"""Time variants of the kernels against each other on one card.

    python -m pda_torch.tools.bench_variants DIR [DIR ...] [--iters 5]
        [--only fwd|bwd|wgrad|mc] [--dtype float32|bf16] [--burst 1]
        [--shapes flagship|lung|all]

Each DIR is a copy of ``pda_torch/kernels/csrc`` with one change (a tile
size, a flag); each builds into its own library (``_build.use_sources``).
For every ConvBlock shape of the serving path (K1, K2, tiled and pseudo),
the MT step's posterior entry and the MT step's backward
(:mod:`.workload`), the variants run in turns (DIR1 .. DIRn, then DIRn ..
DIR1, so A B B A for two) on the same seeded inputs, each timed by CUDA
events (median of ``--iters`` after 2 warm-ups; with ``--burst N`` the
events span N launches back to back and ms is a launch's share, so that a
short kernel's time holds no wait for the host's launch path), and checked
against the
plain version: max |kernel - plain| / max |plain|, and in float32 also
against the plain version in float64 (ref64; for the backward the worst of
its outputs, and dx's and the dW's alone). ``--shapes lung`` runs the Lung suite's
shapes instead (:data:`.workload.LUNG_K1` and the rest: batch 2 and the
single frames), ``all`` both. The MC tail (K3, n_mid 1) runs
the same way at the tiled, MT-teacher and pseudo shapes (S = 16) and at
:data:`MC_OTHER_SHAPES` (the algorithms' narrow tails, MitoEM's MC-8
prediction batch, the Lung MT teacher), held to its plain version and
float64 by the MC mean's max abs error, with the consensus pixels that
differ from the plain version's farther than 1e-4 from a threshold counted
(bf16: float64 sums at the bf16 rounding points, and 2^-6 from a
threshold, ``chip_smoke.py``'s bf16 K3 window), each line with its bound
(165 TFLOP/s in 3xTF32, 989 in bf16, against 3.35 TB/s), the share of it
the variant reaches and whether its outputs are the first variant's bit
for bit. Prints one line per shape and variant, with
TFLOP/s from the FLOPs the shape needs. Needs a CUDA card; TF32 off for
cuDNN and matmul.

``--only wgrad`` (float32) times one layer's weight gradient alone
(``conv_block.wgrad_kernel``, the C entry ``pda_wgrad``: the body the
layer's shape routes it to, and the chunks' sum) at every wgrad layer of
the MT step (:data:`.workload.MT_WGRAD`, with its launches a step) and of
the Lung suite (:data:`.workload.LUNG_WGRAD`), against its plain version
and float64 (dW and db apart), beside the one PyTorch call that computes
the same dW and db (``aten.convolution_backward`` with ``output_mask``
``[False, True, True]``, cuDNN, TF32 off) and the bound (18 * Cin * Cout
FLOPs a pixel at 165 TFLOP/s, 3xTF32, against the bytes at 3.35 TB/s).
A variant of the sources without ``pda_wgrad`` (an older parent's) takes
the entry appended to its ``conv_block_bwd.cu``.

``--dtype bf16`` runs the bf16 instances (pda's bf16 configuration) on bf16
activations, the weights float32 as the wrappers take them. The forward is
then held layer by layer (a bf16 rounding that falls the other way in one
layer moves every later one) against the plain layer summed in float64 from
the kernel's own input to it: the least share of bit-equal elements and the
largest difference relative to the layer's largest value (``ref64``). The
forward is timed through ``conv_block._launch``, which counts no launch, so
a variant may be a parent's sources that lack the newer route counts. The
backward is held the same way, each layer from the kernel's own cotangent to
it (its da workspaces): dW and db against float64 sums (the largest
difference relative to the largest value), da_2, da_1 and dx against the
plain dgrad summed in float64 and rounded once (the least bit-equal share);
it is timed through ``conv_block._launch_bwd``, which counts no launch
either.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import conv_block as kc
from ..kernels import mc_consensus as km
from . import workload as wl

# (B, H, W, Ca, Cb, C), Cb = 0 for a single input
FWD_SHAPES = ([(*s[:4], 0, s[4]) for s in (*wl.K1_TILED, *wl.K1_PSEUDO, wl.K1_POSTERIOR)]
              + wl.K2_TILED + wl.K2_PSEUDO)
# (B, H, W, Ca, Cb, C, need_dx)
BWD_SHAPES = (list(dict.fromkeys((*s[:4], 0, s[4], need_dx) for s, need_dx, *_ in wl.BWD_SHAPES))
              + [(*s, True) for s in wl.BWD_DUAL_SHAPES])
LUNG_FWD_SHAPES = [(*s[:4], 0, s[4]) for s in wl.LUNG_K1] + wl.LUNG_K2
LUNG_BWD_SHAPES = ([(*s[:4], 0, *s[4:]) for s in wl.LUNG_BWD]
                   + [(*s, True) for s in wl.LUNG_BWD_DUAL])
# (name, (B, H, W, C), S, masking): K3 on the other paths (n_mid 1): the
# algorithms phase's narrow tails (C = 16; 20, zero-padded to 24), a MitoEM
# prediction batch (MC-8 over 9 tiles of 512^2), the Lung MT teacher
MC_OTHER_SHAPES = [("C=16", (2, 128, 128, 16), 16, False), ("C=20", (2, 128, 128, 20), 16, False),
                   ("mitoem", (9, 512, 512, 64), 8, False), ("lung", (2, 256, 256, 64), 16, True)]


def rel_err(outs, refs) -> float:
    return max(float((o.double() - r.double()).abs().max()) / max(float(r.abs().max()), 1e-30)
               for o, r in zip(outs, refs) if r is not None)


def bf16_layers(hs, x, ws):
    """(least bit-equal share, largest |diff| / max) of a bf16 block's h1, h2,
    h3, each against the plain layer in float64 sums from the block's own
    input to it."""
    equal, rel = 1.0, 0.0
    for k, h in enumerate(hs):
        with kc.plain_sums(torch.float64):
            ref = kc.conv_relu_layer(x.permute(0, 3, 1, 2), ws[2 * k],
                                     ws[2 * k + 1]).permute(0, 2, 3, 1)
        equal = min(equal, float((h.view(torch.int16) == ref.view(torch.int16)).double().mean()))
        rel = max(rel, rel_err([h.double()], [ref.double()]))
        x = h
    return equal, rel


def bf16_bwd_layers(out, workspaces, g, xs, h1, h2, h3, w1, w2, w3):
    """(largest |diff| / max of dW, db, least bit-equal share of da_2, da_1
    and dx) of a bf16 backward's outputs ``out`` (``_launch_bwd``'s), each
    layer from the kernel's own cotangent to it (``workspaces``: its da_1,
    da_2), against float64 sums."""
    import torch.nn.functional as F

    def dgrad64(da, w, mask):
        wk = kc.bf16_operand(w, torch.float64).flip(0, 1).permute(2, 3, 0, 1)
        r = F.conv2d(da.double().permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
        return (r if mask is None else torch.where(mask > 0, r, 0.0)).to(torch.bfloat16)

    dxa, dxb, dw1, db1, dw2, db2, dw3, db3 = out
    da1, da2 = workspaces
    x = torch.cat(xs, dim=-1)
    da3 = kc.masked_cotangent_plain(g, None, h3)
    grad = 0.0
    for (dw, db), h_in, da in (((dw3, db3), h2, da3), ((dw2, db2), h1, da2), ((dw1, db1), x, da1)):
        refs = (kc._wgrad_plain(h_in.double(), da.double()), da.double().sum(dim=(0, 1, 2)))
        grad = max(grad, rel_err([dw, db], refs))
    checks = [(da2, dgrad64(da3, w3, h2)), (da1, dgrad64(da2, w2, h1))]
    if dxa is not None:
        dx = dxa if dxb is None else torch.cat([dxa, dxb], dim=-1)
        checks.append((dx, dgrad64(da1, w1, None)))
    equal = min(float((a.view(torch.int16) == r.view(torch.int16)).double().mean())
                for a, r in checks)
    return grad, equal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--only", choices=("fwd", "bwd", "wgrad", "mc"),
                    help="time only the forward, the backward, one wgrad layer or the MC tail")
    ap.add_argument("--dtype", choices=("float32", "bf16"), default="float32",
                    help="the kernels' instance: float32 (3xTF32) or bf16")
    ap.add_argument("--burst", type=int, default=1,
                    help="launches between a timing's two events, back to back (ms is per "
                         "launch): above 1 the card need not wait for the host's launch path")
    ap.add_argument("--shapes", choices=("flagship", "lung", "all"), default="flagship",
                    help="the flagship's serving and MT-step shapes, the Lung suite's, or both")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    fwd_shapes = ((FWD_SHAPES if args.shapes != "lung" else [])
                  + (LUNG_FWD_SHAPES if args.shapes != "flagship" else []))
    bwd_shapes = ((BWD_SHAPES if args.shapes != "lung" else [])
                  + (LUNG_BWD_SHAPES if args.shapes != "flagship" else []))
    if not torch.cuda.is_available():
        print("bench_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{args.dtype}")
    order = args.dirs + args.dirs[::-1]  # A B B A

    def timed(fn):
        return wl.cuda_ms(lambda: [fn() for _ in range(args.burst)],
                          iters=args.iters) / args.burst

    gen = torch.Generator().manual_seed(0)
    for b, h, w, ca, cb, c in fwd_shapes if args.only in (None, "fwd") else ():
        xs = [torch.randn(b, h, w, n, generator=gen).to(dev).to(dtype)
              for n in ((ca, cb) if cb else (ca,))]
        ws = wl.conv_weights(gen, ca + cb, c, dev)
        plain = kc.conv_block_fwd_dual_plain if cb else kc.conv_block_fwd_plain
        kernel = lambda: kc._launch(xs[0], xs[1] if cb else None, *ws)  # noqa: E731
        with torch.inference_mode():
            ref = plain(*xs, *ws)
            ref64 = plain(*(t.double() for t in (*xs, *ws))) if dtype == torch.float32 else None
            flops = wl.block_flops(b, h, w, ca + cb, c)
            for d in order:
                _build.use_sources(d)
                hs = kernel()
                err = rel_err([hs[-1].double()], [ref.double()])
                if dtype == torch.float32:
                    check = f"ref64 {rel_err([hs[-1].double()], [ref64]):.2e}"
                else:
                    equal, rel = bf16_layers(hs, torch.cat(xs, dim=-1), ws)
                    check = f"ref64 per layer: bit-equal >= {equal:.6f}, |diff|/max <= {rel:.2e}"
                del hs
                ms = timed(kernel)
                print(f"fwd {ca}{'+' + str(cb) if cb else ''}->{c} @{b}x{h}x{w} {d.name}: "
                      f"ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) rel_err {err:.2e} "
                      f"{check}", flush=True)
        del xs, ws, ref, ref64
    for b, h, w, ca, cb, c, need_dx in bwd_shapes if args.only in (None, "bwd") else ():
        x = torch.randn(b, h, w, ca + cb, generator=gen).to(dev).to(dtype)
        ws_ = wl.conv_weights(gen, ca + cb, c, dev)
        hs = [t.permute(0, 2, 3, 1).contiguous() for t in kc._plain_layers(x, *ws_)]
        g = torch.randn(b, h, w, c, generator=gen).to(dev).to(dtype)
        if cb:
            args_ = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *hs, *ws_[::2])
            plain = kc.conv_block_bwd_dual_plain
        else:
            args_ = (g, x, *hs, *ws_[::2])
            plain = lambda *a: kc.conv_block_bwd_plain(*a, need_dx=need_dx)  # noqa: E731
        ref = plain(*args_)
        ref64 = plain(*(t.double() for t in args_)) if dtype == torch.float32 else None
        xs = args_[1:3] if cb else args_[1:2]
        launch = lambda ws=None: kc._launch_bwd(  # noqa: E731
            g, xs[0], xs[1] if cb else None, *hs, *ws_[::2], need_dx, ws)
        for d in order:
            _build.use_sources(d)
            out = launch()
            outs = out if cb else (out[0], *out[2:])
            err = rel_err(outs, ref)
            check = ""
            if ref64 is not None:
                dx = rel_err([torch.cat(outs[:2], -1) if cb else outs[0]],
                             [torch.cat(ref64[:2], -1) if cb else ref64[0]]) if need_dx else 0.0
                nd = 2 if cb else 1  # dx (dxa, dxb), then dW, db of each layer
                dw = rel_err(outs[nd::2], ref64[nd::2])
                check = f" ref64 {rel_err(outs, ref64):.2e} (dx {dx:.2e}, dW {dw:.2e})"
            del out, outs
            if dtype == torch.bfloat16:
                workspaces = (torch.empty_like(hs[0]), torch.empty_like(hs[0]))
                grad, equal = bf16_bwd_layers(launch(workspaces), workspaces, g, xs, *hs,
                                              *ws_[::2])
                check = f" ref64 per layer: dW, db |diff|/max <= {grad:.2e}, da bit-equal >= {equal:.6f}"
            ms = timed(launch)
            print(f"bwd {ca}{'+' + str(cb) if cb else ''}->{c} @{b}x{h}x{w} {d.name}: "
                  f"ms {ms:.3f} rel_err {err:.2e}{check}", flush=True)
        del x, ws_, hs, g, args_, ref, ref64
    wgrad_shapes = ({**(wl.MT_WGRAD if args.shapes != "lung" else {}),
                     **(wl.LUNG_WGRAD if args.shapes != "flagship" else {})}
                    if args.only in (None, "wgrad") and dtype == torch.float32 else {})
    for (b, h, w, ca, cb, c), calls in wgrad_shapes.items():
        x = torch.relu(torch.randn(b, h, w, ca + cb, generator=gen)).to(dev)
        xa, xb = (x[..., :ca].contiguous(), x[..., ca:].contiguous()) if cb else (x, None)
        da = (torch.randn(b, h, w, c, generator=gen)
              * (torch.rand(b, h, w, c, generator=gen) > 0.5)).to(dev)
        ref = kc.wgrad_plain(xa, da, xb)
        ref64 = kc.wgrad_plain(x.double(), da.double())
        flops = wl.wgrad_flops(b, h, w, ca + cb, c)
        bound, term = wl.bound_ms(flops, wl.wgrad_bytes(b, h, w, ca + cb, c),
                                  wl.PEAK_TF32X3_FLOPS)
        xl, dal = x.permute(0, 3, 1, 2), da.permute(0, 3, 1, 2)  # channels_last views
        wt = torch.empty(c, ca + cb, 3, 3, device=dev).to(memory_format=torch.channels_last)
        library_ms = timed(lambda: torch.ops.aten.convolution_backward(
            dal, xl, wt, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, True]))
        label = f"wgrad {ca}{'+' + str(cb) if cb else ''}->{c} @{b}x{h}x{w}"
        print(f"{label}: {calls} a step; library_ms {library_ms:.3f} "
              f"({flops / library_ms / 1e9:.1f} TFLOP/s) bound_ms {bound:.3f} ({term})", flush=True)
        for d in order:
            _build.use_sources(d)
            route = kc.wgrad_route(xa, da, xb)
            out = kc.wgrad_kernel(xa, da, xb)
            err = rel_err(out, ref)
            dw64, db64 = rel_err(out[:1], ref64[:1]), rel_err(out[1:], ref64[1:])
            del out
            ms = timed(lambda: kc.wgrad_kernel(xa, da, xb))
            print(f"{label} {d.name}: route {route} ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) "
                  f"rel_err {err:.2e} ref64 dW {dw64:.2e} db {db64:.2e}", flush=True)
        del x, xa, xb, da, ref, ref64, xl, dal, wt
    mc_shapes = ([(name, shape, wl.MC_SAMPLES, masking) for name, shape, masking in wl.K3_SHAPES]
                 + MC_OTHER_SHAPES)
    peak = wl.PEAK_BF16_FLOPS if dtype == torch.bfloat16 else wl.PEAK_TF32X3_FLOPS
    for name, (b, h, w, c), s, masking in mc_shapes if args.only in (None, "mc") else ():
        feat, *rest = wl.mc_inputs(gen, b, h, w, c, s=s, dev=dev)
        args_ = (feat.to(dtype), *rest)
        window = 1e-4 if dtype == torch.float32 else 2.0 ** -6  # chip_smoke.py's K3 windows
        with torch.inference_mode():
            ref_mean, ref_cons = km.mc_consensus_plain(*args_, masking)
            if dtype == torch.float32:
                ref64 = km.mc_consensus_plain(*(t.double() for t in args_), masking)[0]
            else:  # the bf16 rounding points, summed in float64
                with kc.plain_sums(torch.float64):
                    ref64 = km.mc_consensus_plain(*args_, masking)[0]
            logits = km.mc_logits_plain(*args_)
            near = ((logits.abs() - torch.log(torch.tensor(9.0))).abs() < window).any(dim=0)
            del logits
            flops = wl.mc_flops(b, h, w, c, s, 1)
            nbytes = wl.mc_bytes(b, h, w, c, s, 1, args_[0].element_size())
            bound, term = wl.bound_ms(flops, nbytes, peak)
            first = None  # the first variant's outputs
            for d in order:
                _build.use_sources(d)
                mean, cons = km.mc_consensus(*args_, masking=masking)
                err = float((mean - ref_mean).abs().max())
                err64 = float((mean.double() - ref64.double()).abs().max())
                stray = int(((cons != ref_cons) & ~near).sum())
                first = first or (mean, cons)
                same = torch.equal(mean, first[0]) and torch.equal(cons, first[1])
                del mean, cons
                ms = timed(lambda: km.mc_consensus(*args_, masking=masking))
                print(f"mc {name} S={s} @{b}x{h}x{w}x{c} masking={masking} {d.name}: ms "
                      f"{ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) bound {bound:.3f} ({term}; "
                      f"{bound / ms:.0%} of it) mean_err {err:.2e} ref64 {err64:.2e} "
                      f"stray {stray}, bit-equal to {order[0].name}'s {same}", flush=True)
        del args_, ref_mean, ref_cons, ref64, near, first
    return 0


if __name__ == "__main__":
    sys.exit(main())
