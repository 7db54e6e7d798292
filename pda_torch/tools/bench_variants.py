"""Time variants of the kernels against each other on one card.

    python -m pda_torch.tools.bench_variants DIR [DIR ...] [--iters 5] [--only fwd|bwd|mc]

Each DIR is a copy of ``pda_torch/kernels/csrc`` with one change (a tile
size, a flag); each builds into its own library (``_build.use_sources``).
For every ConvBlock shape of the serving path (K1, K2, tiled and pseudo),
the MT step's posterior entry and the MT step's backward
(:mod:`.workload`), the variants run in turns (DIR1 .. DIRn, then DIRn ..
DIR1, so A B B A for two) on the same seeded inputs, each timed by CUDA
events (median of ``--iters`` after 2 warm-ups), and checked against the
plain version: max |kernel - plain| / max |plain|, and for the forward also
against the plain version in float64 (ref64). The MC tail (K3, S = 16) runs
the same way at the tiled, MT-teacher and pseudo shapes, held to its plain
version and float64 by the MC mean's max abs error, with the consensus
pixels that differ from the plain version's farther than 1e-4 from a
threshold counted. Prints one line per shape and variant, with TFLOP/s from
the FLOPs the shape needs. Needs a CUDA card; TF32 off for cuDNN and matmul.
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
BWD_SHAPES = ([(*s[:4], 0, s[4], need_dx) for s, need_dx, _ in wl.BWD_SHAPES]
              + [(*s, True) for s in wl.BWD_DUAL_SHAPES])


def rel_err(outs, refs) -> float:
    return max(float((o - r).abs().max()) / max(float(r.abs().max()), 1e-30)
               for o, r in zip(outs, refs) if r is not None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--only", choices=("fwd", "bwd", "mc"),
                    help="time only the forward, the backward or the MC tail")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    order = args.dirs + args.dirs[::-1]  # A B B A
    gen = torch.Generator().manual_seed(0)
    for b, h, w, ca, cb, c in FWD_SHAPES if args.only in (None, "fwd") else ():
        xs = [torch.randn(b, h, w, n, generator=gen).to(dev) for n in ((ca, cb) if cb else (ca,))]
        ws = wl.conv_weights(gen, ca + cb, c, dev)
        kernel = kc.conv_block_fwd_dual if cb else kc.conv_block_fwd
        plain = kc.conv_block_fwd_dual_plain if cb else kc.conv_block_fwd_plain
        with torch.inference_mode():
            ref = plain(*xs, *ws)
            ref64 = plain(*(t.double() for t in (*xs, *ws)))
            flops = wl.block_flops(b, h, w, ca + cb, c)
            for d in order:
                _build.use_sources(d)
                out = kernel(*xs, *ws)
                err, err64 = rel_err([out], [ref]), rel_err([out.double()], [ref64])
                del out
                ms = wl.cuda_ms(lambda: kernel(*xs, *ws), iters=args.iters)
                print(f"fwd {ca}{'+' + str(cb) if cb else ''}->{c} @{b}x{h}x{w} {d.name}: "
                      f"ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) rel_err {err:.2e} "
                      f"ref64 {err64:.2e}", flush=True)
        del xs, ws, ref, ref64
    for b, h, w, ca, cb, c, need_dx in BWD_SHAPES if args.only in (None, "bwd") else ():
        x = torch.randn(b, h, w, ca + cb, generator=gen).to(dev)
        ws = wl.conv_weights(gen, ca + cb, c, dev)
        hs = [t.permute(0, 2, 3, 1).contiguous() for t in kc._plain_layers(x, *ws)]
        g = torch.randn(b, h, w, c, generator=gen).to(dev)
        if cb:
            args_ = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *hs, *ws[::2])
            kernel, plain = kc.conv_block_bwd_dual, kc.conv_block_bwd_dual_plain
        else:
            args_ = (g, x, *hs, *ws[::2])
            kernel = lambda *a: kc.conv_block_bwd(*a, need_dx=need_dx)  # noqa: E731
            plain = lambda *a: kc.conv_block_bwd_plain(*a, need_dx=need_dx)  # noqa: E731
        ref = plain(*args_)
        for d in order:
            _build.use_sources(d)
            err = rel_err(kernel(*args_), ref)
            ms = wl.cuda_ms(lambda: kernel(*args_), iters=args.iters)
            print(f"bwd {ca}{'+' + str(cb) if cb else ''}->{c} @{b}x{h}x{w} {d.name}: "
                  f"ms {ms:.3f} rel_err {err:.2e}", flush=True)
        del x, ws, hs, g, args_, ref
    for name, (b, h, w, c), masking in wl.K3_SHAPES if args.only in (None, "mc") else ():
        args_ = wl.mc_inputs(gen, b, h, w, c, dev=dev)
        with torch.inference_mode():
            ref_mean, ref_cons = km.mc_consensus_plain(*args_, masking)
            ref64 = km.mc_consensus_plain(*(t.double() for t in args_), masking)[0]
            logits = km.mc_logits_plain(*args_)
            near = ((logits.abs() - torch.log(torch.tensor(9.0))).abs() < 1e-4).any(dim=0)
            del logits
            flops = wl.mc_flops(b, h, w, c, wl.MC_SAMPLES, 1)
            for d in order:
                _build.use_sources(d)
                mean, cons = km.mc_consensus(*args_, masking=masking)
                err = float((mean - ref_mean).abs().max())
                err64 = float((mean.double() - ref64).abs().max())
                stray = int(((cons != ref_cons) & ~near).sum())
                del mean, cons
                ms = wl.cuda_ms(lambda: km.mc_consensus(*args_, masking=masking), iters=args.iters)
                print(f"mc {name} S={wl.MC_SAMPLES} @{b}x{h}x{w}x{c} {d.name}: ms {ms:.3f} "
                      f"({flops / ms / 1e9:.1f} TFLOP/s) mean_err {err:.2e} ref64 {err64:.2e} "
                      f"stray {stray}", flush=True)
        del args_, ref_mean, ref_cons, ref64, near
    return 0


if __name__ == "__main__":
    sys.exit(main())
