"""Negative controls of ``chip_smoke.py``'s bf16 step checks: can they fail?

    python -m pda_torch.tools.bf16_controls [--spread N]

Run from the repository root (it imports ``chip_smoke``). Runs the bf16
phase's two whole-step checks, the 128^2 MT step card vs CPU
(``chip_smoke.bf16_card_vs_cpu``) and the 512^2 A/B against every plain
version (``chip_smoke.bf16_ab``), twice on the same inputs: once with the
bf16 kernels, and once with a deliberately wrong bf16 ConvBlock in their
place (:func:`unrounded_blocks`: the plain versions on the card with the
block's first two layers left in float32, only its output rounded to bf16,
a body that drops its per-layer roundings). Prints each check's criteria
that fail. First, the same control against the layer-by-layer check of the
bf16 forward bodies (``chip_smoke.bf16_layers_agree``) at the tiled
forward's shapes, beside the kernel. Exits 0 if the kernels pass both checks; what catches the
control is the result to read. ``--spread N`` then draws N more 512^2
batches and prints, for the kernels and the control against the plain
versions (float32 sums), and for the plain versions in float64 sums against
them (the spread of two valid summation orders), ``pda_torch.tools.ab.ab_metrics``
and the teacher's differences: each leg with its own teacher, and each
student on the kernels' pseudo-labels. Needs a CUDA card; TF32 off for
cuDNN and matmul.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch
import torch.nn.functional as F

from . import ab


@contextlib.contextmanager
def unrounded_blocks():
    """Every kernel wrapper runs its plain version on the card, with the
    bf16 ConvBlock forward computed without its per-layer roundings: h1, h2
    stay in the sums' dtype and only h3 is rounded to bf16."""
    from pda_torch.kernels import conv_block as kc

    layers = kc._plain_layers

    def unrounded(x, w1, b1, w2, b2, w3, b3):
        if x.dtype != torch.bfloat16:
            return layers(x, w1, b1, w2, b2, w3, b3)
        acc = kc.plain_acc(x)
        h, hs = x.permute(0, 3, 1, 2).to(acc), []
        for w, b in ((w1, b1), (w2, b2), (w3, b3)):
            h = F.relu(F.conv2d(h, kc.bf16_operand(w, acc).permute(3, 2, 0, 1), b.to(acc),
                                padding=1))
            hs.append(h)
        hs[-1] = hs[-1].to(torch.bfloat16)
        return hs

    kc._plain_layers = unrounded
    try:
        with kc.plain_versions():
            yield
    finally:
        kc._plain_layers = layers


def unrounded_layers(x, w1, b1, w2, b2, w3, b3):
    """(h1, h2, h3) of a bf16 block that stores each layer rounded to bf16
    but feeds the next layer its unrounded float32 value."""
    from pda_torch.kernels import conv_block as kc

    h, hs = x.permute(0, 3, 1, 2).float(), []
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = F.relu(F.conv2d(h, kc.bf16_operand(w).permute(3, 2, 0, 1), b, padding=1))
        hs.append(h.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous())
    return hs


def layer_control(cs, dev):
    """The layer-by-layer check on the kernel and on :func:`unrounded_layers`
    at the tiled forward's K1 shapes."""
    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools import workload as wl

    gen = torch.Generator().manual_seed(cs.SEED + 3)
    for b, h, w, cin, c in wl.K1_TILED:
        x = torch.randn(b, h, w, cin, generator=gen).to(dev).to(torch.bfloat16)
        ws = wl.conv_weights(gen, cin, c, dev)
        for name, hs in (("kernel", kc._launch(x, None, *ws)),
                         ("control", unrounded_layers(x, *ws))):
            ok, (beyond, equal, rel), _ = cs.bf16_layers_agree(hs, x, ws)
            print(f"bf16_controls layers {cin}->{c} @{b}x{h}x{w} {name}: beyond 1 ulp "
                  f"{beyond} elements, bit-equal {equal:.6f} (>= {cs.BF16_BIT_EQUAL}), worst "
                  f"|diff|/max {rel:.3e}: {'passes' if ok else 'fails'}", flush=True)


def spread(cs, dev, model, frame, gen):
    """One 512^2 draw: the kernels, the control and the plain versions in
    float64 sums, each against the plain versions in float32 sums."""
    from pda_torch.kernels import conv_block as kc

    batch = cs.mt_batch(gen, frame, cs.MT_TIME_PATCH, dev)
    noise = {k: torch.randn(*shape, generator=gen).to(dev) for k, shape in
             (("eps_teacher", (cs.MC, cs.MT_BATCH, 6)), ("eps_post", (cs.MT_BATCH, 6)))}
    legs = {}
    for name, leg in (("kernels", contextlib.nullcontext), ("control", unrounded_blocks)):
        state = cs.bf16_state(model, dev)
        with leg():
            legs[name] = ab.mt_compute(state, batch, noise)
            legs[name]["logits"] = ab.teacher_logits(state, batch[1], noise["eps_teacher"])
    pseudo = (legs["kernels"]["y"], legs["kernels"]["z"])
    ref = {}
    for acc in (torch.float32, torch.float64):
        with kc.plain_versions(), kc.plain_sums(acc):
            ref[acc] = ab.mt_compute(cs.bf16_state(model, dev), batch, noise, plain_teacher=True)
            ref[acc, "shared"] = ab.mt_compute(cs.bf16_state(model, dev), batch, noise,
                                               pseudo=pseudo)
    for name, a in (("kernels", legs["kernels"]), ("control", legs["control"]),
                    ("float64 sums", ref[torch.float64])):
        m = ab.ab_metrics(a, ref[torch.float32])
        shared = ab.ab_metrics(a if name != "float64 sums" else ref[torch.float64, "shared"],
                               ref[torch.float32, "shared"])
        print(f"bf16_controls spread {name} vs plain (float32 sums): own teacher: loss "
              f"{m['loss']:.3e}, cos {m['cos']:.3e}, leaf {m['leaf'][0]:.3e}, teacher logits RMS "
              f"{ab.rms_diff(a['logits'], ref[torch.float32]['logits']):.3e}, consensus "
              f"{int((a['z'] != ref[torch.float32]['z']).sum())} px; on the kernels' "
              f"pseudo-labels: loss {shared['loss']:.3e}, cos {shared['cos']:.3e}, leaf "
              f"{shared['leaf'][0]:.3e}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spread", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_controls: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        layer_control(cs, dev)
    model = cs.bf16_model()
    good = True
    for name, leg in (("kernels", contextlib.nullcontext),
                      ("control: unrounded ConvBlock", unrounded_blocks)):
        gen = torch.Generator().manual_seed(cs.SEED + 3)
        frame = cs.synthetic_frame(gen, cs.FRAME, "cpu")
        for check in (cs.bf16_card_vs_cpu, cs.bf16_ab):
            passed, _ = check(dev, model, frame, gen, leg, name)
            failed = [k for k, v in passed.items() if not v]
            print(f"bf16_controls {check.__name__} {name}: fails "
                  f"{', '.join(failed) if failed else 'nothing'}", flush=True)
            if name == "kernels":
                good &= not failed
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    frame = cs.synthetic_frame(gen, cs.FRAME, "cpu")
    for _ in range(args.spread):
        spread(cs, dev, model, frame, gen)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
