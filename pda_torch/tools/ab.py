"""The Mean-Teacher step's A/B: the flagship MT step's compute twice from
one state, batch and noise, and ``pda``'s measures between the two
(``development/ab_step_check.py``), with the kernels' launch counts.

``chip_smoke.py`` (its bf16 phase) and :mod:`.ab_step_check` both run it
from here:

  * :func:`mt_compute`: the teacher's MC pseudo-label and consensus, the
    student's loss on them and its raw gradients, no update;
  * :func:`kernels_and_plain`: that compute on the kernels (inside a
    caller's context), then with every plain version
    (``conv_block.plain_versions()``), and the plain leg's own spread: its
    teacher's logits, pseudo-label and consensus (float32: its whole
    compute) in float32 against float64 sums;
  * :func:`ab_metrics` and :func:`ab_compare`: the loss's relative
    difference, 1 - the gradients' global cosine, the worst leaf's relative
    L2 (floored at 1e-4 of the global norm), the pseudo-label's largest
    difference and the consensus pixels that differ, each against its bound;
    :func:`f32_bounds`: float32's bounds from the plain leg's own spread.
"""

from __future__ import annotations

import contextlib
import copy
import math
import types
from typing import Callable, Dict

import torch

#: the teacher's MC samples (pda's N_MC_TRAIN)
MC = 16
#: the bf16 A/B's bounds (chip_smoke.py's bf16 phase): loss and aux values
#: relative, 1 - the gradients' cosine, the worst leaf's relative L2
AB_LOSS_TOL, AB_COS_TOL, AB_LEAF_TOL = 1e-3, 1e-5, 1e-2
#: given a reference's own spread (two summation orders of it), a bound is
#: this many times that spread: the least bound in bf16 (and in
#: chip_smoke.py's card-vs-CPU gradient checks), the most in the float32 A/B;
#: and the bf16 consensus pixels that may differ
SPREAD_FACTOR = 4
#: float32's consensus rule: the legs' consensus may differ only at pixels
#: where a sample logit of either leg lies within the larger of this
#: (chip_smoke.py's card-vs-CPU teacher check, its K3_WINDOW) and
#: SPREAD_FACTOR times the plain leg's own largest float32-vs-float64 logit
#: difference of a threshold
THRESHOLD_WINDOW = 1e-4
#: the float32 kernels' own drift (pda_torch/kernels/csrc/tf32x3.cuh): the
#: tensor cores add into float32 with round-toward-zero, so each conv layer's
#: sums may shrink by up to this much of float64's (chains of 8 k-steps,
#: measured on an H100), the same way in every layer: a loss at the end of
#: L conv layers may move by L times this, where the plain versions' own
#: rounding, unbiased, cancels in the loss's sums
TF32X3_LAYER_DRIFT = 1.5e-6
#: pda's own bounds (development/ab_step_check.py): y the pseudo-label's
#: largest difference, loss relative, leaf the worst leaf's relative L2,
#: cos 1 - the gradients' global cosine
PDA_BOUNDS = {"f32": {"y": 2e-3, "loss": 2e-3, "leaf": 5e-2, "cos": 1e-4},
              "bf16": {"y": 3e-2, "loss": 2e-2, "leaf": 3e-1, "cos": 1e-2}}


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_wrappers() -> Dict[str, Callable]:
    """The five kernels' wrappers, each with its ``launches`` count."""
    from ..kernels import conv_block as kc
    from ..kernels import mc_consensus as km

    return {"conv_block_fwd": kc.conv_block_fwd, "conv_block_fwd_dual": kc.conv_block_fwd_dual,
            "mc_consensus": km.mc_consensus, "conv_block_bwd": kc.conv_block_bwd,
            "conv_block_bwd_dual": kc.conv_block_bwd_dual}


def reset_launches(wrappers) -> None:
    """Every count of the wrappers (each instance's, each mode's) to 0."""
    from ..kernels.conv_block import BWD_MODES, FWD_MODES

    for w in wrappers.values():
        w.launches = w.launches_bf16 = 0
        for name in (f"launches_{m}{s}" for m in (*BWD_MODES, *FWD_MODES) for s in ("", "_bf16")):
            if hasattr(w, name):
                setattr(w, name, 0)


def read_launches(wrappers, bf16: bool = False) -> Dict[str, int]:
    """The launches since :func:`reset_launches` of the kernels' float32
    instances (or, with ``bf16``, their bf16 ones)."""
    return {k: w.launches_bf16 if bf16 else w.launches for k, w in wrappers.items()}


def teacher_logits(state, x1, eps):
    """The teacher's (S, B, H, W, 1) MC logits through the plain tail, on the
    CPU (its encoding on the state's device)."""
    from ..models.punet import mc_decode_logits

    with torch.no_grad():
        enc = state.teacher.encode(x1)
        return mc_decode_logits(state.teacher, enc.features, enc.prior, MC, eps=eps).cpu()


def mt_compute(state, batch, noise, plain_teacher=False, pseudo=None):
    """pda's ab_step_check.compute: the teacher's MC pseudo-label and
    consensus (through ``mc_pseudo``, or with ``plain_teacher`` as the plain
    path computes them, from its logits, which are kept; given ``pseudo``
    and no ``plain_teacher``, none), the student's loss on them (or on
    ``pseudo``) and its raw gradients, no update."""
    from ..core.consensus import consensus_from_logits
    from ..train import steps

    _, x1, x2, _ = batch
    out = {"logits": None}
    with torch.no_grad():
        if plain_teacher:
            out["logits"] = teacher_logits(state, x1, noise["eps_teacher"])
            y, z = consensus_from_logits(out["logits"].to(x1.device), masking=True)
        elif pseudo is None:
            y, z = steps._mc_pseudo(state.teacher, x1, MC, True, noise["eps_teacher"])
        else:
            y, z = pseudo
    out["y"], out["z"] = y.cpu(), z.cpu()
    if pseudo is not None:
        y, z = (v.to(x2.device) for v in pseudo)
    state.model.zero_grad(set_to_none=True)
    loss, aux = steps._punet_loss(state.model, x2, y, noise["eps_post"], consm=z)
    loss.backward()
    out["aux"] = {k: float(v.detach()) for k, v in aux.items()}
    out["grads"] = [p.grad.detach().double().cpu() for p in state.model.parameters()]
    out["names"] = [n for n, _ in state.model.named_parameters()]
    return out


def ab_metrics(a, b):
    """pda's A/B measures of two MT computations, ``b`` the reference: the
    loss's relative difference, the aux values' worst (relative to
    max(1, |ref|)), 1 - the gradients' global cosine, and the worst leaf's
    relative L2 (floored at 1e-4 of the global norm) with its name."""
    loss_rel = abs(a["aux"]["loss"] - b["aux"]["loss"]) / max(abs(b["aux"]["loss"]), 1e-12)
    aux_rel = max(abs(a["aux"][k] - v) / max(1.0, abs(v)) for k, v in b["aux"].items())
    nbb = sum(float((g * g).sum()) for g in b["grads"])
    gnorm = math.sqrt(nbb)
    dot = sum(float((p * q).sum()) for p, q in zip(a["grads"], b["grads"]))
    naa = sum(float((p * p).sum()) for p in a["grads"])
    leaf = max((float((p - q).norm()) / max(float(q.norm()), 1e-4 * gnorm), n)
               for p, q, n in zip(a["grads"], b["grads"], b["names"]))
    return {"loss": loss_rel, "aux": aux_rel,
            "cos": 1.0 - dot / max(math.sqrt(naa * nbb), 1e-30), "leaf": leaf}


def rms_diff(a, b):
    """The root mean square of ``a - b``, in float64."""
    return float((a.double() - b.double()).pow(2).mean().sqrt())


def stray_flips(a, b, window: float) -> int:
    """The consensus pixels at which ``a`` and ``b`` differ although no
    sample logit of either lies within ``window`` of a threshold."""
    from ..core.consensus import LOWER_THRESHOLD, UPPER_THRESHOLD

    near = torch.zeros_like(b["z"], dtype=torch.bool)
    for logits in (a["logits"], b["logits"]):
        for p in (UPPER_THRESHOLD, LOWER_THRESHOLD):
            near |= ((logits.double() - math.log(p / (1.0 - p))).abs() <= window).any(dim=0)
    return int(((a["z"] != b["z"]) & ~near).sum())


def f32_bounds(own, depth: int) -> Dict[str, float]:
    """float32's A/B bounds from the plain leg's own float32-vs-float64
    spread ``own`` (:func:`kernels_and_plain`'s): each measure within
    SPREAD_FACTOR times that spread, and never beyond pda's own float32
    bound (``PDA_BOUNDS["f32"]``); the loss and the aux values at least
    within ``depth`` (the conv layers on the model's deepest path) times
    TF32X3_LAYER_DRIFT; "window" the consensus rule's (THRESHOLD_WINDOW or
    SPREAD_FACTOR times the own largest logit difference, the larger)."""
    pda = PDA_BOUNDS["f32"]
    own_of = {"loss": own["loss"], "aux": own["aux"], "cos": own["cos"], "leaf": own["leaf"][0],
              "y": own["dy"]}
    drift = depth * TF32X3_LAYER_DRIFT
    bounds = {k: min(pda["loss" if k == "aux" else k],
                     max(SPREAD_FACTOR * v, drift if k in ("loss", "aux") else 0.0))
              for k, v in own_of.items()}
    bounds["window"] = max(THRESHOLD_WINDOW, SPREAD_FACTOR * own["dlogit"])
    return bounds


def ab_compare(label, a, b, spread=None, teacher_spread=None, bounds=None, window=None):
    """pda's A/B bounds between two MT computations (``b`` the reference):
    the loss's and the aux values' relative difference within AB_LOSS_TOL,
    the gradients' cosine within AB_COS_TOL of 1, the worst leaf's relative
    L2 within AB_LEAF_TOL (``bounds``, a dict of "loss", "cos", "leaf",
    optionally "aux" (else "loss"'s) and "y", the pseudo-label's largest
    difference, takes others); or, given ``spread`` (:func:`ab_metrics` of
    two summation orders of the reference itself), each within
    SPREAD_FACTOR times that spread where that is larger. Given
    ``teacher_spread`` (:func:`kernels_and_plain`'s spread of the
    reference's teacher between two summation orders), the differing
    consensus pixels within SPREAD_FACTOR times its (the RMS is logged).
    Given ``window``, the differing consensus pixels only where a sample
    logit lies within ``window`` of a threshold (:func:`stray_flips`).
    Returns {criterion: passed}."""
    m = ab_metrics(a, b)
    if bounds is None:
        tol = {"loss": AB_LOSS_TOL, "aux": AB_LOSS_TOL, "cos": AB_COS_TOL, "leaf": AB_LEAF_TOL}
    else:
        tol = {"loss": bounds["loss"], "aux": bounds.get("aux", bounds["loss"]),
               "cos": bounds["cos"], "leaf": bounds["leaf"]}
    if spread is not None:
        tol = {k: max(v, SPREAD_FACTOR * (spread[k][0] if k == "leaf" else spread[k]))
               for k, v in tol.items()}
    flips = int((a["z"] != b["z"]).sum())
    rms = rms_diff(a["logits"], b["logits"])
    dy = float((a["y"] - b["y"]).abs().max())
    passed = {k: (m[k][0] if k == "leaf" else m[k]) <= v for k, v in tol.items()}
    passed["finite"] = bool(torch.isfinite(a["y"]).all())
    if bounds is not None:
        passed["y"] = dy <= bounds["y"]
    if teacher_spread is not None:
        passed["consensus"] = flips <= SPREAD_FACTOR * teacher_spread["px"]
    dlogit = float((a["logits"].double() - b["logits"].double()).abs().max())
    if window is not None:
        stray = stray_flips(a, b, window)
        passed["consensus"] = stray == 0
    failed = [k for k, v in passed.items() if not v]
    log(f"{label}: loss {a['aux']['loss']:.6f} vs {b['aux']['loss']:.6f}, relative difference "
        f"{m['loss']:.2e} (tol {tol['loss']:.2e}), aux worst {m['aux']:.2e} (tol "
        f"{tol['aux']:.2e}); gradients' cosine 1 - {m['cos']:.2e} (tol {tol['cos']:.2e}); worst "
        f"leaf relative L2 {m['leaf'][0]:.2e} ({m['leaf'][1]}; tol {tol['leaf']:.2e})"
        + (f" [tolerances: the larger of pda's A/B bounds and {SPREAD_FACTOR:g} x the "
           f"reference's own float32-vs-float64-sums spread: loss {spread['loss']:.2e}, cos "
           f"{spread['cos']:.2e}, leaf {spread['leaf'][0]:.2e}]" if spread else "")
        + f"; pseudo-label max|dy| {dy:.2e}"
        + (f" (tol {bounds['y']:.2e})" if bounds is not None else "")
        + f"; teacher logits max|diff| {dlogit:.2e}, RMS {rms:.3e}"
        + (f" (the reference's own {teacher_spread['rms']:.3e})" if teacher_spread else "")
        + f"; consensus differs at {flips} px"
        + (f" (tol {SPREAD_FACTOR:g} x {teacher_spread['px']})" if teacher_spread else
           f", {stray} of them farther than {window:.2e} from a threshold (tol 0)"
           if window is not None else " (not judged)")
        + f"; consensus share {float(b['z'].mean()):.4f} "
        + ("ok" if not failed else f"FAIL ({', '.join(failed)})"))
    return passed


def kernels_and_plain(make_state: Callable, batch, noise, label: str,
                      leg: Callable = contextlib.nullcontext, bf16: bool = False):
    """The MT compute twice from one state (``make_state()`` each time) on
    the batch's device: inside ``leg`` (the kernels; a control's context),
    then with every plain version (``bf16``: float32 sums on the card); then
    the plain leg once more in float64 sums, its own spread (``bf16``: its
    teacher under ``plain_sums``; float32: the whole compute on a float64
    copy of the state, cuDNN off, so that the card's float64 convolutions
    run on cuBLAS). Logs that spread under ``label``. Returns (kernel leg,
    plain leg, the spread: {"rms": the teacher logits' RMS difference,
    "dlogit": their largest, "px": the consensus pixels that differ, "dy":
    the pseudo-label's largest difference; float32 also :func:`ab_metrics`
    of the plain leg against its float64 self}, the kernel leg's launches,
    the plain leg's) (the launches of the float32 or, with ``bf16``, the
    bf16 instances)."""
    from ..core.consensus import consensus_from_logits
    from ..kernels import conv_block as kc

    wrappers = kernel_wrappers()
    dev = batch[1].device
    reset_launches(wrappers)
    state = make_state()
    with leg():
        kern = mt_compute(state, batch, noise)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = read_launches(wrappers, bf16)
        kern["logits"] = teacher_logits(state, batch[1], noise["eps_teacher"])
    reset_launches(wrappers)
    state = make_state()
    with kc.plain_versions():
        plain = mt_compute(state, batch, noise, plain_teacher=True)
        if bf16:
            with kc.plain_sums(torch.float64):
                ref = {"logits": teacher_logits(state, batch[1], noise["eps_teacher"])}
            ref["y"], ref["z"] = (v.cpu() for v in consensus_from_logits(
                ref["logits"].to(dev), masking=True))
        else:  # a float32 model's plain versions sum in its dtype: a float64 copy
            state64 = types.SimpleNamespace(model=copy.deepcopy(state.model).double(),
                                            teacher=copy.deepcopy(state.teacher).double())
            with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
                ref = mt_compute(state64, [a.double() for a in batch],
                                 {k: v.double() for k, v in noise.items()}, plain_teacher=True)
            del state64
    del state
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plain_counts = read_launches(wrappers, bf16)
    spread = {"rms": rms_diff(ref["logits"], plain["logits"]),
              "dlogit": float((plain["logits"].double() - ref["logits"].double()).abs().max()),
              "px": int((ref["z"] != plain["z"]).sum()),
              "dy": float((plain["y"].double() - ref["y"].double()).abs().max())}
    if not bf16:
        spread.update(ab_metrics(plain, ref))
        k64 = ab_metrics(kern, ref)
    log(f"{label} plain leg, float32 vs float64 sums: teacher logits max|diff| "
        f"{spread['dlogit']:.2e}, RMS {spread['rms']:.3e}; pseudo-label max|dy| "
        f"{spread['dy']:.2e}; consensus differs at {spread['px']} px"
        + ("" if bf16 else f"; loss {spread['loss']:.2e}, aux worst {spread['aux']:.2e}, "
           f"gradients' cosine 1 - {spread['cos']:.2e}, worst leaf relative L2 "
           f"{spread['leaf'][0]:.2e} ({spread['leaf'][1]}) (the kernel leg against the same "
           f"float64 compute: loss {k64['loss']:.2e}, aux worst {k64['aux']:.2e}, cosine 1 - "
           f"{k64['cos']:.2e}, worst leaf {k64['leaf'][0]:.2e})"))
    return kern, plain, spread, counts, plain_counts
