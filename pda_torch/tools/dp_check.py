"""The flagship Mean-Teacher step data-parallel against the same step in one
process.

    python -m pda_torch.tools.dp_check [--hw 512] [--filters 64,128,256,512]
        [--world 2] [--batch 2] [--backend gloo|nccl] [--device cuda|cpu]

``--world`` ranks (default 2) run as processes of one world over a
``FileStore`` in a temporary directory. With ``--backend gloo`` (the
default) every rank is on the same device: one card (NCCL refuses two ranks
on one card, so the mesh's collectives copy each gradient bucket to the
host, reduce it there and copy it back: ``pda_torch.parallel.Mesh``) or the
CPU; with ``--backend nccl`` rank r is on card r (``--world`` cards). Each
rank builds the flagship PUNet (latent 6, Fcomb 3, rl_swap, consensus
masking; seeded weights, the Fcomb's last layer x8, as ``ab_step_check.py``)
and takes its rows of one global batch of ``--batch`` synthetic ``--hw``^2
frames and of the global noise, then runs one ``make_mean_teacher_step(mesh=)``
(Adam 1e-5, EMA 0.999), in float32 and in bf16. The test process then runs
the same step on the whole batch without a mesh, on the first card.
Held, for each dtype, against the single process:

  * the summed gradients, whose scale Adam's step hides (its first step
    moves each element by about +-lr whatever the gradient's size): the
    ratio of their global norms within 1e-4 of 1 (bf16 1e-3), 1 - their
    cosine at most 1e-5, and leaf by leaf, in float32 max|g - ref| within
    1e-4 of the leaf's largest (floored at 1e-3 of the largest leaf's, as
    ``tests/test_torch_parallel.py``), in bf16 the worst leaf's relative L2
    within 1e-2 (``ab.AB_LEAF_TOL``). A mean of the ranks' gradients, a
    differentiated collective (x N) or a lost gradient fails them;
  * the step taken once: the student's update (after - before) and the
    teacher's, each within 1e-2 of the single process's in relative L2. A
    skipped or repeated optimizer step fails it;
  * the loss, recon and KL within 1e-5 relative in float32 (``pda``'s
    ``tests/test_parallel.py``), the loss within 1e-3 in bf16 (``pda``'s
    bf16 A/B);
  * every rank holding the same bytes after the step (gradients, student,
    teacher); on the card, every kernel of the MT step launched on each rank.

On the card it also times, by CUDA events after 2 warm-up steps, the
median of 5 steps on each rank (both ranks share the card, so this is no
scaling number; with NCCL each rank has its own card), the all-reduce of
the step's gradient bucket alone (host clock, the copies included), and
the single-process step. Prints one ``dp_check result {json}`` line with
the card's name and power limit; exits 1 if a bound fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Optional

import torch

from . import ab
from .ab_step_check import BATCH, DTYPES, FILTERS, LR, MOMENTUM, SEED, flagship, synthetic_batch
from .common import add_device_arg, card, tool_device

F32_LOSS_TOL = 1e-5  # pda's tests/test_parallel.py
#: float32's gradients: max|g - ref| within this of the leaf's largest (of
#: 1e-3 of the largest leaf's at least), and the global norms' ratio
F32_GRAD_TOL, F32_NORM_TOL = 1e-4, 1e-4
#: bf16: the loss, 1 - the gradients' cosine (also float32's) and the worst
#: leaf's relative L2 (pda's bf16 A/B); the global norms' ratio
BF16_LOSS_TOL, COS_TOL, BF16_LEAF_TOL, BF16_NORM_TOL = (ab.AB_LOSS_TOL, ab.AB_COS_TOL,
                                                        ab.AB_LEAF_TOL, 1e-3)
#: the student's and the teacher's update against the single process's,
#: relative L2 (a sign that Adam's first step takes the other way where a
#: gradient lies near 0 moves it; a skipped or repeated step moves it by ~1)
UPDATE_TOL = 1e-2
WARMUP, TIMED = 2, 5


def _state(model, dev):
    from ..train import adam, create_train_state

    student = copy.deepcopy(model).to(dev)
    return create_train_state(student, adam(student.parameters(), LR), with_teacher=True)


def _step(state, batch, noise, mesh):
    """One MT step; the (summed) gradients, aux, student and teacher after it."""
    from ..train import make_mean_teacher_step

    step = make_mean_teacher_step(momentum=MOMENTUM, do_consensus_masking=True, mesh=mesh)
    _, aux = step(state, *batch, **noise)
    grads = {n: p.grad.detach().float().cpu() for n, p in state.model.named_parameters()
             if p.grad is not None}
    return {"aux": {k: float(v) for k, v in aux.items()}, "grads": grads,
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "teacher": {k: v.detach().cpu() for k, v in state.teacher.state_dict().items()}}


def _timed_steps(state, batch, noise, mesh) -> float:
    from ..train import make_mean_teacher_step

    step = make_mean_teacher_step(momentum=MOMENTUM, do_consensus_masking=True, mesh=mesh)
    times = []
    for i in range(WARMUP + TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, *batch, **noise)
        end.record()
        end.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _allreduce_ms(mesh, state) -> float:
    """The host-clock median of the all-reduce of one gradient bucket (the
    step's: every gradient, flat), the card waited for on both ends."""
    numel = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    flat = torch.zeros(numel, device=mesh.device)
    times = []
    for _ in range(TIMED):
        mesh.barrier()
        t0 = time.perf_counter()
        mesh.all_reduce_(flat)
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _rank(rank: int, world: int, tmp: str, device: str, backend: str) -> None:
    import torch.distributed as dist

    from ..parallel import get_mesh, shard_batch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    dev = tool_device(f"cuda:{rank}" if backend == "nccl" else device, "dp_check")
    mesh = get_mesh(world, device=dev, rank=rank, world_size=world, backend=backend,
                    store=dist.FileStore(os.path.join(tmp, "store"), world))
    out = {}
    try:
        wrappers = ab.kernel_wrappers()
        for name, case in spec.items():
            batch = [t.to(dev) for t in shard_batch(mesh, case["batch"])]
            noise = {k: v.to(dev) for k, v in case["noise"].items()}
            state = _state(case["model"], dev)
            ab.reset_launches(wrappers)
            res = _step(state, batch, noise, mesh)
            res["launches"] = ab.read_launches(wrappers, name == "bf16")
            if dev.type == "cuda":
                res["step_ms"] = _timed_steps(state, batch, noise, mesh)
                res["allreduce_ms"] = _allreduce_ms(mesh, state)
            out[name] = res
            del state
    finally:
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        mesh.destroy()


def _norm(d: dict) -> float:
    return sum(float(v.double().square().sum()) for v in d.values()) ** 0.5


def _cos(a: dict, b: dict) -> float:
    num = sum(float((a[k].double() * b[k].double()).sum()) for k in b)
    return num / max(_norm({k: a[k] for k in b}) * _norm(b), 1e-300)


def _f32_leaf(a: dict, b: dict) -> float:
    """The worst leaf's max|a - b| over the leaf's largest |b|, floored at
    1e-3 of the largest leaf's (a bias ahead of a norm has a gradient of 0
    up to float32's cancellation)."""
    largest = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k].double() - b[k].double()).abs().max())
               / max(float(b[k].abs().max()), 1e-3 * largest, 1e-300) for k in b)


def _bf16_leaf(a: dict, b: dict) -> float:
    """The worst leaf's relative L2 (``ab.ab_metrics``'s: floored at 1e-4 of
    the global norm)."""
    floor = 1e-4 * _norm(b)
    return max(float((a[k].double() - b[k].double()).norm()) / max(float(b[k].double().norm()),
                                                                   floor, 1e-300) for k in b)


def _update_rel(after: dict, ref: dict, before: dict) -> float:
    """||(after - before) - (ref - before)|| / ||ref - before||."""
    num = sum(float((after[k].double() - ref[k].double()).square().sum()) for k in ref)
    den = sum(float((ref[k].double() - before[k].double()).square().sum()) for k in ref)
    return (num / max(den, 1e-300)) ** 0.5


def compare(name: str, ranks: list, ref: dict, before: dict, on_card: bool) -> tuple:
    """({criterion: passed}, numbers) of one dtype's ranks against the
    single process; ``before`` is the student (and the teacher) before the
    step."""
    got = ranks[0]
    rel = {k: abs(got["aux"][k] - v) / max(1.0, abs(v)) for k, v in ref["aux"].items()}
    grads, gref = got["grads"], ref["grads"]
    nums = {"loss_rel": rel["loss"], "aux_rel": max(rel.values()),
            "cos": _cos(grads, gref),
            "norm_ratio": _norm({k: grads[k] for k in gref}) / max(_norm(gref), 1e-300),
            "leaf": (_f32_leaf if name == "f32" else _bf16_leaf)(grads, gref),
            "update": _update_rel(got["params"], ref["params"], before),
            "teacher_update": _update_rel(got["teacher"], ref["teacher"], before),
            "launches": [r["launches"] for r in ranks]}
    passed = {"ranks equal": all(
        all(torch.equal(r[part][k], got[part][k]) for k in got[part])
        for r in ranks[1:] for part in ("grads", "params", "teacher")),
        "grad leaves": grads.keys() == gref.keys()}
    if name == "f32":
        passed["loss"] = nums["aux_rel"] <= F32_LOSS_TOL
        passed["grad leaves"] &= nums["leaf"] <= F32_GRAD_TOL
        passed["norm"] = abs(nums["norm_ratio"] - 1.0) <= F32_NORM_TOL
    else:
        passed["loss"] = nums["loss_rel"] <= BF16_LOSS_TOL
        passed["grad leaves"] &= nums["leaf"] <= BF16_LEAF_TOL
        passed["norm"] = abs(nums["norm_ratio"] - 1.0) <= BF16_NORM_TOL
    passed["cos"] = 1.0 - nums["cos"] <= COS_TOL
    passed["update"] = nums["update"] <= UPDATE_TOL and nums["teacher_update"] <= UPDATE_TOL
    if on_card:
        passed["launched"] = all(all(r["launches"].values()) for r in ranks)
        nums["step_ms"] = [r["step_ms"] for r in ranks]
        nums["allreduce_ms"] = [r["allreduce_ms"] for r in ranks]
    return passed, nums


def main(argv: Optional[list] = None) -> int:
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=int, default=512)
    parser.add_argument("--filters", default=",".join(map(str, FILTERS)))
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--batch", type=int, default=BATCH, help="the global batch")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                        help="gloo: every rank on one device; nccl: rank r on card r")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "dp_check")
    if dev.type == "cuda" and dev.index is None:  # gloo: every rank on this one card
        dev = torch.device("cuda", torch.cuda.current_device())
    if args.backend == "nccl" and (dev.type != "cuda" or args.world > torch.cuda.device_count()):
        raise RuntimeError(f"dp_check: --backend nccl needs --world ({args.world}) cards, this "
                           f"host has {torch.cuda.device_count()}")
    filters = tuple(int(f) for f in args.filters.split(","))
    spec = {}
    for name in DTYPES:
        gen = torch.Generator().manual_seed(SEED)
        batch = synthetic_batch(args.hw, gen, SEED, "cpu", args.batch)
        spec[name] = {"model": flagship(filters, DTYPES[name], SEED), "batch": batch,
                      "noise": {"eps_teacher": torch.randn(ab.MC, args.batch, 6, generator=gen),
                                "eps_post": torch.randn(args.batch, 6, generator=gen)}}
    result = {"hw": args.hw, "filters": list(filters), "world": args.world, "batch": args.batch,
              "backend": args.backend, "card": card(dev)}
    ok = True
    with tempfile.TemporaryDirectory(prefix="dp_check_") as tmp:
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        t0 = time.perf_counter()
        mp.spawn(_rank, args=(args.world, tmp, str(dev), args.backend),
                 nprocs=args.world, join=True)
        result["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(args.world)]
    for name in DTYPES:
        case = spec[name]
        batch = [t.to(dev) for t in case["batch"]]
        noise = {k: v.to(dev) for k, v in case["noise"].items()}
        ref = _step(_state(case["model"], dev), batch, noise, None)
        before = {k: v.detach() for k, v in case["model"].state_dict().items()}
        passed, nums = compare(name, [r[name] for r in ranks], ref, before, dev.type == "cuda")
        if dev.type == "cuda":
            nums["single_ms"] = _timed_steps(_state(case["model"], dev), batch, noise, None)
        result[name] = {**nums, "passed": passed}
        ab.log(f"dp_check {name} MT step {args.hw}^2 batch {args.batch} world {args.world} "
               f"({args.backend}) vs one process: {nums} "
               f"{'ok' if all(passed.values()) else 'FAIL'}")
        ok &= all(passed.values())
    print("dp_check result " + json.dumps({**result, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
