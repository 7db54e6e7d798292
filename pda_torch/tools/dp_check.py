"""The flagship Mean-Teacher step data-parallel, or row-sharded, against
the same step in one process.

    python -m pda_torch.tools.dp_check [--hw 512] [--filters 64,128,256,512]
        [--world 2] [--space M] [--batch 2] [--backend gloo|nccl]
        [--device cuda|cpu]

``--space M`` makes the ranks a (data, space) mesh of ``--world / M`` x M
(``pda_torch.parallel.get_mesh_2d``): each rank holds its rows of the batch
and its row shard of each image, and every 3-conv block exchanges 4
boundary rows with its space neighbours. Each rank then also reports the
halo exchanges of one step: their count (forward and backward) and their
milliseconds (CUDA events around each, in a step of their own).

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
    within 1e-2 (``ab.AB_LEAF_TOL``; on a space mesh float32's leaf within
    1e-2, ``SPACE_F32_LEAF_TOL``, and bf16 ``SPACE_BF16``'s bounds: the
    shards round otherwise, the encoders' mean completed in bf16 at
    ``pda``'s rounding point). A mean of the ranks' gradients, a
    differentiated collective (x N) or a lost gradient fails them;
  * the step taken once: the student's update (after - before) and the
    teacher's, each within 1e-2 of the single process's in relative L2. A
    skipped or repeated optimizer step fails it;
  * the loss, recon and KL within 1e-5 relative in float32 (``pda``'s
    ``tests/test_parallel.py``), the loss within 1e-3 in bf16 (``pda``'s
    bf16 A/B; 1e-2 on a space mesh, ``SPACE_BF16``);
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
#: bf16 on a (data, space) mesh: the loss, 1 - the gradients' cosine, the
#: worst leaf's relative L2, the global norms' ratio and the updates. The
#: encoders' mean is completed over the row shards in bf16 (``pda``'s
#: rounding point), which moves the latent statistics by up to a few bf16
#: ulps against one process's mean, rounded once: the MT step at 144^2 on
#: the CPU (``tests/test_torch_space.py``'s run of this tool) parts by
#: 1.4e-5, 1.07e-2, 1.1e-3 and 0.10 (Adam's first step flips the elements
#: whose small gradients change sign); on the card at 1024^2, batch 1, on
#: (1, 4), where one image's KL (most of the random flagship's loss) moves
#: with them, the loss by 4.9e-3. Each still fails the faults it is there
#: for (a mean of the gradients: a ratio of 1/N; a skipped step: an update
#: of 1)
SPACE_BF16 = {"loss": 1e-2, "cos": 1e-4, "leaf": 5e-2, "norm": 1e-2, "update": 0.25}
#: float32 on a (data, space) mesh: the worst leaf's max|g - ref| over its
#: largest. The row shards change float32's roundings (the encoders' mean a
#: mean of the shards' means, the upsample two matrix contractions), so a
#: ReLU pre-activation within rounding of 0 may take the other side and move
#: one leaf (a few 1e-3 of its largest card vs CPU, PR 6): 3.2e-4 at 288^2,
#: batch 1, on (1, 4) on the CPU. The cosine and the norm keep float32's
#: bounds
SPACE_F32_LEAF_TOL = 1e-2
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
    grads = {n: p.grad.detach().float().cpu().clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    return {"aux": {k: float(v) for k, v in aux.items()}, "grads": grads,
            "params": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "teacher": {k: v.detach().cpu().clone()
                        for k, v in state.teacher.state_dict().items()}}


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


def _halos(state, batch, noise, mesh) -> dict:
    """The halo exchanges of one MT step: their count, and their
    milliseconds summed (each timed alone)."""
    from ..parallel import space

    space.reset_stats()
    with space.timed_exchanges() as ms:
        _step(state, batch, noise, mesh)
    return {"exchanges": space.stats["exchanges"], "ms": sum(ms),
            "mib": space.stats["elements"] * (2 if state.model.dtype == torch.bfloat16 else 4)
            / 2**20}


def _rank(rank: int, world: int, n_space: int, tmp: str, device: str, backend: str) -> None:
    import torch.distributed as dist

    from ..parallel import get_mesh, get_mesh_2d, shard_batch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    dev = tool_device(f"cuda:{rank}" if backend == "nccl" else device, "dp_check")
    kw = dict(device=dev, rank=rank, world_size=world, backend=backend,
              store=dist.FileStore(os.path.join(tmp, "store"), world))
    mesh = (get_mesh_2d(world // n_space, n_space, **kw) if n_space > 1
            else get_mesh(world, **kw))
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
            if n_space > 1:
                res["halo"] = _halos(state, batch, noise, mesh)
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


def compare(name: str, ranks: list, ref: dict, before: dict, on_card: bool,
            row_sharded: bool = False) -> tuple:
    """({criterion: passed}, numbers) of one dtype's ranks against the
    single process; ``before`` is the student (and the teacher) before the
    step; ``row_sharded``: the bf16 bounds of a (data, space) mesh."""
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
        passed["grad leaves"] &= nums["leaf"] <= (SPACE_F32_LEAF_TOL if row_sharded
                                                  else F32_GRAD_TOL)
        passed["norm"] = abs(nums["norm_ratio"] - 1.0) <= F32_NORM_TOL
    tol = {"loss": BF16_LOSS_TOL, "cos": COS_TOL, "leaf": BF16_LEAF_TOL, "norm": BF16_NORM_TOL,
           "update": UPDATE_TOL}
    if name != "f32" and row_sharded:
        tol = SPACE_BF16
    if name != "f32":
        passed["loss"] = nums["loss_rel"] <= tol["loss"]
        passed["grad leaves"] &= nums["leaf"] <= tol["leaf"]
        passed["norm"] = abs(nums["norm_ratio"] - 1.0) <= tol["norm"]
    passed["cos"] = 1.0 - nums["cos"] <= tol["cos"]
    passed["update"] = (nums["update"] <= tol["update"]
                        and nums["teacher_update"] <= tol["update"])
    if on_card:
        passed["launched"] = all(all(r["launches"].values()) for r in ranks)
        nums["step_ms"] = [r["step_ms"] for r in ranks]
        nums["allreduce_ms"] = [r["allreduce_ms"] for r in ranks]
    if "halo" in got:
        nums["halo"] = [r["halo"] for r in ranks]
    return passed, nums


def main(argv: Optional[list] = None) -> int:
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=int, default=512)
    parser.add_argument("--filters", default=",".join(map(str, FILTERS)))
    parser.add_argument("--world", type=int, default=2, help="the ranks, N x M with --space")
    parser.add_argument("--space", type=int, default=1,
                        help="M > 1: a (data, space) mesh of world / M x M ranks")
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
    if args.space < 1 or args.world % args.space:
        raise ValueError(f"dp_check: --space {args.space} does not divide --world {args.world}")
    filters = tuple(int(f) for f in args.filters.split(","))
    spec = {}
    for name in DTYPES:
        gen = torch.Generator().manual_seed(SEED)
        batch = synthetic_batch(args.hw, gen, SEED, "cpu", args.batch)
        spec[name] = {"model": flagship(filters, DTYPES[name], SEED), "batch": batch,
                      "noise": {"eps_teacher": torch.randn(ab.MC, args.batch, 6, generator=gen),
                                "eps_post": torch.randn(args.batch, 6, generator=gen)}}
    result = {"hw": args.hw, "filters": list(filters), "world": args.world, "batch": args.batch,
              "mesh": {"data": args.world // args.space, "space": args.space},
              "backend": args.backend, "card": card(dev)}
    ok = True
    with tempfile.TemporaryDirectory(prefix="dp_check_") as tmp:
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        t0 = time.perf_counter()
        mp.spawn(_rank, args=(args.world, args.space, tmp, str(dev), args.backend),
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
        passed, nums = compare(name, [r[name] for r in ranks], ref, before, dev.type == "cuda",
                               args.space > 1)
        if dev.type == "cuda":
            nums["single_ms"] = _timed_steps(_state(case["model"], dev), batch, noise, None)
        result[name] = {**nums, "passed": passed}
        ab.log(f"dp_check {name} MT step {args.hw}^2 batch {args.batch} mesh "
               f"{result['mesh']} ({args.backend}) vs one process: {nums} "
               f"{'ok' if all(passed.values()) else 'FAIL'}")
        ok &= all(passed.values())
    print("dp_check result " + json.dumps({**result, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
