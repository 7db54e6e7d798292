"""The ``data`` mesh and the (``data``, ``space``) mesh over
``torch.distributed`` (port of ``pda/parallel/mesh.py``).

``pda`` runs one controller over many devices: a 1-D ``data`` mesh axis,
batches sharded on their leading axis, parameters replicated, the step
inside ``jax.shard_map`` with explicit ``psum``s. PyTorch's idiom is one
process per rank, so the port is multi-process SPMD: every rank runs the
same program on its rows of the global batch, and the reductions that
``pda`` runs over the mesh axis run as collectives of the rank's
:class:`Mesh`:

  * the batch reductions of the losses and metrics are value-global and
    gradient-local (:mod:`pda_torch.core.losses`);
  * the gradients are summed across ranks, never averaged, before the
    optimizer's step (:mod:`pda_torch.train.steps`);
  * every rank draws the same global-batch noise and keeps its slice
    (:func:`pda_torch.core.distributions.sharded_normal`).

The 2-D (``data``, ``space``) mesh (:func:`get_mesh_2d`) also shards the
image rows (H of NHWC) over ``space``: ``pda``'s device grid
``reshape(n_data, n_space)``, so global rank r has data index
``r // n_space`` and space index ``r % n_space``, and the space neighbours
are adjacent ranks. Each rank holds three process groups: the world, its
``data`` group (the ranks of its space index) and its ``space`` group (the
ranks of its data index); :meth:`Mesh.axis` is the rank's view of one axis.
Every 3-conv block exchanges boundary rows with its space neighbours
(:mod:`.space`, :mod:`pda_torch.models.blocks`), the pixel reductions cross
the world, the per-image ones (the KL's batch mean, the noise's rows) the
``data`` axis only.

A rank's device is ``cuda:LOCAL_RANK`` with the NCCL backend, or the CPU
with gloo; the device that is asked for picks the backend. A mesh may be
asked for gloo on the card (several ranks sharing one card, which NCCL
refuses): its collectives then copy each CUDA tensor to the host, reduce
it there and copy it back, explicitly (:meth:`Mesh.all_reduce_`), and the
tensors stay on the card for everything else.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"

#: the launch line a CLI needs for a data mesh of N ranks
LAUNCH_HINT = ("torchrun --nproc-per-node {n} -m pda_torch.experiments.<cli> --mesh data={n}")
#: the launch line of a (data=N, space=M) mesh: N * M ranks
LAUNCH_HINT_2D = ("torchrun --nproc-per-node {n} -m pda_torch.experiments.<cli> "
                  "--mesh data={n_data},space={n_space}")


class Mesh:
    """One rank's view of a mesh: its process group, the world size, its
    rank, its device and the backend; ``shape`` maps each axis to its size
    (``{"data": N}``, or ``{"data": N, "space": M}``, the world N * M).
    Every rank holds one. :meth:`axis` is the rank's view of one axis of a
    2-D mesh: a 1-D mesh over that axis's group, whose ``rank`` is the
    rank's index on the axis and whose ``ranks`` are its members' global
    ranks."""

    def __init__(self, group, world: int, rank: int, device: torch.device, backend: str,
                 store=None, *, shape: Optional[dict] = None, axes: Optional[dict] = None,
                 ranks: Optional[Sequence[int]] = None, owner: bool = True):
        self.group = group
        self.world = world
        self.rank = rank
        self.device = device
        self.backend = backend
        self.store = store
        self.shape = dict(shape or {DATA_AXIS: world})
        #: the global ranks of this group's members, in their order on the axis
        self.ranks = list(range(world) if ranks is None else ranks)
        self._axes = axes or {}
        #: whether :meth:`destroy` ends the process group (an axis's view does not)
        self._owner = owner
        self._waits = 0

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, rank={self.rank}, device={self.device}, backend={self.backend})"

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_space(self) -> int:
        return self.shape.get(SPACE_AXIS, 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    def axis(self, name: str) -> "Mesh":
        """This rank's 1-D view of the axis ``name``: the mesh itself on a
        1-D mesh's ``data`` axis; on a 2-D mesh a mesh over the axis's
        group (it ends no process group: :meth:`destroy` of the mesh does)."""
        if name not in self.shape:
            raise ValueError(f"{self} has no '{name}' axis")
        if len(self.shape) == 1:
            return self
        return self._axes[name]

    @property
    def space(self) -> Optional["Mesh"]:
        """The ``space`` axis's view, or None on a 1-D mesh."""
        return self.axis(SPACE_AXIS) if SPACE_AXIS in self.shape else None

    def flat(self) -> "Mesh":
        """This rank's view of the whole world as one ``data`` axis (the
        tiled serving's: ``pda`` shards the tiles over every device)."""
        if len(self.shape) == 1:
            return self
        return Mesh(self.group, self.world, self.rank, self.device, self.backend, self.store,
                    owner=False)

    # -- collectives ----------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether this collective goes through host memory: gloo on a CUDA
        tensor. NCCL takes CUDA tensors only."""
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError(f"{self}: NCCL reduces CUDA tensors only, got one on {t.device}")
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self._staged(t):
            host = t.to("cpu")
            dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor (``t`` is not
        touched, and no gradient flows through the result)."""
        return self.all_reduce_(t.detach().clone())

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t``, concatenated on axis ``dim`` in rank order."""
        t = t.detach().contiguous()
        if self._staged(t):
            parts = [torch.empty_like(t, device="cpu") for _ in range(self.world)]
            dist.all_gather(parts, t.to("cpu"), group=self.group)
            return torch.cat(parts, dim=dim).to(t.device)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` into every rank's ``t``, in place."""
        if self._staged(t):
            host = t.to("cpu")
            dist.broadcast(host, src=self.ranks[src], group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t

    def broadcast_float(self, value: float, src: int = 0) -> float:
        """Rank ``src``'s Python float on every rank."""
        t = torch.tensor([value], dtype=torch.float64,
                         device=self.device if self.backend == "nccl" else "cpu")
        return float(self.broadcast_(t, src))

    def barrier(self) -> None:
        """Wait until every rank is here."""
        t = torch.zeros(1, device=self.device if self.backend == "nccl" else "cpu")
        self.all_reduce_(t)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def wait_for_rank0(self, timeout: timedelta = timedelta(days=1)) -> None:
        """Rank 0 marks that it is done; every other rank waits for the mark.
        Through the group's store, not a collective, so that a long phase of
        rank 0 alone (a CLI's predictions) trips no collective's timeout."""
        self._waits += 1
        key = f"pda_torch/rank0_done/{self._waits}"
        if self.rank == 0:
            self.store.set(key, "1")
        else:
            self.store.wait([key], timeout)

    # -- rows -----------------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (:func:`rank_rows`),
        by its ``data`` index."""
        return rank_rows(n, self.data_index, self.n_data)

    def image_rows(self, h: int) -> slice:
        """This rank's image rows of an image of ``h`` rows
        (:func:`space_rows`), by its ``space`` index."""
        return space_rows(h, self.space_index, self.n_space)

    def destroy(self) -> None:
        """End the process group (once; a mesh made without one, as the tests
        make them, and an axis's view have nothing to end)."""
        if self._owner and self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None


def rank_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows ``[r n/N, (r+1) n/N)`` of a global batch of
    ``n``; raises, with ``pda``'s message, when N does not divide ``n``."""
    if n % world:
        raise ValueError(
            f"batch size {n} is not divisible by the mesh's '{DATA_AXIS}' axis ({world}); "
            "pick a batch size that is a multiple of it (watch out for a short final batch)")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def space_rows(h: int, index: int, n_space: int) -> slice:
    """Row shard ``index``'s rows ``[s h/M, (s+1) h/M)`` of an image of ``h``
    rows; raises, with ``pda``'s message, when M does not divide ``h``."""
    if h % n_space:
        raise ValueError(f"image height {h} is not divisible by the mesh's '{SPACE_AXIS}' axis "
                         f"({n_space})")
    r = h // n_space
    return slice(index * r, (index + 1) * r)


def _device_for(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("get_mesh: no CUDA card (torch.cuda.is_available() is False); "
                               "pass device='cpu' for a gloo mesh on the CPU")
        index = local_rank if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"get_mesh: local rank {local_rank} asks for cuda:{index}, but "
                             f"this host has {torch.cuda.device_count()} card(s)")
        dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise ValueError(f"get_mesh: a mesh runs on 'cuda' or 'cpu', not {dev}")
    return dev


def _launcher() -> Optional[tuple]:
    """(rank, world, local rank) from ``torchrun``'s environment, or None."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def _init_world(n_devices: Optional[int], hint: str, device, rank, world_size, store,
                backend) -> tuple:
    """The process group of this rank's world (:func:`get_mesh`'s rules):
    ``(rank, world, device, backend, store)``."""
    explicit = (rank, world_size, store)
    if any(v is not None for v in explicit) and not all(v is not None for v in explicit):
        raise ValueError("get_mesh: pass rank, world_size and store together, or none of them")
    if rank is not None:
        world, local_rank = world_size, rank
    elif _launcher() is not None:
        rank, world, local_rank = _launcher()
    else:
        rank, world, local_rank, store = 0, 1, 0, dist.HashStore()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"get_mesh: the mesh asks for {n_devices} rank(s), but this process runs in a world "
            f"of {world}; start one process a rank, e.g. " + hint)
    if dist.is_initialized():
        raise RuntimeError("get_mesh: this process has a torch.distributed process group "
                           "already; make one mesh a process and pass it on")
    dev = _device_for(device, local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("get_mesh: NCCL needs device='cuda'")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"get_mesh: backend {backend!r}: use 'nccl' or 'gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if store is None:  # torchrun: its rendezvous, which also hosts the store
        store, rank, world = next(dist.rendezvous("env://"))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    return rank, world, dev, backend, store


def get_mesh(n_devices: Optional[int] = None, *, device="cuda", rank: Optional[int] = None,
             world_size: Optional[int] = None, store=None,
             backend: Optional[str] = None) -> Mesh:
    """This rank's 1-D ``data`` mesh, and the process group under it.

    The world is, in this order: the explicit ``rank``, ``world_size`` and
    ``store`` (a ``torch.distributed`` store: ``FileStore``, ``HashStore``
    for a world of 1, ``TCPStore``), as the tests and the card tools pass
    them; ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, the rendezvous at ``MASTER_ADDR:MASTER_PORT``); else a
    world of 1 in this process. ``n_devices`` is the world asked for: a
    world of another size raises, with the launch line that would give it.
    One mesh a process: where a process group exists already this raises
    (a CLI makes its mesh once and hands it to its trainers).

    ``device``: ``"cuda"`` is ``cuda:LOCAL_RANK`` (made the current device)
    with NCCL, ``"cpu"`` is gloo. ``backend="gloo"`` on the card lets
    several ranks share one card (NCCL refuses that); its collectives then
    go through host memory (:class:`Mesh`)."""
    hint = LAUNCH_HINT.format(n=n_devices)
    rank, world, dev, backend, store = _init_world(n_devices, hint, device, rank, world_size,
                                                   store, backend)
    mesh = Mesh(dist.group.WORLD, world, rank, dev, backend, store=store)
    atexit.register(mesh.destroy)
    return mesh


def get_mesh_2d(n_data: int, n_space: int, *, device="cuda", rank: Optional[int] = None,
                world_size: Optional[int] = None, store=None,
                backend: Optional[str] = None) -> Mesh:
    """This rank's (``data``, ``space``) mesh of ``n_data * n_space`` ranks:
    batches sharded over ``data``, image rows over ``space`` (``pda``'s
    ``get_mesh_2d``; the world and the device as :func:`get_mesh` finds
    them). Global rank r is ``(r // n_space, r % n_space)`` on the grid. Every
    rank makes every ``data`` group (the ranks of one space index) and every
    ``space`` group (the ranks of one data index), in the same order, and
    keeps its own (an axis as wide as the world takes the world's group);
    one all-reduce on each sets up their communicators."""
    if n_data < 1 or n_space < 1:
        raise ValueError(f"get_mesh_2d: (data={n_data}, space={n_space}): each axis needs >= 1")
    n = n_data * n_space
    hint = LAUNCH_HINT_2D.format(n=n, n_data=n_data, n_space=n_space)
    rank, world, dev, backend, store = _init_world(n, hint, device, rank, world_size, store,
                                                   backend)
    members = {DATA_AXIS: [[d * n_space + s for d in range(n_data)] for s in range(n_space)],
               SPACE_AXIS: [[d * n_space + s for s in range(n_space)] for d in range(n_data)]}
    index = {DATA_AXIS: (rank % n_space, rank // n_space),
             SPACE_AXIS: (rank // n_space, rank % n_space)}
    axes = {}
    for name, groups in members.items():
        # an axis as wide as the world is the world's group (no second communicator)
        made = [dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                for ranks in groups]
        which, pos = index[name]
        axes[name] = Mesh(made[which], len(groups[which]), pos, dev, backend, store,
                          ranks=groups[which], owner=False)
    mesh = Mesh(dist.group.WORLD, world, rank, dev, backend, store=store,
                shape={DATA_AXIS: n_data, SPACE_AXIS: n_space}, axes=axes)
    atexit.register(mesh.destroy)
    for view in axes.values():
        view.barrier()
    return mesh


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every array of ``batch`` (a tuple of arrays or
    tensors, leading axis the batch) and, on a 2-D mesh, of an image's
    rows (axis 1 of an array of 3 or more axes); a 0-d leaf is kept whole.
    Raises, with ``pda``'s messages, when N does not divide the batch or M
    the image's height."""
    out = []
    for x in batch:
        if np.ndim(x) == 0:
            out.append(x)
            continue
        x = x[mesh.rows(int(x.shape[0]))]
        if SPACE_AXIS in mesh.shape and np.ndim(x) >= 3:
            x = x[:, mesh.image_rows(int(x.shape[1]))]
        out.append(x)
    return tuple(out)


def _tensors(modules: Iterable[torch.nn.Module]) -> list:
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def _fingerprint(tensors: Sequence[torch.Tensor]) -> int:
    """An exact, order-free hash of the tensors' bytes: the sum of each
    32-bit word (each byte where a tensor's size is not a multiple of 4)
    times a position weight, in int64 (wrapping)."""
    total = 0
    for i, t in enumerate(tensors):
        raw = t.detach().contiguous().reshape(-1)
        words = (raw.view(torch.int32) if raw.numel() * raw.element_size() % 4 == 0
                 else raw.view(torch.uint8)).to(torch.int64)
        weights = torch.arange(words.numel(), device=words.device, dtype=torch.int64)
        total += int((words * (weights % 1_000_003 + i + 1)).sum())
    return total & (2**63 - 1)


def assert_replicated(mesh: Mesh, *modules: torch.nn.Module) -> None:
    """Raise unless every rank holds the same bytes in the modules'
    parameters and buffers."""
    fp = torch.tensor([_fingerprint(_tensors(modules))], dtype=torch.int64,
                      device=mesh.device if mesh.backend == "nccl" else "cpu")
    every = mesh.all_gather(fp).cpu().tolist()
    if len(set(every)) != 1:
        raise RuntimeError(f"{mesh}: the ranks' parameters differ (fingerprints {every})")


def replicated(mesh: Mesh, *modules: torch.nn.Module) -> None:
    """Replicate the modules' parameters and buffers: rank 0's are
    broadcast to every rank, then :func:`assert_replicated` checks them."""
    with torch.no_grad():
        for t in _tensors(modules):
            mesh.broadcast_(t.data, src=0)
    assert_replicated(mesh, *modules)
