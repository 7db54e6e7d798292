"""Batch loader: patch sampling by worker processes or threads (port of
``pda/data/loader.py``).

A ``Loader`` yields tuples of NHWC numpy batches; the trainer copies them to
the card. Worker modes:

  * ``worker_mode="process"`` (the default with ``num_workers > 0``):
    worker processes (forkserver, so none inherits the parent's CUDA
    context; the server preloads the datasets module) that each receive the
    dataset once and write every sample into a slot of one
    ``multiprocessing.shared_memory`` slab; only (epoch, index, slot) and
    the fields' layout cross the pipe.
  * ``worker_mode="thread"``: a thread pool, also the fallback (with a
    warning) for a dataset that cannot be sent to a process.

Under ``PDA_NATIVE_AUGS`` the parent builds the native library
(:mod:`.native`) before its workers start, and each worker loads the built
file; the workers take the parent's switch. A host with one core samples
inline whatever ``num_workers`` says, unless ``force_workers``.
Determinism: sample ``i`` of epoch ``e`` always uses
``default_rng((seed, e, i))``, whatever the worker count or mode; the shuffle
of epoch ``e`` uses ``default_rng((seed, e))``. ``drop_last=True`` by
default, so every batch has one shape.

On a data mesh (:mod:`pda_torch.parallel`) ``shard=(rank, world)`` makes the
loader fetch only the rank's rows of every global batch (the same samples,
by the seeding above, with 1/world of the host work); a batch that
``world`` does not divide raises. On a (data, space) mesh ``set_shard(...,
space=(index, M))`` also hands the rank its rows of each image (axis 1 of
an array of 3 or more axes): the samples are drawn whole, as one process
draws them, and cut after.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
import warnings
from multiprocessing import shared_memory
from typing import Iterator, Sequence

import numpy as np

from . import native

_WORKER_DATASET = None
_WORKER_SHM = None


def _worker_init(dataset, shm_name, native_augs):
    global _WORKER_DATASET, _WORKER_SHM
    # the parent's switch, not the forkserver's environment of its start
    os.environ["PDA_NATIVE_AUGS"] = native_augs
    _WORKER_DATASET = dataset
    _WORKER_SHM = shared_memory.SharedMemory(name=shm_name) if shm_name else None


def _worker_fetch(seed, epoch, index):
    rng = np.random.default_rng((seed, epoch, int(index)))
    return _WORKER_DATASET.sample(int(index), rng)


def _worker_fetch_shm(seed, epoch, index, slot, slot_nbytes):
    """Sample, then write every field into this task's shared-memory slot;
    only the fields' (shape, dtype, offset) return through the pipe."""
    fields = _worker_fetch(seed, epoch, index)
    total = sum(np.ascontiguousarray(f).nbytes for f in fields)
    if total > slot_nbytes:
        raise ValueError(f"sample ({total} B) exceeds its shared-memory slot ({slot_nbytes} B); "
                         "are sample shapes non-constant?")
    buf = _WORKER_SHM.buf
    off = slot * slot_nbytes
    layout = []
    for f in fields:
        a = np.ascontiguousarray(f)
        dst = np.frombuffer(buf, dtype=np.uint8, count=a.nbytes, offset=off)
        dst[:] = a.view(np.uint8).reshape(-1)
        layout.append((a.shape, a.dtype.str, off))
        off += a.nbytes
    return slot, tuple(layout)


def _forkserver():
    """The forkserver context, its server preloading the datasets module (and
    with it numpy, scipy and the transforms), so that a worker forked from it
    starts with them imported: a pool of 8 then starts in a fraction of a
    second, not the several seconds of 8 processes importing them side by
    side. ``__main__`` stays preloaded, as by default."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", f"{__package__}.datasets"])
    return ctx


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - not on Linux
        return os.cpu_count() or 1


class Loader:
    """Iterable over stacked batches: each item is a tuple of NHWC arrays."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True, num_workers: int = 0,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 worker_mode: str = "process", force_workers: bool = False, shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        #: run the workers even on a one-core host
        self.force_workers = force_workers
        self._epoch = 0
        self._pool = None
        self._shm = None
        self._slot_nbytes = 0
        self._n_slots = 0
        self._free_slots: list = []
        self._pending_pool = None  # a process pool before its first fetch succeeded
        #: (rank, world): fetch only that rank's rows of each batch
        self.shard = None
        #: (index, n_space): keep only that row shard of each image
        self.space = None
        if shard is not None:
            self.set_shard(*shard)

    def set_shard(self, rank: int, world: int, space=None) -> None:
        """Fetch only rank ``rank``'s rows of each batch on a mesh of
        ``world`` ranks (on a 2-D mesh: the data index and the data axis);
        raises where ``world`` does not divide the batch. ``space=(index,
        M)``: keep row shard ``index`` of M of each image, which raises where
        M does not divide its height."""
        from ..parallel.mesh import rank_rows  # not at import: the workers import no torch

        if not 0 <= rank < world:
            raise ValueError(f"shard: rank {rank} is not in a world of {world}")
        rank_rows(self.batch_size, rank, world)
        if space is not None and not 0 <= space[0] < space[1]:
            raise ValueError(f"shard: row shard {space[0]} is not one of {space[1]}")
        self.shard, self.space = (rank, world), space

    # ------------------------------------------------------------------ pool

    def _depth(self) -> int:
        """Batches in flight: enough that every worker has a sample queued."""
        return max(self.prefetch + 1,
                   (2 * self.num_workers + self.batch_size - 1) // self.batch_size)

    def _get_pool(self):
        """The worker pool, made on first use and kept across epochs."""
        if self._pool is not None:
            return self._pool
        if self.worker_mode == "process":
            try:
                self._pool = ("process", self._make_shm_pool())
                return self._pool
            except Exception as e:
                warnings.warn(f"shared-memory process pool unavailable ({type(e).__name__}: "
                              f"{e}); falling back to thread workers, which do not scale for "
                              "large patches", RuntimeWarning, stacklevel=2)
                if self._pending_pool is not None:
                    self._pending_pool.shutdown(wait=False, cancel_futures=True)
                    self._pending_pool = None
                self._release_shm()
        self._pool = ("thread", cf.ThreadPoolExecutor(max_workers=self.num_workers))
        return self._pool

    def _make_shm_pool(self):
        # one probe sample sizes the slots (fixed patch shapes; 2x headroom)
        probe = self._fetch(0, 0)
        self._slot_nbytes = 2 * sum(np.ascontiguousarray(f).nbytes for f in probe)
        self._n_slots = self._depth() * self.batch_size + self.num_workers
        self._shm = shared_memory.SharedMemory(
            create=True, size=max(self._slot_nbytes * self._n_slots, 1))
        # the slots belong to the Loader, so two live iterators never share one
        self._free_slots = list(range(self._n_slots))
        native_augs = native.enabled()
        if native_augs:  # built once here, so no two workers compile it
            native.build()
        pool = cf.ProcessPoolExecutor(max_workers=self.num_workers,
                                      mp_context=_forkserver(),
                                      initializer=_worker_init,
                                      initargs=(self.dataset, self._shm.name,
                                                "1" if native_augs else "0"))
        self._pending_pool = pool
        # one first fetch a worker, submitted together so that every worker
        # starts now (the pool starts them as tasks wait), not in the first
        # epoch; ``pda`` makes one
        warm = [pool.submit(_worker_fetch_shm, self.seed, 0, 0, slot, self._slot_nbytes)
                for slot in range(min(self.num_workers, self._n_slots))]
        for f in warm:
            f.result()
        self._pending_pool = None
        return pool

    def _release_shm(self) -> None:
        if self._shm is not None:
            try:
                self._shm.close()
                self._shm.unlink()
            except Exception:
                pass
            self._shm = None

    def _read_slot(self, layout) -> tuple:
        buf = self._shm.buf
        out = []
        for shape, dstr, off in layout:
            dt = np.dtype(dstr)
            n = int(np.prod(shape)) * dt.itemsize
            a = np.frombuffer(buf, dtype=np.uint8, count=n, offset=off)
            out.append(a.view(dt).reshape(shape).copy())
        return tuple(out)

    def close(self) -> None:
        """Stop the workers and free the shared memory; the next epoch starts
        a new pool. The workers are waited for (``pda`` does not wait): none
        outlives its Loader, and none is still starting when the slab goes."""
        if self._pool is not None:
            pool, self._pool = self._pool[1], None
            try:
                pool.shutdown(wait=True, cancel_futures=True)
            except Exception:
                pass
        self._release_shm()

    def __del__(self):
        self.close()

    # ------------------------------------------------------------ iteration

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def _fetch(self, epoch: int, index: int):
        rng = np.random.default_rng((self.seed, epoch, int(index)))
        return self.dataset.sample(int(index), rng)

    def _stack(self, samples: Sequence[tuple]) -> tuple:
        batch = tuple(np.stack([s[f] for s in samples], axis=0) for f in range(len(samples[0])))
        if self.space is None:
            return batch
        from ..parallel.mesh import space_rows

        return tuple(b[:, space_rows(b.shape[1], *self.space)] if b.ndim >= 3 else b
                     for b in batch)

    def __iter__(self) -> Iterator[tuple]:
        epoch = self._epoch
        self._epoch += 1
        indices = self._epoch_indices(epoch)
        n_full = len(indices) // self.batch_size
        if not self.drop_last and len(indices) % self.batch_size:
            n_batches = n_full + 1
        elif self.drop_last and n_full == 0 and len(indices) > 0:
            raise ValueError(f"dataset ({len(indices)} samples) is smaller than "
                             f"batch_size={self.batch_size} with drop_last=True; lower the "
                             "batch size or pass drop_last=False")
        else:
            n_batches = n_full
        if n_batches == 0:
            return

        if self.shard is not None:
            from ..parallel.mesh import rank_rows

        def batch_slice(b):
            rows = indices[b * self.batch_size: (b + 1) * self.batch_size]
            return rows if self.shard is None else rows[rank_rows(len(rows), *self.shard)]

        workers = self.num_workers if (_cores() > 1 or self.force_workers) else 0
        if workers <= 0:
            for b in range(n_batches):
                rows = batch_slice(b)
                if len(rows):
                    yield self._stack([self._fetch(epoch, i) for i in rows])
            return

        depth = self._depth()
        mode, pool = self._get_pool()
        pending = []  # batches in flight, each a list of (future, slot)

        def take_slot():
            try:
                return self._free_slots.pop()
            except IndexError:
                raise RuntimeError("no free shared-memory slot: another live iterator over "
                                   "this Loader holds them all (close/exhaust it first)") from None

        def submit_batch(b):
            rows = batch_slice(b)
            if mode != "process":
                return [(pool.submit(self._fetch, epoch, i), None) for i in rows]
            out = []
            try:
                for i in rows:
                    slot = take_slot()
                    out.append((pool.submit(_worker_fetch_shm, self.seed, epoch, int(i), slot,
                                            self._slot_nbytes), slot))
            except BaseException:
                _drain([out], self._free_slots)
                raise
            return out

        current, next_b = None, 0
        try:
            while next_b < n_batches and len(pending) < depth:
                pending.append(submit_batch(next_b))
                next_b += 1
            while pending:
                current = pending.pop(0)
                samples = []
                while current:  # popped as consumed, so the drain never frees a slot twice
                    f, slot = current.pop(0)
                    try:
                        r = f.result()
                    except BaseException:
                        if slot is not None:
                            self._free_slots.append(slot)
                        raise
                    if mode == "process":
                        samples.append(self._read_slot(r[1]))
                        self._free_slots.append(slot)
                    else:
                        samples.append(r)
                current = None
                if next_b < n_batches:
                    pending.append(submit_batch(next_b))
                    next_b += 1
                if samples:
                    yield self._stack(samples)
        finally:
            # an epoch left early (an iteration budget) or a worker's error:
            # wait for what is in flight, so no worker still writes into a slot
            _drain(([current] if current else []) + pending, self._free_slots)


def _drain(batches, free_slots) -> None:
    for futures in batches:
        for f, slot in futures:
            if not f.cancel():
                try:
                    f.result()
                except Exception:
                    pass
            if slot is not None:
                free_slots.append(slot)


def get_data_loader(dataset, batch_size: int, **kwargs) -> Loader:
    """torch_em's ``get_data_loader``."""
    return Loader(dataset, batch_size, **kwargs)
