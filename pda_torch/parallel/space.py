"""The two collectives of the (``data``, ``space``) mesh that autograd
differentiates (port of ``pda/models/blocks.py``'s ``_halo_exchange_rows``
and ``global_mean_rows_sharded``), each a ``torch.autograd.Function`` over
one rank's ``space`` axis (:meth:`pda_torch.parallel.Mesh.axis`):

  * :func:`halo_rows`: a row shard extended by ``halo`` rows from each
    space neighbour (``pda``'s ``ppermute`` pair). Its backward is the
    inverse permutation: the cotangents of the received rows go back to
    their owners, who add them into their boundary rows. A shard at the
    image's edge is extended on its inner side only (``pda`` zero-extends it
    and recomputes the edge rows; the port's blocks run their own SAME
    padding there, which is exact);
  * :func:`space_mean`: the mean over the space axis, forward
    ``all_reduce(x) / M``, backward ``all_reduce(ct) / M`` (``pda``'s
    ``pmean`` and its transpose): the encoders' global spatial mean, whose
    value feeds row-sharded consumers and replicated ones alike.

Every other reduction of the mesh stays value-global and gradient-local
(:mod:`pda_torch.core.losses`): no other collective is differentiated.

The exchange of one call is one ``batch_isend_irecv`` on the space group,
both directions batched (NCCL deadlocks on a send left waiting for its
matching receive), the rows of every tensor packed into one buffer per
neighbour; gloo on a CUDA tensor goes through host memory, as the mesh's
other collectives do. :data:`stats` counts the exchanges (forward and
backward); inside :func:`timed_exchanges` each one is also timed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: exchanges made by :func:`halo_rows` (forward and backward), and the
#: elements they sent; :func:`reset_stats` zeroes them
stats = {"exchanges": 0, "elements": 0}
_timing: Optional[list] = None


def reset_stats() -> None:
    stats.update(exchanges=0, elements=0)


@contextlib.contextmanager
def timed_exchanges():
    """Time every exchange made inside: yields a list that holds, after the
    block, each exchange's milliseconds (CUDA events around it on the card,
    the host clock on the CPU). The card is synchronized at the end."""
    global _timing
    prev, _timing = _timing, []
    marks = _timing
    try:
        yield marks
    finally:
        _timing = prev
        if any(isinstance(m, tuple) for m in marks):
            torch.cuda.synchronize()
        marks[:] = [m[0].elapsed_time(m[1]) if isinstance(m, tuple) else m for m in marks]


def _exchange(space, outgoing: dict, incoming: dict) -> None:
    """One ``batch_isend_irecv`` on the space group: ``outgoing`` {axis
    position: tensor} sent, ``incoming`` {axis position: buffer} received,
    the peers by their global ranks."""
    tensors = [*outgoing.values(), *incoming.values()]
    if not tensors:
        return
    staged = space._staged(tensors[0])
    send = {p: (t.to("cpu") if staged else t.contiguous()) for p, t in outgoing.items()}
    recv = {p: (torch.empty_like(t, device="cpu") if staged else t) for p, t in incoming.items()}
    ops = [dist.P2POp(dist.isend, t, space.ranks[p], group=space.group) for p, t in send.items()]
    ops += [dist.P2POp(dist.irecv, t, space.ranks[p], group=space.group)
            for p, t in recv.items()]
    stats["exchanges"] += 1
    stats["elements"] += sum(t.numel() for t in send.values())
    start = None
    if _timing is not None:
        if tensors[0].is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        for p, t in recv.items():
            incoming[p].copy_(t)
    if _timing is not None:
        if tensors[0].is_cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _timing.append((start, end))
        else:
            _timing.append(1e3 * (time.perf_counter() - start))


def _pack(parts) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parts])


def _unpack(flat: torch.Tensor, like) -> list:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def _swap(space, halo: int, rows_up, rows_down, shapes) -> Tuple[list, list]:
    """Send ``rows_up`` (a list, one block of rows a tensor) to the previous
    space rank and ``rows_down`` to the next, where there is one; receive
    theirs, of the ``shapes`` (each ``(B, halo, W, C)``). Returns (from the
    previous rank, from the next), empty where there is none."""
    idx, n = space.rank, space.world
    outgoing, incoming = {}, {}
    ref = (rows_up or rows_down)[0]
    like = [torch.empty(s, dtype=ref.dtype, device=ref.device) for s in shapes]
    if idx > 0:
        outgoing[idx - 1] = _pack(rows_up)
        incoming[idx - 1] = torch.empty_like(outgoing[idx - 1])
    if idx < n - 1:
        outgoing[idx + 1] = _pack(rows_down)
        incoming[idx + 1] = torch.empty_like(outgoing[idx + 1])
    _exchange(space, outgoing, incoming)
    prev = _unpack(incoming[idx - 1], like) if idx > 0 else []
    nxt = _unpack(incoming[idx + 1], like) if idx < n - 1 else []
    return prev, nxt


class _HaloRows(torch.autograd.Function):
    """(B, h, W, C) row shards -> each extended by ``halo`` rows from the
    previous space rank (above) and the next (below), where there is one."""

    @staticmethod
    def forward(ctx, halo: int, space, *xs):
        ctx.halo, ctx.space = halo, space
        shapes = [(x.shape[0], halo, *x.shape[2:]) for x in xs]
        prev, nxt = _swap(space, halo, [x[:, :halo] for x in xs], [x[:, -halo:] for x in xs],
                          shapes)
        ctx.top, ctx.bottom = bool(prev), bool(nxt)
        return tuple(torch.cat([*prev[i:i + 1], x, *nxt[i:i + 1]], dim=1)
                     for i, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *grads):
        halo, top, bottom = ctx.halo, ctx.top, ctx.bottom
        lo = halo if top else 0
        gx = [g[:, lo:g.shape[1] - (halo if bottom else 0)].clone() for g in grads]
        # the cotangents of the rows received from above go back up, those
        # from below back down; each owner adds them into its boundary rows
        up = [g[:, :halo] for g in grads] if top else []
        down = [g[:, -halo:] for g in grads] if bottom else []
        shapes = [(g.shape[0], halo, *g.shape[2:]) for g in gx]
        prev, nxt = _swap(ctx.space, halo, up, down, shapes)
        for i, g in enumerate(gx):
            if prev:
                g[:, :halo] += prev[i]
            if nxt:
                g[:, -halo:] += nxt[i]
        return (None, None, *gx)


def halo_rows(xs: Sequence[torch.Tensor], halo: int, space) -> Tuple[list, int, int]:
    """Each (B, h, W, C) row shard of ``xs`` (one dtype, one batch and
    width) extended by ``halo`` rows from each space neighbour, in one
    exchange: ``(extended, top, bottom)``, ``top``/``bottom`` the rows added
    above and below (``halo``, or 0 at the image's edge). Differentiable;
    a space axis of 1 returns ``xs`` as they are."""
    if space is None or space.world == 1:
        return list(xs), 0, 0
    idx, n = space.rank, space.world
    if any(x.shape[1] < halo for x in xs):
        raise ValueError(f"row shards of {min(x.shape[1] for x in xs)} rows cannot send a halo "
                         f"of {halo}")
    out = _HaloRows.apply(halo, space, *[x.contiguous() for x in xs])
    return list(out), (halo if idx > 0 else 0), (halo if idx < n - 1 else 0)


class _SpaceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space):
        ctx.space = space
        return space.all_reduce(x) / space.world

    @staticmethod
    def backward(ctx, g):
        return ctx.space.all_reduce(g) / ctx.space.world, None


def space_mean(x: torch.Tensor, space) -> torch.Tensor:
    """The mean of ``x`` over the space axis, differentiated: forward
    ``all_reduce(x) / M``, backward ``all_reduce(ct) / M`` (``pda``'s
    ``pmean``), in ``x``'s dtype."""
    return _SpaceMean.apply(x, space)
