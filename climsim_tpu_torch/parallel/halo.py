"""Halo exchange for latitude-band domain decomposition.

Counterpart of ``climsim_tpu/parallel/halo.py``, where ``ppermute`` inside
``shard_map`` moves the ghost rows and XLA overlaps the transfer with
independent compute. Here each rank sends its edge rows to its neighbours
along a mesh axis with ``torch.distributed`` point-to-point operations
(``batch_isend_irecv``); ``async_op=True`` returns a handle, so the caller
overlaps the transfer with its own work and waits when it needs the rows.

Convention: tensors are [rows, ...] on each rank, the rows a contiguous
band of the global leading (latitude) axis; the halo is ``width`` rows from
each neighbour. The global domain is not periodic in rows (poles): the
edge ranks' ghost rows repeat their own boundary row (clamped boundary).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_rank

# message tags: rows travelling to the next rank (received as its rows from
# the previous one), and to the previous rank
_TAG_NEXT, _TAG_PREV = 0, 1


class HaloHandle:
    """A started exchange: ``wait()`` finishes the transfers and returns
    the extended tensor [width + rows + width, ...]."""

    def __init__(self, works, parts):
        self._works, self._parts = works, parts

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return torch.cat(self._parts, dim=0)


def exchange_halo(x: torch.Tensor, mesh: DeviceMesh, axis: str = "col",
                  width: int = 1, periodic: bool = False,
                  async_op: bool = False):
    """``x`` extended by ``width`` ghost rows on both ends of dim 0, from
    the previous and the next rank along ``axis``: the previous rank's
    last rows above, the next rank's first rows below. Without
    ``periodic`` the global edges repeat the edge row. With
    ``async_op=True`` returns a :class:`HaloHandle` instead."""
    idx, n = axis_rank(mesh, axis)
    if x.shape[0] < width:
        raise ValueError(f"{x.shape[0]} rows on this rank, fewer than the "
                         f"halo width {width}")
    top = x[:width].contiguous()
    bot = x[-width:].contiguous()
    has_prev = periodic or idx > 0
    has_next = periodic or idx < n - 1
    from_prev = x[:1].expand(top.shape) if not has_prev else None
    from_next = x[-1:].expand(bot.shape) if not has_next else None
    works = []
    if periodic and n == 1:
        from_prev, from_next = bot, top
    else:
        group = mesh.get_group(axis)
        peer = lambda i: dist.get_global_rank(group, i % n)
        ops = []
        # sends first, then receives, in one order on every rank: with two
        # ranks on a ring both messages between the pair are matched in
        # the order they were posted
        if has_next:
            ops.append(dist.P2POp(dist.isend, bot, peer(idx + 1), group,
                                  _TAG_NEXT))
        if has_prev:
            ops.append(dist.P2POp(dist.isend, top, peer(idx - 1), group,
                                  _TAG_PREV))
        if has_prev:
            from_prev = torch.empty_like(top)
            ops.append(dist.P2POp(dist.irecv, from_prev, peer(idx - 1),
                                  group, _TAG_NEXT))
        if has_next:
            from_next = torch.empty_like(bot)
            ops.append(dist.P2POp(dist.irecv, from_next, peer(idx + 1),
                                  group, _TAG_PREV))
        if ops:
            works = dist.batch_isend_irecv(ops)
    handle = HaloHandle(works, (from_prev, x, from_next))
    return handle if async_op else handle.wait()


def sharded_stencil(fn, mesh: DeviceMesh, axis: str = "col", width: int = 1,
                    periodic: bool = False):
    """Lift ``fn(x_with_halo) -> y`` ([rows + 2 width, ...] -> [rows,
    ...]) to an operator on this rank's rows."""

    def local(x):
        return fn(exchange_halo(x, mesh, axis, width, periodic))

    return local


def global_sum(x: torch.Tensor, mesh: DeviceMesh,
               axis: str = "col") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out
