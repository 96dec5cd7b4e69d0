"""The collectives of the mesh's train step and render (the JAX
package's psum, pmean, pmax and tiled all_gather inside shard_map), all
built on ``dist.all_reduce`` with SUM or MAX.  Every backend takes CUDA
tensors for all_reduce; gloo, which the ranks sharing one card use, copies
them through the host.

All-reduce gives every rank the same bits (each element is summed once,
then handed round), so ranks that start alike stay alike.  A group of
None is an axis of one rank: each function is then the identity.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(tensors: List[torch.Tensor], op: str,
               group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """``tensors`` (one dtype, one device) reduced element-wise across
    ``group`` by ``op`` ("sum" or "max") in one collective over a flat
    buffer; new tensors of the same shapes."""
    if group is None:
        return list(tensors)
    if len({(t.dtype, t.device) for t in tensors}) != 1:
        raise ValueError("all_reduce takes tensors of one dtype and device")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=_OPS[op], group=group)
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _gather(x: torch.Tensor, group, rank: int, world: int, dim: int):
    shape = list(x.shape)
    shape[dim] *= world
    full = x.new_zeros(shape)
    full.narrow(dim, rank * x.shape[dim], x.shape[dim]).copy_(x)
    # exact: every element has one non-zero addend at most
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


class _GatherRows(torch.autograd.Function):
    """forward: the ranks' blocks, in rank order along ``dim``; backward
    (the gather's transpose): every rank's cotangent summed, then this
    rank's block."""

    @staticmethod
    def forward(ctx, x, group, rank, world, dim):
        ctx.args = (group, rank, world, dim)
        return _gather(x, group, rank, world, dim)

    @staticmethod
    def backward(ctx, g):
        return sum_rows(g, *ctx.args), None, None, None, None


def gather_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                rank: int, world: int, dim: int = 0) -> torch.Tensor:
    """The blocks ``x`` of the group's ``world`` ranks concatenated along
    ``dim`` in rank order, on every rank (``all_gather(..., tiled=True)``):
    each rank writes its block into a zero buffer and the buffers are
    summed.  Differentiable: the cotangents of all ranks are summed and
    each rank takes its block's."""
    if group is None:
        return x
    return _GatherRows.apply(x, group, rank, world, dim)


def sum_rows(g: torch.Tensor, group: Optional[dist.ProcessGroup],
             rank: int, world: int, dim: int = 0) -> torch.Tensor:
    """The transpose of ``gather_rows`` on a cotangent ``g`` of the whole:
    the sum over the group, this rank's block of ``dim``."""
    if group is None:
        return g
    g = g.contiguous().clone()
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    n = g.shape[dim] // world
    return g.narrow(dim, rank * n, n)
