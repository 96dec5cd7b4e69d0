"""Tile binning into a staged instance table (counterpart of
ops/binning.py:bin_gaussians_staged), and the per-Gaussian reduce of the
backward's per-instance rows.

  1. expand each kept Gaussian into one instance per tile of its rect
     (kernel K2, ``tile_kernels.expand_instances``), with the corner cull;
  2. one stable sort of the int64 keys tile << 32 | depth bits, i.e. the
     stable (tile, depth) sort with ties in emission order;
  3. per-tile [start, count) by searchsorted over the sorted tiles.

The table is attribute-major [10, L] (x, y, conic a/b/c, opacity, r, g,
b, depth), L = num_instances: the TPU's six padding rows and its
chunk-aligned length served Mosaic's tiling and are not carried over.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import tile_kernels
from .projection import PreprocessOut


class StagedBins(NamedTuple):
    """Tile-sorted instance table (tile-major, depth-ascending per tile)."""
    attr: torch.Tensor        # [10, L] float32
    ids: torch.Tensor         # [L] int32 Gaussian ids
    tile_start: torch.Tensor  # [NT] int32
    tile_count: torch.Tensor  # [NT] int32
    num_instances: int        # instances emitted (valid or corner-culled)
    num_dropped: int          # instances beyond max_instances
    # the sort's permutation (sorted slot -> emission slot) and each
    # Gaussian's tiles_touched: what reduce_instances needs
    perm: torch.Tensor        # [L] int64
    tiles: torch.Tensor       # [N] int32


def _finite(x: torch.Tensor) -> torch.Tensor:
    # the JAX expander sanitizes non-finite payloads to 0 before expansion
    # (saro_gs_tpu/ops/binning.py:263-273)
    x = x.to(torch.float32)
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def expand_inputs(pre: PreprocessOut, opacity: torch.Tensor):
    """The expander's inputs (offsets, tiles, rect, gattr, total): the
    exclusive cumsum of tiles_touched, tiles_touched, the rects [3, N],
    the finite payload rows [10, N] and the instance total, which is read
    back to the host once, to size the table."""
    tiles = pre.tiles_touched.to(torch.int32)
    offsets = torch.cumsum(tiles, 0, dtype=torch.int32) - tiles
    total = int(offsets[-1] + tiles[-1]) if tiles.shape[0] else 0
    rect = torch.stack([pre.rmin_x, pre.rmin_y, pre.rmax_x]).to(torch.int32)
    gattr = torch.stack(
        [_finite(c) for c in (pre.mean_x, pre.mean_y, pre.conic_a,
                              pre.conic_b, pre.conic_c, opacity.reshape(-1),
                              pre.rgb[:, 0], pre.rgb[:, 1], pre.rgb[:, 2],
                              pre.depth)])
    return offsets, tiles, rect.contiguous(), gattr.contiguous(), total


def expand(pre: PreprocessOut, opacity: torch.Tensor, grid_x: int,
           grid_y: int, max_instances: int, tile_x: int, tile_y: int,
           corner_cull: bool = True):
    """Step 1: (keys, gid, attr, num_instances, num_dropped)."""
    offsets, tiles, rect, gattr, total = expand_inputs(pre, opacity)
    n_inst = min(total, max_instances)
    keys, gid, attr = tile_kernels.expand_instances(
        offsets, tiles, rect, gattr, n_inst, grid_x, grid_y, tile_x, tile_y,
        corner_cull)
    return keys, gid, attr, n_inst, max(total - max_instances, 0)


def sort_instances(keys: torch.Tensor, gid: torch.Tensor,
                   attr: torch.Tensor, num_tiles: int):
    """Steps 2-3: (attr, ids, tile_start, tile_count, perm) in tile-major,
    depth-ascending order; invalid instances (sentinel tile num_tiles)
    end up past every tile's range.  ``perm`` maps a sorted slot to its
    emission slot."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    tile_sorted = keys_sorted >> 32
    tids = torch.arange(num_tiles, dtype=torch.int64, device=keys.device)
    start = torch.searchsorted(tile_sorted, tids, side="left")
    end = torch.searchsorted(tile_sorted, tids + 1, side="left")
    return (attr.index_select(1, perm), gid[perm], start.to(torch.int32),
            (end - start).to(torch.int32), perm)


def bin_gaussians_staged(pre: PreprocessOut, opacity: torch.Tensor,
                         grid_x: int, grid_y: int, max_instances: int,
                         tile_x: int, tile_y: int,
                         corner_cull: bool = True) -> StagedBins:
    """Expand, sort and range the instances of one view."""
    keys, gid, attr, n_inst, n_drop = expand(
        pre, opacity, grid_x, grid_y, max_instances, tile_x, tile_y,
        corner_cull)
    attr, ids, start, count, perm = sort_instances(keys, gid, attr,
                                                   grid_x * grid_y)
    return StagedBins(attr=attr, ids=ids, tile_start=start,
                      tile_count=count, num_instances=n_inst,
                      num_dropped=n_drop, perm=perm,
                      tiles=pre.tiles_touched.to(torch.int32))


def reduce_instances(rows: torch.Tensor, perm: torch.Tensor,
                     tiles: torch.Tensor) -> torch.Tensor:
    """Per-instance rows [R, L] in sorted order -> per-Gaussian sums
    [N, R] (the JAX package's segment_sum over ``ids``,
    saro_gs_tpu/ops/rasterize.py:212-223).

    The expander emits every Gaussian's instances as one contiguous run of
    slots, in Gaussian order, so the rows are first put back in emission
    order (``perm`` is a permutation: a plain indexed copy) and each run
    is then summed sequentially by ``torch.segment_reduce``.  No atomics,
    unlike ``index_add_`` on CUDA: two calls agree to the bit."""
    n_inst = rows.shape[1]
    emit = torch.empty((n_inst, rows.shape[0]), dtype=rows.dtype,
                       device=rows.device)
    emit[perm] = rows.T
    tiles = tiles.long()
    offsets = torch.cumsum(tiles, 0) - tiles
    # the runs that fit in the table; the last one may be cut by capacity
    cnt = torch.clamp(torch.minimum(tiles, n_inst - offsets), min=0)
    return torch.segment_reduce(emit, "sum", lengths=cnt, unsafe=True)
