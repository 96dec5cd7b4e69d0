"""Plain tile binning: the benchmark's frozen copy of the port's plain
expander (saro_gs_torch/ops/tile_kernels.py:expand_instances_plain and
its helpers) and of the staged sort (saro_gs_torch/ops/binning.py), part
of the reference that decides `correct`.

Every kept Gaussian is expanded into one instance per tile of its rect
(with the corner cull: an instance whose alpha is below 1/255 all over
its tile is dropped), the instances are sorted stably by
tile << 32 | depth bits, and each tile gets its [start, count) range.
No capacity: the reference never drops an instance.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .compositing import ALPHA_MIN, ROW_DEPTH


class Bins(NamedTuple):
    attr: torch.Tensor        # [10, L] tile-major, depth-ascending
    gid: torch.Tensor         # [L] int64 Gaussian ids (-1 culled slots)
    tile_start: torch.Tensor  # [NT] int32
    tile_count: torch.Tensor  # [NT] int32
    total: int                # instances emitted before the corner cull


def _finite(x):
    x = x.to(torch.float32)
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _corner_keep(tx, ty, a, tile_x: int, tile_y: int):
    mx, my, ca, cb, cc, op = (a[i] for i in range(6))
    px0 = (tx * tile_x).to(torch.float32)
    py0 = (ty * tile_y).to(torch.float32)
    ddx = torch.clamp_min(torch.maximum(px0 - mx, mx - (px0 + tile_x - 1)),
                          0.0)
    ddy = torch.clamp_min(torch.maximum(py0 - my, my - (py0 + tile_y - 1)),
                          0.0)
    d = ca - cc
    lam_min = 0.5 * (ca + cc) - torch.sqrt(0.25 * (d * d) + cb * cb + 1e-20)
    power_bound = -0.5 * torch.clamp_min(lam_min, 0.0) * (ddx * ddx
                                                          + ddy * ddy)
    return op * torch.exp(power_bound) >= ALPHA_MIN


def payload(pre, opacity: torch.Tensor) -> torch.Tensor:
    """The rows an instance carries [10, N]: x, y, conic a/b/c, opacity,
    r, g, b, depth (non-finite entries zeroed, as the expander does)."""
    return torch.stack(
        [_finite(c) for c in (pre.mean_x, pre.mean_y, pre.conic_a,
                              pre.conic_b, pre.conic_c, opacity.reshape(-1),
                              pre.rgb[:, 0], pre.rgb[:, 1], pre.rgb[:, 2],
                              pre.depth)])


def bin_gaussians(pre, gattr: torch.Tensor, grid_x: int, grid_y: int,
                  tile_x: int, tile_y: int) -> Bins:
    """Expand, cull, sort and range one view's instances; ``gattr`` is
    ``payload(pre, opacity)`` (or a tensor equal to it that carries a
    gradient: the table is gathered from it)."""
    dev = gattr.device
    tiles = pre.tiles_touched.to(torch.int64)
    total = int(tiles.sum())
    offsets = torch.cumsum(tiles, 0) - tiles
    g = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev),
                                tiles, output_size=total)
    local = torch.arange(total, device=dev) - offsets[g]
    rmin_x = pre.rmin_x.long()[g]
    rmin_y = pre.rmin_y.long()[g]
    rw = torch.clamp_min(pre.rmax_x.long()[g] - rmin_x, 1)
    tx = rmin_x + local % rw
    ty = rmin_y + local // rw
    a = gattr.index_select(1, g)
    valid = _corner_keep(tx, ty, a.detach(), tile_x, tile_y)
    tile = ty * grid_x + tx
    depth_bits = a[ROW_DEPTH].detach().contiguous().view(torch.int32) \
        .long() & 0xFFFFFFFF
    sentinel = torch.full_like(tile, (grid_x * grid_y) << 32)
    keys = torch.where(valid, (tile << 32) | depth_bits, sentinel)
    _, perm = torch.sort(keys, stable=True)
    keys = keys[perm]
    nt = grid_x * grid_y
    tile_sorted = keys >> 32
    tids = torch.arange(nt, dtype=torch.int64, device=dev)
    start = torch.searchsorted(tile_sorted, tids, side="left")
    end = torch.searchsorted(tile_sorted, tids + 1, side="left")
    gid = torch.where(valid, g, -1)[perm]
    attr = torch.where(valid[None], a, torch.zeros_like(a))[:, perm]
    return Bins(attr=attr, gid=gid, tile_start=start.to(torch.int32),
                tile_count=(end - start).to(torch.int32), total=total)
