"""Per-tile alpha compositing, plain PyTorch (counterpart of the forward
half of ops/compositing.py).

This is the plain version of kernel K1 (``csrc/forward.cu``): the CPU
path, and what the kernel is held to on the card.  It walks each tile's
depth-sorted instance range of the staged table front to back, one
instance per step, with every pixel of every tile in flight at once, and
keeps the reference's per-pixel semantics (forward.cu:261-393):

  * alpha = min(0.99, opacity * exp(min(power, 0))); an instance counts
    only where alpha >= 1/255 and power <= 0 (the broken-conic guard,
    forward.cu:310: an indefinite conic's power > 0 is skipped);
  * termination latch: the instance that would take T below 1e-4 does not
    contribute, and the pixel stops there;
  * median depth: the depth of the contributing instance at which T
    crosses 0.5, else 15.0;
  * colour = C + T * bg.

Its arithmetic is written in the kernel's order, so on the card the two
agree to the last bit where both round the same.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

ALPHA_MAX = 0.99          # forward.cu:349
ALPHA_MIN = 1.0 / 255.0   # forward.cu:350
T_EPS = 1e-4              # forward.cu:353
DEPTH_DEFAULT = 15.0      # forward.cu:308 (median-depth default)

# rows of the staged instance table (binning.StagedBins.attr)
ROW_X, ROW_Y, ROW_CA, ROW_CB, ROW_CC, ROW_OP, ROW_R, ROW_G, ROW_B, \
    ROW_DEPTH = range(10)
ROWS = 10


class ForwardTilesOut(NamedTuple):
    color: torch.Tensor      # [3, H, W] (bg composited)
    depth: torch.Tensor      # [H, W] median depth
    final_t: torch.Tensor    # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32 (zeros when need_aux=False)
    # plain version only: instances each pixel evaluated before its walk
    # stopped (the work the data needed); None from the kernel
    n_walked: Optional[torch.Tensor] = None


def tile_pixel_coords(tile_ids: torch.Tensor, grid_x: int, tile_x: int,
                      tile_y: int):
    """Integer pixel coordinates [T, P] of the given tiles, row-major
    within a tile (no +0.5: the reference's pixel centres)."""
    lin = torch.arange(tile_x * tile_y, device=tile_ids.device)
    ox = (tile_ids % grid_x) * tile_x
    oy = (tile_ids // grid_x) * tile_y
    px = ox[:, None] + (lin % tile_x)[None, :]
    py = oy[:, None] + (lin // tile_x)[None, :]
    return px, py


def composite_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                    tile_count: torch.Tensor, tile_ids: torch.Tensor,
                    bg: torch.Tensor, width: int, height: int, tile_x: int,
                    tile_y: int):
    """Composite the tiles ``tile_ids``; per-tile outputs
    (color [T,3,P], depth [T,P], final_t [T,P], n_contrib [T,P] int32,
    n_walked [T,P] int32), P = tile_x * tile_y."""
    dev = attr.device
    f32 = torch.float32
    grid_x = (width + tile_x - 1) // tile_x
    nt = tile_ids.shape[0]
    p = tile_x * tile_y
    px, py = tile_pixel_coords(tile_ids, grid_x, tile_x, tile_y)
    pxf, pyf = px.to(f32), py.to(f32)
    inside = (px < width) & (py < height)
    start = tile_start[tile_ids].long()
    count = tile_count[tile_ids].long()

    T = torch.ones((nt, p), dtype=f32, device=dev)
    C = torch.zeros((nt, 3, p), dtype=f32, device=dev)
    D = torch.full((nt, p), DEPTH_DEFAULT, dtype=f32, device=dev)
    nc = torch.zeros((nt, p), dtype=torch.int32, device=dev)
    walked = torch.zeros((nt, p), dtype=torch.int32, device=dev)
    done = ~inside
    max_count = int(count.max()) if nt else 0
    block = 64
    for b0 in range(0, max_count, block):
        # each block of steps works on the tiles that still have
        # instances left and a pixel still walking, gathered once
        act = torch.nonzero((count > b0) & ~done.all(1)).squeeze(1)
        if act.numel() == 0:
            break
        aT, aC, aD, anc, awalked, adone = (v[act] for v in (T, C, D, nc,
                                                             walked, done))
        apx, apy, astart, acount = pxf[act], pyf[act], start[act], count[act]
        for s in range(b0, min(b0 + block, max_count)):
            slot_ok = s < acount                                 # [T]
            # rows past a tile's range belong to the next tile: they are
            # gathered (clamped index) but masked by select below, never
            # multiplied away (0 * NaN is NaN)
            row = attr[:, torch.where(slot_ok, astart + s, 0)]   # [ROWS, T]
            x, y, ca, cb, cc, op, r, g, b, dep = (row[i][:, None]
                                                  for i in range(ROWS))
            dx = x - apx
            dy = y - apy
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            gval = torch.exp(torch.clamp_max(power, 0.0))
            alpha = torch.clamp_max(op * gval, ALPHA_MAX)
            live = slot_ok[:, None] & ~adone
            awalked += live.to(torch.int32)
            # broken-conic guard: power > 0 is skipped (forward.cu:310)
            ok = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
            test_t = aT * (1.0 - alpha)
            # termination latch: the killing instance does not contribute
            kill = ok & (test_t < T_EPS)
            contrib = ok & ~kill
            w = alpha * aT
            rgb = torch.stack([r, g, b], dim=1)                  # [T,3,1]
            aC = torch.where(contrib[:, None], aC + w[:, None] * rgb, aC)
            crossing = contrib & (aT > 0.5) & (test_t < 0.5)
            aD = torch.where(crossing, dep, aD)
            anc = torch.where(contrib, torch.full_like(anc, s + 1), anc)
            aT = torch.where(contrib, test_t, aT)
            adone = adone | kill
        T[act], C[act], D[act], nc[act], walked[act], done[act] = \
            aT, aC, aD, anc, awalked, adone
    color = C + T[:, None] * bg.to(f32)[None, :, None]
    return color, D, T, nc, walked


def assemble(x: torch.Tensor, grid_y: int, grid_x: int, tile_y: int,
             tile_x: int, height: int, width: int) -> torch.Tensor:
    """Per-tile [NT, (C,) P] -> image [(C,) H, W]."""
    if x.dim() == 2:
        x = x.reshape(grid_y, grid_x, tile_y, tile_x).permute(0, 2, 1, 3)
        return x.reshape(grid_y * tile_y, grid_x * tile_x)[:height, :width]
    c = x.shape[1]
    x = x.reshape(grid_y, grid_x, c, tile_y, tile_x).permute(2, 0, 3, 1, 4)
    return x.reshape(c, grid_y * tile_y,
                     grid_x * tile_x)[:, :height, :width]


def forward_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, bg: torch.Tensor, width: int,
                  height: int, tile_x: int, tile_y: int,
                  need_aux: bool = True) -> ForwardTilesOut:
    """Composite every tile of the staged table (binning.StagedBins)."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    tids = torch.arange(grid_x * grid_y, device=attr.device)
    color, D, T, nc, walked = composite_tiles(
        attr, tile_start, tile_count, tids, bg, width, height, tile_x,
        tile_y)

    def img(x):
        return assemble(x, grid_y, grid_x, tile_y, tile_x, height, width)
    n_contrib = img(nc) if need_aux else torch.zeros(
        (height, width), dtype=torch.int32, device=attr.device)
    return ForwardTilesOut(color=img(color), depth=img(D), final_t=img(T),
                           n_contrib=n_contrib, n_walked=img(walked))
