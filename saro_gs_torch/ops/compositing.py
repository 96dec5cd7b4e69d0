"""Per-tile alpha compositing and its backward, plain PyTorch (counterpart
of ops/compositing.py).

These are the plain versions of kernel K1 (``csrc/forward.cu``) and of
kernel K3 (``csrc/backward.cu``): the CPU path, and what the kernels are
held to on the card.  The forward walks each tile's
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

``backward_tiles`` replays that walk front to back and gives the
per-instance gradients [9, L] of the colour image (the depth output has no
backward, as in the reference): the colour behind instance k comes from
the forward's outputs, S_k = (color - T_final * bg) - sum_{i<=k} w_i c_i,
so nothing is walked in reverse.  The kernel sums an instance's pixels in
another order than ``sum`` here, so the two agree to rounding, not to the
bit.
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
# rows of the per-instance gradient table: d_rgb (3), d_mean2d (2, in NDC
# units: pixel gradient * 0.5 * width, 0.5 * height), d_conic (3, the true
# b-gradient, unlike the reference's halved one), d_opacity (1)
GRAD_ROWS = 9


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


def tile_image(img: torch.Tensor, tile_ids: torch.Tensor, width: int,
               height: int, tile_x: int, tile_y: int) -> torch.Tensor:
    """Image [(C,) H, W] -> per-tile pixels [T, (C,) P] of the given
    tiles; pixels outside the image read 0."""
    grid_x = (width + tile_x - 1) // tile_x
    px, py = tile_pixel_coords(tile_ids, grid_x, tile_x, tile_y)
    inside = (px < width) & (py < height)
    idx = torch.clamp(py, max=height - 1) * width \
        + torch.clamp(px, max=width - 1)
    if img.dim() == 2:
        v = img.reshape(-1)[idx]
        return torch.where(inside, v, torch.zeros_like(v))
    v = img.reshape(img.shape[0], -1)[:, idx].permute(1, 0, 2)   # [T,C,P]
    return torch.where(inside[:, None], v, torch.zeros_like(v))


def backward_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                   tile_count: torch.Tensor, bg: torch.Tensor,
                   n_contrib: torch.Tensor, out_color: torch.Tensor,
                   final_t: torch.Tensor, d_color: torch.Tensor, width: int,
                   height: int, tile_x: int, tile_y: int,
                   count_pairs: bool = False):
    """Per-instance gradients [GRAD_ROWS, L] of the compositor (plain
    version of K3; saro_gs_tpu/ops/compositing.py:backward_tiles,
    backward.cu:399-557), given the forward's ``out_color`` [3,H,W],
    ``final_t`` and ``n_contrib`` [H,W] and the cotangent ``d_color``.

    A tile is replayed up to its largest n_contrib; slots past that, and
    invalid slots outside every range, stay zero.  As in the reference
    the 0.99 alpha clamp is not gated.  ``width``/``height`` are the full
    frame's (the NDC scaling of d_mean2d).

    With ``count_pairs`` returns (grad, n_pairs): the number of
    instance-pixel pairs that contributed, an int64 scalar tensor (the
    pairs replayed at all number ``n_contrib.sum()``)."""
    dev = attr.device
    f32 = torch.float32
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    tids = torch.arange(grid_x * grid_y, device=dev)
    nt = tids.shape[0]
    p = tile_x * tile_y
    px, py = tile_pixel_coords(tids, grid_x, tile_x, tile_y)
    pxf, pyf = px.to(f32), py.to(f32)
    bg = bg.to(f32)

    def tiles(img):
        return tile_image(img, tids, width, height, tile_x, tile_y)

    # pixels outside the image have n_contrib 0 and replay nothing
    nc = tiles(n_contrib)                                    # [T,P] int32
    dpix = tiles(d_color.to(f32))                            # [T,3,P]
    tf = tiles(final_t)
    S = tiles(out_color) - tf[:, None] * bg[None, :, None]
    bg_dot = dpix[:, 0] * bg[0] + dpix[:, 1] * bg[1] + dpix[:, 2] * bg[2]
    start = tile_start.long()
    limit = torch.minimum(tile_count.long(),
                          nc.max(dim=1).values.long()) if nt else start
    T = torch.ones((nt, p), dtype=f32, device=dev)
    grad = torch.zeros((GRAD_ROWS, attr.shape[1]), dtype=f32, device=dev)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    half_w, half_h = 0.5 * width, 0.5 * height
    max_limit = int(limit.max()) if nt else 0
    block = 64
    for b0 in range(0, max_limit, block):
        act = torch.nonzero(limit > b0).squeeze(1)
        aT, aS, anc = T[act], S[act], nc[act]
        apx, apy, astart, alimit = pxf[act], pyf[act], start[act], limit[act]
        adpix, atf, abg_dot = dpix[act], tf[act], bg_dot[act]
        for s in range(b0, min(b0 + block, max_limit)):
            slot_ok = s < alimit                                 # [T]
            # rows past a tile's bound are gathered (clamped index) and
            # masked by select, never multiplied away
            row = attr[:, torch.where(slot_ok, astart + s, 0)]   # [ROWS, T]
            x, y, ca, cb, cc, op, r, g, b, _ = (row[i][:, None]
                                                for i in range(ROWS))
            dx = x - apx
            dy = y - apy
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            gval = torch.exp(torch.clamp_max(power, 0.0))
            alpha = torch.clamp_max(op * gval, ALPHA_MAX)
            ok = (slot_ok[:, None] & (s < anc) & (power <= 0.0)
                  & (alpha >= ALPHA_MIN))
            test_t = aT * (1.0 - alpha)
            kill = ok & (test_t < T_EPS)       # the forward's latch
            anc = torch.where(kill, torch.zeros_like(anc), anc)
            contrib = ok & ~kill
            w = alpha * aT
            rgb = torch.stack([r, g, b], dim=1)                  # [T,3,1]
            aS = torch.where(contrib[:, None], aS - w[:, None] * rgb, aS)
            inv = 1.0 / (1.0 - alpha)
            e = (rgb * aT[:, None] - aS * inv[:, None]) * adpix
            d_alpha = (e[:, 0] + e[:, 1] + e[:, 2]) - atf * inv * abg_dot
            d_g = op * d_alpha         # the 0.99 clamp is not gated
            gdx = gval * dx
            gdy = gval * dy
            vals = torch.stack([
                w * adpix[:, 0], w * adpix[:, 1], w * adpix[:, 2],
                d_g * (-gdx * ca - gdy * cb) * half_w,
                d_g * (-gdy * cc - gdx * cb) * half_h,
                d_g * (-0.5 * gdx * dx),
                d_g * (-gdx * dy),
                d_g * (-0.5 * gdy * dy),
                gval * d_alpha], dim=1)                          # [T,9,P]
            vals = torch.where(contrib[:, None], vals,
                               torch.zeros_like(vals))
            grad[:, (astart + s)[slot_ok]] = vals.sum(dim=2)[slot_ok].T
            aT = torch.where(contrib, test_t, aT)
            if count_pairs:
                n_pairs += contrib.sum()
        T[act], S[act], nc[act] = aT, aS, anc
    return (grad, n_pairs) if count_pairs else grad
