"""The benchmark's frozen copy of saro_gs_torch/ops/compositing.py, plain
PyTorch, part of the reference that decides `correct`; it imports
nothing of the program.  The original's docstring follows.

Per-tile alpha compositing and its backward, plain PyTorch (counterpart
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

``warp_may_reach`` restates the cull by which both kernels skip the
instances that cannot reach a warp's pixels (csrc/alpha_chain.cuh); the
plain walks need no cull, so it serves the tests and the cull's count.

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


def warp_may_reach(rows, wx0, wx1, wy0, wy1):
    """Plain restatement of csrc/alpha_chain.cuh's warp cull (reach_terms,
    then reaches_box), in its order of operations: False only where the
    instance with staged rows ``rows`` (x, y, conic a/b/c, opacity, ...;
    each a tensor) counts at no pixel of the box [wx0, wx1] x [wy0, wy1]
    (float32 tensors that broadcast against the rows).  ``torch.fmax`` is
    the kernel's fmaxf: it drops a NaN operand."""
    mx, my, ca, cb, cc, op = rows[:6]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=mx.device)
    # reach_terms: what does not depend on the box
    mag = ca.abs() + cc.abs() + 2.0 * cb.abs()
    dd = ca - cc
    lam = torch.fmax(0.5 * (ca + cc) - torch.sqrt(0.25 * (dd * dd) + cb * cb)
                     - 1e-6 * mag, zero)
    thr = torch.log(op / torch.tensor(ALPHA_MIN, dtype=f32))
    eps = 2e-6 * mag / lam
    t2 = 2.0 * (thr + 1e-3) / (1.0 - eps) * 1.00001
    det = ca * cc - cb * cb - 4e-7 * ((ca * cc).abs() + cb * cb)
    boxed = (lam > 0.0) & (eps < 0.5) & (thr > 0.0) & (det > 0.0)
    inf = torch.full((), float("inf"), dtype=f32, device=mx.device)
    hx = torch.where(boxed, torch.sqrt(t2 * cc / det) * 1.00001 + 1e-3, inf)
    hy = torch.where(boxed, torch.sqrt(t2 * ca / det) * 1.00001 + 1e-3, inf)
    # reaches_box
    diag2 = (wx1 - wx0) * (wx1 - wx0) + (wy1 - wy0) * (wy1 - wy0)
    ddx = torch.fmax(torch.fmax(wx0 - mx, mx - wx1), zero)
    ddy = torch.fmax(torch.fmax(wy0 - my, my - wy1), zero)
    dist2 = ddx * ddx + ddy * ddy
    a = 0.5 * lam * dist2
    m = 1e-6 * mag * (2.0 * dist2 + 2.0 * diag2)
    far = a - m - 1e-3 - 1e-5 * (a + m) > thr
    return ~(far | (ddx > hx) | (ddy > hy))


def patch_boxes(tile_ids: torch.Tensor, width: int, height: int,
                tile_x: int, tile_y: int, y0_px: int = 0):
    """The 8x4-pixel warp patches of the given tiles, as the kernels lay
    them out (tile_x a multiple of 8, tile_y of 4): the box of each
    patch's pixels inside the image, (x0, x1, y0, y1) float32 [T, Q], and
    whether the patch has such a pixel.  ``y0_px``: the strip's first
    pixel row (strip mode; tile ids are strip-local, the boxes and the
    image's ``height`` full-frame)."""
    if tile_x % 8 or tile_y % 4:
        raise ValueError(f"tile {tile_x}x{tile_y}: 8x4 patches need a "
                         "width that is a multiple of 8 and a height that "
                         "is a multiple of 4")
    grid_x = (width + tile_x - 1) // tile_x
    q = torch.arange((tile_x // 8) * (tile_y // 4), device=tile_ids.device)
    x0 = ((tile_ids % grid_x) * tile_x)[:, None] + (q % (tile_x // 8)) * 8
    y0 = ((tile_ids // grid_x) * tile_y + y0_px)[:, None] \
        + (q // (tile_x // 8)) * 4
    x1 = torch.clamp(x0 + 7, max=width - 1)
    y1 = torch.clamp(y0 + 3, max=height - 1)
    ok = (x0 < width) & (y0 < height)
    f32 = torch.float32
    return (x0.to(f32), x1.to(f32), y0.to(f32), y1.to(f32)), ok


def cull_counts(attr: torch.Tensor, tile_start: torch.Tensor,
                tile_count: torch.Tensor, width: int, height: int,
                tile_x: int, tile_y: int, slots_per_pass: int = 1 << 16,
                y0_px: int = 0):
    """(pairs, kept): the (8x4 patch, instance) pairs of every tile's range
    whose patch has a pixel in the image, and how many of them the warp
    cull keeps (``warp_may_reach`` on each patch's whole box).  ``y0_px``
    as in ``patch_boxes``."""
    dev = attr.device
    nt = tile_count.shape[0]
    tile_of = torch.repeat_interleave(torch.arange(nt, device=dev),
                                      tile_count.long())
    slot = torch.arange(tile_of.shape[0], device=dev) \
        - (torch.cumsum(tile_count.long(), 0) - tile_count.long())[tile_of] \
        + tile_start.long()[tile_of]
    pairs = kept = 0
    for i in range(0, tile_of.shape[0], slots_per_pass):
        tids = tile_of[i:i + slots_per_pass]
        (x0, x1, y0, y1), ok = patch_boxes(tids, width, height, tile_x,
                                           tile_y, y0_px)
        rows = attr[:6, slot[i:i + slots_per_pass]][:, :, None]
        reach = warp_may_reach(rows, x0, x1, y0, y1)
        pairs += int(ok.sum())
        kept += int((reach & ok).sum())
    return pairs, kept


def tile_pixel_coords(tile_ids: torch.Tensor, grid_x: int, tile_x: int,
                      tile_y: int, y0_px: int = 0):
    """Integer pixel coordinates [T, P] of the given tiles, row-major
    within a tile (no +0.5: the reference's pixel centres).  ``y0_px`` is
    added to every row: a strip's tile ids are strip-local while the splat
    means are full-frame pixel coordinates."""
    lin = torch.arange(tile_x * tile_y, device=tile_ids.device)
    ox = (tile_ids % grid_x) * tile_x
    oy = (tile_ids // grid_x) * tile_y + y0_px
    px = ox[:, None] + (lin % tile_x)[None, :]
    py = oy[:, None] + (lin // tile_x)[None, :]
    return px, py


def composite_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                    tile_count: torch.Tensor, tile_ids: torch.Tensor,
                    bg: torch.Tensor, width: int, height: int, tile_x: int,
                    tile_y: int, y0_px: int = 0):
    """Composite the tiles ``tile_ids``; per-tile outputs
    (color [T,3,P], depth [T,P], final_t [T,P], n_contrib [T,P] int32,
    n_walked [T,P] int32), P = tile_x * tile_y.  ``y0_px`` as in
    ``tile_pixel_coords``; ``height`` stays the full frame's, so that the
    rows of a partial bottom strip past it stay background."""
    dev = attr.device
    f32 = torch.float32
    grid_x = (width + tile_x - 1) // tile_x
    nt = tile_ids.shape[0]
    p = tile_x * tile_y
    px, py = tile_pixel_coords(tile_ids, grid_x, tile_x, tile_y, y0_px)
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
        steps = torch.arange(b0, min(b0 + block, max_count), device=dev)
        # what does not depend on the walk's state, for the block's steps
        # at once ([A, B, P]; the same element-wise arithmetic as one step
        # at a time).  Rows past a tile's range belong to the next tile:
        # they are gathered (clamped index) but masked by select below,
        # never multiplied away (0 * NaN is NaN)
        slot_ok = steps[None, :] < count[act][:, None]           # [A, B]
        idx = torch.where(slot_ok, start[act][:, None] + steps[None, :], 0)
        x, y, ca, cb, cc, op, r, g, b, dep = attr[:, idx, None].unbind(0)
        dx = x - pxf[act][:, None, :]
        dy = y - pyf[act][:, None, :]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        gval = torch.exp(torch.clamp_max(power, 0.0))
        alpha = torch.clamp_max(op * gval, ALPHA_MAX)
        # broken-conic guard: power > 0 is skipped (forward.cu:310)
        visible = (power <= 0.0) & (alpha >= ALPHA_MIN)
        keep_t = 1.0 - alpha
        rgb = torch.stack([r, g, b], dim=2)                      # [A,B,3,1]
        # a step whose instance is visible at no pixel still walking when
        # the block starts changes nothing but the walked counts (done
        # pixels only grow within the block)
        busy = (visible & ~adone[:, None, :]).any(dim=2).any(dim=0).tolist()
        for j, s in enumerate(range(b0, b0 + steps.shape[0])):
            live = slot_ok[:, j, None] & ~adone
            awalked += live
            if not busy[j]:
                continue
            ok = live & visible[:, j]
            test_t = aT * keep_t[:, j]
            # termination latch: the killing instance does not contribute
            kill = ok & (test_t < T_EPS)
            contrib = ok & ~kill
            w = alpha[:, j] * aT
            aC = torch.where(contrib[:, None], aC + w[:, None] * rgb[:, j],
                             aC)
            crossing = contrib & (aT > 0.5) & (test_t < 0.5)
            aD = torch.where(crossing, dep[:, j], aD)
            anc = anc.masked_fill(contrib, s + 1)
            aT = torch.where(contrib, test_t, aT)
            adone = adone | kill
        T[act], C[act], D[act], nc[act], walked[act], done[act] = \
            aT, aC, aD, anc, awalked, adone
    color = C + T[:, None] * bg.to(f32)[None, :, None]
    return color, D, T, nc, walked


def assemble(x: torch.Tensor, grid_y: int, grid_x: int, tile_y: int,
             tile_x: int, height: int, width: int) -> torch.Tensor:
    """Per-tile [NT, (C,) P] -> image [(C,) height, W]: the first
    ``height`` rows of the tile grid (a strip keeps all of its rows)."""
    if x.dim() == 2:
        x = x.reshape(grid_y, grid_x, tile_y, tile_x).permute(0, 2, 1, 3)
        return x.reshape(grid_y * tile_y, grid_x * tile_x)[:height, :width]
    c = x.shape[1]
    x = x.reshape(grid_y, grid_x, c, tile_y, tile_x).permute(2, 0, 3, 1, 4)
    return x.reshape(c, grid_y * tile_y,
                     grid_x * tile_x)[:, :height, :width]


def buffer_rows(height: int, tile_y: int, grid_y_local: int) -> int:
    """Pixel rows of a render's buffers: the image's, or in strip mode
    (``grid_y_local`` > 0 tile rows) the whole strip's, uncropped."""
    return grid_y_local * tile_y if grid_y_local > 0 else height


def forward_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, bg: torch.Tensor, width: int,
                  height: int, tile_x: int, tile_y: int,
                  need_aux: bool = True, grid_y_local: int = 0,
                  y0_px: int = 0) -> ForwardTilesOut:
    """Composite every tile of the staged table (binning.StagedBins).

    Strip mode (saro_gs_tpu/ops/compositing.py:81-131): ``grid_y_local``
    tile rows from global pixel row ``y0_px``, binned strip-locally; the
    outputs are the strip's ``grid_y_local * tile_y`` rows, uncropped, and
    ``height`` stays the full frame's."""
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = grid_y_local or (height + tile_y - 1) // tile_y
    rows = buffer_rows(height, tile_y, grid_y_local)
    tids = torch.arange(grid_x * grid_y, device=attr.device)
    color, D, T, nc, walked = composite_tiles(
        attr, tile_start, tile_count, tids, bg, width, height, tile_x,
        tile_y, y0_px)

    def img(x):
        return assemble(x, grid_y, grid_x, tile_y, tile_x, rows, width)
    n_contrib = img(nc) if need_aux else torch.zeros(
        (rows, width), dtype=torch.int32, device=attr.device)
    return ForwardTilesOut(color=img(color), depth=img(D), final_t=img(T),
                           n_contrib=n_contrib, n_walked=img(walked))


def tile_image(img: torch.Tensor, tile_ids: torch.Tensor, width: int,
               height: int, tile_x: int, tile_y: int) -> torch.Tensor:
    """Image [(C,) height, W] -> per-tile pixels [T, (C,) P] of the given
    tiles; pixels outside the image read 0.  A strip's buffer is indexed
    by its strip-local tile ids and rows (``height`` its rows)."""
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
                   count_pairs: bool = False, grid_y_local: int = 0,
                   y0_px: int = 0):
    """Per-instance gradients [GRAD_ROWS, L] of the compositor (plain
    version of K3; saro_gs_tpu/ops/compositing.py:backward_tiles,
    backward.cu:399-557), given the forward's ``out_color`` [3,H,W],
    ``final_t`` and ``n_contrib`` [H,W] and the cotangent ``d_color``.

    A tile is replayed up to its largest n_contrib; slots past that, and
    invalid slots outside every range, stay zero.  As in the reference
    the 0.99 alpha clamp is not gated.  ``width``/``height`` are the full
    frame's (the NDC scaling of d_mean2d).  In strip mode
    (``grid_y_local``, ``y0_px`` as in ``forward_tiles``) the image
    tensors are the strip's buffers.

    With ``count_pairs`` returns (grad, n_pairs): the number of
    instance-pixel pairs that contributed, an int64 scalar tensor (the
    pairs replayed at all number ``n_contrib.sum()``)."""
    dev = attr.device
    f32 = torch.float32
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = grid_y_local or (height + tile_y - 1) // tile_y
    rows = buffer_rows(height, tile_y, grid_y_local)
    tids = torch.arange(grid_x * grid_y, device=dev)
    nt = tids.shape[0]
    p = tile_x * tile_y
    px, py = tile_pixel_coords(tids, grid_x, tile_x, tile_y, y0_px)
    pxf, pyf = px.to(f32), py.to(f32)
    bg = bg.to(f32)

    def tiles(img):
        return tile_image(img, tids, width, rows, tile_x, tile_y)

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
        adpix, atf, abg_dot = dpix[act], tf[act], bg_dot[act]
        steps = torch.arange(b0, min(b0 + block, max_limit), device=dev)
        # what does not depend on the replay's state, for the block's steps
        # at once ([A, B, P]); rows past a tile's bound are gathered
        # (clamped index) and masked by select, never multiplied away
        slot_ok = steps[None, :] < limit[act][:, None]           # [A, B]
        slot = start[act][:, None] + steps[None, :]
        idx = torch.where(slot_ok, slot, 0)
        x, y, ca, cb, cc, op, r, g, b, _ = attr[:, idx, None].unbind(0)
        dx = x - pxf[act][:, None, :]
        dy = y - pyf[act][:, None, :]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        gval = torch.exp(torch.clamp_max(power, 0.0))
        alpha = torch.clamp_max(op * gval, ALPHA_MAX)
        visible = (slot_ok[:, :, None] & (power <= 0.0)
                   & (alpha >= ALPHA_MIN))
        keep_t = 1.0 - alpha
        inv = 1.0 / (1.0 - alpha)
        gdx = gval * dx
        gdy = gval * dy
        # d_mean2d and d_conic per unit d_g
        geo = torch.stack([(-gdx * ca - gdy * cb), (-gdy * cc - gdx * cb),
                           (-0.5 * gdx * dx), (-gdx * dy),
                           (-0.5 * gdy * dy)], dim=2)            # [A,B,5,P]
        bg_term = atf[:, None] * inv * abg_dot[:, None]         # [A,B,P]
        rgb = torch.stack([r, g, b], dim=2)                      # [A,B,3,1]
        sums = torch.zeros((act.shape[0], steps.shape[0], GRAD_ROWS),
                           dtype=f32, device=dev)
        # d_mean2d's NDC scaling; the conic rows are scaled by an exact 1
        geo_scale = torch.tensor([half_w, half_h, 1.0, 1.0, 1.0], dtype=f32,
                                 device=dev)[:, None]
        for j, s in enumerate(range(b0, b0 + steps.shape[0])):
            ok = visible[:, j] & (s < anc)
            test_t = aT * keep_t[:, j]
            kill = ok & (test_t < T_EPS)       # the forward's latch
            anc = anc.masked_fill(kill, 0)
            contrib = ok & ~kill
            w = alpha[:, j] * aT
            aS = torch.where(contrib[:, None], aS - w[:, None] * rgb[:, j],
                             aS)
            e = (rgb[:, j] * aT[:, None] - aS * inv[:, j, None]) * adpix
            d_alpha = (e[:, 0] + e[:, 1] + e[:, 2]) - bg_term[:, j]
            d_g = op[:, j] * d_alpha   # the 0.99 clamp is not gated
            vals = torch.cat([w[:, None] * adpix,
                              d_g[:, None] * geo[:, j] * geo_scale,
                              (gval[:, j] * d_alpha)[:, None]], dim=1)
            vals = torch.where(contrib[:, None], vals, 0.0)      # [A,9,P]
            sums[:, j] = vals.sum(dim=2)
            aT = torch.where(contrib, test_t, aT)
            if count_pairs:
                n_pairs += contrib.sum()
        grad[:, slot[slot_ok]] = sums[slot_ok].T
        T[act], S[act], nc[act] = aT, aS, anc
    return (grad, n_pairs) if count_pairs else grad
