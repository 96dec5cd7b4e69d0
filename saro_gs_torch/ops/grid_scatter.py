"""Deterministic scatter-add of bilinear-tap gradients into feature grids
(counterpart of ops/grid_scatter.py).

``scatter_mip_taps`` is the grid gradient of one plane's
``mip.sample_mip``: the transpose of its tap gathers, both mip brackets at
once, into the flattened pyramid.  On the card it is kernel K4
(``csrc/grid_scatter.cu``, built and bound by ``tile_kernels``), which
replaces ``saro_gs_tpu/ops/grid_scatter.py:_scatter_kernel``: it makes each
point's taps itself, sorts them by cell with a stable radix sort over the
small key space, and sums each cell's segment in tap order, long segments
cut into pieces whose partials are summed in piece order.  No float
atomics: two calls agree to the bit, which the plain ``index_add_`` does
not promise on CUDA.  It is therefore the default on the card, where the
JAX package keeps its Pallas scatter opt-in.

The plain version makes the taps with ``mip_taps`` and scatters them with
``scatter_taps_plain``; ``sort_keys_plain`` is the plain twin of the
kernel's sort (its counts, scan and placement order).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import tile_kernels

# the kernel's sort: keys per sort block and bits per pass
SORT_TILE = 2048
RADIX_BITS = 8


def _at_most(x, bound):
    if isinstance(bound, int):
        return torch.clamp(x, max=bound)
    return torch.minimum(x, bound)


def tap_cells_weights(u, v, w_l, h_l, base):
    """Flat texel ids [4, N] int64 and bilinear weights [4, N] of one
    level's taps; ``w_l``/``h_l``/``base`` are python ints or per-point
    int tensors.  Clamped border taps repeat an id, and their weights
    simply add."""
    x = u * w_l - 0.5
    y = v * h_l - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.clamp(x - x0, 0, 1)
    fy = torch.clamp(y - y0, 0, 1)
    x0i = _at_most(torch.clamp(x0.to(torch.int64), min=0), w_l - 1)
    x1i = _at_most(x0i + 1, w_l - 1)
    y0i = _at_most(torch.clamp(y0.to(torch.int64), min=0), h_l - 1)
    y1i = _at_most(y0i + 1, h_l - 1)
    cells = torch.stack([base + y0i * w_l + x0i, base + y0i * w_l + x1i,
                         base + y1i * w_l + x0i, base + y1i * w_l + x1i])
    one = torch.ones_like(fx)
    wts = torch.stack([(one - fx) * (one - fy), fx * (one - fy),
                       (one - fx) * fy, fx * fy])
    return cells, wts


def level_sizes(h: int, w: int, n_levels: int):
    """(h_l, w_l) of each pyramid level and the flat offsets of the levels
    (numpy, one more than the levels: the last is the total)."""
    sizes = [(h >> l, w >> l) for l in range(n_levels + 1)]
    return sizes, np.cumsum([0] + [hl * wl for hl, wl in sizes])


def mip_taps(coords: torch.Tensor, level, h: int, w: int, n_levels: int):
    """The taps of ``sample_mip`` on an [h, w] plane with ``n_levels``
    levels above the base: cells [n_taps, N] int64 into the flattened
    pyramid, weights [n_taps, N] with each bracket's linear factor folded
    in, and the pyramid's cell count.  Two brackets of 4 taps (the level's
    floor first), or one when ``n_levels`` is 0 (``level`` unused)."""
    u, v = coords[:, 0], coords[:, 1]
    if n_levels == 0:
        cells, wts = tap_cells_weights(u, v, w, h, 0)
        return cells, wts, h * w
    level = torch.clamp(level.to(torch.float32), 0.0, float(n_levels))
    l0 = torch.clamp(torch.floor(level).to(torch.int64), 0, n_levels)
    l1 = torch.clamp(l0 + 1, 0, n_levels)
    frac = level - l0
    _, offs_np = level_sizes(h, w, n_levels)
    offs = torch.as_tensor(offs_np[:-1], dtype=torch.int64,
                           device=coords.device)
    cells, wts = [], []
    for l, factor in ((l0, 1.0 - frac), (l1, frac)):
        w_l = torch.bitwise_right_shift(torch.full_like(l, w), l)
        h_l = torch.bitwise_right_shift(torch.full_like(l, h), l)
        c, wt = tap_cells_weights(u, v, w_l, h_l, offs[l])
        cells.append(c)
        wts.append(wt * factor[None])
    return torch.cat(cells), torch.cat(wts), int(offs_np[-1])


def scatter_taps_plain(cells: torch.Tensor, weights: torch.Tensor,
                       dfeat: torch.Tensor, total: int) -> torch.Tensor:
    """``out[c, cells[t, i]] += weights[t, i] * dfeat[i, c]`` as one
    ``index_add_`` per tap -> [C, total] in dfeat's dtype.  cells/weights:
    [n_taps, N]; dfeat: [N, C].  Each product is rounded in dfeat's dtype
    and the sums are taken in float64: a cell that takes hundreds of
    thousands of taps (the hot cell at the top of a pyramid) would
    otherwise carry the rounding of a float32 sum in whatever order the
    device adds, and this version is the reference the kernel is held
    to."""
    out = torch.zeros((total, dfeat.shape[1]), dtype=torch.float64,
                      device=dfeat.device)
    for t in range(cells.shape[0]):
        out.index_add_(0, cells[t].long(),
                       (weights[t][:, None] * dfeat).double())
    return out.to(dfeat.dtype).T


def scatter_mip_taps_plain(coords, level, dfeat, h: int, w: int,
                           n_levels: int) -> torch.Tensor:
    """Plain version of K4; see ``scatter_mip_taps``."""
    cells, wts, total = mip_taps(coords, level, h, w, n_levels)
    return scatter_taps_plain(cells, wts, dfeat, total)


def radix_passes(total: int) -> int:
    """Passes of RADIX_BITS the kernel's sort makes over keys in
    [0, total)."""
    bits = max(int(total) - 1, 0).bit_length()
    return max(1, -(-bits // RADIX_BITS))


def sort_keys_plain(keys: torch.Tensor, total: int):
    """Plain twin of K4's stable sort: the permutation [n] int64 that
    sorts ``keys`` (ints in [0, total)) stably, and the segment bounds
    seg [total + 1] (seg[c] = the first sorted position with key >= c).
    Pass by pass as the kernel does it: per-block digit counts, their
    exclusive scan digit-major, then each key placed at its (digit, block)
    offset plus its rank among the equal digits earlier in its block."""
    keys = keys.reshape(-1).long()
    n = keys.numel()
    radix = 1 << RADIX_BITS
    n_blocks = max(1, -(-n // SORT_TILE))
    block = torch.arange(n) // SORT_TILE
    ids = torch.arange(n)
    for p in range(radix_passes(total)):
        digit = (keys >> (p * RADIX_BITS)) & (radix - 1)
        counts = torch.bincount(digit * n_blocks + block,
                                minlength=radix * n_blocks)
        offsets = torch.cumsum(counts, 0) - counts
        onehot = torch.zeros((n_blocks * SORT_TILE, radix), dtype=torch.int32)
        onehot[torch.arange(n), digit] = 1
        rank = onehot.reshape(n_blocks, SORT_TILE, radix).cumsum(1).reshape(
            -1, radix)[torch.arange(n), digit] - 1
        pos = offsets[digit * n_blocks + block] + rank
        new_keys = torch.empty_like(keys)
        new_ids = torch.empty_like(ids)
        new_keys[pos] = keys
        new_ids[pos] = ids
        keys, ids = new_keys, new_ids
    seg = torch.cat([torch.zeros(1, dtype=torch.int64),
                     torch.cumsum(torch.bincount(keys, minlength=total), 0)])
    return ids, seg


@functools.lru_cache(maxsize=64)
def _sizes(n: int, h: int, w: int, n_levels: int, c_feat: int):
    """The pyramid's cell count and the kernel's scratch bytes."""
    fn = tile_kernels._fn("grid_scatter", "saro_scatter_mip_workspace")
    return (int(level_sizes(h, w, n_levels)[1][-1]),
            int(fn(n, h, w, n_levels, c_feat)))


def scatter_mip_taps(coords: torch.Tensor, level, dfeat: torch.Tensor,
                     h: int, w: int, n_levels: int) -> torch.Tensor:
    """K4: the grid gradient d_flat [C, total] float32 of one plane's mip
    sampling, in the flattened pyramid's layout (level 0 first, each level
    row-major).  coords [N, 2] float32 in [0, 1] (coords[:, 0] along w),
    level [N] float32 fractional mip level (clamped to [0, n_levels]; may
    be None when ``n_levels`` is 0, which is one plain bilinear bracket),
    dfeat [N, C] float32, rows of any stride.  Duplicate cells from
    clamped border taps add; cells with no tap are zero.  A CPU tensor
    takes the plain version; a CUDA tensor takes the kernel or raises."""
    if dfeat.device.type == "cpu":
        return scatter_mip_taps_plain(coords, level, dfeat, h, w, n_levels)
    dev = dfeat.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_mip_taps: unsupported device {dev}")
    n, c_feat = dfeat.shape
    if dfeat.dtype != torch.float32:
        raise ValueError(f"dfeat has dtype {dfeat.dtype}, expected "
                         "torch.float32")
    # autograd may hand over a strided view: rows of any stride are read
    # in place, a non-unit channel stride is copied
    if dfeat.stride(1) != 1 or dfeat.stride(0) < c_feat:
        dfeat = dfeat.contiguous()
    if c_feat < 1:
        raise ValueError("dfeat has no channels")
    if n_levels < 0 or (h >> n_levels) < 1 or (w >> n_levels) < 1:
        raise ValueError(f"{n_levels} levels above a {h}x{w} base")
    tile_kernels._check(coords, "coords", torch.float32, (n, 2), dev)
    if n_levels > 0:
        tile_kernels._check(level, "level", torch.float32, (n,), dev)
    if n == 0:
        return torch.zeros((c_feat, int(level_sizes(h, w, n_levels)[1][-1])),
                           dtype=torch.float32, device=dev)
    total, work_bytes = _sizes(n, h, w, n_levels, c_feat)
    if 8 * n >= (1 << 31) or c_feat * total >= (1 << 31) \
            or dfeat.stride(0) * n >= (1 << 31):
        raise ValueError("tap, output and dfeat counts must fit in 31 bits")
    out = torch.empty((c_feat, total), dtype=torch.float32, device=dev)
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    fn = tile_kernels._fn("grid_scatter")
    err = fn(coords.data_ptr(), level.data_ptr() if n_levels > 0 else None,
             dfeat.data_ptr(), dfeat.stride(0), n, c_feat, h, w, n_levels,
             out.data_ptr(), work.data_ptr(), tile_kernels._stream())
    tile_kernels._launched("grid_scatter", err)
    return out
