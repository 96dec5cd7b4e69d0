"""Deterministic scatter-add of bilinear-tap gradients into feature grids
(counterpart of ops/grid_scatter.py).

``scatter_taps`` is the transpose of the tap gathers of ``mip.sample_mip``:
``out[c, cells[t, i]] += weights[t, i] * dfeat[i, c]``.  On the card it is
kernel K4 (``csrc/grid_scatter.cu``, built and bound by
``tile_kernels``), which replaces
``saro_gs_tpu/ops/grid_scatter.py:_scatter_kernel``: the wrapper sorts the
taps by cell (stably, so a cell's taps keep their tap-major, point-minor
order) and finds each cell's segment; the kernel gives every cell to a
warp that walks its segment in that order.  No atomics: two calls agree to
the bit, which the plain ``index_add_`` does not promise on CUDA.  It is
therefore the default on the card, where the JAX package keeps its Pallas
scatter opt-in.
"""
from __future__ import annotations

import torch

from . import tile_kernels


def scatter_taps_plain(cells: torch.Tensor, weights: torch.Tensor,
                       dfeat: torch.Tensor, total: int) -> torch.Tensor:
    """Plain version of K4: one ``index_add_`` per tap -> [C, total].
    cells/weights: [n_taps, N]; dfeat: [N, C]."""
    out = torch.zeros((total, dfeat.shape[1]), dtype=dfeat.dtype,
                      device=dfeat.device)
    for t in range(cells.shape[0]):
        out.index_add_(0, cells[t].long(), weights[t][:, None] * dfeat)
    return out.T


def sort_taps(cells: torch.Tensor, weights: torch.Tensor, total: int):
    """The kernel's inputs: (seg [total + 1] int32, point [n_taps * N]
    int32, weight [n_taps * N] float32), the taps sorted stably by cell
    and the bounds of each cell's segment."""
    n = cells.shape[1]
    # 32-bit keys: half the radix passes of the int64 ids that indexing
    # hands over
    sorted_cells, order = torch.sort(cells.reshape(-1).to(torch.int32),
                                     stable=True)
    point = (order % n).to(torch.int32)
    weight = weights.reshape(-1).to(torch.float32)[order]
    bounds = torch.arange(total + 1, dtype=torch.int32,
                          device=cells.device)
    seg = torch.searchsorted(sorted_cells, bounds, side="left")
    return seg.to(torch.int32), point, weight


def scatter_taps(cells: torch.Tensor, weights: torch.Tensor,
                 dfeat: torch.Tensor, total: int) -> torch.Tensor:
    """K4: deterministic ``out[c, cells[t, i]] += weights[t, i] *
    dfeat[i, c]`` -> [C, total] float32.  cells [n_taps, N] int32 or int64
    in [0, total) (duplicate ids, as clamped border taps give, simply
    add), weights [n_taps, N] float32, dfeat [N, C] float32.  Cells with
    no tap are zero.  A CPU tensor takes the plain version; a CUDA tensor
    takes the kernel or raises."""
    if dfeat.device.type == "cpu":
        return scatter_taps_plain(cells, weights, dfeat, total)
    dev = dfeat.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_taps: unsupported device {dev}")
    n_taps, n = cells.shape
    c_feat = dfeat.shape[1]
    if cells.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"cells has dtype {cells.dtype}, expected an "
                         "integer type")
    if cells.device != dev:
        raise ValueError(f"cells on {cells.device}, expected {dev}")
    if n_taps * n >= (1 << 31) or c_feat * total >= (1 << 31):
        raise ValueError("tap and output counts must fit in 31 bits")
    tile_kernels._check(weights, "weights", torch.float32, (n_taps, n), dev)
    tile_kernels._check(dfeat, "dfeat", torch.float32, (n, c_feat), dev)
    seg, point, weight = sort_taps(cells, weights, total)
    out = torch.empty((c_feat, total), dtype=torch.float32, device=dev)
    if total == 0:
        return out
    fn = tile_kernels._fn("grid_scatter")
    err = fn(seg.data_ptr(), point.data_ptr(), weight.data_ptr(),
             dfeat.data_ptr(), c_feat, total, out.data_ptr(),
             tile_kernels._stream())
    tile_kernels._launched("grid_scatter", err)
    return out
