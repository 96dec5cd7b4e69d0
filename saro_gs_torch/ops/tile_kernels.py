"""Hand-written Hopper kernels of the rasterizer and their wrappers
(counterpart of ops/tile_kernels.py), and the build of every kernel
library of the package.

  * K2, the instance expander (``csrc/expand.cu``), replaces
    ``saro_gs_tpu/ops/tile_kernels.py:_expand_kernel``;
  * K1, the forward compositor (``csrc/forward.cu``), replaces
    ``saro_gs_tpu/ops/tile_kernels.py:_fwd_kernel``;
  * K3, the backward compositor (``csrc/backward.cu``), replaces
    ``saro_gs_tpu/ops/tile_kernels.py:_bwd_kernel``;
  * K4, the field-gradient scatter (``csrc/grid_scatter.cu``), is built
    here and wrapped in ``ops/grid_scatter.py:scatter_mip_taps``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, under
``<repo>/build/saro_gs_torch/`` (git-ignored), and bound with ``ctypes``.
The libraries are named by a hash of source, shared headers and flags,
so an edited source is rebuilt.  ``-fmad=false`` keeps every multiply and
add rounded on its own, as PyTorch's eager kernels round them, so a
kernel and its plain version compute the same bits (K3, held to its plain
version by a tolerance, fuses some of its gradient arithmetic by explicit
``fmaf``); ``--use_fast_math`` is not used, so ``expf`` is the accurate
one.

Strip mode (the tile-axis sharding of parallel/shard.py): K2, K1 and K3
take ``y0_tiles``, the strip's first global tile row, with strip-local tile
ids (the expander's corner cull, the compositors' pixel coordinates and
warp boxes are global), and K1 and K3 take ``grid_y_local`` tile rows,
whose buffers are the strip's ``grid_y_local * tile_y`` rows; the inside
test and K3's NDC scale stay the full frame's.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (``torch.empty``; zeroed where the kernel leaves slots unwritten),
launches on the current stream, raises if the launch failed, and counts
its launches in ``launches``.  A CPU tensor takes the plain version; a
CUDA tensor takes the kernel or raises.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import compositing
from .compositing import ROWS

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build",
                         "saro_gs_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: source, function, argtypes (pointers and the stream as
# c_void_p, so ctypes passes them whole)
_KERNELS = {
    "expand": ("expand.cu", "saro_expand_instances",
               [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                _P, _P, _P, _P]),
    "forward": ("forward.cu", "saro_forward_tiles",
                [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 _P, _P, _P, _P, _P, _P]),
    "backward": ("backward.cu", "saro_backward_tiles",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _P, _P, _P, _P, _P, _P, _P]),
    "grid_scatter": ("grid_scatter.cu", "saro_scatter_mip_taps",
                     [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
}
# further C functions of a library: name -> (argtypes, restype)
_HELPERS = {
    "forward": {"saro_forward_band_rows": ([_I, _I], _I)},
    "grid_scatter": {"saro_scatter_mip_workspace": ([_I] * 5,
                                                    ctypes.c_longlong)},
}
# instances the backward stages per batch, whatever the forward's chunk:
# two staging buffers and nine partial sums per warp for each of them
# (52 KB a block at 8 warps)
BACKWARD_CHUNK = 128
# the backward splits a tile into this many bands of rows, a cluster of
# one block each (at most 256 threads; csrc/backward.cu:kSplit)
BACKWARD_SPLIT = 4

# launches of each kernel since the last reset_launches()
launches = {name: 0 for name in _KERNELS}
_libs = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    src = _KERNELS[name][0]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for name in [src, *headers]:
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _compile(name: str, verbose: bool) -> str:
    src, _, _ = _KERNELS[name]
    out = _lib_path(name)
    if os.path.exists(out):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, os.path.join(_CSRC, src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (rc {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return res.stderr


def build(verbose: bool = False) -> float:
    """Compile (one nvcc per source, all at once) and load every kernel
    library not loaded yet; returns the seconds it took.  ``verbose``
    prints ptxas' register and shared-memory report."""
    t0 = time.perf_counter()
    todo = [name for name in _KERNELS if name not in _libs]
    with concurrent.futures.ThreadPoolExecutor(max(len(todo), 1)) as ex:
        logs = dict(zip(todo, ex.map(lambda n: _compile(n, verbose), todo)))
    for name in todo:
        src, fn, argtypes = _KERNELS[name]
        lib = ctypes.CDLL(_lib_path(name))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        for helper, (h_args, h_res) in _HELPERS.get(name, {}).items():
            getattr(lib, helper).argtypes = h_args
            getattr(lib, helper).restype = h_res
        _libs[name] = lib
        if verbose and logs[name]:
            print(f"[build] {src}:\n{logs[name].strip()}", flush=True)
    return time.perf_counter() - t0


def _fn(name: str, symbol: str = ""):
    """The C function ``symbol`` (default: the launch) of library
    ``name``, built at first use."""
    build()
    return getattr(_libs[name], symbol or _KERNELS[name][1])


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launched(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K2: instance expansion (duplicateWithKeys, rasterizer_impl.cu:90-112)
# ---------------------------------------------------------------------------

def _corner_keep(tx, ty, a, tile_x: int, tile_y: int, y0_tiles: int = 0):
    """Corner cull (saro_gs_tpu/ops/binning.py:410-429): keep an instance
    unless its splat's largest alpha anywhere in the tile is < 1/255.
    power(q) <= -0.5 lam_min(C) |q|^2 with |q| >= dist(mean, tile rect).
    ``ty`` is strip-local, the tile's origin global.  Written in the
    kernel's order of operations."""
    mx, my, ca, cb, cc, op = (a[i] for i in range(6))
    px0 = (tx * tile_x).to(torch.float32)
    py0 = ((ty + y0_tiles) * tile_y).to(torch.float32)
    ddx = torch.clamp_min(torch.maximum(px0 - mx, mx - (px0 + tile_x - 1)),
                          0.0)
    ddy = torch.clamp_min(torch.maximum(py0 - my, my - (py0 + tile_y - 1)),
                          0.0)
    d = ca - cc
    lam_min = 0.5 * (ca + cc) - torch.sqrt(0.25 * (d * d) + cb * cb + 1e-20)
    power_bound = -0.5 * torch.clamp_min(lam_min, 0.0) * (ddx * ddx
                                                          + ddy * ddy)
    return op * torch.exp(power_bound) >= compositing.ALPHA_MIN


def run_owners(offsets, tiles, n_inst: int):
    """Owner of each of the n_inst slots, as the plain version finds it:
    kept Gaussians own consecutive slot ranges that tile [0, n_inst) in
    Gaussian order, so the owners in slot order are a repeat_interleave of
    each Gaussian's (capacity-cut) run length."""
    n = offsets.shape[0]
    keep = (tiles > 0) & (offsets < n_inst)
    cnt = torch.where(keep, torch.minimum(tiles, n_inst - offsets),
                      torch.zeros_like(tiles))
    return torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                   cnt.long(), output_size=n_inst)


def expand_instances_plain(offsets, tiles, rect, gattr, n_inst: int,
                           grid_x: int, grid_y: int, tile_x: int,
                           tile_y: int, corner_cull: bool,
                           y0_tiles: int = 0):
    """Plain version of K2; see ``expand_instances``."""
    dev = offsets.device
    g = run_owners(offsets, tiles, n_inst)
    local = torch.arange(n_inst, dtype=torch.int32, device=dev) - offsets[g]
    rmin_x, rmin_y, rmax_x = rect[0][g], rect[1][g], rect[2][g]
    rw = torch.clamp_min(rmax_x - rmin_x, 1)
    tx = rmin_x + local % rw
    ty = rmin_y + local // rw
    a = gattr.index_select(1, g)
    if corner_cull:
        valid = _corner_keep(tx, ty, a, tile_x, tile_y, y0_tiles)
    else:
        valid = torch.ones(n_inst, dtype=torch.bool, device=dev)
    tile = (ty * grid_x + tx).long()
    depth_bits = a[compositing.ROW_DEPTH].view(torch.int32).long() \
        & 0xFFFFFFFF
    sentinel = torch.full_like(tile, (grid_x * grid_y) << 32)
    keys = torch.where(valid, (tile << 32) | depth_bits, sentinel)
    gid = torch.where(valid, g.to(torch.int32), -1)
    attr = torch.where(valid[None], a, 0.0)
    return keys, gid, attr


def expand_instances(offsets: torch.Tensor, tiles: torch.Tensor,
                     rect: torch.Tensor, gattr: torch.Tensor, n_inst: int,
                     grid_x: int, grid_y: int, tile_x: int, tile_y: int,
                     corner_cull: bool, y0_tiles: int = 0):
    """K2: spread each Gaussian's attributes to its instance slots.

    offsets, tiles: [N] int32, the exclusive cumsum of tiles_touched and
    tiles_touched (0 for culled Gaussians); rect: [3, N] int32
    (rmin_x, rmin_y, rmax_x); gattr: [10, N] float32 finite payload rows
    (x, y, conic a/b/c, opacity, r, g, b, depth); n_inst = min(total,
    max_instances) slots.  Slot s belongs to the Gaussian g with
    offsets[g] <= s < offsets[g] + tiles[g] and covers tile
    (rmin_x + l % rw, rmin_y + l // rw), l = s - offsets[g], rw the rect
    width.  With ``corner_cull`` an instance whose alpha is < 1/255 all
    over its tile is invalid; in strip mode the rect rows are
    strip-local and the tile's pixels start at global tile row
    ``y0_tiles`` + its row.  One thread per slot, which finds its owner
    by binary search over offsets.

    Returns keys [n_inst] int64 (tile << 32 | depth bits; the sentinel
    tile grid_x*grid_y for invalid slots, which sort past every real tile),
    gid [n_inst] int32 (-1 invalid) and attr [10, n_inst] float32 (zeros
    for invalid slots)."""
    if offsets.device.type == "cpu":
        return expand_instances_plain(offsets, tiles, rect, gattr, n_inst,
                                      grid_x, grid_y, tile_x, tile_y,
                                      corner_cull, y0_tiles)
    dev = offsets.device
    if dev.type != "cuda":
        raise ValueError(f"expand_instances: unsupported device {dev}")
    n = offsets.shape[0]
    _check(offsets, "offsets", torch.int32, (n,), dev)
    _check(tiles, "tiles", torch.int32, (n,), dev)
    _check(rect, "rect", torch.int32, (3, n), dev)
    _check(gattr, "gattr", torch.float32, (ROWS, n), dev)
    if (grid_x * grid_y) >= (1 << 31):
        raise ValueError("tile ids must fit in 31 bits")
    keys = torch.empty(n_inst, dtype=torch.int64, device=dev)
    gid = torch.empty(n_inst, dtype=torch.int32, device=dev)
    attr = torch.empty((ROWS, n_inst), dtype=torch.float32, device=dev)
    if n_inst == 0:
        return keys, gid, attr
    fn = _fn("expand")
    err = fn(offsets.data_ptr(), tiles.data_ptr(), rect.data_ptr(),
             gattr.data_ptr(), n, n_inst, grid_x, grid_y, tile_x, tile_y,
             y0_tiles, int(corner_cull), keys.data_ptr(), gid.data_ptr(),
             attr.data_ptr(), _stream())
    _launched("expand", err)
    return keys, gid, attr


# ---------------------------------------------------------------------------
# K1: forward compositor
# ---------------------------------------------------------------------------

def heaviest_first(tile_count: torch.Tensor) -> torch.Tensor:
    """The compositors' (K1 and K3) launch order: int32 tile ids by
    ``tile_count``, a stable descending order, so the longest blocks start
    in the first wave.  Computed once per view, by binning; neither
    kernel's output depends on it."""
    return torch.argsort(tile_count, descending=True, stable=True).to(
        torch.int32)


def forward_band_rows(tile_x: int, tile_y: int) -> int:
    """Rows of a band of K1 for this tile, as the kernel's library picks
    them (csrc/forward.cu:saro_forward_band_rows; 32x32 tiles: 8 rows, 4
    bands; 16x16: one band); 0 where the kernel cannot take the tile."""
    return _fn("forward", "saro_forward_band_rows")(tile_x, tile_y)


def forward_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, bg: torch.Tensor, width: int,
                  height: int, tile_x: int, tile_y: int, chunk: int,
                  need_aux: bool = True, tile_order=None,
                  grid_y_local: int = 0,
                  y0_tiles: int = 0) -> compositing.ForwardTilesOut:
    """K1: front-to-back compositing of every tile's
    [tile_start, tile_start + tile_count) range of the staged table
    ``attr`` [10, L] (binning.StagedBins).  A tile is split into bands of
    rows (``forward_band_rows``), one block each, launched in
    ``tile_order`` ([NT] int32, default ``heaviest_first(tile_count)``);
    each warp culls the instances that cannot reach its 8x4-pixel patch
    and stops once its pixels are done.  Instances are staged ``chunk`` at
    a time, which changes no output.  Strip mode: ``grid_y_local`` tile
    rows from global tile row ``y0_tiles`` (module docstring).
    Plain version: compositing.forward_tiles."""
    if attr.device.type == "cpu":
        return compositing.forward_tiles(attr, tile_start, tile_count, bg,
                                         width, height, tile_x, tile_y,
                                         need_aux=need_aux,
                                         grid_y_local=grid_y_local,
                                         y0_px=y0_tiles * tile_y)
    dev = attr.device
    if dev.type != "cuda":
        raise ValueError(f"forward_tiles: unsupported device {dev}")
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = grid_y_local or (height + tile_y - 1) // tile_y
    rows = compositing.buffer_rows(height, tile_y, grid_y_local)
    nt = grid_x * grid_y
    if forward_band_rows(tile_x, tile_y) == 0:
        raise ValueError(f"tile {tile_x}x{tile_y}: a row of it does not fit "
                         "one block of the kernel")
    if not 1 <= chunk <= 1024:
        raise ValueError(f"chunk {chunk} outside [1, 1024]")
    _check(attr, "attr", torch.float32, (ROWS, attr.shape[1]), dev)
    _check(tile_start, "tile_start", torch.int32, (nt,), dev)
    _check(tile_count, "tile_count", torch.int32, (nt,), dev)
    _check(bg, "bg", torch.float32, (3,), dev)
    color = torch.empty((3, rows, width), dtype=torch.float32, device=dev)
    depth = torch.empty((rows, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((rows, width), dtype=torch.float32, device=dev)
    if need_aux:
        n_contrib = torch.empty((rows, width), dtype=torch.int32,
                                device=dev)
    else:
        n_contrib = torch.zeros((rows, width), dtype=torch.int32,
                                device=dev)
    if tile_order is None:
        tile_order = heaviest_first(tile_count)
    _check(tile_order, "tile_order", torch.int32, (nt,), dev)
    fn = _fn("forward")
    err = fn(tile_order.data_ptr(), tile_start.data_ptr(),
             tile_count.data_ptr(), attr.data_ptr(), attr.shape[1], width,
             height, grid_x, grid_y, tile_x, tile_y, y0_tiles * tile_y, rows,
             chunk, bg.data_ptr(),
             color.data_ptr(), depth.data_ptr(), final_t.data_ptr(),
             n_contrib.data_ptr() if need_aux else None, _stream())
    _launched("forward", err)
    return compositing.ForwardTilesOut(color=color, depth=depth,
                                       final_t=final_t, n_contrib=n_contrib)


# ---------------------------------------------------------------------------
# K3: backward compositor
# ---------------------------------------------------------------------------

def backward_tiles(attr: torch.Tensor, tile_start: torch.Tensor,
                   tile_count: torch.Tensor, bg: torch.Tensor,
                   n_contrib: torch.Tensor, out_color: torch.Tensor,
                   final_t: torch.Tensor, d_color: torch.Tensor, width: int,
                   height: int, tile_x: int, tile_y: int, tile_order=None,
                   grid_y_local: int = 0, y0_tiles: int = 0) -> torch.Tensor:
    """K3: per-instance gradients [9, L] of the compositor on the staged
    table ``attr`` [10, L], from the forward's ``out_color`` [3,H,W],
    ``final_t`` and ``n_contrib`` [H,W] and the colour cotangent
    ``d_color`` [3,H,W].  Rows: d_rgb (3), d_mean2d (2, NDC units of the
    full frame), d_conic (3, true b-gradient), d_opacity (1).  A tile is a
    cluster of BACKWARD_SPLIT blocks, one band of rows each, launched in
    ``tile_order`` (as K1; default ``heaviest_first(tile_count)``), each
    replaying up to its tile's largest n_contrib; a front-to-back replay
    in batches of BACKWARD_CHUNK instances; slots never visited are zero;
    no atomics, so two launches agree to the bit.  Strip mode as K1's
    (``grid_y_local``, ``y0_tiles``): the image tensors are the strip's
    buffers, while ``width``/``height`` stay the full frame's.
    Plain version: compositing.backward_tiles."""
    if attr.device.type == "cpu":
        return compositing.backward_tiles(attr, tile_start, tile_count, bg,
                                          n_contrib, out_color, final_t,
                                          d_color, width, height, tile_x,
                                          tile_y, grid_y_local=grid_y_local,
                                          y0_px=y0_tiles * tile_y)
    dev = attr.device
    if dev.type != "cuda":
        raise ValueError(f"backward_tiles: unsupported device {dev}")
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = grid_y_local or (height + tile_y - 1) // tile_y
    rows = compositing.buffer_rows(height, tile_y, grid_y_local)
    nt = grid_x * grid_y
    if tile_y < BACKWARD_SPLIT or tile_x * -(-tile_y // BACKWARD_SPLIT) > 256:
        raise ValueError(f"tile {tile_x}x{tile_y}: the kernel takes at "
                         f"least {BACKWARD_SPLIT} rows and at most 256 "
                         f"pixels in each of {BACKWARD_SPLIT} bands")
    n_slots = attr.shape[1]
    _check(attr, "attr", torch.float32, (ROWS, n_slots), dev)
    _check(tile_start, "tile_start", torch.int32, (nt,), dev)
    _check(tile_count, "tile_count", torch.int32, (nt,), dev)
    _check(bg, "bg", torch.float32, (3,), dev)
    _check(n_contrib, "n_contrib", torch.int32, (rows, width), dev)
    _check(out_color, "out_color", torch.float32, (3, rows, width), dev)
    _check(final_t, "final_t", torch.float32, (rows, width), dev)
    _check(d_color, "d_color", torch.float32, (3, rows, width), dev)
    grad = torch.zeros((compositing.GRAD_ROWS, n_slots),
                       dtype=torch.float32, device=dev)
    if tile_order is None:
        tile_order = heaviest_first(tile_count)
    _check(tile_order, "tile_order", torch.int32, (nt,), dev)
    # each tile's replay bound
    padded = torch.nn.functional.pad(
        n_contrib, (0, grid_x * tile_x - width, 0, grid_y * tile_y - rows))
    bound = torch.minimum(padded.reshape(grid_y, tile_y, grid_x, tile_x)
                          .amax(dim=(1, 3)).reshape(-1), tile_count)
    fn = _fn("backward")
    err = fn(tile_order.data_ptr(), bound.data_ptr(), tile_start.data_ptr(),
             attr.data_ptr(), n_slots, width, height, grid_x, grid_y, tile_x,
             tile_y, y0_tiles * tile_y, rows, BACKWARD_CHUNK, bg.data_ptr(),
             n_contrib.data_ptr(), out_color.data_ptr(), final_t.data_ptr(),
             d_color.data_ptr(), grad.data_ptr(), _stream())
    _launched("backward", err)
    return grad
