#!/usr/bin/env python3
"""Where the port's compositor, expander and field-gradient kernels spend
their time, on one NVIDIA GPU.

    python3 scripts/torch_kernel_probe.py [--root DIR] [--counters] [--chunk N]

Stages the arena checkpoint's frame as chip_smoke.py does (ring camera 0,
1352x1014, ts = 0.5, 32x32 tiles) with the saro_gs_torch package found
under DIR (default: this checkout; DIR may hold another revision's
package, for a comparison in one run), and prints one JSON line:

  * the tiles' replay bounds (min(tile count, the tile's largest
    n_contrib)): the largest 20, the median, the 90th percentile;
  * whether K2's tables and K1's four outputs (at --chunk) equal their
    plain versions' to the bit;
  * K2 (tile_kernels.expand_instances) in ms, CUDA events over 20 launches,
    the device time of every kernel one call launches, summed, and that of
    each, by torch.profiler over 10 calls (the wrapper's host time may
    exceed a short kernel's);
  * K1 (tile_kernels.forward_tiles, need_aux=False, as the render calls
    it) in ms, CUDA events over 20 launches, and the device time of every
    kernel one call launches (the tile-order sort and the zero fill
    included), summed, by torch.profiler over 10: the whole frame, only
    the heaviest tile (by tile count), only the 100 heaviest, all but the
    100 heaviest (the other tiles' counts set to 0); and the device time
    of each kernel of a whole frame's call;
  * K3 (tile_kernels.backward_tiles) in ms, CUDA events over 10 launches:
    the whole frame, only the heaviest tile, only the 100 heaviest, all but
    the 100 heaviest (the other tiles' counts set to 0); and, where the
    wrappers take a ``tile_order``, the device time of K3's kernel on the
    whole frame launched by tile count (K1's order) and by replay bound,
    by torch.profiler over 10 launches, in the order count, bound, bound,
    count;
  * the grid gradient of one plane (ops/mip.py:_grid_grad, K4 and the
    pyramid's transpose chain) in ms for the (x, y) plane and the (x, t)
    plane, CUDA events over 20 calls, and the host's enqueue time per call;
  * the device time of each kernel that one (x, y) plane's gradient
    launches, by torch.profiler over 5 calls.

With --counters it also builds copies of csrc/backward.cu and
csrc/forward.cu with integer counters added (under build/probe/) and
prints how many (warp, instance) pairs K3 meets inside the warps' replay
bounds, how many its cull lets through, how many have a contributing
pixel, and the contributing pixels; and how many (warp, instance) pairs
K1's warps meet while a pixel of theirs still walks, how many the cull
keeps, and how many they walk before their pixels have all ended.
Times are taken by this checkout's saro_gs_torch/timing.py, whatever
--root holds.  Imports nothing of JAX.  Times are the card's own: the
card's name and power limit are in the line.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, TILE = 1352, 1014, 32


def own_timing():
    """This checkout's saro_gs_torch/timing.py, loaded on its own, so that
    a --root revision is timed by the same code."""
    spec = importlib.util.spec_from_file_location(
        "probe_timing", os.path.join(HERE, "saro_gs_torch", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the counters of each kernel: its library, the number of counters, and
# (anchor in its source, code put after (first) or before (the rest) it)
def _decl(n):
    return (f"__device__ unsigned long long probe_cnt[{n}];\n"
            f"extern \"C\" int probe_counters(void* out) {{\n"
            f"  return (int)cudaMemcpyFromSymbol(out, probe_cnt,\n"
            f"                                   sizeof(probe_cnt));\n"
            f"}}\n")


_COUNTERS = {
    "backward": (4, [
        ("namespace cg = cooperative_groups;", _decl(4)),
        ("      for (unsigned live = __ballot_sync(kFull, reach);",
         "      {\n"
         "        const unsigned rb = __ballot_sync(kFull, reach);\n"
         "        if (lane == 0) {\n"
         "          atomicAdd(&probe_cnt[0],\n"
         "                    (unsigned long long)min(32, wl - g));\n"
         "          atomicAdd(&probe_cnt[1],\n"
         "                    (unsigned long long)__popc(rb));\n"
         "        }\n"
         "      }\n"),
        ("        if (any1 != 0u && any2 != 0u) {",
         "        if (lane == 0) {\n"
         "          atomicAdd(&probe_cnt[2], (unsigned long long)"
         "((any1 != 0u) + (any2 != 0u)));\n"
         "          atomicAdd(&probe_cnt[3], (unsigned long long)"
         "(__popc(any1) + __popc(any2)));\n"
         "        }\n")],
        ("warp_instances_in_bound", "warp_instances_evaluated",
         "warp_instances_with_contributor", "contributing_pixels")),
    # K1: (warp, instance) pairs its warps meet while some pixel of theirs
    # still walks, those the cull keeps, those evaluated before the warp's
    # pixels all ended
    "forward": (3, [
        ('#include "alpha_chain.cuh"', _decl(3)),
        ("      for (unsigned live = __ballot_sync(kFull, reach); live != 0u;) {",
         "      {\n"
         "        const unsigned rb = __ballot_sync(kFull, reach);\n"
         "        if (lane == 0) {\n"
         "          atomicAdd(&probe_cnt[0],\n"
         "                    (unsigned long long)min(32, nb - g));\n"
         "          atomicAdd(&probe_cnt[1],\n"
         "                    (unsigned long long)__popc(rb));\n"
         "        }\n"
         "      }\n"),
        ("          al[k] = s.alpha;",
         "          if (lane == 0 && js[k] >= 0)\n"
         "            atomicAdd(&probe_cnt[2], 1ull);\n")],
        ("warp_instances_met", "warp_instances_kept",
         "warp_instances_evaluated")),
}


def counted(tk, name):
    """Build csrc/<name>.cu with the counters under build/probe/ and route
    tile_kernels' wrapper through it; returns a function that reads the
    counters as a dict."""
    n, anchors, keys = _COUNTERS[name]
    src_name = tk._KERNELS[name][0]
    src = open(os.path.join(tk._CSRC, src_name)).read()
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    for i, (anchor, code) in enumerate(anchors):
        if src.count(anchor) != 1:
            raise RuntimeError(f"{src_name} has no single {anchor!r}")
        src = src.replace(anchor, anchor + "\n" + code if i == 0
                          else code + anchor)
    with open(os.path.join(out_dir, src_name), "w") as f:
        f.write(src)
    shutil.copy(os.path.join(tk._CSRC, "alpha_chain.cuh"), out_dir)
    lib_path = os.path.join(out_dir, f"lib{name}_counted.so")
    res = subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-o", lib_path,
                          os.path.join(out_dir, src_name)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr)
    lib = ctypes.CDLL(lib_path)
    _, launch, argtypes = tk._KERNELS[name]
    for sym, (args, res) in [(launch, (argtypes, ctypes.c_int)),
                             *tk._HELPERS.get(name, {}).items()]:
        getattr(lib, sym).argtypes = args
        getattr(lib, sym).restype = res
    tk._libs[name] = lib
    buf = (ctypes.c_ulonglong * n)()

    def read():
        lib.probe_counters(buf)
        return dict(zip(keys, buf))
    return read


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--counters", action="store_true")
    ap.add_argument("--chunk", type=int, default=128,
                    help="K1's staging batch (the arena config's: 128)")
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a card")
    timing = own_timing()
    event_ms, device_ms = timing.event_ms, timing.device_ms
    sys.path.insert(0, os.path.abspath(opt.root))
    from saro_gs_torch import config as cfg_mod
    from saro_gs_torch import render, scene
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import field as field_mod
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import binning, compositing, mip, projection
    from saro_gs_torch.ops import tile_kernels as tk

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tk.build()
    arena = os.path.join(HERE, "checkpoints", "arena")
    cfg = cfg_mod.load_cfg_args(os.path.join(arena, "cfg_args.json"))
    mcfg = cfg.model_config()
    params, nets, alive, fstatic, npts = scene.load_gaussian_checkpoint(
        os.path.join(arena, "point_cloud", "iteration_best",
                     "point_cloud.ply"), mcfg, device=dev)
    with torch.no_grad():
        feat = gm.field_feat(params, nets, mcfg, fstatic)
        d = gm.deform(params, nets, mcfg, fstatic, 0.5, feat=feat)
    cam = cameras.camera_from_c2w(cameras.ring_cameras(21)[0], 0.85, W, H,
                                  0.0).raster_params(dev)
    bg = torch.ones(3, device=dev)
    gx, gy = -(-W // TILE), -(-H // TILE)
    active = alive * (d.state[:, 0] > render.EVAL_STATE_CUTOFF)
    pre = projection.preprocess(
        d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam, W, H, TILE,
        TILE, sh_degree=3, shs=d.shs, active=active, tight_rect=True)
    offsets, tiles, rect, gattr, total = binning.expand_inputs(
        pre, d.opacity.reshape(-1))
    exp_args = (offsets, tiles, rect, gattr, total, gx, gy, TILE, TILE, True)
    keys, gid, attr = tk.expand_instances(*exp_args)
    plain = tk.expand_instances_plain(*exp_args)
    k2_equal = (torch.equal(keys, plain[0]) and torch.equal(gid, plain[1])
                and torch.equal(attr.view(torch.int32),
                                plain[2].view(torch.int32)))
    k2_ms = event_ms(lambda: tk.expand_instances(*exp_args), 20)
    k2_by_kernel = device_ms(lambda: tk.expand_instances(*exp_args), 10)
    attr_s, _, tstart, tcount, _ = binning.sort_instances(keys, gid, attr,
                                                          gx * gy)
    fwd = tk.forward_tiles(attr_s, tstart, tcount, bg, W, H, TILE, TILE,
                           opt.chunk, need_aux=True)
    pf = compositing.forward_tiles(attr_s, tstart, tcount, bg, W, H, TILE,
                                   TILE, need_aux=True)
    k1_equal = all(torch.equal(getattr(fwd, k), getattr(pf, k))
                   for k in ("color", "depth", "final_t", "n_contrib"))
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_color = torch.randn(3, H, W, generator=gen).to(dev)
    padded = torch.nn.functional.pad(fwd.n_contrib,
                                     (0, gx * TILE - W, 0, gy * TILE - H))
    bound = torch.minimum(padded.reshape(gy, TILE, gx, TILE)
                          .amax(dim=(1, 3)).reshape(-1), tcount)
    b = bound.cpu().numpy()
    heavy = torch.as_tensor(np.argsort(-b, kind="stable").copy(),
                            device=dev)
    args = [attr_s, tstart, tcount, bg, fwd.n_contrib, fwd.color,
            fwd.final_t, d_color, W, H, TILE, TILE]

    def only(tiles, keep, a=args):
        counts = torch.zeros_like(tcount) if keep else tcount.clone()
        counts[tiles] = tcount[tiles] if keep else 0
        return [*a[:2], counts, *a[3:]]
    fwd_args = [attr_s, tstart, tcount, bg, W, H, TILE, TILE, opt.chunk]
    by_count = torch.argsort(tcount, descending=True, stable=True)
    k1, k1_device = {}, {}
    for name, a in (("frame", fwd_args),
                    ("heaviest_tile", only(by_count[:1], True, fwd_args)),
                    ("heaviest_100", only(by_count[:100], True, fwd_args)),
                    ("all_but_heaviest_100",
                     only(by_count[:100], False, fwd_args))):
        def call(a=a):
            return tk.forward_tiles(*a, need_aux=False)
        k1[name] = event_ms(call, 20)
        k1_device[name] = sum(device_ms(call, 10).values())
    k3 = {name: event_ms(lambda a=a: tk.backward_tiles(*a), 10)
          for name, a in (("frame", args), ("heaviest_tile",
                                             only(heavy[:1], True)),
                          ("heaviest_100", only(heavy[:100], True)),
                          ("all_but_heaviest_100",
                           only(heavy[:100], False)))}
    k3_order = {}
    if hasattr(tk, "heaviest_first"):
        orders = {"by_count": tk.heaviest_first(tcount),
                  "by_bound": tk.heaviest_first(bound)}
        for key in ("by_count", "by_bound", "by_bound", "by_count"):
            ms = sum(v for k, v in device_ms(
                lambda: tk.backward_tiles(*args, tile_order=orders[key]),
                10).items() if "backward_kernel" in k)
            k3_order.setdefault(key, []).append(ms)
        assert torch.equal(
            tk.backward_tiles(*args, tile_order=orders["by_bound"]),
            tk.backward_tiles(*args, tile_order=orders["by_count"]))

    fcfg = mcfg.field
    with torch.no_grad():
        norm = (params.xyz - fstatic.aabb_min) / (fstatic.aabb_max
                                                  - fstatic.aabb_min)
        tn = gm.get_temporal_pos(params, mcfg) * fstatic.duration \
            / (fstatic.duration - 1.0)
        levels4 = field_mod.get_levels(fcfg, fstatic, gm.get_scaling(params))
    coords4 = torch.cat([norm, tn.reshape(-1, 1)], dim=-1)
    reso = fcfg.reso(fcfg.multires[0])
    dfeat = torch.randn(npts, fcfg.out_dim, generator=gen).to(dev)
    planes = {}
    for name, (a, c), max_level in (("xy", (0, 1), field_mod.SPATIAL_MAX_MIP),
                                    ("xt", (0, 3), 0)):
        shape = (fcfg.out_dim, reso[c], reso[a])
        grad_args = (shape, coords4[:, [a, c]].contiguous(),
                     torch.minimum(levels4[:, a], levels4[:, c]), max_level,
                     dfeat)
        ms = event_ms(lambda g=grad_args: mip._grid_grad(*g), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            mip._grid_grad(*grad_args)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        planes[name] = {"ms": ms, "host_enqueue_ms": host_ms}
        if name == "xy":
            xy_args = grad_args
    by_kernel = device_ms(lambda: mip._grid_grad(*xy_args), 5)
    out = {"card": card, "root": os.path.abspath(opt.root),
           "tile_bounds": {"largest_20": np.sort(b)[::-1][:20].tolist(),
                           "median": float(np.median(b)),
                           "p90": float(np.percentile(b, 90)),
                           "tiles": int(b.size)},
           "max_tile_count": int(tcount.max()), "instances": total,
           "k2_equal_to_plain": k2_equal, "k1_equal_to_plain": k1_equal,
           "k2_ms": k2_ms, "k2_device_ms": sum(k2_by_kernel.values()),
           "k2_device_ms_by_kernel": k2_by_kernel,
           "k1_ms": k1, "k1_device_ms": k1_device,
           "k1_device_ms_by_kernel": device_ms(
               lambda: tk.forward_tiles(*fwd_args, need_aux=False), 10),
           "k3_ms": k3, "k3_kernel_device_ms_by_order": k3_order,
           "grid_grad_plane": planes,
           "grid_grad_xy_device_ms_by_kernel": by_kernel}
    if opt.counters:
        read = counted(tk, "backward")
        tk.backward_tiles(*args)
        torch.cuda.synchronize()
        out["k3_counts"] = read()
        read = counted(tk, "forward")
        tk.forward_tiles(*fwd_args, need_aux=False)
        torch.cuda.synchronize()
        out["k1_counts"] = read()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
