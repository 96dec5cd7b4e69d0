#!/usr/bin/env python3
"""Where the port's backward kernels spend their time, on one NVIDIA GPU.

    python3 scripts/torch_kernel_probe.py [--root DIR] [--counters]

Stages the arena checkpoint's frame as chip_smoke.py does (ring camera 0,
1352x1014, ts = 0.5, 32x32 tiles) with the saro_gs_torch package found
under DIR (default: this checkout; DIR may hold another revision's
package, for a comparison in one run), and prints one JSON line:

  * the tiles' replay bounds (min(tile count, the tile's largest
    n_contrib)): the largest 20, the median, the 90th percentile;
  * K3 (tile_kernels.backward_tiles) in ms, CUDA events over 10 launches:
    the whole frame, only the heaviest tile, only the 100 heaviest, all but
    the 100 heaviest (the other tiles' counts set to 0);
  * the grid gradient of one plane (ops/mip.py:_grid_grad, K4 and the
    pyramid's transpose chain) in ms for the (x, y) plane and the (x, t)
    plane, CUDA events over 20 calls, and the host's enqueue time per call;
  * the device time of each kernel that one (x, y) plane's gradient
    launches, by torch.profiler over 5 calls.

With --counters it also builds a copy of csrc/backward.cu with integer
counters added (under build/probe/) and prints how many (warp, instance)
pairs K3 meets inside the warps' replay bounds, how many its cull lets
through, how many have a contributing pixel, and the contributing pixels.
Imports nothing of JAX.  Times are the card's own: the card's name and
power limit are in the line.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, TILE = 1352, 1014, 32


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# the counters: (anchor in backward.cu, code put before it)
_COUNT_DECL = ("namespace cg = cooperative_groups;",
               "__device__ unsigned long long probe_cnt[4];\n"
               "extern \"C\" int probe_counters(void* out) {\n"
               "  return (int)cudaMemcpyFromSymbol(out, probe_cnt,\n"
               "                                   sizeof(probe_cnt));\n"
               "}\n")
_COUNT_LIVE = ("      for (unsigned live = __ballot_sync(kFull, reach);",
               "      {\n"
               "        const unsigned rb = __ballot_sync(kFull, reach);\n"
               "        if (lane == 0) {\n"
               "          atomicAdd(&probe_cnt[0],\n"
               "                    (unsigned long long)min(32, wl - g));\n"
               "          atomicAdd(&probe_cnt[1],\n"
               "                    (unsigned long long)__popc(rb));\n"
               "        }\n"
               "      }\n")
_COUNT_CONTRIB = ("        if (any1 != 0u && any2 != 0u) {",
                  "        if (lane == 0) {\n"
                  "          atomicAdd(&probe_cnt[2], (unsigned long long)"
                  "((any1 != 0u) + (any2 != 0u)));\n"
                  "          atomicAdd(&probe_cnt[3], (unsigned long long)"
                  "(__popc(any1) + __popc(any2)));\n"
                  "        }\n")


def counted_backward(tk):
    """Build csrc/backward.cu with the counters under build/probe/ and
    route tile_kernels.backward_tiles through it; returns a function that
    reads the counters."""
    src = open(os.path.join(tk._CSRC, "backward.cu")).read()
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    for anchor, code in (_COUNT_DECL, _COUNT_LIVE, _COUNT_CONTRIB):
        if src.count(anchor) != 1:
            raise RuntimeError(f"backward.cu has no single {anchor!r}")
        if anchor == _COUNT_DECL[0]:
            src = src.replace(anchor, anchor + "\n" + code)
        else:
            src = src.replace(anchor, code + anchor)
    with open(os.path.join(out_dir, "backward.cu"), "w") as f:
        f.write(src)
    shutil.copy(os.path.join(tk._CSRC, "alpha_chain.cuh"), out_dir)
    lib_path = os.path.join(out_dir, "libbackward_counted.so")
    res = subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-o", lib_path,
                          os.path.join(out_dir, "backward.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr)
    lib = ctypes.CDLL(lib_path)
    fn = lib.saro_backward_tiles
    fn.argtypes = tk._KERNELS["backward"][2]
    fn.restype = ctypes.c_int
    tk._libs["backward"] = type("Counted", (), {
        tk._KERNELS["backward"][1]: fn})()
    buf = (ctypes.c_ulonglong * 4)()

    def read():
        lib.probe_counters(buf)
        return list(buf)
    return read


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--counters", action="store_true")
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a card")
    sys.path.insert(0, os.path.abspath(opt.root))
    from saro_gs_torch import config as cfg_mod
    from saro_gs_torch import render, scene
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import field as field_mod
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import binning, mip, projection
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
    keys, gid, attr, _, _ = binning.expand(pre, d.opacity.reshape(-1), gx,
                                           gy, 1 << 21, TILE, TILE, True)
    attr_s, _, tstart, tcount, _ = binning.sort_instances(keys, gid, attr,
                                                          gx * gy)
    fwd = tk.forward_tiles(attr_s, tstart, tcount, bg, W, H, TILE, TILE, 128,
                           need_aux=True)
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

    def only(tiles, keep):
        counts = torch.zeros_like(tcount) if keep else tcount.clone()
        counts[tiles] = tcount[tiles] if keep else 0
        return [*args[:2], counts, *args[3:]]
    k3 = {name: cuda_ms(torch, lambda a=a: tk.backward_tiles(*a), 10)
          for name, a in (("frame", args), ("heaviest_tile",
                                             only(heavy[:1], True)),
                          ("heaviest_100", only(heavy[:100], True)),
                          ("all_but_heaviest_100",
                           only(heavy[:100], False)))}

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
        ms = cuda_ms(torch, lambda g=grad_args: mip._grid_grad(*g), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            mip._grid_grad(*grad_args)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        planes[name] = {"ms": ms, "host_enqueue_ms": host_ms}
        if name == "xy":
            xy_args = grad_args
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            mip._grid_grad(*xy_args)
        torch.cuda.synchronize()
    by_kernel = {e.key[:80]: e.self_device_time_total / 5 / 1e3
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0}
    out = {"card": card, "root": os.path.abspath(opt.root),
           "tile_bounds": {"largest_20": np.sort(b)[::-1][:20].tolist(),
                           "median": float(np.median(b)),
                           "p90": float(np.percentile(b, 90)),
                           "tiles": int(b.size)},
           "k3_ms": k3, "grid_grad_plane": planes,
           "grid_grad_xy_device_ms_by_kernel": by_kernel}
    if opt.counters:
        read = counted_backward(tk)
        tk.backward_tiles(*args)
        torch.cuda.synchronize()
        out["k3_counts"] = dict(zip(
            ("warp_instances_in_bound", "warp_instances_evaluated",
             "warp_instances_with_contributor", "contributing_pixels"),
            read()))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
