#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (saro_gs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

  1. device: require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ with nvcc;
  3. K2 (instance expander) against its plain version on the arena
     checkpoint's preprocessed Gaussians at 1352x1014, ts = 0.5: the
     instance tables and the sorted tile ranges must be equal exactly;
  4. K1 (forward compositor) against its plain version on that staged
     table, every tile: colour and final T within 1e-4, median depth and
     n_contrib equal on >= 99.9% of pixels;
  5. the slice: the arena checkpoint rendered by render.test_render at
     1352x1014 from ring camera 0 over bench.py's timestamp sweep (50
     frames, 10 warm-up), timed with CUDA events; FPS, ms per stage and
     each kernel's launches in that run (both must be > 0, nothing may be
     dropped);
  6. parity with the JAX package: the 338x254 render against
     tests/golden/torch_arena_338x254.npz (PSNR >= 50 dB, max error
     < 4/255);
  7. one JSON line per kernel summary, then the card line, then the
     result line {"ok": true, "device": {...}}.

Imports nothing of JAX.  Times are the card's own: read them beside the
card's name and power limit printed with them.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 1352, 1014
GOLDEN = os.path.join(HERE, "tests", "golden", "torch_arena_338x254.npz")
ARENA = os.path.join(HERE, "checkpoints", "arena")
PLY = os.path.join(ARENA, "point_cloud", "iteration_best", "point_cloud.ply")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s outside
# the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# per evaluated instance-pixel pair in K1: dx, dy (2), power (9), min,
# expf (counted as 1), opacity * g, min, 2 cutoff compares, 1 - alpha,
# * T, the T_EPS compare; a contributing pair adds 9 more, not counted
K1_FLOPS_PER_PAIR = 20
# per instance in K2: tile origin (2), distances to the tile rect (10),
# power bound (4), expf, opacity * g, compare
K2_FLOPS_PER_INSTANCE = 19


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, torch):
    """Mean ms per call of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, HERE)
    from saro_gs_torch import config as cfg_mod
    from saro_gs_torch import render, scene
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import binning, compositing, projection
    from saro_gs_torch.ops import tile_kernels as tk

    dev = torch.device("cuda")
    torch.manual_seed(0)

    # ---- 1. device --------------------------------------------------------
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(card, flush=True)

    # ---- 2. build ---------------------------------------------------------
    secs = tk.build(verbose=True)
    log(f"build: {secs:.2f} s (nvcc, {len(tk.launches)} kernels)")

    # ---- the model ----------------------------------------------------------
    cfg = cfg_mod.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    mcfg = cfg.model_config()
    params, nets, alive, fstatic, npts = scene.load_gaussian_checkpoint(
        PLY, mcfg, device=dev)
    with torch.no_grad():
        feat = gm.field_feat(params, nets, mcfg, fstatic)
    cam = cameras.camera_from_c2w(cameras.ring_cameras(21)[0], 0.85, W, H,
                                  0.0).raster_params(dev)
    bg = torch.ones(3, device=dev)        # white background (cfg_args)
    rcfg = cfg.raster_config()._replace(need_aux=False)
    log(f"model: {npts} Gaussians, planes "
        f"{[tuple(p.shape) for p in nets.field.planes][:2]}..., "
        f"hidden {mcfg.deform_hidden_dim}; raster tile {rcfg.tile_x}, "
        f"chunk {rcfg.chunk}")

    def frame(ts, rc):
        return render.test_render(cam, ts, params, nets, alive, mcfg,
                                  fstatic, bg, width=W, height=H,
                                  sh_degree=3, rcfg=rc, feat=feat)[0]

    # instance capacity as bench.py sizes it: probe the sweep's timestamp
    # extremes and the middle, add 15%, round up to 64k
    need = 0
    for pts in (0.01, 0.5, 0.99):
        out = frame(pts, rcfg)
        need = max(need, out.num_instances + out.num_dropped)
    cap = max(-(-int(need * 1.15) // 65536) * 65536, 65536)
    rcfg = rcfg._replace(max_instances=cap)
    log(f"capacity: {need} instances at most over the probes -> "
        f"max_instances {cap}")

    gx = (W + rcfg.tile_x - 1) // rcfg.tile_x
    gy = (H + rcfg.tile_y - 1) // rcfg.tile_y
    nt = gx * gy

    def stage_inputs(ts):
        with torch.no_grad():
            d = gm.deform(params, nets, mcfg, fstatic, ts, feat=feat)
        active = alive * (d.state[:, 0] > render.EVAL_STATE_CUTOFF)
        pre = projection.preprocess(
            d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam, W, H,
            rcfg.tile_x, rcfg.tile_y, sh_degree=3, shs=d.shs, active=active,
            tight_rect=rcfg.tight_rect)
        return d, pre

    # ---- 3. K2 against its plain version ------------------------------------
    d, pre = stage_inputs(0.5)
    opac = d.opacity.reshape(-1)
    offsets, tiles, rect, gattr, total = binning.expand_inputs(pre, opac)
    n_inst = min(total, cap)
    check(total <= cap, f"{total - cap} instances dropped at 1352x1014")
    exp_args = (offsets, tiles, rect, gattr, n_inst, gx, gy, rcfg.tile_x,
                rcfg.tile_y, rcfg.tight_rect)
    kk, kg, ka = tk.expand_instances(*exp_args)
    pk, pg, pa = tk.expand_instances_plain(*exp_args)
    torch.cuda.synchronize()
    check(torch.equal(kk, pk), "K2: sort keys (tile, depth) differ")
    check(torch.equal(kg, pg), "K2: Gaussian ids differ")
    k2_err = float((ka - pa).abs().max()) if n_inst else 0.0
    check(torch.equal(ka.view(torch.int32), pa.view(torch.int32)),
          f"K2: attributes differ (max abs {k2_err})")
    ks = binning.sort_instances(kk, kg, ka, nt)
    ps = binning.sort_instances(pk, pg, pa, nt)
    check(torch.equal(ks[2], ps[2]) and torch.equal(ks[3], ps[3]),
          "K2: tile_start/tile_count differ after the sort")
    n_valid = int(ks[3].sum())
    k2_ms = cuda_ms(lambda: tk.expand_instances(*exp_args), 20, torch)
    k2_plain_ms = cuda_ms(lambda: tk.expand_instances_plain(*exp_args), 5,
                          torch)
    n = offsets.shape[0]
    k2_bytes = n * (4 + 4 + 12 + 40) + n_inst * (8 + 4 + 40)
    k2_ops = n_inst * K2_FLOPS_PER_INSTANCE
    k2_bound = max(k2_bytes / PEAK_BYTES, k2_ops / PEAK_F32) * 1e3
    k2_by = "operations" if k2_ops / PEAK_F32 > k2_bytes / PEAK_BYTES \
        else "bytes"
    log(f"K2 expand: exact match on {n_inst} instances ({n_valid} valid, "
        f"{n} Gaussians); kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} "
        f"ms, bound {k2_bound:.4f} ms ({k2_bytes} bytes)")

    # ---- 4. K1 against its plain version ------------------------------------
    attr_s, ids_s, tstart, tcount = ks
    kf = tk.forward_tiles(attr_s, tstart, tcount, bg, W, H, rcfg.tile_x,
                          rcfg.tile_y, rcfg.chunk, need_aux=True)
    kf_noaux = tk.forward_tiles(attr_s, tstart, tcount, bg, W, H,
                                rcfg.tile_x, rcfg.tile_y, rcfg.chunk,
                                need_aux=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf = compositing.forward_tiles(attr_s, tstart, tcount, bg, W, H,
                                   rcfg.tile_x, rcfg.tile_y, need_aux=True)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    col_err = float((kf.color - pf.color).abs().max())
    t_err = float((kf.final_t - pf.final_t).abs().max())
    depth_eq = float((kf.depth == pf.depth).float().mean())
    nc_eq = float((kf.n_contrib == pf.n_contrib).float().mean())
    log(f"K1 forward vs plain, {nt} tiles: colour max abs err {col_err:.3g}, "
        f"final T {t_err:.3g}, depth equal {depth_eq:.6f}, n_contrib equal "
        f"{nc_eq:.6f}; max tile count {int(tcount.max())}")
    check(col_err <= 1e-4, f"K1: colour error {col_err} > 1e-4")
    check(t_err <= 1e-4, f"K1: final T error {t_err} > 1e-4")
    check(depth_eq >= 0.999, f"K1: median depth equal on {depth_eq}")
    check(nc_eq >= 0.999, f"K1: n_contrib equal on {nc_eq}")
    check(torch.equal(kf_noaux.color, kf.color)
          and torch.equal(kf_noaux.final_t, kf.final_t),
          "K1: need_aux=False changes the image")
    k1_ms = cuda_ms(lambda: tk.forward_tiles(
        attr_s, tstart, tcount, bg, W, H, rcfg.tile_x, rcfg.tile_y,
        rcfg.chunk, need_aux=False), 20, torch)
    pairs = int(pf.n_walked.sum())
    k1_bytes = 10 * 4 * n_valid + 8 * nt + 5 * 4 * W * H
    k1_ops = pairs * K1_FLOPS_PER_PAIR
    k1_bound = max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_F32) * 1e3
    k1_by = "operations" if k1_ops / PEAK_F32 > k1_bytes / PEAK_BYTES \
        else "bytes"
    log(f"K1 forward: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms "
        f"(one call), bound {k1_bound:.4f} ms ({pairs} instance-pixel pairs "
        f"walked, {k1_bytes} bytes)")

    # ---- 5. the slice: the eval render sweep --------------------------------
    ts_list = [0.5 + 0.49 * math.sin(i / 7) for i in range(50)]
    warm = 10
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    tk.reset_launches()
    n_inst_seen = []
    for i, ts in enumerate(ts_list):
        if i == warm:
            torch.cuda.synchronize()
            ev0.record()
        out = frame(ts, rcfg)
        check(out.num_dropped == 0, f"ts={ts}: {out.num_dropped} dropped")
        n_inst_seen.append(out.num_instances)
    ev1.record()
    torch.cuda.synchronize()
    counts = dict(tk.launches)
    frame_ms = ev0.elapsed_time(ev1) / (len(ts_list) - warm)
    check(torch.isfinite(out.color).all() and out.color.shape == (3, H, W),
          "slice: non-finite or misshapen image")
    check(all(c > 0 for c in counts.values()),
          f"slice: a kernel never launched on the main path: {counts}")
    log(f"slice: {1e3 / frame_ms:.2f} FPS ({frame_ms:.3f} ms/frame) over "
        f"{len(ts_list) - warm} frames at {W}x{H}; instances per frame "
        f"{min(n_inst_seen)}..{max(n_inst_seen)}; launches {counts}")

    # per-stage breakdown: the same frames, the same functions, an event
    # between stages
    names = ("deform", "preprocess", "expand", "sort", "composite")
    acc = {k: 0.0 for k in names}
    for i, ts in enumerate(ts_list):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        evs[0].record()
        with torch.no_grad():
            d = gm.deform(params, nets, mcfg, fstatic, ts, feat=feat)
        evs[1].record()
        active = alive * (d.state[:, 0] > render.EVAL_STATE_CUTOFF)
        pre = projection.preprocess(
            d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam, W, H,
            rcfg.tile_x, rcfg.tile_y, sh_degree=3, shs=d.shs, active=active,
            tight_rect=rcfg.tight_rect)
        evs[2].record()
        kk, kg, ka, _, _ = binning.expand(
            pre, d.opacity.reshape(-1), gx, gy, cap, rcfg.tile_x,
            rcfg.tile_y, rcfg.tight_rect)
        evs[3].record()
        attr_s, _, tstart, tcount = binning.sort_instances(kk, kg, ka, nt)
        evs[4].record()
        tk.forward_tiles(attr_s, tstart, tcount, bg, W, H, rcfg.tile_x,
                         rcfg.tile_y, rcfg.chunk, need_aux=False)
        evs[5].record()
        torch.cuda.synchronize()
        if i >= warm:
            for j, k in enumerate(names):
                acc[k] += evs[j].elapsed_time(evs[j + 1])
    stages = {k: v / (len(ts_list) - warm) for k, v in acc.items()}
    log("ms per frame by stage: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()})
        + f" (sum {sum(stages.values()):.3f})")

    # ---- 6. parity with the JAX package ---------------------------------------
    g = np.load(GOLDEN)
    gw, gh = int(g["width"]), int(g["height"])
    gcam = cameras.camera_from_c2w(cameras.ring_cameras(21)[int(g["camera"])],
                                   float(g["fovx"]), gw, gh,
                                   float(g["ts"])).raster_params(dev)
    gout = render.test_render(gcam, float(g["ts"]), params, nets, alive,
                              mcfg, fstatic, bg, width=gw, height=gh,
                              sh_degree=3, rcfg=cfg.raster_config(),
                              feat=feat)[0]
    check(cfg.raster_config().tile_x == int(g["tile"]),
          "the golden was rendered with other tiles")
    gold = g["color"].astype(np.float32)
    mine = gout.color.cpu().numpy()
    mse = float(np.mean((mine.astype(np.float64) - gold) ** 2))
    psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
    maxerr = float(np.abs(mine - gold).max())
    log(f"parity vs JAX golden {gw}x{gh}: PSNR {psnr:.2f} dB, max abs err "
        f"{maxerr:.3g} (limits >= 50 dB, < {4 / 255:.4f})")
    check(gout.num_dropped == 0, "parity render dropped instances")
    check(psnr >= 50.0 and maxerr < 4.0 / 255.0, "parity with JAX failed")

    # ---- 7. summary ---------------------------------------------------------
    kernels = [
        {"name": "expand_instances (K2)", "route": "cuda",
         "source": "saro_gs_torch/csrc/expand.cu",
         "replaces": "saro_gs_tpu/ops/tile_kernels.py:203",
         "launches": counts["expand"], "max_abs_err": k2_err,
         "check": "exact", "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "forward_tiles (K1)", "route": "cuda",
         "source": "saro_gs_torch/csrc/forward.cu",
         "replaces": "saro_gs_tpu/ops/tile_kernels.py:409",
         "launches": counts["forward"], "max_abs_err": col_err,
         "check": "colour/T <= 1e-4, depth/n_contrib >= 99.9% equal",
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
    ]
    print(json.dumps({"slice": {"fps": 1e3 / frame_ms, "ms_per_frame":
                                frame_ms, "stages_ms": stages,
                                "num_instances": [min(n_inst_seen),
                                                  max(n_inst_seen)],
                                "max_instances": cap,
                                "parity_psnr_db": psnr,
                                "parity_max_abs_err": maxerr,
                                "build_s": secs}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
