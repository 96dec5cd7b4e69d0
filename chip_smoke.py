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
  5. K3 (backward compositor) against its plain version on that staged
     table with a seeded colour cotangent: every row of [9, L] within 1e-5
     of the row's largest entry and 1e-5 in relative L2, unvisited slots
     exactly zero, two launches equal to the bit;
  6. K4 (field-gradient scatter) against its plain version on the taps of
     the checkpoint's points on a 128x128 spatial plane (both mip
     brackets) and on a time plane, and on a hot cell: within 1e-5 of the
     output's largest entry, two launches equal to the bit;
  7. the render slice: the arena checkpoint rendered by render.test_render
     at 1352x1014 from ring camera 0 over bench.py's timestamp sweep (30
     frames, 5 warm-up), timed with CUDA events; FPS, ms per stage and the
     launches of K1 and K2 in that run (both > 0, nothing dropped);
  8. parity with the JAX package: the 338x254 render against
     tests/golden/torch_arena_338x254.npz (PSNR >= 50 dB, max error
     < 4/255);
  9. the training slice: train/step.py:train_step_core on the arena
     checkpoint, dynamic stage, batch 4 at 1352x1014 (four ring cameras,
     seeded uint8 noise as ground truth, the checkpoint's loss weights and
     learning rates, the integral prune and LR scaling).  The same first
     step from two copies of the state must give equal states to the bit;
     10 checked steps (2 warm-up, 8 timed with CUDA events: steps/s, every
     kernel's launches, all four > 0), then 5 more for the ms per stage
     (3) and the card's busy share under torch.profiler (2); no bad step
     and nothing dropped on any of the 15;
 10. gradient parity with the JAX package: one training view at 338x254
     against tests/golden/torch_arena_grads_338x254.npz (loss within 1e-5,
     every group's gradients within 0.05 of its largest entry);
 11. one JSON line of results, one of the kernels, then the card line,
     then the result line {"ok": true, "device": {...}}.

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
GRADS_GOLDEN = os.path.join(HERE, "tests", "golden",
                            "torch_arena_grads_338x254.npz")
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
# K3, per instance-pixel pair it replays (one per pixel and instance up to
# the pixel's n_contrib): the alpha evaluation as in K1 (20).  A pair that
# contributes (counted in this run by the plain version) adds w (1), the
# running colour (6), 1/(1-a) (2), d_alpha (15), d_g, g*dx, g*dy (3), the
# nine values (22), and one add for each of the nine into its instance's
# sums.  The kernel's own warp butterflies (5 shuffle-adds a value and
# lane) are its overhead, not the function's work, and are not counted.
K3_FLOPS_PER_REPLAYED_PAIR = 20
K3_FLOPS_PER_CONTRIBUTING_PAIR = 49 + 9
# per tap and channel in K4: one multiply, one add
K4_FLOPS_PER_TAP_CHANNEL = 2
# K3 against its plain version, which sums an instance's pixels in another
# order: each row's worst entry over the row's largest, and the row's
# relative L2 error
K3_TOL = 1e-5
BATCH = 4


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
    from saro_gs_torch import render, scene, timing
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import densify as dens
    from saro_gs_torch.models import field as field_mod
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import (binning, compositing, grid_scatter, mip,
                                   projection)
    from saro_gs_torch.ops import tile_kernels as tk
    from saro_gs_torch.train import step as step_mod
    from tests import torch_parity as golden

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
    attr_s, ids_s, tstart, tcount, _ = ks
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

    # ---- 5. K3 against its plain version ------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_color = torch.randn(3, H, W, generator=gen).to(dev)
    k3_args = (attr_s, tstart, tcount, bg, kf.n_contrib, kf.color,
               kf.final_t, d_color, W, H, rcfg.tile_x, rcfg.tile_y)
    kb = tk.backward_tiles(*k3_args)
    kb2 = tk.backward_tiles(*k3_args)
    torch.cuda.synchronize()
    check(torch.equal(kb, kb2), "K3: two launches differ")
    t0 = time.perf_counter()
    pb, k3_contrib = compositing.backward_tiles(*k3_args, count_pairs=True)
    k3_contrib = int(k3_contrib)
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.isfinite(kb).all(), "K3: non-finite gradients")
    # each row against its largest entry, and in relative L2 so that the
    # typical entries count beside the few large ones
    k3_err, k3_rel, k3_l2 = 0.0, 0.0, 0.0
    for r in range(compositing.GRAD_ROWS):
        scale = float(pb[r].abs().max())
        err = float((kb[r] - pb[r]).abs().max())
        check(scale > 0, f"K3: plain row {r} is all zero")
        l2 = float((kb[r] - pb[r]).double().norm() / pb[r].double().norm())
        check(err <= K3_TOL * scale,
              f"K3: row {r} differs by {err} (row max {scale})")
        check(l2 <= K3_TOL, f"K3: row {r} relative L2 error {l2}")
        k3_err = max(k3_err, err)
        k3_rel = max(k3_rel, err / scale)
        k3_l2 = max(k3_l2, l2)
    unvisited = (pb == 0).all(dim=0)
    check(not bool(kb[:, unvisited].any()),
          "K3: a slot the replay never visits is not zero")
    k3_ms = cuda_ms(lambda: tk.backward_tiles(*k3_args), 10, torch)
    k3_pairs = int(kf.n_contrib.sum())
    check(0 < k3_contrib <= k3_pairs, "K3: contributing pairs miscounted")
    k3_bytes = (10 + 9) * 4 * n_valid + 8 * nt + 8 * 4 * W * H
    k3_ops = k3_pairs * K3_FLOPS_PER_REPLAYED_PAIR \
        + k3_contrib * K3_FLOPS_PER_CONTRIBUTING_PAIR
    k3_bound = max(k3_bytes / PEAK_BYTES, k3_ops / PEAK_F32) * 1e3
    k3_by = "operations" if k3_ops / PEAK_F32 > k3_bytes / PEAK_BYTES \
        else "bytes"
    log(f"K3 backward vs plain: worst row error {k3_rel:.3g} of the row's "
        f"max, {k3_l2:.3g} in relative L2 (limits {K3_TOL:g}), "
        f"{int(unvisited.sum())} all-zero slots equal, two launches "
        f"bit-equal; kernel {k3_ms:.4f} ms in batches of "
        f"{tk.BACKWARD_CHUNK} instances, plain {k3_plain_ms:.1f} ms (one "
        f"call), bound {k3_bound:.4f} ms ({k3_pairs} instance-pixel pairs "
        f"replayed, {k3_contrib} of them contributing, {k3_ops} flops, "
        f"{k3_bytes} bytes)")

    # ---- 6. K4 against its plain version ------------------------------------
    # the taps sample_mip's backward makes for the checkpoint's points: the
    # (x, y) plane with its mip pyramid (two brackets) and the (x, t) plane
    fcfg = mcfg.field
    with torch.no_grad():
        norm = (params.xyz - fstatic.aabb_min) / (fstatic.aabb_max
                                                  - fstatic.aabb_min)
        tn = gm.get_temporal_pos(params, mcfg) * fstatic.duration \
            / (fstatic.duration - 1.0)
        levels4 = field_mod.get_levels(fcfg, fstatic, gm.get_scaling(params))
    c_feat = fcfg.out_dim
    gen = torch.Generator(device="cpu").manual_seed(1)
    dfeat = torch.randn(npts, c_feat, generator=gen).to(dev)
    rx, ry, _, rt = fcfg.reso(fcfg.multires[0])
    n_lv = mip.max_mip_levels(ry, rx, field_mod.SPATIAL_MAX_MIP)
    sizes = [(ry >> l, rx >> l) for l in range(n_lv + 1)]
    offs = torch.as_tensor(np.cumsum([0] + [a * b for a, b in sizes])[:-1],
                           device=dev)
    total_sp = int(sum(a * b for a, b in sizes))
    lvl = torch.clamp(torch.minimum(levels4[:, 0], levels4[:, 1]), 0.0,
                      float(n_lv))
    l0 = torch.clamp(torch.floor(lvl).long(), 0, n_lv)
    l1 = torch.clamp(l0 + 1, 0, n_lv)
    frac = lvl - l0
    cases = []
    for name, l, factor in (("spatial l0", l0, 1.0 - frac),
                            ("spatial l1", l1, frac)):
        cells, wts = mip._tap_cells_weights(
            norm[:, 0], norm[:, 1], torch.full_like(l, rx) >> l,
            torch.full_like(l, ry) >> l, offs[l])
        cases.append((name, cells, wts, (dfeat * factor[:, None])
                      .contiguous(), total_sp))
    cells, wts = mip._tap_cells_weights(norm[:, 0], tn[:, 0], rx, rt, 0)
    cases.append(("time", cells, wts, dfeat, rx * rt))
    hot = torch.full((4, npts), 37, dtype=torch.int64, device=dev)
    cases.append(("hot cell", hot, cases[0][2], dfeat, 1024))
    k4_err, k4_rel, k4 = 0.0, 0.0, {}
    for name, cells, wts, df, total in cases:
        ko = grid_scatter.scatter_taps(cells, wts, df, total)
        ko2 = grid_scatter.scatter_taps(cells, wts, df, total)
        po = grid_scatter.scatter_taps_plain(cells, wts, df, total)
        torch.cuda.synchronize()
        check(torch.equal(ko, ko2), f"K4 {name}: two launches differ")
        scale = float(po.abs().max())
        err = float((ko - po).abs().max())
        check(scale > 0 and err <= 1e-5 * scale,
              f"K4 {name}: differs by {err} (output max {scale})")
        k4_err, k4_rel = max(k4_err, err), max(k4_rel, err / scale)
        if name == "hot cell":
            continue
        ms = cuda_ms(lambda: grid_scatter.scatter_taps(cells, wts, df,
                                                       total), 20, torch)
        sort_ms = cuda_ms(lambda: grid_scatter.sort_taps(cells, wts, total),
                          20, torch)
        plain_ms = cuda_ms(lambda: grid_scatter.scatter_taps_plain(
            cells, wts, df, total), 10, torch)

        def library():
            out = torch.zeros((total, c_feat), device=dev)
            out.index_add_(0, cells.reshape(-1),
                           (wts[:, :, None] * df[None]).reshape(-1, c_feat))
            return out
        lib_ms = cuda_ms(library, 10, torch)
        n_taps = cells.shape[0]
        nbytes = n_taps * npts * 8 + npts * c_feat * 4 + c_feat * total * 4
        ops = n_taps * npts * c_feat * K4_FLOPS_PER_TAP_CHANNEL
        k4[name] = dict(ms=ms, sort_ms=sort_ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bytes=nbytes,
                        bound_ms=max(nbytes / PEAK_BYTES,
                                     ops / PEAK_F32) * 1e3,
                        bound_by="operations" if ops / PEAK_F32
                        > nbytes / PEAK_BYTES else "bytes")
        log(f"K4 scatter, {name} ({n_taps}x{npts} taps -> {c_feat}x{total})"
            f": error {err / scale:.3g} of the output's max (limit 1e-5), "
            f"bit-equal; wrapper {ms:.4f} ms (its sort and segment search "
            f"{sort_ms:.4f} ms), plain {plain_ms:.4f} ms, one index_add_ "
            f"{lib_ms:.4f} ms, bound {k4[name]['bound_ms']:.5f} ms "
            f"({nbytes} bytes)")

    # ---- 7. the render slice: the eval render sweep -------------------------
    ts_list = [0.5 + 0.49 * math.sin(i / 7) for i in range(30)]
    warm = 5
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
    check(counts["expand"] > 0 and counts["forward"] > 0,
          f"slice: a kernel never launched on the render path: {counts}")
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
        sa, _, sstart, scount, _ = binning.sort_instances(kk, kg, ka, nt)
        evs[4].record()
        tk.forward_tiles(sa, sstart, scount, bg, W, H, rcfg.tile_x,
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

    # ---- 8. parity with the JAX package -----------------------------------
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

    # ---- 9. the training slice ----------------------------------------------
    with torch.no_grad():
        integral = gm.temporal_integral(params, nets, mcfg, fstatic)
    alive_t, inv_integral = dens.integral_prune_and_lr(
        alive, integral, cfg.min_intergral, cfg.inv_lr_clip)
    ring = cameras.ring_cameras(BATCH)
    centres = np.stack([c2w[:3, 3] for c2w in ring])
    # the scene extent as the trainer takes it from its cameras: 1.1 times
    # the largest distance of a camera from the cameras' centre
    extent = 1.1 * float(np.linalg.norm(centres - centres.mean(0),
                                        axis=1).max())
    tcams = [cameras.camera_from_c2w(c2w, 0.85, W, H, 0.0).raster_params(dev)
             for c2w in ring]
    cams = projection.CameraParams(*[torch.stack(x) for x in zip(*tcams)])
    gt = torch.as_tensor(golden.noise_gt(BATCH, H, W), device=dev)
    ts_train = torch.linspace(0.1, 0.9, BATCH, device=dev).reshape(-1, 1, 1)
    train_rcfg = cfg.raster_config()
    need = 0
    with torch.no_grad():
        for i in range(BATCH):
            pkg = render.train_render(
                tcams[i], ts_train[i], params, nets, alive_t, mcfg, fstatic,
                bg, width=W, height=H, stage="dynamatic", sh_degree=3,
                rcfg=train_rcfg._replace(max_instances=1 << 22), feat=feat)
            need = max(need, pkg.out.num_instances + pkg.out.num_dropped)
    train_cap = max(-(-int(need * 1.15) // 65536) * 65536, 65536)
    train_rcfg = train_rcfg._replace(max_instances=train_cap)
    st = step_mod.StepStatics(
        mcfg=mcfg, rcfg=train_rcfg, weights=cfg.loss_weights(), width=W,
        height=H, cfg_lrs=step_mod.make_lr_statics(cfg), extent=extent,
        scale_floor=cfg.scale_floor)
    state0 = step_mod.init_state(params, nets, alive_t)._replace(
        inv_integral=inv_integral)
    log(f"train: {int(alive_t.sum())} of {npts} Gaussians alive after the "
        f"integral prune, LR scaling up to {float(inv_integral.max()):.2f}, "
        f"extent {extent:.3f}, weights {tuple(cfg.loss_weights())}, "
        f"max_instances {train_cap} ({need} needed)")

    def one_step(state):
        return step_mod.train_step_core(
            state, cams, gt, ts_train, bg, fstatic, st, stage="dynamatic",
            sh_degree=3, scale_integral=True)

    def leaves_of(state):
        return (step_mod.param_leaves(state.points, state.nets)
                + state.opt.mu + state.opt.nu + list(state.aux))

    # the same step from two copies of the state: equal to the bit
    sa, ma = one_step(step_mod.clone_state(state0))
    sb, mb = one_step(step_mod.clone_state(state0))
    torch.cuda.synchronize()
    check(ma == mb, f"train: two identical steps report differently: "
          f"{ma} vs {mb}")
    for k, (x, y) in enumerate(zip(leaves_of(sa), leaves_of(sb))):
        check(torch.equal(x, y), f"train: leaf {k} differs between two "
              "identical steps")
    log("train: two identical steps from one state are equal to the bit "
        f"({len(leaves_of(sa))} tensors); loss {ma['loss']:.6f}")
    # sa is one step ahead; one more warm-up, then the timed steps
    state, m = one_step(sa)
    all_metrics = [ma, m]
    n_timed = 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    ev0.record()
    for _ in range(n_timed):
        state, m = one_step(state)
        all_metrics.append(m)
    ev1.record()
    torch.cuda.synchronize()
    train_counts = dict(tk.launches)
    step_ms = ev0.elapsed_time(ev1) / n_timed
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(all_metrics):
        check(math.isfinite(m["loss"]), f"train: step {i} loss {m['loss']}")
        check(m["bad_step"] == 0, f"train: step {i} was skipped, bad_src "
              f"{step_mod.bad_src_names(m['bad_src'])}")
        check(m["dropped"] == 0, f"train: step {i} dropped {m['dropped']}")
    check(state.step == 2 + n_timed, "train: the step counter is off")
    with torch.no_grad():
        moved = float((state.points.xyz - params.xyz).abs().max())
        plane_moved = float((state.nets.field.planes[0]
                             - nets.field.planes[0]).abs().max())
    check(moved > 0 and plane_moved > 0, "train: parameters did not move")
    check(all(torch.isfinite(x).all() for x in leaves_of(state)),
          "train: a non-finite value in the state")
    check(all(train_counts[k] > 0 for k in
              ("expand", "forward", "backward", "grid_scatter")),
          f"train: a kernel never launched in the timed steps: "
          f"{train_counts}")
    log(f"train: {1e3 / step_ms:.3f} steps/s ({step_ms:.2f} ms/step) over "
        f"{n_timed} steps, batch {BATCH} at {W}x{H}; loss "
        f"{all_metrics[0]['loss']:.5f} -> {all_metrics[-1]['loss']:.5f} "
        f"over the {len(all_metrics)} steps so far, "
        f"psnr {all_metrics[-1]['psnr']:.3f}; launches {train_counts}; "
        f"peak memory {peak_gb:.2f} GiB; xyz moved by up to {moved:.3g}")
    # per-stage breakdown: three more steps with an event at every stage
    n_prof = 3
    with timing.record() as rec:
        for _ in range(n_prof):
            state, m = one_step(state)
            all_metrics.append(m)
    train_stages = {k: v / n_prof for k, v in rec.stages().items()}
    log("train ms per step by stage: " + json.dumps(
        {k: round(v, 3) for k, v in train_stages.items()})
        + f" (sum {sum(train_stages.values()):.2f})")

    # the card's busy share: two more steps under torch.profiler (its own
    # cost shows in the wall time against the timed steps' above)
    from torch.profiler import ProfilerActivity, profile
    n_trace = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_trace):
            state, m = one_step(state)
            all_metrics.append(m)
        torch.cuda.synchronize()
        trace_ms = (time.perf_counter() - t0) * 1e3 / n_trace
    for i, m in enumerate(all_metrics[2 + n_timed:], 2 + n_timed):
        check(math.isfinite(m["loss"]) and m["bad_step"] == 0
              and m["dropped"] == 0, f"train: step {i} (stage breakdown or "
              f"trace) went wrong: {m}")
    check(state.step == len(all_metrics) == 2 + n_timed + n_prof + n_trace
          and state.bad_steps == 0 and state.dropped_hwm == 0,
          "train: counters are off after the last step")
    # device-side events only: an operator's entry repeats its kernels'
    # time
    by_kernel = sorted(((e.self_device_time_total / 1e3 / n_trace, e.key)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(ms for ms, _ in by_kernel)
    if busy_ms > 0:
        log(f"train trace: card busy {busy_ms:.2f} ms of a {trace_ms:.2f} ms "
            f"step under the profiler ({100 * busy_ms / trace_ms:.1f}%; "
            f"{100 * busy_ms / step_ms:.1f}% of the untraced {step_ms:.2f} "
            "ms step); top kernels (ms/step): " + "; ".join(
                f"{ms:.3f} {key[:60]}" for ms, key in by_kernel[:8]))
    else:
        log("train trace: the profiler reported no device time; busy share "
            "not measured")

    # ---- 10. gradient parity with the JAX package -------------------------
    report = golden.check_gradients(GRADS_GOLDEN, cfg, params, nets, alive,
                                    fstatic, dev)
    log("gradient parity vs JAX golden: loss rel err "
        f"{report['loss_rel_err']:.3g} (limit 1e-5), worst group error "
        f"{report['worst_rel_err']:.3g} of its max, worst norm error "
        f"{report['worst_norm_rel_err']:.3g} (limits 0.05); "
        + json.dumps({k: round(v['rel_err'], 6)
                      for k, v in report["groups"].items()}))
    check(report["dropped"] == 0, "gradient parity view dropped instances")
    check(report["loss_rel_err"] <= 1e-5, "gradient parity: loss differs")
    check(report["worst_rel_err"] <= 0.05
          and report["worst_norm_rel_err"] <= 0.05,
          "gradient parity with JAX failed")

    # ---- 11. summary --------------------------------------------------------
    k4m = k4["spatial l0"]
    kernels = [
        {"name": "expand_instances (K2)", "route": "cuda",
         "source": "saro_gs_torch/csrc/expand.cu",
         "replaces": "saro_gs_tpu/ops/tile_kernels.py:203",
         "launches": train_counts["expand"],
         "launches_render": counts["expand"], "max_abs_err": k2_err,
         "check": "exact", "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "forward_tiles (K1)", "route": "cuda",
         "source": "saro_gs_torch/csrc/forward.cu",
         "replaces": "saro_gs_tpu/ops/tile_kernels.py:409",
         "launches": train_counts["forward"],
         "launches_render": counts["forward"], "max_abs_err": col_err,
         "check": "colour/T <= 1e-4, depth/n_contrib >= 99.9% equal",
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "backward_tiles (K3)", "route": "cuda",
         "source": "saro_gs_torch/csrc/backward.cu",
         "replaces": "saro_gs_tpu/ops/tile_kernels.py:726",
         "launches": train_counts["backward"], "max_abs_err": k3_err,
         "check": f"each row <= {K3_TOL:g} of its max and in relative L2, "
                  "unvisited slots zero, two launches bit-equal",
         "rel_l2_err": k3_l2, "batch": tk.BACKWARD_CHUNK,
         "pairs_replayed": k3_pairs, "pairs_contributing": k3_contrib,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None},
        {"name": "scatter_taps (K4)", "route": "cuda",
         "source": "saro_gs_torch/csrc/grid_scatter.cu",
         "replaces": "saro_gs_tpu/ops/grid_scatter.py:50",
         "launches": train_counts["grid_scatter"], "max_abs_err": k4_err,
         "check": "<= 1e-5 of the output's max, two launches bit-equal",
         "ms": k4m["ms"], "plain_ms": k4m["plain_ms"],
         "bound_ms": k4m["bound_ms"], "bound_by": k4m["bound_by"],
         "library_ms": k4m["library_ms"]},
    ]
    print(json.dumps({"slice": {"fps": 1e3 / frame_ms, "ms_per_frame":
                                frame_ms, "stages_ms": stages,
                                "num_instances": [min(n_inst_seen),
                                                  max(n_inst_seen)],
                                "max_instances": cap,
                                "parity_psnr_db": psnr,
                                "parity_max_abs_err": maxerr,
                                "build_s": secs},
                      "train": {"steps_per_s": 1e3 / step_ms,
                                "ms_per_step": step_ms,
                                "stages_ms": train_stages,
                                "batch": BATCH, "alive": int(alive_t.sum()),
                                "max_instances": train_cap,
                                "peak_memory_gib": peak_gb,
                                "steps": len(all_metrics),
                                "loss_first": all_metrics[0]["loss"],
                                "loss_last": all_metrics[-1]["loss"],
                                "bit_equal": True,
                                "card_busy_ms_per_step": busy_ms or None,
                                "traced_ms_per_step": trace_ms,
                                "grad_parity": report},
                      "k4_shapes": k4}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
