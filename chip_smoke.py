#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (saro_gs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

  1. device: require CUDA; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ with nvcc, and the native host
     library's core (COLMAP parsing, knn) with g++ on this host;
  3. K2 (instance expander) against its plain version on the arena
     checkpoint's preprocessed Gaussians at 1352x1014, ts = 0.5: the
     instance tables and the sorted tile ranges must be equal exactly.
     K1's and K2's ms are the device time of every kernel one wrapper
     call launches (K1's tile-order sort and zero fill included), by
     torch.profiler (a wrapper call's host time exceeds K2's kernels),
     beside the wrapper's ms a call by CUDA events;
  4. K1 (forward compositor) against its plain version on that staged
     table, every tile: colour, median depth, final T and n_contrib equal
     to the bit, need_aux=False the same image; the share of (8x4 patch,
     instance) pairs its warp cull drops, by the cull's plain restatement;
  5. K3 (backward compositor) against its plain version on that staged
     table with a seeded colour cotangent: every row of [9, L] within 1e-5
     of the row's largest entry and 1e-5 in relative L2, unvisited slots
     exactly zero, two launches equal to the bit;
  6. K4 (field-gradient scatter, scatter_mip_taps) against its plain
     version on the grid gradients of the checkpoint's points on its three
     128x128 spatial planes (both mip brackets in one call), on one time
     plane (strided dfeat rows) and on a hot cell (every point on the
     coarsest texel): within 1e-5 of the output's largest entry, two
     launches equal to the bit; ms per call beside one index_add_ over the
     same taps;
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
     kernel's launches, all four > 0, K4 once per plane), then 5 more for
     the ms per stage (3) and the card's busy share under torch.profiler
     (2); no bad step and nothing dropped on any of the 15;
 10. gradient parity with the JAX package: one training view at 338x254
     against tests/golden/torch_arena_grads_338x254.npz (loss within 1e-5,
     every group's gradients within 0.05 of its largest entry);
 11. the trainer: configs/synth/arena.json at full width (planes
     128^3 x 50, 32 channels, batch 2, its losses), its schedule cut to 150
     iterations (static until 50, densify at 80 and 120, opacity reset at
     120, integral refreshes at 100 and 150, test at 150, capacity 1 so the
     first densify grows it), trained from a point cloud through
     cli.train_main.  The scene is built in memory and reaches the trainer
     through the port's Scene and reader registry: 21 ring cameras at
     1352x1014 (camera 0 the test view), ground truth rendered from the
     arena checkpoint, and 65,000 points of the checkpoint's positions at
     random frames plus N(0, 0.01) noise, coloured by its DC term plus
     noise.  Checked: no bad step, nothing dropped, the last loss logged
     before the opacity reset below 0.7 of the first and the last one
     below the first, each densify's count adding up, the saved
     checkpoint reloading through Scene to the same render to the bit, a
     finite eval PSNR, and cli.test_main's metrics (where PIL imports)
     equal to that render's.  Measured: iterations/s over the dynamic
     stage (loop, loader and control included) beside train_step_core
     alone, ms per densify pass and capacity growth, the card's busy share
     over 5 iterations, the kernels' launches over 8;
 12. the arena trainer from disk: phase 11's cameras, ground truth (as
     8-bit PNGs) and init cloud written as a Blender/D-NeRF dataset under
     build/chip_smoke_disk/, then trained with phase 11's schedule by
     cli.train_main (--quiet) through the blender reader and the image
     decoder, no reader of its own.  The native core library (built in
     phase 2) must load, give nn distances within rtol 1e-5, atol 1e-6 of
     ops/knn.py on the card, and read a COLMAP model as the Python readers
     do.  Where png.h and jpeglib.h are found, the image library must
     build and decode the PNGs within 1e-6 of PIL; without them its build
     must raise (a line says so) and the decode takes PIL, while the
     COLMAP readers and the knn stay native.  Checked: no bad step,
     nothing dropped, the last loss logged before the opacity reset below
     0.7 of the first, every kernel launched in the run, LPIPS-alex (the
     seed-0 fixture) at 1352x1014 on the card within 1e-4 relative of the
     CPU's on two views, and cli.test_main's report carrying a finite
     LPIPS-alex from the fixture, its PSNR and SSIM within 1e-6 and its
     LPIPS within 1e-5 of the reloaded checkpoint's.  Measured: the scene
     build, the loader's decode per batch (native and PIL), it/s over the
     dynamic stage beside phase 11's, the largest relative difference
     from phase 11's logged losses (the PNGs quantise the ground truth),
     LPIPS ms a view;
 13. the parallel path, as ranks sharing the one card under gloo
     (saro_gs_torch/parallel/): (a) K2, K1 and K3 on the arena frame's
     strip of 16 tile rows from row 16 (ts 0.5, the partial bottom row
     included) against their plain versions, K2 and K1 to the bit, K3
     within its 1e-5 gates; (b) 2 and 4 strips by rasterize equal to the
     full frame to the bit, their gradients summed within 1e-5 of each
     group's largest entry of the frame's; (c) phase 9's step on the
     2x1 and 1x2 meshes (2 ranks) and the 2x2 mesh (4 ranks), 4 steps
     each: every rank's state equal to the bit, losses within 1e-5 of the
     single process's, step 1's reduced gradient (Adam's first moment)
     within 1e-5 of its largest entry and the parameters within 2e-5
     where it is significant, step 4's parameters within twice the single
     process's own spread under another order of its views; steps/s and
     launches by mesh; (d) tile_sharded_render of the arena frame over 2
     ranks equal to the single render to the bit; (e) phase 11's trainer
     on 2 data ranks through cli.train_main --quiet: the loss at
     iteration 1 within 1e-5 and at 50 and 100 within 1e-3 of phase 11's,
     no bad step, nothing dropped, the ranks' states equal to the bit,
     the checkpoint written by rank 0 alone, its render at PSNR >= 50 dB
     against phase 11's, it/s beside phase 11's.  A failed rank fails the
     phase;
 14. the Neural3D-scale trainer: configs/synth/stress_szcap.json at its
     widths (planes 512^3 x 256, 32 channels, batch 4 at 1352x1014,
     duration 300, capacity 262,144, max_instances 1,048,576 presized by
     3.0, max_screen_size 150, dynamic from iteration 1), only its
     schedule cut: 210 iterations, densify from 50 every 50 until 200
     (passes at 100 and 150), opacity reset at 120, test and save at 210
     (the SH steps and the late passes are phase 16's).  The scene is
     saro_gs_torch/data/synth.py's, built in memory and registered as
     chip_smoke_stress: build_gt(7) rendered on the card by
     ring_cameras(21) (fovx 0.85), the 20 training cameras at frames
     0, 20, ..., 280 of 300 (uint8), camera 0 at frames 0, 140 and 280
     the test views, 100,000 points of init_cloud(gt, 300, 100000, 7).
     Checked: (a) K4 on the first step's own grid gradients of the xy
     plane (512x512, 8 levels, 349,520 cells) and the xt plane (32 x 256 x
     512, 131,072 cells), both sorted in 3 radix passes, within 1e-5 of
     the output's largest entry and two launches equal to the bit, ms
     beside one index_add_ and the byte bound; (b) K2 and K1 equal to the
     bit and K3 within its gates on the trained state's test frame;
     (c) two identical first steps equal to the bit; (d) the run through
     cli.train_main: no bad step, nothing dropped on a checked step or at
     eval, the overflow doublings accounting for the final capacity, the
     last loss logged before the opacity reset below 0.7 of the first,
     each densify's counts adding up, SH degree 0 at the end, the test
     PSNR above the initial state's, the checkpoint reloading to the same
     render to the bit.  Measured: it/s from iteration 50 to 200,
     train_step_core alone over 8 steps, ms per densify pass, ms per stage
     over 3 steps, the card's busy share over 5 iterations, peak memory,
     the kernels' launches over the run, the phase's seconds (limit 600);
 15. the Neural3D training mode, in a process of its own started before
     phase 11 and run beside phases 11 to 14 and 16 (its results are
     joined after phase 14; a failure there fails the run, and a failed
     run stops it): configs/neural_3D/flame_steak.json
     through cli.train_main and cli.test_main, only its schedule cut
     (duration 30 of 300, 510 of 30,000 iterations, densify from 100 until
     500, so passes at 200, 300 and 400, the opacity reset at 300, test
     and save at 510, the base-time z prune at 501); resolution 2, planes
     512^3 x 256, batch 4 at 1352x1014, preprocesspoints 31, densify 2,
     the colmap reader, a black background, capacity 262,144 as the file
     and the defaults have them.  The scene is tests/torch_n3d_scene.py's,
     written under build/chip_smoke_n3d/ (reused when complete): build_gt(7)
     moved in front of a 19-camera forward-facing rig (camera 00 the test
     camera), 30 frames rendered by the port at 2704x2028 on black as
     8-bit PNGs, poses_bounds.npy, colmap_0/sparse/0/{cameras,images}.bin
     by llff_poses_to_colmap, per-frame points3D.bin (233,055 points in
     frame 0 with 100 near floaters and 200 far ones, 40,000 in each later
     frame: 121 slots free after the z prune, so the first densify pass
     overflows); the COLMAP files parse through the native core library
     (its 30 points3D.bin files are also timed through the Python loop,
     side by side), and without png.h and jpeglib.h the images decode
     through PIL.  Checked: (a) 540 train, 30 test and 300 val
     cameras, the centres those of poses_bounds.npy within 1e-5, the
     merged cloud and the counts after the preprocess and the CLI's z
     prune equal to a numpy and scipy recount from the written clouds;
     (b) two identical first steps equal to the bit; (c) no bad step,
     densify at 200, 300 and 400 with counts adding up, a capacity growth
     262,144 -> 524,288 after which every per-Gaussian tensor and both
     Adam moments have the grown rows, the z prune once, at 501, equal to
     a recount of deform(..., 0.0).real_xyz[:, 2] < 4.5 on the state before
     it, the overflow doublings accounting for max_instances, nothing
     dropped at eval, the test PSNR at 510 above the initial state's;
     (d) K2 and K1 equal to the bit and K3 within its gates on the trained
     test frame on black, two identical steps of the grown state equal to
     the bit and K4 on that step's xy and xt plane gradients; (e) the
     checkpoint reloading to the same render to the bit, cli.test_main's
     PSNR, SSIM and MS-SSIM within 1e-6 of the trainer's eval of the same
     state at SH degree 3, 300 val renders written.  Measured: the
     scene's write and build seconds (reader, preprocess), the native and
     the Python parse of the 30 points3D.bin files, the loader's decode ms
     a batch, it/s over iterations 50 to 500, train_step_core alone on the
     grown state, ms per densify pass and growth, peak memory, the busy
     share over 5 iterations, test_main's seconds (the phase's limit
     600 s);
 16. the D-NeRF training mode, in a process of its own started with
     phase 15's and run beside phases 11 to 15 (the phase's own limit
     1,100 s): configs/dnerf/standup.json through
     cli.train_main and cli.test_main, only its schedule cut (2,110 of
     20,000 iterations, test and save at 2,110): the blender reader at
     resolution 2 (400x400 from 800x800 RGBA composited over white), batch
     4, planes 64^3 x 128 of 32 channels, static until 1,000, densify 5
     from 500 every 100 (16 passes, 600 to 2,100), the opacity reset at
     2,000, the SH degree stepping at 1,000 and 2,000, capacity 262,144,
     max_instances presized, as the file and the defaults have them.  The
     scene is tests/torch_dnerf_scene.py's, written under
     build/chip_smoke_dnerf/ (reused when complete): build_gt(7) without
     its floor, 150 training and 20 test frames, one hemisphere pose each
     at radius 4, rendered by the port at 800x800 as RGBA PNGs (alpha 1 -
     T); no points3d.ply, so the reader draws its 100,000-point random
     init; without png.h and jpeglib.h the images decode through PIL.
     Checked: (a) the init cloud equal to a numpy
     recount of RandomState(666); two identical first steps equal to the
     bit, static and dynamic, and K4 on the dynamic one's xy (64x64, 6
     levels, 5,461 cells) and xt (64x128) plane gradients, 2 radix passes,
     within 1e-5 of the output's largest entry; no bad step; the 16 passes'
     counts adding up, the one at 2,100 alone with the size threshold; the
     reset at 2,000 after the SH step to 2; SH degree 2 at the end; the
     integral refresh at every 50th dynamic iteration; the overflow
     doublings accounting for max_instances; nothing dropped at eval; the
     test PSNR at 2,110 above the initial state's; the checkpoint
     reloading to the same render to the bit; cli.test_main's PSNR, SSIM
     and MS-SSIM within 1e-6 of the trainer's eval of the same state; K2
     and K1 equal to the bit and K3 within its gates on the trained test
     frame over white.  (b) The same scene and config with no presize and
     max_instances 65,536 for 100 iterations: the overflow check doubles
     it (Trainer.overflows non-empty, every high-water mark > 0), the final
     max_instances 65,536 x 2^(doublings), the checks after the last
     doubling reading nothing dropped, the last state rendering every
     training view at the final max_instances without a drop, no bad step.
     (c) Run (a) resumed through cli.train_main --start_checkpoint (its
     checkpoint at 2,110) --start_iteration 2110 on the same model path,
     to 2,310 (test and save there): the loaded state at step 2,110 in
     max(capacity, next power of two) rows rendering the check view equal
     to the bit to run (a)'s state, two identical first resumed steps
     equal to the bit, best_psnr seeded from 2110_runtimeresults.json, no
     bad step, the passes at 2,200 and 2,300 adding up, the SH degree 0
     through 2,310 (it restarts at 0, as in the JAX package), no reported
     eval view dropping, iteration_best replaced only by a better eval,
     every kernel launched.  Measured: the scene's write and build
     seconds, the loader's decode ms a batch, it/s over the static (50 to
     1,000) and the dynamic (1,050 to 2,100) stage, train_step_core alone
     over 8 steps, ms per densify pass, peak memory, the busy share over 5
     iterations, run (b)'s doublings, test_main's seconds, run (c)'s
     checkpoint load seconds and it/s;
 17. the eval's capacity, after phase 14: Evaluator.render_set on the
     arena checkpoint at 1352x1014 over phase 11's test view (ring camera
     0), led by ring camera 0 turned by EVAL_TURN_DEG about the world's z
     axis, which sees few Gaussians (8-bit ground truth: each view's
     render).  The probe sizes the capacity from the turned view, so the
     test view drops instances and is rendered again.  Checked: at least
     one view rendered again; no reported view with instances dropped;
     each re-rendered view's image, depth and final T equal to the bit to
     the view rendered alone at the final capacity, and its reported
     PSNR that render's; K2 and K1 launched by every render.  Measured:
     render_set's seconds, the view alone's ms, the truncated render's
     PSNR beside the reported one;
 18. the bench, after phase 10 and before phases 15 and 16 start, so
     that its parts have the card alone: saro_gs_torch/bench.py, the
     port of bench.py, on its synthetic scene (bench_scene: 200,000
     Gaussians of synthetic_state(seed=3), scales log U(0.003, 0.02);
     field 32^3 x 16 of 16 channels).  (a) and (b) run in a process of
     their own (phase "bench_kernels"), where no profiler has run before,
     so that K1's and K2's ms are device time by the profiler: (a) K2 and
     K1 equal to the bit and K3 within its gates (frame_kernels) on the
     scene's frame at 1352x1014, ts 0.5, from bench_camera on black, the
     capacity from the bench's probe; (b) one bench train step (batch 4
     at 1352x1014, nothing dropped, no bad step) and K4 on that step's own
     gradients of the three 32x32 spatial planes and the xt time plane
     (k4_check);
     (c) python -m saro_gs_torch.bench in a process of its own, nothing
     else running on the card: rc 0, the four records of bench.py's
     names in its order with the headline render_fps_1352x1014 last,
     every value > 0, vs_baseline null, "card" naming this card, nothing
     dropped, K2 and K1 launched in both renders and all four kernels in
     the train bench.  Frame counts are the bench's own (50 frames, 10
     warm-up, 4 passes; 1 + 20 steps);
 19. the HyperNeRF training mode, in a process of its own started once
     phase 15 has ended and run beside phase 16 (the phase's own limit
     600 s):
     configs/dnerf/standup.json's model and training settings (planes
     64^3 x 128 of 32 channels, batch 4, densify 5, capacity 262,144,
     max_instances presized) with HYPERNERF_SCHEDULE: the hypernerf
     reader at resolution 2 on black, duration 100, 610 of 20,000
     iterations, static until 300, densify from 200 every 100 (passes at
     300 to 600), test and save at 610; through cli.train_main and
     cli.test_main.  The scene is tests/torch_hypernerf_scene.py's vrig
     layout, written under build/chip_smoke_hypernerf/ (reused when
     complete): 100 time steps x 2 rig cameras (left for training, right
     for validation, 0.1 apart) of build_gt(7) with its floor, rendered by
     the port as portrait 536x960 PNGs (rgb/2x of 1072x1920, focal length
     1,500 px at 1x), and a points.npy of 20,000 points.  Checked: (a) 100
     train and 100 test cameras whose FoVs, centres, sizes and timestamps
     (time_id / 99, equal for both rig cameras of a step) agree with a
     numpy recount from the JSON files, the init cloud points.npy's at t
     0.5, grey; (b) two identical first steps equal to the bit, static and
     dynamic, and K4 on the dynamic one's xy and xt plane gradients
     (2 radix passes); (c) no bad step, the densify passes' counts adding
     up, the overflow doublings accounting for max_instances, nothing
     dropped at eval, the test PSNR at 610 above the initial state's;
     (d) K2 and K1 equal to the bit and K3 within its gates on the trained
     test frame at 536x960 on black; (e) the checkpoint reloading to the
     same render to the bit, cli.test_main's PSNR, SSIM and MS-SSIM within
     1e-6 of the trainer's eval of the same state.  Measured: the layout's
     write and the scene's build seconds, the loader's decode ms a batch,
     it/s over the static (50 to 300) and the dynamic (350 to 600) stage,
     train_step_core alone over 8 steps, peak memory, the busy share over
     5 iterations, test_main's seconds, K1 to K4's ms and launches;
 20. one JSON line of results, one of each trainer phase, one of the
     parallel path, one of the stress phase ({"phase": "stress", ...}),
     one of the Neural3D phase ({"phase": "neural3d", ...}), one of the
     D-NeRF phase ({"phase": "dnerf", ...}, run c under "resume"), one of
     the HyperNeRF phase ({"phase": "hypernerf", ...}), one of the eval's
     capacity ({"eval_capacity": ...}), one of the bench ({"bench":
     ...}), one of the kernels, then the card line, then the result line
     {"ok": true, "device": {...}}.

Imports nothing of JAX.  Times are the card's own: read them beside the
card's name and power limit printed with them.
"""
import dataclasses
import importlib.util
import json
import math
import os
import shutil
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
ARENA_CONFIG = os.path.join(HERE, "configs", "synth", "arena.json")
# the trainer phase's scene: cameras, frames, init points, and where its
# config and model go (build/ is git-ignored)
N_CAMS, DURATION, N_INIT = 21, 50, 65_000
TRAIN_DIR = os.path.join(HERE, "build", "chip_smoke")
# phase 12's dataset, config and model (git-ignored)
DISK_DIR = os.path.join(HERE, "build", "chip_smoke_disk")
LOADER = "chip_smoke_arena"
SCHEDULE = dict(iterations=150, static_iteration=50, densify_from_iter=60,
                densification_interval=40, densify_until_iter=140,
                opacity_reset_interval=120, test_iteration=150, capacity=1)
# phase 13: steps a mesh runs, the gated point fields, its config and
# model (git-ignored), and a rank group's time limit
PARALLEL_STEPS = 4
PARALLEL_FIELDS = ("xyz", "scaling", "opacity", "temporal_pos")
# the single-process reference's second order of the views
ALT_ORDER = [0, 2, 1, 3]
MESH_DIR = os.path.join(HERE, "build", "chip_smoke_mesh")
PARALLEL_TIMEOUT_S = 420.0
# phase 14: configs/synth/stress_szcap.json at its widths on the port's
# synthetic scene (saro_gs_torch/data/synth.py), only its schedule cut;
# its config and model (git-ignored), and the phase's own time limit
STRESS_CONFIG = os.path.join(HERE, "configs", "synth", "stress_szcap.json")
STRESS_DIR = os.path.join(HERE, "build", "chip_smoke_stress")
STRESS_LOADER = "chip_smoke_stress"
STRESS_CAMS, STRESS_INIT, STRESS_SEED = 21, 100_000, 7
STRESS_TRAIN_FRAMES = tuple(range(0, 300, 20))
STRESS_TEST_FRAMES = (0, 140, 280)
STRESS_SCHEDULE = dict(iterations=210, densify_from_iter=50,
                       densification_interval=50, densify_until_iter=200,
                       opacity_reset_interval=120, test_iteration=210,
                       testing_iterations=[210], save_iterations=[210])
STRESS_LIMIT_S = 600
# phase 15: the Neural3D training mode, configs/neural_3D/flame_steak.json
# through the CLI on a scene in the Neural3D layout
# (tests/torch_n3d_scene.py), only its schedule cut; the scene, config and
# model (git-ignored), and the phase's own time limit
N3D_CONFIG = os.path.join(HERE, "configs", "neural_3D", "flame_steak.json")
N3D_DIR = os.path.join(HERE, "build", "chip_smoke_n3d")
N3D_SCHEDULE = dict(duration=30, iterations=510, densify_from_iter=100,
                    densify_until_iter=500, opacity_reset_interval=300,
                    testing_iterations=[510], save_iterations=[510])
N3D_LIMIT_S = 600
# phase 16: the D-NeRF training mode, configs/dnerf/standup.json through
# the CLI on a scene in the D-NeRF layout (tests/torch_dnerf_scene.py),
# only its schedule cut (run a); then the same with max_instances left
# small so that the overflow check doubles it (run b); the scene, configs
# and models (git-ignored), and the phase's own time limit
DNERF_CONFIG = os.path.join(HERE, "configs", "dnerf", "standup.json")
DNERF_DIR = os.path.join(HERE, "build", "chip_smoke_dnerf")
DNERF_SCHEDULE = dict(iterations=2110, testing_iterations=[2110],
                      save_iterations=[2110])
DNERF_DOUBLING = dict(iterations=100, presize_instances=False,
                      max_instances=65536)
# run (c): run (a) resumed from its checkpoint at 2,110 on the same model
# path, through the passes at 2,200 and 2,300
DNERF_RESUME = dict(iterations=2310, testing_iterations=[2310],
                    save_iterations=[2310])
DNERF_LIMIT_S = 1100
# phase 17: the eval's capacity, on the arena checkpoint; ring camera 0
# turned about the world's z axis by this many degrees sees few Gaussians
EVAL_DIR = os.path.join(HERE, "build", "chip_smoke_eval")
EVAL_TURN_DEG = 40.0
# phase 19: the HyperNeRF training mode, standup.json's model and
# training settings with the hypernerf reader on a vrig layout
# (tests/torch_hypernerf_scene.py), its schedule cut; the scene, config
# and model (git-ignored), and the phase's own time limit
HYPERNERF_CONFIG = DNERF_CONFIG
HYPERNERF_DIR = os.path.join(HERE, "build", "chip_smoke_hypernerf")
HYPERNERF_SCHEDULE = dict(
    loader="hypernerf", resolution=2, white_background=False, duration=100,
    iterations=610, static_iteration=300, densify_from_iter=200,
    densification_interval=100, testing_iterations=[610],
    save_iterations=[610])
HYPERNERF_LIMIT_S = 600
# phase 18: the bench's scene, and the time limit of its process (c)
BENCH_POINTS = 200_000
BENCH_NAMES = ["render_fps_1352x1014", "render_fps_ckpt_1352x1014",
               "train_steps_per_s_b4_1352x1014", "render_fps_1352x1014"]
BENCH_LIMIT_S = 400


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# the processes this script starts (phases 15 and 16 beside phases 11 to
# 14, then 19 beside 16; phase 18's kernels)
CHILDREN = []


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    stop_children()
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


def call_ms(fn, timing):
    """(ms, wrapper ms, source, ms by kernel) of a call of fn(): the
    device time of every kernel and copy the call launches, summed, by
    torch.profiler over 10 calls (source "profiler"), beside the call's ms
    by CUDA events over 20, which time the host where a call's host work
    exceeds its kernels' (source "events", and the ms, where the profiler
    reports no device time)."""
    by_kernel = timing.device_ms(fn, 10)
    wrapper = timing.event_ms(fn, 20)
    total = sum(by_kernel.values())
    if total > 0:
        return total, wrapper, "profiler", by_kernel
    return wrapper, wrapper, "events", by_kernel


def load_arena(dev):
    """The arena checkpoint: (cfg, mcfg, params, nets, alive, fstatic,
    number of points) on ``dev``."""
    from saro_gs_torch import config as cfg_mod
    from saro_gs_torch import scene
    cfg = cfg_mod.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    mcfg = cfg.model_config()
    return (cfg, mcfg) + tuple(scene.load_gaussian_checkpoint(
        PLY, mcfg, device=dev))


def train_inputs(cfg, mcfg, params, nets, alive, fstatic, dev,
                 train_cap=None):
    """Phase 9's step on the arena checkpoint, dynamic stage, batch 4 at
    1352x1014: four ring cameras, seeded uint8 noise as ground truth, the
    checkpoint's loss weights and learning rates, the integral prune and
    LR scaling.  ``train_cap`` None sizes the instance capacity from the
    four views (their most instances plus 15%, a multiple of 64k).
    Returns cams, gt, ts, st, state0, need (SimpleNamespace)."""
    import types

    import torch
    from saro_gs_torch import render
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import densify as dens
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import projection
    from saro_gs_torch.train import step as step_mod
    from tests import torch_parity as golden
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
    ts = torch.linspace(0.1, 0.9, BATCH, device=dev).reshape(-1, 1, 1)
    rcfg = cfg.raster_config()
    need = None
    if train_cap is None:
        need = 0
        bg = torch.ones(3, device=dev)
        with torch.no_grad():
            feat = gm.field_feat(params, nets, mcfg, fstatic)
            for i in range(BATCH):
                pkg = render.train_render(
                    tcams[i], ts[i], params, nets, alive_t, mcfg, fstatic,
                    bg, width=W, height=H, stage="dynamatic", sh_degree=3,
                    rcfg=rcfg._replace(max_instances=1 << 22), feat=feat)
                need = max(need, pkg.out.num_instances + pkg.out.num_dropped)
        train_cap = max(-(-int(need * 1.15) // 65536) * 65536, 65536)
    st = step_mod.StepStatics(
        mcfg=mcfg, rcfg=rcfg._replace(max_instances=train_cap),
        weights=cfg.loss_weights(), width=W, height=H,
        cfg_lrs=step_mod.make_lr_statics(cfg), extent=extent,
        scale_floor=cfg.scale_floor)
    state0 = step_mod.init_state(params, nets, alive_t)._replace(
        inv_integral=inv_integral)
    return types.SimpleNamespace(cams=cams, gt=gt, ts=ts, st=st,
                                 state0=state0, need=need)


def arena_scene_info(params, nets, alive, fstatic, mcfg, rcfg, dev):
    """The trainer phase's scene, in memory: ring cameras with ground truth
    rendered from the checkpoint, and a point cloud of its positions at
    random frames plus noise (the layout of scripts/make_synth_scene.py,
    whose renderer is the JAX package's)."""
    import torch
    from saro_gs_torch import render
    from saro_gs_torch.data import cameras, readers
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import sh
    bg = torch.ones(3, device=dev)
    cams = []
    for i, c2w in enumerate(cameras.ring_cameras(N_CAMS)):
        ts = ((7 * i) % DURATION) / DURATION
        cam = dataclasses.replace(
            cameras.camera_from_c2w(c2w, 0.85, W, H, ts), uid=i,
            image_name=f"r_{i:02d}")
        out, _ = render.test_render(cam.raster_params(dev), ts, params, nets,
                                    alive, mcfg, fstatic, bg, width=W,
                                    height=H, sh_degree=3, rcfg=rcfg)
        check(out.num_dropped == 0, f"ground truth {i}: instances dropped")
        cam.set_image(torch.clamp(out.color, 0, 1).cpu().numpy())
        cams.append(cam)
    rng = np.random.RandomState(1)
    idx = rng.randint(0, params.xyz.shape[0], N_INIT)
    frames = rng.randint(0, DURATION, N_INIT) / DURATION
    sub = gm.GaussianParams(*[x[torch.as_tensor(idx, device=dev)]
                              for x in params])
    with torch.no_grad():
        d = gm.deform(sub, nets, mcfg, fstatic, torch.as_tensor(
            frames[:, None], dtype=torch.float32, device=dev))
    pts = d.xyz.cpu().double().numpy() + rng.normal(0, 0.01, (N_INIT, 3))
    colors = np.clip(sh.sh2rgb(sub.features_dc[:, 0].cpu().double().numpy())
                     + rng.normal(0, 0.05, (N_INIT, 3)), 0, 1)
    radius, translate = readers.nerfpp_norm(cams[1:])
    return readers.SceneInfo(
        point_cloud=gm.PointCloud(points=pts, colors=colors,
                                  times=frames[:, None]),
        train_cameras=cams[1:], test_cameras=cams[:1], val_cameras=[],
        nerf_radius=radius, nerf_translate=translate, ply_path="")


def trainer_phase(params, nets, alive, fstatic, mcfg, rcfg, dev, tk):
    """Phase 11: train the arena configuration from a point cloud through
    cli.train_main; returns (the "trainer" results, the kernels' launches
    over the run, the scene, what phase 13 compares with: the logged
    losses, the config, the test camera and its render at the end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from saro_gs_torch import cli, render, scene
    from saro_gs_torch.data import readers
    from saro_gs_torch.train import losses
    from saro_gs_torch.train import step as step_mod
    from saro_gs_torch.train.trainer import Trainer

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = t0 = time.perf_counter()
    info = arena_scene_info(params, nets, alive, fstatic, mcfg, rcfg, dev)
    readers.SCENE_READERS[LOADER] = lambda *a, **k: info
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    with open(ARENA_CONFIG) as f:
        config = json.load(f)
    config.update(SCHEDULE, loader=LOADER)
    cfg_path = os.path.join(TRAIN_DIR, "arena_150.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    model = os.path.join(TRAIN_DIR, "model")
    scene_s = time.perf_counter() - t0
    log(f"trainer: scene of {N_CAMS} cameras at {W}x{H} and {N_INIT} points "
        f"built in {scene_s:.1f} s; schedule {SCHEDULE}")

    # densify passes and capacity growth, each timed to a synchronize
    timed = {"_densify": [], "grow_capacity": []}
    originals = {name: getattr(Trainer, name) for name in timed}

    def timed_method(name):
        def run(self, *a, **k):
            sync()
            t = time.perf_counter()
            out = originals[name](self, *a, **k)
            sync()
            timed[name].append((time.perf_counter() - t) * 1e3)
            return out
        return run
    for name in timed:
        setattr(Trainer, name, timed_method(name))
    tk.reset_launches()
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", "in-memory", "--config", cfg_path, "-m",
                             model, "--device", str(dev)])
    finally:
        for name, fn in originals.items():
            setattr(Trainer, name, fn)
    sync()
    run_s = time.perf_counter() - t0
    launches = dict(tk.launches)
    cfg = tr.cfg
    hist = {h["it"]: h for h in tr.history}
    st = tr.state
    check(st.step == cfg.iterations, f"trainer: stopped at {st.step}")
    check(st.bad_steps == 0 and not any("bad_step" in h for h in tr.history),
          f"trainer: {st.bad_steps} bad steps")
    check(not tr.overflows and st.dropped_hwm == 0,
          f"trainer: instances dropped: {tr.overflows}, {st.dropped_hwm}")
    # the opacity reset at 120 clamps every opacity to 0.01, below the
    # start's 0.1, and 30 iterations do not bring it back: the loss must
    # fall by 30% before the reset and stay below the first after it
    first, last = hist[1]["loss"], hist[cfg.iterations]["loss"]
    before_reset = max(i for i in hist if i < cfg.opacity_reset_interval)
    pre = hist[before_reset]["loss"]
    check(pre < 0.7 * first and last < first,
          f"trainer: loss {first} -> {pre} (it {before_reset}) -> {last}")
    check([d["it"] for d in tr.densify_log] == [80, 120],
          f"trainer: densify ran at {[d['it'] for d in tr.densify_log]}")
    for d in tr.densify_log:
        check(d["after"] == d["before"] + d["cloned"] + d["split"]
              - d["pruned"], f"trainer: densify counts do not add up: {d}")
    check(all(launches[k] > 0 for k in launches),
          f"trainer: a kernel never launched in the run: {launches}")
    dyn = (cfg.iterations - cfg.static_iteration) / (
        hist[cfg.iterations]["elapsed_s"] - hist[cfg.static_iteration]
        ["elapsed_s"])
    with open(os.path.join(model, f"{cfg.iterations}_runtimeresults.json")) \
            as f:
        report = json.load(f)
    check(math.isfinite(report["PSNR"]), f"trainer: eval PSNR {report}")
    log(f"trainer: {cfg.iterations} iterations in {run_s:.1f} s "
        f"({dyn:.3f} it/s over the dynamic stage), loss {first:.5f} -> "
        f"{pre:.5f} (it {before_reset}) -> {last:.5f}, {tr.n_alive()} "
        f"points; densify {tr.densify_log} in "
        f"{timed['_densify']} ms, grow {timed['grow_capacity']} ms; eval "
        f"PSNR {report['PSNR']:.3f} SSIM {report['SSIM']:.4f} MS-SSIM "
        f"{report['MS-SSIM']:.4f}; launches {launches}")

    # the saved checkpoint renders as the trainer's final state does
    cam = info.test_cameras[0]
    loaded = scene.Scene(cfg, load_iteration=str(cfg.iterations), device=dev)
    bg = torch.ones(3, device=dev)
    eval_rcfg = cfg.raster_config()._replace(max_instances=tr.rcfg
                                             .max_instances)
    outs = []
    for p, n_, a, fs in ((st.points, st.nets, st.alive, tr.scene.fstatic),
                         (loaded.params, loaded.nets, loaded.alive,
                          loaded.fstatic)):
        out, _ = render.test_render(cam.raster_params(dev), cam.timestamp, p,
                                    n_, a, tr.mcfg, fs, bg, width=W,
                                    height=H, sh_degree=cfg.sh_degree,
                                    rcfg=eval_rcfg)
        check(out.num_dropped == 0, "trainer: the check render dropped")
        outs.append(out)
    check(all(torch.equal(getattr(outs[0], k), getattr(outs[1], k))
              for k in ("color", "depth", "final_t")),
          "trainer: the reloaded checkpoint renders differently")
    img = torch.clamp(outs[0].color, 0, 1)
    gt = torch.as_tensor(cam.load_image(True), device=dev)
    final = {"PSNR": float(losses.psnr(img, gt)),
             "SSIM": float(losses.ssim(img, gt)),
             "MS-SSIM": float(losses.msssim(img, gt))}
    log(f"trainer: checkpoint {cfg.iterations} ({loaded.alive.shape[0]} "
        f"rows) renders the test view as the trainer's state "
        f"({st.alive.shape[0]} rows) does, to the bit; at SH degree "
        f"{cfg.sh_degree}: {final}")

    # 8 more dynamic iterations: the kernels' launches and the loop's rate
    tk.reset_launches()
    sync()
    t0 = time.perf_counter()
    tr.run(max_iterations=cfg.iterations + 8, log_every=10 ** 6)
    sync()
    loop8 = 8 / (time.perf_counter() - t0)
    launches8 = dict(tk.launches)
    check(all(launches8[k] > 0 for k in launches8),
          f"trainer: a kernel never launched in 8 iterations: {launches8}")
    # 5 under torch.profiler: the card's busy share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        tr.run(max_iterations=cfg.iterations + 13, log_every=10 ** 6)
        sync()
        traced_ms = (time.perf_counter() - t0) * 1e3 / 5
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / 5
    # train_step_core alone on one batch of the loader, 8 steps
    loader = tr.scene.train_loader(cfg.batch, num_workers=2, seed=cfg.seed)
    try:
        cams_b, gt_b, ts_b = tr._to_device(next(iter(loader)))
    finally:
        loader.close()
    state = tr.state

    def core(state):
        return step_mod.train_step_core(
            state, cams_b, gt_b, ts_b, tr.bg, tr.scene.fstatic,
            tr._statics(), stage="dynamatic", sh_degree=cfg.sh_degree,
            scale_integral=False, sh_mask=tr._sh_mask(tr.active_sh_degree))
    state, m = core(state)
    sync()
    t0 = time.perf_counter()
    for _ in range(8):
        state, m = core(state)
        check(m["bad_step"] == 0 and m["dropped"] == 0,
              f"trainer: a train_step_core step went wrong: {m}")
    sync()
    core_its = 8 / (time.perf_counter() - t0)
    log(f"trainer: 8 iterations through the loop {loop8:.3f} it/s, "
        f"train_step_core alone {core_its:.3f} it/s; launches in 8 "
        f"iterations {launches8}; card busy {busy_ms:.2f} ms of "
        f"{traced_ms:.2f} ms an iteration under the profiler "
        + (f"({100 * busy_ms / traced_ms:.1f}%)" if busy_ms > 0 else
           "(no device time reported: not measured)"))

    test_main = None
    if importlib.util.find_spec("PIL") is not None:
        res = cli.test_main(["-m", model, "--iteration", str(cfg.iterations),
                             "--device", str(dev), "--skip_val"])
        for k, v in final.items():
            check(abs(res[k] - v) <= 1e-6 * abs(v),
                  f"trainer: test_main's {k} {res[k]} against {v}")
        test_main = {k: res[k] for k in final}
        log(f"trainer: cli.test_main ran, metrics equal: {test_main}")
    else:
        log("trainer: PIL is not installed; cli.test_main not run")
    readers.SCENE_READERS.pop(LOADER, None)
    phase_s = time.perf_counter() - t_phase
    log(f"trainer: the phase took {phase_s:.1f} s")
    return {
        "iterations": cfg.iterations, "batch": cfg.batch, "phase_s": phase_s,
        "resolution": [W, H], "init_points": N_INIT, "scene_s": scene_s,
        "run_s": run_s, "dynamic_its_per_s": dyn,
        "loop_its_per_s_8": loop8, "train_step_core_its_per_s": core_its,
        "densify_ms": timed["_densify"],
        "grow_capacity_ms": timed["grow_capacity"],
        "capacity_grew": bool(timed["grow_capacity"]),
        "densify": tr.densify_log, "points_final": tr.n_alive(),
        "loss_first": first, "loss_before_reset": pre, "loss_last": last,
        "eval": {k: report[k] for k in ("PSNR", "SSIM", "MS-SSIM")},
        "render_sh3": final, "test_main": test_main,
        "card_busy_ms_per_it": busy_ms or None,
        "traced_ms_per_it": traced_ms,
        "launches_8_its": launches8}, launches, info, {
            "losses": {i: h["loss"] for i, h in hist.items()}, "cfg": cfg,
            "test_camera": cam, "eval_rcfg": eval_rcfg,
            "render": outs[0].color, "dyn": dyn}


def header_found(name):
    """Whether the host compiler finds ``<name>`` (the native library's
    image decoders need png.h and jpeglib.h)."""
    try:
        res = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                             input=f"#include <{name}>\n", text=True,
                             capture_output=True, timeout=60)
    except OSError:
        return False
    return res.returncode == 0


def image_decoder(native):
    """Which decoder the loader takes: "native", or "PIL" and why (the
    image library's first error line, printed once on stderr)."""
    if native.image_available():
        return "native"
    return f"PIL (no image library: {native.IMAGE_ERROR})"


def write_arena_dataset(info, root):
    """Phase 12's dataset on disk, in the Blender/D-NeRF layout: phase
    11's cameras as transforms_{train,test}.json (``time`` chosen so the
    reader's time * (d - 1) / d gives phase 11's timestamps), their ground
    truth as 8-bit PNGs, and phase 11's init cloud as points3d.ply, which
    the reader keeps.  Returns the PNG paths, camera 0 (the test view)
    first."""
    from PIL import Image
    from saro_gs_torch.data import cameras, ply
    c2ws = cameras.ring_cameras(N_CAMS)
    frames = {"train": [], "test": []}
    paths = []
    for i, cam in enumerate(list(info.test_cameras)
                            + list(info.train_cameras)):
        split = "test" if i == 0 else "train"
        name = f"{split}/r_{i:02d}"
        os.makedirs(os.path.join(root, split), exist_ok=True)
        rgb = np.transpose(np.clip(cam.load_image(True), 0, 1), (1, 2, 0))
        paths.append(os.path.join(root, name + ".png"))
        Image.fromarray((rgb * 255 + 0.5).astype(np.uint8)).save(paths[-1])
        frames[split].append({
            "file_path": name, "transform_matrix": c2ws[i].tolist(),
            "time": ((7 * i) % DURATION) / (DURATION - 1)})
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.85, "frames": fr}, f)
    pcd = info.point_cloud
    ply.store_point_cloud(os.path.join(root, "points3d.ply"),
                          np.concatenate([pcd.points, pcd.times], axis=1),
                          pcd.colors * 255)
    return paths


def native_checks(info, paths, root, dev, core_build_s):
    """Phase 12's checks of the native host library on the card's host:
    the core library (built in phase 2, in ``core_build_s``) loaded, nn distances against
    ops/knn.py on the card, and the COLMAP binary readers against the
    Python ones; the image library built and its batch PNG decode against
    PIL where png.h and jpeglib.h are found, else its build raising, and
    PIL decoding.  Returns the results."""
    import torch
    from saro_gs_torch import native
    from saro_gs_torch.data import cameras, colmap
    from saro_gs_torch.ops import knn
    check(native.available(), "native: the core library did not load")
    headers = {h: header_found(h) for h in ("png.h", "jpeglib.h")}
    t0 = time.perf_counter()
    pil = np.stack([cameras.load_image_pil(p, W, H, True) for p in paths])
    pil_ms = (time.perf_counter() - t0) * 1e3
    out = {"headers": headers, "core_build_s": core_build_s,
           "pil_decode_ms": pil_ms, "images": len(paths)}
    if all(headers.values()):
        out["image_build_s"] = native.build_image()
        check(native.image_available(), "native: the image library did not "
              f"load: {native.IMAGE_ERROR}")
        t0 = time.perf_counter()
        imgs = native.load_images(paths, W, H, (1.0, 1.0, 1.0))
        out["png_decode_ms"] = (time.perf_counter() - t0) * 1e3
        check(imgs is not None, "native: load_images refused the PNGs")
        out["decode_max_abs_err"] = float(np.abs(imgs - pil).max())
        check(out["decode_max_abs_err"] <= 1e-6,
              f"native: decode differs from PIL by "
              f"{out['decode_max_abs_err']}")
        log(f"native: image library built in {out['image_build_s']:.2f} s")
    else:
        # the image library's build must fail loudly; the decode then
        # takes PIL and the core library stays
        try:
            native.build_image()
        except RuntimeError as e:
            out["image_error"] = next(
                (ln.strip() for ln in str(e).splitlines()
                 if "fatal error" in ln), str(e).splitlines()[0])
        else:
            fail("native: the image library built without the image "
                 "headers")
        check(not native.image_available() and native.IMAGE_ERROR,
              "native: the image library loaded without the image headers")
        log(f"native: image headers missing on this host {headers}; the "
            f"image library's build raises ({out['image_error']}); images "
            "decode through PIL, the core library (COLMAP, knn) is native")
    pts = np.asarray(info.point_cloud.points, np.float32)
    t0 = time.perf_counter()
    nn = native.nn_distance(pts)
    nn_ms = (time.perf_counter() - t0) * 1e3
    check(nn is not None, "native: nn_distance refused the cloud")
    ref = torch.sqrt(knn.knn_sq_dists(torch.as_tensor(pts, device=dev),
                                      1)[:, 0]).cpu().numpy()
    nn_err = float(np.max(np.abs(nn - ref) / (1e-6 + 1e-5 * np.abs(ref))))
    check(nn_err <= 1.0, f"native: nn_distance outside rtol 1e-5, atol "
          f"1e-6 of ops/knn ({nn_err} of the tolerance)")
    # a COLMAP model of phase 11's cameras and cloud, read both ways
    sparse = os.path.join(root, "colmap")
    os.makedirs(sparse)
    cams = list(info.test_cameras) + list(info.train_cameras)
    focal = W / (2 * math.tan(0.85 / 2))
    colmap.write_cameras_binary(
        {1: colmap.ColmapCamera(1, "PINHOLE", W, H,
                                np.array([focal, focal, W / 2, H / 2]))},
        os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(
        {i + 1: colmap.ColmapImage(i + 1, colmap.rotmat2qvec(c.R.T), c.T, 1,
                                   f"r_{i:02d}.png", None, None)
         for i, c in enumerate(cams)}, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(
        info.point_cloud.points,
        (info.point_cloud.colors * 255).astype(np.uint8),
        os.path.join(sparse, "points3D.bin"))

    def read_all():
        return (colmap.read_cameras_binary(os.path.join(sparse,
                                                        "cameras.bin")),
                colmap.read_images_binary(os.path.join(sparse,
                                                       "images.bin")),
                colmap.read_points3d_binary(os.path.join(sparse,
                                                         "points3D.bin")))
    check(native.read_points3d_bin(os.path.join(sparse, "points3D.bin"))
          is not None, "native: the core library refused points3D.bin")
    t0 = time.perf_counter()
    nat = read_all()
    colmap_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    py = (colmap.read_cameras_binary_py(os.path.join(sparse, "cameras.bin")),
          colmap.read_images_binary_py(os.path.join(sparse, "images.bin")),
          colmap.read_points3d_binary_py(os.path.join(sparse,
                                                      "points3D.bin")))
    colmap_py_ms = (time.perf_counter() - t0) * 1e3
    same = (nat[0].keys() == py[0].keys() and nat[1].keys() == py[1].keys()
            and all(np.array_equal(nat[0][k].params, py[0][k].params)
                    and nat[0][k][:4] == py[0][k][:4] for k in nat[0])
            and all(np.array_equal(nat[1][k].qvec, py[1][k].qvec)
                    and np.array_equal(nat[1][k].tvec, py[1][k].tvec)
                    and nat[1][k].name == py[1][k].name for k in nat[1])
            and all(np.array_equal(a, b) for a, b in zip(nat[2], py[2])))
    check(same, "native: the COLMAP readers differ from Python's")
    out.update(nn_points=int(pts.shape[0]), nn_ms=nn_ms,
               nn_err_of_tolerance=nn_err,
               colmap_points=int(nat[2][0].shape[0]), colmap_ms=colmap_ms,
               colmap_python_ms=colmap_py_ms)
    log(f"native: {json.dumps(out)}")
    return out


def disk_trainer_phase(info, losses11, dyn11, core_build_s, dev, tk):
    """Phase 12: phase 11's scene written to disk and trained from there
    through the blender reader, the loader's decode and cli.train_main;
    returns (the "trainer_disk" results, the kernels' launches over the
    run)."""
    import torch
    from saro_gs_torch import cli, native, render, scene
    from saro_gs_torch.config import load_config
    from saro_gs_torch.data import cameras
    from saro_gs_torch.train import losses, lpips

    def sync():
        torch.cuda.synchronize()

    check(importlib.util.find_spec("PIL") is not None,
          "trainer_disk: PIL is needed to write and size the PNGs")
    t_phase = t0 = time.perf_counter()
    shutil.rmtree(DISK_DIR, ignore_errors=True)
    root = os.path.join(DISK_DIR, "scene")
    paths = write_arena_dataset(info, root)
    write_s = time.perf_counter() - t0
    log(f"trainer_disk: {len(paths)} PNGs at {W}x{H} and points3d.ply "
        f"written in {write_s:.1f} s under {root}")
    nat = native_checks(info, paths, DISK_DIR, dev, core_build_s)

    with open(ARENA_CONFIG) as f:
        config = json.load(f)
    config.update(SCHEDULE, loader="blender")
    cfg_path = os.path.join(DISK_DIR, "arena_150.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    # the scene as the trainer builds it, and the loader's decode
    t0 = time.perf_counter()
    sc = scene.Scene(load_config(cfg_path, source_path=root,
                                 model_path=os.path.join(DISK_DIR, "probe")),
                     device=dev)
    sync()
    scene_s = time.perf_counter() - t0
    bsz, n_train = config["batch"], len(sc.info.train_cameras)
    loader = sc.train_loader(bsz, num_workers=1)
    decoder = image_decoder(native)
    batches = [np.arange(b * bsz, (b + 1) * bsz) % n_train for b in range(10)]
    try:
        decode = {}
        t0 = time.perf_counter()
        for idx in batches:
            loader._load_batch(idx)
        decode["loader"] = (time.perf_counter() - t0) * 1e3 / 10
        t0 = time.perf_counter()
        for idx in batches:
            for c in (sc.info.train_cameras[i] for i in idx):
                cameras.load_image_pil(c.image_path, c.width, c.height, True)
        decode["pil"] = (time.perf_counter() - t0) * 1e3 / 10
    finally:
        loader.close()
    del sc
    log(f"trainer_disk: scene built in {scene_s:.2f} s; BatchLoader decode "
        f"{decode['loader']:.2f} ms a batch of {config['batch']} "
        f"({decoder}), PIL alone {decode['pil']:.2f} ms")

    model = os.path.join(DISK_DIR, "model")
    tk.reset_launches()
    t0 = time.perf_counter()
    tr = cli.train_main(["-s", root, "--config", cfg_path, "-m", model,
                         "--device", str(dev), "--quiet"])
    sync()
    run_s = time.perf_counter() - t0
    launches = dict(tk.launches)
    cfg = tr.cfg
    hist = {h["it"]: h for h in tr.history}
    st = tr.state
    check(st.step == cfg.iterations, f"trainer_disk: stopped at {st.step}")
    check(st.bad_steps == 0 and not any("bad_step" in h for h in tr.history),
          f"trainer_disk: {st.bad_steps} bad steps")
    check(not tr.overflows and st.dropped_hwm == 0,
          f"trainer_disk: instances dropped: {tr.overflows}, "
          f"{st.dropped_hwm}")
    first, last = hist[1]["loss"], hist[cfg.iterations]["loss"]
    before_reset = max(i for i in hist if i < cfg.opacity_reset_interval)
    pre = hist[before_reset]["loss"]
    check(pre < 0.7 * first,
          f"trainer_disk: loss {first} -> {pre} (it {before_reset})")
    check(all(launches[k] > 0 for k in launches),
          f"trainer_disk: a kernel never launched in the run: {launches}")
    dyn = (cfg.iterations - cfg.static_iteration) / (
        hist[cfg.iterations]["elapsed_s"] - hist[cfg.static_iteration]
        ["elapsed_s"])
    common = sorted(set(hist) & set(losses11))
    loss_diff = max(abs(hist[i]["loss"] - losses11[i]) / abs(losses11[i])
                    for i in common)
    log(f"trainer_disk: {cfg.iterations} iterations in {run_s:.1f} s, "
        f"{dyn:.3f} it/s over the dynamic stage (phase 11: {dyn11:.3f}); "
        f"loss {first:.5f} -> {pre:.5f} (it {before_reset}) -> {last:.5f}; "
        f"largest relative difference from phase 11's losses at {common}: "
        f"{loss_diff:.3g}; densify {tr.densify_log}; launches {launches}")

    # the reloaded checkpoint, scored as the trainer's eval scores it
    loaded = scene.Scene(cfg, load_iteration=str(cfg.iterations), device=dev)
    bg = torch.ones(3, device=dev)
    eval_rcfg = cfg.raster_config()._replace(
        max_instances=tr.rcfg.max_instances)
    views = [loaded.test_cameras()[0], loaded.info.train_cameras[0]]
    imgs, gts = [], []
    for cam in views:
        out, _ = render.test_render(cam.raster_params(dev), cam.timestamp,
                                    loaded.params, loaded.nets, loaded.alive,
                                    tr.mcfg, loaded.fstatic, bg, width=W,
                                    height=H, sh_degree=cfg.sh_degree,
                                    rcfg=eval_rcfg)
        check(out.num_dropped == 0, "trainer_disk: the check render dropped")
        imgs.append(torch.clamp(out.color, 0, 1))
        gts.append(torch.as_tensor(cam.load_image(True), device=dev))
    final = {"PSNR": float(losses.psnr(imgs[0], gts[0])),
             "SSIM": float(losses.ssim(imgs[0], gts[0])),
             "LPIPS-alex": float(lpips.lpips(imgs[0], gts[0], "alex"))}

    # LPIPS on the card against the CPU, two views at full size
    card, cpu, lp_ms = [], [], []
    for img, gt in zip(imgs, gts):
        card.append(float(lpips.lpips(img, gt, "alex")))
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            lpips.lpips(img, gt, "alex")
        sync()
        lp_ms.append((time.perf_counter() - t0) * 1e3 / 5)
        cpu.append(float(lpips.lpips(img.cpu(), gt.cpu(), "alex")))
    lp_err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"trainer_disk: LPIPS-alex ({lpips.weights_source('alex')}) at "
        f"{W}x{H}: card {card}, CPU {cpu}, largest relative difference "
        f"{lp_err:.3g}; {lp_ms} ms a view on the card")
    check(lp_err <= 1e-4, f"trainer_disk: LPIPS card {card} vs CPU {cpu}")

    res = cli.test_main(["-m", model, "--iteration", str(cfg.iterations),
                         "--device", str(dev), "--skip_val"])
    with open(os.path.join(model, f"{cfg.iterations}_runtimeresults.json"))             as f:
        report = json.load(f)
    check(isinstance(report["LPIPS-alex"], float)
          and math.isfinite(report["LPIPS-alex"])
          and report["LPIPS-weights"] == lpips.FIXTURE_SOURCE,
          f"trainer_disk: the eval report's LPIPS: {report}")
    for k, v in final.items():
        tol = 1e-5 if k == "LPIPS-alex" else 1e-6
        check(abs(res[k] - v) <= tol * abs(v),
              f"trainer_disk: test_main's {k} {res[k]} against {v}")
    phase_s = time.perf_counter() - t_phase
    log(f"trainer_disk: cli.test_main {json.dumps(res)}; reloaded "
        f"checkpoint {final}; the phase took {phase_s:.1f} s; card "
        f"{smi_line()}")
    return {
        "iterations": cfg.iterations, "batch": cfg.batch,
        "resolution": [W, H], "write_s": write_s, "native": nat,
        "scene_s": scene_s, "decoder": decoder, "decode_ms_per_batch": decode,
        "run_s": run_s,
        "dynamic_its_per_s": dyn, "dynamic_its_per_s_phase11": dyn11,
        "loss_first": first, "loss_before_reset": pre, "loss_last": last,
        "loss_max_rel_diff_phase11": loss_diff, "loss_its": common,
        "densify": tr.densify_log, "points_final": tr.n_alive(),
        "render_sh3": final, "test_main": {
            k: res[k] for k in ("PSNR", "SSIM", "MS-SSIM", "LPIPS-alex",
                                "LPIPS-weights")},
        "lpips_card": card, "lpips_cpu": cpu, "lpips_rel_diff": lp_err,
        "lpips_ms_per_view": lp_ms, "phase_s": phase_s}, launches


def state_checksum(state):
    """sha256 of every leaf of a TrainState: points, nets, Adam moments,
    densify statistics, alive and the LR scalings."""
    import hashlib
    from saro_gs_torch.train import step as step_mod
    h = hashlib.sha256()
    for x in (step_mod.param_leaves(state.points, state.nets) + state.opt.mu
              + state.opt.nu + list(state.aux)
              + [state.alive, state.inv_integral,
                 state.inv_integral_densify]):
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def gate_leaves(state):
    """What phase 13 holds to the single process, as numpy: the point
    fields PARALLEL_FIELDS and the first plane, their Adam first moments
    (``mu.<name>``), and xyz_grad_accum."""
    from saro_gs_torch.models import gaussians as gm

    def n(x):
        return x.detach().cpu().numpy()
    fields = gm.GaussianParams._fields
    out = {k: n(getattr(state.points, k)) for k in PARALLEL_FIELDS}
    out["plane0"] = n(state.nets.field.planes[0])
    for k in PARALLEL_FIELDS:
        out[f"mu.{k}"] = n(state.opt.mu[fields.index(k)])
    out["mu.plane0"] = n(state.opt.mu[len(fields)])
    out["xyz_grad_accum"] = n(state.aux.xyz_grad_accum)
    return out


def state_errors(ref_first, ref, alt, got_first, got):
    """Phase 13's comparison of a mesh's state with the single process's,
    by gated leaf.  After step 1: ``mu_step1``, Adam's first moment (0.1
    times the step's reduced gradient) off by this share of its largest
    entry, and ``step1``, the largest difference of the parameter where
    that gradient is significant (|mu| >= 1e-3 of the largest).  After
    the last step: ``last``, the largest difference, beside ``spread``,
    the single process's own largest difference between two orders of
    its views (``alt``).  Adam's first steps move a parameter by about
    lr * sign(gradient), so a gradient at the rounding of the summation
    order moves it either way, and later steps carry that on."""
    out = {}
    for k in PARALLEL_FIELDS + ("plane0",):
        mu = np.abs(ref_first[f"mu.{k}"])
        sig = mu >= 1e-3 * mu.max()
        out[k] = {
            "mu_step1": float(np.abs(got_first[f"mu.{k}"]
                                     - ref_first[f"mu.{k}"]).max()
                              / max(mu.max(), 1e-30)),
            "step1": float(np.abs(got_first[k] - ref_first[k])[sig]
                           .max(initial=0.0)),
            "last": float(np.abs(got[k] - ref[k]).max()),
            "spread": float(np.abs(alt[k] - ref[k]).max())}
    return out


def eval_camera(dev):
    """Ring camera 0 of 21 at 1352x1014, the render slice's camera."""
    from saro_gs_torch.data import cameras
    return cameras.camera_from_c2w(cameras.ring_cameras(21)[0], 0.85, W, H,
                                   0.0).raster_params(dev)


def collective_ms(fn, reps=3):
    """ms a call of ``fn`` (collectives) on every rank, after a warm-up,
    the ranks starting together."""
    import torch
    import torch.distributed as dist
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def parallel_rank(rank, meshes, train_cap, render_cap, trainer):
    """One rank of phase 13 on the card.  On each (n_data, n_tile) mesh:
    PARALLEL_STEPS of phase 9's step from the checkpoint on this rank's
    views (its data index's share of the batch, its strips of every
    view).  With ``trainer`` (config path, model dir) also the arena frame
    by tile_sharded_render over the 2 ranks and phase 11's trainer on
    2 data ranks through cli.train_main.  Returns what the main process
    checks; the arrays only from rank 0."""
    import torch
    import torch.distributed as dist
    from saro_gs_torch import cli
    from saro_gs_torch.data import readers
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import tile_kernels as tk
    from saro_gs_torch.ops.projection import CameraParams
    from saro_gs_torch.parallel import comm, runtime, shard
    from saro_gs_torch.train import step as step_mod
    dev = runtime.rank_device("cuda")
    tk.build()
    cfg, mcfg, params, nets, alive, fstatic, _ = load_arena(dev)
    tin = train_inputs(cfg, mcfg, params, nets, alive, fstatic, dev,
                       train_cap)
    bg = torch.ones(3, device=dev)
    out = {}
    for shape in meshes:
        mesh = shard.make_mesh(*shape)
        idx = runtime.host_shard(list(range(BATCH)), mesh.data_rank,
                                 mesh.n_data)
        cams = CameraParams(*[x[idx] for x in tin.cams])
        state = step_mod.clone_state(tin.state0)
        tk.reset_launches()
        metrics, secs = [], []
        for k in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            state, m = shard.dp_train_step(
                state, cams, tin.gt[idx], tin.ts[idx], bg, fstatic, tin.st,
                stage="dynamatic", sh_degree=3, scale_integral=True,
                mesh=mesh)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append(m)
            if k == 0 and rank == 0:
                first = gate_leaves(state)
        res = {"metrics": metrics, "step_s": secs,
               "launches": dict(tk.launches),
               "checksum": state_checksum(state)}
        if rank == 0:
            res["leaves"] = (first, gate_leaves(state))
        # what the collectives cost alone: a reduction of buffers the size
        # of the gradients over each axis, and a view's strip gather
        grads = [torch.zeros_like(x) for x in
                 step_mod.param_leaves(state.points, state.nets)]
        ty = tin.st.rcfg.tile_y
        rows = -(-(-(-H // ty)) // mesh.n_tile)      # ceil(ceil(H/ty)/n)
        strip = torch.zeros(3, rows * ty, W, device=dev)
        res["collective_ms"] = {
            "gradient_floats": sum(g.numel() for g in grads),
            **{f"all_reduce_{axis}": collective_ms(
                lambda g=group: comm.all_reduce(grads, "sum", g))
               for axis, group in (("data", mesh.data_group),
                                   ("tile", mesh.tile_group))
               if group is not None}}
        if mesh.tile_group is not None:
            res["collective_ms"]["gather_strip"] = collective_ms(
                lambda: comm.gather_rows(strip, mesh.tile_group,
                                         mesh.tile_rank, mesh.n_tile, dim=1))
        out[f"{shape[0]}x{shape[1]}"] = res
        del state, grads
    if trainer is None:
        return out
    rcfg = cfg.raster_config()._replace(need_aux=False,
                                        max_instances=render_cap)
    with torch.no_grad():
        d = gm.deform(params, nets, mcfg, fstatic, 0.5)
    tk.reset_launches()
    img = shard.tile_sharded_render(
        d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), None,
        eval_camera(dev), bg, width=W, height=H, n_tile=2, shs=d.shs,
        sh_degree=3, config=rcfg)
    out["render"] = {"launches": dict(tk.launches),
                     "image": img.cpu().numpy() if rank == 0 else None}
    cfg_path, model = trainer
    info = arena_scene_info(params, nets, alive, fstatic, mcfg, rcfg, dev)
    readers.SCENE_READERS[LOADER] = lambda *a, **k: info
    tk.reset_launches()
    t0 = time.perf_counter()
    tr = cli.train_main(["-s", "in-memory", "--config", cfg_path, "-m",
                         model, "--device", "cuda", "--quiet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    hist = {h["it"]: h for h in tr.history}
    c = tr.cfg
    out["trainer"] = {
        "losses": {i: h["loss"] for i, h in hist.items()},
        "bad_steps": tr.state.bad_steps,
        "bad_logged": any("bad_step" in h for h in tr.history),
        "overflows": tr.overflows, "dropped_hwm": tr.state.dropped_hwm,
        "step": tr.state.step, "checksum": state_checksum(tr.state),
        "writes": tr.scene.writes, "run_s": run_s,
        "dynamic_its_per_s": (c.iterations - c.static_iteration) / (
            hist[c.iterations]["elapsed_s"]
            - hist[c.static_iteration]["elapsed_s"]),
        "launches": dict(tk.launches), "points": tr.n_alive(),
        "densify": tr.densify_log}
    return out


def parallel_phase(cfg, mcfg, params, nets, alive, fstatic, rcfg, tin,
                   phase11, dev, tk):
    """Phase 13: the parallel path on the card.  (a) K2, K1 and K3 on the
    arena frame's strip of 16 tile rows from row 16 (the partial bottom
    row included) against their plain versions; (b) 2 and 4 strips by
    rasterize against the full frame, forward and gradients; (c) the
    2x1, 1x2 (2 ranks) and 2x2 (4 ranks) meshes sharing the one card under
    gloo, PARALLEL_STEPS steps each against the single process; (d)
    tile_sharded_render over 2 ranks against the single render; (e) phase
    11's trainer on 2 data ranks against phase 11.  Returns (the
    "parallel" results, the kernels' launches by run)."""
    import torch
    from saro_gs_torch import render, scene
    from saro_gs_torch.data import readers
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import binning, compositing, projection
    from saro_gs_torch.ops.rasterize import _clip_to_strip, rasterize
    from saro_gs_torch.parallel import runtime
    from saro_gs_torch import timing
    from saro_gs_torch.train import step as step_mod

    t_phase = time.perf_counter()
    T = rcfg.tile_x
    gx, gy = -(-W // T), -(-H // T)
    bg = torch.ones(3, device=dev)
    cam = eval_camera(dev)
    with torch.no_grad():
        d = gm.deform(params, nets, mcfg, fstatic, 0.5)
    active = alive * (d.state[:, 0] > render.EVAL_STATE_CUTOFF)
    opac = d.opacity.reshape(-1)

    # ---- (a) the strip kernels against their plain versions --------------
    row0, rows = 16, 16
    check(gy == 32 and H % T != 0, "the arena frame's tile rows changed")
    pre = _clip_to_strip(projection.preprocess(
        d.xyz, d.scaling, d.rotation, opac, cam, W, H, T, T, sh_degree=3,
        shs=d.shs, active=active, tight_rect=rcfg.tight_rect), row0, rows)
    offsets, tiles, rect, gattr, total = binning.expand_inputs(pre, opac)
    check(total <= rcfg.max_instances, "strip: instances dropped")
    exp_args = (offsets, tiles, rect, gattr, total, gx, rows, T, T,
                rcfg.tight_rect, row0)
    kk, kg, ka = tk.expand_instances(*exp_args)
    pk, pg, pa = tk.expand_instances_plain(*exp_args)
    torch.cuda.synchronize()
    check(torch.equal(kk, pk) and torch.equal(kg, pg)
          and torch.equal(ka.view(torch.int32), pa.view(torch.int32)),
          "strip K2: differs from its plain version")
    sa_, _, sstart, scount, _ = binning.sort_instances(kk, kg, ka,
                                                       gx * rows)
    fargs = (sa_, sstart, scount, bg, W, H, T, T)
    kf = tk.forward_tiles(*fargs, rcfg.chunk, need_aux=True,
                          grid_y_local=rows, y0_tiles=row0)
    pf = compositing.forward_tiles(*fargs, need_aux=True, grid_y_local=rows,
                                   y0_px=row0 * T)
    torch.cuda.synchronize()
    k1_err = float((kf.color - pf.color).abs().max())
    for name in ("color", "depth", "final_t", "n_contrib"):
        check(torch.equal(getattr(kf, name), getattr(pf, name)),
              f"strip K1: {name} differs (colour max abs err {k1_err})")
    gen = torch.Generator(device="cpu").manual_seed(7)
    d_strip = torch.randn(3, rows * T, W, generator=gen).to(dev)
    bargs = (sa_, sstart, scount, bg, kf.n_contrib, kf.color, kf.final_t,
             d_strip, W, H, T, T)
    kb = tk.backward_tiles(*bargs, grid_y_local=rows, y0_tiles=row0)
    pb = compositing.backward_tiles(*bargs, grid_y_local=rows,
                                    y0_px=row0 * T)
    k3_rel = k3_l2 = 0.0
    for r in range(compositing.GRAD_ROWS):
        scale = float(pb[r].abs().max())
        check(scale > 0, f"strip K3: plain row {r} all zero")
        k3_rel = max(k3_rel, float((kb[r] - pb[r]).abs().max()) / scale)
        k3_l2 = max(k3_l2, float((kb[r] - pb[r]).double().norm()
                                 / pb[r].double().norm()))
    check(k3_rel <= K3_TOL and k3_l2 <= K3_TOL,
          f"strip K3: {k3_rel} of a row's max, {k3_l2} in relative L2")
    check(not bool(kb[:, (pb == 0).all(dim=0)].any()),
          "strip K3: a slot the replay never visits is not zero")
    strip_ms = {
        "K2": timing.event_ms(lambda: tk.expand_instances(*exp_args), 20),
        "K1": timing.event_ms(lambda: tk.forward_tiles(
            *fargs, rcfg.chunk, need_aux=True, grid_y_local=rows,
            y0_tiles=row0), 20),
        "K3": timing.event_ms(lambda: tk.backward_tiles(
            *bargs, grid_y_local=rows, y0_tiles=row0), 10)}
    log(f"parallel (a): the strip of {rows} tile rows from row {row0} "
        f"({total} instances): K2 and K1 equal to the bit to their plain "
        f"versions, K3 {k3_rel:.3g} of a row's max and {k3_l2:.3g} in "
        f"relative L2 (limits {K3_TOL:g}); ms {strip_ms}")

    # ---- (b) strips by rasterize against the full frame -------------------
    rc = rcfg._replace(need_aux=True)
    leaves = [x.detach().requires_grad_() for x in
              (d.xyz, d.scaling, d.rotation, opac, d.shs)]

    def frame(config, row0=0):
        return rasterize(*leaves[:4], cam, bg, width=W, height=H,
                         sh_degree=3, config=config, shs=leaves[4],
                         active=active, row0=row0)
    d_full = torch.randn(3, H, W, generator=gen).to(dev)
    full = frame(rc)
    g_full = torch.autograd.grad((full.color * d_full).sum(), leaves)
    strip_diff, grad_rel = {}, {}
    for n_strip in (2, 4):
        srows = -(-gy // n_strip)
        d_pad = torch.nn.functional.pad(d_full,
                                        (0, 0, 0, n_strip * srows * T - H))
        outs, g_sum = [], None
        for k in range(n_strip):
            o = frame(rc._replace(strip_rows=srows), k * srows)
            g = torch.autograd.grad(
                (o.color * d_pad[:, k * srows * T:(k + 1) * srows * T])
                .sum(), leaves)
            g_sum = g if g_sum is None else [a + b for a, b in zip(g_sum, g)]
            outs.append(o)
            check(o.num_dropped == 0, "strips: instances dropped")
        diff = 0.0
        for key in ("color", "depth", "final_t", "n_contrib"):
            dim = 1 if key == "color" else 0
            got = torch.cat([getattr(o, key) for o in outs],
                            dim=dim).narrow(dim, 0, H)
            ref = getattr(full, key)
            diff = max(diff, float((got.double() - ref.double()).abs()
                                   .max()))
            check(torch.equal(got, ref),
                  f"strips: {n_strip} strips' {key} differ from the frame")
        strip_diff[n_strip] = diff
        grad_rel[n_strip] = {
            name: float((a - b).abs().max() / (a.abs().max() + 1e-6))
            for name, a, b in zip(("means", "scales", "quats", "opacities",
                                   "shs"), g_full, g_sum)}
        check(max(grad_rel[n_strip].values()) <= 1e-5,
              f"strips: {n_strip} strips' gradients {grad_rel[n_strip]}")
    log(f"parallel (b): 2 and 4 strips equal the frame to the bit (largest "
        f"difference {strip_diff}); their gradients sum to the frame's "
        f"within {max(max(g.values()) for g in grad_rel.values()):.3g} of "
        f"each group's max (limit 1e-5): {grad_rel}")
    del leaves, g_full, g_sum, outs, full

    # ---- (c) the single-process reference of the meshes --------------------
    # and the same steps with the views in another order, which sums
    # every gradient in another order: the single process's own spread
    runs1 = []
    for order in (list(range(BATCH)), ALT_ORDER):
        views = (projection.CameraParams(*[x[order] for x in tin.cams]),
                 tin.gt[order], tin.ts[order])
        state = step_mod.clone_state(tin.state0)
        metrics, secs = [], []
        for k in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_mod.train_step_core(
                state, *views, bg, fstatic, tin.st, stage="dynamatic",
                sh_degree=3, scale_integral=True)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append(m)
            if k == 0:
                first = gate_leaves(state)
        runs1.append((metrics, secs, first, gate_leaves(state)))
        del state
    (ref_metrics, ref_s, ref_first, ref), (_, _, _, alt) = runs1
    torch.cuda.empty_cache()
    # (e)'s config: phase 11's on 2 data ranks
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    with open(ARENA_CONFIG) as f:
        config = json.load(f)
    config.update(SCHEDULE, loader=LOADER, mesh_data=2)
    cfg_path = os.path.join(MESH_DIR, "arena_150_mesh.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    model = os.path.join(MESH_DIR, "model")
    runs = {}
    for world, meshes, trainer in ((2, [(2, 1), (1, 2)], (cfg_path, model)),
                                   (4, [(2, 2)], None)):
        t0 = time.perf_counter()
        try:
            outs = runtime.launch_local(
                parallel_rank, world,
                (meshes, tin.st.rcfg.max_instances, rcfg.max_instances,
                 trainer),
                init_method=f"file://{MESH_DIR}/store_{world}",
                backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as e:
            fail(f"parallel: a rank of {world} failed:\n{e}")
        runs[world] = (outs, time.perf_counter() - t0)
        log(f"parallel: {world} ranks on one card took "
            f"{runs[world][1]:.1f} s")

    results = {"steps": PARALLEL_STEPS, "batch": BATCH, "ranks_share_card":
               torch.cuda.device_count(), "backend": "gloo",
               "single": {"steps_per_s": (PARALLEL_STEPS - 1)
                          / sum(ref_s[1:]), "first_step_s": ref_s[0]},
               "meshes": {}, "strip_ms": strip_ms, "strip_k3_rel": k3_rel,
               "strip_k3_l2": k3_l2, "strip_diff": strip_diff,
               "strip_grad_rel": grad_rel}
    launches = {}
    for world, (outs, _) in runs.items():
        for name in outs[0]:
            if name in ("render", "trainer"):
                continue
            rk = [o[name] for o in outs]
            check(len({r["checksum"] for r in rk}) == 1,
                  f"parallel {name}: the ranks' states differ")
            for r in rk:
                for i, m in enumerate(r["metrics"]):
                    check(m["bad_step"] == 0 and m["dropped"] == 0,
                          f"parallel {name}: step {i} went wrong: {m}")
            for i, (a, b) in enumerate(zip(ref_metrics, rk[0]["metrics"])):
                check(abs(b["loss"] - a["loss"]) <= 1e-5 * abs(a["loss"]),
                      f"parallel {name}: loss {b['loss']} against "
                      f"{a['loss']} at step {i}")
            got_first, got = rk[0]["leaves"]
            errs = state_errors(ref_first, ref, alt, got_first, got)
            check(all(e["mu_step1"] <= 1e-5 and e["step1"] <= 2e-5
                      for e in errs.values()),
                  f"parallel {name}: step 1 off the single process: {errs}")
            check(all(e["last"] <= max(2e-5, 2 * e["spread"])
                      for e in errs.values()),
                  f"parallel {name}: step {PARALLEL_STEPS} off the single "
                  f"process by more than twice its own spread: {errs}")
            acc = np.abs(got_first["xyz_grad_accum"]
                         - ref_first["xyz_grad_accum"])
            check(bool(np.all(acc <= 1e-3 * np.abs(
                ref_first["xyz_grad_accum"]) + 1e-6)),
                  f"parallel {name}: xyz_grad_accum off by {acc.max()}")
            lz = rk[0]["launches"]
            check(all(lz[k] > 0 for k in lz),
                  f"parallel {name}: a kernel never launched: {lz}")
            launches[name] = lz
            sps = (PARALLEL_STEPS - 1) / sum(rk[0]["step_s"][1:])
            loss_rel = max(abs(b["loss"] - a["loss"]) / abs(a["loss"])
                           for a, b in zip(ref_metrics, rk[0]["metrics"]))
            results["meshes"][name] = {
                "ranks": world, "steps_per_s": sps,
                "collective_ms": rk[0]["collective_ms"],
                "first_step_s": rk[0]["step_s"][0], "errors": errs,
                "loss_rel": loss_rel,
                "loss": [m["loss"] for m in rk[0]["metrics"]],
                "launches_rank0": lz}
            log(f"parallel (c) {name} on {world} ranks: states equal to the "
                f"bit on every rank; losses within {loss_rel:.3g} (limit "
                f"1e-5); against the single process (step 1's gradient "
                f"within 1e-5 of its max and the parameters within 2e-5 "
                f"where it is significant; step {PARALLEL_STEPS} within "
                f"twice the single process's spread): {errs}; "
                f"{sps:.3f} steps/s (single process "
                f"{results['single']['steps_per_s']:.3f}); collectives "
                f"alone on rank 0 (ms) {rk[0]['collective_ms']}; rank 0 "
                f"launches {lz}")

    # ---- (d) the tile-sharded render --------------------------------------
    outs = runs[2][0]
    with torch.no_grad():
        single = rasterize(d.xyz, d.scaling, d.rotation, opac, cam, bg,
                           width=W, height=H, sh_degree=3, config=rcfg,
                           shs=d.shs).color.cpu().numpy()
    img = outs[0]["render"]["image"]
    render_err = float(np.abs(img - single).max())
    check(img.shape == single.shape and np.array_equal(img, single),
          f"parallel (d): tile_sharded_render differs by {render_err}")
    launches["tile_sharded_render"] = outs[0]["render"]["launches"]
    log(f"parallel (d): tile_sharded_render over 2 ranks equals the single "
        f"render to the bit; rank 0 launches "
        f"{launches['tile_sharded_render']}")

    # ---- (e) the trainer on 2 data ranks ----------------------------------
    trs = [o["trainer"] for o in outs]
    tr0 = trs[0]
    check(len({t["checksum"] for t in trs}) == 1,
          "parallel (e): the ranks' trainer states differ")
    check([t["writes"] for t in trs] == [True, False],
          "parallel (e): rank 0, and only rank 0, must write")
    check(tr0["step"] == SCHEDULE["iterations"] and tr0["bad_steps"] == 0
          and not tr0["bad_logged"] and not tr0["overflows"]
          and tr0["dropped_hwm"] == 0,
          f"parallel (e): bad steps or drops: {tr0}")
    losses11 = phase11["losses"]
    rel = {i: abs(tr0["losses"][i] - losses11[i]) / abs(losses11[i])
           for i in (1, 50, 100)}
    check(rel[1] <= 1e-5 and rel[50] <= 1e-3 and rel[100] <= 1e-3,
          f"parallel (e): logged losses off phase 11's: {rel}")
    ckpt = os.path.join(model, "point_cloud",
                        f"iteration_{SCHEDULE['iterations']}")
    check(os.path.isdir(ckpt) and os.path.exists(
        os.path.join(model, "history.json")),
        "parallel (e): rank 0 wrote no checkpoint or history")
    tcfg = dataclasses.replace(phase11["cfg"], model_path=model)
    readers.SCENE_READERS[LOADER] = lambda *a, **k: phase11["info"]
    try:
        loaded = scene.Scene(tcfg,
                             load_iteration=str(SCHEDULE["iterations"]),
                             device=dev)
    finally:
        readers.SCENE_READERS.pop(LOADER, None)
    test_cam = phase11["test_camera"]
    out, _ = render.test_render(
        test_cam.raster_params(dev), test_cam.timestamp, loaded.params,
        loaded.nets, loaded.alive, mcfg, loaded.fstatic, bg, width=W,
        height=H, sh_degree=tcfg.sh_degree, rcfg=phase11["eval_rcfg"])
    mine = torch.clamp(out.color, 0, 1).double()
    theirs = torch.clamp(phase11["render"], 0, 1).double()
    mse = float(((mine - theirs) ** 2).mean())
    ckpt_psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
    check(out.num_dropped == 0 and ckpt_psnr >= 50.0,
          f"parallel (e): the 2-rank checkpoint renders {ckpt_psnr} dB "
          "from phase 11's")
    launches["trainer_2x1"] = tr0["launches"]
    check(all(v > 0 for v in tr0["launches"].values()),
          f"parallel (e): a kernel never launched: {tr0['launches']}")
    log(f"parallel (e): 2 data ranks trained {tr0['step']} iterations in "
        f"{tr0['run_s']:.1f} s, {tr0['dynamic_its_per_s']:.3f} it/s over the "
        f"dynamic stage (phase 11: {phase11['dyn']:.3f}); losses at 1, 50, "
        f"100 off phase 11's by {rel} (limits 1e-5, 1e-3, 1e-3); rank "
        f"states equal; {tr0['points']} points; the checkpoint, written by "
        f"rank 0 alone, renders {ckpt_psnr:.2f} dB from phase 11's")
    phase_s = time.perf_counter() - t_phase
    log(f"parallel: the phase took {phase_s:.1f} s; card {smi_line()}")
    results.update({
        "render_max_abs_err": render_err,
        "trainer": {k: tr0[k] for k in ("run_s", "dynamic_its_per_s",
                                        "points", "launches")},
        "trainer_dynamic_its_per_s_phase11": phase11["dyn"],
        "trainer_loss_rel": rel, "trainer_ckpt_psnr_db": ckpt_psnr,
        "spawn_s": {w: r[1] for w, r in runs.items()}, "phase_s": phase_s})
    return results, launches


def stress_scene(duration, dev):
    """Phase 14's scene, in memory, as the blender reader reads what
    saro_gs_torch.data.synth writes: synth.build_gt(7) rendered on the card
    at 1352x1014 (uint8) by 21 ring cameras (fovx 0.85), frame j at scene
    time j / (duration - 1) and camera timestamp j / duration; camera 0 at
    STRESS_TEST_FRAMES the test views, the other 20 at STRESS_TRAIN_FRAMES
    the training views; the init cloud of synth.init_cloud quantised as
    points3d.ply stores it."""
    from saro_gs_torch.data import cameras, readers, synth
    from saro_gs_torch.models import gaussians as gm
    gt = synth.build_gt(STRESS_SEED)
    ring = cameras.ring_cameras(STRESS_CAMS)
    views = []
    for ci in range(STRESS_CAMS):
        for j in STRESS_TRAIN_FRAMES if ci else STRESS_TEST_FRAMES:
            t = j / (duration - 1)
            cam = cameras.camera_from_c2w(ring[ci], 0.85, W, H,
                                          t * (duration - 1) / duration)
            views.append((dataclasses.replace(
                cam, uid=len(views), image_name=f"r_{ci:02d}_{j:03d}"), t))
    for (cam, _), img in zip(views, synth.render_frames(gt, views, W, H,
                                                         dev)):
        cam.set_image(img.permute(2, 0, 1).contiguous().cpu().numpy())
    n_test = len(STRESS_TEST_FRAMES)
    test, train = [c for c, _ in views[:n_test]], [c for c, _ in
                                                   views[n_test:]]
    pts, cols, times = synth.init_cloud(gt, duration, STRESS_INIT,
                                        STRESS_SEED)
    radius, translate = readers.nerfpp_norm(train)
    return readers.SceneInfo(
        point_cloud=gm.PointCloud(
            points=pts.astype(np.float64),
            colors=(cols * 255).astype(np.uint8) / 255.0,
            times=times.astype(np.float64)),
        train_cameras=train, test_cameras=test, val_cameras=[],
        nerf_radius=radius, nerf_translate=translate, ply_path="")


def stress_phase(dev, tk, timing):
    """Phase 14: configs/synth/stress_szcap.json at its widths, its
    schedule cut (STRESS_SCHEDULE), trained through cli.train_main on
    stress_scene.  Before the run, on the trainer's initial state and the
    run's first batch: two identical first steps equal to the bit, K4 on
    that step's own grid gradients of the xy and xt planes, the test
    views' PSNR.  After it, K2, K1 and K3 on the trained state's test
    frame.  Returns (the "stress" results, the kernels' launches over the
    run)."""
    import signal

    import torch
    from saro_gs_torch import cli
    from saro_gs_torch import eval as eval_mod
    from saro_gs_torch.data import readers
    from saro_gs_torch.train import step as step_mod
    from saro_gs_torch.train.trainer import Trainer

    def over_time(signum, frame):
        print(f"[chip_smoke] FAIL: stress: the phase ran past its "
              f"{STRESS_LIMIT_S} s", file=sys.stderr, flush=True)
        stop_children()
        os._exit(1)
    signal.signal(signal.SIGALRM, over_time)
    signal.alarm(STRESS_LIMIT_S)

    def sync():
        torch.cuda.synchronize()

    t_phase = t0 = time.perf_counter()
    with open(STRESS_CONFIG) as f:
        config = json.load(f)
    info = stress_scene(config["duration"], dev)
    readers.SCENE_READERS[STRESS_LOADER] = lambda *a, **k: info
    shutil.rmtree(STRESS_DIR, ignore_errors=True)
    os.makedirs(STRESS_DIR)
    config.update(STRESS_SCHEDULE, loader=STRESS_LOADER)
    cfg_path = os.path.join(STRESS_DIR, f"stress_szcap_"
                            f"{STRESS_SCHEDULE['iterations']}.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    model = os.path.join(STRESS_DIR, "model")
    scene_s = time.perf_counter() - t0
    gt_gb = sum(c._image.nbytes for c in info.train_cameras) / 1e9
    log(f"stress: scene of {len(info.train_cameras)} training and "
        f"{len(info.test_cameras)} test views at {W}x{H} ({gt_gb:.3f} GB of "
        f"uint8 ground truth) and {STRESS_INIT} points built in "
        f"{scene_s:.1f} s; schedule {STRESS_SCHEDULE}")

    # wrapped for the run: densify passes timed, eval renders' drops, and
    # the checks on the initial state before the loop starts
    timed, eval_dropped, pre = [], [], {}
    originals = {"_densify": Trainer._densify, "run": Trainer.run,
                 "render": eval_mod.Evaluator.render_view}

    def densify(self, *a, **k):
        sync()
        t = time.perf_counter()
        out = originals["_densify"](self, *a, **k)
        sync()
        timed.append((time.perf_counter() - t) * 1e3)
        return out

    def eval_render(self, *a, **k):
        # a view as the eval reports it, after any render at a larger
        # capacity
        out = originals["render"](self, *a, **k)
        eval_dropped.append(out[0].num_dropped)
        return out

    def run(self, *a, **k):
        if not pre:
            pre.update(stress_initial_checks(self, timing))
            tk.reset_launches()
            sync()
            torch.cuda.reset_peak_memory_stats()
        return originals["run"](self, *a, **k)
    Trainer._densify, Trainer.run = densify, run
    eval_mod.Evaluator.render_view = eval_render
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", "in-memory", "--config", cfg_path, "-m",
                             model, "--device", str(dev)])
        sync()
        run_s = time.perf_counter() - t0
        launches = dict(tk.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        Trainer._densify, Trainer.run = originals["_densify"], \
            originals["run"]
        eval_mod.Evaluator.render_view = originals["render"]
    cfg, st = tr.cfg, tr.state
    hist, report = run_checks("stress", tr, pre, eval_dropped, launches)
    first, last = hist[1]["loss"], max(hist.items())[1]["loss"]
    before_reset = max(i for i in hist if i < cfg.opacity_reset_interval)
    pre_reset = hist[before_reset]["loss"]
    check(pre_reset < 0.7 * first,
          f"stress: loss {first} -> {pre_reset} (it {before_reset})")
    its = [d["it"] for d in tr.densify_log]
    check(its == list(range(cfg.densify_from_iter
                            + cfg.densification_interval,
                            cfg.densify_until_iter,
                            cfg.densification_interval)),
          f"stress: densify ran at {its}")
    check(tr.active_sh_degree == 0,
          f"stress: SH degree {tr.active_sh_degree} after {cfg.iterations} "
          "iterations")
    # the loop's rate, loader and control included, from iteration 50 to
    # the last one logged
    a, b = 50, max(hist)
    dyn = (b - a) / (hist[b]["elapsed_s"] - hist[a]["elapsed_s"])
    log(f"stress: {cfg.iterations} iterations in {run_s:.1f} s "
        f"({dyn:.3f} it/s over iterations {a} to {b}), loss {first:.5f} -> "
        f"{pre_reset:.5f} (it {before_reset}) -> {last:.5f}, "
        f"{tr.n_alive()} points, capacity {st.alive.shape[0]}, "
        f"max_instances {pre['max_instances']} presized -> "
        f"{tr.rcfg.max_instances} (doublings {tr.overflows}); densify "
        f"{tr.densify_log} in {[round(x, 1) for x in timed]} ms; SH degree "
        f"{tr.active_sh_degree}; test PSNR {pre['psnr_init']:.3f} at the "
        f"start -> {report['PSNR']:.3f} (SSIM {report['SSIM']:.4f}); peak "
        f"memory {peak_gib:.2f} GiB; launches {launches}")

    # the saved checkpoint renders as the trainer's final state does
    cam = info.test_cameras[len(info.test_cameras) // 2]
    bg = torch.ones(3, device=dev)
    rcfg, _ = reload_check("stress", tr, cam, bg, dev)

    # K2, K1 and K3 on that view of the trained state
    d, pre_frame = stage_frame(st.points, st.nets, st.alive, tr.mcfg,
                               tr.scene.fstatic, cam.raster_params(dev),
                               cam.timestamp, rcfg)
    fk = frame_kernels("stress", d, pre_frame, rcfg.max_instances, bg, rcfg,
                       tk, timing)
    del d, pre_frame

    # train_step_core alone on one batch of the loader: 8 steps, then 3
    # with the stage marks
    loader = tr.scene.train_loader(cfg.batch, num_workers=2, seed=cfg.seed)
    try:
        cams_b, gt_b, ts_b = tr._to_device(next(iter(loader)))
    finally:
        loader.close()
    scale_int = tr.integral_flags(st.step + 1)[1]

    def step(state):
        return step_mod.train_step_core(
            state, cams_b, gt_b, ts_b, tr.bg, tr.scene.fstatic,
            tr._statics(), stage="dynamatic", sh_degree=cfg.sh_degree,
            scale_integral=scale_int,
            sh_mask=tr._sh_mask(tr.active_sh_degree))
    core_ips, state = core_its("stress", step, st)
    with timing.record() as rec:
        for _ in range(3):
            state, m = step(state)
            check(m["bad_step"] == 0 and m["dropped"] == 0,
                  f"stress: a train_step_core step went wrong: {m}")
    stages = {k: v / 3 for k, v in rec.stages().items()}
    del state
    busy_ms, traced_ms, busy = busy_share("stress", tr)
    log(f"stress: train_step_core alone {core_ips:.3f} it/s; ms per step by "
        "stage " + json.dumps({k: round(v, 3) for k, v in stages.items()})
        + f" (sum {sum(stages.values()):.2f}); {busy}")
    readers.SCENE_READERS.pop(STRESS_LOADER, None)
    phase_s = time.perf_counter() - t_phase
    signal.alarm(0)
    log(f"stress: the phase took {phase_s:.1f} s (limit {STRESS_LIMIT_S} "
        f"s); card {smi_line()}")
    return {
        "config": os.path.relpath(STRESS_CONFIG, HERE),
        "schedule": STRESS_SCHEDULE, "iterations": cfg.iterations,
        "batch": cfg.batch, "resolution": [W, H],
        "planes": [list(p.shape) for p in st.nets.field.planes],
        "train_views": len(info.train_cameras),
        "test_views": len(info.test_cameras), "init_points": STRESS_INIT,
        "gt_bytes": int(gt_gb * 1e9), "scene_s": scene_s, "run_s": run_s,
        "its_per_s_from_50": dyn, "train_step_core_its_per_s": core_ips,
        "stages_ms": stages, "densify_ms": timed, "densify": tr.densify_log,
        "overflows": tr.overflows,
        "max_instances": [pre["max_instances"], tr.rcfg.max_instances],
        "points_final": tr.n_alive(), "capacity": st.alive.shape[0],
        "sh_degree": tr.active_sh_degree, "loss_first": first,
        "loss_before_reset": pre_reset, "loss_last": last,
        "psnr_init": pre["psnr_init"],
        "eval": {k: report[k] for k in ("PSNR", "SSIM", "MS-SSIM")},
        "peak_memory_gib": peak_gib, "card_busy_ms_per_it": busy_ms or None,
        "traced_ms_per_it": traced_ms, "launches": launches,
        "k4": pre["k4"], "frame": fk, "phase_s": phase_s}, launches


def neural3d_phase(dev, tk, timing):
    """Phase 15: the Neural3D training mode on the card.
    configs/neural_3D/flame_steak.json through cli.train_main and
    cli.test_main, with only N3D_SCHEDULE's keys (and the paths) changed:
    30 of 300 frames, 510 of 30,000 iterations, densify from 100 (of 500)
    until 500 (of 5,000), so passes at 200, 300 and 400, the opacity reset
    at 300 (of 3,000), test and save at 510; the base-time z prune then
    runs at 501.  Everything else is the file's or the defaults: resolution
    2, planes 512^3 x 256 of 32 channels, batch 4 at 1352x1014,
    preprocesspoints 31, densify 2, the colmap reader, a black background,
    capacity 262,144, max_instances presized.  The scene is
    tests/torch_n3d_scene.py's, written under build/chip_smoke_n3d/ (19 rig
    cameras x 30 frames of build_gt(7) at 2704x2028, per-frame clouds with
    floaters) and read through the colmap reader, which parses through the
    native core library; without the image library the images decode
    through PIL.
    Returns (the "neural3d" results, the kernels' launches over the run)."""
    import signal

    import torch
    from saro_gs_torch import cli, native
    from saro_gs_torch import eval as eval_mod
    from saro_gs_torch import scene as scene_mod
    from saro_gs_torch.data import colmap, readers
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.train.trainer import Trainer
    from tests import torch_n3d_scene as n3d

    def over_time(signum, frame):
        print(f"[chip_smoke] FAIL: neural3d: the phase ran past its "
              f"{N3D_LIMIT_S} s", file=sys.stderr, flush=True)
        stop_children()
        os._exit(1)
    signal.signal(signal.SIGALRM, over_time)
    signal.alarm(N3D_LIMIT_S)

    def sync():
        torch.cuda.synchronize()

    t_phase = t0 = time.perf_counter()
    decoder = image_decoder(native)
    root = os.path.join(N3D_DIR, "scene")
    written = n3d.write_n3d_scene(root, dev)
    sync()
    write_s = time.perf_counter() - t0
    bins = [os.path.join(root, f"colmap_{j}", "sparse", "0", "points3D.bin")
            for j in range(n3d.N3D_FRAMES)]
    frames_xyz = [n3d.read_points3d(p) for p in bins]
    recount = n3d.recount_preprocess31(frames_xyz)
    log(f"neural3d: scene of {n3d.N3D_CAMS} cameras x {n3d.N3D_FRAMES} "
        f"frames at {n3d.N3D_W}x{n3d.N3D_H} "
        f"{'written' if written['written'] else 'reused'} in {write_s:.1f} s "
        f"under {root}; clouds {[x.shape[0] for x in frames_xyz[:2]]}..., "
        f"numpy recount (merged, preprocessed, after the z prune) "
        f"{recount}; image decode {decoder}")
    # the reader's parse of the per-frame clouds: the native core library
    # against the Python loop, side by side
    parse_s = {}
    for mode, read in (("native", colmap.read_points3d_binary),
                       ("python", colmap.read_points3d_binary_py)):
        t0 = time.perf_counter()
        parsed = [read(p) for p in bins]
        parse_s[mode] = time.perf_counter() - t0
        check(all(np.array_equal(x[0], ref)
                  for x, ref in zip(parsed, frames_xyz)),
              f"neural3d: the {mode} parse of points3D.bin differs from the "
              "written clouds")
    check(native.read_points3d_bin(bins[0]) is not None,
          "neural3d: the native core library refused points3D.bin")
    log(f"neural3d: the {len(bins)} points3D.bin files "
        f"({sum(x.shape[0] for x in frames_xyz)} points) parse in "
        f"{parse_s['native']:.3f} s natively, {parse_s['python']:.3f} s by "
        "the Python loop")

    model = os.path.join(N3D_DIR, "model")
    shutil.rmtree(model, ignore_errors=True)
    with open(N3D_CONFIG) as f:
        config = json.load(f)
    config.update(N3D_SCHEDULE, source_path=os.path.join(root, "colmap_0"),
                  model_path=model)
    cfg_path = os.path.join(N3D_DIR, "flame_steak_510.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)

    # wrapped for the run: the scene build timed, the count before the
    # CLI's prune, densify passes and growths timed, the z prune held to a
    # recount, eval renders' drops, the checks on the initial state
    built, timed, grown, zpruned, eval_dropped, pre = {}, [], [], [], [], {}
    originals = {"scene": scene_mod.Scene.__init__,
                 "reader": readers.SCENE_READERS["colmap"],
                 "preprocess": scene_mod.preprocess_points,
                 "init": Trainer.__init__, "_densify": Trainer._densify,
                 "grow": Trainer.grow_capacity,
                 "zprune": Trainer._zprune_real_xyz, "run": Trainer.run,
                 "render": eval_mod.Evaluator.render_view}

    def timed_call(name, fn):
        def call(*a, **k):
            sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            built[name] = time.perf_counter() - t
            return out
        return call

    def trainer_init(self, cfg, scene):
        pre["alive_preprocessed"] = int((scene.alive > 0).sum())
        originals["init"](self, cfg, scene)

    def densify(self, *a, **k):
        sync()
        t = time.perf_counter()
        out = originals["_densify"](self, *a, **k)
        sync()
        timed.append((time.perf_counter() - t) * 1e3)
        return out

    def grow(self, *a, **k):
        old = self.state.alive.shape[0]
        sync()
        t = time.perf_counter()
        originals["grow"](self, *a, **k)
        sync()
        grown.append((self.state.step, old, self.state.alive.shape[0],
                      (time.perf_counter() - t) * 1e3))

    def zprune(self):
        st = self.state
        with torch.no_grad():
            real = gm.deform(st.points, st.nets, self.mcfg,
                             self.scene.fstatic, 0.0,
                             with_residuals=True).real_xyz
        expect = torch.where(real[:, 2] < 4.5, torch.zeros_like(st.alive),
                             st.alive)
        before = int((st.alive > 0).sum())
        originals["zprune"](self)
        zpruned.append((st.step, before, int((self.state.alive > 0).sum()),
                        bool(torch.equal(self.state.alive, expect))))

    def eval_render(self, *a, **k):
        # a view as the eval reports it, after any render at a larger
        # capacity
        out = originals["render"](self, *a, **k)
        eval_dropped.append(out[0].num_dropped)
        return out

    def run(self, *a, **k):
        if not pre.get("checked"):
            pre.update(n3d_initial_checks(
                self, recount, pre["alive_preprocessed"], root))
            pre["checked"] = True
            tk.reset_launches()
            sync()
            torch.cuda.reset_peak_memory_stats()
        return originals["run"](self, *a, **k)
    scene_mod.Scene.__init__ = timed_call("scene", originals["scene"])
    readers.SCENE_READERS["colmap"] = timed_call("reader",
                                                 originals["reader"])
    scene_mod.preprocess_points = timed_call("preprocess",
                                             originals["preprocess"])
    Trainer.__init__, Trainer._densify = trainer_init, densify
    Trainer.grow_capacity, Trainer._zprune_real_xyz = grow, zprune
    Trainer.run, eval_mod.Evaluator.render_view = run, eval_render
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", config["source_path"], "--config",
                             cfg_path, "-m", model, "--device", str(dev)])
        sync()
        run_s = time.perf_counter() - t0
        launches = dict(tk.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        scene_mod.Scene.__init__ = originals["scene"]
        readers.SCENE_READERS["colmap"] = originals["reader"]
        scene_mod.preprocess_points = originals["preprocess"]
        Trainer.__init__, Trainer._densify = (originals["init"],
                                              originals["_densify"])
        Trainer.grow_capacity = originals["grow"]
        Trainer._zprune_real_xyz = originals["zprune"]
        Trainer.run = originals["run"]
        eval_mod.Evaluator.render_view = originals["render"]
    cfg, st = tr.cfg, tr.state
    hist, report = run_checks("neural3d", tr, pre, eval_dropped, launches)
    its = [d["it"] for d in tr.densify_log]
    check(its == [i for i in range(1, cfg.densify_until_iter)
                  if i > cfg.densify_from_iter
                  and i % cfg.densification_interval == 0],
          f"neural3d: densify ran at {its}")
    cap0 = pre["capacity"]
    check(grown and grown[0][1:3] == (cap0, 2 * cap0),
          f"neural3d: no capacity growth {cap0} -> {2 * cap0}: {grown}; "
          f"densify {tr.densify_log}")
    rows = cap0 << len(grown)
    k = len(gm.GaussianParams._fields)
    per_gaussian = (list(st.points) + st.opt.mu[:k] + st.opt.nu[:k]
                    + [st.alive, st.inv_integral, st.inv_integral_densify]
                    + list(st.aux))
    check(all(x.shape[0] == rows for x in per_gaussian),
          f"neural3d: per-Gaussian rows "
          f"{sorted({x.shape[0] for x in per_gaussian})} after "
          f"{len(grown)} growth(s) from {cap0}")
    z_its = [i for i in range(cfg.densify_until_iter, cfg.iterations + 1)
             if i % 500 == 1]
    check([z[0] for z in zpruned] == z_its and all(z[3] for z in zpruned),
          f"neural3d: the base-time z prune {zpruned} (expected at {z_its}, "
          "equal to the recount)")
    a, b = 50, max(i for i in hist if i <= cfg.densify_until_iter)
    dyn = (b - a) / (hist[b]["elapsed_s"] - hist[a]["elapsed_s"])
    first, last = hist[1]["loss"], max(hist.items())[1]["loss"]
    log(f"neural3d: {cfg.iterations} iterations in {run_s:.1f} s "
        f"({dyn:.3f} it/s over iterations {a} to {b}), loss {first:.5f} -> "
        f"{last:.5f}; scene built in {built['scene']:.2f} s (reader "
        f"{built['reader']:.2f} s, preprocess {built['preprocess']:.2f} s); "
        f"{pre['alive_preprocessed']} points after preprocesspoints 31, "
        f"{pre['alive_start']} after the z prune; densify {tr.densify_log} "
        f"in {[round(x, 1) for x in timed]} ms; growths (it, from, to, ms) "
        f"{grown}; z prune (it, before, after, equal to the recount) "
        f"{zpruned}; {tr.n_alive()} points, capacity {st.alive.shape[0]}, "
        f"max_instances {pre['max_instances']} presized -> "
        f"{tr.rcfg.max_instances} (doublings {tr.overflows}); test PSNR "
        f"{pre['psnr_init']:.3f} at the start -> {report['PSNR']:.3f} (SH "
        f"degree {tr.active_sh_degree}); peak memory {peak_gib:.2f} GiB; "
        f"launches {launches}")

    # the checkpoint renders the test frame as the trainer's state does
    info = tr.scene.info
    cam = info.test_cameras[len(info.test_cameras) // 2]
    bg = torch.zeros(3, device=dev)
    rcfg, _ = reload_check("neural3d", tr, cam, bg, dev)

    # cli.test_main: the test set, then the 300 spiral val views
    res, same, test_main_s = check_test_main("neural3d", tr, dev)
    val = os.path.join(model, "val", f"ours_{cfg.iterations}", "renders")
    n_val = len(os.listdir(val)) if os.path.isdir(val) else 0
    check(len(info.val_cameras) == n_val == 300,
          f"neural3d: {n_val} val renders of {len(info.val_cameras)} views")
    log(f"neural3d: cli.test_main in {test_main_s:.1f} s: "
        f"{json.dumps(res)}; the trainer's eval of that state at SH "
        f"{cfg.sh_degree} "
        + json.dumps({k_: same[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM")})
        + f"; its eval at {cfg.iterations} (SH {tr.active_sh_degree}) PSNR "
        f"{report['PSNR']:.4f}; {n_val} val renders")

    # K2, K1 and K3 on that view of the trained state, on black
    d, pre_frame = stage_frame(st.points, st.nets, st.alive, tr.mcfg,
                               tr.scene.fstatic, cam.raster_params(dev),
                               cam.timestamp, rcfg)
    fk = frame_kernels("neural3d", d, pre_frame, rcfg.max_instances, bg,
                       rcfg, tk, timing)
    del d, pre_frame

    # the grown state: two identical steps, K4 on that step's xy and xt
    # plane gradients, then train_step_core alone over 8 steps
    step = core_step(tr, first_batch(tr), st.step + 1)
    _, taps = same_two_steps("neural3d: a step of the grown state", step, st)
    k4 = plane_k4("neural3d", taps, f"at {rows} rows", timing)
    del taps
    core_ips, _ = core_its("neural3d", step, st)

    # the loader's decode: capture-size PNG to the training size, a batch;
    # the busy share
    dec_ms = decode_ms(tr, 37, 101)
    busy_ms, traced_ms, busy = busy_share("neural3d", tr)
    log(f"neural3d: train_step_core alone {core_ips:.3f} it/s on the grown "
        f"state ({rows} rows); loader decode {dec_ms:.1f} ms a batch of "
        f"{cfg.batch} ({n3d.N3D_W}x{n3d.N3D_H} PNG -> {W}x{H}, {decoder}); "
        f"{busy}")

    phase_s = time.perf_counter() - t_phase
    signal.alarm(0)
    log(f"neural3d: the phase took {phase_s:.1f} s (limit {N3D_LIMIT_S} "
        f"s); card {smi_line()}")
    return {
        "config": os.path.relpath(N3D_CONFIG, HERE),
        "schedule": N3D_SCHEDULE, "iterations": cfg.iterations,
        "batch": cfg.batch, "resolution": [W, H],
        "capture": [n3d.N3D_W, n3d.N3D_H], "rig_cameras": n3d.N3D_CAMS,
        "frames": n3d.N3D_FRAMES, "clouds": n3d.N3D_CLOUD,
        "planes": [list(p.shape) for p in st.nets.field.planes],
        "train_views": len(info.train_cameras),
        "test_views": len(info.test_cameras),
        "val_views": len(info.val_cameras), "decoder": decoder,
        "scene_written": written["written"], "write_s": write_s,
        "points3d_parse_s": parse_s, "build_s": built, "recount": recount,
        "alive_preprocessed": pre["alive_preprocessed"],
        "alive_start": pre["alive_start"], "run_s": run_s,
        "its_per_s_50_500": dyn, "train_step_core_its_per_s": core_ips,
        "decode_ms_per_batch": dec_ms, "densify_ms": timed,
        "densify": tr.densify_log, "growths": grown, "zprune": zpruned,
        "overflows": tr.overflows,
        "max_instances": [pre["max_instances"], tr.rcfg.max_instances],
        "points_final": tr.n_alive(), "capacity": rows,
        "loss_first": first, "loss_last": last,
        "psnr_init": pre["psnr_init"],
        "eval": {k_: report[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM")},
        "test_main": {k_: res[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM",
                                             "LPIPS-alex", "FPS")},
        "test_main_s": test_main_s, "peak_memory_gib": peak_gib,
        "card_busy_ms_per_it": busy_ms or None, "traced_ms_per_it": traced_ms,
        "launches": launches, "k4": k4, "frame": fk,
        "phase_s": phase_s}, launches


def dnerf_phase(dev, tk, timing):
    """Phase 16: the D-NeRF training mode on the card.  (a)
    configs/dnerf/standup.json through cli.train_main and cli.test_main,
    with only DNERF_SCHEDULE's keys (and the paths) changed: 2,110 of
    20,000 iterations, test and save at 2,110.  Everything else is the
    file's or the defaults: the blender reader at resolution 2 (400x400
    from 800x800 RGBA) over white, batch 4, planes 64^3 x 128 of 32
    channels, densify 5 from 500 every 100, the opacity reset every 2,000,
    static until 1,000, duration 150, capacity 262,144, max_instances
    presized, the learning rates of the real run.  (c) Run (a) resumed
    from its checkpoint at 2,110 to 2,310 (dnerf_resume).  (b) The same
    scene and config with DNERF_DOUBLING: no presize, max_instances
    65,536, 100 iterations, so that the overflow check doubles it.  The
    scene is tests/torch_dnerf_scene.py's, written under
    build/chip_smoke_dnerf/ (150 training and 20 test frames of 800x800
    RGBA rendered by the port, no points3d.ply: the reader draws its
    random init); without the image library the images decode through
    PIL.  Returns (the "dnerf" results, the kernels' launches over run
    a)."""
    import signal

    import torch
    from saro_gs_torch import cli, native
    from saro_gs_torch import eval as eval_mod
    from saro_gs_torch import scene as scene_mod
    from saro_gs_torch.train.trainer import Trainer
    from tests import torch_dnerf_scene as dnerf

    def over_time(signum, frame):
        print(f"[chip_smoke] FAIL: dnerf: the phase ran past its "
              f"{DNERF_LIMIT_S} s", file=sys.stderr, flush=True)
        stop_children()
        os._exit(1)
    signal.signal(signal.SIGALRM, over_time)
    signal.alarm(DNERF_LIMIT_S)

    def sync():
        torch.cuda.synchronize()

    t_phase = t0 = time.perf_counter()
    decoder = image_decoder(native)
    root = os.path.join(DNERF_DIR, "scene")
    written = dnerf.write_dnerf_scene(root, dev)
    sync()
    write_s = time.perf_counter() - t0
    full = dnerf.FULL
    log(f"dnerf: scene of {full['train']} training and {full['test']} test "
        f"frames at {full['width']}x{full['height']} RGBA "
        f"{'written' if written['written'] else 'reused'} in {write_s:.1f} "
        f"s under {root}; image decode {decoder}")

    def config_file(name, extra, model):
        with open(DNERF_CONFIG) as f:
            config = json.load(f)
        config.update(extra, source_path=root, model_path=model)
        path = os.path.join(DNERF_DIR, name)
        with open(path, "w") as f:
            json.dump(config, f)
        return path

    # ---- run (a): the schedule to 2,110 ----------------------------------
    model = os.path.join(DNERF_DIR, "model")
    shutil.rmtree(model, ignore_errors=True)
    cfg_path = config_file("standup_2110.json", DNERF_SCHEDULE, model)
    # wrapped for the run: the scene build timed, each densify attempt
    # timed with its size flag, the refreshes and resets recorded with the
    # SH degree, eval renders' drops, the checks on the initial state
    built, passes, refreshes, resets, eval_dropped, pre = ({}, [], [], [],
                                                          [], {})
    originals = {"scene": scene_mod.Scene.__init__,
                 "_densify": Trainer._densify,
                 "refresh": Trainer._integral_refresh,
                 "reset": Trainer._reset_opacity, "run": Trainer.run,
                 "render": eval_mod.Evaluator.render_view}

    def scene_init(self, *a, **k):
        sync()
        t = time.perf_counter()
        originals["scene"](self, *a, **k)
        sync()
        built.setdefault("scene", time.perf_counter() - t)

    def densify(self, size):
        sync()
        t = time.perf_counter()
        out = originals["_densify"](self, size)
        sync()
        passes.append((self.state.step, size,
                       (time.perf_counter() - t) * 1e3))
        return out

    def refresh(self, use):
        refreshes.append(self.state.step + 1)
        return originals["refresh"](self, use)

    def reset(self):
        resets.append((self.state.step, self.active_sh_degree))
        return originals["reset"](self)

    def eval_render(self, *a, **k):
        # a view as the eval reports it, after any render at a larger
        # capacity
        out = originals["render"](self, *a, **k)
        eval_dropped.append(out[0].num_dropped)
        return out

    def run(self, *a, **k):
        if not pre:
            pre.update(dnerf_initial_checks(self, timing))
            tk.reset_launches()
            sync()
            torch.cuda.reset_peak_memory_stats()
        return originals["run"](self, *a, **k)
    scene_mod.Scene.__init__, Trainer._densify = scene_init, densify
    Trainer._integral_refresh, Trainer._reset_opacity = refresh, reset
    Trainer.run, eval_mod.Evaluator.render_view = run, eval_render
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", root, "--config", cfg_path, "-m", model,
                             "--device", str(dev)])
        sync()
        run_s = time.perf_counter() - t0
        launches = dict(tk.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        scene_mod.Scene.__init__ = originals["scene"]
        Trainer._densify = originals["_densify"]
        Trainer._integral_refresh = originals["refresh"]
        Trainer._reset_opacity = originals["reset"]
        Trainer.run = originals["run"]
        eval_mod.Evaluator.render_view = originals["render"]
    cfg, st = tr.cfg, tr.state
    hist, report = run_checks("dnerf", tr, pre, eval_dropped, launches)
    pass_its = [i for i in range(1, cfg.iterations + 1)
                if cfg.densify_from_iter < i < cfg.densify_until_iter
                and i % cfg.densification_interval == 0]
    its = [d["it"] for d in tr.densify_log]
    check(its == pass_its and len(its) == 16,
          f"dnerf: densify ran at {its}, expected {pass_its}")
    # one entry an iteration (a pass that overflows runs again after the
    # growth)
    sizes = sorted({i: size for i, size, _ in passes}.items())
    check(sizes == [(i, i > cfg.opacity_reset_interval) for i in pass_its]
          and sum(size for _, size in sizes) == 1,
          f"dnerf: the passes' size thresholds {sizes}")
    check(resets == [(cfg.opacity_reset_interval, 2)],
          f"dnerf: opacity resets (it, SH degree) {resets}, expected one at "
          f"{cfg.opacity_reset_interval} after the SH step to 2")
    check(tr.active_sh_degree == 2,
          f"dnerf: SH degree {tr.active_sh_degree} after {cfg.iterations}")
    refresh_its = [i for i in range(cfg.static_iteration + 1,
                                    cfg.iterations + 1) if i % 50 == 0]
    check(refreshes == refresh_its,
          f"dnerf: integral refreshes at {refreshes}, expected "
          f"{refresh_its}")
    a, b = 50, cfg.static_iteration
    static_its = (b - a) / (hist[b]["elapsed_s"] - hist[a]["elapsed_s"])
    c, e = cfg.static_iteration + 50, max(hist)
    dynamic_its = (e - c) / (hist[e]["elapsed_s"] - hist[c]["elapsed_s"])
    first, last = hist[1]["loss"], max(hist.items())[1]["loss"]
    densify_ms = [round(ms, 1) for _, _, ms in passes]
    log(f"dnerf: {cfg.iterations} iterations in {run_s:.1f} s "
        f"({static_its:.3f} it/s over iterations {a} to {b}, static; "
        f"{dynamic_its:.3f} it/s over {c} to {e}, dynamic), loss "
        f"{first:.5f} -> {last:.5f}; scene built in {built['scene']:.2f} s; "
        f"densify {tr.densify_log} in {densify_ms} ms (the pass at "
        f"{[i for i, s in sizes if s]} with the size threshold); opacity "
        f"reset (it, SH degree) {resets}; integral refreshes "
        f"{refreshes[0]}..{refreshes[-1]} ({len(refreshes)}); "
        f"{tr.n_alive()} points, capacity {st.alive.shape[0]}, "
        f"max_instances {pre['max_instances']} presized -> "
        f"{tr.rcfg.max_instances} (doublings {tr.overflows}); test PSNR "
        f"{pre['psnr_init']:.3f} at the start -> {report['PSNR']:.3f} (SH "
        f"degree {tr.active_sh_degree}); peak memory {peak_gib:.2f} GiB; "
        f"launches {launches}")

    # the checkpoint renders the test frame as the trainer's state does
    info = tr.scene.info
    cam = info.test_cameras[len(info.test_cameras) // 2]
    width, height = cam.width, cam.height
    bg = torch.ones(3, device=dev)
    rcfg, out = reload_check("dnerf", tr, cam, bg, dev)
    # run (c) holds its loaded state to this render of run (a)'s last one
    view = dict(cam=cam, rcfg=rcfg, sh_degree=cfg.sh_degree,
                **{k_: getattr(out, k_) for k_ in ("color", "depth",
                                                   "final_t")})
    del out

    res, same, test_main_s = check_test_main("dnerf", tr, dev)
    check(res["num_views"] == len(info.test_cameras),
          f"dnerf: test_main rendered {res['num_views']} views")
    log(f"dnerf: cli.test_main in {test_main_s:.1f} s: {json.dumps(res)}; "
        f"the trainer's eval of that state at SH {cfg.sh_degree} "
        + json.dumps({k_: same[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM")}))

    # K2, K1 and K3 on that view of the trained state, over white
    d, pre_frame = stage_frame(st.points, st.nets, st.alive, tr.mcfg,
                               tr.scene.fstatic, cam.raster_params(dev),
                               cam.timestamp, rcfg, width=width,
                               height=height)
    fk = frame_kernels("dnerf", d, pre_frame, rcfg.max_instances, bg, rcfg,
                       tk, timing, width=width, height=height)
    del d, pre_frame

    # train_step_core alone over 8 dynamic steps of the trained state, then
    # 3 with the stage marks
    step = core_step(tr, first_batch(tr), st.step + 1)
    core_ips, state = core_its("dnerf", step, st)
    with timing.record() as rec:
        for _ in range(3):
            state, m = step(state)
            check(m["bad_step"] == 0 and m["dropped"] == 0,
                  f"dnerf: a train_step_core step went wrong: {m}")
    stages = {k: v / 3 for k, v in rec.stages().items()}
    del state

    # the loader's decode: 800x800 RGBA PNG to 400x400 over white, a
    # batch; the busy share
    dec_ms = decode_ms(tr, 37, 11)
    busy_ms, traced_ms, busy = busy_share("dnerf", tr)
    log(f"dnerf: train_step_core alone {core_ips:.3f} it/s; ms per step by "
        "stage " + json.dumps({k: round(v, 3) for k, v in stages.items()})
        + f" (sum {sum(stages.values()):.2f}); loader decode "
        f"{dec_ms:.1f} ms a batch of {cfg.batch} ({full['width']}x"
        f"{full['height']} RGBA PNG -> {width}x{height}, {decoder}); {busy}")
    planes = [list(p.shape) for p in st.nets.field.planes]
    densify_log, overflows = tr.densify_log, tr.overflows
    sh_degree = tr.active_sh_degree
    n_points, capacity = tr.n_alive(), st.alive.shape[0]
    del tr, st
    torch.cuda.empty_cache()

    # ---- run (c): run (a) resumed from its checkpoint --------------------
    resume = dnerf_resume(root, model, config_file, view, dev, tk)
    del view
    torch.cuda.empty_cache()

    # ---- run (b): max_instances left at 65,536 ---------------------------
    doubling = dnerf_doubling(root, config_file, dev)

    phase_s = time.perf_counter() - t_phase
    signal.alarm(0)
    log(f"dnerf: the phase took {phase_s:.1f} s (limit {DNERF_LIMIT_S} s); "
        f"card {smi_line()}")
    return {
        "config": os.path.relpath(DNERF_CONFIG, HERE),
        "schedule": DNERF_SCHEDULE, "iterations": cfg.iterations,
        "batch": cfg.batch, "resolution": [width, height],
        "source": [full["width"], full["height"]], "planes": planes,
        "train_views": len(info.train_cameras),
        "test_views": len(info.test_cameras), "decoder": decoder,
        "scene_written": written["written"], "write_s": write_s,
        "build_s": built["scene"], "init_points": pre["init_points"],
        "run_s": run_s, "its_per_s_static_50_1000": static_its,
        "its_per_s_dynamic_1050_2100": dynamic_its,
        "train_step_core_its_per_s": core_ips, "stages_ms": stages,
        "decode_ms_per_batch": dec_ms, "densify_ms": densify_ms,
        "densify": densify_log, "size_thresholded": [i for i, s in sizes
                                                     if s],
        "resets": resets, "refreshes": len(refreshes), "sh_degree": sh_degree,
        "overflows": overflows,
        "max_instances": [pre["max_instances"], rcfg.max_instances],
        "points_final": n_points, "capacity": capacity,
        "loss_first": first, "loss_last": last,
        "psnr_init": pre["psnr_init"],
        "eval": {k_: report[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM")},
        "test_main": {k_: res[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM",
                                             "LPIPS-alex", "FPS")},
        "test_main_s": test_main_s, "peak_memory_gib": peak_gib,
        "card_busy_ms_per_it": busy_ms or None, "traced_ms_per_it": traced_ms,
        "launches": launches, "k4": pre["k4"], "frame": fk,
        "doubling": doubling, "resume": resume, "phase_s": phase_s}, launches


def dnerf_initial_checks(tr, timing):
    """Phase 16 on the trainer's initial state and the run's first batch:
    the init cloud equal to a numpy recount of the reader's
    RandomState(666) draw, every point alive, the capacity 262,144; two
    identical first steps equal to the bit, static (iteration 1) and
    dynamic (the stage of iteration 1,001), nothing dropped; K4 on the
    dynamic step's own grid gradients of the xy plane (64x64, 6 levels,
    5,461 cells) and the xt plane (64x128, 8,192 cells), both sorted in 2
    radix passes; the test views' PSNR.  Returns what the run is held
    to."""
    from saro_gs_torch import eval as eval_mod
    from tests import torch_dnerf_scene as dnerf
    pc = tr.scene.info.point_cloud
    pts, cols, times = dnerf.recount_random_init()
    check(np.array_equal(pc.points, pts) and np.array_equal(pc.colors, cols)
          and np.array_equal(pc.times, times),
          "dnerf: the init cloud differs from the numpy recount of "
          "RandomState(666)")
    alive, cap = tr.n_alive(), tr.state.alive.shape[0]
    check(alive == dnerf.INIT_POINTS and cap == tr.cfg.capacity == 262144,
          f"dnerf: {alive} points alive in {cap} rows")
    check(tr.active_sh_degree == 0, "dnerf: the run starts above SH 0")
    batch = first_batch(tr)
    ma, _ = same_two_steps("dnerf: first static step",
                           core_step(tr, batch, 1), tr.state)
    _, taps = same_two_steps(
        "dnerf: first dynamic step",
        core_step(tr, batch, tr.cfg.static_iteration + 1), tr.state)
    k4 = plane_k4("dnerf", taps, "at the first dynamic step", timing,
                  passes=2)
    del taps
    psnr = eval_mod.quick_test_report(tr, tr.scene.test_cameras(),
                                      histograms=False)["PSNR"]
    log(f"dnerf: init cloud of {pc.points.shape[0]} points equal to the "
        f"numpy recount; {alive} alive in {cap} rows; the initial state "
        f"renders the test views at {psnr:.3f} dB; max_instances "
        f"{tr.rcfg.max_instances} after the presize")
    return {"loss_step1": ma["loss"], "k4": k4, "psnr_init": psnr,
            "init_points": pc.points.shape[0], "capacity": cap,
            "max_instances": tr.rcfg.max_instances}


def dnerf_resume(root, model, config_file, view, dev, tk):
    """Phase 16's run (c): run (a) resumed through cli.train_main with
    --start_checkpoint (its checkpoint at 2,110) and --start_iteration
    2110 on the same model path, standup.json with DNERF_RESUME (2,310
    iterations, test and save at 2,310).  Checked: the loaded state at
    step 2,110 in max(capacity, next power of two) rows, rendering the
    check view equal to the bit to run (a)'s state (``view``); two
    identical first resumed steps equal to the bit; best_psnr seeded from
    2110_runtimeresults.json; no bad step; the passes at 2,200 and 2,300
    with the size threshold and their counts adding up; the SH degree 0
    from the start to 2,310 (it restarts at 0 and steps only at a
    multiple of 1,000, as in the JAX package); nothing dropped in a
    reported eval view; iteration_best replaced only by a better eval;
    every kernel launched in the run.  Returns the numbers, the kernels'
    launches over the run among them."""
    import torch
    from saro_gs_torch import cli, render
    from saro_gs_torch import eval as eval_mod
    from saro_gs_torch import scene as scene_mod
    from saro_gs_torch.train.trainer import Trainer
    start = DNERF_SCHEDULE["iterations"]
    ckpt = os.path.join(model, "point_cloud", f"iteration_{start}",
                        "point_cloud.ply")
    best_ply = os.path.join(model, "point_cloud", "iteration_best",
                            "point_cloud.ply")
    with open(os.path.join(model, f"{start}_runtimeresults.json")) as f:
        seed = json.load(f)["PSNR"]
    with open(best_ply, "rb") as f:
        best_before = f.read()
    cfg_path = config_file("standup_resume.json", DNERF_RESUME, model)
    pre, eval_dropped, eval_rerendered = {}, [], []
    originals = {"load": scene_mod.Scene.load_checkpoint, "run": Trainer.run,
                 "render": eval_mod.Evaluator.render_view}

    def load(self, path):
        torch.cuda.synchronize()
        t = time.perf_counter()
        originals["load"](self, path)
        torch.cuda.synchronize()
        pre["load_s"] = time.perf_counter() - t
        pre["rows"] = self.alive.shape[0]
        pre["points"] = int((self.alive > 0).sum())

    def run(self, *a, **k):
        if "loss_step1" not in pre:
            st = self.state
            check(st.step == start and self.best_psnr == seed
                  and self.active_sh_degree == 0,
                  f"dnerf (c): resumed at step {st.step}, best PSNR "
                  f"{self.best_psnr} (seed {seed}), SH degree "
                  f"{self.active_sh_degree}")
            out, _ = render.test_render(
                view["cam"].raster_params(dev), view["cam"].timestamp,
                st.points, st.nets, st.alive, self.mcfg,
                self.scene.fstatic, self.bg, width=view["cam"].width,
                height=view["cam"].height, sh_degree=view["sh_degree"],
                rcfg=view["rcfg"])
            check(out.num_dropped == 0
                  and all(torch.equal(getattr(out, k_), view[k_])
                          for k_ in ("color", "depth", "final_t")),
                  "dnerf (c): the loaded checkpoint renders differently from "
                  "run (a)'s state")
            m, _ = same_two_steps("dnerf (c): first resumed step",
                                  core_step(self, first_batch(self),
                                            start + 1), st)
            pre["loss_step1"] = m["loss"]
            tk.reset_launches()
            torch.cuda.synchronize()
        return originals["run"](self, *a, **k)

    def eval_render(self, *a, **k):
        n_before = len(self.rerendered)
        out = originals["render"](self, *a, **k)
        eval_dropped.append(out[0].num_dropped)
        eval_rerendered.append(len(self.rerendered) - n_before)
        return out
    scene_mod.Scene.load_checkpoint, Trainer.run = load, run
    eval_mod.Evaluator.render_view = eval_render
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", root, "--config", cfg_path, "-m", model,
                             "--device", str(dev), "--start_checkpoint",
                             ckpt, "--start_iteration", str(start),
                             "--quiet"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(tk.launches)
    finally:
        scene_mod.Scene.load_checkpoint = originals["load"]
        Trainer.run = originals["run"]
        eval_mod.Evaluator.render_view = originals["render"]
    cfg, st = tr.cfg, tr.state
    hist = {h["it"]: h for h in tr.history}
    check(st.step == cfg.iterations, f"dnerf (c): stopped at {st.step}")
    check(pre["rows"] == max(cfg.capacity,
                             1 << (pre["points"] - 1).bit_length()),
          f"dnerf (c): {pre['points']} points loaded into {pre['rows']} "
          "rows")
    check(st.bad_steps == 0 and not any("bad_step" in h for h in tr.history),
          f"dnerf (c): {st.bad_steps} bad steps")
    pass_its = [i for i in range(start + 1, cfg.iterations + 1)
                if cfg.densify_from_iter < i < cfg.densify_until_iter
                and i % cfg.densification_interval == 0]
    check([d["it"] for d in tr.densify_log] == pass_its == [2200, 2300],
          f"dnerf (c): densify ran at {[d['it'] for d in tr.densify_log]}")
    for d in tr.densify_log:
        check(d["after"] == d["before"] + d["cloned"] + d["split"]
              - d["pruned"], f"dnerf (c): densify counts do not add up: {d}")
    check(tr.active_sh_degree == 0,
          f"dnerf (c): SH degree {tr.active_sh_degree} at {cfg.iterations}")
    check(eval_dropped and not any(eval_dropped),
          f"dnerf (c): eval views reported with instances dropped: "
          f"{eval_dropped}")
    check(all(launches[k_] > 0 for k_ in launches),
          f"dnerf (c): a kernel never launched in the run: {launches}")
    with open(os.path.join(model,
                           f"{cfg.iterations}_runtimeresults.json")) as f:
        psnr = json.load(f)["PSNR"]
    with open(best_ply, "rb") as f:
        best_after = f.read()
    better = psnr >= seed
    check(tr.best_psnr == (psnr if better else seed)
          and (best_after != best_before) == better,
          f"dnerf (c): eval PSNR {psnr} against the seed {seed}: best PSNR "
          f"{tr.best_psnr}, iteration_best "
          f"{'replaced' if best_after != best_before else 'kept'}")
    a, b = min(hist), max(hist)
    its = (b - a) / (hist[b]["elapsed_s"] - hist[a]["elapsed_s"])
    log(f"dnerf (c): resumed from {ckpt} at {start}: {pre['points']} points "
        f"into {pre['rows']} rows, loaded in {pre['load_s']:.2f} s; "
        f"{cfg.iterations - start} iterations in {run_s:.1f} s ({its:.3f} "
        f"it/s over {a} to {b}); densify {tr.densify_log}; SH degree "
        f"{tr.active_sh_degree}; eval PSNR {psnr:.3f} against the seed "
        f"{seed:.3f} (iteration_best {'replaced' if better else 'kept'}); "
        f"eval views rendered again {sum(eval_rerendered)}; launches "
        f"{launches}")
    out = {"start": start, "iterations": cfg.iterations,
           "points": pre["points"], "rows": pre["rows"],
           "load_s": pre["load_s"], "run_s": run_s, "its_per_s": its,
           "its_range": [a, b], "loss_step1": pre["loss_step1"],
           "densify": tr.densify_log, "sh_degree": tr.active_sh_degree,
           "seed_psnr": seed, "eval_psnr": psnr, "best_replaced": better,
           "eval_rerendered": sum(eval_rerendered), "launches": launches}
    del tr, st
    return out


def dnerf_doubling(root, config_file, dev):
    """Phase 16's run (b): standup.json with DNERF_DOUBLING (no presize,
    max_instances 65,536, 100 iterations, all in the static stage) through
    cli.train_main.  Checked: no bad step; Trainer.overflows non-empty,
    every high-water mark > 0, each at an overflow check; the final
    max_instances 65,536 x 2^(doublings); every check after the last
    doubling reading nothing dropped (at least one); the last state
    rendering every training view (the static stage's render) at the
    final max_instances, dropping nothing.  Returns the numbers."""
    import torch
    from saro_gs_torch import cli, render
    from saro_gs_torch.train.trainer import Trainer
    model = os.path.join(DNERF_DIR, "model_doubling")
    shutil.rmtree(model, ignore_errors=True)
    cfg_path = config_file("standup_doubling.json", DNERF_DOUBLING, model)
    checks = []
    control = Trainer._density_control

    def density_control(self, it, stage):
        control(self, it, stage)
        # what the overflow check reads right after this call
        if it % self.cfg.overflow_check_every == 0:
            checks.append((it, int(self.state.dropped_hwm)))
    Trainer._density_control = density_control
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", root, "--config", cfg_path, "-m", model,
                             "--device", str(dev), "--quiet"])
        torch.cuda.synchronize()
    finally:
        Trainer._density_control = control
    run_s = time.perf_counter() - t0
    cfg, st = tr.cfg, tr.state
    start = DNERF_DOUBLING["max_instances"]
    check(st.step == cfg.iterations and not cfg.presize_instances,
          f"dnerf (b): stopped at {st.step}")
    check(st.bad_steps == 0 and not any("bad_step" in h for h in tr.history),
          f"dnerf (b): {st.bad_steps} bad steps")
    check(tr.overflows and all(type(h) is int and h > 0
                               for _, h in tr.overflows),
          f"dnerf (b): overflow doublings {tr.overflows}")
    check(tr.overflows == [c for c in checks if c[1] > 0],
          f"dnerf (b): doublings {tr.overflows} against the checks "
          f"{checks}")
    check(tr.rcfg.max_instances == start << len(tr.overflows),
          f"dnerf (b): max_instances {tr.rcfg.max_instances} after "
          f"{len(tr.overflows)} doublings of {start}")
    last = tr.overflows[-1][0]
    after = [h for i, h in checks if i > last]
    check(after and not any(after),
          f"dnerf (b): checks after the last doubling at {last}: {checks}")
    bg = torch.ones(3, device=dev)
    dropped = []
    with torch.no_grad():
        for cam in tr.scene.info.train_cameras:
            pkg = render.train_render(
                cam.raster_params(dev), cam.timestamp, st.points, st.nets,
                st.alive, tr.mcfg, tr.scene.fstatic, bg, width=cam.width,
                height=cam.height, stage="static", sh_degree=0,
                rcfg=tr.rcfg)
            dropped.append((pkg.out.num_dropped, pkg.out.num_instances))
    check(not any(d for d, _ in dropped),
          f"dnerf (b): the last state drops instances at max_instances "
          f"{tr.rcfg.max_instances}: {[d for d in dropped if d[0]]}")
    doublings = [(it, hwm, start << (k + 1))
                 for k, (it, hwm) in enumerate(tr.overflows)]
    hist = {h["it"]: h for h in tr.history}
    b = max(hist)
    its = (b - 50) / (hist[b]["elapsed_s"] - hist[50]["elapsed_s"])
    most = max(n for _, n in dropped)
    log(f"dnerf (b): {cfg.iterations} iterations from max_instances {start} "
        f"without a presize in {run_s:.1f} s ({its:.3f} it/s over 50 to "
        f"{b}); doublings (it, most dropped, new max_instances) "
        f"{doublings}; checks after the last one {after}; the last state "
        f"renders the {len(dropped)} training views with up to {most} "
        f"instances, none dropped; loss {hist[1]['loss']:.5f} -> "
        f"{hist[b]['loss']:.5f}")
    return {"iterations": cfg.iterations, "start": start,
            "doublings": doublings, "checks": checks,
            "max_instances": tr.rcfg.max_instances,
            "views_most_instances": most, "its_per_s_50_on": its,
            "run_s": run_s, "loss_first": hist[1]["loss"],
            "loss_last": hist[b]["loss"]}


def hypernerf_phase(dev, tk, timing):
    """Phase 19: the HyperNeRF training mode on the card.
    configs/dnerf/standup.json's model and training settings with
    HYPERNERF_SCHEDULE's keys (and the paths) changed: the hypernerf
    reader at resolution 2 on black, duration 100, 610 of 20,000
    iterations, static until 300, densify from 200 every 100 (passes at
    300, 400, 500 and 600), test and save at 610; through cli.train_main
    and cli.test_main.  Everything else is the file's or the defaults:
    batch 4, planes 64^3 x 128 of 32 channels, densify 5, capacity
    262,144, max_instances presized.  The scene is
    tests/torch_hypernerf_scene.py's vrig layout, written under
    build/chip_smoke_hypernerf/ (100 time steps x 2 rig cameras at
    536x960, a points.npy of 20,000 points).  Returns (the "hypernerf"
    results, the kernels' launches over the run)."""
    import signal

    import torch
    from saro_gs_torch import cli, native
    from saro_gs_torch import eval as eval_mod
    from saro_gs_torch import scene as scene_mod
    from saro_gs_torch.train.trainer import Trainer
    from tests import torch_hypernerf_scene as vrig

    def over_time(signum, frame):
        print(f"[chip_smoke] FAIL: hypernerf: the phase ran past its "
              f"{HYPERNERF_LIMIT_S} s", file=sys.stderr, flush=True)
        stop_children()
        os._exit(1)
    signal.signal(signal.SIGALRM, over_time)
    signal.alarm(HYPERNERF_LIMIT_S)

    def sync():
        torch.cuda.synchronize()

    t_phase = t0 = time.perf_counter()
    decoder = image_decoder(native)
    root = os.path.join(HYPERNERF_DIR, "scene")
    written = vrig.write_hypernerf_scene(root, dev)
    sync()
    write_s = time.perf_counter() - t0
    full = vrig.FULL
    log(f"hypernerf: vrig layout of {full['steps']} time steps x 2 cameras "
        f"at {full['width'] // vrig.RATIO}x{full['height'] // vrig.RATIO} "
        f"(rgb/{vrig.RATIO}x of {full['width']}x{full['height']}) "
        f"{'written' if written['written'] else 'reused'} in {write_s:.1f} "
        f"s under {root}; image decode {decoder}")

    model = os.path.join(HYPERNERF_DIR, "model")
    shutil.rmtree(model, ignore_errors=True)
    with open(HYPERNERF_CONFIG) as f:
        config = json.load(f)
    config.update(HYPERNERF_SCHEDULE, source_path=root, model_path=model)
    cfg_path = os.path.join(HYPERNERF_DIR, "standup_hypernerf_610.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)

    # wrapped for the run: the scene build timed, each densify pass timed,
    # eval renders' drops, the checks on the initial state
    built, passes, eval_dropped, pre = {}, [], [], {}
    originals = {"scene": scene_mod.Scene.__init__,
                 "_densify": Trainer._densify, "run": Trainer.run,
                 "render": eval_mod.Evaluator.render_view}

    def scene_init(self, *a, **k):
        sync()
        t = time.perf_counter()
        originals["scene"](self, *a, **k)
        sync()
        built.setdefault("scene", time.perf_counter() - t)

    def densify(self, size):
        sync()
        t = time.perf_counter()
        out = originals["_densify"](self, size)
        sync()
        passes.append(round((time.perf_counter() - t) * 1e3, 1))
        return out

    def eval_render(self, *a, **k):
        # a view as the eval reports it, after any render at a larger
        # capacity
        out = originals["render"](self, *a, **k)
        eval_dropped.append(out[0].num_dropped)
        return out

    def run(self, *a, **k):
        if not pre:
            pre.update(hypernerf_initial_checks(self, timing, root))
            tk.reset_launches()
            sync()
            torch.cuda.reset_peak_memory_stats()
        return originals["run"](self, *a, **k)
    scene_mod.Scene.__init__, Trainer._densify = scene_init, densify
    Trainer.run, eval_mod.Evaluator.render_view = run, eval_render
    t0 = time.perf_counter()
    try:
        tr = cli.train_main(["-s", root, "--config", cfg_path, "-m", model,
                             "--device", str(dev)])
        sync()
        run_s = time.perf_counter() - t0
        launches = dict(tk.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        scene_mod.Scene.__init__ = originals["scene"]
        Trainer._densify = originals["_densify"]
        Trainer.run = originals["run"]
        eval_mod.Evaluator.render_view = originals["render"]
    cfg, st = tr.cfg, tr.state
    hist, report = run_checks("hypernerf", tr, pre, eval_dropped, launches)
    its = [d["it"] for d in tr.densify_log]
    check(its == [300, 400, 500, 600],
          f"hypernerf: densify ran at {its}, expected 300 to 600")
    a, b = 50, cfg.static_iteration
    static_its = (b - a) / (hist[b]["elapsed_s"] - hist[a]["elapsed_s"])
    c, e = cfg.static_iteration + 50, max(hist)
    dynamic_its = (e - c) / (hist[e]["elapsed_s"] - hist[c]["elapsed_s"])
    first, last = hist[1]["loss"], max(hist.items())[1]["loss"]
    log(f"hypernerf: {cfg.iterations} iterations in {run_s:.1f} s "
        f"({static_its:.3f} it/s over iterations {a} to {b}, static; "
        f"{dynamic_its:.3f} it/s over {c} to {e}, dynamic), loss "
        f"{first:.5f} -> {last:.5f}; scene built in {built['scene']:.2f} s; "
        f"densify {tr.densify_log} in {passes} ms; {tr.n_alive()} points, "
        f"capacity {st.alive.shape[0]}, max_instances "
        f"{pre['max_instances']} presized -> {tr.rcfg.max_instances} "
        f"(doublings {tr.overflows}); test PSNR {pre['psnr_init']:.3f} at "
        f"the start -> {report['PSNR']:.3f} (SH degree "
        f"{tr.active_sh_degree}); peak memory {peak_gib:.2f} GiB; launches "
        f"{launches}")

    # (e) the checkpoint and cli.test_main
    info = tr.scene.info
    cam = info.test_cameras[len(info.test_cameras) // 2]
    bg = torch.zeros(3, device=dev)
    rcfg, _ = reload_check("hypernerf", tr, cam, bg, dev)
    res, same, test_main_s = check_test_main("hypernerf", tr, dev)
    check(res["num_views"] == len(info.test_cameras),
          f"hypernerf: test_main rendered {res['num_views']} views")
    log(f"hypernerf: cli.test_main in {test_main_s:.1f} s: "
        f"{json.dumps(res)}; the trainer's eval of that state at SH "
        f"{cfg.sh_degree} "
        + json.dumps({k_: same[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM")}))

    # (d) K2, K1 and K3 on that view of the trained state, on black
    d, pre_frame = stage_frame(st.points, st.nets, st.alive, tr.mcfg,
                               tr.scene.fstatic, cam.raster_params(dev),
                               cam.timestamp, rcfg, width=cam.width,
                               height=cam.height)
    fk = frame_kernels("hypernerf", d, pre_frame, rcfg.max_instances, bg,
                       rcfg, tk, timing, width=cam.width, height=cam.height)
    del d, pre_frame

    # train_step_core alone over 8 dynamic steps of the trained state; the
    # loader's decode of 536x960 RGB PNGs; the busy share
    its_core, _ = core_its("hypernerf",
                           core_step(tr, first_batch(tr), st.step + 1), st)
    dec_ms = decode_ms(tr, 23, 11)
    busy_ms, traced_ms, busy = busy_share("hypernerf", tr)
    log(f"hypernerf: train_step_core alone {its_core:.3f} it/s; loader "
        f"decode {dec_ms:.1f} ms a batch of {cfg.batch} ({cam.width}x"
        f"{cam.height} RGB PNG, {decoder}); {busy}")

    phase_s = time.perf_counter() - t_phase
    signal.alarm(0)
    log(f"hypernerf: the phase took {phase_s:.1f} s (limit "
        f"{HYPERNERF_LIMIT_S} s); card {smi_line()}")
    return {
        "config": os.path.relpath(HYPERNERF_CONFIG, HERE),
        "schedule": HYPERNERF_SCHEDULE, "iterations": cfg.iterations,
        "batch": cfg.batch, "resolution": [cam.width, cam.height],
        "capture": [full["width"], full["height"]],
        "planes": [list(p.shape) for p in st.nets.field.planes],
        "train_views": len(info.train_cameras),
        "test_views": len(info.test_cameras), "decoder": decoder,
        "scene_written": written["written"], "write_s": write_s,
        "build_s": built["scene"], "init_points": pre["init_points"],
        "cameras_off_recount": pre["cameras"], "run_s": run_s,
        "its_per_s_static_50_300": static_its,
        "its_per_s_dynamic_350_600": dynamic_its,
        "train_step_core_its_per_s": its_core,
        "decode_ms_per_batch": dec_ms, "densify_ms": passes,
        "densify": tr.densify_log, "overflows": tr.overflows,
        "max_instances": [pre["max_instances"], rcfg.max_instances],
        "points_final": tr.n_alive(), "capacity": st.alive.shape[0],
        "loss_first": first, "loss_last": last,
        "psnr_init": pre["psnr_init"],
        "eval": {k_: report[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM")},
        "test_main": {k_: res[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM",
                                             "LPIPS-alex", "FPS")},
        "test_main_s": test_main_s, "peak_memory_gib": peak_gib,
        "card_busy_ms_per_it": busy_ms or None, "traced_ms_per_it": traced_ms,
        "launches": launches, "k4": pre["k4"], "frame": fk,
        "phase_s": phase_s}, launches


def hypernerf_initial_checks(tr, timing, root):
    """Phase 19 on the trainer's initial state and the run's first batch:
    (a) 100 train and 100 test cameras whose FoVs, centres, sizes and
    timestamps agree with the numpy recount of the layout's JSON files
    (the train split camera 0's, the test split camera 1's), both rig
    cameras of a time step at one timestamp, the init cloud
    points.npy's (t 0.5, grey), every point alive in 262,144 rows;
    (b) two identical first steps equal to the bit, static (iteration 1)
    and dynamic (the stage of iteration 301), nothing dropped, and K4 on
    the dynamic step's own grid gradients of the xy plane (64x64, 6
    levels, 5,461 cells) and the xt plane (64x128, 8,192 cells), both
    sorted in 2 radix passes; the test views' PSNR.  Returns what the run
    is held to."""
    from saro_gs_torch import eval as eval_mod
    from tests import torch_hypernerf_scene as vrig
    info = tr.scene.info
    recount = vrig.recount_cameras(root)
    steps = vrig.FULL["steps"]
    size = (vrig.FULL["width"] // vrig.RATIO,
            vrig.FULL["height"] // vrig.RATIO)
    worst = {"fov": 0.0, "centre": 0.0}
    for split, cams in (("train", info.train_cameras),
                        ("test", info.test_cameras)):
        rc = recount[split]
        check(len(cams) == len(rc) == steps,
              f"hypernerf: {len(cams)} {split} cameras, {len(rc)} in the "
              f"recount")
        for cam, r in zip(cams, rc):
            check(cam.image_name == r["id"] and (cam.width, cam.height)
                  == (r["width"], r["height"]) == size
                  and cam.timestamp == r["timestamp"],
                  f"hypernerf: {split} camera {cam.image_name} ({cam.width}x"
                  f"{cam.height}, t {cam.timestamp}) against the recount "
                  f"{r['id']} ({r['width']}x{r['height']}, t "
                  f"{r['timestamp']})")
            worst["fov"] = max(worst["fov"], abs(cam.fovx - r["fovx"]),
                               abs(cam.fovy - r["fovy"]))
            worst["centre"] = max(worst["centre"], float(np.abs(
                cam.camera_center - r["centre"]).max()))
    check(worst["fov"] <= 1e-6 and worst["centre"] <= 1e-5,
          f"hypernerf: cameras off the recount by {worst} (limits 1e-6 "
          "rad, 1e-5)")
    check([c.timestamp for c in info.train_cameras]
          == [c.timestamp for c in info.test_cameras]
          == [t / (steps - 1) for t in range(steps)],
          "hypernerf: the rig cameras of a time step differ in timestamp")
    pc = info.point_cloud
    pts, cols, times = vrig.recount_init_cloud(root)
    check(np.array_equal(pc.points, pts) and np.array_equal(pc.colors, cols)
          and np.array_equal(pc.times, times),
          "hypernerf: the init cloud differs from points.npy at t 0.5, "
          "grey")
    alive, cap = tr.n_alive(), tr.state.alive.shape[0]
    check(alive == vrig.FULL["points"] and cap == tr.cfg.capacity == 262144,
          f"hypernerf: {alive} points alive in {cap} rows")
    check(tr.active_sh_degree == 0, "hypernerf: the run starts above SH 0")
    batch = first_batch(tr)
    ma, _ = same_two_steps("hypernerf: first static step",
                           core_step(tr, batch, 1), tr.state)
    _, taps = same_two_steps(
        "hypernerf: first dynamic step",
        core_step(tr, batch, tr.cfg.static_iteration + 1), tr.state)
    k4 = plane_k4("hypernerf", taps, "at the first dynamic step", timing,
                  passes=2)
    del taps
    psnr = eval_mod.quick_test_report(tr, tr.scene.test_cameras(),
                                      histograms=False)["PSNR"]
    log(f"hypernerf: {len(info.train_cameras)} train and "
        f"{len(info.test_cameras)} test cameras at {size[0]}x{size[1]} "
        f"equal to the recount (FoV within {worst['fov']:.3g} rad, centres "
        f"within {worst['centre']:.3g}); init cloud of {pc.points.shape[0]} "
        f"points equal to points.npy at t 0.5, grey; {alive} alive in {cap} "
        f"rows; the initial state renders the test views at {psnr:.3f} dB; "
        f"max_instances {tr.rcfg.max_instances} after the presize")
    return {"loss_step1": ma["loss"], "k4": k4, "psnr_init": psnr,
            "init_points": pc.points.shape[0], "capacity": cap,
            "max_instances": tr.rcfg.max_instances, "cameras": worst}


def turned_c2w(c2w, degrees):
    """``c2w`` turned about the world's z axis through the camera's
    centre."""
    a = math.radians(degrees)
    rz = np.array([[math.cos(a), -math.sin(a), 0.0],
                   [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    out = np.array(c2w, dtype=float)
    out[:3, :3] = rz @ out[:3, :3]
    return out


def eight_bit(img):
    """A [3, H, W] image in [0, 1] as uint8 ground truth."""
    import torch
    return (torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()


def eval_capacity_phase(cfg, mcfg, params, nets, alive, fstatic, info, dev,
                        tk):
    """Phase 17: the eval's instance capacity on the arena checkpoint at
    1352x1014.  Evaluator.render_set over phase 11's test view, led by
    ring camera 0 turned by EVAL_TURN_DEG about the world's z axis (few
    Gaussians in view; its ground truth its own render): the probe sizes
    the capacity from the turned view, the test view needs more and is
    rendered again at a capacity that holds it.  Checked: at least one
    view rendered again; every reported view with nothing dropped; each
    re-rendered view's image, depth and final T equal to the bit to the
    view rendered alone at the final capacity, and its reported PSNR that
    render's; K2 and K1 launched by every render.  Returns (the numbers,
    the kernels' launches over render_set)."""
    import types

    import torch
    from saro_gs_torch import eval as eval_mod
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.train import losses
    t_phase = time.perf_counter()
    with torch.no_grad():
        feat = gm.field_feat(params, nets, mcfg, fstatic)
    test = info.test_cameras[0]
    turned = dataclasses.replace(
        cameras.camera_from_c2w(turned_c2w(cameras.ring_cameras(N_CAMS)[0],
                                           EVAL_TURN_DEG), 0.85, W, H,
                                test.timestamp),
        uid=N_CAMS, image_name=f"turned_{EVAL_TURN_DEG:g}")
    ecfg = dataclasses.replace(cfg, model_path=EVAL_DIR)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    scene = types.SimpleNamespace(device=dev, fstatic=fstatic)
    sh_degree = mcfg.sh_degree
    with torch.no_grad():
        out, _ = eval_mod.Evaluator(ecfg, scene, max_instances=1 << 22) \
            .render(turned, params, nets, alive, feat, sh_degree)
    check(out.num_dropped == 0, "eval capacity: the turned view dropped")
    # the ground truth as 8-bit images (phase 11's test view holds its
    # render unrounded): the metrics stay finite
    turned.set_image(eight_bit(out.color))
    test = dataclasses.replace(test)
    test.set_image(eight_bit(torch.as_tensor(test.load_image())))
    views = [turned, test]
    calls, reported, truncated = [], {}, {}
    render, render_view = (eval_mod.Evaluator.render,
                           eval_mod.Evaluator.render_view)

    def counted(self, cam, *a, **k):
        before = dict(tk.launches)
        got = render(self, cam, *a, **k)
        calls.append((cam.image_name, self.rcfg.max_instances,
                      got[0].num_instances, got[0].num_dropped,
                      {k_: tk.launches[k_] - before[k_]
                       for k_ in ("expand", "forward")}))
        if got[0].num_dropped:
            # what a report of the truncated render would say
            gt = torch.as_tensor(cam.load_image(ecfg.white_background),
                                 device=dev)
            truncated[cam.image_name] = float(losses.psnr(
                torch.clamp(got[0].color, 0, 1), gt))
        return got

    def checked(self, cam, *a, **k):
        got = render_view(self, cam, *a, **k)
        reported[cam.image_name] = (got[0].num_dropped, {
            k_: getattr(got[0], k_).clone()
            for k_ in ("color", "depth", "final_t")})
        return got
    eval_mod.Evaluator.render = counted
    eval_mod.Evaluator.render_view = checked
    tk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ev = eval_mod.Evaluator(ecfg, scene)
        res = ev.render_set("test", views, params, nets, alive,
                            iteration="capacity")
        torch.cuda.synchronize()
        set_s = time.perf_counter() - t0
        launches = dict(tk.launches)
    finally:
        eval_mod.Evaluator.render = render
        eval_mod.Evaluator.render_view = render_view
    names = [c.image_name for c in views]
    check(list(reported) == names
          and not any(d for d, _ in reported.values()),
          f"eval capacity: views reported with instances dropped: "
          f"{[(k_, d) for k_, (d, _) in reported.items()]}")
    check(ev.rerendered and test.image_name in [r[0] for r in ev.rerendered],
          f"eval capacity: no view rendered again ({calls})")
    check(all(c[4]["expand"] >= 1 and c[4]["forward"] >= 1 for c in calls),
          f"eval capacity: a render launched no K2 or K1: {calls}")
    final = ev.rcfg.max_instances
    with open(os.path.join(EVAL_DIR, "capacity_runtimeperview.json")) as f:
        psnrs = {names[int(i)]: v for i, v in json.load(f)["PSNR"].items()}
    alone_ms = {}
    for name, dropped, old, new in ev.rerendered:
        cam = views[names.index(name)]
        alone = eval_mod.Evaluator(ecfg, scene, max_instances=final)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = alone.render(cam, params, nets, alive, feat, sh_degree)
        torch.cuda.synchronize()
        alone_ms[name] = (time.perf_counter() - t0) * 1e3
        got = reported[name][1]
        check(out.num_dropped == 0
              and all(torch.equal(getattr(out, k_), got[k_])
                      for k_ in ("color", "depth", "final_t")),
              f"eval capacity: {name} rendered again differs from its "
              f"render alone at {final}")
        gt = torch.as_tensor(cam.load_image(ecfg.white_background),
                             device=dev)
        psnr = float(losses.psnr(torch.clamp(out.color, 0, 1), gt))
        check(psnrs[name] == psnr,
              f"eval capacity: {name}'s reported PSNR {psnrs[name]}, its "
              f"render alone {psnr}")
    phase_s = time.perf_counter() - t_phase
    log(f"eval capacity: render_set over {names}: renders (view, "
        f"max_instances, instances, dropped, K2/K1 launches) {calls}; "
        f"rendered again (view, dropped, capacity -> new) {ev.rerendered}; "
        f"every reported view whole, each re-rendered one equal to the bit "
        f"to its render alone at {final} ({alone_ms} ms); PSNR {psnrs} "
        f"(the truncated renders: {truncated}); "
        f"render_set {set_s:.2f} s, the phase {phase_s:.1f} s; launches "
        f"{launches}")
    return {"views": names, "turn_deg": EVAL_TURN_DEG,
            "renders": [list(c[:4]) for c in calls],
            "rerendered": [list(r) for r in ev.rerendered],
            "max_instances": final, "psnr": psnrs,
            "psnr_truncated": truncated,
            "report": {k_: res[k_] for k_ in ("PSNR", "SSIM", "MS-SSIM",
                                              "LPIPS-alex")},
            "alone_ms": alone_ms, "render_set_s": set_s,
            "phase_s": phase_s, "launches": launches}, launches


def n3d_initial_checks(tr, recount, preprocessed, root):
    """Phase 15 on the trainer's initial state: (a) the scene: 570 cameras
    (540 train, 30 test), their centres the poses_bounds.npy centres
    within 1e-5, 300 val cameras, the merged cloud and the counts after
    the preprocess and the CLI's prune equal to the numpy recount; (b) two
    identical first steps equal to the bit; the test views' PSNR.  Returns
    what the run is held to."""
    from saro_gs_torch import eval as eval_mod
    from tests import torch_n3d_scene as n3d
    info = tr.scene.info
    n_cams = len(info.train_cameras) + len(info.test_cameras)
    frames = tr.cfg.duration
    check((len(info.train_cameras), len(info.test_cameras),
           len(info.val_cameras)) == ((n3d.N3D_CAMS - 1) * frames, frames,
                                      300),
          f"neural3d: {len(info.train_cameras)} train, "
          f"{len(info.test_cameras)} test, {len(info.val_cameras)} val "
          "cameras")
    pb = np.load(os.path.join(root, "poses_bounds.npy"))
    centers = pb[:, :15].reshape(-1, 3, 5)[:, :, 3]
    err = max(float(np.abs(c.camera_center - centers[int(c.image_name[3:])])
                    .max()) for c in info.train_cameras + info.test_cameras)
    check(err <= 1e-5, f"neural3d: camera centres off poses_bounds by {err}")
    merged, alive = info.point_cloud.points.shape[0], tr.n_alive()
    check((merged, preprocessed, alive) == recount,
          f"neural3d: merged cloud, points after preprocesspoints 31 and "
          f"after the z prune {(merged, preprocessed, alive)}, the numpy "
          f"recount {recount}")
    cap = tr.state.alive.shape[0]
    check(cap == max(tr.cfg.capacity, 1 << (preprocessed - 1).bit_length()),
          f"neural3d: capacity {cap} for {preprocessed} points")
    ma, _ = same_two_steps("neural3d: first step",
                           core_step(tr, first_batch(tr), 1), tr.state)
    psnr = eval_mod.quick_test_report(tr, tr.scene.test_cameras(),
                                      histograms=False)["PSNR"]
    log(f"neural3d: {n_cams} cameras and {len(info.val_cameras)} val "
        f"cameras, centres within "
        f"{err:.3g} of poses_bounds.npy; merged cloud {merged}; "
        f"{preprocessed} after preprocesspoints 31, {alive} after the z "
        f"prune (the recount {recount}); capacity {cap}; the initial state "
        f"renders the test "
        f"views at {psnr:.3f} dB; max_instances {tr.rcfg.max_instances} "
        f"after the presize")
    return {"loss_step1": ma["loss"], "psnr_init": psnr,
            "alive_start": alive, "capacity": cap,
            "max_instances": tr.rcfg.max_instances}


def run_checks(label, tr, pre, eval_dropped, launches):
    """What a trainer phase holds its run through cli.train_main to: the
    last iteration reached, no bad step, iteration 1's logged loss the
    checked first step's (``pre["loss_step1"]``), each densify pass's
    counts adding up, the overflow doublings accounting for the final
    max_instances (a view that dropped instances doubles it at the next
    check), no reported eval view with instances dropped, every kernel
    launched, the test PSNR at the end above the initial state's.
    Returns (the history by iteration, the eval report at the end)."""
    cfg, st = tr.cfg, tr.state
    hist = {h["it"]: h for h in tr.history}
    check(st.step == cfg.iterations, f"{label}: stopped at {st.step}")
    check(st.bad_steps == 0 and not any("bad_step" in h for h in tr.history),
          f"{label}: {st.bad_steps} bad steps")
    check(hist[1]["loss"] == pre["loss_step1"],
          f"{label}: iteration 1 logged loss {hist[1]['loss']}, the checked "
          f"first step {pre['loss_step1']}")
    for d in tr.densify_log:
        check(d["after"] == d["before"] + d["cloned"] + d["split"]
              - d["pruned"], f"{label}: densify counts do not add up: {d}")
    check(all(hwm > 0 for _, hwm in tr.overflows)
          and tr.rcfg.max_instances
          == pre["max_instances"] << len(tr.overflows),
          f"{label}: overflow doublings {tr.overflows} do not account for "
          f"max_instances {pre['max_instances']} -> {tr.rcfg.max_instances}")
    check(eval_dropped and not any(eval_dropped),
          f"{label}: eval views reported with instances dropped: "
          f"{eval_dropped}")
    check(all(launches[k] > 0 for k in launches),
          f"{label}: a kernel never launched in the run: {launches}")
    with open(os.path.join(cfg.model_path,
                           f"{cfg.iterations}_runtimeresults.json")) as f:
        report = json.load(f)
    check(report["PSNR"] > pre["psnr_init"],
          f"{label}: test PSNR {report['PSNR']} at {cfg.iterations}, "
          f"{pre['psnr_init']} from the initial state")
    return hist, report


def reload_check(label, tr, cam, bg, dev):
    """The checkpoint of the run's last iteration, loaded through Scene,
    renders ``cam`` at its size as the trainer's final state does: colour,
    depth and final T equal to the bit, nothing dropped.  Returns (the
    raster config of that render, the state's render)."""
    import torch
    from saro_gs_torch import render
    from saro_gs_torch import scene as scene_mod
    cfg, st = tr.cfg, tr.state
    loaded = scene_mod.Scene(cfg, load_iteration=str(cfg.iterations),
                             device=dev)
    rcfg = cfg.raster_config()._replace(max_instances=tr.rcfg.max_instances)
    outs = []
    for p, n_, al, fs in ((st.points, st.nets, st.alive, tr.scene.fstatic),
                          (loaded.params, loaded.nets, loaded.alive,
                           loaded.fstatic)):
        out, _ = render.test_render(cam.raster_params(dev), cam.timestamp, p,
                                    n_, al, tr.mcfg, fs, bg, width=cam.width,
                                    height=cam.height,
                                    sh_degree=cfg.sh_degree, rcfg=rcfg)
        check(out.num_dropped == 0, f"{label}: the check render dropped")
        outs.append(out)
    check(all(torch.equal(getattr(outs[0], k), getattr(outs[1], k))
              for k in ("color", "depth", "final_t")),
          f"{label}: the reloaded checkpoint renders differently")
    log(f"{label}: checkpoint {cfg.iterations} ({loaded.alive.shape[0]} "
        f"rows) renders test view {cam.image_name} at t {cam.timestamp:.4f} "
        "as the trainer's state does, to the bit")
    return rcfg, outs[0]


def check_test_main(label, tr, dev):
    """cli.test_main of the run's last checkpoint against the trainer's
    eval of the same state at test_main's SH degree (the trainer's own
    eval renders at the active one): PSNR, SSIM and MS-SSIM within 1e-6.
    Returns (test_main's report, the eval's, test_main's seconds)."""
    import torch
    from saro_gs_torch import cli
    from saro_gs_torch import eval as eval_mod
    cfg = tr.cfg
    sh_now, tr.active_sh_degree = tr.active_sh_degree, cfg.sh_degree
    same = eval_mod.quick_test_report(tr, tr.scene.test_cameras(),
                                      histograms=False)
    tr.active_sh_degree = sh_now
    t0 = time.perf_counter()
    res = cli.test_main(["-m", cfg.model_path, "--iteration",
                         str(cfg.iterations), "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for key in ("PSNR", "SSIM", "MS-SSIM"):
        check(abs(res[key] - same[key]) <= 1e-6 * abs(same[key]),
              f"{label}: test_main's {key} {res[key]} against the trainer's "
              f"eval {same[key]}")
    return res, same, secs


def core_its(label, step, state, n=8):
    """train_step_core alone: a warm-up step from a copy of ``state``, then
    ``n`` timed, none bad or dropping.  Returns (it/s, the last state)."""
    import torch
    from saro_gs_torch.train import step as step_mod

    def core(s):
        s, m = step(s)
        check(m["bad_step"] == 0 and m["dropped"] == 0,
              f"{label}: a train_step_core step went wrong: {m}")
        return s
    state = core(step_mod.clone_state(state))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state = core(state)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), state


def decode_ms(tr, stride, shift):
    """The loader's decode in the calling thread, ms a batch over 5
    batches: views (stride * k + shift * i) mod the training views, for
    k < batch, of batch i."""
    loader = tr.scene.train_loader(tr.cfg.batch, num_workers=1)
    n_train = len(tr.scene.info.train_cameras)
    try:
        t0 = time.perf_counter()
        for i in range(5):
            loader._load_batch((np.arange(tr.cfg.batch) * stride + i * shift)
                               % n_train)
        return (time.perf_counter() - t0) * 1e3 / 5
    finally:
        loader.close()


def busy_share(label, tr):
    """5 more iterations of the trainer's loop under torch.profiler, none
    bad or dropping.  Returns the card's busy ms and the wall ms an
    iteration, and those words for a log line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(max_iterations=tr.cfg.iterations + 5, log_every=10 ** 6)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / 5
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / 5
    check(tr.state.bad_steps == 0 and tr.state.dropped_hwm == 0,
          f"{label}: the traced iterations went wrong")
    words = (f"card busy {busy_ms:.2f} ms of {traced_ms:.2f} ms an iteration "
             "under the profiler "
             + (f"({100 * busy_ms / traced_ms:.1f}%)" if busy_ms > 0 else
                "(no device time reported: not measured)"))
    return busy_ms, traced_ms, words


def first_batch(tr):
    """The run's first batch (the loader's seed) on the card."""
    loader = tr.scene.train_loader(tr.cfg.batch, num_workers=2,
                                   seed=tr.cfg.seed)
    try:
        return tr._to_device(next(iter(loader)))
    finally:
        loader.close()


def core_step(tr, batch, it):
    """step(state): train_step_core on ``batch`` as the trainer runs
    iteration ``it`` (stage, integral flag, SH mask)."""
    from saro_gs_torch.train import step as step_mod
    cams_b, gt_b, ts_b = batch

    def step(state):
        return step_mod.train_step_core(
            state, cams_b, gt_b, ts_b, tr.bg, tr.scene.fstatic,
            tr._statics(), stage=tr.stage_at(it), sh_degree=tr.cfg.sh_degree,
            scale_integral=tr.integral_flags(it)[1],
            sh_mask=tr._sh_mask(tr.active_sh_degree))
    return step


def state_leaves(state):
    from saro_gs_torch.train import step as step_mod
    return (step_mod.param_leaves(state.points, state.nets)
            + state.opt.mu + state.opt.nu + list(state.aux))


def same_two_steps(label, step, state0):
    """Two steps from copies of ``state0``: equal to the bit, nothing
    dropped, no bad step.  Returns the first one's metrics and the grid
    gradients its backward hands K4 (``grid_taps``)."""
    import torch
    from saro_gs_torch.train import step as step_mod
    (sa, ma), taps = grid_taps(step_mod.clone_state(state0), step)
    sb, mb = step(step_mod.clone_state(state0))
    torch.cuda.synchronize()
    check(ma == mb, f"{label}: two identical steps report differently: "
          f"{ma} vs {mb}")
    check(ma["bad_step"] == 0 and ma["dropped"] == 0,
          f"{label}: the step went wrong: {ma}")
    leaves_a, leaves_b = state_leaves(sa), state_leaves(sb)
    for k, (x, y) in enumerate(zip(leaves_a, leaves_b)):
        check(torch.equal(x, y), f"{label}: leaf {k} differs between two "
              "identical steps")
    log(f"{label}: two identical steps from one state are equal to the bit "
        f"({len(leaves_a)} tensors); loss {ma['loss']:.6f}")
    return ma, taps


def grid_taps(state, step):
    """step(state), with the grid gradients its backward hands K4 kept:
    (its result, {plane index: (coords, level, dfeat, h, w, n_levels)}); a
    plane's call is known by its coordinates."""
    import torch
    from saro_gs_torch.ops import grid_scatter, mip
    planes = {p.data_ptr(): i for i, p in enumerate(state.nets.field.planes)}
    sampled, taps = [], {}
    sample, scatter = mip.sample_mip, grid_scatter.scatter_mip_taps

    def sample_rec(grid, coords, level, max_level):
        sampled.append((planes[grid.data_ptr()], coords))
        return sample(grid, coords, level, max_level)

    def scatter_rec(coords, level, dfeat, h, w, n_levels):
        i, = [i for i, c in sampled if torch.equal(c, coords)]
        taps[i] = (coords.clone(), None if level is None else level.clone(),
                   dfeat.clone(), h, w, n_levels)
        return scatter(coords, level, dfeat, h, w, n_levels)
    mip.sample_mip, grid_scatter.scatter_mip_taps = sample_rec, scatter_rec
    try:
        return step(state), taps
    finally:
        mip.sample_mip, grid_scatter.scatter_mip_taps = sample, scatter


def plane_k4(label, taps, when, timing, passes=3):
    """K4 (k4_check) on the xy and xt planes' grid gradients of one step,
    each sorted in ``passes`` radix passes."""
    from saro_gs_torch.models import field as field_mod
    k4 = {}
    for name in ("xy", "xt"):
        a, b = "xyzt".index(name[0]), "xyzt".index(name[1])
        i = field_mod.COMBS.index((a, b))
        check(i in taps, f"{label}: no grid gradient for plane {name}")
        coords, lvl, df, h, w, n_lv = taps[i]
        k4[name] = k4_check(f"plane {name} {when}", coords, lvl, df, h, w,
                            n_lv, timing)
        check(k4[name]["radix_passes"] == passes,
              f"{label}: plane {name}'s {k4[name]['cells']} cells sort in "
              f"{k4[name]['radix_passes']} passes, not {passes}")
    return k4


def stress_initial_checks(tr, timing):
    """Phase 14 on the trainer's initial state and the run's first batch
    (the loader's seed): two identical first steps equal to the bit, with
    nothing dropped; K4 on the grid gradients of that step's xy and xt
    planes (sample_mip's cotangent at iteration 1); the test views' PSNR
    through the eval's own report.  Returns what the run is held to."""
    from saro_gs_torch import eval as eval_mod
    check(tr.active_sh_degree == 0, "stress: the run starts above SH 0")
    ma, taps = same_two_steps("stress: first step",
                              core_step(tr, first_batch(tr), 1), tr.state)
    k4 = plane_k4("stress", taps, "at iteration 1", timing)
    del taps
    psnr = eval_mod.quick_test_report(tr, tr.scene.test_cameras(),
                                      histograms=False)["PSNR"]
    log(f"stress: the initial state renders the test views at "
        f"{psnr:.3f} dB; max_instances {tr.rcfg.max_instances} after the "
        f"presize")
    return {"loss_step1": ma["loss"], "k4": k4, "psnr_init": psnr,
            "max_instances": tr.rcfg.max_instances}


def k4_check(name, coords, lvl, df, h, w, n_lv, timing):
    """K4 (scatter_mip_taps) on one plane's taps against its plain version:
    two launches equal to the bit, within 1e-5 of the output's largest
    entry; its ms beside the plain version's and one index_add_ over the
    same taps, and its bound from these inputs.  Returns the numbers."""
    import torch
    from saro_gs_torch.ops import grid_scatter
    dev = df.device
    npts, c_feat = df.shape
    args = (coords, lvl, df, h, w, n_lv)
    ko = grid_scatter.scatter_mip_taps(*args)
    ko2 = grid_scatter.scatter_mip_taps(*args)
    po = grid_scatter.scatter_mip_taps_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(ko, ko2), f"K4 {name}: two launches differ")
    scale = float(po.abs().max())
    err = float((ko - po).abs().max())
    check(ko.shape == po.shape and scale > 0 and err <= 1e-5 * scale,
          f"K4 {name}: differs by {err} (output max {scale})")
    ms = timing.event_ms(lambda: grid_scatter.scatter_mip_taps(*args), 20)
    plain_ms = timing.event_ms(
        lambda: grid_scatter.scatter_mip_taps_plain(*args), 5)
    cells, wts, total = grid_scatter.mip_taps(coords, lvl, h, w, n_lv)

    def library():
        out = torch.zeros((total, c_feat), device=dev)
        out.index_add_(0, cells.reshape(-1),
                       (wts[:, :, None] * df[None]).reshape(-1, c_feat))
        return out
    lib_ms = timing.event_ms(library, 10)
    n_taps = cells.shape[0]
    # coords and level read once, dfeat read once, the output written
    nbytes = npts * 8 + (npts * 4 if n_lv else 0) + npts * c_feat * 4 \
        + c_feat * total * 4
    ops = n_taps * npts * c_feat * K4_FLOPS_PER_TAP_CHANNEL
    res = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               beats_library=ms < lib_ms, taps=n_taps * npts, cells=total,
               radix_passes=grid_scatter.radix_passes(total), bytes=nbytes,
               max_abs_err=err, max_rel_err=err / scale,
               bound_ms=max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3,
               bound_by="operations" if ops / PEAK_F32 > nbytes / PEAK_BYTES
               else "bytes")
    log(f"K4 scatter_mip_taps, {name} ({n_taps}x{npts} taps -> "
        f"{c_feat}x{total}, {n_lv} levels, {res['radix_passes']} sort "
        f"passes, dfeat row stride {df.stride(0)}): error "
        f"{err / scale:.3g} of the output's max (limit 1e-5), bit-equal; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, one index_add_ "
        f"{lib_ms:.4f} ms "
        f"({'kernel faster' if ms < lib_ms else 'LIBRARY FASTER'}), "
        f"bound {res['bound_ms']:.5f} ms ({nbytes} bytes)")
    return res


def stage_frame(params, nets, alive, mcfg, fstatic, cam, ts, rcfg,
                feat=None, width=W, height=H):
    """One frame's deformed Gaussians and their preprocess at width x
    height (1352x1014 unless given), as the eval render makes them:
    (deformed, preprocessed)."""
    import torch
    from saro_gs_torch import render
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import projection
    with torch.no_grad():
        d = gm.deform(params, nets, mcfg, fstatic, ts, feat=feat)
        active = alive * (d.state[:, 0] > render.EVAL_STATE_CUTOFF)
        pre = projection.preprocess(
            d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam,
            width, height, rcfg.tile_x, rcfg.tile_y, sh_degree=3, shs=d.shs,
            active=active, tight_rect=rcfg.tight_rect)
    return d, pre


def frame_kernels(label, d, pre, cap, bg, rcfg, tk, timing, width=W,
                  height=H):
    """K2, K1 and K3 against their plain versions on one staged frame at
    width x height (1352x1014 unless given): K2's instance tables and
    sorted tile ranges and K1's colour, depth, final T and n_contrib equal
    to the bit (need_aux=False the same image), the share of (8x4 patch,
    instance) pairs K1's warp cull drops, K3's rows within K3_TOL of their
    largest entry and in relative L2 on a seeded colour cotangent,
    unvisited slots zero, two launches equal to the bit.  Returns each
    kernel's numbers (ms, plain ms, bound) by name, "K2", "K1", "K3", and
    the frame's instance counts."""
    import torch
    from saro_gs_torch.ops import binning, compositing
    gx = (width + rcfg.tile_x - 1) // rcfg.tile_x
    gy = (height + rcfg.tile_y - 1) // rcfg.tile_y
    nt = gx * gy
    dev = bg.device

    # ---- K2 against its plain version
    opac = d.opacity.reshape(-1)
    offsets, tiles, rect, gattr, total = binning.expand_inputs(pre, opac)
    n_inst = min(total, cap)
    check(total <= cap, f"{label}: {total - cap} instances dropped at "
          f"{width}x{height}")
    exp_args = (offsets, tiles, rect, gattr, n_inst, gx, gy, rcfg.tile_x,
                rcfg.tile_y, rcfg.tight_rect)
    kk, kg, ka = tk.expand_instances(*exp_args)
    pk, pg, pa = tk.expand_instances_plain(*exp_args)
    torch.cuda.synchronize()
    check(torch.equal(kk, pk), f"{label} K2: sort keys (tile, depth) differ")
    check(torch.equal(kg, pg), f"{label} K2: Gaussian ids differ")
    k2_err = float((ka - pa).abs().max()) if n_inst else 0.0
    check(torch.equal(ka.view(torch.int32), pa.view(torch.int32)),
          f"{label} K2: attributes differ (max abs {k2_err})")
    ks = binning.sort_instances(kk, kg, ka, nt)
    ps = binning.sort_instances(pk, pg, pa, nt)
    check(torch.equal(ks[2], ps[2]) and torch.equal(ks[3], ps[3]),
          f"{label} K2: tile_start/tile_count differ after the sort")
    n_valid = int(ks[3].sum())
    k2_ms, k2_wrapper_ms, k2_src, _ = call_ms(
        lambda: tk.expand_instances(*exp_args), timing)
    k2_plain_ms = timing.event_ms(
        lambda: tk.expand_instances_plain(*exp_args), 5)
    n = offsets.shape[0]
    k2_bytes = n * (4 + 4 + 12 + 40) + n_inst * (8 + 4 + 40)
    k2_ops = n_inst * K2_FLOPS_PER_INSTANCE
    k2_bound = max(k2_bytes / PEAK_BYTES, k2_ops / PEAK_F32) * 1e3
    k2_by = "operations" if k2_ops / PEAK_F32 > k2_bytes / PEAK_BYTES \
        else "bytes"
    log(f"{label} K2 expand: exact match on {n_inst} instances ({n_valid} "
        f"valid, {n} Gaussians); kernel {k2_ms:.4f} ms ({k2_src}"
        + ("" if k2_src == "profiler" else ": the wrapper's host time")
        + f"), wrapper "
        f"{k2_wrapper_ms:.4f} ms a call, plain {k2_plain_ms:.4f} ms, bound "
        f"{k2_bound:.4f} ms ({k2_bytes} bytes)")

    # ---- K1 against its plain version
    attr_s, _, tstart, tcount, _ = ks
    kf = tk.forward_tiles(attr_s, tstart, tcount, bg, width, height,
                          rcfg.tile_x, rcfg.tile_y, rcfg.chunk, need_aux=True)
    kf_noaux = tk.forward_tiles(attr_s, tstart, tcount, bg, width, height,
                                rcfg.tile_x, rcfg.tile_y, rcfg.chunk,
                                need_aux=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf = compositing.forward_tiles(attr_s, tstart, tcount, bg, width,
                                   height, rcfg.tile_x, rcfg.tile_y,
                                   need_aux=True)
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    col_err = float((kf.color - pf.color).abs().max())
    for name in ("color", "depth", "final_t", "n_contrib"):
        check(torch.equal(getattr(kf, name), getattr(pf, name)),
              f"{label} K1: {name} differs from the plain version (colour "
              f"max abs err {col_err})")
    check(torch.equal(kf_noaux.color, kf.color)
          and torch.equal(kf_noaux.depth, kf.depth)
          and torch.equal(kf_noaux.final_t, kf.final_t),
          f"{label} K1: need_aux=False changes the image")
    cull_pairs, cull_kept = compositing.cull_counts(
        attr_s, tstart, tcount, width, height, rcfg.tile_x, rcfg.tile_y)
    k1_culled = 1.0 - cull_kept / cull_pairs
    band = f"{rcfg.tile_x}x{tk.forward_band_rows(rcfg.tile_x, rcfg.tile_y)}"
    log(f"{label} K1 forward vs plain, {nt} tiles: colour, depth, final T "
        f"and n_contrib equal to the bit; max tile count "
        f"{int(tcount.max())}; bands of {band} pixels, batches of "
        f"{rcfg.chunk}; the warp cull drops {cull_pairs - cull_kept} of "
        f"{cull_pairs} (8x4 patch, instance) pairs "
        f"({100 * k1_culled:.2f}%)")

    def k1_call():
        return tk.forward_tiles(attr_s, tstart, tcount, bg, width, height,
                                rcfg.tile_x, rcfg.tile_y, rcfg.chunk,
                                need_aux=False)
    k1_ms, k1_wrapper_ms, k1_src, k1_by_kernel = call_ms(k1_call, timing)
    pairs = int(pf.n_walked.sum())
    k1_bytes = 10 * 4 * n_valid + 8 * nt + 5 * 4 * width * height
    k1_ops = pairs * K1_FLOPS_PER_PAIR
    k1_bound = max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_F32) * 1e3
    k1_by = "operations" if k1_ops / PEAK_F32 > k1_bytes / PEAK_BYTES \
        else "bytes"
    what = ("of device time" if k1_src == "profiler" else
            "by CUDA events, host time where it exceeds the kernels'")
    log(f"{label} K1 forward: {k1_ms:.4f} ms {what} a call ({k1_src}; "
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in k1_by_kernel.items())
        + f"), wrapper {k1_wrapper_ms:.4f} ms a call, plain "
        f"{k1_plain_ms:.1f} ms (one call), bound {k1_bound:.4f} ms ({pairs} "
        f"instance-pixel pairs walked, {k1_bytes} bytes)")

    # ---- K3 against its plain version
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_color = torch.randn(3, height, width, generator=gen).to(dev)
    k3_args = (attr_s, tstart, tcount, bg, kf.n_contrib, kf.color,
               kf.final_t, d_color, width, height, rcfg.tile_x, rcfg.tile_y)
    kb = tk.backward_tiles(*k3_args)
    kb2 = tk.backward_tiles(*k3_args)
    torch.cuda.synchronize()
    check(torch.equal(kb, kb2), f"{label} K3: two launches differ")
    t0 = time.perf_counter()
    pb, k3_contrib = compositing.backward_tiles(*k3_args, count_pairs=True)
    k3_contrib = int(k3_contrib)
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.isfinite(kb).all(), f"{label} K3: non-finite gradients")
    # each row against its largest entry, and in relative L2 so that the
    # typical entries count beside the few large ones
    k3_err, k3_rel, k3_l2 = 0.0, 0.0, 0.0
    for r in range(compositing.GRAD_ROWS):
        scale = float(pb[r].abs().max())
        err = float((kb[r] - pb[r]).abs().max())
        check(scale > 0, f"{label} K3: plain row {r} is all zero")
        l2 = float((kb[r] - pb[r]).double().norm() / pb[r].double().norm())
        check(err <= K3_TOL * scale,
              f"{label} K3: row {r} differs by {err} (row max {scale})")
        check(l2 <= K3_TOL, f"{label} K3: row {r} relative L2 error {l2}")
        k3_err = max(k3_err, err)
        k3_rel = max(k3_rel, err / scale)
        k3_l2 = max(k3_l2, l2)
    unvisited = (pb == 0).all(dim=0)
    check(not bool(kb[:, unvisited].any()),
          f"{label} K3: a slot the replay never visits is not zero")
    k3_ms = timing.event_ms(lambda: tk.backward_tiles(*k3_args), 10)
    k3_pairs = int(kf.n_contrib.sum())
    check(0 < k3_contrib <= k3_pairs,
          f"{label} K3: contributing pairs miscounted")
    k3_bytes = (10 + 9) * 4 * n_valid + 8 * nt + 8 * 4 * width * height
    k3_ops = k3_pairs * K3_FLOPS_PER_REPLAYED_PAIR \
        + k3_contrib * K3_FLOPS_PER_CONTRIBUTING_PAIR
    k3_bound = max(k3_bytes / PEAK_BYTES, k3_ops / PEAK_F32) * 1e3
    k3_by = "operations" if k3_ops / PEAK_F32 > k3_bytes / PEAK_BYTES \
        else "bytes"
    log(f"{label} K3 backward vs plain: worst row error {k3_rel:.3g} of the "
        f"row's max, {k3_l2:.3g} in relative L2 (limits {K3_TOL:g}), "
        f"{int(unvisited.sum())} all-zero slots equal, two launches "
        f"bit-equal; kernel {k3_ms:.4f} ms in batches of "
        f"{tk.BACKWARD_CHUNK} instances, clusters of {tk.BACKWARD_SPLIT} "
        f"bands a tile, plain {k3_plain_ms:.1f} ms (one "
        f"call), bound {k3_bound:.4f} ms ({k3_pairs} instance-pixel pairs "
        f"replayed, {k3_contrib} of them contributing, {k3_ops} flops, "
        f"{k3_bytes} bytes)")
    return {
        "instances": n_inst, "valid_instances": n_valid, "gaussians": n,
        "max_tile_count": int(tcount.max()),
        "K2": {"max_abs_err": k2_err, "check": "exact", "ms": k2_ms,
               "ms_by": k2_src, "wrapper_ms": k2_wrapper_ms,
               "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
               "bound_by": k2_by, "library_ms": None},
        "K1": {"max_abs_err": col_err,
               "check": "colour, depth, final T, n_contrib equal to the bit",
               "band": band, "batch": rcfg.chunk,
               "patch_pairs": cull_pairs, "culled_pair_share": k1_culled,
               "ms": k1_ms, "ms_by": k1_src, "ms_by_kernel": k1_by_kernel,
               "wrapper_ms": k1_wrapper_ms, "plain_ms": k1_plain_ms,
               "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        "K3": {"max_abs_err": k3_err,
               "check": f"each row <= {K3_TOL:g} of its max and in relative "
                        "L2, unvisited slots zero, two launches bit-equal",
               "rel_l2_err": k3_l2, "batch": tk.BACKWARD_CHUNK,
               "bands": tk.BACKWARD_SPLIT, "pairs_replayed": k3_pairs,
               "pairs_contributing": k3_contrib, "ms": k3_ms,
               "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
               "bound_by": k3_by, "library_ms": None}}


def bench_kernels_phase(dev, tk, timing):
    """Phase 18 (a) and (b), in a process of its own where no profiler has
    run before (start_phase("bench_kernels")): the frame kernels and K4 on
    the bench scene.  Returns (results, the kernels' launches in it)."""
    import torch
    from saro_gs_torch import bench, render
    from saro_gs_torch.models import field as field_mod
    from saro_gs_torch.models import gaussians as gm
    t0 = time.perf_counter()
    scene = bench.bench_scene(BENCH_POINTS, device=dev)
    mcfg, params, nets, alive, fstatic, _ = scene
    build_s = time.perf_counter() - t0
    cam = bench.bench_camera(W, H, dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        feat = gm.field_feat(params, nets, mcfg, fstatic)

    # ---- (a) K2, K1 and K3 on the scene's frame at ts 0.5
    rcfg = bench.raster_config()._replace(need_aux=False)
    cap = bench.probe_capacity(lambda ts: render.test_render(
        cam, ts, params, nets, alive, mcfg, fstatic, bg, width=W, height=H,
        sh_degree=3, rcfg=rcfg, feat=feat)[0])
    rcfg = rcfg._replace(max_instances=cap)
    d, pre = stage_frame(params, nets, alive, mcfg, fstatic, cam, 0.5, rcfg,
                         feat=feat)
    fk = frame_kernels("bench", d, pre, cap, bg, rcfg, tk, timing)
    del d, pre

    # ---- (b) one bench train step; K4 on its plane gradients
    tin = bench.train_inputs(scene, W, H, BATCH, bench.START_INSTANCES, dev)
    (_, m), taps = grid_taps(tin.state, lambda s: bench.train_step(tin, s))
    check(m["bad_step"] == 0 and m["dropped"] == 0,
          f"bench: the train step went wrong: {m}")
    k4 = {}
    for i, (a, b) in enumerate(field_mod.COMBS):
        if 3 in (a, b) and (a, b) != (0, 3):
            continue                          # one time plane: xt
        name = "xyzt"[a] + "xyzt"[b]
        check(i in taps, f"bench: no grid gradient for plane {name}")
        k4[name] = k4_check(f"bench plane {name}", *taps[i], timing)
    return {"frame": fk, "k4": k4, "max_instances": cap,
            "scene_build_s": build_s}, dict(tk.launches)


def bench_phase(card, dev, tk, timing):
    """Phase 18 (module docstring): (a) the frame kernels and (b) K4 on
    the bench scene in a process of their own, then (c) the bench alone
    on the card.  Returns (results, the kernels' launches in each of the
    bench's records)."""
    t_phase = time.perf_counter()
    kern, _ = join_phase("bench_kernels", *start_phase("bench_kernels"))
    kernels_s = time.perf_counter() - t_phase

    # ---- (c) the bench in a process of its own, alone on the card
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-m", "saro_gs_torch.bench"],
                             cwd=HERE, capture_output=True, text=True,
                             timeout=BENCH_LIMIT_S)
    except subprocess.TimeoutExpired:
        fail(f"bench: python -m saro_gs_torch.bench ran past "
             f"{BENCH_LIMIT_S} s")
    run_s = time.perf_counter() - t0
    check(res.returncode == 0,
          f"bench: python -m saro_gs_torch.bench exited with "
          f"{res.returncode}: {res.stderr[-3000:]}")
    records = [json.loads(x) for x in res.stdout.splitlines()
               if x.startswith("{")]
    check([r.get("metric") for r in records] == BENCH_NAMES,
          f"bench: records {[r.get('metric') for r in records]}, expected "
          f"{BENCH_NAMES}")
    head, ckpt, train, last = records
    for r in records:
        check(r["value"] > 0 and r["vs_baseline"] is None
              and r["dropped"] == 0 and r["card"] == card,
              f"bench: record {r['metric']} is off: {r}")
    check(last["ckpt_fps"] == ckpt["value"]
          and last["train_steps_per_s"] == train["value"]
          and train["render_fps"] == head["value"] == last["value"],
          "bench: the headline does not embed the other records")
    for r in (head, ckpt):
        check(r["launches"]["expand"] > 0 and r["launches"]["forward"] > 0,
              f"bench: {r['metric']}: K2 or K1 never launched: "
              f"{r['launches']}")
    check(all(v > 0 for v in train["launches"].values()),
          f"bench: a kernel never launched in the train bench: "
          f"{train['launches']}")
    phase_s = time.perf_counter() - t_phase
    log(f"bench: {head['value']:.2f} FPS (synthetic, {head['instances']} "
        f"instances, max_instances {head['max_instances']}), "
        f"{ckpt['value']:.2f} FPS ({ckpt['scene']}), "
        f"{train['value']:.3f} train steps/s; the process took {run_s:.1f} "
        f"s, the kernels' process {kernels_s:.1f} s, the phase "
        f"{phase_s:.1f} s; card {card}")
    launches = {"render": head["launches"], "render_ckpt": ckpt["launches"],
                "train": train["launches"]}
    return {"render_fps": head["value"], "render_fps_ckpt": ckpt["value"],
            "train_steps_per_s": train["value"], "records": records,
            **kern, "kernels_process_s": kernels_s, "process_s": run_s,
            "phase_s": phase_s}, launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, HERE)
    from saro_gs_torch import native, render, timing
    from saro_gs_torch.data import cameras
    from saro_gs_torch.models import field as field_mod
    from saro_gs_torch.models import gaussians as gm
    from saro_gs_torch.ops import binning, mip, projection
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
    # the native host library's core, built here on this host whatever a
    # copied build/ holds, before any phase of its own process starts; the
    # image library is phase 12's
    for path in (native.SO_PATH, native.IMAGE_SO_PATH):
        if os.path.exists(path):
            os.remove(path)
    core_build_s = native.build()
    log(f"build: {core_build_s:.2f} s (g++, the native core library "
        f"{native.SO_PATH})")

    # ---- the model ----------------------------------------------------------
    cfg, mcfg, params, nets, alive, fstatic, npts = load_arena(dev)
    with torch.no_grad():
        feat = gm.field_feat(params, nets, mcfg, fstatic)
    cam = eval_camera(dev)
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

    # ---- 3 to 5. K2, K1 and K3 against their plain versions ---------------
    d, pre = stage_frame(params, nets, alive, mcfg, fstatic, cam, 0.5, rcfg,
                         feat=feat)
    fk = frame_kernels("arena", d, pre, cap, bg, rcfg, tk, timing)

    # ---- 6. K4 against its plain version ------------------------------------
    # the grid gradients sample_mip's backward makes for the checkpoint's
    # points: its three spatial planes (128x128, a 7-level pyramid: both
    # brackets in one call), one time plane (no pyramid), and a hot cell
    fcfg = mcfg.field
    with torch.no_grad():
        norm = (params.xyz - fstatic.aabb_min) / (fstatic.aabb_max
                                                  - fstatic.aabb_min)
        tn = gm.get_temporal_pos(params, mcfg) * fstatic.duration \
            / (fstatic.duration - 1.0)
        coords4 = torch.cat([norm, tn.reshape(-1, 1)], dim=-1)
        levels4 = field_mod.get_levels(fcfg, fstatic, gm.get_scaling(params))
    c_feat = fcfg.out_dim
    reso = fcfg.reso(fcfg.multires[0])
    gen = torch.Generator(device="cpu").manual_seed(1)
    dfeat = torch.randn(npts, c_feat, generator=gen).to(dev)
    # autograd hands the backward strided rows: one case reads them so
    dfeat_wide = torch.randn(npts, 2 * c_feat, generator=gen).to(dev)
    cases = []
    for a, b in field_mod.COMBS:
        spatial = 3 not in (a, b)
        if not spatial and any(not c[5] for c in cases):
            continue                          # one time plane
        h, w = reso[b], reso[a]
        n_lv = mip.max_mip_levels(
            h, w, field_mod.SPATIAL_MAX_MIP if spatial else 0)
        cases.append((f"plane {'xyzt'[a]}{'xyzt'[b]}",
                      coords4[:, [a, b]].contiguous(),
                      torch.minimum(levels4[:, a], levels4[:, b]),
                      dfeat if spatial else dfeat_wide[:, :c_feat],
                      (h, w, n_lv), spatial))
    h_sp, w_sp, n_sp = cases[0][4]
    hot_coords = torch.tensor([[0.3, 0.7]], device=dev).expand(npts, 2)
    cases.append(("hot cell", hot_coords.contiguous(),
                  torch.full((npts,), float(n_sp), device=dev), dfeat,
                  (h_sp, w_sp, n_sp), True))
    k4 = {name: k4_check(name, coords, lvl, df, h, w, n_lv, timing)
          for name, coords, lvl, df, (h, w, n_lv), _ in cases}
    k4_err = max(r["max_abs_err"] for r in k4.values())

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
    tin = train_inputs(cfg, mcfg, params, nets, alive, fstatic, dev)
    cams, gt, ts_train, st, state0 = (tin.cams, tin.gt, tin.ts, tin.st,
                                      tin.state0)
    train_cap = st.rcfg.max_instances
    alive_t = state0.alive
    log(f"train: {int(alive_t.sum())} of {npts} Gaussians alive after the "
        f"integral prune, LR scaling up to "
        f"{float(state0.inv_integral.max()):.2f}, extent {st.extent:.3f}, "
        f"weights {tuple(cfg.loss_weights())}, max_instances {train_cap} "
        f"({tin.need} needed)")

    def one_step(state):
        return step_mod.train_step_core(
            state, cams, gt, ts_train, bg, fstatic, st, stage="dynamatic",
            sh_degree=3, scale_integral=True)

    # the same step from two copies of the state: equal to the bit
    sa, ma = one_step(step_mod.clone_state(state0))
    sb, mb = one_step(step_mod.clone_state(state0))
    torch.cuda.synchronize()
    check(ma == mb, f"train: two identical steps report differently: "
          f"{ma} vs {mb}")
    for k, (x, y) in enumerate(zip(state_leaves(sa), state_leaves(sb))):
        check(torch.equal(x, y), f"train: leaf {k} differs between two "
              "identical steps")
    log("train: two identical steps from one state are equal to the bit "
        f"({len(state_leaves(sa))} tensors); loss {ma['loss']:.6f}")
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
    check(all(torch.isfinite(x).all() for x in state_leaves(state)),
          "train: a non-finite value in the state")
    check(all(train_counts[k] > 0 for k in
              ("expand", "forward", "backward", "grid_scatter")),
          f"train: a kernel never launched in the timed steps: "
          f"{train_counts}")
    # K4: one call per plane a step, both mip brackets in it
    check(train_counts["grid_scatter"] == len(nets.field.planes) * n_timed,
          f"train: K4 launched {train_counts['grid_scatter']} times in "
          f"{n_timed} steps, expected one per plane")
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

    # ---- 18. the bench, alone on the card ------------------------------------
    torch.cuda.empty_cache()
    bench_res, bench_counts = bench_phase(card, dev, tk, timing)

    # ---- 15 and 16 start, each in a process of its own beside phases 11
    # to 14: the Neural3D and the D-NeRF training modes ---------------------
    n3d_proc = start_phase("neural3d")
    dnerf_proc = start_phase("dnerf")

    # ---- 11. the trainer --------------------------------------------------
    trainer, trainer_counts, info, phase11 = trainer_phase(
        params, nets, alive, fstatic, mcfg, rcfg, dev, tk)
    torch.cuda.empty_cache()

    # ---- 12. the arena trainer from disk ------------------------------------
    trainer_disk, disk_counts = disk_trainer_phase(
        info, phase11["losses"], trainer["dynamic_its_per_s"], core_build_s,
        dev, tk)
    torch.cuda.empty_cache()

    # ---- 13. the parallel path ----------------------------------------------
    parallel, parallel_counts = parallel_phase(
        cfg, mcfg, params, nets, alive, fstatic, rcfg, tin,
        dict(phase11, info=info), dev, tk)
    torch.cuda.empty_cache()

    # ---- 14. the Neural3D-scale trainer --------------------------------------
    stress, stress_counts = stress_phase(dev, tk, timing)
    torch.cuda.empty_cache()

    # ---- 17. the eval's capacity --------------------------------------------
    eval_capacity, eval_counts = eval_capacity_phase(
        cfg, mcfg, params, nets, alive, fstatic, info, dev, tk)
    torch.cuda.empty_cache()

    # ---- 15. the Neural3D training mode: its process's results -------------
    neural3d, n3d_counts = join_phase("neural3d", *n3d_proc)

    # ---- 19. the HyperNeRF training mode, in a process of its own beside
    # phase 16 once phase 15 has ended (beside both, phase 15 came within
    # 50 s of its limit) -------------------------------------------------
    hypernerf_proc = start_phase("hypernerf")

    # ---- 16. the D-NeRF training mode: its process's results ---------------
    dnerf, dnerf_counts = join_phase("dnerf", *dnerf_proc)

    # ---- 19. the HyperNeRF training mode: its process's results ------------
    hypernerf, hypernerf_counts = join_phase("hypernerf", *hypernerf_proc)

    # ---- 20. summary --------------------------------------------------------
    k4m = k4[cases[0][0]]
    k4_row = {"max_abs_err": k4_err,
              "check": "<= 1e-5 of the output's max, two launches bit-equal",
              "shape": cases[0][0],
              **{k: k4m[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"saro_gs_torch/csrc/{src}", "replaces": replaces,
         "launches": train_counts[key],
         "launches_trainer": trainer_counts[key],
         "launches_trainer_disk": disk_counts[key],
         "launches_parallel": {run: c[key]
                               for run, c in parallel_counts.items()},
         "launches_stress": stress_counts[key],
         "launches_neural3d": n3d_counts[key],
         "launches_dnerf": dnerf_counts[key],
         "launches_dnerf_resume": dnerf["resume"]["launches"][key],
         "launches_hypernerf": hypernerf_counts[key],
         "launches_eval_capacity": eval_counts[key],
         "launches_bench": {run: c[key] for run, c in bench_counts.items()},
         "launches_render": counts[key], **numbers}
        for key, name, src, replaces, numbers in (
            ("expand", "expand_instances (K2)", "expand.cu",
             "saro_gs_tpu/ops/tile_kernels.py:203", fk["K2"]),
            ("forward", "forward_tiles (K1)", "forward.cu",
             "saro_gs_tpu/ops/tile_kernels.py:409", fk["K1"]),
            ("backward", "backward_tiles (K3)", "backward.cu",
             "saro_gs_tpu/ops/tile_kernels.py:726", fk["K3"]),
            ("grid_scatter", "scatter_mip_taps (K4)", "grid_scatter.cu",
             "saro_gs_tpu/ops/grid_scatter.py:50", k4_row))]
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
    print(json.dumps({"trainer": trainer}), flush=True)
    print(json.dumps({"trainer_disk": trainer_disk}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"phase": "stress", **stress}), flush=True)
    print(json.dumps({"phase": "neural3d", **neural3d}), flush=True)
    print(json.dumps({"phase": "dnerf", **dnerf}), flush=True)
    print(json.dumps({"phase": "hypernerf", **hypernerf}), flush=True)
    print(json.dumps({"eval_capacity": eval_capacity}), flush=True)
    print(json.dumps({"bench": bench_res}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def start_phase(name):
    """Phase ``name`` of PHASES in a process of its own, beside the
    script's: (the process, the file its results go to)."""
    out = os.path.join(HERE, "build", f"chip_smoke_{name}.json")
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phase", name, "--out", out], cwd=HERE)
    CHILDREN.append(proc)
    return proc, out


def join_phase(name, proc, out):
    """The results of a phase that ``start_phase`` started: (results,
    the kernels' launches over its run); a failed phase fails the run."""
    rc = proc.wait()
    check(rc == 0 and os.path.exists(out),
          f"{name}: its process exited with {rc}")
    with open(out) as f:
        done = json.load(f)
    return done["results"], done["launches"]


def phase_main(name, out):
    """One phase in this process (for start_phase): build the kernels
    (cached by the script's own build), run it, write its results."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, HERE)
    from saro_gs_torch import timing
    from saro_gs_torch.ops import tile_kernels as tk
    tk.build()
    results, launches = PHASES[name](torch.device("cuda"), tk, timing)
    with open(out, "w") as f:
        json.dump({"results": results, "launches": launches}, f)


# the phases that can run in a process of their own
PHASES = {"neural3d": neural3d_phase, "dnerf": dnerf_phase,
          "hypernerf": hypernerf_phase, "bench_kernels": bench_kernels_phase}


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--phase"]:
            phase_main(sys.argv[2], sys.argv[4])
        else:
            main()
    finally:
        stop_children()
