"""The port's benchmark: render FPS and train steps/s (counterpart of
bench.py, and of __graft_entry__.py's synthetic state and camera).

    python -m saro_gs_torch.bench [--device cuda|cpu]

Three benches, bench.py's protocols on the port's entry points:

  * ``bench_fps()`` renders a synthetic 200,000-Gaussian scene
    (``bench_scene``: ``synthetic_state`` with log-uniform scales in
    [0.003, 0.02]) from ``bench_camera`` on black through
    ``render.test_render``, field features computed once.  The capacity
    comes from probes at ts 0.01, 0.5 and 0.99 (the most instances seen,
    padded by 1.15, rounded up to 64k); then 50 frames of the sweep
    ts = 0.5 + 0.49 sin(i / 7), the first 10 of them warm-up, in 4
    passes, the card synchronized at the end of the warm-up and of each
    pass, host clock; FPS = 1 / the mean of the passes' seconds a frame;
    then ts 0.01 and 0.99 rendered again as the check after the sweep;
  * ``bench_fps(use_ckpt=True)`` the same on a trained checkpoint
    (``find_checkpoint``: ``SARO_BENCH_CKPT``, else the tracked
    checkpoints/arena) from ring camera 0 at fovx 0.85 on white;
  * ``bench_train()`` steps the same scene through
    ``train/step.py:train_step_core``: dynamic stage, SH degree 3,
    integral-scaled LRs, batch 4 ring views at 1352x1014, uniform-noise
    ground truth, 1 warm-up step and 20 timed.

On the card the renders are 1352x1014; on the CPU what bench.py takes
there: 338x254 and 5,000 points, 8 frames (2 warm-up) in 1 pass, no
checkpoint, and the train bench at 96x64, 500 points, batch 2, 3 steps.
``SARO_BENCH_TILE`` and ``SARO_BENCH_CHUNK`` set the tile (32) and K1's
staging batch (128).

``main`` prints bench.py's JSON lines in its order: the headline
``render_fps_<W>x<H>``, the checkpoint's ``render_fps_ckpt_<W>x<H>``,
``train_steps_per_s_b<B>_<W>x<H>``, then the headline again as the last
line, with ``ckpt_fps``, ``ckpt_scene``, ``train_steps_per_s`` and
``render_fps`` embedded as bench.py embeds them.  Each record carries
``"card"`` (nvidia-smi's name and power limit, or "cpu") and
``"launches"``, each kernel's launches over that bench.

Where it departs from bench.py:

  * ``vs_baseline`` is null: bench.py divides by numbers taken on a TPU,
    and the port states none;
  * nothing is skipped quietly: no deadline, no train bench in a child
    process whose timeout is swallowed, no ``os._exit(0)``.  A bench
    either prints its record or the process exits non-zero; on the card
    a missing checkpoint raises;
  * a dropped instance fails the run (``BenchError``): every frame's
    ``num_dropped`` is read (the binning reads each view's instance total
    anyway), and any timed or checked frame or train step that dropped
    one raises, where bench.py warns.  A truncated frame is another
    image, not a faster one;
  * a bad (non-finite) train step raises;
  * values are not rounded;
  * the TPU kernel switches (``SARO_BENCH_PREFIX``, ``_PACKED``,
    ``_EXPAND``) have no counterpart: the port has one compositor and one
    expander.

``synthetic_state`` draws the cloud from ``RandomState(seed)`` as
__graft_entry__.py does, so the points, colours and everything derived
from them equal the JAX package's; the temporal positions and the heads
come from a ``torch.Generator`` and differ from the JAX package's
``PRNGKey`` draws by design.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device
from .data.cameras import camera_from_c2w, ring_cameras
from .models import field as field_mod
from .models import gaussians as gm
from .ops import math3d
from .ops import tile_kernels
from .ops.projection import CameraParams
from .ops.rasterize import RasterConfig
from .render import test_render
from .train import losses
from .train import step as step_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's starting capacity, before the probe (and the train step's)
START_INSTANCES = 576 * 1024
# the train bench's learning rates (bench.py:253-254, in make_lr_statics'
# order)
CFG_LRS = (1.6e-4, 1.6e-6, 0.01, 30000, 0.0025, 0.05, 0.005, 0.001, 1e-4,
           1.6e-4, 1.6e-7, 3.2e-3, 3.2e-6)


class BenchError(RuntimeError):
    """A bench that cannot report: instances dropped, a bad step, no
    checkpoint."""


class Protocol(NamedTuple):
    """What a bench does on one kind of device (bench.py's two)."""
    width: int
    height: int
    points: int
    frames: int
    warmup: int
    passes: int
    train_width: int
    train_height: int
    train_points: int
    batch: int
    steps: int
    train_max_instances: int


CARD = Protocol(width=1352, height=1014, points=200_000, frames=50,
                warmup=10, passes=4, train_width=1352, train_height=1014,
                train_points=200_000, batch=4, steps=20,
                train_max_instances=START_INSTANCES)
CPU = Protocol(width=338, height=254, points=5_000, frames=8, warmup=2,
               passes=1, train_width=96, train_height=64, train_points=500,
               batch=2, steps=3, train_max_instances=1 << 14)


def protocol(device) -> Protocol:
    return CARD if torch.device(device).type == "cuda" else CPU


def synthetic_state(n=4096, capacity=4096, seed=0, duration=30,
                    device=DEFAULT_DEVICE,
                    generator: Optional[torch.Generator] = None):
    """A new model of ``n`` random points in [-1, 1]^3, padded to
    ``capacity`` rows (__graft_entry__.py:_synthetic_state) -> (mcfg,
    params, nets, alive, fstatic) on ``device``.

    The field is 32^3 x 16 of 16 channels at one scale, the aabb +-1.5.
    Points then colours come from ``RandomState(seed)``, as in the JAX
    package, so xyz, SH DC, rest, rotation, opacity, alive and (up to the
    knn's rounding) scaling are its values.  ``create_from_pcd``'s
    temporal positions and then ``init_nets``' heads are drawn from
    ``generator`` (default: a CPU generator seeded with ``seed``), so they
    differ from the JAX package's PRNGKey draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed)
    mcfg = gm.ModelConfig(
        field=field_mod.FieldConfig(resolution=(32, 32, 32, 16), out_dim=16,
                                    multires=(1,)),
        min_interval=0.5, min_intergral=1e-3)
    pcd = gm.PointCloud(points=rng.uniform(-1, 1, (n, 3)),
                        colors=rng.uniform(0, 1, (n, 3)))
    params, alive = gm.create_from_pcd(pcd, capacity, mcfg, generator, dev)
    nets = gm.init_nets(mcfg, generator, dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    fstatic = field_mod.FieldStatic(aabb_min=f32([-1.5] * 3),
                                    aabb_max=f32([1.5] * 3),
                                    duration=f32(duration))
    return mcfg, params, nets, alive, fstatic


def bench_scene(n, seed=3, device=DEFAULT_DEVICE):
    """The benches' scene: ``synthetic_state(n, n, seed)`` with bench.py's
    scale override, log U(0.003, 0.02) from ``RandomState(0)``
    (bench.py:133-136) -> (mcfg, params, nets, alive, fstatic, rng), the
    ``RandomState`` left after that draw, from which the train bench
    draws its ground truth (bench.py:273-274)."""
    mcfg, params, nets, alive, fstatic = synthetic_state(
        n=n, capacity=n, seed=seed, device=device)
    rng = np.random.RandomState(0)
    scaling = np.log(rng.uniform(0.003, 0.02, (n, 3))).astype(np.float32)
    params = params._replace(
        scaling=torch.as_tensor(scaling, device=params.xyz.device))
    return mcfg, params, nets, alive, fstatic, rng


def bench_camera(width, height, device=DEFAULT_DEVICE) -> CameraParams:
    """The synthetic scene's camera (__graft_entry__.py:_camera): fovx 60
    degrees, at z = 4 looking down the world's z axis."""
    dev = resolve_device(device)
    fovx = math.radians(60)
    focal = math3d.fov2focal(fovx, width)
    fovy = math3d.focal2fov(focal, height)
    wv = math3d.world_to_view_matrix(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = math3d.projection_matrix(0.01, 100.0, fovx, fovy)
    wv64 = wv.astype(np.float64)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return CameraParams(
        viewmat=f32(wv), projmat=f32(wv64 @ proj.astype(np.float64)),
        campos=f32(np.linalg.inv(wv64)[3, :3]),
        tanfovx=f32(math.tan(fovx / 2)), tanfovy=f32(math.tan(fovy / 2)))


def find_checkpoint() -> Optional[str]:
    """The trained checkpoint the checkpoint bench renders (bench.py:50-78):
    ``SARO_BENCH_CKPT`` if set (None if it does not exist), else the
    tracked checkpoints/arena/point_cloud/iteration_best, else the best or
    highest saved iteration of log/synth_arena/{r4,r2d,r2main}; a PLY
    counts only beside its npz."""
    path = os.environ.get("SARO_BENCH_CKPT", "")
    if path:
        return path if os.path.exists(path) else None

    def complete(p):
        return os.path.exists(p) and os.path.exists(p.replace(".ply",
                                                              ".npz"))
    tracked = os.path.join(ROOT, "checkpoints", "arena", "point_cloud",
                           "iteration_best", "point_cloud.ply")
    if complete(tracked):
        return tracked
    root = os.path.join(ROOT, "log", "synth_arena")
    for exp in ("r4", "r2d", "r2main"):
        pat = os.path.join(root, exp, "point_cloud", "iteration_*")
        nums = sorted((int(os.path.basename(d).split("_")[1])
                       for d in glob.glob(pat)
                       if os.path.basename(d).split("_")[1].isdigit()),
                      reverse=True)
        for tag in ["iteration_best"] + [f"iteration_{i}" for i in nums]:
            p = os.path.join(root, exp, "point_cloud", tag,
                             "point_cloud.ply")
            if complete(p):
                return p
    return None


def card_name(device) -> str:
    """nvidia-smi's "name, power limit" of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def raster_config() -> RasterConfig:
    """The render benches' rasterizer before the probe sizes it."""
    tile = int(os.environ.get("SARO_BENCH_TILE", "32"))
    return RasterConfig(tile_x=tile, tile_y=tile,
                        chunk=int(os.environ.get("SARO_BENCH_CHUNK", "128")),
                        max_instances=START_INSTANCES)


def probe_capacity(render) -> int:
    """bench.py:168-175: the most instances over ts 0.01, 0.5 and 0.99,
    padded by 1.15, rounded up to a multiple of 65,536."""
    need = 0
    for ts in (0.01, 0.5, 0.99):
        out = render(ts)
        need = max(need, out.num_instances + out.num_dropped)
    return max(-(-int(need * 1.15) // 65536) * 65536, 65536)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_fps(use_ckpt=False, device=DEFAULT_DEVICE, frames=None,
              warmup=None, passes=None):
    """bench.py's render-FPS bench (module docstring) -> its record, or
    None for the checkpoint bench on the CPU.  ``frames``, ``warmup`` and
    ``passes`` default to the device's protocol.  Raises BenchError where
    a frame drops instances."""
    dev = resolve_device(device)
    proto = protocol(dev)
    frames = proto.frames if frames is None else frames
    warmup = proto.warmup if warmup is None else warmup
    passes = proto.passes if passes is None else passes
    if not 0 <= warmup < frames or passes < 1:
        raise ValueError(f"{frames} frames, {warmup} warm-up, {passes} "
                         "passes: needs a timed frame and a pass")
    width, height = proto.width, proto.height
    if use_ckpt:
        if dev.type != "cuda":
            return None
        ckpt = find_checkpoint()
        if ckpt is None:
            raise BenchError("no checkpoint for the checkpoint bench: set "
                             "SARO_BENCH_CKPT or restore checkpoints/arena")
        from .config import load_cfg_args
        from .scene import load_gaussian_checkpoint
        cfg = load_cfg_args(os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(ckpt))), "cfg_args.json"))
        mcfg = cfg.model_config()
        # the exact point count: no padding rows in the benched sort
        params, nets, alive, fstatic, n = load_gaussian_checkpoint(
            ckpt, mcfg, dev, capacity=None)
        cam = camera_from_c2w(ring_cameras(21)[0], 0.85, width, height,
                              0.0).raster_params(dev)
        scene = f"ckpt:{os.path.relpath(ckpt, ROOT)} ({n} pts)"
        bg = torch.ones(3, device=dev)
    else:
        n = proto.points
        mcfg, params, nets, alive, fstatic, _ = bench_scene(n, device=dev)
        cam = bench_camera(width, height, dev)
        scene = f"synthetic ({n} pts)"
        bg = torch.zeros(3, device=dev)
    tile_kernels.reset_launches()
    with torch.no_grad():
        feat = gm.field_feat(params, nets, mcfg, fstatic)

    def render(ts, rcfg):
        return test_render(cam, ts, params, nets, alive, mcfg, fstatic, bg,
                           width=width, height=height, sh_degree=3,
                           rcfg=rcfg, feat=feat)[0]

    rcfg = raster_config()
    capacity = probe_capacity(lambda ts: render(ts, rcfg))
    rcfg = rcfg._replace(max_instances=capacity)

    ts_list = [0.5 + 0.49 * math.sin(i / 7) for i in range(frames)]
    seen = []

    def frame(ts):
        out = render(ts, rcfg)
        if out.num_dropped:
            total = out.num_instances + out.num_dropped
            raise BenchError(
                f"ts={ts}: {out.num_dropped} of {total} instances dropped "
                f"at max_instances {capacity}: no FPS on a truncated frame")
        seen.append(out.num_instances)
        return out

    durations = []
    for _ in range(passes):
        for i, ts in enumerate(ts_list):
            if i == warmup:
                _sync(dev)
                t0 = time.perf_counter()
            frame(ts)
        _sync(dev)
        durations.append((time.perf_counter() - t0) / (frames - warmup))
    fps = 1.0 / float(np.mean(durations))
    # bench.py's check after the sweep: the extreme frames again
    for ts in (0.01, 0.99):
        frame(ts)
    _sync(dev)
    tag = "render_fps_ckpt" if use_ckpt else "render_fps"
    return {"metric": f"{tag}_{width}x{height}", "value": fps,
            "unit": "frames/s", "vs_baseline": None, "scene": scene,
            "card": card_name(dev), "launches": dict(tile_kernels.launches),
            "ms_per_frame": 1e3 / fps, "frames": frames, "warmup": warmup,
            "passes": passes, "max_instances": capacity,
            "instances": [min(seen), max(seen)], "dropped": 0}


class TrainInputs(NamedTuple):
    st: step_mod.StepStatics
    state: step_mod.TrainState
    fstatic: field_mod.FieldStatic
    cams: CameraParams        # leaves with a leading batch axis
    gt: torch.Tensor          # [B, 3, H, W] float32
    timestamps: torch.Tensor  # [B, 1, 1]
    bg: torch.Tensor


def train_inputs(scene, width, height, batch, max_instances,
                 device=DEFAULT_DEVICE) -> TrainInputs:
    """bench.py:245-275's step set-up on ``scene`` = (mcfg, params, nets,
    alive, fstatic, rng), as ``bench_scene`` returns it: the statics
    (tile 32, chunk 128, dssim 0.2, CFG_LRS, extent 1), a fresh state
    (unit LR scaling), ``batch`` ring views at fovx 0.85, float32
    U(0, 1) ground truth from ``rng``, timestamps linspace(0.1, 0.9),
    black background."""
    dev = resolve_device(device)
    mcfg, params, nets, alive, fstatic, rng = scene
    st = step_mod.StepStatics(
        mcfg=mcfg,
        rcfg=RasterConfig(tile_x=32, tile_y=32, chunk=128,
                          max_instances=max_instances),
        weights=losses.LossWeights(lambda_dssim=0.2), width=width,
        height=height, cfg_lrs=CFG_LRS, extent=1.0)
    views = [camera_from_c2w(c2w, 0.85, width, height, 0.0)
             .raster_params(dev) for c2w in ring_cameras(batch)]
    cams = CameraParams(*[torch.stack(x) for x in zip(*views)])
    gt = torch.as_tensor(rng.uniform(0.0, 1.0, (batch, 3, height, width))
                         .astype(np.float32), device=dev)
    ts = torch.as_tensor(np.linspace(0.1, 0.9, batch).astype(np.float32)
                         .reshape(-1, 1, 1), device=dev)
    return TrainInputs(st=st, state=step_mod.init_state(params, nets, alive),
                       fstatic=fstatic, cams=cams, gt=gt, timestamps=ts,
                       bg=torch.zeros(3, device=dev))


def train_step(tin: TrainInputs, state):
    """One bench step: dynamic stage, SH degree 3, integral-scaled LRs ->
    (state, metrics)."""
    return step_mod.train_step_core(
        state, tin.cams, tin.gt, tin.timestamps, tin.bg, tin.fstatic,
        tin.st, stage="dynamatic", sh_degree=3, scale_integral=True)


def bench_train(device=DEFAULT_DEVICE, steps=None, warmup=1):
    """bench.py's train bench (module docstring) -> its record.  ``steps``
    (timed) defaults to the device's protocol.  Raises BenchError on a bad
    step or dropped instances."""
    dev = resolve_device(device)
    proto = protocol(dev)
    steps = proto.steps if steps is None else steps
    if steps < 1:
        raise ValueError("the train bench needs a timed step")
    w, h, b = proto.train_width, proto.train_height, proto.batch
    tin = train_inputs(bench_scene(proto.train_points, device=dev), w, h, b,
                       proto.train_max_instances, dev)
    tile_kernels.reset_launches()
    state = tin.state

    def step(state, i):
        state, m = train_step(tin, state)
        if m["bad_step"] or m["dropped"]:
            raise BenchError(
                f"train step {i}: bad_step {m['bad_step']} (groups "
                f"{step_mod.bad_src_names(m['bad_src'])}), {m['dropped']} "
                f"instances dropped at max_instances "
                f"{tin.st.rcfg.max_instances}")
        return state, m

    for i in range(warmup):
        state, _ = step(state, i)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step(state, warmup + i)
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    return {"metric": f"train_steps_per_s_b{b}_{w}x{h}", "value": 1.0 / dt,
            "unit": "steps/s", "vs_baseline": None,
            "scene": f"synthetic ({proto.train_points} pts)",
            "card": card_name(dev), "launches": dict(tile_kernels.launches),
            "ms_per_step": dt * 1e3, "steps": steps, "warmup": warmup,
            "loss": m["loss"], "max_instances": tin.st.rcfg.max_instances,
            "dropped": 0, "bad_steps": 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m saro_gs_torch.bench",
        description="Render FPS and train steps/s of the port, with "
                    "bench.py's protocols (module docstring).")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    fps_rec = bench_fps(device=dev)
    print(json.dumps(fps_rec), flush=True)
    ckpt_rec = bench_fps(use_ckpt=True, device=dev)
    if ckpt_rec:
        ckpt_rec["note"] = "reference protocol: trained model"
        print(json.dumps(ckpt_rec), flush=True)
        fps_rec["ckpt_fps"] = ckpt_rec["value"]
        fps_rec["ckpt_scene"] = ckpt_rec["scene"]
    train_rec = bench_train(device=dev)
    fps_rec["train_steps_per_s"] = train_rec["value"]
    train_rec["render_fps"] = fps_rec["value"]
    print(json.dumps(train_rec), flush=True)
    # the last line: the headline, with the other metrics embedded
    print(json.dumps(fps_rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
