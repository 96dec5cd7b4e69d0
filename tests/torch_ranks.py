"""What each rank of tests/test_torch_parallel.py runs, on the CPU, in a
process of its own (parallel.runtime.launch_local pickles these functions
by name).  Imports torch and saro_gs_torch only: a rank never loads JAX.

The toy step's statics are those of tests/test_torch_step.py."""
import json
import os

import numpy as np
import torch

from saro_gs_torch import config as tcfg
from saro_gs_torch import convert
from saro_gs_torch.data import cameras as tcams
from saro_gs_torch.data import ply
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.ops.rasterize import RasterConfig
from saro_gs_torch.parallel import runtime, shard
from saro_gs_torch.scene import Scene
from saro_gs_torch.train import losses
from saro_gs_torch.train import step as tstep
from saro_gs_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARENA = os.path.join(ROOT, "checkpoints", "arena")
W = H = 48
TILE = 16
LAMBDAS = dict(lambda_dssim=0.2, lambda_dtstd=0.01, lambda_dscale_reg=8e-6,
               lambda_dshs_reg=1e-5, lambda_dmotion_reg=1e-5,
               lambda_dplanetv=1e-3, lambda_dtime_smooth=1e-3)
OVERRIDES = dict(kplanes_config={"grid_dimensions": 2,
                                 "input_coordinate_dim": 4,
                                 "output_coordinate_dim": 8,
                                 "resolution": [16, 16, 16, 8]},
                 deform_hidden_dim=16, scale_reg=True, shs_reg=True,
                 motion_reg=True)
N_POINTS = 400


def port_config():
    cfg = tcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    for k, v in OVERRIDES.items():
        setattr(cfg, k, v)
    return cfg


def statics(cfg) -> tstep.StepStatics:
    return tstep.StepStatics(
        mcfg=cfg.model_config(),
        rcfg=RasterConfig(tile_x=TILE, tile_y=TILE, chunk=64,
                          max_instances=1 << 13, tight_rect=True),
        weights=losses.LossWeights(**LAMBDAS), width=W, height=H,
        cfg_lrs=tstep.make_lr_statics(cfg), extent=1.3, scale_floor=1e-4)


def views(batch, idx):
    """The views ``idx`` of a (cams [5 arrays], gt, ts) numpy batch, as
    the step's tensors."""
    cams, gt, ts = batch
    return (CameraParams(*[torch.as_tensor(np.asarray(x)[idx])
                           for x in cams]),
            torch.as_tensor(gt[idx]), torch.as_tensor(ts[idx]))


def run_steps(state_np, batch, steps, mesh=None):
    """``steps`` dynamic-stage steps from ``state_np`` on the views of
    ``batch`` (a mesh rank: its data index's share) -> (metrics of each
    step, the final state as numpy)."""
    cfg = port_config()
    state, fstatic = convert.train_state_from_numpy(
        state_np, cfg.model_config(), device="cpu")
    n = batch[1].shape[0]
    idx = np.arange(n) if mesh is None else np.asarray(
        runtime.host_shard(range(n), mesh.data_rank, mesh.n_data))
    cams, gt, ts = views(batch, idx)
    st = statics(cfg)
    metrics = []
    for _ in range(steps):
        if mesh is None:
            state, m = tstep.train_step_core(
                state, cams, gt, ts, torch.ones(3), fstatic, st,
                stage="dynamatic", sh_degree=3, scale_integral=True)
        else:
            state, m = shard.dp_train_step(
                state, cams, gt, ts, torch.ones(3), fstatic, st,
                stage="dynamatic", sh_degree=3, scale_integral=True,
                mesh=mesh)
        metrics.append(m)
    return metrics, convert.train_state_to_numpy(state)


def step_rank(rank, meshes, state_np, batch, steps):
    """On each (n_data, n_tile) mesh in turn: ``steps`` steps from
    ``state_np``; the metrics and the final state, by mesh."""
    torch.set_num_threads(1)
    out = {}
    for shape in meshes:
        mesh = shard.make_mesh(*shape)
        out[shape] = run_steps(state_np, batch, steps, mesh)
    return out


def mesh_place(rank):
    """This rank's (data, tile) place on a 2x2 mesh, whether both groups
    exist, and whether a 1x2 mesh of the 4 ranks is refused."""
    mesh = shard.make_mesh(2, 2)
    try:
        shard.make_mesh(1, 2)
        refused = False
    except ValueError:
        refused = True
    return (mesh.data_rank, mesh.tile_rank,
            mesh.data_group is not None and mesh.tile_group is not None,
            refused)


def fail_on(rank, bad):
    """Rank ``bad`` raises; the others wait for it at a barrier."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


def render_args(seed=5, n=80):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    means = rng.uniform(-1.2, 1.2, (n, 3)).astype(f32)
    scales = rng.uniform(0.05, 0.3, (n, 3)).astype(f32)
    quats = rng.normal(0, 1, (n, 4)).astype(f32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.99, n).astype(f32)
    colors = rng.uniform(0, 1, (n, 3)).astype(f32)
    return means, scales, quats, opac, colors


def write_toy_scene(root, n_train=8, width=40, height=32, seed=7):
    """A Blender/D-NeRF layout the ``blender`` reader takes: ring cameras
    (one test view), smooth random 8-bit images with ``time`` = frame /
    n_train, and an init cloud of N_POINTS points (points3d.ply, which the
    reader keeps)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    os.makedirs(root)
    yy, xx = np.mgrid[0:height, 0:width] / max(width, height)
    frames = {"train": [], "test": []}
    for i, c2w in enumerate(tcams.ring_cameras(n_train + 1)):
        split = "test" if i == 0 else "train"
        f = rng.uniform(1, 4, (3, 2))
        rgb = 0.5 + 0.5 * np.sin(f[:, :1, None] * xx + f[:, 1:, None] * yy
                                 + rng.uniform(0, 6, (3, 1, 1)))
        name = f"r_{i:02d}"
        Image.fromarray((rgb.transpose(1, 2, 0) * 255).astype(np.uint8)) \
            .save(os.path.join(root, name + ".png"))
        frames[split].append({"file_path": name, "time": i / n_train,
                              "transform_matrix": c2w.tolist()})
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.85, "frames": fr}, f)
    xyz = rng.uniform(-1.0, 1.0, (N_POINTS, 3))
    times = rng.uniform(0, 1, (N_POINTS, 1))
    ply.store_point_cloud(os.path.join(root, "points3d.ply"),
                          np.concatenate([xyz, times], axis=1),
                          rng.uniform(0, 255, (N_POINTS, 3)))


def run_trainer(cfg_kw, iterations):
    """``Trainer.run`` on the toy Blender scene -> (the history's losses,
    the state as numpy, whether the scene writes)."""
    cfg = tcfg.load_config(**cfg_kw)
    scene = Scene(cfg, device="cpu")
    tr = Trainer(cfg, scene)
    tr.run(max_iterations=iterations, log_every=1)
    saved = scene.save(iterations, tr.state.points, tr.state.nets,
                       tr.state.alive)
    return ([h["loss"] for h in tr.history],
            convert.train_state_to_numpy(tr.state),
            scene.writes and saved is not None)


def two_rank_run(rank, state_np, batch, steps, render, cam, height,
                 cfg_kw, iterations):
    """Everything the 2-rank tests check, in one process group: the 2x1
    and 1x2 steps, the tile-sharded render, and the trainer on 2 data
    ranks."""
    torch.set_num_threads(1)
    out = {"steps": step_rank(rank, [(2, 1), (1, 2)], state_np, batch,
                              steps)}
    m, s, q, o, c = (torch.as_tensor(x) for x in render)
    cam_t = CameraParams(*[torch.as_tensor(np.asarray(x)) for x in cam])
    out["render"] = shard.tile_sharded_render(
        m, s, q, o, c, cam_t, torch.zeros(3), width=W, height=height,
        tile_x=TILE, tile_y=TILE, max_instances=1 << 13, n_tile=2).numpy()
    out["trainer"] = run_trainer(cfg_kw, iterations)
    return out
