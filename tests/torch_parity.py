"""Helpers shared by the tests that hold saro_gs_torch against saro_gs_tpu:
the same numpy inputs go to both packages.

Also the gradient golden: one training view's loss and gradients,
summarized so that a reference run fits in a small file.  The reference
run is made by the JAX package on the CPU
(tests/test_torch_slice.py:make_grads_golden); ``check_gradients`` runs the
same view through the port's ``step.batch_loss_fn`` on any device
(chip_smoke.py runs it on the card) and reports how far the port is from
it.  Both sides build their ground truth with ``noise_gt`` and summarize
with ``summarize``.  This module imports nothing of JAX."""
from __future__ import annotations

import sys

import numpy as np
import torch

from saro_gs_torch.data import cameras
from saro_gs_torch.models import gaussians as gm
from saro_gs_torch.ops.projection import CameraParams as TorchCam
from saro_gs_torch.train import step as step_mod

# the suite runs several test files at once (pytest-xdist): keep torch's
# intra-op thread pool from oversubscribing the cores the JAX tests share
if "pytest" in sys.modules:
    torch.set_num_threads(1)


def torch_cam(cam, device="cpu") -> TorchCam:
    """A JAX-package CameraParams (numpy or jax leaves) as the port's."""
    return TorchCam(*[torch.as_tensor(np.asarray(x, np.float32),
                                      device=device) for x in cam])


def t(x, device="cpu"):
    return torch.as_tensor(np.array(x), device=device)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def psnr(a, b) -> float:
    mse = float(np.mean((n(a).astype(np.float64)
                         - n(b).astype(np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


ROW_STRIDE = 16              # every 16th Gaussian's gradient rows
ROW_STRIDE_WIDE = 64         # features_rest (45 values a row)
PATCH = (slice(None), slice(40, 56), slice(40, 56))   # of plane 0
N_PLANES = 6


def noise_gt(batch: int, height: int, width: int) -> np.ndarray:
    """Uniform-noise ground truth [B, 3, H, W] uint8 from a fixed seed: a
    target that keeps every pixel's gradient path live."""
    rng = np.random.RandomState(0)
    return (rng.uniform(0.0, 1.0, (batch, 3, height, width)) * 255.0
            ).astype(np.uint8)


def _stride(name: str) -> int:
    return ROW_STRIDE_WIDE if name == "features_rest" else ROW_STRIDE


def summarize(loss: float, groups: dict, net_leaf_grads: list) -> dict:
    """loss, per-Gaussian gradient groups {name: [N, ...]} and the net
    leaves' gradients (planes first) -> {key: float32 array}."""
    f32 = np.float32
    out = {"loss": f32(loss)}
    for name, g in groups.items():
        g = np.asarray(g, f32)
        out[f"{name}_norm"] = f32(np.linalg.norm(g.astype(np.float64)))
        out[f"{name}_max"] = f32(np.abs(g).max())
        out[f"{name}_rows"] = g[::_stride(name)]
    planes = [np.asarray(x, f32) for x in net_leaf_grads[:N_PLANES]]
    heads = [np.asarray(x, f32) for x in net_leaf_grads[N_PLANES:]]
    out["planes_norms"] = np.array(
        [np.linalg.norm(p.astype(np.float64)) for p in planes], f32)
    out["planes_max"] = np.array([np.abs(p).max() for p in planes], f32)
    out["plane0_patch"] = planes[0][PATCH]
    out["heads_norms"] = np.array(
        [np.linalg.norm(h.astype(np.float64)) for h in heads], f32)
    out["heads_max"] = np.array([np.abs(h).max() for h in heads], f32)
    return out


def check_gradients(golden_path: str, cfg, params, nets, alive, fstatic,
                    device) -> dict:
    """Run the golden's view through the port and compare.  ``cfg`` is the
    checkpoint's Config.  Returns {"loss", "loss_rel_err", "groups":
    {name: {"rel_err": max abs difference of the sampled entries over the
    reference group's largest entry, "norm_rel_err"}}, "worst_rel_err",
    "worst_norm_rel_err", "dropped"}."""
    g = np.load(golden_path)
    w, h, ts = int(g["width"]), int(g["height"]), float(g["ts"])
    tile = int(g["tile"])
    dev = torch.device(device)
    cam = cameras.camera_from_c2w(
        cameras.ring_cameras(21)[int(g["camera"])], float(g["fovx"]), w, h,
        ts).raster_params(dev)
    cams = TorchCam(*[x[None] for x in cam])
    rcfg = cfg.raster_config()
    if rcfg.tile_x != tile:
        raise ValueError("the golden was made with other tiles")
    st = step_mod.StepStatics(
        mcfg=cfg.model_config(), rcfg=rcfg, weights=cfg.loss_weights(),
        width=w, height=h, cfg_lrs=step_mod.make_lr_statics(cfg),
        extent=1.0)
    gt = torch.as_tensor(noise_gt(1, h, w), device=dev).to(torch.float32) \
        * (1.0 / 255.0)
    loss, (_, _, dropped, _, _), (g_leaves, g_m2d) = step_mod.batch_loss_fn(
        params, nets, cams=cams, gt=gt,
        timestamps=torch.full((1, 1, 1), ts, device=dev), alive=alive,
        bg=torch.ones(3, device=dev), fstatic=fstatic, st=st,
        stage="dynamatic", sh_degree=3)
    fields = gm.GaussianParams._fields
    groups = {k: v.cpu().numpy() for k, v in zip(fields, g_leaves)}
    groups["mean2d"] = g_m2d[0].cpu().numpy()
    mine = summarize(float(loss), groups,
                     [x.cpu().numpy().T if name.endswith(".weight")
                      else x.cpu().numpy() for name, x in
                      zip(nets.leaf_names(), g_leaves[len(fields):])])

    report = {"loss": float(mine["loss"]), "dropped": int(dropped),
              "loss_rel_err": abs(float(mine["loss"]) - float(g["loss"]))
              / abs(float(g["loss"])), "groups": {}}

    def add(name, rel, norm_rel):
        report["groups"][name] = {"rel_err": float(rel),
                                  "norm_rel_err": float(norm_rel)}

    def rel_norm(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    for name in groups:
        ref_max = max(float(g[f"{name}_max"]), 1e-30)
        add(name, np.abs(mine[f"{name}_rows"] - g[f"{name}_rows"]).max()
            / ref_max, rel_norm(mine[f"{name}_norm"], g[f"{name}_norm"]))
    add("plane0_patch",
        np.abs(mine["plane0_patch"] - g["plane0_patch"]).max()
        / max(float(g["planes_max"][0]), 1e-30),
        rel_norm(mine["planes_norms"][0], g["planes_norms"][0]))
    for key in ("planes", "heads"):
        # whole-leaf summaries: the largest entries and the norms
        ref_max = np.maximum(g[f"{key}_max"], 1e-30)
        ref_norm = np.maximum(g[f"{key}_norms"], 1e-30)
        add(key, (np.abs(mine[f"{key}_max"] - g[f"{key}_max"])
                  / ref_max).max(),
            (np.abs(mine[f"{key}_norms"] - g[f"{key}_norms"])
             / ref_norm).max())
    report["worst_rel_err"] = max(v["rel_err"]
                                  for v in report["groups"].values())
    report["worst_norm_rel_err"] = max(v["norm_rel_err"]
                                       for v in report["groups"].values())
    return report
