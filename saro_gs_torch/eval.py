"""Evaluation: metrics, the FPS protocol, render dumps (counterpart of
eval.py; the reference's test.py:61-181).

Per-view PSNR, SSIM and MS-SSIM by ``train/losses.py`` and LPIPS (alex)
by ``train/lpips.py``, whose weights resolve as the JAX package's do (a
local npz, else the seed-0 fixture: ``LPIPS-weights`` names which; with
``SARO_LPIPS_FIXTURE=0`` and no npz both LPIPS entries are None); renders,
ground truth and viridis depth (and the lifespan segmentation) as PNGs,
encoded by PIL on a few threads beside the renders; the FPS protocol of
the reference: 4 passes over the views, the first 10 frames of each
discarded, each frame timed to a ``torch.cuda.synchronize``.

A view is scored only as a whole: where a view's instances overflow the
capacity (``num_dropped`` > 0), the capacity is raised to hold them and
the view rendered again (``Evaluator.render_view``), since the reference
sizes its buffers per call and never drops.  The JAX package sizes the
capacity from the first view alone and scores a truncated later view.
"""
from __future__ import annotations

import collections
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from .data.cameras import Camera
from .models import gaussians as gm
from .render import test_render
from .train import losses, lpips


# render_set's PNG dumps: encoder threads, and how many dumps may wait
DUMP_THREADS, DUMP_BACKLOG = 4, 16
# the most instance slots a view is rendered at: a view that still drops
# there raises
MAX_INSTANCES = 1 << 31


def capacity_for(need: int) -> int:
    """The instance capacity for a view of ``need`` instances: a power of
    two at or above 1.3 x ``need`` (30% headroom)."""
    return 1 << max(int(need * 1.3) - 1, 1).bit_length()


def save_png(path: str, img: np.ndarray):
    """img [3, H, W] or [H, W] float in [0, 1]."""
    from PIL import Image
    if img.ndim == 3:
        arr = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1)
               * 255).astype(np.uint8)
    else:
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_depth_png(path: str, depth: np.ndarray):
    """A depth map [H, W], stretched to its own range, as viridis."""
    dmin, dmax = depth.min(), depth.max()
    save_png(path, viridis((depth - dmin) / max(dmax - dmin, 1e-6)))


def viridis(x: np.ndarray) -> np.ndarray:
    """A small viridis colormap for the depth dumps: x in [0, 1] ->
    [3, H, W]."""
    anchors = np.array([
        [0.267, 0.005, 0.329], [0.283, 0.141, 0.458], [0.254, 0.265, 0.530],
        [0.207, 0.372, 0.553], [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
        [0.135, 0.659, 0.518], [0.267, 0.749, 0.441], [0.478, 0.821, 0.318],
        [0.741, 0.873, 0.150], [0.993, 0.906, 0.144]])
    x = np.clip(x, 0, 1) * (len(anchors) - 1)
    i0 = np.floor(x).astype(int)
    i1 = np.clip(i0 + 1, 0, len(anchors) - 1)
    f = (x - i0)[..., None]
    rgb = anchors[i0] * (1 - f) + anchors[i1] * f
    return np.moveaxis(rgb, -1, 0)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Evaluator:
    """Renders and scores camera sets of ``scene``'s model on the scene's
    device, from ``max_instances`` instance slots (default the config's).
    ``rerendered`` holds (view, dropped, old capacity, new capacity) for
    each view rendered again at a larger capacity."""

    def __init__(self, cfg, scene, max_instances=None):
        self.cfg = cfg
        self.scene = scene
        self.device = scene.device
        self.mcfg = cfg.model_config()
        self.rcfg = cfg.raster_config()
        if max_instances is not None:
            self.rcfg = self.rcfg._replace(max_instances=max_instances)
        self.rerendered = []
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
            device=self.device)

    def render(self, cam: Camera, points, nets, alive, feat, sh_degree,
               require_segment=False):
        return test_render(cam.raster_params(self.device), cam.timestamp,
                           points, nets, alive, self.mcfg, self.scene.fstatic,
                           self.bg, width=cam.width, height=cam.height,
                           sh_degree=sh_degree, rcfg=self.rcfg, feat=feat,
                           require_segment=require_segment)

    def render_view(self, cam: Camera, points, nets, alive, feat, sh_degree,
                    require_segment=False):
        """``render`` of the whole view: where instances were dropped, the
        capacity is raised to ``capacity_for`` the view's instances (at
        most MAX_INSTANCES) and the view rendered again.  Raises if a view
        still drops at MAX_INSTANCES slots."""
        out, seg = self.render(cam, points, nets, alive, feat, sh_degree,
                               require_segment)
        while out.num_dropped > 0:
            cap = self.rcfg.max_instances
            need = out.num_instances + out.num_dropped
            if cap >= MAX_INSTANCES:
                raise RuntimeError(
                    f"view {cam.image_name!r}: {out.num_dropped} of {need} "
                    f"instances dropped at {cap} slots")
            new = min(capacity_for(need), MAX_INSTANCES)
            print(f"[eval] view {cam.image_name!r}: {out.num_dropped} of "
                  f"{need} instances dropped at max_instances {cap}; "
                  f"rendered again at {new}", flush=True)
            self.rerendered.append((cam.image_name, out.num_dropped, cap,
                                    new))
            self.rcfg = self.rcfg._replace(max_instances=new)
            out, seg = self.render(cam, points, nets, alive, feat, sh_degree,
                                   require_segment)
        return out, seg

    def render_set(self, name: str, cameras: List[Camera],
                   points: gm.GaussianParams, nets: gm.DeformNets,
                   alive, iteration="best", require_segment=False,
                   save_every: int = 1, measure_fps: bool = True,
                   has_gt: bool = True):
        """test.py:61-181: dumps under <model>/<name>/ours_<iteration>/,
        means in <iteration>_runtimeresults.json, per-view values in
        <iteration>_runtimeperview.json."""
        cfg = self.cfg
        out_root = os.path.join(cfg.model_path, name, f"ours_{iteration}")
        for sub in ("renders", "gt", "depth") + (
                ("segment",) if require_segment else ()):
            os.makedirs(os.path.join(out_root, sub), exist_ok=True)
        sh_degree = self.mcfg.sh_degree
        # the field features do not depend on the view (get_deformfeature,
        # saro_gaussian.py:863)
        with torch.no_grad():
            feat = gm.field_feat(points, nets, self.mcfg, self.scene.fstatic)
        # instance capacity for this model: one probe frame, 30% headroom,
        # a power of two; a later view that needs more raises it
        probe, _ = self.render(cameras[0], points, nets, alive, feat,
                               sh_degree)
        self.rcfg = self.rcfg._replace(max_instances=capacity_for(
            probe.num_instances + probe.num_dropped))

        use_lpips = lpips.lpips_available("alex")
        psnrs, ssims, msssims, lpipss = [], [], [], []
        # the dumps are encoded on threads (PIL's encoder and numpy run
        # without the interpreter lock), at most DUMP_BACKLOG waiting
        dumps = collections.deque()

        def dump(fn, sub, idx, img):
            dumps.append(pool.submit(fn, os.path.join(out_root, sub,
                                                      f"{idx:05d}.png"), img))
            while len(dumps) > DUMP_BACKLOG:
                dumps.popleft().result()
        with ThreadPoolExecutor(DUMP_THREADS) as pool:
            for idx, cam in enumerate(cameras):
                out, seg = self.render_view(cam, points, nets, alive, feat,
                                            sh_degree, require_segment)
                img_t = torch.clamp(out.color, 0, 1)
                saved = idx % save_every == 0
                if has_gt and cam.has_image:
                    gt = cam.load_image(cfg.white_background)
                    gt_t = torch.as_tensor(gt, device=self.device)
                    psnrs.append(float(losses.psnr(img_t, gt_t)))
                    ssims.append(float(losses.ssim(img_t, gt_t)))
                    msssims.append(float(losses.msssim(img_t, gt_t)))
                    if use_lpips:
                        lpipss.append(float(lpips.lpips(img_t, gt_t,
                                                        "alex")))
                    if saved:
                        dump(save_png, "gt", idx, gt)
                if saved:
                    dump(save_png, "renders", idx, img_t.cpu().numpy())
                    dump(save_depth_png, "depth", idx,
                         out.depth.cpu().numpy())
                    if seg is not None:
                        dump(save_png, "segment", idx,
                             torch.clamp(seg.color, 0, 1).cpu().numpy())
            while dumps:
                dumps.popleft().result()

        # the FPS protocol (test.py:150-163), at a capacity that holds
        # every view
        fps = None
        if measure_fps and len(cameras) > 10:
            warmup = 10
            durations = []
            for _ in range(4):
                spent = 0.0
                for i, cam in enumerate(cameras):
                    _sync(self.device)
                    t0 = time.perf_counter()
                    self.render(cam, points, nets, alive, feat, sh_degree)
                    _sync(self.device)
                    if i >= warmup:
                        spent += time.perf_counter() - t0
                durations.append(spent / (len(cameras) - warmup))
            fps = 1.0 / float(np.mean(durations))

        results = {
            "PSNR": float(np.mean(psnrs)) if psnrs else None,
            "SSIM": float(np.mean(ssims)) if ssims else None,
            "MS-SSIM": float(np.mean(msssims)) if msssims else None,
            "LPIPS-alex": float(np.mean(lpipss)) if lpipss else None,
            # "fixture-random-seed0" values are a relative random-feature
            # distance, not comparable to published LPIPS
            "LPIPS-weights": lpips.weights_source("alex"),
            "FPS": fps,
            "num_views": len(cameras),
        }
        with open(os.path.join(cfg.model_path,
                               f"{iteration}_runtimeresults.json"),
                  "w") as f:
            json.dump(results, f, indent=True)
        with open(os.path.join(cfg.model_path,
                               f"{iteration}_runtimeperview.json"),
                  "w") as f:
            json.dump({"PSNR": dict(enumerate(psnrs)),
                       "SSIM": dict(enumerate(ssims))}, f, indent=True)
        return results


def quick_test_report(trainer, cameras: List[Camera], max_views=None,
                      histograms: bool = True) -> dict:
    """Validation during training over ``cameras`` (training_report,
    train.py:305-438), at the trainer's active SH degree and from its
    instance capacity: the means of L1, PSNR, SSIM and MS-SSIM, the
    per-view PSNR series (:372-381) and the opacity and t-centre
    histograms of the live points (:391-408)."""
    st = trainer.state
    ev = Evaluator(trainer.cfg, trainer.scene,
                   max_instances=trainer.rcfg.max_instances)
    with torch.no_grad():
        feat = gm.field_feat(st.points, st.nets, trainer.mcfg,
                             trainer.scene.fstatic)
    per_view = {"psnr": [], "ssim": [], "msssim": [], "l1": []}
    for cam in cameras[:max_views]:
        out, _ = ev.render_view(cam, st.points, st.nets, st.alive, feat,
                                trainer.active_sh_degree)
        img = torch.clamp(out.color, 0, 1)
        gt = torch.as_tensor(cam.load_image(trainer.cfg.white_background),
                             device=trainer.device)
        v = torch.stack([losses.psnr(img, gt), losses.ssim(img, gt),
                         losses.msssim(img, gt),
                         (img - gt).abs().mean()]).tolist()
        for key, x in zip(per_view, v):
            per_view[key].append(x)
    pv = np.asarray(per_view["psnr"])
    rep = {
        "PSNR": float(pv.mean()), "SSIM": float(np.mean(per_view["ssim"])),
        "MS-SSIM": float(np.mean(per_view["msssim"])),
        "L1": float(np.mean(per_view["l1"])),
        "PSNR_per_view": [round(v, 3) for v in per_view["psnr"]],
        "PSNR_spread": {"std": float(pv.std()), "min": float(pv.min()),
                        "max": float(pv.max())},
    }
    if histograms:
        alive = st.alive.cpu().numpy() > 0
        opac = gm.get_opacity(st.points)[:, 0].cpu().numpy()[alive]
        tc = gm.get_temporal_pos(st.points,
                                 trainer.mcfg)[:, 0].cpu().numpy()[alive]
        rep["opacity_hist"] = np.histogram(
            opac, bins=20, range=(0.0, 1.0))[0].tolist()
        tc_counts, tc_edges = np.histogram(tc, bins=20)
        rep["tcenter_hist"] = {"counts": tc_counts.tolist(),
                               "range": [float(tc_edges[0]),
                                         float(tc_edges[-1])]}
    return rep


def quick_test_psnr(trainer, cameras: List[Camera], max_views=None) -> float:
    """The mean PSNR of ``quick_test_report``."""
    return quick_test_report(trainer, cameras, max_views,
                             histograms=False)["PSNR"]
