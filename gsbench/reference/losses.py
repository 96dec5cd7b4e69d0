"""The training loss and Adam, plain PyTorch: part of the benchmark's
reference; it imports nothing of the program.

Written from the port's plain forms (saro_gs_torch/train/losses.py,
train/optim.py, train/step.py:lr_trees), which follow SaRO-GS
(utils/loss_utils.py, helper_train.py:50-99, saro_gaussian.py:345-398):
L1 and windowed SSIM (11x11, sigma 1.5, zero padding, as two separable
shift-and-add passes), the scale-residual and temporal-centre-std
regularizers, torch-style Adam (eps 1e-15, weight decay added to the
gradient where it is not zero) with per-Gaussian LR columns and the
log-linear LR decay.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


def _taps(window_size=11, sigma=1.5):
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


WINDOW = _taps()


def blur(img, taps=WINDOW):
    k = len(taps)
    h = k // 2
    _, height, width = img.shape
    x = F.pad(img, (0, 0, h, h))
    x = sum(taps[i] * x[:, i:i + height, :] for i in range(k))
    x = F.pad(x, (h, h))
    return sum(taps[i] * x[:, :, i:i + width] for i in range(k))


def ssim(img1, img2):
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu12 + c1) * (2 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))).mean()


def view_loss(cfg: dict, image, gt, scale_residual, t_centers, alive):
    """One view's training loss: (loss, L1)."""
    ll1 = (image - gt).abs().mean()
    lam = float(cfg.get("lambda_dssim", 0.2))
    if lam > 0:
        loss = (1.0 - lam) * ll1 + lam * (1.0 - ssim(image, gt))
    else:
        loss = ll1
    lscale = float(cfg.get("lambda_dscale_reg", 0.0))
    if lscale > 0 and scale_residual is not None:
        loss = loss + lscale * torch.linalg.norm(
            (scale_residual * alive[:, None]).reshape(-1))
    ltstd = float(cfg.get("lambda_dtstd", 0.0))
    if ltstd > 0:
        n = torch.clamp_min(alive.sum(), 2.0)
        x = t_centers[:, 0]
        mean = (x * alive).sum() / n
        std = torch.sqrt((alive * (x - mean) ** 2).sum() / (n - 1.0))
        loss = loss + ltstd * (1.0 - std)
    return loss, ll1


def expon_lr(step: int, lr_init: float, lr_final: float,
             max_steps: int) -> float:
    """Log-linear decay, evaluated in float32 (no delay steps)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    f32 = np.float32
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    out = np.exp(f32(np.log(lr_init)) * (f32(1) - t)
                 + f32(np.log(lr_final)) * t, dtype=f32)
    return float(f32(1.0) * out)


def learning_rates(cfg: dict, step: int, names, extent: float,
                   inv_integral, scale_integral: bool):
    """(lr, weight decay) per leaf name, dynamic stage."""
    max_steps = int(cfg.get("position_lr_max_steps", 30_000))
    xyz_lr = expon_lr(step, cfg.get("position_lr_init", 1.6e-4) * extent,
                      cfg.get("position_lr_final", 1.6e-6) * extent,
                      max_steps)
    mlp_lr = expon_lr(step, cfg.get("mlp_lr", 1.6e-4),
                      cfg.get("mlp_lr_final", 1.6e-7), max_steps)
    hex_lr = expon_lr(step, cfg.get("hexplane_lr", 3.2e-3),
                      cfg.get("hexplane_lr_final", 3.2e-6), max_steps)
    inv = inv_integral[:, 0]
    feat = cfg.get("feature_lr", 0.0025)
    sc = cfg.get("scaling_lr", 0.005)
    points = {"xyz": xyz_lr * inv, "features_dc": feat * inv,
              "features_rest": feat / 20.0,
              "scaling": sc * inv if scale_integral else sc,
              "rotation": cfg.get("rotation_lr", 0.001) * inv,
              "opacity": cfg.get("opacity_lr", 0.05) * inv,
              "temporal_pos": cfg.get("trbfc_lr", 1e-4) * inv}
    out = {}
    for name in names:
        if name in points:
            out[name] = (points[name], 0.0)
        elif name.startswith("field.planes."):
            out[name] = (hex_lr, 8e-7)
        else:
            out[name] = (mlp_lr, 8e-7)
    return out


def adam(p, g, m, v, count: int, lr, wd: float):
    """One Adam step of one leaf -> (p, m, v)."""
    b1c = float(np.float32(1.0) - np.float32(BETA1) ** np.float32(count))
    b2c = float(np.float32(1.0) - np.float32(BETA2) ** np.float32(count))
    if wd:
        g = g + wd * p
    m = BETA1 * m + (1 - BETA1) * g
    v = BETA2 * v + (1 - BETA2) * g * g
    if isinstance(lr, torch.Tensor) and 0 < lr.dim() < p.dim():
        lr = lr.reshape(lr.shape + (1,) * (p.dim() - lr.dim()))
    p = p - lr * (m / b1c) / (torch.sqrt(v / b2c) + EPS)
    return p, m, v


def scale_cap(extent: float) -> float:
    return math.log(2.0 * extent + 1e-6)
