"""Loss and image-quality metrics (counterpart of train/losses.py).

The reference's loss library (utils/loss_utils.py, helper_train.py:50) and
metrics (utils/image_utils.py): windowed SSIM (11x11, sigma 1.5), MS-SSIM,
per-channel PSNR, and the composite training loss with the
temporal-centre-std, residual-norm and plane regularizers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(x, y):
    return (x - y).abs().mean()


def l2_loss(x, y):
    return ((x - y) ** 2).mean()


def rel_loss(x, y):
    """Relative L1 (utils/loss_utils.py:24-25)."""
    return ((x - y) / (y + 0.001)).abs().mean()


def psnr(img, gt):
    """Per-channel MSE -> PSNR, averaged (utils/image_utils.py:17-21 and
    the ``.mean()`` at its call sites)."""
    c = img.shape[0]
    mse = ((img - gt) ** 2).reshape(c, -1).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()


def _gaussian_taps(window_size=11, sigma=1.5):
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


_WINDOW = _gaussian_taps()


def _depthwise_conv(img, taps):
    """img [C, H, W], separable taps (k,) -> zero-padded same-size blur
    with the outer-product window (the reference's F.conv2d with the 2-D
    Gaussian window, utils/loss_utils.py:27-36).

    Two shift-and-add passes, in the JAX package's order of operations,
    and not a library convolution: cuDNN's backward is not reproducible
    run to run and defaults to TF32, and the train step is held equal to
    the bit across runs."""
    k = len(taps)
    h = k // 2
    _, height, width = img.shape
    x = F.pad(img, (0, 0, h, h))
    x = sum(taps[i] * x[:, i:i + height, :] for i in range(k))
    x = F.pad(x, (h, h))
    return sum(taps[i] * x[:, :, i:i + width] for i in range(k))


def _ssim_stats(img1, img2, window):
    mu1 = _depthwise_conv(img1, window)
    mu2 = _depthwise_conv(img2, window)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _depthwise_conv(img1 * img1, window) - mu1_sq
    s2 = _depthwise_conv(img2 * img2, window) - mu2_sq
    s12 = _depthwise_conv(img1 * img2, window) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
    return ssim_map, cs_map


def ssim(img1, img2):
    """Windowed SSIM with the reference's 11x11 sigma-1.5 kernel and zero
    padding (utils/loss_utils.py:38-68)."""
    return _ssim_stats(img1, img2, _WINDOW)[0].mean()


def ssim_map(img1, img2):
    """Per-pixel SSIM map (utils/loss_utils.ssimmap:71-101)."""
    return _ssim_stats(img1, img2, _WINDOW)[0]


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim(img1, img2):
    """Multi-scale SSIM (Wang et al. weights), as
    torchmetrics.MultiScaleStructuralSimilarityIndexMeasure(data_range=1)."""
    levels = len(_MSSSIM_WEIGHTS)
    vals = []
    x, y = img1, img2
    for i in range(levels):
        s_map, cs_map = _ssim_stats(x, y, _WINDOW)
        if i < levels - 1:
            vals.append(torch.clamp_min(cs_map.mean(), 0.0))
            x = F.avg_pool2d(x[None], 2)[0]
            y = F.avg_pool2d(y[None], 2)[0]
        else:
            vals.append(torch.clamp_min(s_map.mean(), 0.0))
    w = torch.as_tensor(_MSSSIM_WEIGHTS, dtype=img1.dtype,
                        device=img1.device)
    return torch.prod(torch.stack(vals) ** w)


class LossWeights(NamedTuple):
    """The lambda_* knobs (arguments/__init__.py:160-168)."""
    lambda_dssim: float = 0.2
    lambda_dtstd: float = 0.0
    lambda_dscale_reg: float = 0.0
    lambda_dshs_reg: float = 0.0
    lambda_dmotion_reg: float = 0.0
    lambda_dplanetv: float = 0.0
    lambda_dtime_smooth: float = 0.0


def composite_loss(w: LossWeights, image, gt_image, *,
                   t_centers=None,
                   scale_residual=None, shs_residual=None,
                   motion_residual=None, active_sh_degree: int = 3,
                   sh_mask=None,
                   grids=None, plane_tv_fn=None, time_smooth_fn=None):
    """The training loss (helper_train.py:50-99).  Returns (loss, logs).

    ``sh_mask`` ([K, 1] float) supersedes ``active_sh_degree``; ``grids``
    is the field's flat plane list."""
    ll1 = l1_loss(image, gt_image)
    logs = {"Ll1": ll1}
    if w.lambda_dssim > 0:
        ldssim = 1.0 - ssim(image, gt_image)
        loss = (1.0 - w.lambda_dssim) * ll1 + w.lambda_dssim * ldssim
        logs["Ldssim"] = ldssim
    else:
        loss = ll1
    if w.lambda_dtstd > 0 and t_centers is not None:
        ltstd = 1.0 - torch.std(t_centers, unbiased=False)
        loss = loss + w.lambda_dtstd * ltstd
        logs["Ldtstd"] = ltstd
    if w.lambda_dscale_reg > 0 and scale_residual is not None:
        lscale = torch.linalg.norm(scale_residual.reshape(-1))
        loss = loss + w.lambda_dscale_reg * lscale
        logs["Ldscale_reg"] = lscale
    if w.lambda_dshs_reg > 0 and shs_residual is not None:
        if sh_mask is not None:
            r = (shs_residual * sh_mask).reshape(shs_residual.shape[0], -1)
        else:
            k = (active_sh_degree + 1) ** 2
            r = shs_residual[:, :k].reshape(shs_residual.shape[0], -1)
        lshs = torch.linalg.norm(r)
        loss = loss + w.lambda_dshs_reg * lshs
        logs["Ldshs_reg"] = lshs
    if w.lambda_dmotion_reg > 0 and motion_residual is not None:
        lmot = torch.linalg.norm(motion_residual)
        loss = loss + w.lambda_dmotion_reg * lmot
        logs["Ldmotion_reg"] = lmot
    if w.lambda_dplanetv > 0 and grids is not None:
        ltv = plane_tv_fn(grids)
        loss = loss + w.lambda_dplanetv * ltv
        logs["Ldplanetv"] = ltv
    if w.lambda_dtime_smooth > 0 and grids is not None:
        lts = time_smooth_fn(grids)
        loss = loss + w.lambda_dtime_smooth * lts
        logs["Ldtime_smooth"] = lts
    logs["loss"] = loss
    return loss, logs
