"""Loss and image-quality metrics (counterpart of train/losses.py).

The reference's loss library (utils/loss_utils.py, helper_train.py:50) and
metrics (utils/image_utils.py): windowed SSIM (11x11, sigma 1.5), MS-SSIM,
per-channel PSNR, and the composite training loss with the
temporal-centre-std, residual-norm and plane regularizers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import ssim as ssim_ops


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


def _ssim_stats(img1, img2):
    p = ssim_ops.parts(img1, img2)
    return p.ssim_map, p.num2 / p.den2


def ssim(img1, img2):
    """Windowed SSIM with the reference's 11x11 sigma-1.5 kernel and zero
    padding (utils/loss_utils.py:38-68): kernel pair K5 on the card, its
    plain version on the CPU (ops/ssim.py)."""
    return ssim_ops.ssim(img1.contiguous(), img2.contiguous())


def ssim_map(img1, img2):
    """Per-pixel SSIM map (utils/loss_utils.ssimmap:71-101)."""
    return _ssim_stats(img1, img2)[0]


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim(img1, img2):
    """Multi-scale SSIM (Wang et al. weights), as
    torchmetrics.MultiScaleStructuralSimilarityIndexMeasure(data_range=1)."""
    levels = len(_MSSSIM_WEIGHTS)
    vals = []
    x, y = img1, img2
    for i in range(levels):
        s_map, cs_map = _ssim_stats(x, y)
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
