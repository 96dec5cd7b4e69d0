"""Windowed SSIM and the gradient of its mean (counterpart of the SSIM of
saro_gs_tpu/train/losses.py, which is plain XLA ops).

The blur is the reference's 11x11, sigma-1.5 Gaussian window with zero
padding (utils/loss_utils.py:27-68), as two shift-and-add passes in the
JAX package's order of operations (``blur``); ``parts`` forms the map from
it.  ``ssim`` is the training loss's SSIM term, forward and backward: on
the card kernel pair K5 (``csrc/ssim.cu``, built and bound by
``tile_kernels``), three kernel launches a view; on the CPU ``parts``
itself, differentiated by autograd.  K5 repeats that arithmetic operation
for operation, the backward in the order autograd's engine runs and
accumulates it, so the terms and d img1 are the eager path's to the bit,
and a train step is; only the mean is summed in another order.  No
gradient goes to img2.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import timing
from . import tile_kernels

C1, C2 = 0.01 ** 2, 0.03 ** 2


def gaussian_taps(window_size=11, sigma=1.5):
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


WINDOW = gaussian_taps()
# the window as the kernel takes it
_TAPS = (ctypes.c_float * len(WINDOW))(*WINDOW)


def blur(img):
    """img [C, H, W] -> its zero-padded same-size blur by the outer product
    of WINDOW with itself (the reference's F.conv2d with the 2-D Gaussian
    window, utils/loss_utils.py:27-36).

    Two shift-and-add passes, in the JAX package's order of operations,
    and not a library convolution: cuDNN's backward is not reproducible
    run to run and defaults to TF32, and the train step is held equal to
    the bit across runs."""
    taps = WINDOW
    k = len(taps)
    h = k // 2
    _, height, width = img.shape
    x = F.pad(img, (0, 0, h, h))
    x = sum(taps[i] * x[:, i:i + height, :] for i in range(k))
    x = F.pad(x, (h, h))
    return sum(taps[i] * x[:, :, i:i + width] for i in range(k))


class Parts(NamedTuple):
    """The per-pixel terms of the SSIM map."""
    mu1: torch.Tensor
    mu2: torch.Tensor
    num1: torch.Tensor      # 2 mu1 mu2 + C1
    num2: torch.Tensor      # 2 s12 + C2
    den1: torch.Tensor      # mu1^2 + mu2^2 + C1
    den2: torch.Tensor      # s1 + s2 + C2
    ssim_map: torch.Tensor  # num1 num2 / (den1 den2)


def parts(img1, img2) -> Parts:
    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    num1, num2 = 2 * mu12 + C1, 2 * s12 + C2
    den1, den2 = mu1_sq + mu2_sq + C1, s1 + s2 + C2
    return Parts(mu1, mu2, num1, num2, den1, den2,
                 (num1 * num2) / (den1 * den2))


def _check_images(img1, img2):
    if img1.dim() != 3 or min(img1.shape) < 1:
        raise ValueError(f"img1 has shape {tuple(img1.shape)}, expected a "
                         "non-empty [C, H, W]")
    if img1.numel() >= (1 << 31):
        raise ValueError("the image must have fewer than 2^31 values")
    for name, t in (("img1", img1), ("img2", img2)):
        tile_kernels._check(t, name, torch.float32, img1.shape, img1.device)


def ssim_forward(img1, img2, need_grad: bool):
    """K5's forward: (the mean [] float32, and where ``need_grad`` the terms
    [6, C, H, W] the backward starts from: mu1, mu2, num1, num2, den1, den2
    of ``parts``, else None).  img1, img2 [C, H, W] float32, contiguous,
    on the card."""
    dev = img1.device
    if dev.type != "cuda":
        raise ValueError(f"ssim: unsupported device {dev}")
    _check_images(img1, img2)
    c, h, w = img1.shape
    n_partial = tile_kernels._fn("ssim", "saro_ssim_partials")(c, h, w)
    partial = torch.empty(n_partial, dtype=torch.float64, device=dev)
    mean = torch.empty((), dtype=torch.float32, device=dev)
    terms = torch.empty((6, c, h, w), dtype=torch.float32, device=dev) \
        if need_grad else None
    err = tile_kernels._fn("ssim")(
        img1.data_ptr(), img2.data_ptr(), c, h, w, _TAPS, C1, C2,
        partial.data_ptr(), mean.data_ptr(),
        None if terms is None else terms.data_ptr(), tile_kernels._stream())
    tile_kernels._launched("ssim", err)
    return mean, terms


def ssim_backward(img1, img2, terms, grad):
    """K5's backward: d img1 [C, H, W] from the forward's terms and the
    mean's cotangent ``grad`` (a [] tensor on the card)."""
    _check_images(img1, img2)
    c, h, w = img1.shape
    tile_kernels._check(terms, "terms", torch.float32, (6, c, h, w),
                        img1.device)
    # each map value's cotangent, divided as MeanBackward divides it
    g_map = grad / img1.numel()
    tile_kernels._check(g_map, "g_map", torch.float32, (), img1.device)
    out = torch.empty_like(img1)
    err = tile_kernels._fn("ssim", "saro_ssim_backward")(
        img1.data_ptr(), img2.data_ptr(), c, h, w, _TAPS, terms.data_ptr(),
        g_map.data_ptr(), out.data_ptr(), tile_kernels._stream())
    tile_kernels._launched("ssim", err)
    return out


class _SSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2):
        mean, terms = ssim_forward(img1, img2, True)
        ctx.save_for_backward(img1, img2, terms)
        return mean

    @staticmethod
    def backward(ctx, grad):
        return ssim_backward(*ctx.saved_tensors, grad), None


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The mean of the SSIM map of img1 and img2 [C, H, W]; differentiable
    in img1 alone (img2 that requires a gradient is refused).  A CPU tensor
    takes ``parts`` and autograd; a CUDA tensor takes K5 (float32,
    contiguous) or raises.  Counts ``ssim`` on the open unit."""
    timing.count("ssim", 1)
    grad = torch.is_grad_enabled()
    if grad and img2.requires_grad:
        raise ValueError("ssim: img2 requires a gradient, which K5 does not "
                         "give")
    if img1.device.type == "cpu":
        return parts(img1, img2).ssim_map.mean()
    if grad and img1.requires_grad:
        return _SSIM.apply(img1, img2)
    return ssim_forward(img1, img2, False)[0]
