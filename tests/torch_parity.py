"""Helpers shared by the tests that hold saro_gs_torch against saro_gs_tpu:
the same numpy inputs go to both packages."""
from __future__ import annotations

import numpy as np
import torch

from saro_gs_torch.ops.projection import CameraParams as TorchCam

# the suite runs several test files at once (pytest-xdist): keep torch's
# intra-op thread pool from oversubscribing the cores the JAX tests share
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
