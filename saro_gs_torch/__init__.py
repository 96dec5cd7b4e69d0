"""PyTorch/CUDA port of saro_gs_tpu for one NVIDIA H100.

Module names follow the JAX package, so each module's counterpart is the
file of the same name under ``saro_gs_tpu/``.  This package imports torch
only: never jax, never saro_gs_tpu.

Entry points take an explicit ``device`` and default to ``"cuda"``; with
no card present they raise instead of running on the CPU.  Functions on
tensors run where their inputs live.
"""
from __future__ import annotations

import torch

# float32 products and convolutions run in full float32: TF32 keeps ~3
# decimal digits, and the port is held to the JAX package's float32
# results.  Set explicitly because cuDNN's TF32 default is True.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev
