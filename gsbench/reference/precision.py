"""The precision the reference computes in.

The configurations state float32 with TF32 off: the port turns TF32 off
for its products and convolutions, and so does the reference, whatever
the process was set to before.  ``tf32(True)`` is the control's precision,
the nearest one below: products in TF32.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
