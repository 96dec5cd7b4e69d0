"""The deformation heads: plain Linear-ReLU stacks (counterpart of
models/mlp.py; the reference's saro_gaussian.py:104-110).

``nn.Linear``'s default initialization is the reference's (uniform in
+-1/sqrt(fan_in) for weight and bias).  The JAX package stores weights as
[in, out]; ``nn.Linear`` keeps [out, in], and ``convert.py`` transposes.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, sizes: Sequence[int],
                 final_activation: Optional[Callable] = None):
        """sizes = [in, h1, ..., out]; ReLU between layers."""
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = torch.relu(x)
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x
