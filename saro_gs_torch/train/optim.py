"""Adam with per-group LRs and per-Gaussian LR tensors (counterpart of
train/optim.py).

The reference drives torch's Adam (eps 1e-15) with a tensor learning rate
per parameter group: each Gaussian's LR is scaled by the inverse of its
temporal-opacity integral (saro_gaussian.py:323,345-398).
``torch.optim.Adam`` takes no row-wise LR, so this is a small Adam over a
flat list of tensors (the model's leaves in ``step.param_leaves`` order):

  * the moments are lists shaped like the parameters;
  * an LR is a python float, a 0-d tensor or a [C] tensor that broadcasts
    over a parameter's rows;
  * weight decay is torch-style (grad += wd * param).

Nothing is updated in place: a step returns new tensors, so a skipped step
simply keeps the old ones.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15


class AdamState(NamedTuple):
    mu: List[torch.Tensor]   # like the parameter leaves
    nu: List[torch.Tensor]
    count: int


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params], count=0)


def adam_step(state: AdamState, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], lrs: Sequence,
              wds: Sequence[float]):
    """One Adam step over the leaves -> (new_params, new_state)."""
    count = state.count + 1
    # bias corrections in float32, as the JAX package computes them
    b1c = float(np.float32(1.0) - np.float32(BETA1) ** np.float32(count))
    b2c = float(np.float32(1.0) - np.float32(BETA2) ** np.float32(count))
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for p, g, m, v, lr, wd in zip(params, grads, state.mu, state.nu,
                                      lrs, wds):
            g = g + wd * p
            m = BETA1 * m + (1 - BETA1) * g
            v = BETA2 * v + (1 - BETA2) * g * g
            mhat = m / b1c
            vhat = v / b2c
            if isinstance(lr, torch.Tensor) and 0 < lr.dim() < p.dim():
                lr = lr.reshape(lr.shape + (1,) * (p.dim() - lr.dim()))
            new_p.append(p - lr * mhat / (torch.sqrt(vhat) + EPS))
            new_m.append(m)
            new_v.append(v)
    return new_p, AdamState(mu=new_m, nu=new_v, count=count)


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             start_step: int = 0) -> float:
    """Plenoxels-style log-linear LR decay (utils/general_utils.py:76-111),
    evaluated on the host in float32 like the JAX package's traced one."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    f32 = np.float32
    s = f32(step)
    if lr_delay_steps > 0:
        delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(s / f32(lr_delay_steps), 0, 1),
            dtype=f32)
    else:
        delay = f32(1.0)
    t = np.clip(s / f32(max_steps - start_step), f32(0), f32(1))
    log_lerp = np.exp(f32(np.log(lr_init)) * (f32(1) - t)
                      + f32(np.log(lr_final)) * t, dtype=f32)
    out = delay * log_lerp
    # the reference returns lr_init before start_step, 0 for negative steps
    if step < start_step:
        out = f32(lr_init)
    if step < 0:
        out = f32(0.0)
    return float(out)
