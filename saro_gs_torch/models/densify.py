"""Densification statistics and the integral prune (counterpart of the
per-step half of models/densify.py).

Only what the train step and its LR scaling need is here: the statistics
that every step merges, and the every-50-iterations integral prune with
its inverse-integral LR tensor.  The capacity moves (clone, split, prune
into dead slots) and the optimizer surgery come with the trainer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DensifyAux(NamedTuple):
    """Densification statistics (training_setup, saro_gaussian.py:297-303)."""
    xyz_grad_accum: torch.Tensor   # [C, 1]
    denom: torch.Tensor            # [C, 1]
    max_radii2d: torch.Tensor      # [C]


def init_aux(capacity: int, device) -> DensifyAux:
    f32 = torch.float32
    return DensifyAux(
        xyz_grad_accum=torch.zeros((capacity, 1), dtype=f32, device=device),
        denom=torch.zeros((capacity, 1), dtype=f32, device=device),
        max_radii2d=torch.zeros((capacity,), dtype=f32, device=device))


def add_stats(aux: DensifyAux, batch_grad_norm: torch.Tensor,
              visibility: torch.Tensor, radii: torch.Tensor) -> DensifyAux:
    """Per-iteration merge (train.py:278-292 and
    add_densification_stats_grad :745-750): ``batch_grad_norm`` is the
    batch-mean screen-gradient norm over the views that saw the point."""
    vis = visibility.to(torch.float32)
    return DensifyAux(
        xyz_grad_accum=aux.xyz_grad_accum + (batch_grad_norm * vis)[:, None],
        denom=aux.denom + vis[:, None],
        max_radii2d=torch.where(
            visibility,
            torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
            aux.max_radii2d))


def integral_prune_and_lr(alive: torch.Tensor, integral: torch.Tensor,
                          min_intergral: float, clip: float = 0.0):
    """Integral prune and the inverse-integral LR tensor
    (update_learning_rate, saro_gaussian.py:345-398): drop low-integral
    points, then inv = (1/I) / min(1/I) over the survivors.  ``clip`` > 0
    caps the multiplier (config ``inv_lr_clip``); the reference leaves it
    unbounded up to 1/min_intergral.  Returns (alive, inv_integral [C,1])."""
    valid = (integral[:, 0] > min_intergral) & (alive > 0)
    alive_out = torch.where(valid, alive, torch.zeros_like(alive))
    inv = 1.0 / torch.clamp_min(integral[:, 0], 1e-12)
    inv_min = torch.where(valid, inv, torch.full_like(inv, float("inf"))).min()
    inv_min = torch.where(torch.isfinite(inv_min), inv_min,
                          torch.ones_like(inv_min))
    inv_integral = torch.where(valid, inv / inv_min,
                               torch.ones_like(inv))[:, None]
    if clip > 0.0:
        inv_integral = torch.clamp_max(inv_integral, clip)
    return alive_out, inv_integral
