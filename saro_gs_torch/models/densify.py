"""Adaptive density control on capacity-padded tensors (counterpart of
models/densify.py).

The statistics every step merges; the every-50-iterations integral prune
with its inverse-integral LR tensor; and the capacity moves of the
reference's densify/clone/split/prune with their optimizer surgery
(saro_gaussian.py:540-759, helper_train.py:103-174).  New Gaussians go
into dead slots (``alive`` 0) instead of new rows, and the Adam moments
of the rows written are zeroed, which is the state the reference reaches
by concatenating and masking tensors, minus the row order (nothing reads
it: the rasterizer sorts by depth every frame).  A split writes child 1
into the parent's slot and child 2 into a dead slot.

Rows are selected with ``torch.where`` and index writes, never by a
multiplied mask: dead rows may hold non-finite values.  Index writes send
unselected rows to a scratch row past the end, which is then cut off, so
nothing waits on the host for a count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import math3d
from . import gaussians as gm


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


def reset_opacity(params: gm.GaussianParams, mu: gm.GaussianParams,
                  nu: gm.GaussianParams):
    """Clamp opacity to at most 0.01 and zero its Adam moments
    (saro_gaussian.py:451-455).  ``mu``/``nu``: the moments of the point
    leaves, as GaussianParams."""
    new_op = math3d.inverse_sigmoid(
        torch.clamp_max(gm.get_opacity(params), 0.01))
    return (params._replace(opacity=new_op),
            mu._replace(opacity=torch.zeros_like(mu.opacity)),
            nu._replace(opacity=torch.zeros_like(nu.opacity)))


def _dead_slot_lookup(alive: torch.Tensor):
    """(lookup, n_free): lookup[r] = index of the r-th dead slot (else C),
    n_free the number of dead slots (0-d int32)."""
    c = alive.shape[0]
    dead = alive <= 0
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    pos = torch.where(dead, rank, torch.full_like(rank, c)).long()
    lookup = torch.full((c + 1,), c, dtype=torch.int32, device=alive.device)
    lookup[pos] = torch.arange(c, dtype=torch.int32, device=alive.device)
    return lookup[:c], dead.sum().to(torch.int32)


def _scatter_rows(x: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """x with row i of ``src`` written to row idx[i]; idx == C drops."""
    out = torch.cat([x, x[:1]])
    out[idx] = src.to(x.dtype)
    return out[:x.shape[0]]


class DensifyResult(NamedTuple):
    params: gm.GaussianParams
    mu: gm.GaussianParams
    nu: gm.GaussianParams
    alive: torch.Tensor
    aux: DensifyAux
    n_cloned: torch.Tensor     # 0-d int32
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    overflowed: torch.Tensor   # 0-d bool: fewer dead slots than moves


def densify_pruneclone(params: gm.GaussianParams, mu: gm.GaussianParams,
                       nu: gm.GaussianParams, alive: torch.Tensor,
                       aux: DensifyAux, samples, *, grad_threshold: float,
                       min_opacity: float, extent: float,
                       percent_dense: float, max_screen_size,
                       inv_integral: torch.Tensor, integral: torch.Tensor,
                       min_intergral: float, prune_z: bool,
                       prune_big_ws: bool,
                       min_scale_abs: float = 0.0) -> DensifyResult:
    """One densify and prune pass (saro_gaussian.py:646-739).

    ``samples`` (s1, s2): standard normal draws [C, 3], one per split
    child, made by the caller.  ``integral`` [C, 1]: the temporal-opacity
    integral before the pass; ``inv_integral`` [C, 1] scales the gradient
    statistic.  ``max_screen_size`` None skips the size prunes."""
    c = alive.shape[0]
    dev = alive.device
    drop = torch.full((c,), c, dtype=torch.long, device=dev)
    alivef = alive > 0
    grads = aux.xyz_grad_accum / aux.denom
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    grads = (grads * inv_integral)[:, 0]

    scaling = gm.get_scaling(params)
    max_scale = scaling.max(dim=1).values
    hit = (grads >= grad_threshold) & alivef
    clone_mask = hit & (max_scale <= percent_dense * extent)
    split_mask = hit & (max_scale > percent_dense * extent)

    lookup, n_free = _dead_slot_lookup(alive)
    rank_c = torch.cumsum(clone_mask.to(torch.int32), 0) - 1
    n_clone = clone_mask.sum().to(torch.int32)
    rank_s = torch.cumsum(split_mask.to(torch.int32), 0) - 1
    n_split = split_mask.sum().to(torch.int32)

    # clone destinations: dead slots [0, n_clone); split child 2: dead
    # slots [n_clone, n_clone + n_split)
    dest_c = lookup[torch.clamp(rank_c, 0, c - 1).long()].long()
    dest_s2 = lookup[torch.clamp(n_clone + rank_s, 0, c - 1).long()].long()
    fits_c = clone_mask & (rank_c < n_free)
    fits_s = split_mask & (n_clone + rank_s < n_free)
    overflow = (n_clone + n_split) > n_free
    idx_c = torch.where(fits_c, dest_c, drop)
    idx_s2 = torch.where(fits_s, dest_s2, drop)

    def zero_rows(t, idx):
        return gm.GaussianParams(*[_scatter_rows(x, idx, torch.zeros_like(x))
                                   for x in t])

    def select_rows(mask, src, dst):
        m = mask.reshape((-1,) + (1,) * (dst.dim() - 1))
        return torch.where(m, src, dst)

    # clone: raw rows copied (densify_and_clone :685-701), moments zeroed
    # (cat_tensors_to_optimizer :596-617)
    params_new = gm.GaussianParams(*[_scatter_rows(x, idx_c, x)
                                     for x in params])
    mu_new, nu_new = zero_rows(mu, idx_c), zero_rows(nu, idx_c)
    alive_new = _scatter_rows(alive, idx_c, torch.ones_like(alive))

    # split (densify_and_splitv2 :646-682, N=2); every row is computed and
    # the split rows are selected
    s1, s2 = samples
    rot = math3d.quat_to_rotmat_cols(
        *math3d.quat_normalize(params.rotation).unbind(-1))
    rot = torch.stack(rot, dim=-1).reshape(-1, 3, 3)
    samp1 = s1 * scaling
    samp2 = s2 * scaling
    child_xyz1 = (rot * samp1[:, None, :]).sum(-1) + params.xyz
    child_xyz2 = (rot * samp2[:, None, :]).sum(-1) + params.xyz
    child_scaling = torch.log(scaling / (0.8 * 2))
    child1 = params._replace(xyz=child_xyz1, scaling=child_scaling)
    child2 = params._replace(xyz=child_xyz2, scaling=child_scaling)
    # child 1 takes the parent's slot (the reference prunes the parent)
    params_new = gm.GaussianParams(*[select_rows(fits_s, src, dst)
                                     for src, dst in zip(child1,
                                                         params_new)])
    mu_new = gm.GaussianParams(*[select_rows(fits_s, torch.zeros_like(x), x)
                                 for x in mu_new])
    nu_new = gm.GaussianParams(*[select_rows(fits_s, torch.zeros_like(x), x)
                                 for x in nu_new])
    # child 2 into a dead slot
    params_new = gm.GaussianParams(*[_scatter_rows(dst, idx_s2, src)
                                     for src, dst in zip(child2,
                                                         params_new)])
    mu_new, nu_new = zero_rows(mu_new, idx_s2), zero_rows(nu_new, idx_s2)
    alive_new = _scatter_rows(alive_new, idx_s2, torch.ones_like(alive))

    # prune (densify_pruneclone :718-736)
    prune = gm.get_opacity(params_new)[:, 0] < min_opacity
    prune = prune | (integral[:, 0] < min_intergral)
    if prune_z:
        prune = prune | (params_new.xyz[:, 2] < 4.5)
    if max_screen_size is not None:
        # new slots have max_radii2d 0: never too big on screen
        prune = prune | (aux.max_radii2d > max_screen_size)
        if prune_big_ws:
            prune = prune | (gm.get_scaling(params_new).max(dim=1).values
                             > 0.1 * extent)
    if min_scale_abs > 0.0:
        # collapsed-scale prune (config prune_min_scale times the extent;
        # not in the reference): speckle points whose log-scale ran away
        # below any visible size
        prune = prune | (gm.get_scaling(params_new).max(dim=1).values
                         < min_scale_abs)
    alive_out = torch.where(prune, torch.zeros_like(alive_new), alive_new)
    n_pruned = ((alive_new > 0) & prune).sum().to(torch.int32)
    return DensifyResult(params=params_new, mu=mu_new, nu=nu_new,
                         alive=alive_out, aux=init_aux(c, dev),
                         n_cloned=fits_c.sum().to(torch.int32),
                         n_split=fits_s.sum().to(torch.int32),
                         n_pruned=n_pruned, overflowed=overflow)


def prune_mask_only(alive: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain prune (the z-floater prune on real_xyz, train.py:128-142,
    helper_train.py:138-142)."""
    return torch.where(mask, torch.zeros_like(alive), alive)
