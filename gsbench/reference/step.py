"""The reference train step and eval frame, plain PyTorch; part of the
benchmark's reference (no import of the program).

``RefState`` holds the leaves by name (model.leaf_names), Adam's moments
and the step count.  ``train_step`` is one dynamic-stage step over a
batch of views: the field features sampled once, each view deformed,
rendered (render.render_train) and scored, the mean loss differentiated
by autograd, then the LRs, Adam, the scale cap and the non-finite guard,
as SaRO-GS's train step does them (train.py, saro_gaussian.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import losses, model, render


class RefState(NamedTuple):
    leaves: dict      # name -> tensor
    mu: dict
    nu: dict
    count: int
    step: int


class Scene(NamedTuple):
    """What a step or a frame needs besides the leaves."""
    cfg: dict           # the source config's keys
    m: model.Model
    alive: torch.Tensor
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    duration: torch.Tensor
    bg: torch.Tensor
    width: int
    height: int
    tile: int
    extent: float


def init_state(leaves: dict) -> RefState:
    return RefState(leaves={k: v.detach().clone() for k, v in leaves.items()},
                    mu={k: torch.zeros_like(v) for k, v in leaves.items()},
                    nu={k: torch.zeros_like(v) for k, v in leaves.items()},
                    count=0, step=0)


def feat_of(sc: Scene, leaves: dict):
    return model.field_feat(sc.m, leaves, sc.aabb_min, sc.aabb_max,
                            sc.duration)


@torch.no_grad()
def eval_frame(sc: Scene, leaves: dict, feat, cam: render.Camera,
               timestamp: float) -> render.Frame:
    """The eval render of one frame: Gaussians whose survival state is at
    most 1e-3 are left out."""
    d = model.deform(sc.m, leaves, feat, sc.duration, timestamp)
    active = sc.alive * (d.state[:, 0] > model.EVAL_STATE_CUTOFF)
    return render.render(d, cam, active, sc.bg, sc.width, sc.height,
                         sc.tile, sc.m.sh_degree)


def train_step(sc: Scene, st: RefState, cams: list, gts, timestamps,
               scale_integral: bool = True, sh_degree: int = 3):
    """One step -> (state, dict(loss, grads, finite)).  ``cams`` a
    list of render.Camera, ``gts`` [B, 3, H, W] uint8 or float32,
    ``timestamps`` a list of floats or 0-d tensors."""
    if gts.dtype == torch.uint8:
        gts = gts.to(torch.float32) * (1.0 / 255.0)
    names = list(st.leaves)
    leaves = {k: v.detach().requires_grad_() for k, v in st.leaves.items()}
    feat_graph = feat_of(sc, leaves)
    feat = feat_graph.detach().requires_grad_()
    batch = len(cams)
    view_losses = []
    for cam, gt, ts in zip(cams, gts, timestamps):
        d = model.deform(sc.m, leaves, feat, sc.duration, ts,
                         with_residuals=True)
        color = render.render_train(d, cam, sc.alive, sc.bg, sc.width,
                                    sc.height, sc.tile, sh_degree)
        loss, _ = losses.view_loss(sc.cfg, color, gt, d.scale_residual,
                                   model.temporal_pos(sc.m, leaves),
                                   sc.alive)
        (loss * (1.0 / batch)).backward()
        view_losses.append(float(loss.detach()))
    if feat.grad is not None:
        feat_graph.backward(feat.grad)
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
             for k, v in leaves.items()}
    loss = sum(view_losses) / batch
    with torch.no_grad():
        finite = bool(torch.isfinite(torch.tensor(loss))) and all(
            bool(torch.isfinite(g.sum())) for g in grads.values())
        inv = torch.ones((sc.alive.shape[0], 1), device=sc.alive.device)
        lrs = losses.learning_rates(sc.cfg, st.step, names, sc.extent, inv,
                                    scale_integral)
        count = st.count + 1
        new_l, new_m, new_v = {}, {}, {}
        for k in names:
            lr, wd = lrs[k]
            new_l[k], new_m[k], new_v[k] = losses.adam(
                st.leaves[k], grads[k], st.mu[k], st.nu[k], count, lr, wd)
        new_l["scaling"] = torch.clamp_max(new_l["scaling"],
                                           losses.scale_cap(sc.extent))
    if finite:
        new = RefState(leaves=new_l, mu=new_m, nu=new_v, count=count,
                       step=st.step + 1)
    else:
        new = st._replace(step=st.step + 1)
    return new, {"loss": loss, "grads": grads, "finite": finite}
