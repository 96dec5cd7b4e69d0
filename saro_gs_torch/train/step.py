"""The train step as functions of explicit state (counterpart of
train/step.py, with ``TrainState`` of train/trainer.py).

``train_step_core`` is one optimization step over a batch of views:
renders, loss, gradients, the densify statistics, the LR schedules, the
Adam update and the non-finite guard.  What it keeps from the JAX package:

  * the field features depend on (xyz, t_center, scale) only, so they are
    sampled once per step and shared by the views; their gradient is
    accumulated over the views and pushed through the field once;
  * the views run one after the other (the JAX package's ``lax.map``):
    each view's graph is differentiated and freed before the next one is
    built, so memory stays at one view's worth;
  * a step whose loss or gradients are not finite changes nothing but the
    step counter and the health counters.

The parameter leaves, in the order every flat list here uses, are the
seven ``GaussianParams`` fields and then ``DeformNets.leaves()``.  The
nets are an ``nn.Module`` and are updated in place; everything else of the
state is replaced, not mutated.  The mesh branches of the JAX package
(``axis_name``, ``axis_tile``) are not ported yet.
"""
from __future__ import annotations

import copy
import math
from typing import NamedTuple

import torch

from .. import timing
from ..models import densify as dens
from ..models import field as field_mod
from ..models import gaussians as gm
from ..ops.projection import CameraParams
from ..render import train_render
from . import losses, optim


class TrainState(NamedTuple):
    points: gm.GaussianParams
    nets: gm.DeformNets
    opt: optim.AdamState           # over param_leaves(points, nets)
    alive: torch.Tensor            # [C]
    aux: dens.DensifyAux
    inv_integral: torch.Tensor     # [C, 1] LR scaling (refreshed / 50 it)
    inv_integral_densify: torch.Tensor  # [C, 1]
    step: int
    dropped_hwm: int = 0           # most instances dropped in one view
    bad_steps: int = 0             # cumulative non-finite steps


def param_leaves(points: gm.GaussianParams, nets: gm.DeformNets) -> list:
    return list(points) + nets.leaves()


def init_state(points: gm.GaussianParams, nets: gm.DeformNets,
               alive: torch.Tensor) -> TrainState:
    """A fresh state at step 0: zero moments and statistics, unit LR
    scaling."""
    cap = alive.shape[0]
    dev = alive.device
    return TrainState(
        points=points, nets=nets,
        opt=optim.init_adam(param_leaves(points, nets)), alive=alive,
        aux=dens.init_aux(cap, dev),
        inv_integral=torch.ones((cap, 1), device=dev),
        inv_integral_densify=torch.ones((cap, 1), device=dev), step=0)


def clone_state(state: TrainState) -> TrainState:
    """A copy that shares nothing with ``state`` (the step updates the
    nets in place)."""
    def c(x):
        return x.detach().clone()
    return state._replace(
        points=gm.GaussianParams(*[c(x) for x in state.points]),
        nets=copy.deepcopy(state.nets),
        opt=optim.AdamState(mu=[c(x) for x in state.opt.mu],
                            nu=[c(x) for x in state.opt.nu],
                            count=state.opt.count),
        alive=c(state.alive), aux=dens.DensifyAux(*[c(x) for x in state.aux]),
        inv_integral=c(state.inv_integral),
        inv_integral_densify=c(state.inv_integral_densify))


class StepStatics(NamedTuple):
    """Everything static for a step."""
    mcfg: object           # gm.ModelConfig
    rcfg: object           # RasterConfig
    weights: object        # LossWeights
    width: int
    height: int
    cfg_lrs: tuple         # see make_lr_statics
    extent: float
    # relative scale floor (x extent); 0 = off, as the reference
    scale_floor: float = 0.0


def make_lr_statics(cfg) -> tuple:
    return (cfg.position_lr_init, cfg.position_lr_final,
            cfg.position_lr_delay_mult, cfg.position_lr_max_steps,
            cfg.feature_lr, cfg.opacity_lr, cfg.scaling_lr,
            cfg.rotation_lr, cfg.trbfc_lr, cfg.mlp_lr, cfg.mlp_lr_final,
            cfg.hexplane_lr, cfg.hexplane_lr_final)


def _masked_std(x, mask):
    n = torch.clamp_min(mask.sum(), 2.0)
    mean = (x * mask).sum() / n
    var = (mask * (x - mean) ** 2).sum() / (n - 1.0)
    return torch.sqrt(var)


def batch_loss_fn(points: gm.GaussianParams, nets: gm.DeformNets, *, cams,
                  gt, timestamps, alive, bg, fstatic, st: StepStatics,
                  stage: str, sh_degree: int, sh_mask=None):
    """Mean loss over the view batch and its gradients.

    ``cams`` is a CameraParams whose leaves carry a leading batch axis.
    Returns (loss, (radii [B, C], ll1, dropped, last image), grads) with
    grads = (g_leaves in ``param_leaves`` order, g_m2d [B, C, 2]): the
    gradient of the mean loss, and of the mean loss with respect to each
    view's ``mean2d_dummy``."""
    mcfg, rcfg, weights = st.mcfg, st.rcfg, st.weights
    alive_col = alive[:, None]
    batch = gt.shape[0]
    cap = alive.shape[0]
    dynamic = stage == "dynamatic"

    pts = gm.GaussianParams(*[p.detach().requires_grad_() for p in points])
    net_leaves = nets.leaves()
    n_planes = len(nets.field.planes)
    timing.mark("start")
    # the field features do not depend on the view's timestamp
    # (saro_gaussian.py:780): sample once, share across the batch
    feat_graph = feat = None
    if dynamic:
        feat_graph = gm.field_feat(pts, nets, mcfg, fstatic)
        feat = feat_graph.detach().requires_grad_()
    timing.mark("field_features")
    inputs = list(pts) + net_leaves + ([feat] if dynamic else [])
    acc = [None] * len(inputs)
    g_m2d, radii, loss_all, ll1_all = [], [], [], []
    dropped = 0
    color = None
    use_grids = weights.lambda_dplanetv > 0 or weights.lambda_dtime_smooth > 0

    for i in range(batch):
        cam = CameraParams(*[x[i] for x in cams])
        m2d = torch.zeros((cap, 2), dtype=torch.float32, device=alive.device,
                          requires_grad=True)
        pkg = train_render(
            cam, timestamps[i], pts, nets, alive, mcfg, fstatic, bg,
            width=st.width, height=st.height, stage=stage,
            sh_degree=sh_degree, rcfg=rcfg, mean2d_dummy=m2d, feat=feat,
            sh_mask=sh_mask)
        color = pkg.out.color
        d = pkg.deform
        loss, logs = losses.composite_loss(
            weights, color, gt[i],
            scale_residual=(None if d is None or d.scale_residual is None
                            else d.scale_residual * alive_col),
            shs_residual=(None if d is None or d.shs_residual is None
                          else d.shs_residual * alive_col[..., None]),
            motion_residual=(None if d is None or d.motion_residual is None
                             else d.motion_residual * alive_col),
            active_sh_degree=sh_degree, sh_mask=sh_mask,
            grids=list(nets.field.planes) if use_grids else None,
            plane_tv_fn=field_mod.plane_tv,
            time_smooth_fn=field_mod.time_smoothness)
        if weights.lambda_dtstd > 0 and dynamic:
            ltstd = 1.0 - _masked_std(
                gm.get_temporal_pos(pts, mcfg)[:, 0], alive)
            loss = loss + weights.lambda_dtstd * ltstd
        timing.mark("loss")
        # this view's share of the mean loss, differentiated now so its
        # graph is freed before the next view is rendered
        grads = torch.autograd.grad(loss / batch, inputs + [m2d],
                                    allow_unused=True)
        timing.mark("deform_backward")
        for k, g in enumerate(grads[:-1]):
            if g is not None:
                acc[k] = g if acc[k] is None else acc[k] + g
        g_m2d.append(grads[-1] if grads[-1] is not None
                     else torch.zeros_like(m2d))
        radii.append(pkg.out.radii)
        loss_all.append(loss.detach())
        ll1_all.append(logs["Ll1"].detach())
        dropped = max(dropped, pkg.out.num_dropped)
        color = color.detach()

    if dynamic and acc[-1] is not None:
        # the views' feature gradient through the field, once
        g_planes = torch.autograd.grad(feat_graph, net_leaves[:n_planes],
                                       acc[-1], allow_unused=True)
        for k, g in enumerate(g_planes):
            j = len(pts) + k
            if g is not None:
                acc[j] = g if acc[j] is None else acc[j] + g
    timing.mark("field_backward")
    leaves = list(pts) + net_leaves
    g_leaves = [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, acc[:len(leaves)])]
    loss = torch.stack(loss_all).mean()
    ll1 = torch.stack(ll1_all).mean()
    return (loss, (torch.stack(radii), ll1, dropped, color),
            (g_leaves, torch.stack(g_m2d)))


def lr_trees(step: int, inv_integral, points: gm.GaussianParams,
             nets: gm.DeformNets, st: StepStatics, *, stage: str,
             scale_integral: bool):
    """LRs and weight decays per update_learning_rate
    (saro_gaussian.py:345-398), as flat lists in ``param_leaves`` order."""
    (pli, plf, pldm, plms, feat_lr, op_lr, sc_lr, rot_lr, tc_lr,
     mlp_i, mlp_f, hex_i, hex_f) = st.cfg_lrs
    ext = st.extent
    inv = inv_integral[:, 0] if stage == "dynamatic" else 1.0
    xyz_lr = optim.expon_lr(step, pli * ext, plf * ext, plms,
                            lr_delay_mult=pldm)
    mlp_lr = optim.expon_lr(step, mlp_i, mlp_f, plms)
    hex_lr = optim.expon_lr(step, hex_i, hex_f, plms)
    points_lr = gm.GaussianParams(
        xyz=xyz_lr * inv, features_dc=feat_lr * inv,
        features_rest=feat_lr / 20.0,
        scaling=sc_lr * inv if scale_integral else sc_lr,
        rotation=rot_lr * inv, opacity=op_lr * inv,
        temporal_pos=tc_lr * inv)
    n_planes = len(nets.field.planes)
    n_nets = len(nets.leaf_names())
    nets_lr = [hex_lr] * n_planes + [mlp_lr] * (n_nets - n_planes)
    wd = 8e-7 if stage == "dynamatic" else 0.0
    return (list(points_lr) + nets_lr,
            [0.0] * len(points_lr) + [wd] * n_nets)


def train_step_core(state: TrainState, cams, gt, timestamps, bg, fstatic,
                    st: StepStatics, *, stage: str, sh_degree: int,
                    scale_integral: bool, sh_mask=None):
    """One optimization step -> (new state, metrics).

    ``gt`` [B, 3, H, W] is float32 in [0, 1] or uint8 (decoded here, so the
    host sends a quarter of the bytes).  The metrics are python numbers:
    the guard reads them, with its flags, in one transfer from the card."""
    if gt.dtype == torch.uint8:
        gt = gt.to(torch.float32) * (1.0 / 255.0)
    batch = gt.shape[0]

    loss, (radii, ll1, dropped, last_img), (g_leaves, g_m2d) = \
        batch_loss_fn(state.points, state.nets, cams=cams, gt=gt,
                      timestamps=timestamps, alive=state.alive, bg=bg,
                      fstatic=fstatic, st=st, stage=stage,
                      sh_degree=sh_degree, sh_mask=sh_mask)

    with torch.no_grad():
        # densify statistics (train.py:278-292).  The reference accumulates
        # the screen-gradient norm of each view's own loss; the batch loss
        # is the mean over views, so undo the 1/B on the dummy gradients
        norms = torch.linalg.norm(g_m2d, dim=-1) * batch
        vis = radii > 0
        vis_count = vis.sum(dim=0)
        summed = norms.sum(dim=0)
        max_radii = radii.max(dim=0).values
        seen = vis_count > 0
        batch_grad = torch.where(seen, summed / torch.clamp_min(vis_count, 1),
                                 torch.zeros_like(summed))
        aux = dens.add_stats(state.aux, batch_grad, seen, max_radii)

        n_pts = len(state.points)
        if stage != "dynamatic":
            tpos = gm.GaussianParams._fields.index("temporal_pos")
            g_leaves = [torch.zeros_like(g) if k >= n_pts or k == tpos else g
                        for k, g in enumerate(g_leaves)]

        lrs, wds = lr_trees(state.step, state.inv_integral, state.points,
                            state.nets, st, stage=stage,
                            scale_integral=scale_integral)
        leaves = param_leaves(state.points, state.nets)
        new_leaves, new_opt = optim.adam_step(state.opt, leaves, g_leaves,
                                              lrs, wds)
        # physical projection: under the per-Gaussian integral LR scaling
        # Adam's log-space steps can run a scale away until exp()
        # overflows; cap at twice the camera extent
        pts = gm.GaussianParams(*new_leaves[:n_pts])
        scaling = torch.clamp_max(pts.scaling,
                                  math.log(2.0 * st.extent + 1e-6))
        if st.scale_floor > 0.0:
            scaling = torch.clamp_min(scaling,
                                      math.log(st.scale_floor * st.extent))
        pts = pts._replace(scaling=scaling)

        # non-finite guard: one bad frame must not poison the run.  The
        # flags, the per-group max |grad| and the scalar metrics travel to
        # the host in one tensor.  bad_src is a bitmask of the gradient
        # groups that went non-finite (decode with bad_src_names); g_m2d
        # counts because it feeds the persistent densify statistics.
        groups = [(name, [g]) for name, g in
                  zip(gm.GaussianParams._fields, g_leaves[:n_pts])]
        groups += [("nets", g_leaves[n_pts:]), ("mean2d", [g_m2d])]
        flags = [torch.isfinite(loss)]
        gmaxs = []
        for _, gs in groups:
            flags.append(torch.stack(
                [torch.isfinite(g.sum()) for g in gs]).all())
            gmaxs.append(torch.stack([g.abs().max() for g in gs]).max())
        psnr = losses.psnr(torch.clamp(last_img, 0, 1), gt[-1])
        packed = torch.stack(
            [f.to(torch.float32) for f in flags] + gmaxs
            + [loss, ll1, state.inv_integral.max(), psnr]).tolist()
        n_flags = len(flags)
        ok = [v > 0.5 for v in packed[:n_flags]]
        finite = all(ok)
        bad_src = sum(1 << bit for bit, good in enumerate(ok) if not good)
        gmax = {name: packed[n_flags + k]
                for k, (name, _) in enumerate(groups)}
        loss_v, ll1_v, inv_max_v, psnr_v = packed[n_flags + len(groups):]

        if finite:
            for p, new in zip(state.nets.leaves(), new_leaves[n_pts:]):
                p.copy_(new)
            new_state = state._replace(points=pts, opt=new_opt, aux=aux)
        else:
            new_state = state
        # the health counters move on skipped steps too
        new_state = new_state._replace(
            step=state.step + 1,
            dropped_hwm=max(state.dropped_hwm, int(dropped)),
            bad_steps=state.bad_steps + (0 if finite else 1))
    timing.mark("adam_guard")

    metrics = {"loss": loss_v, "Ll1": ll1_v, "dropped": int(dropped),
               "bad_step": 0 if finite else 1, "bad_src": bad_src,
               "gmax": gmax, "inv_lr_max": inv_max_v, "psnr": psnr_v}
    return new_state, metrics


def bad_src_names(mask: int):
    """Decode metrics['bad_src'] into the non-finite gradient groups."""
    names = ["loss"] + list(gm.GaussianParams._fields) + ["nets", "mean2d"]
    return [n for i, n in enumerate(names) if mask & (1 << i)]
