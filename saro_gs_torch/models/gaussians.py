"""The 4D Gaussian model: parameters, deformation nets, activations
(counterpart of models/gaussians.py; the reference's saro_gaussian.py).

Per-point parameters are a ``GaussianParams`` tuple of tensors; the field
and the four MLP heads are one ``DeformNets`` module.  ``deform`` is the
temporal model: residual-field features, lifespan and survival state, the
heads' motion/rotation/scale/SH residuals (saro_gaussian.py:779-847);
``temporal_integral`` is the closed-form opacity integral that prunes and
scales learning rates.  ``init_nets`` and ``create_from_pcd`` make a new
model from a point cloud, their draws from a caller's ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops import knn, math3d, sh
from . import field as field_mod
from .mlp import MLP


class ModelConfig(NamedTuple):
    """Static model hyperparameters (same fields as the JAX package)."""
    sh_degree: int = 3
    deform_hidden_dim: int = 128
    deform_time_encode: int = 4
    dx: bool = True
    drot: bool = True
    dopacity: bool = True
    dsh: bool = True
    sigmoid_tcenter: bool = False
    min_intergral: float = 0.1
    min_interval: float = 1.0
    integral_renorm: bool = False
    scale_reg: bool = True
    shs_reg: bool = False
    motion_reg: bool = False
    field: field_mod.FieldConfig = field_mod.FieldConfig()

    @property
    def time_embed_dim(self) -> int:
        return 1 + 2 * self.deform_time_encode


class GaussianParams(NamedTuple):
    """Per-point parameters [N, ...]."""
    xyz: torch.Tensor            # [N, 3]
    features_dc: torch.Tensor    # [N, 1, 3]
    features_rest: torch.Tensor  # [N, 15, 3]
    scaling: torch.Tensor        # [N, 3] (log)
    rotation: torch.Tensor       # [N, 4]
    opacity: torch.Tensor        # [N, 1] (logit)
    temporal_pos: torch.Tensor   # [N, 1]


# the heads in the JAX package's NetParams field order
HEADS = ("motion_mlp", "rot_mlp", "opacity_mlp", "shs_mlp")


class DeformNets(nn.Module):
    """HexPlane field + the four MLP heads (saro_gaussian.py:93-110).  The
    heads are allocated, not initialized: ``init_nets`` or ``convert.py``
    fills them."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.deform_hidden_dim
        fd = cfg.field.feat_dim
        te = cfg.time_embed_dim
        self.field = field_mod.HexPlaneField(cfg.field)
        self.motion_mlp = MLP([te + fd, h, h, 3])
        self.rot_mlp = MLP([te + fd, h, h, 7])
        self.opacity_mlp = MLP([fd, h, h // 2, 1],
                               final_activation=torch.sigmoid)
        self.shs_mlp = MLP([te + fd, h, h, 48])

    def leaf_names(self) -> list:
        """Parameter names in the JAX package's NetParams leaf order: the
        planes, then each head's biases before its weights."""
        names = [f"field.planes.{i}" for i in range(len(self.field.planes))]
        for head in HEADS:
            n_layers = len(getattr(self, head).layers)
            names += [f"{head}.layers.{i}.bias" for i in range(n_layers)]
            names += [f"{head}.layers.{i}.weight" for i in range(n_layers)]
        return names

    def leaves(self) -> list:
        """The parameters in ``leaf_names`` order."""
        return [self.get_parameter(n) for n in self.leaf_names()]


def time_embed(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """NeRF positional encoding of the time distance
    (saro_gaussian.py:922-969): x, then sin/cos at 2^0..2^(L-1)."""
    outs = [x]
    for i in range(cfg.deform_time_encode):
        f = 2.0 ** i
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


# ---- activations (saro_gaussian.py:32-47) ----------------------------------

def get_scaling(p: GaussianParams):
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams):
    return math3d.quat_normalize(p.rotation)


def get_opacity(p: GaussianParams):
    return torch.sigmoid(p.opacity)


def get_temporal_pos(p: GaussianParams, cfg: ModelConfig):
    if cfg.sigmoid_tcenter:
        return torch.sigmoid(p.temporal_pos)
    return p.temporal_pos


def get_features(p: GaussianParams):
    return torch.cat([p.features_dc, p.features_rest], dim=1)


# ---- temporal model ----------------------------------------------------------

def survival_state(dist_over_lifespan: torch.Tensor) -> torch.Tensor:
    """Eq. 9: exp(-4 x^2) (saro_gaussian.py:757-759)."""
    return torch.exp(-4.0 * (dist_over_lifespan * dist_over_lifespan))


def compute_lifespan(nets: DeformNets, cfg: ModelConfig,
                     feat: torch.Tensor, duration) -> torch.Tensor:
    """(1 - min_scale) * (1 - sigmoid-MLP(feat)) + min_scale
    (saro_gaussian.py:782-785)."""
    raw = 1.0 - nets.opacity_mlp(feat)
    # a true division (`float / tensor` would be reciprocal * float)
    min_scale = duration.new_tensor(cfg.min_interval) / duration
    return (1.0 - min_scale) * raw + min_scale


class DeformOut(NamedTuple):
    xyz: torch.Tensor
    rotation: torch.Tensor     # normalized quaternion
    scaling: torch.Tensor      # linear (exp applied)
    opacity: torch.Tensor      # [N, 1]
    shs: torch.Tensor          # [N, 16, 3]
    lifespan: torch.Tensor     # [N, 1]
    state: torch.Tensor        # [N, 1] survival
    # the heads at zero time distance, for the regularizers (None unless
    # the config's scale_reg / shs_reg / motion_reg asks)
    scale_residual: Optional[torch.Tensor] = None    # [N, 3]
    shs_residual: Optional[torch.Tensor] = None      # [N, 16, 3]
    motion_residual: Optional[torch.Tensor] = None   # [N, 3]
    real_xyz: Optional[torch.Tensor] = None  # base-time position, no grad


def field_feat(params: GaussianParams, nets: DeformNets, cfg: ModelConfig,
               fstatic: field_mod.FieldStatic) -> torch.Tensor:
    """Field features at the Gaussians' (xyz, t_center, scale), inputs
    detached (saro_gaussian.py:780)."""
    return nets.field(fstatic, params.xyz.detach(),
                      get_temporal_pos(params, cfg).detach(),
                      get_scaling(params).detach())


def deform(params: GaussianParams, nets: DeformNets, cfg: ModelConfig,
           fstatic: field_mod.FieldStatic, timestamp,
           feat: Optional[torch.Tensor] = None,
           with_residuals: bool = False) -> DeformOut:
    """Temporal deformation at ``timestamp`` (saro_gaussian.py:779-847).
    ``with_residuals`` also runs the heads at zero time distance, for the
    training regularizers and ``real_xyz``; the eval render skips that
    pass."""
    if feat is None:
        feat = field_feat(params, nets, cfg, fstatic)
    lifespan = compute_lifespan(nets, cfg, feat, fstatic.duration)
    t_pos = get_temporal_pos(params, cfg)
    distance = timestamp - t_pos
    state = survival_state(distance / lifespan)

    emb = time_embed(cfg, distance).detach()        # PE detached (:792)
    df = torch.cat([feat, emb], dim=-1)

    scale_residual = shs_residual = motion_residual = real_xyz = None
    if with_residuals:
        # the heads at zero time distance (saro_gaussian.py:797-812)
        base_emb = time_embed(cfg, torch.zeros_like(distance))
        base_df = torch.cat([feat, base_emb], dim=-1)
        m_base = nets.motion_mlp(base_df)
        if cfg.scale_reg:
            scale_residual = nets.rot_mlp(base_df)[:, 4:]
        if cfg.shs_reg:
            shs_residual = nets.shs_mlp(base_df).reshape(-1, 16, 3)
        if cfg.motion_reg:
            motion_residual = m_base
        real_xyz = (params.xyz + m_base).detach()

    if cfg.dx:
        xyz = params.xyz + nets.motion_mlp(df)
    else:
        xyz = params.xyz

    if cfg.drot:
        rr = nets.rot_mlp(df)
        rot = math3d.quat_normalize(params.rotation + rr[:, :4])
        # logit cap 30: the per-frame residual is unbounded and exp
        # overflow would give an inf cov3d; e^30 still renders (huge,
        # finite)
        scaling = torch.exp(torch.clamp_max(params.scaling + rr[:, 4:],
                                            30.0))
    else:
        rot = get_rotation(params)
        scaling = get_scaling(params)

    if cfg.dopacity:
        opacity = torch.sigmoid(params.opacity) * state
    else:
        opacity = get_opacity(params)

    shs = get_features(params)
    if cfg.dsh:
        shs = shs + nets.shs_mlp(df).reshape(-1, 16, 3)

    return DeformOut(xyz=xyz, rotation=rot, scaling=scaling, opacity=opacity,
                     shs=shs, lifespan=lifespan, state=state,
                     scale_residual=scale_residual,
                     shs_residual=shs_residual,
                     motion_residual=motion_residual, real_xyz=real_xyz)


def temporal_integral(params: GaussianParams, nets: DeformNets,
                      cfg: ModelConfig, fstatic: field_mod.FieldStatic,
                      start: float = 0.0, end: float = 1.0,
                      feat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Closed-form temporal opacity integral [N, 1], Eq. 22
    (saro_gaussian.py:761-777).  Carries no gradient."""
    with torch.no_grad():
        if feat is None:
            feat = field_feat(params, nets, cfg, fstatic)
        lifespan = compute_lifespan(nets, cfg, feat, fstatic.duration)
        t_pos = get_temporal_pos(params, cfg)

        def q(x):
            a1, a2 = 0.070565902, 1.5976
            return 1.0 - 1.0 / (1.0 + torch.exp(a1 * x ** 3 + a2 * x))

        c = 2.0 * math.sqrt(2.0)
        p1 = q(c * (end - t_pos) / lifespan)
        p2 = q(c * (start - t_pos) / lifespan)
        integral = lifespan * (math.sqrt(math.pi) / 2.0) * (p1 - p2)
        if cfg.integral_renorm:
            # Q(+inf) - Q(-inf) = 1, so p1 - p2 is the mass fraction inside
            # [start, end]; dividing by it (at most a 4x boost, so a point
            # wholly outside stays prunable) gives an edge-centred splat
            # the integral of its unclipped mass
            integral = integral / torch.clamp(p1 - p2, 0.25, 1.0)
        return integral


# ---- creation (saro_gaussian.py:159-218) ------------------------------------

class PointCloud(NamedTuple):
    points: np.ndarray   # [N, 3]
    colors: np.ndarray   # [N, 3] in [0, 1]
    times: Optional[np.ndarray] = None   # [N, 1]


def init_nets(cfg: ModelConfig, generator: torch.Generator,
              device) -> DeformNets:
    """New nets on ``device``: zero planes (hexplane.py:78-86) and heads
    drawn as the reference's ``nn.Linear`` default, U(+-1/sqrt(fan_in))
    for weights and biases (the JAX package's mlp.init_mlp), from
    ``generator`` (a CPU generator, so every device gets the same
    numbers)."""
    nets = DeformNets(cfg)
    with torch.no_grad():
        for p in nets.field.planes:
            p.zero_()
        for head in HEADS:
            for layer in getattr(nets, head).layers:
                bound = 1.0 / math.sqrt(layer.in_features)
                for p in (layer.weight, layer.bias):
                    p.copy_((torch.rand(p.shape, generator=generator)
                             * 2.0 - 1.0) * bound)
    return nets.to(device)


def create_from_pcd(pcd: PointCloud, capacity: int, cfg: ModelConfig,
                    generator: torch.Generator, device
                    ) -> tuple[GaussianParams, torch.Tensor]:
    """Parameters from a point cloud, padded to ``capacity`` rows
    (saro_gaussian.py:159-218) -> (params, alive [capacity] f32).

    Log-scales from the mean squared 3-NN distance clamped to [-10, 1],
    temporal positions U(0, 1) from ``generator``, SH DC from RGB, opacity
    logit of 0.1.  Unused rows: xyz 0, scaling -10, opacity -10, identity
    quaternion, temporal_pos 0.5."""
    n = pcd.points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed the capacity {capacity}")
    f32 = torch.float32
    pts = torch.as_tensor(np.asarray(pcd.points, np.float32), device=device)
    d2 = torch.clamp_min(knn.mean_sq_dist_to_3nn(pts), 1e-7)
    scales = torch.clamp(torch.log(torch.sqrt(d2)), -10.0, 1.0)[:, None] \
        .expand(n, 3)

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=f32,
                         device=device)
        out[:n] = x
        return out

    colors = torch.as_tensor(np.asarray(pcd.colors, np.float32),
                             device=device)
    dc = sh.rgb2sh(colors).reshape(n, 1, 3)
    rots = torch.zeros((capacity, 4), dtype=f32, device=device)
    rots[:, 0] = 1.0
    opac = math3d.inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=f32,
                                                   device=device))
    times = torch.rand((n, 1), generator=generator).to(device)
    params = GaussianParams(
        xyz=pad(pts), features_dc=pad(dc),
        features_rest=torch.zeros((capacity, 15, 3), dtype=f32,
                                  device=device),
        scaling=pad(scales, fill=-10.0), rotation=rots,
        opacity=pad(opac, fill=-10.0), temporal_pos=pad(times, fill=0.5))
    alive = (torch.arange(capacity, device=device) < n).to(f32)
    return params, alive
