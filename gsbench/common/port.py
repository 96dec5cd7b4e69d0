"""The system under test: the port (``saro_gs_torch``) built from the
benchmark's inputs.  This is the only module of the harness that imports
the program (the runners call ``test_render``, ``train_render``,
``step_mod`` and ``timing`` through it); the reference never does.

The port's own configuration loader reads the source config's keys, as a
user's ``cli train --config`` does; the leaves are copied from the
benchmark's tensors (the port updates its nets in place, so it never gets
the benchmark's own).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from saro_gs_torch import timing
from saro_gs_torch.config import load_config
from saro_gs_torch.models import field as field_mod
from saro_gs_torch.models import gaussians as gm
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.render import test_render, train_render
from saro_gs_torch.train import step as step_mod

from .cameras import FIELDS
from ..reference.model import POINT_FIELDS


class Port(NamedTuple):
    cfg: object            # saro_gs_torch.config.Config
    mcfg: object
    rcfg: object
    params: object         # GaussianParams
    nets: object           # DeformNets
    alive: torch.Tensor
    fstatic: object


def build(src: dict, inputs) -> Port:
    """The port's model of ``inputs`` (scene.Inputs) under the source
    config ``src``."""
    cfg = load_config(**src)
    mcfg = cfg.model_config()
    dev = inputs.alive.device
    nets = gm.DeformNets(mcfg).to(dev)
    params = restore(nets, inputs)
    fstatic = field_mod.FieldStatic(aabb_min=inputs.aabb_min.clone(),
                                    aabb_max=inputs.aabb_max.clone(),
                                    duration=inputs.duration.clone())
    return Port(cfg=cfg, mcfg=mcfg, rcfg=cfg.raster_config(), params=params,
                nets=nets, alive=inputs.alive.clone(), fstatic=fstatic)


def restore(nets, inputs) -> gm.GaussianParams:
    """The benchmark's leaves: copied into ``nets`` (in place) and a fresh
    copy of the point leaves."""
    with torch.no_grad():
        for name in nets.leaf_names():
            nets.get_parameter(name).copy_(inputs.leaves[name])
    return gm.GaussianParams(*[inputs.leaves[f].clone()
                               for f in POINT_FIELDS])


def camera(cams: dict, index) -> CameraParams:
    """One camera (an int index) or a batch (an index tensor) of the
    stacked cameras, as the port takes them."""
    return CameraParams(*[cams[f][index] for f in FIELDS])


def leaves(state) -> dict:
    """A train state's leaves by the reference's names."""
    out = dict(zip(POINT_FIELDS, state.points))
    out.update(zip(state.nets.leaf_names(), state.nets.leaves()))
    return out


def mu_leaves(state) -> dict:
    """Adam's first moments by leaf name."""
    names = list(POINT_FIELDS) + state.nets.leaf_names()
    return dict(zip(names, state.opt.mu))
