"""JAX-package parameters (as numpy) -> the port's model state.

The JAX package flattens its ``NetParams`` in treedef order, which is also
the order of the ``leaf_<i>`` arrays of a checkpoint's npz:

  * the field planes, ``grids[m][i]`` for each multires scale m and each
    plane i in COMBS order;
  * then each head of NetParams in field order (motion, rot, opacity,
    shs), its dict keys sorted, so all biases ``b0..b{L-1}`` come before
    all weights ``w0..w{L-1}``.

The mapping below is spelled out and every shape is checked, so a change
of layout on either side fails loudly instead of loading scrambled
weights.  JAX weights are [in, out]; ``nn.Linear`` keeps [out, in].
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device
from .models import field as field_mod
from .models import gaussians as gm

_PARAM_KEYS = {"xyz": "xyz", "features_dc": "f_dc",
               "features_rest": "f_rest", "scaling": "scaling",
               "rotation": "rotation", "opacity": "opacity",
               "temporal_pos": "temporal_pos"}


def net_leaf_names(nets: gm.DeformNets) -> list:
    """Parameter names of ``nets``, one per npz leaf, in leaf order."""
    names = [f"field.planes.{i}" for i in range(len(nets.field.planes))]
    for head in gm.HEADS:
        n_layers = len(getattr(nets, head).layers)
        names += [f"{head}.layers.{i}.bias" for i in range(n_layers)]
        names += [f"{head}.layers.{i}.weight" for i in range(n_layers)]
    return names


def jax_to_torch(params_np: Mapping[str, np.ndarray],
                 nets_np_leaves: Sequence[np.ndarray],
                 fstatic_np: Mapping[str, np.ndarray],
                 cfg: gm.ModelConfig, device=DEFAULT_DEVICE
                 ) -> Tuple[gm.GaussianParams, gm.DeformNets,
                            field_mod.FieldStatic]:
    """Build (params, nets, fstatic) on ``device``.

    params_np: the GaussianParams fields by name (``xyz``,
      ``features_dc``, ...; the PLY loader's short names ``f_dc``/``f_rest``
      are accepted too).
    nets_np_leaves: the flat NetParams leaves in treedef order.
    fstatic_np: ``aabb_min``, ``aabb_max``, ``duration``."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    fields = {}
    for name, short in _PARAM_KEYS.items():
        fields[name] = t(params_np[name] if name in params_np
                         else params_np[short])
    params = gm.GaussianParams(**fields)

    nets = gm.DeformNets(cfg)
    names = net_leaf_names(nets)
    if len(nets_np_leaves) != len(names):
        raise ValueError(f"{len(nets_np_leaves)} net leaves, expected "
                         f"{len(names)} for {cfg}")
    state = {}
    for name, leaf in zip(names, nets_np_leaves):
        arr = np.asarray(leaf, np.float32)
        if name.endswith(".weight"):
            arr = arr.T
        want = tuple(nets.get_parameter(name).shape)
        if arr.shape != want:
            raise ValueError(f"leaf for {name}: shape {arr.shape}, "
                             f"expected {want}")
        state[name] = torch.tensor(arr)
    nets.load_state_dict(state, strict=True)
    nets.to(dev)

    fstatic = field_mod.FieldStatic(aabb_min=t(fstatic_np["aabb_min"]),
                                    aabb_max=t(fstatic_np["aabb_max"]),
                                    duration=t(fstatic_np["duration"]))
    return params, nets, fstatic
