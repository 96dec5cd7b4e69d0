"""JAX-package parameters and train state (as numpy) <-> the port's.

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

A whole train state travels as a plain dict of numpy arrays
(``train_state_from_numpy`` / ``train_state_to_numpy``):

  points, mu_points, nu_points   {GaussianParams field: array}
  net_leaves, mu_net_leaves, nu_net_leaves   lists in the leaf order above
  count, step, dropped_hwm, bad_steps        integers
  alive [C], inv_integral [C,1], inv_integral_densify [C,1]
  aux   {xyz_grad_accum [C,1], denom [C,1], max_radii2d [C]}
  fstatic   {aabb_min, aabb_max, duration}   (from_numpy only)

LPIPS weights travel in the npz layout of ``train/lpips.py``
(``lpips_params_from_numpy``).
"""
from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device
from .models import densify as dens
from .models import field as field_mod
from .models import gaussians as gm
from .train import optim
from .train.step import TrainState

_PARAM_KEYS = {"xyz": "xyz", "features_dc": "f_dc",
               "features_rest": "f_rest", "scaling": "scaling",
               "rotation": "rotation", "opacity": "opacity",
               "temporal_pos": "temporal_pos"}


def _net_leaves_to_torch(nets: gm.DeformNets, leaves_np, dev) -> List:
    """numpy leaves in JAX layout -> tensors shaped like nets.leaves()."""
    names = nets.leaf_names()
    if len(leaves_np) != len(names):
        raise ValueError(f"{len(leaves_np)} net leaves, expected "
                         f"{len(names)}")
    out = []
    for name, ref, leaf in zip(names, nets.leaves(), leaves_np):
        arr = np.asarray(leaf, np.float32)
        if name.endswith(".weight"):
            arr = arr.T
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"leaf for {name}: shape {arr.shape}, "
                             f"expected {tuple(ref.shape)}")
        out.append(torch.tensor(arr, device=dev))
    return out


def net_leaves_to_jax(nets: gm.DeformNets, leaves=None) -> List:
    """``leaves`` (default: the nets' own), shaped like ``nets.leaves()``,
    as numpy arrays in the JAX layout and treedef order."""
    leaves = nets.leaves() if leaves is None else leaves
    return [x.detach().cpu().numpy().T if name.endswith(".weight")
            else x.detach().cpu().numpy()
            for name, x in zip(nets.leaf_names(), leaves)]


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

    nets = gm.DeformNets(cfg).to(dev)
    with torch.no_grad():   # the heads come allocated, not initialized
        for p, leaf in zip(nets.leaves(),
                           _net_leaves_to_torch(nets, nets_np_leaves, dev)):
            p.copy_(leaf)

    fstatic = field_mod.FieldStatic(aabb_min=t(fstatic_np["aabb_min"]),
                                    aabb_max=t(fstatic_np["aabb_max"]),
                                    duration=t(fstatic_np["duration"]))
    return params, nets, fstatic


def train_state_from_numpy(d: Mapping, cfg: gm.ModelConfig,
                           device=DEFAULT_DEVICE):
    """The dict of the module docstring -> (TrainState, fstatic) on
    ``device``."""
    dev = resolve_device(device)

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.array(x, dtype), device=dev)

    points, nets, fstatic = jax_to_torch(d["points"], d["net_leaves"],
                                         d["fstatic"], cfg, device=dev)
    fields = gm.GaussianParams._fields
    mu = [t(d["mu_points"][k]) for k in fields] \
        + _net_leaves_to_torch(nets, d["mu_net_leaves"], dev)
    nu = [t(d["nu_points"][k]) for k in fields] \
        + _net_leaves_to_torch(nets, d["nu_net_leaves"], dev)
    state = TrainState(
        points=points, nets=nets,
        opt=optim.AdamState(mu=mu, nu=nu, count=int(d["count"])),
        alive=t(d["alive"]),
        aux=dens.DensifyAux(**{k: t(d["aux"][k])
                               for k in dens.DensifyAux._fields}),
        inv_integral=t(d["inv_integral"]),
        inv_integral_densify=t(d["inv_integral_densify"]),
        step=int(d["step"]), dropped_hwm=int(d.get("dropped_hwm", 0)),
        bad_steps=int(d.get("bad_steps", 0)))
    return state, fstatic


def train_state_to_numpy(state: TrainState) -> dict:
    """The port's TrainState -> the dict of the module docstring (weights
    back in the JAX [in, out] layout), for comparison with the JAX
    package's."""
    def n(x):
        return x.detach().cpu().numpy()

    fields = gm.GaussianParams._fields
    k = len(fields)
    return {
        "points": {f: n(x) for f, x in zip(fields, state.points)},
        "net_leaves": net_leaves_to_jax(state.nets),
        "mu_points": {f: n(x) for f, x in zip(fields, state.opt.mu[:k])},
        "mu_net_leaves": net_leaves_to_jax(state.nets, state.opt.mu[k:]),
        "nu_points": {f: n(x) for f, x in zip(fields, state.opt.nu[:k])},
        "nu_net_leaves": net_leaves_to_jax(state.nets, state.opt.nu[k:]),
        "count": state.opt.count, "step": state.step,
        "dropped_hwm": state.dropped_hwm, "bad_steps": state.bad_steps,
        "alive": n(state.alive),
        "aux": {f: n(x) for f, x in zip(dens.DensifyAux._fields, state.aux)},
        "inv_integral": n(state.inv_integral),
        "inv_integral_densify": n(state.inv_integral_densify)}


def lpips_params_from_numpy(params_np: Mapping[str, np.ndarray],
                            net_type: str = "alex", device="cpu"
                            ) -> dict:
    """LPIPS weights in the npz layout (the JAX package's
    ``save_weights_npz`` / ``init_random_weights`` dict) -> float32
    tensors on ``device``; the names and every shape are checked against
    ``train/lpips.param_shapes``."""
    from .train.lpips import param_shapes
    shapes = param_shapes(net_type)
    if set(params_np) != set(shapes):
        raise ValueError(f"LPIPS {net_type} weights: keys "
                         f"{sorted(set(params_np) ^ set(shapes))} differ "
                         "from the layout")
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(params_np[name], np.float32)
        if arr.shape != shape:
            raise ValueError(f"LPIPS {net_type} {name}: shape {arr.shape}, "
                             f"expected {shape}")
        out[name] = torch.tensor(arr, device=device)
    return out
