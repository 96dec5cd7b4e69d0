"""saro_gs_torch's model half against the JAX package: checkpoint loading
through convert.py, the mip sampler, the field and ``deform`` on the real
arena checkpoint (full-width planes and heads)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import config as tcfg
from saro_gs_torch import convert
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import ply as tply
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.ops import mip as tmip
from saro_gs_tpu import config as jcfg
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.data import ply as jply
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops import mip as jmip
from tests.torch_parity import n, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARENA = os.path.join(ROOT, "checkpoints", "arena")
PLY = os.path.join(ARENA, "point_cloud", "iteration_best", "point_cloud.ply")


@pytest.fixture(scope="module")
def arena():
    mcfg_j = jcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json")
                                ).model_config()
    mcfg_t = tcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json")
                                ).model_config()
    tpl = jgm.init_nets(jax.random.PRNGKey(0), mcfg_j)
    jstate = jscene.load_gaussian_checkpoint(PLY, tpl, capacity=None)
    tstate = tscene.load_gaussian_checkpoint(PLY, mcfg_t, device="cpu")
    return mcfg_j, mcfg_t, jstate, tstate


def test_ply_loader_matches():
    a = jply.load_gaussian_ply(PLY)
    b = tply.load_gaussian_ply(PLY)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_checkpoint_leaves_map_explicitly(arena):
    mcfg_j, mcfg_t, (jp, jnets, _, jfs, jn), (tp, tnets, alive, tfs, tn) = \
        arena
    assert jn == tn == 82496
    assert alive.shape == (tn,) and bool((alive == 1).all())
    names = tnets.leaf_names()
    # leaf 9 is the motion head's first weight, leaf 20 the opacity head's
    # last bias (dict keys sort "b" before "w")
    assert names[9] == "motion_mlp.layers.0.weight"
    assert names[20] == "opacity_mlp.layers.2.bias"
    leaves = jax.tree_util.tree_leaves(jnets)
    state = tnets.state_dict()
    for name, leaf in zip(names, leaves):
        want = np.asarray(leaf)
        got = n(state[name])
        np.testing.assert_array_equal(got.T if name.endswith("weight")
                                      else got, want, err_msg=name)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(n(b), np.asarray(a))
    for a, b in zip(jfs, tfs):
        np.testing.assert_array_equal(n(b), np.asarray(a))
    with pytest.raises(ValueError):
        convert.jax_to_torch({k: np.asarray(v) for k, v in
                              jp._asdict().items()}, leaves[:-1],
                             {"aabb_min": jfs.aabb_min,
                              "aabb_max": jfs.aabb_max,
                              "duration": jfs.duration}, mcfg_t,
                             device="cpu")


@pytest.mark.parametrize("max_level,shape", [(7, (8, 64, 32)),
                                             (0, (8, 50, 128))])
def test_sample_mip_matches(rng, max_level, shape):
    grid = rng.normal(0, 1, shape).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (512, 2)).astype(np.float32)
    level = rng.uniform(-1.0, 8.0, (512,)).astype(np.float32)
    a = jmip.sample_mip(jnp.asarray(grid), jnp.asarray(coords),
                        jnp.asarray(level), max_level)
    b = tmip.sample_mip(t(grid), t(coords), t(level), max_level)
    np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ts", [0.01, 0.5, 0.99])
def test_deform_matches_on_arena_subset(arena, ts):
    mcfg_j, mcfg_t, (jp, jnets, _, jfs, _), (tp, tnets, _, tfs, tn) = arena
    idx = np.random.RandomState(3).choice(tn, 2048, replace=False)
    jsub = jgm.GaussianParams(*[x[idx] for x in jp])
    tsub = tgm.GaussianParams(*[x[torch.as_tensor(idx)] for x in tp])
    jfeat = jgm.field_feat(jsub, jnets, mcfg_j, jfs)
    with torch.no_grad():
        tfeat = tgm.field_feat(tsub, tnets, mcfg_t, tfs)
        b = tgm.deform(tsub, tnets, mcfg_t, tfs, ts, feat=tfeat)
    np.testing.assert_allclose(n(tfeat), np.asarray(jfeat), rtol=1e-5,
                               atol=1e-6)
    a = jgm.deform(jsub, jnets, mcfg_j, jfs, jnp.float32(ts), feat=jfeat)
    for f in ("xyz", "rotation", "scaling", "opacity", "shs", "lifespan",
              "state"):
        np.testing.assert_allclose(n(getattr(b, f)),
                                   np.asarray(getattr(a, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
