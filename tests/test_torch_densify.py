"""The port's densify moves, knn and model creation against the JAX
package's (saro_gs_tpu.models.densify, ops.knn, models.gaussians), on
seeded numpy inputs at capacity 256.  The split draws are JAX's own
(jax.random.normal from the same keys), passed to the port as
``samples``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.models import densify as tdens
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.ops import knn as tknn
from saro_gs_tpu.models import densify as jdens
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops import knn as jknn
from tests.torch_parity import n

C = 256
FIELDS = jgm.GaussianParams._fields


def _inputs(seed, n_dead):
    """Points, moments, statistics and integrals at capacity C, the last
    ``n_dead`` rows and a few in between dead; dead rows hold what
    grow_capacity leaves there (zero quaternions)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    p = dict(
        xyz=rng.uniform(-1, 1, (C, 3)) * [1, 1, 4] + [0, 0, 4.5],
        features_dc=rng.normal(0, 0.5, (C, 1, 3)),
        features_rest=rng.normal(0, 0.1, (C, 15, 3)),
        scaling=np.log(rng.uniform(1e-4, 0.3, (C, 3))),
        rotation=rng.normal(0, 1, (C, 4)),
        opacity=rng.uniform(-6, 4, (C, 1)),
        temporal_pos=rng.uniform(0, 1, (C, 1)))
    p = {k: v.astype(f32) for k, v in p.items()}
    alive = np.ones(C, f32)
    alive[C - n_dead:] = 0.0
    alive[rng.choice(C - n_dead, 10, replace=False)] = 0.0
    p["rotation"][alive == 0] = 0.0
    mu = {k: rng.normal(0, 1e-3, v.shape).astype(f32) for k, v in p.items()}
    nu = {k: rng.uniform(0, 1e-6, v.shape).astype(f32) for k, v in p.items()}
    denom = rng.randint(0, 4, (C, 1)).astype(f32)
    aux = dict(xyz_grad_accum=(rng.uniform(0, 4e-4, (C, 1)) * denom)
               .astype(f32), denom=denom,
               max_radii2d=rng.uniform(0, 40, C).astype(f32))
    inv_integral = rng.uniform(1, 3, (C, 1)).astype(f32)
    integral = rng.uniform(0, 1, (C, 1)).astype(f32)
    return p, mu, nu, alive, aux, inv_integral, integral


def _jax(p, mu, nu, alive, aux, key, inv_integral, integral, **kw):
    def gp(d):
        return jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
    return jdens.densify_pruneclone(
        gp(p), gp(mu), gp(nu), jnp.asarray(alive),
        jdens.DensifyAux(**{k: jnp.asarray(v) for k, v in aux.items()}),
        key, inv_integral=jnp.asarray(inv_integral),
        integral=jnp.asarray(integral), **kw)


def _torch(p, mu, nu, alive, aux, samples, inv_integral, integral, **kw):
    def gp(d):
        return tgm.GaussianParams(**{k: torch.as_tensor(v)
                                     for k, v in d.items()})
    return tdens.densify_pruneclone(
        gp(p), gp(mu), gp(nu), torch.as_tensor(alive),
        tdens.DensifyAux(**{k: torch.as_tensor(v) for k, v in aux.items()}),
        samples, inv_integral=torch.as_tensor(inv_integral),
        integral=torch.as_tensor(integral), **kw)


BASE = dict(grad_threshold=2e-4, min_opacity=0.0, extent=2.0,
            percent_dense=0.01, max_screen_size=None, min_intergral=0.0,
            prune_z=False, prune_big_ws=False)
CASES = {
    "clone_only": dict(percent_dense=10.0),
    "split_only": dict(percent_dense=1e-6),
    "clone_and_split": dict(percent_dense=0.05),
    "overflow": dict(percent_dense=0.05, n_dead=12),
    "prune_opacity": dict(grad_threshold=1.0, min_opacity=0.05),
    "prune_integral": dict(grad_threshold=1.0, min_intergral=0.3),
    "prune_z": dict(grad_threshold=1.0, prune_z=True),
    "prune_screen": dict(grad_threshold=1.0, max_screen_size=20),
    "prune_screen_big_ws": dict(grad_threshold=1.0, max_screen_size=20,
                                prune_big_ws=True),
    "prune_min_scale": dict(grad_threshold=1.0, min_scale_abs=0.12),
    "everything": dict(percent_dense=0.05, min_opacity=0.02,
                       min_intergral=0.1, prune_z=True, max_screen_size=30,
                       prune_big_ws=True, min_scale_abs=1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_pruneclone_matches_jax(case):
    kw = dict(BASE, **CASES[case])
    n_dead = kw.pop("n_dead", 120)
    p, mu, nu, alive, aux, inv_integral, integral = _inputs(3, n_dead)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    samples = [torch.as_tensor(n(jax.random.normal(k, (C, 3))).copy())
               for k in (k1, k2)]
    a = _jax(p, mu, nu, alive, aux, key, inv_integral, integral, **kw)
    b = _torch(p, mu, nu, alive, aux, samples, inv_integral, integral, **kw)

    for f in ("n_cloned", "n_split", "n_pruned", "overflowed"):
        assert int(n(getattr(a, f))) == int(n(getattr(b, f))), f
    np.testing.assert_array_equal(n(b.alive), n(a.alive))
    if case.startswith("prune"):
        assert int(n(b.n_cloned)) + int(n(b.n_split)) == 0
        assert int(n(b.n_pruned)) > 0
    else:
        assert int(n(b.n_cloned)) + int(n(b.n_split)) > 0
    assert bool(n(b.overflowed)) == (case == "overflow")
    if case == "clone_only":
        assert int(n(b.n_split)) == 0
    if case == "split_only":
        assert int(n(b.n_cloned)) == 0

    # the rows each package wrote (clone and split destinations, split
    # parents) are the same rows, with the same values
    moved_j = np.zeros(C, bool)
    moved_t = np.zeros(C, bool)
    for k, f in enumerate(FIELDS):
        old = p[f].reshape(C, -1)
        new_j = n(a.params[k]).reshape(C, -1)
        new_t = n(b.params[k]).reshape(C, -1)
        moved_j |= (new_j != old).any(1)
        moved_t |= (new_t != old).any(1)
        np.testing.assert_allclose(new_t, new_j, rtol=1e-6, atol=1e-7,
                                   err_msg=f)
    np.testing.assert_array_equal(moved_t, moved_j)
    assert moved_t.sum() == int(n(b.n_cloned)) + 2 * int(n(b.n_split))
    for src, res in ((mu, b.mu), (nu, b.nu)):
        for k, f in enumerate(FIELDS):
            got = n(res[k]).reshape(C, -1)
            assert (got[moved_t] == 0).all(), f
            np.testing.assert_array_equal(got[~moved_t],
                                          src[f].reshape(C, -1)[~moved_t])
    for f in tdens.DensifyAux._fields:
        assert not n(getattr(b.aux, f)).any()


def test_reset_opacity_matches_jax():
    p, mu, nu, *_ = _inputs(4, 20)
    ja = jdens.reset_opacity(
        *[jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})
          for d in (p, mu, nu)])
    tb = tdens.reset_opacity(
        *[tgm.GaussianParams(**{k: torch.as_tensor(v) for k, v in d.items()})
          for d in (p, mu, nu)])
    for x, y in zip(ja, tb):
        for k, f in enumerate(FIELDS):
            np.testing.assert_allclose(n(y[k]), n(x[k]), rtol=1e-6,
                                       err_msg=f)
    assert (n(tgm.get_opacity(tb[0])) <= 0.01 + 1e-6).all()
    assert not n(tb[1].opacity).any() and not n(tb[2].opacity).any()
    np.testing.assert_array_equal(n(tb[1].xyz), mu["xyz"])


@pytest.mark.parametrize("case", ["plain", "valid_mask", "duplicates",
                                  "three_points", "one_point"])
def test_mean_sq_dist_to_3nn_matches_jax(case):
    rng = np.random.RandomState(9)
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    valid = None
    if case == "valid_mask":
        valid = rng.rand(700) > 0.3
    elif case == "duplicates":
        pts[100:140] = pts[0]
        pts[500:503] = pts[7]
    elif case == "three_points":
        pts = pts[:3]
    elif case == "one_point":
        pts = pts[:1]
    a = n(jknn.mean_sq_dist_to_3nn(
        jnp.asarray(pts), None if valid is None else jnp.asarray(valid)))
    b = n(tknn.mean_sq_dist_to_3nn(
        torch.as_tensor(pts), None if valid is None else
        torch.as_tensor(valid)))
    sel = np.ones(len(pts), bool) if valid is None else valid
    np.testing.assert_allclose(b[sel], a[sel], rtol=1e-6, atol=0)
    assert np.isfinite(b).all()
    if case == "duplicates":
        assert (b[100:140] == 0).all()


def test_create_from_pcd_matches_jax():
    """Every leaf but the temporal positions (their own generators) and
    the padding equal JAX's; the positions are U(0, 1) from the port's
    generator and the same for the same seed."""
    rng = np.random.RandomState(2)
    pcd_np = dict(points=rng.uniform(-1, 1, (150, 3)),
                  colors=rng.uniform(0, 1, (150, 3)))
    cfg = jgm.ModelConfig()
    jp, jalive = jgm.create_from_pcd(jax.random.PRNGKey(0),
                                     jgm.PointCloud(**pcd_np), C, cfg)
    tp, talive = tgm.create_from_pcd(
        tgm.PointCloud(**pcd_np), C, tgm.ModelConfig(),
        torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_array_equal(n(talive), n(jalive))
    for f in FIELDS:
        if f == "temporal_pos":
            continue
        np.testing.assert_allclose(n(getattr(tp, f)), n(getattr(jp, f)),
                                   rtol=2e-6, atol=0, err_msg=f)
    t = n(tp.temporal_pos)
    assert ((t[:150] >= 0) & (t[:150] < 1)).all() and (t[150:] == 0.5).all()
    tp2, _ = tgm.create_from_pcd(
        tgm.PointCloud(**pcd_np), C, tgm.ModelConfig(),
        torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(tp2.temporal_pos, tp.temporal_pos)
    np.testing.assert_array_equal(n(tp.rotation)[150:],
                                  np.tile([1, 0, 0, 0], (C - 150, 1)))
    with pytest.raises(ValueError):
        tgm.create_from_pcd(tgm.PointCloud(**pcd_np), 100, tgm.ModelConfig(),
                            torch.Generator().manual_seed(0), "cpu")


def test_init_nets_draws_from_its_generator_only():
    """Zero planes, heads within +-1/sqrt(fan_in) with the leaf layout of
    the JAX package's init_nets; the same seed gives the same nets, and
    torch's global RNG is not touched."""
    cfg = tgm.ModelConfig(deform_hidden_dim=32)
    state = torch.random.get_rng_state()
    a = tgm.init_nets(cfg, torch.Generator().manual_seed(1), "cpu")
    a.requires_grad_(False)
    b = tgm.init_nets(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    jleaves = jax.tree_util.tree_leaves(
        jgm.init_nets(jax.random.PRNGKey(0), jgm.ModelConfig(
            deform_hidden_dim=32)))
    assert len(a.leaves()) == len(jleaves)
    for name, x, y, j in zip(a.leaf_names(), a.leaves(), b.leaves(),
                             jleaves):
        assert torch.equal(x, y), name
        assert tuple(x.shape) == (j.shape[::-1] if name.endswith(".weight")
                                  else j.shape), name
        if name.startswith("field."):
            assert not x.any(), name
        else:
            fan_in = x.shape[-1] if name.endswith(".weight") else None
            if fan_in:
                bound = 1.0 / np.sqrt(fan_in)
                assert float(x.abs().max()) <= bound
                assert float(x.abs().max()) > 0.9 * bound, name
