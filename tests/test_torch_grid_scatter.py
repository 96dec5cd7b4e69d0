"""saro_gs_torch's plain field-gradient scatter (the CPU twin of kernel
K4) and sample_mip's custom backward against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.models import field as tfield
from saro_gs_torch.ops import grid_scatter as tgs
from saro_gs_torch.ops import mip as tmip
from saro_gs_tpu.models import field as jfield
from saro_gs_tpu.ops import grid_scatter as jgs
from saro_gs_tpu.ops import mip as jmip
from tests.torch_parity import n, t


def _random_taps(rng, n_pts, total, c, span=40):
    base = rng.randint(0, total - span - 1, n_pts).astype(np.int32)
    offs = np.sort(rng.randint(0, span, (4, n_pts)), axis=0).astype(np.int32)
    offs[0] = 0
    return (base[None] + offs, rng.rand(4, n_pts).astype(np.float32),
            rng.randn(n_pts, c).astype(np.float32))


@pytest.mark.parametrize("n_pts,total,c", [(1000, 2048, 8), (300, 513, 16),
                                           (4096, 4096, 32)])
def test_plain_scatter_matches_jax(rng, n_pts, total, c):
    """Against the XLA scatter and the Pallas kernel in interpret mode,
    the tolerances of tests/test_grid_scatter.py."""
    cells, weights, dfeat = _random_taps(rng, n_pts, total, c)
    jargs = (jnp.asarray(cells), jnp.asarray(weights), jnp.asarray(dfeat),
             total)
    b = n(tgs.scatter_taps_plain(t(cells), t(weights), t(dfeat), total))
    assert b.shape == (c, total)
    np.testing.assert_allclose(b, n(jgs.scatter_taps_xla(*jargs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b, n(jgs.scatter_taps_pallas(*jargs)),
                               rtol=1e-5, atol=1e-5)
    # the kernel's sort of these taps: every cell's segment holds its taps
    # in tap-major, point-minor order
    order, seg = tgs.sort_keys_plain(t(cells), total)
    assert int(seg[0]) == 0 and int(seg[-1]) == 4 * n_pts
    cell = 7 + int(cells[0, 0])
    s, e = int(seg[cell]), int(seg[cell + 1])
    taps, pts = np.nonzero(cells == cell)
    np.testing.assert_array_equal(n(order[s:e]), taps * n_pts + pts)


@pytest.mark.parametrize("kind,n_keys,total", [
    ("random", 5000, 21845), ("duplicates", 7001, 300),
    ("hot", 4500, 6400), ("one pass", 3000, 256)])
def test_sort_twin_matches_stable_argsort(rng, kind, n_keys, total):
    """The plain twin of K4's radix sort (per-block counts, their scan,
    the stable placement) against numpy's stable argsort, with segment
    bounds as searchsorted gives them."""
    if kind == "duplicates":
        keys = rng.randint(0, 5, n_keys) * 61
    elif kind == "hot":
        keys = np.full(n_keys, total - 1)
        keys[::97] = rng.randint(0, total, keys[::97].shape)
    else:
        keys = rng.randint(0, total, n_keys)
    assert tgs.radix_passes(total) == (1 if total <= 256 else 2)
    order, seg = tgs.sort_keys_plain(torch.as_tensor(keys), total)
    np.testing.assert_array_equal(n(order), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(
        n(seg), np.searchsorted(np.sort(keys), np.arange(total + 1)))


def test_plain_scatter_hot_cell(rng):
    """Thousands of rows on one cell stay exact."""
    n_pts, total, c = 3000, 1024, 8
    cells = np.full((4, n_pts), 37, np.int32)
    weights = rng.rand(4, n_pts).astype(np.float32)
    dfeat = rng.randn(n_pts, c).astype(np.float32)
    a = n(jgs.scatter_taps_xla(jnp.asarray(cells), jnp.asarray(weights),
                               jnp.asarray(dfeat), total))
    b = n(tgs.scatter_taps_plain(t(cells), t(weights), t(dfeat), total))
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3)
    assert not b[:, :37].any() and not b[:, 38:].any()


@pytest.mark.parametrize("max_level", [0, 3])
def test_sample_mip_grid_gradient_matches_jax(rng, monkeypatch, max_level):
    """The custom backward against jax.grad of the JAX sample_mip (its
    Pallas scatter, interpret mode) and against the port's own autograd
    through the gathers, with per-point mip levels and border clamps:
    1e-5 of the gradient's largest entry."""
    monkeypatch.setenv("SARO_GRID_SCATTER", "pallas")
    c, h, w, n_pts = 6, 32, 32, 500
    grid = rng.randn(c, h, w).astype(np.float32)
    coords = rng.rand(n_pts, 2).astype(np.float32)
    coords[:8] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0],
                  [0.999, 0.5], [0.5, 0.001], [0.015, 0.985], [0.5, 0.5]]
    level = (rng.rand(n_pts) * max_level).astype(np.float32)
    d_out = rng.randn(n_pts, c).astype(np.float32)
    gj = n(jax.grad(lambda g: jnp.sum(jmip.sample_mip(
        g, jnp.asarray(coords), jnp.asarray(level), max_level)
        * jnp.asarray(d_out)))(jnp.asarray(grid)))

    def grad_of(fn):
        g = t(grid).requires_grad_()
        cds = t(coords).requires_grad_()
        out = fn(g, cds, t(level), max_level)
        (out * t(d_out)).sum().backward()
        return out, n(g.grad), cds.grad

    out_c, g_custom, g_coords = grad_of(tmip.sample_mip)
    out_a, g_auto, _ = grad_of(tmip._sample_mip_impl)
    scale = np.abs(gj).max() + 1e-6
    assert np.abs(g_custom - gj).max() / scale < 1e-5
    assert np.abs(g_custom - g_auto).max() / scale < 1e-5
    assert torch.equal(out_c, out_a)          # the forward is unchanged
    assert g_coords is None                   # coords carry no gradient


@pytest.mark.parametrize("h,w,n_levels", [(32, 64, 5), (50, 128, 0)])
def test_mip_taps_fold_both_brackets(rng, h, w, n_levels):
    """The entry point's plain version (both brackets' taps, the bracket
    factor folded into the weight, one scatter) against one scatter per
    bracket of the factored cotangent, as the grid gradient was built
    before: 1e-5 of the largest entry."""
    n_pts, c = 700, 8
    coords = rng.rand(n_pts, 2).astype(np.float32)
    coords[:4] = [[0.0, 0.0], [1.0, 1.0], [0.999, 0.001], [0.5, 0.5]]
    level = (rng.rand(n_pts) * (n_levels + 1) - 0.5).astype(np.float32)
    dfeat = rng.randn(n_pts, c).astype(np.float32)
    got = tgs.scatter_mip_taps(t(coords), t(level), t(dfeat), h, w,
                               n_levels)
    u, v = t(coords[:, 0]), t(coords[:, 1])
    if n_levels == 0:
        cells, wts = tgs.tap_cells_weights(u, v, w, h, 0)
        want = tgs.scatter_taps_plain(cells, wts, t(dfeat), h * w)
    else:
        lvl = torch.clamp(t(level), 0.0, float(n_levels))
        l0 = torch.clamp(torch.floor(lvl).long(), 0, n_levels)
        l1 = torch.clamp(l0 + 1, 0, n_levels)
        frac = lvl - l0
        sizes, offs = tgs.level_sizes(h, w, n_levels)
        want = 0
        for l, fac in ((l0, 1.0 - frac), (l1, frac)):
            cells, wts = tgs.tap_cells_weights(
                u, v, torch.full_like(l, w) >> l, torch.full_like(l, h) >> l,
                torch.as_tensor(offs[:-1])[l])
            want = want + tgs.scatter_taps_plain(
                cells, wts, t(dfeat) * fac[:, None], int(offs[-1]))
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_field_features_gradient_matches_jax(rng, monkeypatch):
    """The whole field's plane gradients, end to end."""
    monkeypatch.setenv("SARO_GRID_SCATTER", "pallas")
    jcfg = jfield.FieldConfig(resolution=(16, 16, 16, 8), out_dim=4,
                              multires=(1,))
    tcfg = tfield.FieldConfig(resolution=(16, 16, 16, 8), out_dim=4,
                              multires=(1,))
    jstatic = jfield.make_static([-1.0] * 3, [1.0] * 3, 8)
    n_pts = 200
    planes = [rng.normal(0, 0.1, (4, jcfg.reso(1)[b], jcfg.reso(1)[a]))
              .astype(np.float32) for a, b in jfield.COMBS]
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    tt = rng.rand(n_pts, 1).astype(np.float32)
    scales = rng.uniform(0.01, 1.0, (n_pts, 3)).astype(np.float32)
    d_out = rng.randn(n_pts, jcfg.feat_dim).astype(np.float32)
    gj = jax.grad(lambda g: jnp.sum(jfield.field_features(
        g, jcfg, jstatic, jnp.asarray(pts), jnp.asarray(tt),
        jnp.asarray(scales)) * jnp.asarray(d_out)))(
        [[jnp.asarray(p) for p in planes]])
    field = tfield.HexPlaneField(tcfg)
    with torch.no_grad():
        for p, v in zip(field.planes, planes):
            p.copy_(t(v))
    tstatic = tfield.FieldStatic(aabb_min=torch.full((3,), -1.0),
                                 aabb_max=torch.full((3,), 1.0),
                                 duration=torch.tensor(8.0))
    out = field(tstatic, t(pts), t(tt), t(scales))
    (out * t(d_out)).sum().backward()
    for p, g in zip(field.planes, gj[0]):
        g = n(g)
        scale = np.abs(g).max() + 1e-6
        assert np.abs(n(p.grad) - g).max() / scale < 1e-5


def test_plane_regularizers_match_jax(rng):
    planes = [rng.normal(0, 0.3, (4, 8 + i, 9 + i)).astype(np.float32)
              for i in range(12)]
    jgrids = [[jnp.asarray(p) for p in planes[:6]],
              [jnp.asarray(p) for p in planes[6:]]]
    tplanes = [t(p) for p in planes]
    np.testing.assert_allclose(float(tfield.plane_tv(tplanes)),
                               float(jfield.plane_tv(jgrids)), rtol=1e-5)
    np.testing.assert_allclose(float(tfield.time_smoothness(tplanes)),
                               float(jfield.time_smoothness(jgrids)),
                               rtol=1e-5)
