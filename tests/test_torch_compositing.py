"""saro_gs_torch's plain forward compositor (the CPU twin of kernel K1)
against the JAX package: its pure-JAX compositor (backend="jax") and its
Pallas forward kernel in interpret mode (backend="pallas")."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.ops import compositing as tcomp
from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
from saro_gs_tpu.ops import binning as jbin
from saro_gs_tpu.ops import projection as jproj
from saro_gs_tpu.ops import tile_kernels as jtk
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.ops.rasterize import rasterize as jrasterize
from tests.scene_fixtures import make_camera, make_gaussians
from tests.torch_parity import n, t, torch_cam

W, H = 64, 48
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _scene(rng, saturate=True):
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(
        rng, n=300 if saturate else 60)
    if saturate:
        opac[::6] = 0.995      # saturating splats exercise the T latch
    return cam, means, scales, quats, opac, shs


def _close(b, a):
    """The tolerances of tests/test_pallas_kernels.py:29-34."""
    np.testing.assert_allclose(n(b.color), n(a.color), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(b.final_t), n(a.final_t), atol=1e-6)
    assert (n(b.n_contrib) == n(a.n_contrib)).mean() >= 0.999
    assert (n(b.depth) == n(a.depth)).mean() >= 0.999


# The Pallas kernel's prefix products reassociate the transmittance
# product, which moves the T < 1e-4 latch where pixels saturate: on the
# dense saturated scene JAX's own two backends differ on 1.4% of pixels
# (up to 3.9e-3).  So the Pallas comparison uses a sparse scene far from
# the latch, and the sequential backend="jax" the dense saturated one.
@pytest.mark.parametrize("backend,saturate", [("jax", True),
                                              ("pallas", False)])
def test_render_matches_jax(rng, backend, saturate):
    cam, means, scales, quats, opac, shs = _scene(rng, saturate)
    jcfg = JRasterConfig(tile_x=16, tile_y=16, chunk=128,
                         max_instances=1 << 14, max_slots=512,
                         backend=backend, tight_rect=False)
    a = jrasterize(jnp.asarray(means), jnp.asarray(scales),
                   jnp.asarray(quats), jnp.asarray(opac), cam,
                   jnp.asarray(BG), width=W, height=H, sh_degree=3,
                   config=jcfg, shs=jnp.asarray(shs))
    b = rasterize(t(means), t(scales), t(quats), t(opac), torch_cam(cam),
                  t(BG), width=W, height=H, sh_degree=3,
                  config=RasterConfig(tile_x=16, tile_y=16, chunk=128,
                                      max_instances=1 << 14,
                                      tight_rect=False),
                  shs=t(shs))
    assert b.num_instances == int(a.num_instances) and b.num_dropped == 0
    if saturate:
        assert float(n(a.final_t).min()) < 1e-3
    _close(b, a)


def test_forward_tiles_on_jax_staged_table(rng):
    """The same staged table through JAX's Pallas forward (interpret) and
    the port's plain compositor, 32x32 tiles as the arena config uses."""
    cam, means, scales, quats, opac, shs = _scene(rng, saturate=False)
    pre = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                           jnp.asarray(quats), jnp.asarray(opac), cam, W, H,
                           32, 32, sh_degree=3, shs=jnp.asarray(shs),
                           tight_rect=True)
    bins = jbin.bin_gaussians_staged(pre, jnp.asarray(opac), 2, 2, 1 << 14,
                                     128, tile_x=32, tile_y=32,
                                     packed=False, expander="sort")
    a = jtk.forward_tiles_pallas(bins, jnp.asarray(BG), W, H, 32, 32, 128)
    b = tcomp.forward_tiles(t(n(bins.attr)[:10]), t(bins.tile_start),
                            t(bins.tile_count), t(BG), W, H, 32, 32)
    _close(b, a)


def _table(rows):
    """[10, L] staged table from per-instance tuples
    (x, y, ca, cb, cc, opacity, r, g, b, depth)."""
    return torch.tensor(np.array(rows, np.float32).T.copy())


def test_semantics_latch_guard_and_masking():
    w = h = 8
    one = torch.tensor([0], dtype=torch.int32)
    bg = torch.tensor([0.0, 0.0, 1.0])
    # at pixel (3, 3) alpha = min(0.99, opacity): T goes 1 -> 0.1 -> 1e-3,
    # the third instance would take it to 1e-5 < T_EPS, so the latch stops
    # the walk there without its contribution, and the fourth is never seen
    rows = [(3.0, 3.0, 0.01, 0.0, 0.01, 0.9, 1, 0, 0, 2.0),
            (3.0, 3.0, 0.01, 0.0, 0.01, 0.995, 0, 1, 0, 3.0),
            (3.0, 3.0, 0.01, 0.0, 0.01, 0.99, 0, 0, 1, 4.0),
            (3.0, 3.0, 0.01, 0.0, 0.01, 0.5, 1, 1, 1, 5.0)]
    out = tcomp.forward_tiles(_table(rows), one, torch.tensor([4],
                              dtype=torch.int32), bg, w, h, 8, 8)
    f = np.float32
    t1 = f(1.0) - f(0.9)
    t2 = t1 * (f(1.0) - f(0.99))
    assert n(out.n_contrib)[3, 3] == 2
    assert n(out.depth)[3, 3] == 2.0          # T crossed 0.5 at row 0
    assert n(out.final_t)[3, 3] == t2
    np.testing.assert_allclose(n(out.color)[:, 3, 3],
                               [0.9, 0.99 * t1, t2], rtol=1e-6)

    # broken conic: an indefinite conic (power > 0 off-centre) is skipped
    bad = [(3.0, 3.0, -1.0, 0.0, -1.0, 0.9, 1, 1, 1, 1.0)]
    out = tcomp.forward_tiles(_table(bad), one, torch.tensor([1],
                              dtype=torch.int32), bg, w, h, 8, 8)
    assert n(out.n_contrib)[0, 0] == 0 and n(out.final_t)[0, 0] == 1.0
    np.testing.assert_array_equal(n(out.color)[:, 0, 0], [0, 0, 1])

    # rows past the tile's range are never composited, even NaN ones
    nan = [(3.0, 3.0, 0.5, 0.0, 0.5, 0.5, 1, 0, 0, 1.0)] + \
        [(math.nan,) * 10]
    out = tcomp.forward_tiles(_table(nan), one, torch.tensor([1],
                              dtype=torch.int32), bg, w, h, 8, 8)
    assert np.isfinite(n(out.color)).all()
    # an empty tile renders the background
    out = tcomp.forward_tiles(_table(nan), one, torch.tensor([0],
                              dtype=torch.int32), bg, w, h, 8, 8)
    np.testing.assert_array_equal(n(out.color),
                                  np.broadcast_to(n(bg)[:, None, None],
                                                  (3, h, w)))
    assert (n(out.depth) == tcomp.DEPTH_DEFAULT).all()
