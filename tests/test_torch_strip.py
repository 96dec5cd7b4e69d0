"""Strip mode of saro_gs_torch's rasterizer (``RasterConfig.strip_rows``
and ``row0``, the tile-axis sharding of parallel/shard.py) on the CPU,
through the plain versions of K1, K2 and K3: strips assemble to the full
frame to the bit, meet the JAX package's strip renders, and their
gradients sum to the full frame's.  Mirrors tests/test_strip.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.ops.rasterize import rasterize as jrasterize
from tests.scene_fixtures import make_camera, make_gaussians
from tests.torch_parity import n, t, torch_cam

W = 64
TILE = 16
BG = np.array([0.1, 0.3, 0.2], np.float32)
KEYS = ("color", "depth", "final_t", "n_contrib")
NAMES = ["means", "scales", "quats", "opacities", "shs"]


def _cfg(strip_rows=0, tight=True):
    return RasterConfig(tile_x=TILE, tile_y=TILE, chunk=8,
                        max_instances=1 << 13, tight_rect=tight,
                        strip_rows=strip_rows)


def _jcfg(strip_rows=0, tight=True):
    # backend="jax" bins without the corner cull, so its n_contrib (a rank
    # in the tile's range) meets the port's with tight_rect=False only
    return JRasterConfig(tile_x=TILE, tile_y=TILE, chunk=8,
                         max_instances=1 << 13, max_slots=256,
                         backend="jax", tight_rect=tight,
                         strip_rows=strip_rows)


def _scene(rng, height, n_gauss=60):
    cam, _ = make_camera(width=W, height=height)
    means, scales, quats, opac, shs = make_gaussians(rng, n=n_gauss)
    opac[::6] = 0.995            # saturating splats: the latch, the clamp
    return cam, (means, scales, quats, opac, shs)


def _render(cam, arrays, height, cfg, row0=0):
    m, s, q, o, sh = (t(x) for x in arrays)
    return rasterize(m, s, q, o, torch_cam(cam), t(BG), width=W,
                     height=height, sh_degree=3, config=cfg, shs=sh,
                     row0=row0)


def _assemble(strips, height):
    out = {}
    for k in KEYS:
        dim = 1 if k == "color" else 0
        out[k] = torch.cat([getattr(s, k) for s in strips],
                           dim=dim).narrow(dim, 0, height)
    return out


# (height, strips): 2 and 4 strips of a 4-row grid, a partial bottom tile
# (56 = 3.5 tiles), an uneven split (3 strips of 2 rows on 4 rows: the
# last strip lies below the frame)
CASES = [(64, 2), (64, 4), (56, 2), (64, 3)]


@pytest.mark.parametrize("height,n_strip", CASES)
def test_strips_assemble_to_full_frame(rng, height, n_strip):
    cam, arrays = _scene(rng, height)
    full = _render(cam, arrays, height, _cfg())
    grid_y = -(-height // TILE)
    rows = -(-grid_y // n_strip)
    strips = [_render(cam, arrays, height, _cfg(rows), s * rows)
              for s in range(n_strip)]
    for s in strips:
        assert s.color.shape == (3, rows * TILE, W)
        assert s.n_contrib.shape == (rows * TILE, W)
        assert torch.equal(s.radii, full.radii) and s.num_dropped == 0
    got = _assemble(strips, height)
    for k in KEYS:
        assert torch.equal(got[k], getattr(full, k)), k
    # rows past the frame's bottom are background, as in the JAX package
    below = torch.cat([s.color for s in strips], dim=1)[:, height:]
    assert torch.equal(below, t(BG)[:, None, None].expand_as(below))
    assert sum(s.num_instances for s in strips) >= full.num_instances


@pytest.mark.parametrize("height,n_strip", [(56, 2), (64, 3)])
def test_strips_match_jax_strips(rng, height, n_strip):
    """Each strip against the JAX package's strip render (backend="jax"),
    with the tolerances of tests/test_torch_compositing.py:_close."""
    cam, arrays = _scene(rng, height)
    grid_y = -(-height // TILE)
    rows = -(-grid_y // n_strip)
    jcfg = _jcfg(rows, tight=False)

    @jax.jit
    def strip(row0):
        return jrasterize(*(jnp.asarray(x) for x in arrays[:4]), cam,
                          jnp.asarray(BG), width=W, height=height,
                          sh_degree=3, config=jcfg,
                          shs=jnp.asarray(arrays[4]), row0=row0)
    for s in range(n_strip):
        a = strip(jnp.int32(s * rows))
        b = _render(cam, arrays, height, _cfg(rows, tight=False), s * rows)
        assert b.color.shape == tuple(a.color.shape)
        assert b.num_instances == int(a.num_instances)
        np.testing.assert_allclose(n(b.color), n(a.color), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(n(b.final_t), n(a.final_t), atol=1e-6)
        assert (n(b.n_contrib) == n(a.n_contrib)).mean() >= 0.999
        assert (n(b.depth) == n(a.depth)).mean() >= 0.999


def _torch_grads(cam, arrays, height, d_color, cfg, row0=0):
    leaves = [t(x).requires_grad_() for x in arrays]
    out = rasterize(*leaves[:4], torch_cam(cam), t(BG), width=W,
                    height=height, sh_degree=3, config=cfg, shs=leaves[4],
                    row0=row0)
    (out.color * t(d_color)).sum().backward()
    return [n(x.grad) for x in leaves]


def _jax_grad_fn(cam, height, cfg):
    """d/d(means, scales, quats, opacities, shs) of sum(strip * d_color),
    compiled once for every strip of one shape."""
    def loss(xs, d_color, row0):
        out = jrasterize(*xs[:4], cam, jnp.asarray(BG), width=W,
                         height=height, sh_degree=3, config=cfg, shs=xs[4],
                         row0=row0)
        return jnp.sum(out.color * d_color)
    return jax.jit(jax.grad(loss))


@pytest.mark.parametrize("height,n_strip", [(64, 2), (56, 2), (64, 4)])
def test_strip_grads_sum_to_full_and_match_jax(rng, height, n_strip):
    """Per-strip gradients (each strip's cotangent its rows of one
    full-frame cotangent) sum to the full frame's within 1e-5 of each
    group's largest entry (tests/test_strip.py:59-92), and each strip's
    meet the JAX package's strip gradients within 2e-4 of their largest
    (tests/test_torch_rasterize_grad.py)."""
    cam, arrays = _scene(rng, height, n_gauss=40)
    grid_y = -(-height // TILE)
    rows = -(-grid_y // n_strip)
    d_full = rng.normal(0, 1, (3, height, W)).astype(np.float32)
    padded = np.zeros((3, n_strip * rows * TILE, W), np.float32)
    padded[:, :height] = d_full
    g_full = _torch_grads(cam, arrays, height, d_full, _cfg())
    jgrad = _jax_grad_fn(cam, height, _jcfg(rows))
    g_sum = None
    for s in range(n_strip):
        d_strip = padded[:, s * rows * TILE:(s + 1) * rows * TILE]
        g = _torch_grads(cam, arrays, height, d_strip, _cfg(rows), s * rows)
        gj = jgrad([jnp.asarray(x) for x in arrays], jnp.asarray(d_strip),
                   jnp.int32(s * rows))
        for name, a, b in zip(NAMES, (np.asarray(x) for x in gj), g):
            scale = np.abs(a).max()
            assert scale > 0, name
            assert np.abs(a - b).max() / scale < 2e-4, (name, s)
        g_sum = g if g_sum is None else [x + y for x, y in zip(g_sum, g)]
    for name, a, b in zip(NAMES, g_full, g_sum):
        scale = np.abs(a).max() + 1e-6
        assert np.abs(a - b).max() / scale < 1e-5, name


def test_row0_needs_strip_rows(rng):
    cam, arrays = _scene(rng, 64)
    with pytest.raises(ValueError, match="strip_rows"):
        _render(cam, arrays, 64, _cfg(), row0=2)
