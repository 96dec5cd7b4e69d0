"""saro_gs_torch's differentiable rasterize against the JAX package's
(backend="jax"), on the CPU through the plain versions of K1 and K3: the
image and every input gradient, the culled-point and active-mask gating,
and the forward-only refusal.  Mirrors tests/test_rasterize.py:127-200."""
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

W, H = 64, 48
BG = np.array([0.1, 0.2, 0.3], np.float32)
JCFG = JRasterConfig(tile_x=16, tile_y=16, chunk=8, max_instances=1 << 13,
                     tight_rect=True, max_slots=256, backend="jax")
TCFG = RasterConfig(tile_x=16, tile_y=16, chunk=8, max_instances=1 << 13,
                    tight_rect=True)


def _jax_grads(cam, means, scales, quats, opac, colour, d_color, use_sh,
               active=None):
    dcol = jnp.asarray(d_color)

    def loss_fn(means_, scales_, quats_, opac_, col_, dummy):
        o = jrasterize(means_, scales_, quats_, opac_, cam,
                       jnp.asarray(BG), width=W, height=H, sh_degree=3,
                       config=JCFG, shs=col_ if use_sh else None,
                       colors_precomp=None if use_sh else col_,
                       mean2d_dummy=dummy, active=active)
        return jnp.sum(o.color * dcol), o.color

    (_, img), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(opac), jnp.asarray(colour),
        jnp.zeros((means.shape[0], 2), jnp.float32))
    return np.asarray(img), [np.asarray(g) for g in grads]


def _torch_grads(cam, means, scales, quats, opac, colour, d_color, use_sh,
                 active=None, cfg=TCFG):
    leaves = [t(x).requires_grad_() for x in (means, scales, quats, opac,
                                              colour)]
    dummy = torch.zeros(means.shape[0], 2, requires_grad=True)
    o = rasterize(leaves[0], leaves[1], leaves[2], leaves[3],
                  torch_cam(cam), t(BG), width=W, height=H, sh_degree=3,
                  config=cfg, shs=leaves[4] if use_sh else None,
                  colors_precomp=None if use_sh else leaves[4],
                  mean2d_dummy=dummy,
                  active=None if active is None else t(active))
    assert o.num_dropped == 0
    (o.color * t(d_color)).sum().backward()
    return n(o.color), [n(x.grad) for x in leaves + [dummy]]


NAMES = ["means", "scales", "quats", "opacities", "colour", "mean2d_dummy"]


@pytest.mark.parametrize("use_sh", [True, False])
def test_every_input_gradient_matches_jax(rng, use_sh):
    """Each gradient within 2e-4 of the JAX gradient's largest entry (both
    are float32 sums over the same pixels in another order), the image to
    1e-5."""
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(rng, n=120)
    opac[::6] = 0.995        # saturating splats: the 0.99 clamp, the latch
    colour = shs if use_sh else np.abs(shs[:, 0]).astype(np.float32)
    d_color = rng.normal(0, 1, (3, H, W)).astype(np.float32)
    img_j, gj = _jax_grads(cam, means, scales, quats, opac, colour, d_color,
                           use_sh)
    img_t, gt = _torch_grads(cam, means, scales, quats, opac, colour,
                             d_color, use_sh)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-5)
    for name, a, b in zip(NAMES, gj, gt):
        assert a.shape == b.shape, name
        scale = np.abs(a).max()
        assert scale > 0, name
        err = np.abs(a - b).max() / scale
        assert err < 2e-4, f"{name}: rel err {err}"


def test_active_mask_and_culled_overflow_give_finite_zeros(rng):
    """Inactive slots, and a culled point whose scale overflowed, get
    exactly zero, finite gradients; the others are unchanged."""
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(rng, n=60)
    d_color = rng.normal(0, 1, (3, H, W)).astype(np.float32)
    active = np.ones(60, np.float32)
    active[40:] = 0.0
    _, g_sub = _torch_grads(cam, means[:40], scales[:40], quats[:40],
                            opac[:40], shs[:40], d_color, True)
    scales = scales.copy()
    means = means.copy()
    scales[45] = np.inf              # inactive and overflowed
    means[46] = -1e30                # far behind the camera
    img, g = _torch_grads(cam, means, scales, quats, opac, shs, d_color,
                          True, active=active)
    assert np.isfinite(img).all()
    for name, full, sub in zip(NAMES, g, g_sub):
        assert np.isfinite(full).all(), name
        assert not full[40:].any(), name
        np.testing.assert_allclose(full[:40], sub, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_need_aux_false_under_grad_raises(rng):
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(rng, n=10)
    with pytest.raises(RuntimeError, match="forward-only"):
        _torch_grads(cam, means, scales, quats, opac, shs,
                     np.zeros((3, H, W), np.float32), True,
                     cfg=TCFG._replace(need_aux=False))
    # without gradients the same config renders
    with torch.no_grad():
        o = rasterize(t(means), t(scales), t(quats), t(opac),
                      torch_cam(cam), t(BG), width=W, height=H, sh_degree=3,
                      config=TCFG._replace(need_aux=False), shs=t(shs))
    assert torch.isfinite(o.color).all()
