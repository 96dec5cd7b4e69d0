"""saro_gs_torch's losses, composite loss, Adam and LR schedule against
the JAX package's, on the same numpy inputs (rtol 1e-5 unless stated)."""
import jax.numpy as jnp
import numpy as np
import pytest

from saro_gs_torch.models import densify as tdens
from saro_gs_torch.models import field as tfield
from saro_gs_torch.train import losses as tl
from saro_gs_torch.train import optim as topt
from saro_gs_tpu.models import densify as jdens
from saro_gs_tpu.models import field as jfield
from saro_gs_tpu.train import losses as jl
from saro_gs_tpu.train import optim as jopt
from tests.torch_parity import n, t


def _images(rng, h=40, w=56):
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "rel_loss", "psnr",
                                  "ssim"])
def test_loss_matches_jax(rng, name):
    a, b = _images(rng)
    got = float(getattr(tl, name)(t(a), t(b)))
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ssim_map_and_msssim_match_jax(rng):
    a, b = _images(rng, 176, 192)     # five 2x levels above the 11-tap window
    np.testing.assert_allclose(n(tl.ssim_map(t(a), t(b))),
                               n(jl.ssim_map(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tl.msssim(t(a), t(b))),
                               float(jl.msssim(jnp.asarray(a),
                                               jnp.asarray(b))), rtol=1e-5)


def test_ssim_gradient_matches_jax(rng):
    import jax
    a, b = _images(rng)
    x = t(a).requires_grad_()
    tl.ssim(x, t(b)).backward()
    g = jax.grad(lambda u: jl.ssim(u, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(n(x.grad), n(g), rtol=1e-4,
                               atol=1e-5 * float(np.abs(n(g)).max()))


def test_composite_loss_with_every_lambda(rng):
    a, b = _images(rng)
    pts = 50
    res = dict(scale_residual=rng.normal(0, 0.1, (pts, 3)),
               shs_residual=rng.normal(0, 0.1, (pts, 16, 3)),
               motion_residual=rng.normal(0, 0.1, (pts, 3)),
               t_centers=rng.uniform(0, 1, pts))
    res = {k: v.astype(np.float32) for k, v in res.items()}
    planes = [rng.normal(0, 0.3, (4, 8, 9)).astype(np.float32)
              for _ in range(6)]
    lam = dict(lambda_dssim=0.2, lambda_dtstd=0.3, lambda_dscale_reg=0.1,
               lambda_dshs_reg=0.2, lambda_dmotion_reg=0.3,
               lambda_dplanetv=0.4, lambda_dtime_smooth=0.5)
    sh_mask = (np.arange(16) < 9).astype(np.float32)[:, None]
    for mask in (None, sh_mask):
        want, wlogs = jl.composite_loss(
            jl.LossWeights(**lam), jnp.asarray(a), jnp.asarray(b),
            **{k: jnp.asarray(v) for k, v in res.items()},
            active_sh_degree=1,
            sh_mask=None if mask is None else jnp.asarray(mask),
            grids=[[jnp.asarray(p) for p in planes]],
            plane_tv_fn=jfield.plane_tv,
            time_smooth_fn=jfield.time_smoothness)
        got, glogs = tl.composite_loss(
            tl.LossWeights(**lam), t(a), t(b),
            **{k: t(v) for k, v in res.items()}, active_sh_degree=1,
            sh_mask=None if mask is None else t(mask),
            grids=[t(p) for p in planes], plane_tv_fn=tfield.plane_tv,
            time_smooth_fn=tfield.time_smoothness)
        assert set(glogs) == set(wlogs) and len(glogs) == 9
        for k in wlogs:
            np.testing.assert_allclose(float(glogs[k]), float(wlogs[k]),
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_adam_three_steps_with_tensor_lrs_and_weight_decay(rng):
    shapes = [(20, 3), (20, 1, 3), (7, 5), (5,)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    row_lr = rng.uniform(1e-3, 1e-1, 20).astype(np.float32)
    lrs = [row_lr, row_lr * 2, 1e-2, np.float32(3e-3)]
    wds = [0.0, 0.0, 8e-7, 0.1]
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init_adam(jp)
    tp = [t(p) for p in params]
    ts = topt.init_adam(tp)
    for _ in range(3):
        grads = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
        jp, js = jopt.adam_step(js, jp, [jnp.asarray(g) for g in grads],
                                [jnp.asarray(x) for x in lrs], wds)
        tp, ts = topt.adam_step(
            ts, tp, [t(g) for g in grads],
            [t(x) if isinstance(x, np.ndarray) else float(x) for x in lrs],
            wds)
    assert ts.count == int(js.count) == 3
    for a, b in zip(jp + js.mu + js.nu, tp + ts.mu + ts.nu):
        np.testing.assert_allclose(n(b), n(a), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("step", [-1, 0, 1, 150, 2999, 30000, 40000])
def test_expon_lr_matches_jax(step):
    for kw in (dict(lr_delay_mult=0.01), dict(lr_delay_steps=200,
                                              lr_delay_mult=0.01),
               dict(start_step=100)):
        want = float(jopt.expon_lr(step, 1.6e-4, 1.6e-6, 30000, **kw))
        got = topt.expon_lr(step, 1.6e-4, 1.6e-6, 30000, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert topt.expon_lr(step, 0.0, 0.0, 30000) == 0.0


def test_densify_stats_and_integral_lr_match_jax(rng):
    c = 64
    aux = dict(xyz_grad_accum=rng.uniform(0, 1, (c, 1)),
               denom=rng.randint(0, 5, (c, 1)), max_radii2d=rng.uniform(
                   0, 9, c))
    aux = {k: v.astype(np.float32) for k, v in aux.items()}
    norm = rng.uniform(0, 1, c).astype(np.float32)
    vis = rng.rand(c) > 0.4
    radii = rng.randint(0, 20, c).astype(np.int32)
    a = jdens.add_stats(jdens.DensifyAux(**{k: jnp.asarray(v) for k, v in
                                            aux.items()}),
                        jnp.asarray(norm), jnp.asarray(vis),
                        jnp.asarray(radii))
    b = tdens.add_stats(tdens.DensifyAux(**{k: t(v) for k, v in
                                            aux.items()}),
                        t(norm), t(vis), t(radii))
    for x, y in zip(a, b):
        np.testing.assert_allclose(n(y), n(x), rtol=1e-6)
    alive = (rng.rand(c) > 0.1).astype(np.float32)
    integral = rng.uniform(0.0, 0.5, (c, 1)).astype(np.float32)
    for clip in (0.0, 50.0):
        ja, ji = jdens.integral_prune_and_lr(jnp.asarray(alive),
                                             jnp.asarray(integral), 0.0025,
                                             clip)
        ta, ti = tdens.integral_prune_and_lr(t(alive), t(integral), 0.0025,
                                             clip)
        np.testing.assert_array_equal(n(ta), n(ja))
        np.testing.assert_allclose(n(ti), n(ji), rtol=1e-6)
    # nothing survives: the LR scaling falls back to 1
    ta, ti = tdens.integral_prune_and_lr(t(alive), t(integral), 1.0)
    assert not n(ta).any() and (n(ti) == 1.0).all()
