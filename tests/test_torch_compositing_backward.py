"""saro_gs_torch's plain backward compositor (the CPU twin of kernel K3)
against the JAX package: its pure-JAX backward_tiles, its Pallas backward
kernel in interpret mode, and the NumPy oracle."""
import jax.numpy as jnp
import numpy as np
import torch

from saro_gs_torch.ops import compositing as tcomp
from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
from saro_gs_tpu.ops import binning as jbin
from saro_gs_tpu.ops import compositing as jcomp
from saro_gs_tpu.ops import projection as jproj
from saro_gs_tpu.ops import tile_kernels as jtk
from tests.oracle import raster_oracle as oracle
from tests.scene_fixtures import make_camera, make_gaussians
from tests.torch_parity import n, t, torch_cam

W, H = 64, 48
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _rows_close(b, a, tol):
    """Every row of the port's [9, L] within ``tol`` of the row's largest
    reference entry."""
    assert a.shape == b.shape
    for r in range(a.shape[0]):
        scale = np.abs(a[r]).max()
        assert scale > 0, r
        assert np.abs(a[r] - b[r]).max() <= tol * scale, (
            r, np.abs(a[r] - b[r]).max() / scale)


def test_plain_backward_matches_jax_backward_tiles(rng):
    """The same instances through JAX's sequential backward_tiles and the
    port's, on a dense scene with saturating splats (the latch, the 0.99
    clamp): 1e-4 of each row's largest entry (float32 sums over a tile's
    pixels in another order)."""
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(rng, n=300)
    opac[::6] = 0.995
    tile, slots = 16, 512
    pre = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                           jnp.asarray(quats), jnp.asarray(opac), cam, W, H,
                           tile, tile, sh_degree=3, shs=jnp.asarray(shs))
    gx, gy = -(-W // tile), -(-H // tile)
    bins = jbin.bin_gaussians(pre, gx, gy, 1 << 14, 64)
    args = (bins.point_list, bins.tile_start, bins.tile_count, pre.mean2d,
            pre.conic, jnp.asarray(opac), pre.rgb)
    fwd = jcomp.forward_tiles(*args, pre.depth, jnp.asarray(BG), W, H, tile,
                              tile, slots)
    d_color = rng.normal(0, 1, (3, H, W)).astype(np.float32)
    inst = jcomp.backward_tiles(*args, jnp.asarray(BG), fwd.color,
                                fwd.final_t, jnp.asarray(d_color), W, H,
                                tile, tile, slots)
    a = np.concatenate([n(inst.d_rgb), n(inst.d_mean2d), n(inst.d_conic),
                        n(inst.d_opacity)[:, None]], axis=1).T     # [9, MI]
    assert float(n(fwd.final_t).min()) < 1e-3

    # the port's staged table from JAX's point list, padding slots zero
    pl = n(bins.point_list)
    g = np.clip(pl, 0, None)
    cols = [n(pre.mean2d)[g, 0], n(pre.mean2d)[g, 1], n(pre.conic)[g, 0],
            n(pre.conic)[g, 1], n(pre.conic)[g, 2], opac[g],
            n(pre.rgb)[g, 0], n(pre.rgb)[g, 1], n(pre.rgb)[g, 2],
            n(pre.depth)[g]]
    attr = np.where(pl[None] >= 0, np.stack(cols), 0.0).astype(np.float32)
    b = tcomp.backward_tiles(t(attr), t(bins.tile_start), t(bins.tile_count),
                             t(BG), t(fwd.n_contrib), t(fwd.color),
                             t(fwd.final_t), t(d_color), W, H, tile, tile)
    _rows_close(n(b), a, 1e-4)
    assert not n(b)[:, pl < 0].any()


def test_plain_backward_matches_pallas_interpret(rng):
    """The same staged table through JAX's Pallas backward kernel
    (interpret mode) and the port's plain version, 32x32 tiles.  A sparse
    scene: the Pallas kernels' prefix products move the T < 1e-4 latch
    where pixels saturate, so JAX's own two backends differ there."""
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(rng, n=60)
    pre = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                           jnp.asarray(quats), jnp.asarray(opac), cam, W, H,
                           32, 32, sh_degree=3, shs=jnp.asarray(shs),
                           tight_rect=True)
    bins = jbin.bin_gaussians_staged(pre, jnp.asarray(opac), 2, 2, 1 << 14,
                                     128, tile_x=32, tile_y=32,
                                     packed=False, expander="sort")
    fwd = jtk.forward_tiles_pallas(bins, jnp.asarray(BG), W, H, 32, 32, 128)
    d_color = rng.normal(0, 1, (3, H, W)).astype(np.float32)
    a = jtk.backward_tiles_pallas(bins, jnp.asarray(BG), fwd.color,
                                  fwd.final_t, jnp.asarray(d_color), W, H,
                                  32, 32, 128, n_contrib=fwd.n_contrib)
    b = tcomp.backward_tiles(t(n(bins.attr)[:10]), t(bins.tile_start),
                             t(bins.tile_count), t(BG), t(fwd.n_contrib),
                             t(fwd.color), t(fwd.final_t), t(d_color), W, H,
                             32, 32)
    _rows_close(n(b), n(a)[:9], 1e-4)


def test_rasterize_gradients_match_oracle(rng):
    """The whole backward (plain K3, the per-Gaussian reduce, the
    reference's preprocess chain) against the float64 NumPy oracle with
    the reference's instance sets: 5e-3 of each gradient's largest entry,
    the float32 drift of conics and alphas (the JAX package is held to
    1e-4 in float64)."""
    cam, meta = make_camera()
    means, scales, quats, opac, shs = make_gaussians(rng, n=40)
    bg = np.zeros(3)
    w, h = meta["width"], meta["height"]
    f = float
    cam64 = (np.asarray(cam.viewmat, f), np.asarray(cam.projmat, f),
             np.asarray(cam.campos, f))
    ref = oracle.oracle_render(
        means.astype(f), scales.astype(f), quats.astype(f), opac.astype(f),
        *cam64, w, h, meta["tanfovx"], meta["tanfovy"], bg, sh_degree=3,
        shs=shs.astype(f))
    d_color = rng.normal(0, 1, (3, h, w))
    gref = oracle.oracle_backward(
        ref, means.astype(f), scales.astype(f), quats.astype(f),
        opac.astype(f), *cam64, w, h, meta["tanfovx"], meta["tanfovy"], bg,
        d_color, sh_degree=3, shs=shs.astype(f))
    leaves = [t(x).requires_grad_() for x in (means, scales, quats, opac,
                                              shs)]
    dummy = torch.zeros(40, 2, requires_grad=True)
    out = rasterize(*leaves[:4], torch_cam(cam), t(bg.astype(np.float32)),
                    width=w, height=h, sh_degree=3,
                    config=RasterConfig(tile_x=16, tile_y=16, chunk=8,
                                        max_instances=4096,
                                        tight_rect=False),
                    shs=leaves[4], mean2d_dummy=dummy)
    (out.color * t(d_color.astype(np.float32))).sum().backward()
    names = ["d_means", "d_scales", "d_quats", "d_opacity", "d_shs",
             "d_mean2d"]
    for x, name in zip(leaves + [dummy], names):
        r = gref[name]
        g = n(x.grad).reshape(r.shape)
        err = np.abs(g - r).max() / (np.abs(r).max() + 1e-8)
        assert err < 5e-3, f"{name}: rel err {err}"
