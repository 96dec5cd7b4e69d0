"""The CUDA kernels of saro_gs_torch against their plain versions, on the
card.  Skipped without one.  This file imports neither jax nor the JAX
package (the card's machine has no jax), so it runs there without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from saro_gs_torch.data import cameras
from saro_gs_torch.ops import (binning, compositing, grid_scatter,
                               projection, tile_kernels)
from saro_gs_torch.models import field as field_mod
from saro_gs_torch.models import gaussians as gm
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
from saro_gs_torch.train import losses
from saro_gs_torch.train import step as step_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    tile_kernels.build()
    return torch.device("cuda")


def _scene(seed, count, width, height):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    means = rng.uniform(-1.2, 1.2, (count, 3)).astype(f32)
    scales = rng.uniform(0.01, 0.2, (count, 3)).astype(f32)
    quats = rng.normal(0, 1, (count, 4)).astype(f32)
    opac = rng.uniform(0.01, 1.0, count).astype(f32)
    opac[::7] = 0.999
    shs = rng.normal(0, 0.3, (count, 16, 3)).astype(f32)
    cam = cameras.camera_from_c2w(cameras.ring_cameras(5)[1], 0.85, width,
                                  height, 0.0)
    return cam, [torch.as_tensor(x) for x in (means, scales, quats, opac,
                                               shs)]


def _pre(dev, tile, tight, seed=0, count=3000, width=200, height=150):
    cam, (m, s, q, o, sh) = _scene(seed, count, width, height)
    pre = projection.preprocess(
        m.to(dev), s.to(dev), q.to(dev), o.to(dev),
        cam.raster_params(device=dev), width, height, tile, tile,
        sh_degree=3, shs=sh.to(dev), tight_rect=tight)
    return pre, o.to(dev), width, height


@pytest.mark.parametrize("tile,tight,cap", [(16, False, 1 << 20),
                                            (32, True, 1 << 20),
                                            (32, True, 5000)])
def test_expand_kernel_matches_plain(dev, tile, tight, cap):
    pre, o, w, h = _pre(dev, tile, tight)
    gx, gy = -(-w // tile), -(-h // tile)
    tile_kernels.reset_launches()
    keys, gid, attr, n_inst, n_drop = binning.expand(pre, o, gx, gy, cap,
                                                     tile, tile, tight)
    assert tile_kernels.launches["expand"] == 1
    assert (n_drop > 0) == (cap == 5000)
    offsets, tiles, rect, gattr, _ = binning.expand_inputs(pre, o)
    pk, pg, pa = tile_kernels.expand_instances_plain(
        offsets, tiles, rect, gattr, n_inst, gx, gy, tile, tile, tight)
    assert torch.equal(keys, pk) and torch.equal(gid, pg)
    assert torch.equal(attr.view(torch.int32), pa.view(torch.int32))


@pytest.mark.parametrize("tile,chunk,need_aux", [(16, 64, True),
                                                 (32, 128, True),
                                                 (32, 100, False)])
def test_forward_kernel_matches_plain(dev, tile, chunk, need_aux):
    pre, o, w, h = _pre(dev, tile, True)
    gx, gy = -(-w // tile), -(-h // tile)
    bins = binning.bin_gaussians_staged(pre, o, gx, gy, 1 << 20, tile, tile)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    tile_kernels.reset_launches()
    k = tile_kernels.forward_tiles(bins.attr, bins.tile_start,
                                   bins.tile_count, bg, w, h, tile, tile,
                                   chunk, need_aux=need_aux)
    torch.cuda.synchronize()
    assert tile_kernels.launches["forward"] == 1
    p = compositing.forward_tiles(bins.attr, bins.tile_start,
                                  bins.tile_count, bg, w, h, tile, tile,
                                  need_aux=need_aux)
    assert float(p.final_t.min()) < 1e-3
    assert (k.color - p.color).abs().max().item() <= 1e-4
    assert (k.final_t - p.final_t).abs().max().item() <= 1e-4
    assert (k.depth == p.depth).float().mean().item() >= 0.999
    if need_aux:
        assert (k.n_contrib == p.n_contrib).float().mean().item() >= 0.999
    else:
        assert int(k.n_contrib.abs().sum()) == 0


def test_forward_kernel_masks_rows_past_the_range(dev):
    """NaN rows right after a tile's range never reach its pixels."""
    rows = [(3.0, 3.0, 0.5, 0.0, 0.5, 0.5, 1, 0, 0, 1.0)] + \
        [(math.nan,) * 10] * 200
    attr = torch.tensor(np.array(rows, np.float32).T.copy(), device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    bg = torch.ones(3, device=dev)
    for count in (0, 1):
        cnt = torch.full((1,), count, dtype=torch.int32, device=dev)
        k = tile_kernels.forward_tiles(attr, start, cnt, bg, 8, 8, 8, 8, 64)
        p = compositing.forward_tiles(attr, start, cnt, bg, 8, 8, 8, 8)
        assert torch.isfinite(k.color).all()
        assert torch.equal(k.color, p.color)


def test_render_cuda_matches_cpu(dev):
    cam, (m, s, q, o, sh) = _scene(3, 1500, 96, 80)
    cfg = RasterConfig(tile_x=32, tile_y=32, chunk=128, max_instances=1 << 18)
    outs = []
    for d in ("cpu", dev):
        with torch.no_grad():
            outs.append(rasterize(
                m.to(d), s.to(d), q.to(d), o.to(d), cam.raster_params(d),
                torch.ones(3, device=d), width=96, height=80, sh_degree=3,
                config=cfg, shs=sh.to(d)))
    a, b = outs
    assert a.num_instances == b.num_instances
    assert (b.color.cpu() - a.color).abs().max().item() < 1e-4


def test_wrappers_refuse_bad_inputs(dev):
    attr = torch.zeros(10, 4, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        tile_kernels.forward_tiles(attr, start.long(), start, torch.ones(
            3, device=dev), 8, 8, 8, 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tile_kernels.forward_tiles(attr.T.contiguous().T, start, start,
                                   torch.ones(3, device=dev), 8, 8, 8, 8, 64)
    with pytest.raises(ValueError, match="on"):
        tile_kernels.forward_tiles(attr, start.cpu(), start,
                                   torch.ones(3, device=dev), 8, 8, 8, 8, 64)


@pytest.mark.parametrize("tile,chunk", [(16, 64), (32, 128), (32, 7)])
def test_backward_kernel_matches_plain(dev, monkeypatch, tile, chunk):
    """K3 against compositing.backward_tiles: each row within 1e-5 of the
    row's largest entry and 1e-5 in relative L2 (the kernel sums an
    instance's pixels in another order), unvisited slots exactly zero, two
    launches equal to the bit.  The backward's own batch is also run at an
    odd size."""
    monkeypatch.setattr(tile_kernels, "BACKWARD_CHUNK",
                        min(chunk, tile_kernels.BACKWARD_CHUNK))
    pre, o, w, h = _pre(dev, tile, True)
    gx, gy = -(-w // tile), -(-h // tile)
    bins = binning.bin_gaussians_staged(pre, o, gx, gy, 1 << 20, tile, tile)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    f = tile_kernels.forward_tiles(bins.attr, bins.tile_start,
                                   bins.tile_count, bg, w, h, tile, tile,
                                   chunk, need_aux=True)
    gen = torch.Generator(device="cpu").manual_seed(1)
    d_color = torch.randn(3, h, w, generator=gen).to(dev)
    args = (bins.attr, bins.tile_start, bins.tile_count, bg, f.n_contrib,
            f.color, f.final_t, d_color, w, h, tile, tile)
    tile_kernels.reset_launches()
    k = tile_kernels.backward_tiles(*args)
    k2 = tile_kernels.backward_tiles(*args)
    torch.cuda.synchronize()
    assert tile_kernels.launches["backward"] == 2
    assert torch.equal(k, k2)
    p = compositing.backward_tiles(*args)
    assert k.shape == p.shape == (9, bins.attr.shape[1])
    assert float(f.final_t.min()) < 1e-3
    for r in range(9):
        scale = p[r].abs().max().item()
        assert scale > 0
        assert (k[r] - p[r]).abs().max().item() <= 1e-5 * scale, r
        assert ((k[r] - p[r]).norm() / p[r].norm()).item() <= 1e-5, r
    assert not k[:, (p == 0).all(0)].any()


def test_backward_kernel_masks_rows_past_the_range(dev):
    """NaN rows right after a tile's range reach no gradient."""
    rows = [(3.0, 3.0, 0.5, 0.0, 0.5, 0.5, 1, 0, 0, 1.0)] + \
        [(math.nan,) * 10] * 200
    attr = torch.tensor(np.array(rows, np.float32).T.copy(), device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    cnt = torch.ones(1, dtype=torch.int32, device=dev)
    bg = torch.ones(3, device=dev)
    f = tile_kernels.forward_tiles(attr, start, cnt, bg, 8, 8, 8, 8, 64)
    d_color = torch.ones(3, 8, 8, device=dev)
    args = (attr, start, cnt, bg, f.n_contrib, f.color, f.final_t, d_color,
            8, 8, 8, 8)
    k = tile_kernels.backward_tiles(*args)
    p = compositing.backward_tiles(*args)
    assert torch.isfinite(k).all() and not k[:, 1:].any()
    assert (k[:, 0] - p[:, 0]).abs().max().item() <= 1e-5 * \
        p[:, 0].abs().max().item()


@pytest.mark.parametrize("n_pts,total,c", [(1000, 2048, 8), (300, 513, 16),
                                           (4096, 4096, 32), (50, 40, 70)])
def test_scatter_kernel_matches_plain(dev, n_pts, total, c):
    """K4 against the per-tap index_add_: 1e-5 of the output's largest
    entry, two launches equal to the bit."""
    rng = np.random.RandomState(0)
    cells = torch.as_tensor(rng.randint(0, total, (4, n_pts))).to(dev)
    weights = torch.as_tensor(rng.rand(4, n_pts).astype(np.float32)).to(dev)
    dfeat = torch.as_tensor(rng.randn(n_pts, c).astype(np.float32)).to(dev)
    tile_kernels.reset_launches()
    k = grid_scatter.scatter_taps(cells, weights, dfeat, total)
    k2 = grid_scatter.scatter_taps(cells.int(), weights, dfeat, total)
    torch.cuda.synchronize()
    assert tile_kernels.launches["grid_scatter"] == 2
    assert torch.equal(k, k2)
    p = grid_scatter.scatter_taps_plain(cells.cpu(), weights.cpu(),
                                        dfeat.cpu(), total)
    assert k.shape == p.shape == (c, total)
    assert (k.cpu() - p).abs().max().item() <= 1e-5 * p.abs().max().item()


def test_scatter_kernel_hot_cell(dev):
    """Every tap on one texel: one warp's long walk stays exact."""
    rng = np.random.RandomState(1)
    n_pts, total, c = 3000, 1024, 8
    cells = torch.full((4, n_pts), 37, dtype=torch.int64, device=dev)
    weights = torch.as_tensor(rng.rand(4, n_pts).astype(np.float32)).to(dev)
    dfeat = torch.as_tensor(rng.randn(n_pts, c).astype(np.float32)).to(dev)
    k = grid_scatter.scatter_taps(cells, weights, dfeat, total).cpu()
    p = grid_scatter.scatter_taps_plain(cells.cpu(), weights.cpu(),
                                        dfeat.cpu(), total)
    # the CPU's index_add_ walks the taps in the kernel's order
    assert torch.equal(k, p)
    assert not k[:, :37].any() and not k[:, 38:].any()


def test_rasterize_gradients_cuda_match_cpu(dev):
    cam, (m, s, q, o, sh) = _scene(3, 1500, 96, 80)
    cfg = RasterConfig(tile_x=32, tile_y=32, chunk=128, max_instances=1 << 18)
    gen = torch.Generator(device="cpu").manual_seed(2)
    d_color = torch.randn(3, 80, 96, generator=gen)
    grads = []
    for d in ("cpu", dev):
        leaves = [x.detach().clone().to(d).requires_grad_()
                  for x in (m, s, q, o, sh)]
        dummy = torch.zeros(1500, 2, device=d, requires_grad=True)
        out = rasterize(leaves[0], leaves[1], leaves[2], leaves[3],
                        cam.raster_params(d), torch.ones(3, device=d),
                        width=96, height=80, sh_degree=3, config=cfg,
                        shs=leaves[4], mean2d_dummy=dummy)
        (out.color * d_color.to(d)).sum().backward()
        grads.append([x.grad.cpu() for x in leaves + [dummy]])
    for a, b in zip(*grads):
        scale = a.abs().max().item()
        assert scale > 0
        assert (a - b).abs().max().item() <= 1e-3 * scale


def _toy_train_state(device, count=600):
    """A small random model (planes 16^3 x 8, heads of width 32) with an
    LR scaling, on ``device``; the same numbers on every device."""
    rng = np.random.RandomState(4)
    f32 = np.float32
    mcfg = gm.ModelConfig(
        deform_hidden_dim=32, dsh=True, scale_reg=True,
        field=field_mod.FieldConfig(resolution=(16, 16, 16, 8), out_dim=8,
                                    multires=(1,)))

    def t(x):
        return torch.as_tensor(x.astype(f32), device=device)
    points = gm.GaussianParams(
        xyz=t(rng.uniform(-1.2, 1.2, (count, 3))),
        features_dc=t(rng.normal(0, 0.8, (count, 1, 3))),
        features_rest=t(rng.normal(0, 0.1, (count, 15, 3))),
        scaling=t(np.log(rng.uniform(0.03, 0.15, (count, 3)))),
        rotation=t(rng.normal(0, 1, (count, 4))),
        opacity=t(rng.uniform(-2.0, 4.0, (count, 1))),
        temporal_pos=t(rng.uniform(0, 1, (count, 1))))
    torch.manual_seed(0)
    nets = gm.DeformNets(mcfg)
    with torch.no_grad():
        for p in nets.field.planes:
            p.copy_(torch.as_tensor(rng.normal(0, 0.3, tuple(p.shape))
                                    .astype(f32)))
    nets.to(device)
    fstatic = field_mod.FieldStatic(aabb_min=t(np.full(3, -1.5)),
                                    aabb_max=t(np.full(3, 1.5)),
                                    duration=t(np.array(50.0)))
    state = step_mod.init_state(points, nets,
                                torch.ones(count, device=device))
    state = state._replace(inv_integral=t(rng.uniform(1, 5, (count, 1))))
    return state, fstatic, mcfg


def test_train_step_cuda_matches_cpu(dev):
    """One dynamic-stage step on the card (all four kernels) against the
    same step on the CPU (their plain versions): the loss to 1e-5, every
    Adam first moment within 1e-3 of its largest entry; and two steps on
    the card from one state equal to the bit."""
    w, h, batch = 96, 80, 2
    rcfg = RasterConfig(tile_x=32, tile_y=32, chunk=128,
                        max_instances=1 << 16)
    gt = torch.as_tensor((np.random.RandomState(0).uniform(
        0, 1, (batch, 3, h, w)) * 255).astype(np.uint8))
    ts = torch.linspace(0.1, 0.9, batch).reshape(-1, 1, 1)
    results = []
    for d in ("cpu", dev, dev):
        state, fstatic, mcfg = _toy_train_state(d)
        st = step_mod.StepStatics(
            mcfg=mcfg, rcfg=rcfg,
            weights=losses.LossWeights(lambda_dssim=0.2,
                                       lambda_dscale_reg=8e-6),
            width=w, height=h,
            cfg_lrs=(1.6e-4, 1.6e-6, 0.01, 30000, 0.0025, 0.05, 0.005,
                     0.001, 1e-4, 1.6e-4, 1.6e-7, 3.2e-3, 3.2e-6),
            extent=1.3)
        cams = [cameras.camera_from_c2w(c2w, 0.85, w, h, 0.0)
                .raster_params(d) for c2w in cameras.ring_cameras(batch)]
        tile_kernels.reset_launches()
        new, m = step_mod.train_step_core(
            state, CameraParams(*[torch.stack(x) for x in zip(*cams)]),
            gt.to(d), ts.to(d), torch.ones(3, device=d), fstatic, st,
            stage="dynamatic", sh_degree=3, scale_integral=True)
        assert m["bad_step"] == 0 and m["dropped"] == 0
        if d != "cpu":
            assert tile_kernels.launches == {"expand": batch,
                                             "forward": batch,
                                             "backward": batch,
                                             "grid_scatter": 9}
        results.append((m, [x.cpu() for x in new.opt.mu],
                        [x.detach().cpu() for x in step_mod.param_leaves(
                            new.points, new.nets)]))
    (m_cpu, mu_cpu, _), (m_a, mu_a, p_a), (m_b, mu_b, p_b) = results
    assert abs(m_cpu["loss"] - m_a["loss"]) <= 1e-5 * abs(m_cpu["loss"])
    for a, b in zip(mu_cpu, mu_a):
        assert (a - b).abs().max().item() <= 1e-3 * a.abs().max().item() \
            + 1e-12
    assert m_a == m_b
    for a, b in zip(mu_a + p_a, mu_b + p_b):
        assert torch.equal(a, b)
