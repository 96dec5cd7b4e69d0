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
from saro_gs_torch.models import densify as dens
from saro_gs_torch.train import losses
from saro_gs_torch.train import step as step_mod
from saro_gs_torch.train import trainer as trainer_mod

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


def test_expand_kernel_wide_splat_and_capacity_cut(dev):
    """K2 exact on a table with one splat over 600 tiles among small ones,
    zero-tile Gaussians between and after them, and capacities that cut
    inside the wide run and inside a small one."""
    rng = np.random.RandomState(8)
    n, gx, gy, tile = 2000, 43, 32, 32
    rmin = np.stack([rng.randint(0, gx - 3, n), rng.randint(0, gy - 3, n)])
    size = np.stack([rng.randint(1, 4, n), rng.randint(1, 4, n)])
    rmin[:, 700], size[:, 700] = (2, 3), (30, 20)
    rect = np.stack([rmin[0], rmin[1], rmin[0] + size[0]]).astype(np.int32)
    tiles = (size[0] * size[1]).astype(np.int32)
    tiles[rng.rand(n) < 0.3] = 0
    tiles[-40:] = 0
    tiles[700] = 600
    offsets = (np.cumsum(tiles) - tiles).astype(np.int32)
    gattr = np.zeros((10, n), np.float32)
    gattr[0] = (rmin[0] + size[0] / 2) * tile
    gattr[1] = (rmin[1] + size[1] / 2) * tile
    sig = rng.uniform(2, 40, n)
    sig[700] = 150.0                    # the corner cull trims its corners
    gattr[2], gattr[4] = 1 / sig ** 2, 1 / sig ** 2
    gattr[3] = rng.uniform(-0.3, 0.3, n) / sig ** 2
    gattr[5] = rng.uniform(0.001, 1, n)
    gattr[5, 700] = 0.9
    gattr[6:9] = rng.uniform(0, 1, (3, n))
    gattr[9] = rng.uniform(0.3, 50, n)
    total = int(tiles.sum())
    small = int(np.flatnonzero(tiles >= 4)[-1])
    args = [torch.as_tensor(x, device=dev) for x in (offsets, tiles, rect,
                                                      gattr)]
    for n_inst in (total, int(offsets[700]) + 250, int(offsets[small]) + 1):
        for cull in (True, False):
            rest = (n_inst, gx, gy, tile, tile, cull)
            k = tile_kernels.expand_instances(*args, *rest)
            p = tile_kernels.expand_instances_plain(*args, *rest)
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
            assert torch.equal(k[2].view(torch.int32),
                               p[2].view(torch.int32))
            if cull:
                assert (k[1] < 0).any() and (k[1] == 700).sum() > 100


def _assert_forward_equal(k, p, need_aux):
    """K1 against its plain version: equal to the bit."""
    assert torch.equal(k.color, p.color)
    assert torch.equal(k.depth, p.depth)
    assert torch.equal(k.final_t, p.final_t)
    if need_aux:
        assert torch.equal(k.n_contrib, p.n_contrib)
    else:
        assert int(k.n_contrib.abs().sum()) == 0


@pytest.mark.parametrize("need_aux", [True, False])
@pytest.mark.parametrize("chunk", [64, 100, 128])
@pytest.mark.parametrize("tile", [16, 32])
def test_forward_kernel_matches_plain(dev, tile, chunk, need_aux):
    """K1 (bands, warp cull, per-warp stop) equal to the bit to its plain
    version in colour, depth, final T and n_contrib, whatever the tile
    and the staging batch."""
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
    _assert_forward_equal(k, p, need_aux)


@pytest.mark.parametrize("tile_x,tile_y", [(12, 10), (64, 16), (8, 8)])
def test_forward_kernel_other_tiles(dev, tile_x, tile_y):
    """K1 on tiles the arena config does not use: a 12x10 tile is two
    bands (8 rows, then 2) of consecutive pixels rather than 8x4 patches, a
    64x16 tile four bands of 64x4, an 8x8 tile one block of 64 threads.
    Equal to the bit."""
    cam, (m, s, q, o, sh) = _scene(0, 3000, 200, 150)
    pre = projection.preprocess(
        m.to(dev), s.to(dev), q.to(dev), o.to(dev), cam.raster_params(dev),
        200, 150, tile_x, tile_y, sh_degree=3, shs=sh.to(dev),
        tight_rect=True)
    gx, gy = -(-200 // tile_x), -(-150 // tile_y)
    bins = binning.bin_gaussians_staged(pre, o.to(dev), gx, gy, 1 << 20,
                                        tile_x, tile_y)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    k = tile_kernels.forward_tiles(bins.attr, bins.tile_start,
                                   bins.tile_count, bg, 200, 150, tile_x,
                                   tile_y, 64, need_aux=True)
    p = compositing.forward_tiles(bins.attr, bins.tile_start,
                                  bins.tile_count, bg, 200, 150, tile_x,
                                  tile_y, need_aux=True)
    _assert_forward_equal(k, p, True)


def test_forward_kernel_heavy_tile(dev):
    """One 32x32 tile with 4,000 instances: opaque splats over its top-left
    corner end those warps' walks early, faint ones elsewhere keep the other
    warps walking to the end of the range.  Equal to the bit."""
    rng = np.random.RandomState(6)
    n, n_opaque, tile = 4000, 300, 32
    rows = np.zeros((10, n), np.float32)
    rows[0:2] = rng.uniform(-4, 36, (2, n))
    rows[0:2, :n_opaque] = rng.uniform(0, 8, (2, n_opaque))
    sig = rng.uniform(2.0, 12.0, n)
    sig[:n_opaque] = rng.uniform(1.5, 3.0, n_opaque)
    rows[2] = 1.0 / sig ** 2
    rows[3] = rng.uniform(-0.2, 0.2, n) / sig ** 2
    rows[4] = 1.0 / sig ** 2
    rows[5] = rng.uniform(0.004, 0.03, n)
    rows[5, :n_opaque] = rng.uniform(0.6, 0.95, n_opaque)
    rows[6:9] = rng.uniform(0, 1, (3, n))
    rows[9] = np.sort(rng.uniform(1, 10, n))
    perm = rng.permutation(n)                 # opaque ones spread in depth
    rows[:9] = rows[:9, perm]
    attr = torch.as_tensor(rows, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), n, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    for chunk in (64, 128):
        k = tile_kernels.forward_tiles(attr, start, cnt, bg, tile, tile,
                                       tile, tile, chunk, need_aux=True)
        p = compositing.forward_tiles(attr, start, cnt, bg, tile, tile, tile,
                                      tile, need_aux=True)
        _assert_forward_equal(k, p, True)
    # the 8x4-pixel warp patches: some end before half the range, some
    # walk all of it
    patches = p.n_walked.reshape(8, 4, 4, 8).permute(0, 2, 1, 3)
    assert int((patches < n // 2).all(3).all(2).sum()) >= 2
    assert int((patches == n).all(3).all(2).sum()) >= 2


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


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_compositors_any_tile_order(dev, kernel):
    """K1 and K3 launched in a random tile order give the bits of the
    heaviest-first order binning computes."""
    tile = 32
    pre, o, w, h = _pre(dev, tile, True)
    gx, gy = -(-w // tile), -(-h // tile)
    bins = binning.bin_gaussians_staged(pre, o, gx, gy, 1 << 20, tile, tile)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    shuffled = torch.randperm(gx * gy, generator=gen).to(dev, torch.int32)
    assert not torch.equal(shuffled, bins.tile_order)

    def forward(order):
        return tile_kernels.forward_tiles(
            bins.attr, bins.tile_start, bins.tile_count, bg, w, h, tile,
            tile, 128, need_aux=True, tile_order=order)
    f = forward(bins.tile_order)
    if kernel == "forward":
        _assert_forward_equal(forward(shuffled), f, True)
        return
    d_color = torch.randn(3, h, w, generator=gen).to(dev)
    args = (bins.attr, bins.tile_start, bins.tile_count, bg, f.n_contrib,
            f.color, f.final_t, d_color, w, h, tile, tile)
    assert torch.equal(
        tile_kernels.backward_tiles(*args, tile_order=shuffled),
        tile_kernels.backward_tiles(*args, tile_order=bins.tile_order))


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
    with pytest.raises(ValueError, match="levels"):
        grid_scatter.scatter_mip_taps(torch.zeros(4, 2, device=dev), None,
                                      torch.zeros(4, 8, device=dev), 8, 8, 4)


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


def test_backward_kernel_heavy_tile(dev):
    """One tile with thousands of faint, overlapping instances: the
    replay runs many batches deep (the double-buffered staging, the
    per-warp bounds), held as in test_backward_kernel_matches_plain."""
    rng = np.random.RandomState(5)
    n, tile = 4000, 32
    rows = np.zeros((10, n), np.float32)
    rows[0:2] = rng.uniform(-4, 36, (2, n))
    sig = rng.uniform(2.0, 12.0, n)
    rows[2] = 1.0 / sig ** 2
    rows[3] = rng.uniform(-0.2, 0.2, n) / sig ** 2
    rows[4] = 1.0 / sig ** 2
    rows[5] = rng.uniform(0.004, 0.03, n)
    rows[6:9] = rng.uniform(0, 1, (3, n))
    rows[9] = np.sort(rng.uniform(1, 10, n))
    attr = torch.as_tensor(rows, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), n, dtype=torch.int32, device=dev)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    f = tile_kernels.forward_tiles(attr, start, cnt, bg, tile, tile, tile,
                                   tile, 128, need_aux=True)
    assert int(f.n_contrib.max()) > 2 * tile_kernels.BACKWARD_CHUNK
    gen = torch.Generator(device="cpu").manual_seed(3)
    d_color = torch.randn(3, tile, tile, generator=gen).to(dev)
    args = (attr, start, cnt, bg, f.n_contrib, f.color, f.final_t, d_color,
            tile, tile, tile, tile)
    tile_kernels.reset_launches()
    k = tile_kernels.backward_tiles(*args)
    k2 = tile_kernels.backward_tiles(*args)
    torch.cuda.synchronize()
    assert tile_kernels.launches["backward"] == 2
    assert torch.equal(k, k2)
    p = compositing.backward_tiles(*args)
    for r in range(9):
        scale = p[r].abs().max().item()
        assert scale > 0
        assert (k[r] - p[r]).abs().max().item() <= 1e-5 * scale, r
        assert ((k[r] - p[r]).norm() / p[r].norm()).item() <= 1e-5, r
    assert not k[:, (p == 0).all(0)].any()


@pytest.mark.parametrize("tile,n_strip", [(16, 3), (32, 2)])
def test_strip_kernels_match_plain(dev, tile, n_strip):
    """Strip mode, every strip of a frame whose last tile row is partial:
    K2 (corner cull at the strip's tile-row offset) and K1 equal to the
    bit to their plain versions, K3 within its 1e-5 row-max and L2 gates,
    and the strips' colour, depth, final T and n_contrib equal to the
    full frame's."""
    from saro_gs_torch.ops.rasterize import _clip_to_strip
    pre0, o, w, h = _pre(dev, tile, True, height=150)
    gx, gy = -(-w // tile), -(-h // tile)
    rows = -(-gy // n_strip)
    bg = torch.tensor([0.2, 0.5, 1.0], device=dev)
    bins0 = binning.bin_gaussians_staged(pre0, o, gx, gy, 1 << 20, tile,
                                         tile)
    full = tile_kernels.forward_tiles(bins0.attr, bins0.tile_start,
                                      bins0.tile_count, bg, w, h, tile, tile,
                                      128)
    gen = torch.Generator(device="cpu").manual_seed(4)
    strips = []
    for s in range(n_strip):
        row0 = s * rows
        pre = _clip_to_strip(pre0, row0, rows)
        offsets, tiles, rect, gattr, total = binning.expand_inputs(pre, o)
        exp = (offsets, tiles, rect, gattr, total, gx, rows, tile, tile,
               True, row0)
        k2 = tile_kernels.expand_instances(*exp)
        p2 = tile_kernels.expand_instances_plain(*exp)
        assert torch.equal(k2[0], p2[0]) and torch.equal(k2[1], p2[1])
        assert torch.equal(k2[2].view(torch.int32), p2[2].view(torch.int32))
        bins = binning.bin_gaussians_staged(pre, o, gx, rows, 1 << 20, tile,
                                            tile, y0_tiles=row0)
        fargs = (bins.attr, bins.tile_start, bins.tile_count, bg, w, h, tile,
                 tile)
        k1 = tile_kernels.forward_tiles(*fargs, 128, grid_y_local=rows,
                                        y0_tiles=row0)
        p1 = compositing.forward_tiles(*fargs, grid_y_local=rows,
                                       y0_px=row0 * tile)
        _assert_forward_equal(k1, p1, True)
        strips.append(k1)
        d_color = torch.randn(3, rows * tile, w, generator=gen).to(dev)
        bargs = (bins.attr, bins.tile_start, bins.tile_count, bg,
                 k1.n_contrib, k1.color, k1.final_t, d_color, w, h, tile,
                 tile)
        k3 = tile_kernels.backward_tiles(*bargs, grid_y_local=rows,
                                         y0_tiles=row0)
        p3 = compositing.backward_tiles(*bargs, grid_y_local=rows,
                                        y0_px=row0 * tile)
        if int(bins.tile_count.sum()) == 0:
            assert not k3.any() and not p3.any()
            continue
        for r in range(9):
            scale = p3[r].abs().max().item()
            assert (k3[r] - p3[r]).abs().max().item() <= 1e-5 * scale, r
            assert ((k3[r] - p3[r]).norm()
                    / p3[r].norm().clamp_min(1e-30)).item() <= 1e-5, r
        assert not k3[:, (p3 == 0).all(0)].any()
    for key in ("color", "depth", "final_t", "n_contrib"):
        dim = 1 if key == "color" else 0
        got = torch.cat([getattr(x, key) for x in strips], dim=dim)
        assert torch.equal(got.narrow(dim, 0, h), getattr(full, key)), key


# border points of tests/test_torch_grid_scatter.py's sample_mip test
_BORDER = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0], [0.999, 0.5],
           [0.5, 0.001], [0.015, 0.985], [0.5, 0.5]]


@pytest.mark.parametrize("n_pts,h,w,n_levels,c", [
    (20000, 128, 128, 7, 32), (3000, 50, 128, 0, 32), (500, 24, 40, 3, 16),
    (50, 16, 16, 4, 70), (300, 16, 16, 0, 8), (262144, 512, 512, 7, 32),
    (100000, 256, 512, 0, 32), (262144, 64, 64, 6, 32),
    (262144, 128, 64, 0, 32)])
def test_scatter_kernel_matches_plain(dev, n_pts, h, w, n_levels, c):
    """K4 (scatter_mip_taps) against its plain version on the CPU: random
    coords and levels with the border points, 0- and 7-level planes, a
    pyramid whose cell count is no power of two, strided dfeat rows: 1e-5
    of the output's largest entry, two launches equal to the bit.  The
    kernel's radix sort makes one pass for each 8 bits of the largest cell
    id: the cases cover 1 pass (16x16 with no pyramid, 256 cells), 2
    passes (128x128 with 7 levels, 21,845 cells; 50x128, 6,400; 24x40
    with 3 levels, 1,275; 16x16 with 4 levels, 341; the D-NeRF
    configurations' 64x64 plane with 6 levels, 5,461 cells, and 64x128
    time plane, 8,192, each under 262,144 rows: thousands of taps a
    coarse cell) and 3 passes, whose
    result lands in the other buffer of the ping-pong pair (the stress
    configuration's 512x512 plane with 7 levels, 349,520 cells, and its
    512x256 time plane, 131,072)."""
    rng = np.random.RandomState(0)
    coords = rng.rand(n_pts, 2).astype(np.float32)
    coords[:8] = _BORDER
    level = (rng.rand(n_pts) * (n_levels + 1) - 0.5).astype(np.float32)
    wide = rng.randn(n_pts, 2 * c).astype(np.float32)
    args = [torch.as_tensor(coords), torch.as_tensor(level),
            torch.as_tensor(wide)[:, :c]]
    cells = int(grid_scatter.level_sizes(h, w, n_levels)[1][-1])
    assert grid_scatter.radix_passes(cells) == {
        256: 1, 341: 2, 1275: 2, 5461: 2, 6400: 2, 8192: 2, 21845: 2,
        131072: 3, 349520: 3}[cells]
    tile_kernels.reset_launches()
    k = grid_scatter.scatter_mip_taps(*[x.to(dev) for x in args], h, w,
                                      n_levels)
    k2 = grid_scatter.scatter_mip_taps(
        *[x.to(dev).contiguous() for x in args], h, w, n_levels)
    torch.cuda.synchronize()
    assert tile_kernels.launches["grid_scatter"] == 2
    assert torch.equal(k, k2)
    p = grid_scatter.scatter_mip_taps_plain(*args, h, w, n_levels)
    assert k.shape == p.shape
    assert (k.cpu() - p).abs().max().item() <= 1e-5 * p.abs().max().item()


def test_scatter_kernel_hot_cell(dev):
    """Every tap on the coarsest texel of a 7-level pyramid: the segment is
    cut into pieces whose partials are summed in piece order."""
    rng = np.random.RandomState(1)
    n_pts, c = 30000, 8
    coords = torch.full((n_pts, 2), 0.3)
    level = torch.full((n_pts,), 7.0)
    dfeat = torch.as_tensor(rng.randn(n_pts, c).astype(np.float32))
    tile_kernels.reset_launches()
    k = grid_scatter.scatter_mip_taps(coords.to(dev), level.to(dev),
                                      dfeat.to(dev), 128, 128, 7)
    k2 = grid_scatter.scatter_mip_taps(coords.to(dev), level.to(dev),
                                       dfeat.to(dev), 128, 128, 7)
    torch.cuda.synchronize()
    assert tile_kernels.launches["grid_scatter"] == 2
    assert torch.equal(k, k2)
    p = grid_scatter.scatter_mip_taps_plain(coords, level, dfeat, 128, 128,
                                            7)
    k = k.cpu()
    assert (k - p).abs().max().item() <= 1e-5 * p.abs().max().item()
    assert not k[:, :-1].any()


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
    nets = gm.init_nets(mcfg, torch.Generator().manual_seed(0), "cpu")
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
                                             "grid_scatter": 6}
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


def _densify_inputs(device, cap=4096, seed=3):
    """A densify pass's inputs at ``cap`` rows, a quarter dead (zero
    quaternions, as grow_capacity leaves them), on ``device``."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    p = dict(
        xyz=rng.uniform(-1, 1, (cap, 3)) * [1, 1, 4] + [0, 0, 4.5],
        features_dc=rng.normal(0, 0.5, (cap, 1, 3)),
        features_rest=rng.normal(0, 0.1, (cap, 15, 3)),
        scaling=np.log(rng.uniform(1e-4, 0.3, (cap, 3))),
        rotation=rng.normal(0, 1, (cap, 4)),
        opacity=rng.uniform(-6, 4, (cap, 1)),
        temporal_pos=rng.uniform(0, 1, (cap, 1)))
    alive = (rng.rand(cap) > 0.25).astype(f32)
    p["rotation"][alive == 0] = 0.0
    denom = rng.randint(0, 4, (cap, 1))

    def t(x):
        return torch.as_tensor(np.asarray(x, f32), device=device)
    params = gm.GaussianParams(**{k: t(v) for k, v in p.items()})
    mu = gm.GaussianParams(*[t(rng.normal(0, 1e-3, x.shape)) for x in params])
    nu = gm.GaussianParams(*[t(rng.uniform(0, 1e-6, x.shape))
                             for x in params])
    aux = dens.DensifyAux(
        xyz_grad_accum=t(rng.uniform(0, 4e-4, (cap, 1)) * denom),
        denom=t(denom), max_radii2d=t(rng.uniform(0, 40, cap)))
    samples = [t(rng.normal(size=(cap, 3))) for _ in range(2)]
    return (params, mu, nu, t(alive), aux, samples,
            t(rng.uniform(1, 3, (cap, 1))), t(rng.uniform(0, 1, (cap, 1))))


def test_densify_and_grow_cuda_match_cpu(dev):
    """densify_pruneclone (clone, split, every prune) and grow_state on the
    card against the same calls on the CPU with the same samples: integer
    results equal, floats within 1e-6."""
    kw = dict(grad_threshold=2e-4, min_opacity=0.02, extent=2.0,
              percent_dense=0.05, max_screen_size=30, min_intergral=0.1,
              prune_z=True, prune_big_ws=True, min_scale_abs=1e-3)
    res = []
    for d in ("cpu", dev):
        params, mu, nu, alive, aux, samples, inv, integral = \
            _densify_inputs(d)
        r = dens.densify_pruneclone(params, mu, nu, alive, aux, samples,
                                    inv_integral=inv, integral=integral,
                                    **kw)
        state = step_mod.init_state(r.params, gm.init_nets(
            gm.ModelConfig(deform_hidden_dim=16, field=field_mod.FieldConfig(
                resolution=(8, 8, 8, 4), out_dim=4)),
            torch.Generator().manual_seed(0), d), r.alive)
        state = state._replace(opt=state.opt._replace(
            mu=list(r.mu) + state.opt.mu[7:],
            nu=list(r.nu) + state.opt.nu[7:]))
        grown = trainer_mod.grow_state(state)
        res.append((r, grown))
    (rc, gc), (rg, gg) = res
    for f in ("n_cloned", "n_split", "n_pruned", "overflowed"):
        assert int(getattr(rc, f)) == int(getattr(rg, f)), f
    assert int(rg.n_cloned) > 0 and int(rg.n_split) > 0
    assert int(rg.n_pruned) > 0
    assert torch.equal(rc.alive, rg.alive.cpu())

    def close(a, b):
        b = b.cpu()
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            assert torch.allclose(b, a, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b)
    for a, b in zip(list(rc.params) + list(rc.mu) + list(rc.nu),
                    list(rg.params) + list(rg.mu) + list(rg.nu)):
        close(a, b)
    for a, b in zip(step_mod.param_leaves(gc.points, gc.nets) + gc.opt.mu
                    + gc.opt.nu + list(gc.aux)
                    + [gc.alive, gc.inv_integral, gc.inv_integral_densify],
                    step_mod.param_leaves(gg.points, gg.nets) + gg.opt.mu
                    + gg.opt.nu + list(gg.aux)
                    + [gg.alive, gg.inv_integral, gg.inv_integral_densify]):
        close(a.detach(), b.detach())
    assert gg.alive.shape[0] == 2 * rg.alive.shape[0]


def test_knn_100k_points_on_the_card(dev):
    """mean_sq_dist_to_3nn over 100,000 points (the Blender init cloud's
    size) in under a second on the card, against the same distances on
    the CPU for 5,000 of them (each against all 100,000, in the same
    difference form)."""
    import time
    from saro_gs_torch.ops import knn
    pts = torch.as_tensor(np.random.RandomState(666).uniform(
        -1.3, 1.3, (100_000, 3)).astype(np.float32))
    gpu = pts.to(dev)
    knn.mean_sq_dist_to_3nn(gpu[:4096])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = knn.mean_sq_dist_to_3nn(gpu)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert secs < 1.0, secs
    rows = torch.as_tensor(np.random.RandomState(1).choice(
        100_000, 5000, replace=False))
    ref = []
    for chunk in rows.split(500):
        q = pts[chunk]
        d2 = ((q[:, None, 0] - pts[None, :, 0]) ** 2
              + (q[:, None, 1] - pts[None, :, 1]) ** 2
              + (q[:, None, 2] - pts[None, :, 2]) ** 2)
        d2[torch.arange(chunk.shape[0]), chunk] = float("inf")
        ref.append(torch.topk(d2, 3, dim=1, largest=False).values.mean(1))
    assert torch.allclose(out.cpu()[rows], torch.cat(ref), rtol=1e-6, atol=0)
