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
from saro_gs_torch.ops import binning, compositing, projection, tile_kernels
from saro_gs_torch.ops.rasterize import RasterConfig, rasterize

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
