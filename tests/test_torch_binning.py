"""saro_gs_torch staged binning (plain expander + stable key sort) against
the JAX package's bin_gaussians_staged with packed=False, for both of its
expanders ("sort", and "pallas" in Pallas interpret mode).  Both packages
bin the SAME preprocess output, so the tables are copies and must match
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.ops import binning as tbin
from saro_gs_torch.ops import projection as tproj
from saro_gs_torch.ops import tile_kernels
from saro_gs_tpu.ops import binning as jbin
from saro_gs_tpu.ops import projection as jproj
from tests.scene_fixtures import make_camera, make_gaussians
from tests.torch_parity import n, t

W = H = 64
TILE = 16
GX = GY = 4


def _pre(rng, tight, count=600):
    cam, _ = make_camera(W, H)
    means, scales, quats, opac, shs = make_gaussians(rng, n=count)
    opac[::4] = 0.02
    pre = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                           jnp.asarray(quats), jnp.asarray(opac), cam, W, H,
                           TILE, TILE, sh_degree=3, shs=jnp.asarray(shs),
                           tight_rect=tight)
    return pre, opac


def _to_torch(pre):
    """The JAX PreprocessOut as the port's, value for value."""
    return tproj.PreprocessOut(
        depth=t(pre.depth), radii=t(pre.radii), mean_x=t(pre.mean_x),
        mean_y=t(pre.mean_y), conic_a=t(pre.conic_a), conic_b=t(pre.conic_b),
        conic_c=t(pre.conic_c), rgb=t(pre.rgb), clamped=t(pre.clamped),
        rmin_x=t(pre.rmin_x), rmin_y=t(pre.rmin_y), rmax_x=t(pre.rmax_x),
        rmax_y=t(pre.rmax_y), tiles_touched=t(pre.tiles_touched),
        mask=t(pre.mask))


@pytest.mark.parametrize("expander", ["sort", "pallas"])
@pytest.mark.parametrize("tight,cap", [(False, 1 << 14), (True, 1 << 14),
                                       (True, 700)])
def test_staged_binning_matches_jax(rng, expander, tight, cap):
    pre, opac = _pre(rng, tight)
    a = jbin.bin_gaussians_staged(pre, jnp.asarray(opac), GX, GY, cap, 128,
                                  tile_x=TILE, tile_y=TILE,
                                  corner_cull=tight, packed=False,
                                  expander=expander)
    b = tbin.bin_gaussians_staged(_to_torch(pre), t(opac), GX, GY, cap,
                                  TILE, TILE, corner_cull=tight)
    assert b.num_instances == int(a.num_instances)
    assert b.num_dropped == int(a.num_dropped)
    assert (b.num_dropped > 0) == (cap == 700)
    np.testing.assert_array_equal(n(b.tile_start), n(a.tile_start))
    np.testing.assert_array_equal(n(b.tile_count), n(a.tile_count))
    v = int(n(b.tile_count).sum())
    assert v > 200
    np.testing.assert_array_equal(n(b.ids)[:v], n(a.ids)[:v])
    assert (n(b.ids)[v:] == -1).all() and (n(a.ids)[v:] == -1).all()
    # attribute rows 0..9 are copies: bit-identical
    np.testing.assert_array_equal(n(b.attr)[:, :v].view(np.uint32),
                                  n(a.attr)[:10, :v].view(np.uint32))


def test_plain_expander_emission_order(rng):
    """Slots follow emission order: Gaussian by Gaussian, each rect
    row-major; culled Gaussians own no slots; capacity truncates."""
    offsets = torch.tensor([0, 4, 4, 6], dtype=torch.int32)
    tiles = torch.tensor([4, 0, 2, 3], dtype=torch.int32)
    rect = torch.tensor([[0, 9, 2, 1], [0, 9, 1, 3], [2, 9, 3, 4]],
                        dtype=torch.int32)
    gattr = torch.arange(40, dtype=torch.float32).reshape(10, 4) + 1.0
    keys, gid, attr = tile_kernels.expand_instances(
        offsets, tiles, rect, gattr, 8, GX, GY, TILE, TILE, False)
    np.testing.assert_array_equal(n(gid), [0, 0, 0, 0, 2, 2, 3, 3])
    tiles_of = n(keys >> 32)
    np.testing.assert_array_equal(tiles_of, [0, 1, 4, 5, 6, 10, 13, 14])
    np.testing.assert_array_equal(n(keys & 0xFFFFFFFF),
                                  n(attr[9].view(torch.int32)))
    np.testing.assert_array_equal(n(attr[0]), [1, 1, 1, 1, 3, 3, 4, 4])


@pytest.mark.parametrize("case", ["zero_tiles", "trailing_zero_tiles",
                                  "capacity_cut", "wide_run"])
def test_search_owners_match_runs(case):
    """K2's owner rule (the last g with offsets[g] <= s, by search) against
    the plain version's repeat_interleave of run lengths: zero-tile
    Gaussians inside and at the end of the table, a capacity cut in the
    middle of a Gaussian's run, and one run of hundreds of slots."""
    r = np.random.RandomState(11)
    tiles = r.randint(0, 6, 300).astype(np.int32)
    tiles[r.rand(300) < 0.4] = 0
    if case == "trailing_zero_tiles":
        tiles[-25:] = 0
    if case == "wide_run":
        tiles[117] = 700
    tiles[0] = 0                            # a zero-tile Gaussian first
    offsets = np.cumsum(tiles) - tiles
    total = int(tiles.sum())
    n_inst = total
    if case == "capacity_cut":
        g = int(np.flatnonzero(tiles >= 3)[len(tiles) // 4])
        n_inst = int(offsets[g]) + 2        # cut inside g's run
        assert tiles[g] > n_inst - offsets[g]
    o, tl = torch.as_tensor(offsets.astype(np.int32)), torch.as_tensor(tiles)
    runs = tile_kernels.run_owners(o, tl, n_inst)
    # csrc/expand.cu:owner_of, stated plainly
    found = torch.searchsorted(o, torch.arange(n_inst, dtype=torch.int32),
                               right=True) - 1
    assert runs.shape == (n_inst,)
    np.testing.assert_array_equal(n(found), n(runs))
    assert (tiles[n(found)] > 0).all()


@pytest.mark.parametrize("case", ["zero_tiles", "trailing_zero_tiles",
                                  "capacity_cut"])
def test_plain_expander_owners_match_jax(rng, case):
    """expand_instances_plain, whose owners come from run_owners, against
    the JAX package's "sort" expander on one preprocess output with
    zero-tile Gaussians inside the table (the first among them) and at its
    end, their rects left as they were, and a capacity cut inside a
    Gaussian's run: after the stable key sort the tables, ids and tile
    ranges are equal to the bit."""
    pre, opac = _pre(rng, True)
    tiles = np.asarray(pre.tiles_touched).copy()
    zeroed = np.random.RandomState(5).rand(tiles.size) < 0.3
    zeroed[0] = True
    if case == "trailing_zero_tiles":
        zeroed[-40:] = True
    assert (tiles[zeroed] > 0).sum() > 20     # rects that no longer count
    tiles[zeroed] = 0
    pre = pre._replace(tiles_touched=jnp.asarray(tiles))
    offsets = np.cumsum(tiles) - tiles
    cap = 1 << 14
    if case == "capacity_cut":
        g = int(np.flatnonzero(tiles >= 3)[np.sum(tiles >= 3) // 2])
        cap = int(offsets[g]) + 1             # one slot of g's run kept
    a = jbin.bin_gaussians_staged(pre, jnp.asarray(opac), GX, GY, cap, 128,
                                  tile_x=TILE, tile_y=TILE, corner_cull=True,
                                  packed=False, expander="sort")
    offs, tl, rect, gattr, total = tbin.expand_inputs(_to_torch(pre),
                                                      t(opac))
    n_inst = min(total, cap)
    assert n_inst == int(a.num_instances)
    assert (total > cap) == (case == "capacity_cut")
    keys, gid, attr = tile_kernels.expand_instances_plain(
        offs, tl, rect, gattr, n_inst, GX, GY, TILE, TILE, True)
    attr_s, ids, start, count, _ = tbin.sort_instances(keys, gid, attr,
                                                       GX * GY)
    np.testing.assert_array_equal(n(start), n(a.tile_start))
    np.testing.assert_array_equal(n(count), n(a.tile_count))
    v = int(n(count).sum())
    assert v > 100
    np.testing.assert_array_equal(n(ids)[:v], n(a.ids)[:v])
    assert (tiles[n(ids)[:v]] > 0).all()
    np.testing.assert_array_equal(n(attr_s)[:, :v].view(np.uint32),
                                  n(a.attr)[:10, :v].view(np.uint32))
    if case == "capacity_cut":
        assert (n(gid) == g).sum() <= 1 and n(gid).max() <= g


def test_tile_order_heaviest_first(rng):
    """The compositors' launch order: every tile once, by tile_count
    descending, ties in tile order."""
    pre, opac = _pre(rng, True)
    b = tbin.bin_gaussians_staged(_to_torch(pre), t(opac), GX, GY, 1 << 14,
                                  TILE, TILE)
    count = n(b.tile_count)
    assert len(set(count.tolist())) < count.size    # ties to break
    assert b.tile_order.dtype == torch.int32
    np.testing.assert_array_equal(n(b.tile_order),
                                  np.argsort(-count, kind="stable"))


def test_invalid_instances_sort_last(rng):
    pre, opac = _pre(rng, True)
    p = _to_torch(pre)
    keys, gid, attr, n_inst, _ = tbin.expand(p, t(opac), GX, GY, 1 << 14,
                                             TILE, TILE)
    invalid = n(gid) < 0
    assert invalid.any() and not invalid.all()
    assert (n(keys >> 32)[invalid] == GX * GY).all()
    assert (n(attr)[:, invalid] == 0).all()
    attr_s, ids, start, count, _ = tbin.sort_instances(keys, gid, attr,
                                                       GX * GY)
    v = int(count.sum())
    assert v == int((~invalid).sum())
    assert (n(ids)[:v] >= 0).all() and (n(ids)[v:] == -1).all()
