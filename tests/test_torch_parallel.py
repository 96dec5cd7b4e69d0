"""saro_gs_torch's parallel path on the CPU: the runtime helpers, the
loader's shares, and ranks spawned by parallel.runtime.launch_local (gloo,
a file:// store, one intra-op thread each) running the data x tile step,
the tile-sharded render and the trainer, each held to the port's single
process and to the JAX package's mesh (the conftest's 8 CPU devices).
The gates are those of tests/test_parallel.py.  What the ranks run is in
tests/torch_ranks.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.data import cameras as tcams
from saro_gs_torch.data.dataset import BatchLoader
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.parallel import runtime
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.parallel import shard as jshard
from saro_gs_tpu.train import losses as jlosses
from saro_gs_tpu.train import step as jstep
from tests import torch_ranks as R
from tests.test_torch_step import _assert_states_close, _jax_state_np, \
    _toy_state
from tests.torch_parity import n

B = 4            # views a step: 2 a data rank on the meshes with 2
STEPS = 2
RENDER_H = 56    # a partial bottom tile under the tile-sharded render
TIMEOUT_S = 120.0
FIELDS = ("xyz", "scaling", "opacity", "temporal_pos")


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    cams = [tcams.camera_from_c2w(c2w, 0.85, R.W, R.H, 0.0)
            .raster_params("cpu") for c2w in tcams.ring_cameras(B)]
    stacked = [np.stack([n(c[k]) for c in cams]) for k in range(5)]
    gt = (rng.uniform(0, 1, (B, 3, R.H, R.W)) * 255).astype(np.uint8)
    ts = np.linspace(0.1, 0.9, B).astype(np.float32).reshape(-1, 1, 1)
    return stacked, gt, ts


def _trainer_kw(root, model, mesh_data):
    return dict(source_path=root, model_path=model, loader="blender",
                duration=8, resolution=1, batch=2, iterations=3,
                static_iteration=1, densify=0, preprocesspoints=0,
                capacity=512, max_instances=16384,
                kplanes_config={"grid_dimensions": 2,
                                "input_coordinate_dim": 4,
                                "output_coordinate_dim": 8,
                                "resolution": [16, 16, 16, 8]},
                multires=[1], sh_degree=1, dsh=True, min_intergral=1e-4,
                min_interval=0.5, data_workers=1, mesh_data=mesh_data)


def _launch(fn, world, args, tmp):
    return runtime.launch_local(fn, world, args,
                                init_method=f"file://{tmp}/store",
                                device="cpu", timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def toy():
    d, jstate, jfs, cj, ct = _toy_state()
    return dict(d=d, jstate=jstate, jfs=jfs, cj=cj, batch=_batch(),
                single=R.run_steps(d, _batch(), STEPS))


@pytest.fixture(scope="module")
def two_ranks(toy, tmp_path_factory):
    """One 2-rank group: the 2x1 and 1x2 steps, the tile-sharded render
    and 3 trainer iterations on 2 data ranks."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    root = str(tmp / "scene")
    R.write_toy_scene(root)
    cam = tcams.camera_from_c2w(tcams.ring_cameras(5)[1], 0.85, R.W,
                                RENDER_H, 0.0).raster_params("cpu")
    cam_np = [n(x) for x in cam]
    single = R.run_trainer(_trainer_kw(root, str(tmp / "m1"), 1), 3)
    outs = _launch(R.two_rank_run, 2,
                   (toy["d"], toy["batch"], STEPS, R.render_args(), cam_np,
                    RENDER_H, _trainer_kw(root, str(tmp / "m2"), 2), 3),
                   tmp)
    return dict(outs=outs, cam=cam, trainer_single=single)


def _assert_ranks_equal(states):
    """Every rank's state equal to the bit to rank 0's."""
    def flat(d):
        yield from (d["points"][k] for k in sorted(d["points"]))
        yield from d["net_leaves"]
        for part in ("mu", "nu"):
            yield from (d[f"{part}_points"][k]
                        for k in sorted(d[f"{part}_points"]))
            yield from d[f"{part}_net_leaves"]
        yield from (d["aux"][k] for k in sorted(d["aux"]))
    ref = list(flat(states[0]))
    for s in states[1:]:
        for a, b in zip(ref, flat(s)):
            assert np.array_equal(a, b)


def _assert_matches_single(single, mesh_run):
    """tests/test_parallel.py's gates: the loss within 1e-5, the points
    and a grid within 2e-5, xyz_grad_accum within 1e-3 relative."""
    (m1, s1), (mn, sn) = single, mesh_run
    for a, b in zip(m1, mn):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["Ll1"], a["Ll1"], rtol=1e-5)
        assert b["bad_step"] == 0 and b["dropped"] == 0
    for k in FIELDS:
        np.testing.assert_allclose(sn["points"][k], s1["points"][k],
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(sn["net_leaves"][0], s1["net_leaves"][0],
                               atol=2e-5)
    np.testing.assert_allclose(sn["aux"]["xyz_grad_accum"],
                               s1["aux"]["xyz_grad_accum"], rtol=1e-3,
                               atol=1e-6)
    assert sn["step"] == s1["step"] and sn["bad_steps"] == 0


def test_runtime_helpers(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert runtime.init_distributed(device="cpu") == 0
    assert runtime.group_rank() == 0 and runtime.group_size() == 1
    assert runtime.host_shard([1, 2, 3]) == [1, 2, 3]
    assert runtime.host_shard([1, 2, 3, 4], 1, 2) == [2, 4]
    assert runtime.host_shard(list(range(7)), 2, 3) == [2, 5]
    # ranks with a card each: nccl; sharing cards or on the CPU: gloo
    assert runtime.choose_backend(4, 4) == "nccl"
    assert runtime.choose_backend(2, 8) == "nccl"
    assert runtime.choose_backend(4, 1) == "gloo"
    assert runtime.choose_backend(2, 0) == "gloo"
    assert runtime.rank_device("cpu") == torch.device("cpu")
    assert runtime.make_mesh(1, 1) == runtime.Mesh(1, 1, 0, 0, None, None)
    with pytest.raises(RuntimeError, match="torchrun"):
        runtime.make_mesh(2, 1)
    batch = (CameraParams(*[torch.zeros(3, 4)] * 5),
             torch.zeros(3, 3, 8, 8), torch.zeros(3, 1, 1))
    assert runtime.make_global_batch(batch) is batch
    with pytest.raises(ValueError, match="views"):
        runtime.make_global_batch((torch.zeros(2, 3), torch.zeros(3, 3)))


def test_rank_to_mesh_map(tmp_path):
    """Rank r of a 2x2 mesh is (data r // 2, tile r % 2); a mesh that does
    not use every rank raises."""
    outs = _launch(R.mesh_place, 4, (), tmp_path)
    assert outs == [(0, 0, True, True), (0, 1, True, True),
                    (1, 0, True, True), (1, 1, True, True)]


def test_launch_local_reports_a_failed_rank(tmp_path):
    """A rank that raises stops the group: launch_local raises with its
    traceback instead of waiting out the timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        _launch(R.fail_on, 2, (1,), tmp_path)
    assert time.monotonic() - t0 < TIMEOUT_S / 2


def _cams(count, size=8):
    rng = np.random.RandomState(0)
    out = []
    for i, c2w in enumerate(tcams.ring_cameras(count)):
        cam = tcams.camera_from_c2w(c2w, 0.85, size, size, i / count)
        cam.set_image(rng.uniform(0, 1, (3, size, size)).astype(np.float32))
        out.append(cam)
    return out


def test_loader_shares():
    """Over an epoch the data ranks' shares are disjoint and cover the
    cameras; each batch's shares make up the single process's batch;
    tile peers (the same share) draw identical batches."""
    cams = _cams(12)
    loaders = [BatchLoader(cams, 4, num_workers=2, seed=3, shard=s)
               for s in ((0, 1), (0, 2), (1, 2), (1, 2))]
    try:
        epochs = [list(ld.epoch()) for ld in loaders]
    finally:
        for ld in loaders:
            ld.close()
    whole, r0, r1, peer = epochs
    assert len(whole) == len(r0) == len(r1) == 3
    seen = []
    for w, a, b, p in zip(whole, r0, r1, peer):
        assert a.gt.shape[0] == b.gt.shape[0] == 2
        assert sorted(np.concatenate([a.indices, b.indices])) \
            == sorted(w.indices)
        assert list(a.indices) == runtime.host_shard(list(w.indices), 0, 2)
        assert np.array_equal(b.indices, p.indices)
        assert np.array_equal(b.gt, p.gt)
        assert np.array_equal(b.cams.viewmat, p.cams.viewmat)
        seen += [list(a.indices), list(b.indices)]
    flat = [i for s in seen for i in s]
    assert sorted(flat) == list(range(12))
    with pytest.raises(ValueError, match="split"):
        BatchLoader(cams, 3, shard=(0, 2))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_two_rank_step_matches_single(toy, two_ranks, shape):
    runs = [out["steps"][shape] for out in two_ranks["outs"]]
    _assert_ranks_equal([s for _, s in runs])
    for m_rank in zip(*(m for m, _ in runs)):
        assert all(m["loss"] == m_rank[0]["loss"] for m in m_rank)
    _assert_matches_single(toy["single"], runs[0])


def test_four_rank_step_matches_single(toy, tmp_path):
    outs = _launch(R.step_rank, 4, ([(2, 2)], toy["d"], toy["batch"], STEPS),
                   tmp_path)
    runs = [o[(2, 2)] for o in outs]
    _assert_ranks_equal([s for _, s in runs])
    _assert_matches_single(toy["single"], runs[0])


def test_two_rank_step_matches_jax_dp_train_step(toy, two_ranks):
    """The port's 2x1 mesh against saro_gs_tpu.parallel.shard.dp_train_step
    on 2 of the conftest's CPU devices, from the same state and batch
    (tests/test_torch_step.py's tolerances after more than one step)."""
    cj, jfs = toy["cj"], toy["jfs"]
    st = jstep.StepStatics(
        mcfg=cj.model_config(),
        rcfg=JRasterConfig(tile_x=R.TILE, tile_y=R.TILE, chunk=64,
                           max_instances=1 << 13, max_slots=256,
                           backend="jax", tight_rect=True),
        weights=jlosses.LossWeights(**R.LAMBDAS), width=R.W, height=R.H,
        cfg_lrs=jstep.make_lr_statics(cj), extent=1.3, scale_floor=1e-4)
    cams, gt, ts = toy["batch"]
    args = (JCameraParams(*[jnp.asarray(x) for x in cams]),
            jnp.asarray(gt.astype(np.float32) * np.float32(1.0 / 255.0)),
            jnp.asarray(ts))

    @jax.jit
    def step(state):
        return jshard.dp_train_step(
            state, *args, jnp.ones(3), jfs, st, stage="dynamatic",
            sh_degree=3, scale_integral=True, n_data=2)
    js = toy["jstate"]
    for k in range(STEPS):
        js, jm = step(js)
        m = two_ranks["outs"][0]["steps"][(2, 1)][0][k]
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-4)
        assert int(jm["bad_step"]) == 0
    port = two_ranks["outs"][0]["steps"][(2, 1)][1]
    _assert_states_close(_jax_state_np(js), port, toy["d"], 5e-3)


def test_tile_sharded_render(two_ranks):
    """2 ranks' strips equal the single-process render to the bit, on
    every rank, and meet the JAX package's tile_sharded_render."""
    from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
    args = R.render_args()
    ref = rasterize(*(torch.as_tensor(x) for x in args[:4]),
                    two_ranks["cam"], torch.zeros(3), width=R.W,
                    height=RENDER_H, sh_degree=0,
                    config=RasterConfig(tile_x=R.TILE, tile_y=R.TILE,
                                        max_instances=1 << 13),
                    colors_precomp=torch.as_tensor(args[4]))
    for out in two_ranks["outs"]:
        assert np.array_equal(out["render"], n(ref.color))
    jcam = JCameraParams(*[jnp.asarray(n(x)) for x in two_ranks["cam"]])
    render = jax.jit(lambda *a: jshard.tile_sharded_render(
        *a, jcam, jnp.zeros(3), width=R.W, height=RENDER_H, tile_x=R.TILE,
        tile_y=R.TILE, max_instances=1 << 13, max_slots=256, n_tile=2))
    jimg = render(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(two_ranks["outs"][0]["render"], n(jimg),
                               rtol=1e-4, atol=1e-5)


def test_two_rank_trainer_matches_single(two_ranks):
    """3 iterations of Trainer.run on 2 data ranks against one process
    over the same batches (the counterpart of
    test_two_process_train_matches_single); only rank 0 writes."""
    losses1, s1, writes1 = two_ranks["trainer_single"]
    runs = [out["trainer"] for out in two_ranks["outs"]]
    assert writes1 and [w for _, _, w in runs] == [True, False]
    _assert_ranks_equal([s for _, s, _ in runs])
    losses2, s2, _ = runs[0]
    np.testing.assert_allclose(losses2, losses1, rtol=1e-5)
    for k in FIELDS:
        np.testing.assert_allclose(s2["points"][k], s1["points"][k],
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(s2["net_leaves"][0], s1["net_leaves"][0],
                               atol=2e-5)
