"""The port's bench (saro_gs_torch/bench.py) against bench.py and
__graft_entry__.py on the CPU: the synthetic state, the scale and
ground-truth draws, the camera, a render at the bench's raster settings
and one bench train step, each from the JAX package's state carried
across by convert.py; then the port's bench end to end, its refusals and
its device default.

The JAX renders run the pure-JAX compositor (backend "jax"), which walks at
most ``max_slots`` instances a tile (saro_gs_tpu/ops/compositing.py:124;
bench.py sets 512 and 128 there).  The port's compositor has no such cap,
so the JAX side gets ``max_slots`` above the densest tile, counted by the
port's binning without the corner cull (the pure-JAX binning has none);
nothing else of bench.py's settings changes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _camera, _synthetic_state
from saro_gs_torch import bench, convert, render
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.ops import binning, projection
from saro_gs_torch.train import step as tstep
from saro_gs_tpu.models import densify as jdens
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.render import test_render as jtest_render
from saro_gs_tpu.train import losses as jlosses
from saro_gs_tpu.train import optim as joptim
from saro_gs_tpu.train import step as jstep
from saro_gs_tpu.train.trainer import TrainState as JTrainState
from tests.test_torch_step import _assert_states_close, _jax_state_np
from tests.test_torch_stress import _near_relu_kink
from tests.test_torch_synth import _script_module
from tests.torch_parity import n

# the CPU protocol's sizes (bench.py:101-103,131-132,231-233)
W, H, N = 338, 254, 5_000
TW, TH, TN, TB = 96, 64, 500, 2
PROBE_TS = (0.01, 0.5, 0.99)


def _jax_bench_scene(n_pts):
    """bench.py's scene on the JAX side (bench.py:131-136,239-244): the
    state and the RandomState(0) left after the scale draw."""
    cfg, params, nets, alive, fstatic = _synthetic_state(
        n=n_pts, capacity=n_pts, seed=3)
    rng = np.random.RandomState(0)
    params = params._replace(scaling=jnp.asarray(
        np.log(rng.uniform(0.003, 0.02, (n_pts, 3))), jnp.float32))
    return cfg, params, nets, alive, fstatic, rng


def _mcfg():
    """The port's ModelConfig of the synthetic state."""
    return bench.synthetic_state(4, 4, device="cpu")[0]


def _carried(jscene, alive=None):
    """The JAX scene in the port's terms, by convert.py: (mcfg, params,
    nets, alive, fstatic, rng); ``alive`` replaces the JAX alive."""
    cfg, params, nets, jalive, fstatic, rng = jscene
    mcfg = _mcfg()
    tp, tn, tfs = convert.jax_to_torch(
        {k: np.asarray(v) for k, v in params._asdict().items()},
        [np.asarray(x) for x in jax.tree_util.tree_leaves(nets)],
        {k: np.asarray(v) for k, v in fstatic._asdict().items()}, mcfg,
        device="cpu")
    a = np.asarray(jalive if alive is None else alive, np.float32)
    return mcfg, tp, tn, torch.tensor(a), tfs, rng


def _densest_tile(d, active, cam, width, height):
    """The most instances any 32x32 tile holds, by the port's binning
    without the corner cull: the pure-JAX path walks every tile of a rect
    (saro_gs_tpu/ops/binning.py:bin_gaussians)."""
    pre = projection.preprocess(
        d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam, width,
        height, 32, 32, sh_degree=3, shs=d.shs, active=active,
        tight_rect=True)
    bins = binning.bin_gaussians_staged(
        pre, d.opacity.reshape(-1), -(-width // 32), -(-height // 32),
        1 << 22, 32, 32, corner_cull=False)
    return int(bins.tile_count.max())


def _near_alpha_cutoff(d, active, cam, width, height, rel=1e-4):
    """Gaussians whose alpha at a pixel of the frame lies within ``rel`` of
    the 1/255 cutoff.  Two float32 implementations round such an alpha to
    either side of the cutoff, and the pixel then gains or loses that
    Gaussian's whole contribution (about 1/255 of its colour): the
    comparison is undefined there, not wrong (as at a ReLU kink,
    tests/test_torch_stress.py:_near_relu_kink)."""
    pre = projection.preprocess(
        d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam, width,
        height, 32, 32, sh_degree=3, shs=d.shs, active=active,
        tight_rect=True)
    idx = torch.nonzero(pre.mask).squeeze(1)
    r = int(pre.radii[idx].max()) + 1
    off = torch.arange(-r, r + 1, dtype=torch.float32)
    mx, my = pre.mean_x[idx], pre.mean_y[idx]
    px = torch.round(mx)[:, None, None] + off[None, None, :]
    py = torch.round(my)[:, None, None] + off[None, :, None]
    dx, dy = mx[:, None, None] - px, my[:, None, None] - py
    a, b, c = (x[idx, None, None] for x in (pre.conic_a, pre.conic_b,
                                            pre.conic_c))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = d.opacity.reshape(-1)[idx, None, None] \
        * torch.exp(torch.clamp_max(power, 0.0))
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    near = (inside & ((alpha - 1.0 / 255.0).abs() <= rel / 255.0)) \
        .any(2).any(1)
    out = torch.zeros(d.xyz.shape[0], dtype=torch.bool)
    out[idx[near]] = True
    return out


# ---- the state, the draws, the camera --------------------------------------

def test_synthetic_state_matches_graft_entry():
    """synthetic_state(500, 500, seed=3) against _synthetic_state: the
    configs equal; xyz, DC, rest, rotation, opacity and alive to the bit;
    scaling (the knn's) within 1e-6; fstatic equal; the torch draws in
    range and the nets shaped as convert.py maps them."""
    cfg, jp, jn, ja, jfs = _synthetic_state(n=500, capacity=500, seed=3)
    mcfg, tp, tn, ta, tfs = bench.synthetic_state(500, 500, seed=3,
                                                  device="cpu")
    mine, theirs = mcfg._asdict(), cfg._asdict()
    assert tuple(mine.pop("field")) == tuple(theirs.pop("field"))
    assert mine == theirs
    for k in ("xyz", "features_dc", "features_rest", "rotation",
              "opacity"):
        x, y = np.asarray(getattr(jp, k)), n(getattr(tp, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert np.array_equal(np.asarray(ja), n(ta))
    np.testing.assert_allclose(n(tp.scaling), np.asarray(jp.scaling),
                               rtol=0, atol=1e-6)
    for k in ("aabb_min", "aabb_max", "duration"):
        assert np.array_equal(np.asarray(getattr(jfs, k)),
                              n(getattr(tfs, k))), k
    tpos = n(tp.temporal_pos)
    assert tpos.shape == (500, 1) and (tpos >= 0).all() and (tpos < 1).all()
    assert not np.array_equal(tpos, np.asarray(jp.temporal_pos))
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jn)]
    tl = convert.net_leaves_to_jax(tn)
    assert [x.shape for x in tl] == [x.shape for x in jl]
    assert jl[0].shape == (16, 32, 32)          # 16 channels, 32x32 planes
    assert all(not x.any() for x in tl[:6])     # zero planes, as in JAX
    # the same generator seed draws the same nets
    again = bench.synthetic_state(500, 500, seed=3, device="cpu")[2]
    assert all(torch.equal(x, y) for x, y in zip(tn.leaves(),
                                                 again.leaves()))


def test_bench_scene_and_ground_truth_draws_match_bench_py():
    """bench_scene's scale override and the train bench's ground truth
    come from RandomState(0) in bench.py's order (bench.py:241-244, then
    :273-274), to the bit; the ring views are the script's
    (scripts/make_synth_scene.py) and the timestamps bench.py's."""
    scene = bench.bench_scene(TN, device="cpu")
    rng = np.random.RandomState(0)
    scaling = jnp.asarray(np.log(rng.uniform(0.003, 0.02, (TN, 3))),
                          jnp.float32)
    assert np.array_equal(n(scene[1].scaling), np.asarray(scaling))
    tin = bench.train_inputs(scene, TW, TH, TB, 1 << 14, "cpu")
    gt = jnp.asarray(rng.uniform(0.0, 1.0, (TB, 3, TH, TW)), jnp.float32)
    assert tin.gt.dtype == torch.float32
    assert np.array_equal(n(tin.gt), np.asarray(gt))
    ts = jnp.linspace(0.1, 0.9, TB).reshape(-1, 1, 1)
    assert np.array_equal(n(tin.timestamps), np.asarray(ts))
    script = _script_module()
    for i, c2w in enumerate(script.ring_cameras(TB)):
        theirs = script.camera_from_c2w(c2w, 0.85, TW, TH, 0.0) \
            .raster_params()
        for k, x in enumerate(theirs):
            assert np.array_equal(n(tin.cams[k][i]),
                                  np.asarray(x, np.float32)), (i, k)
    assert not tin.bg.any() and tin.st.extent == 1.0
    assert tin.st.cfg_lrs == bench.CFG_LRS
    assert tuple(tin.st.weights) == tuple(jlosses.LossWeights(
        lambda_dssim=0.2))


@pytest.mark.parametrize("size", [(338, 254), (1352, 1014)])
def test_bench_camera_matches_graft_entry(size):
    theirs = _camera(*size)
    mine = bench.bench_camera(*size, device="cpu")
    for k, (x, y) in enumerate(zip(theirs, mine)):
        assert np.array_equal(np.asarray(x), n(y)), k


# ---- a render at the bench's settings ---------------------------------------

@pytest.fixture(scope="module")
def render_case():
    """The CPU bench's scene (5,000 points, 338x254) on both sides, the
    JAX test_render compiled once (alive an argument), and per probe ts
    the port's deformed points; the JAX max_slots covers the densest tile
    of the three frames."""
    jscene = _jax_bench_scene(N)
    cfg, params, nets, alive, fstatic, _ = jscene
    mcfg, tp, tn, ta, tfs, _ = _carried(jscene)
    tcam = bench.bench_camera(W, H, "cpu")
    with torch.no_grad():
        feat = tgm.field_feat(tp, tn, mcfg, tfs)
        frames = {}
        for ts in PROBE_TS:
            d = tgm.deform(tp, tn, mcfg, tfs, ts, feat=feat)
            frames[ts] = (d, ta * (d.state[:, 0] > render.EVAL_STATE_CUTOFF))
    densest = max(_densest_tile(d, act, tcam, W, H)
                  for d, act in frames.values())
    rcfg = bench.raster_config()
    jrcfg = JRasterConfig(tile_x=rcfg.tile_x, tile_y=rcfg.tile_y,
                          chunk=rcfg.chunk, max_instances=rcfg.max_instances,
                          backend="jax", max_slots=-(-densest // 128) * 128)
    jcam = _camera(W, H)
    jfeat = jgm.field_feat(params, nets, cfg, fstatic)

    @jax.jit
    def jrender(ts, alive):
        out, _ = jtest_render(jcam, ts, params, nets, alive, cfg, fstatic,
                              jnp.zeros(3), width=W, height=H, sh_degree=3,
                              rcfg=jrcfg, feat=jfeat)
        return out.color, out.num_instances, out.num_dropped

    def trender(ts, alive):
        return render.test_render(tcam, ts, tp, tn, alive, mcfg, tfs,
                                  torch.zeros(3), width=W, height=H,
                                  sh_degree=3, rcfg=rcfg, feat=feat)[0]
    return dict(alive=np.asarray(alive), talive=ta, jrender=jrender,
                trender=trender, frames=frames, tcam=tcam)


def test_probe_counts_and_capacity_match_jax(render_case):
    """The instances at bench.py's probe timestamps equal the JAX
    package's, so probe_capacity gives bench.py's capacity
    (bench.py:168-175); nothing is dropped at the starting 589,824."""
    c = render_case
    counts = []
    for ts in PROBE_TS:
        _, ni, nd = c["jrender"](jnp.float32(ts), jnp.asarray(c["alive"]))
        out = c["trender"](ts, c["talive"])
        assert out.num_instances == int(ni) > 0, ts
        assert out.num_dropped == int(nd) == 0, ts
        counts.append(int(ni))
    theirs = max(-(-int(max(counts) * 1.15) // 65536) * 65536, 65536)
    assert bench.probe_capacity(
        lambda ts: c["trender"](ts, c["talive"])) == theirs


@pytest.mark.parametrize("ts", PROBE_TS)
def test_render_matches_jax_at_bench_settings(render_case, ts):
    """test_render at the bench's raster settings (tile 32, chunk 128,
    black) against JAX test_render (backend "jax"): colour within
    test_torch_compositing.py::test_render_matches_jax's gate (rtol 1e-4,
    atol 1e-5), the few Gaussians at the alpha cutoff dead in both."""
    c = render_case
    d, active = c["frames"][ts]
    with torch.no_grad():
        near = _near_alpha_cutoff(d, active, c["tcam"], W, H)
    assert int(near.sum()) <= N // 100
    alive = c["talive"].clone()
    alive[near] = 0.0
    color, ni, nd = c["jrender"](jnp.float32(ts), jnp.asarray(n(alive)))
    out = c["trender"](ts, alive)
    assert out.num_instances == int(ni) and out.num_dropped == int(nd) == 0
    np.testing.assert_allclose(n(out.color), np.asarray(color), rtol=1e-4,
                               atol=1e-5)


# ---- one bench train step ---------------------------------------------------

def test_bench_train_step_matches_jax():
    """One bench train step (96x64, 500 points, batch 2: the CPU protocol)
    from the JAX state carried across against JAX's train_step_core with
    bench.py's statics (bench.py:245-289; backend "jax" with max_slots
    above the densest tile): loss within 1e-5; Ll1, PSNR and the LR
    scaling within test_torch_step.py's rtol 2e-5, each group's largest
    gradient within its 2e-3, the states within its 5e-4 gates.  The
    points at a ReLU kink are dead in both."""
    jscene = _jax_bench_scene(TN)
    cfg, params, nets, alive, fstatic, rng = jscene
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(nets)]
    pts = {k: np.asarray(v) for k, v in params._asdict().items()}
    f32 = np.float32
    d = dict(points=pts, net_leaves=leaves,
             mu_points={k: np.zeros_like(v) for k, v in pts.items()},
             nu_points={k: np.zeros_like(v) for k, v in pts.items()},
             mu_net_leaves=[np.zeros_like(x) for x in leaves],
             nu_net_leaves=[np.zeros_like(x) for x in leaves],
             count=0, step=0, alive=np.array(alive, f32),
             aux=dict(xyz_grad_accum=np.zeros((TN, 1), f32),
                      denom=np.zeros((TN, 1), f32),
                      max_radii2d=np.zeros(TN, f32)),
             inv_integral=np.ones((TN, 1), f32),
             inv_integral_densify=np.ones((TN, 1), f32),
             fstatic={k: np.asarray(v)
                      for k, v in fstatic._asdict().items()})
    mcfg = _mcfg()
    ts = np.linspace(0.1, 0.9, TB).astype(f32)
    near = _near_relu_kink(d, mcfg, ts)
    assert near.sum() <= TN // 5        # as test_torch_stress.py allows
    d["alive"][near] = 0.0
    tin = bench.train_inputs(_carried(jscene, d["alive"]), TW, TH, TB,
                             1 << 14, "cpu")
    with torch.no_grad():
        feat = tgm.field_feat(tin.state.points, tin.state.nets, mcfg,
                              tin.fstatic)
        densest = 0
        for i in range(TB):
            dd = tgm.deform(tin.state.points, tin.state.nets, mcfg,
                            tin.fstatic, float(ts[i]), feat=feat)
            cam = projection.CameraParams(*[x[i] for x in tin.cams])
            densest = max(densest, _densest_tile(dd, tin.state.alive, cam,
                                                 TW, TH))

    jalive = jnp.asarray(d["alive"])
    jstate = JTrainState(
        points=params, nets=nets,
        opt=joptim.init_adam({"points": params, "nets": nets}),
        alive=jalive, aux=jdens.init_aux(TN),
        inv_integral=jnp.ones((TN, 1)),
        inv_integral_densify=jnp.ones((TN, 1)),
        step=jnp.zeros((), jnp.int32))
    jst = jstep.StepStatics(
        mcfg=cfg,
        rcfg=JRasterConfig(tile_x=32, tile_y=32, chunk=128,
                           max_instances=1 << 14, backend="jax",
                           max_slots=-(-densest // 128) * 128),
        weights=jlosses.LossWeights(lambda_dssim=0.2), width=TW, height=TH,
        cfg_lrs=bench.CFG_LRS, extent=1.0)
    js, jm = jax.jit(lambda s, c, g, t: jstep.train_step_core(
        s, c, g, t, jnp.zeros(3), fstatic, jst, stage="dynamatic",
        sh_degree=3, scale_integral=True))(
        jstate, JCameraParams(*[jnp.asarray(n(x)) for x in tin.cams]),
        jnp.asarray(n(tin.gt)), jnp.asarray(n(tin.timestamps)))

    old = convert.train_state_to_numpy(tstep.clone_state(tin.state))
    state, tm = bench.train_step(tin, tin.state)
    assert tm["bad_step"] == 0 and int(jm["bad_step"]) == 0
    assert tm["dropped"] == 0 and int(jm["dropped"]) == 0
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-5)
    for key in ("Ll1", "inv_lr_max", "psnr"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=2e-5,
                                   err_msg=key)
    for k, v in jm["gmax"].items():
        np.testing.assert_allclose(tm["gmax"][k], float(v), rtol=2e-3,
                                   atol=1e-12, err_msg=k)
    _assert_states_close(_jax_state_np(js),
                         convert.train_state_to_numpy(state), old, 5e-4)


# ---- the bench end to end ---------------------------------------------------

def test_main_on_cpu_prints_bench_py_records(capsys, monkeypatch):
    """main(["--device", "cpu"]) with the CPU protocol cut to fewer frames
    and steps (through ``bench.CPU``): bench.py's records in its order (no
    checkpoint record on the CPU), the headline last with the train metric
    embedded, vs_baseline null, card "cpu", nothing dropped, no kernel
    launched (the plain versions)."""
    monkeypatch.setattr(bench, "CPU", bench.CPU._replace(frames=3, warmup=1,
                                                         steps=1))
    assert bench.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    names = [r["metric"] for r in lines]
    assert names == ["render_fps_338x254", "train_steps_per_s_b2_96x64",
                     "render_fps_338x254"]
    head, train, last = lines
    assert last["train_steps_per_s"] == train["value"] > 0
    assert train["render_fps"] == head["value"] == last["value"] > 0
    assert "ckpt_fps" not in last
    for r in lines:
        assert r["vs_baseline"] is None and r["card"] == "cpu"
        assert r["dropped"] == 0
        assert set(r["launches"]) == {"expand", "forward", "backward",
                                      "grid_scatter", "ssim"}
        assert not any(r["launches"].values())
    assert head["frames"] == 3 and head["warmup"] == 1
    assert head["passes"] == 1 and train["steps"] == 1
    assert head["scene"] == "synthetic (5000 pts)"
    assert head["max_instances"] == 65536
    assert bench.bench_fps(use_ckpt=True, device="cpu") is None


def test_dropped_instances_fail_the_bench(capsys, monkeypatch):
    """With a capacity below the frames' instances the bench raises and
    prints no FPS, from bench_fps and from main."""
    monkeypatch.setattr(bench, "probe_capacity", lambda render: 1024)
    with pytest.raises(bench.BenchError, match="instances dropped"):
        bench.bench_fps(device="cpu", frames=2, warmup=1)
    monkeypatch.setattr(bench, "CPU", bench.CPU._replace(frames=2, warmup=1))
    with pytest.raises(bench.BenchError, match="instances dropped"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_default_device_needs_a_card(monkeypatch):
    """Without a card the default device raises, as every entry point of
    the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bench.bench_fps, bench.bench_train,
               lambda: bench.main([])):
        with pytest.raises(RuntimeError, match="is_available"):
            fn()


def test_checkpoint_lookup_and_load(monkeypatch, tmp_path):
    """find_checkpoint: SARO_BENCH_CKPT when it exists (None when not),
    else the tracked arena checkpoint, which bench_fps loads at its exact
    count."""
    monkeypatch.setenv("SARO_BENCH_CKPT", str(tmp_path / "none.ply"))
    assert bench.find_checkpoint() is None
    monkeypatch.delenv("SARO_BENCH_CKPT")
    path = bench.find_checkpoint()
    assert path == f"{bench.ROOT}/checkpoints/arena/point_cloud/" \
        "iteration_best/point_cloud.ply"
    monkeypatch.setenv("SARO_BENCH_CKPT", path)
    assert bench.find_checkpoint() == path
    from saro_gs_torch import config as tcfg
    cfg = tcfg.load_cfg_args(f"{bench.ROOT}/checkpoints/arena/"
                             "cfg_args.json")
    from saro_gs_torch.scene import load_gaussian_checkpoint
    params, nets, alive, fstatic, npts = load_gaussian_checkpoint(
        path, cfg.model_config(), "cpu", capacity=None)
    assert npts == params.xyz.shape[0] == alive.shape[0] == int(alive.sum())


def test_bench_module_imports_none_of_the_reference():
    """saro_gs_torch/bench.py imports no JAX, nothing of saro_gs_tpu, and
    neither bench.py, __graft_entry__.py nor a scripts/ module: the port
    keeps its own copy of what it needs from them."""
    import re
    with open(bench.__file__) as f:
        src = f.read()
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|saro_gs_tpu|bench|"
                     r"__graft_entry__|scripts|make_synth_scene)\b", re.M)
    assert not pat.search(src)
    assert "sys.path" not in src
