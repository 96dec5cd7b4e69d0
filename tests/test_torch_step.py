"""One train step of saro_gs_torch against saro_gs_tpu on the CPU, from
one identical toy TrainState carried across by convert.py: the dynamic
and the static stage, three consecutive steps, the non-finite guard, and
the port's run-to-run equality."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import config as tcfg
from saro_gs_torch import convert
from saro_gs_torch.data import cameras as tcams
from saro_gs_torch.train import losses as tlosses
from saro_gs_torch.train import step as tstep
from saro_gs_tpu import config as jcfg
from saro_gs_tpu.models import densify as jdens
from saro_gs_tpu.models import field as jfield
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.train import losses as jlosses
from saro_gs_tpu.train import optim as joptim
from saro_gs_tpu.train import step as jstep
from saro_gs_tpu.train.trainer import TrainState as JTrainState
from tests.torch_parity import n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARENA = os.path.join(ROOT, "checkpoints", "arena")
W = H = 48
B, N = 2, 300
TILE = 16
FIELDS = jgm.GaussianParams._fields
LAMBDAS = dict(lambda_dssim=0.2, lambda_dtstd=0.01, lambda_dscale_reg=8e-6,
               lambda_dshs_reg=1e-5, lambda_dmotion_reg=1e-5,
               lambda_dplanetv=1e-3, lambda_dtime_smooth=1e-3)


def _configs():
    over = dict(kplanes_config={"grid_dimensions": 2,
                                "input_coordinate_dim": 4,
                                "output_coordinate_dim": 8,
                                "resolution": [16, 16, 16, 8]},
                deform_hidden_dim=16, scale_reg=True, shs_reg=True,
                motion_reg=True)
    cj = jcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    ct = tcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    for k, v in over.items():
        setattr(cj, k, v)
        setattr(ct, k, v)
    return cj, ct


def _toy_state(seed=11):
    """(state dict of numpy arrays in convert.py's format, JAX TrainState,
    JAX fstatic, configs): random points, planes, heads, non-zero Adam
    moments and statistics, a dead slot, a non-trivial LR scaling."""
    cj, ct = _configs()
    mj = cj.model_config()
    rng = np.random.RandomState(seed)
    f32 = np.float32
    points = dict(
        xyz=rng.uniform(-1.2, 1.2, (N, 3)).astype(f32),
        features_dc=rng.normal(0, 0.8, (N, 1, 3)).astype(f32),
        features_rest=rng.normal(0, 0.1, (N, 15, 3)).astype(f32),
        scaling=np.log(rng.uniform(0.03, 0.15, (N, 3))).astype(f32),
        rotation=rng.normal(0, 1, (N, 4)).astype(f32),
        opacity=rng.uniform(-2.0, 4.0, (N, 1)).astype(f32),
        temporal_pos=rng.uniform(0, 1, (N, 1)).astype(f32))
    tpl = jgm.init_nets(jax.random.PRNGKey(seed), mj)
    treedef = jax.tree_util.tree_structure(tpl)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(tpl)]
    for i in range(6):
        leaves[i] = rng.normal(0, 0.3, leaves[i].shape).astype(f32)
    alive = np.ones(N, f32)
    alive[-5:] = 0.0
    d = dict(
        points=points, net_leaves=leaves,
        mu_points={k: (1e-4 * rng.normal(size=v.shape)).astype(f32)
                   for k, v in points.items()},
        nu_points={k: (1e-7 * rng.uniform(size=v.shape)).astype(f32)
                   for k, v in points.items()},
        mu_net_leaves=[(1e-4 * rng.normal(size=x.shape)).astype(f32)
                       for x in leaves],
        nu_net_leaves=[(1e-7 * rng.uniform(size=x.shape)).astype(f32)
                       for x in leaves],
        count=3, step=7, alive=alive,
        aux=dict(xyz_grad_accum=rng.uniform(0, 1, (N, 1)).astype(f32),
                 denom=rng.randint(0, 4, (N, 1)).astype(f32),
                 max_radii2d=rng.uniform(0, 9, N).astype(f32)),
        inv_integral=rng.uniform(1, 5, (N, 1)).astype(f32),
        inv_integral_densify=np.ones((N, 1), f32),
        fstatic=dict(aabb_min=np.full(3, -1.5, f32),
                     aabb_max=np.full(3, 1.5, f32), duration=f32(50.0)))

    def jnets(ls):
        return jax.tree_util.tree_unflatten(treedef,
                                            [jnp.asarray(x) for x in ls])

    def jpts(p):
        return jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in p.items()})
    jstate = JTrainState(
        points=jpts(points), nets=jnets(leaves),
        opt=joptim.AdamState(
            mu={"points": jpts(d["mu_points"]),
                "nets": jnets(d["mu_net_leaves"])},
            nu={"points": jpts(d["nu_points"]),
                "nets": jnets(d["nu_net_leaves"])},
            count=jnp.asarray(3, jnp.int32)),
        alive=jnp.asarray(alive),
        aux=jdens.DensifyAux(**{k: jnp.asarray(v)
                                for k, v in d["aux"].items()}),
        inv_integral=jnp.asarray(d["inv_integral"]),
        inv_integral_densify=jnp.asarray(d["inv_integral_densify"]),
        step=jnp.asarray(7, jnp.int32))
    jfs = jfield.FieldStatic(**{k: jnp.asarray(v)
                                for k, v in d["fstatic"].items()})
    return d, jstate, jfs, cj, ct


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    cams = [tcams.camera_from_c2w(c2w, 0.85, W, H, 0.0).raster_params("cpu")
            for c2w in tcams.ring_cameras(B)]
    stacked = [np.stack([n(c[k]) for c in cams]) for k in range(5)]
    gt = (rng.uniform(0, 1, (B, 3, H, W)) * 255).astype(np.uint8)
    ts = np.linspace(0.1, 0.9, B).astype(np.float32).reshape(-1, 1, 1)
    return stacked, gt, ts


_JAX_STEPS = {}


def _jax_step_fn(cj, jfs, stage):
    """The jitted JAX step for ``stage``, compiled once per process (the
    toy configs and fstatic are the same in every test)."""
    if stage not in _JAX_STEPS:
        _JAX_STEPS[stage] = _make_jax_step_fn(cj, jfs, stage)
    return _JAX_STEPS[stage]


def _make_jax_step_fn(cj, jfs, stage):
    st = jstep.StepStatics(
        mcfg=cj.model_config(),
        rcfg=JRasterConfig(tile_x=TILE, tile_y=TILE, chunk=64,
                           max_instances=1 << 13, max_slots=256,
                           backend="jax", tight_rect=True),
        weights=jlosses.LossWeights(**LAMBDAS), width=W, height=H,
        cfg_lrs=jstep.make_lr_statics(cj), extent=1.3, scale_floor=1e-4)

    @jax.jit
    def fn(state, cams, gt, ts):
        return jstep.train_step_core(state, cams, gt, ts, jnp.ones(3), jfs,
                                     st, stage=stage, sh_degree=3,
                                     scale_integral=True)
    return fn


def _torch_statics(ct):
    from saro_gs_torch.ops.rasterize import RasterConfig
    return tstep.StepStatics(
        mcfg=ct.model_config(),
        rcfg=RasterConfig(tile_x=TILE, tile_y=TILE, chunk=64,
                          max_instances=1 << 13, tight_rect=True),
        weights=tlosses.LossWeights(**LAMBDAS), width=W, height=H,
        cfg_lrs=tstep.make_lr_statics(ct), extent=1.3, scale_floor=1e-4)


def _torch_step(state, fstatic, st, batch, stage):
    cams, gt, ts = batch
    from saro_gs_torch.ops.projection import CameraParams
    return tstep.train_step_core(
        state, CameraParams(*[torch.as_tensor(x) for x in cams]),
        torch.as_tensor(gt), torch.as_tensor(ts), torch.ones(3), fstatic, st,
        stage=stage, sh_degree=3, scale_integral=True)


def _decode(gt_u8):
    """uint8 ground truth as the float32 both packages decode it to.  The
    port gets the uint8 and decodes on its device; the JAX step gets this,
    so one compilation serves the float ground truth of the NaN test too."""
    return gt_u8.astype(np.float32) * np.float32(1.0 / 255.0)


def _jax_state_np(js):
    """A JAX TrainState as convert.py's dict (without fstatic)."""
    def pts(p):
        return {k: np.asarray(v) for k, v in zip(FIELDS, p)}

    def nl(x):
        return [np.asarray(v) for v in jax.tree_util.tree_leaves(x)]
    return dict(points=pts(js.points), net_leaves=nl(js.nets),
                mu_points=pts(js.opt.mu["points"]),
                mu_net_leaves=nl(js.opt.mu["nets"]),
                nu_points=pts(js.opt.nu["points"]),
                nu_net_leaves=nl(js.opt.nu["nets"]),
                count=int(js.opt.count), step=int(js.step),
                dropped_hwm=int(js.dropped_hwm),
                bad_steps=int(js.bad_steps), alive=np.asarray(js.alive),
                aux={k: np.asarray(v) for k, v in js.aux._asdict().items()},
                inv_integral=np.asarray(js.inv_integral),
                inv_integral_densify=np.asarray(js.inv_integral_densify))


def _flat(d, prefix):
    """(name, array) over the points and net leaves of one part."""
    out = [(f"{prefix}.{k}", d[f"{prefix}_points" if prefix != "p"
                               else "points"][k]) for k in FIELDS]
    key = "net_leaves" if prefix == "p" else f"{prefix}_net_leaves"
    return out + [(f"{prefix}.net{i}", x) for i, x in enumerate(d[key])]


def _assert_states_close(a, b, old, tol):
    """a: the JAX state, b: the port's, old: the state before the steps.
    Adam's first moment is linear in the gradient: within ``tol`` of the
    leaf's largest entry; the second moment likewise.  The parameters move
    by about lr * sign(g), so where the gradient is significant (above
    1e-3 of the leaf's largest) the two moves agree within 2% of the
    largest move; elsewhere within one full move."""
    assert a["count"] == b["count"] and a["step"] == b["step"]
    assert a["bad_steps"] == b["bad_steps"] == 0
    for part in ("mu", "nu"):
        for (name, x), (_, y), (_, o) in zip(_flat(a, part), _flat(b, part),
                                             _flat(old, part)):
            scale = np.abs(x - o * (0.9 if part == "mu" else 0.999)).max()
            assert np.abs(x - y).max() <= tol * scale + 1e-12, name
    for (name, x), (_, y), (_, o), (_, m) in zip(
            _flat(a, "p"), _flat(b, "p"), _flat(old, "p"), _flat(a, "mu")):
        move = np.abs(x - o).max()
        sig = np.abs(m) > 1e-3 * np.abs(m).max()
        assert np.abs(x - y)[sig].max(initial=0) <= 0.02 * move + 1e-9, name
        assert np.abs(x - y).max() <= 2.0 * move + 1e-9, name
    for k in a["aux"]:
        np.testing.assert_allclose(b["aux"][k], a["aux"][k], rtol=2e-3,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(a["alive"], b["alive"])


@pytest.mark.parametrize("stage", ["dynamatic", "static"])
def test_one_step_matches_jax(stage):
    d, jstate, jfs, cj, ct = _toy_state()
    batch = _batch()
    fn = _jax_step_fn(cj, jfs, stage)
    js, jm = fn(jstate, JCameraParams(*[jnp.asarray(x) for x in batch[0]]),
                jnp.asarray(_decode(batch[1])), jnp.asarray(batch[2]))
    state, fstatic = convert.train_state_from_numpy(d, ct.model_config(),
                                                    device="cpu")
    old = convert.train_state_to_numpy(tstep.clone_state(state))
    ts_, tm = _torch_step(state, fstatic, _torch_statics(ct), batch, stage)
    assert tm["bad_step"] == 0 and int(jm["bad_step"]) == 0
    assert tm["dropped"] == 0
    for key in ("loss", "Ll1", "inv_lr_max", "psnr"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=2e-5,
                                   err_msg=key)
    for k, v in jm["gmax"].items():
        np.testing.assert_allclose(tm["gmax"][k], float(v), rtol=2e-3,
                                   atol=1e-12, err_msg=k)
    if stage == "static":
        assert tm["gmax"]["nets"] == 0 and tm["gmax"]["temporal_pos"] == 0
    _assert_states_close(_jax_state_np(js),
                         convert.train_state_to_numpy(ts_), old, 5e-4)


def test_three_steps_stay_close_and_runs_are_bit_equal():
    d, jstate, jfs, cj, ct = _toy_state()
    fn = _jax_step_fn(cj, jfs, "dynamatic")
    state, fstatic = convert.train_state_from_numpy(d, ct.model_config(),
                                                    device="cpu")
    old = convert.train_state_to_numpy(tstep.clone_state(state))
    twin = tstep.clone_state(state)
    st = _torch_statics(ct)
    for i in range(3):
        batch = _batch(seed=i)
        jstate, jm = fn(jstate,
                        JCameraParams(*[jnp.asarray(x) for x in batch[0]]),
                        jnp.asarray(_decode(batch[1])),
                        jnp.asarray(batch[2]))
        state, tm = _torch_step(state, fstatic, st, batch, "dynamatic")
        twin, tm2 = _torch_step(twin, fstatic, st, batch, "dynamatic")
        # three steps compound the first step's rounding differences
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=1e-4)
        assert tm == tm2
    a, b = (convert.train_state_to_numpy(s) for s in (state, twin))
    for part in ("p", "mu", "nu"):
        for (name, x), (_, y) in zip(_flat(a, part), _flat(b, part)):
            assert np.array_equal(x, y), name
    for k in a["aux"]:
        assert np.array_equal(a["aux"][k], b["aux"][k])
    assert state.step == 10 and state.opt.count == 6
    _assert_states_close(_jax_state_np(jstate), a, old, 5e-3)


def test_nan_in_ground_truth_skips_the_step():
    """A NaN planted in the ground truth: no parameter, moment or statistic
    changes, the step counter and bad_steps move, bad_src names the loss
    (and the groups its NaN reached), in both packages alike."""
    d, jstate, jfs, cj, ct = _toy_state()
    cams, gt, ts = _batch()
    gt = _decode(gt)
    gt[0, 1, 5, 5] = np.nan
    fn = _jax_step_fn(cj, jfs, "dynamatic")
    js, jm = fn(jstate, JCameraParams(*[jnp.asarray(x) for x in cams]),
                jnp.asarray(gt), jnp.asarray(ts))
    state, fstatic = convert.train_state_from_numpy(d, ct.model_config(),
                                                    device="cpu")
    before = convert.train_state_to_numpy(tstep.clone_state(state))
    new, tm = _torch_step(state, fstatic, _torch_statics(ct),
                          (cams, gt, ts), "dynamatic")
    assert tm["bad_step"] == 1 == int(jm["bad_step"])
    assert tm["bad_src"] == int(jm["bad_src"])
    assert "loss" in tstep.bad_src_names(tm["bad_src"])
    after = convert.train_state_to_numpy(new)
    for part in ("p", "mu", "nu"):
        for (name, x), (_, y) in zip(_flat(before, part),
                                     _flat(after, part)):
            assert np.array_equal(x, y), name
    for k in before["aux"]:
        assert np.array_equal(before["aux"][k], after["aux"][k])
    assert new.step == 8 == int(js.step)
    assert new.bad_steps == 1 == int(js.bad_steps)
    assert new.opt.count == 3 == int(js.opt.count)
