"""Warm start and resume through both packages' ``cli train`` on the CPU
(``--start_checkpoint`` and ``--start_iteration``), and the full schedules
of configs/dnerf/standup.json and configs/neural_3D/flame_steak.json.

Two modes, each from one checkpoint written by one package and given to
both CLIs on the same model-path layout, with an earlier
``<N>_runtimeresults.json`` and an ``iteration_best`` checkpoint beside
it:

- mode 5 (D-NeRF): standup.json on tests/torch_dnerf_scene.py's toy
  (random init cut to 600 points, planes cut to 16^3 x 8 of 8 channels),
  the checkpoint written by the JAX package at 1,995, resumed to 2,005:
  passes at 1,998, 2,001 and 2,004 (the last two with the size
  threshold), the refresh, SH step and opacity reset at 2,000;
- mode 2 (Neural3D): flame_steak.json on tests/torch_n3d_scene.py's toy
  (tests/test_torch_neural3d.py's widths), the checkpoint written by the
  port at 4,997, resumed to 5,003: the refresh, SH step, pass and reset
  at 5,000, the base-time z prune at 5,001, and the CLI's z < 4.5 prune
  of the loaded checkpoint.

The port's densify passes take the JAX run's split draws, so every loss
after N is held (1e-5 relative), with every event of the schedule, the
capacity the checkpoint is padded to, the seeded ``best_psnr`` and the
SH degree, which restarts at 0 on a resume in both packages.

The full schedules: ``Trainer.run`` of both packages over 20,000 and
30,000 iterations under the config each CLI builds from the file, with
the step, the loader and the density moves stubbed
(tests/test_torch_dnerf.py:_stub_run), event for event.

This file runs mode 5; tests/test_torch_resume_n3d.py runs the tests that
take the ``resumed`` fixture in mode 2 (one file a mode keeps each under a
minute on the CPU).
"""
import concurrent.futures
import json
import os
import queue
import shutil

import jax
import numpy as np
import pytest
import torch

from saro_gs_torch import cli as tcli
from saro_gs_torch import config as tconfig
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import ply as tply
from saro_gs_torch.data import readers as treaders
from saro_gs_torch.models import densify as tdens
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.train import trainer as ttrainer
from saro_gs_tpu import cli as jcli
from saro_gs_tpu import config as jconfig
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.data import readers as jreaders
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.train import trainer as jtrainer
from tests import torch_dnerf_scene as dnerf
from tests import torch_n3d_scene as n3d
from tests.test_torch_dnerf import STANDUP, _stub_run
from tests.test_torch_neural3d import FLAME
from tests.test_torch_neural3d import TOY as N3D_TOY
from tests.test_torch_trainer import _small_reader
from tests.torch_parity import n

LOADER = "dnerf_toy600"
TOY_PLANES = {"grid_dimensions": 2, "input_coordinate_dim": 4,
              "output_coordinate_dim": 8, "resolution": [16, 16, 16, 8]}
# per mode: the config file, its changes, the checkpoint's iteration N and
# which package writes it
MODES = {
    "dnerf": dict(
        config=STANDUP, start=1995, writer="jax",
        over=dict(loader=LOADER, duration=dnerf.TOY["train"],
                  kplanes_config=TOY_PLANES, capacity=4096,
                  presize_instances=False, max_instances=1 << 16,
                  max_slots=4096, raster_backend="jax", static_iteration=3,
                  densification_interval=3, iterations=2005,
                  test_iteration=2005)),
    "n3d": dict(
        config=FLAME, start=4997, writer="torch",
        over=dict({k: v for k, v in N3D_TOY.items()
                   if k != "position_lr_max_steps"},
                  capacity=256, densify_from_iter=500,
                  densification_interval=100, densify_until_iter=5001,
                  opacity_reset_interval=2500, iterations=5003,
                  test_iteration=5003)),
}
# the earlier eval's PSNR the resumed runs are seeded with: above what the
# toys reach, so the eval after the resume must not replace iteration_best
SEED_PSNR = 40.0
LOSS_RTOL = 1e-5


def _write_checkpoint(mode, spec, root, cfg_path, model):
    """The initial state of ``spec["writer"]``'s Scene on ``root`` saved as
    ``model``/point_cloud/iteration_<N>/ and as iteration_best, with
    ``<N>_runtimeresults.json`` beside it; the PLY's path."""
    start = spec["start"]
    if spec["writer"] == "jax":
        sc = jscene.Scene(jconfig.load_config(
            cfg_path, source_path=root, model_path=model))
    else:
        sc = tscene.Scene(tconfig.load_config(
            cfg_path, source_path=root, model_path=model), device="cpu")
    path = sc.save(start, sc.params, sc.nets, sc.alive)
    sc.save(start, sc.params, sc.nets, sc.alive, best_ckpt=True)
    with open(os.path.join(model, f"{start}_runtimeresults.json"),
              "w") as f:
        json.dump({"iteration": start, "PSNR": SEED_PSNR}, f)
    return path


def _trainers(rec):
    """Both packages' Trainer classes recording into ``rec[pkg]``: the
    state, best PSNR and SH degree ``run`` starts from, the SH degree
    after each iteration's SH step, the refreshes (with their flag), the
    densify attempts (size flag, counts, overflow), the resets and the
    z prunes (with the live points after); every iteration logged.  The
    JAX passes put their split draws in ``rec["draws"]``, and the port's
    passes take them from there, waiting for the JAX run (in another
    thread) to make them."""
    densify = tdens.densify_pruneclone

    def start(tr, step):
        return dict(step=step, alive=n(tr.state.alive), best=tr.best_psnr,
                    sh=tr.active_sh_degree)

    def note(pkg, *event):
        if rec["recording"]:
            rec[pkg]["events"].append(event)

    class JT(jtrainer.Trainer):
        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            if rec["recording"]:
                rec["jax"]["start"] = start(self, int(self.state.step))
            return super().run(max_iterations, 1, eval_fn)

        def _density_control(self, it, stage):
            note("jax", "sh", it, self.active_sh_degree)
            super()._density_control(it, stage)

        def _integral_refresh(self, state, use):
            note("jax", "refresh", int(state.step) + 1, bool(use))
            return super()._integral_refresh(state, use)

        def _densify(self, state, key, *, with_size_threshold):
            rec["draws"].put([
                torch.tensor(n(jax.random.normal(k, state.points.xyz.shape)))
                for k in jax.random.split(key)])
            rec["jax_passes"] += 1
            st, res = super()._densify(
                state, key, with_size_threshold=with_size_threshold)
            note("jax", "densify", int(state.step), with_size_threshold,
                 int(res.n_cloned), int(res.n_split), int(res.n_pruned),
                 bool(res.overflowed))
            return st, res

        def _reset_opacity(self, state):
            note("jax", "reset", int(state.step))
            return super()._reset_opacity(state)

        def _zprune_real_xyz(self, state):
            st = super()._zprune_real_xyz(state)
            note("jax", "zprune", int(state.step),
                 int(np.asarray(st.alive).sum()))
            return st

    class TT(ttrainer.Trainer):
        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            if rec["recording"]:
                rec["torch"]["start"] = start(self, self.state.step)
            return super().run(max_iterations, 1, eval_fn)

        def _density_control(self, it, stage):
            note("torch", "sh", it, self.active_sh_degree)
            super()._density_control(it, stage)

        def _integral_refresh(self, use):
            note("torch", "refresh", self.state.step + 1, bool(use))
            return super()._integral_refresh(use)

        def _densify(self, size):
            res = super()._densify(size)
            c = self._densify_counts(res)
            note("torch", "densify", self.state.step, size, c["cloned"],
                 c["split"], c["pruned"], c["overflowed"])
            return res

        def _reset_opacity(self):
            note("torch", "reset", self.state.step)
            return super()._reset_opacity()

        def _zprune_real_xyz(self):
            super()._zprune_real_xyz()
            note("torch", "zprune", self.state.step, self.n_alive())

    def with_jax_draws(params, mu, nu, alive, aux, samples, **kw):
        while True:
            try:
                draws = rec["draws"].get(timeout=1)
                break
            except queue.Empty:
                if rec["jax_job"].done():
                    raise RuntimeError("the JAX run ended without the "
                                       "pass's draws")
        rec["port_passes"] += 1
        assert draws[0].shape == samples[0].shape
        return densify(params, mu, nu, alive, aux, draws, **kw)
    return JT, TT, with_jax_draws


def resume_both(mode, tmp_path_factory):
    """``mode``'s checkpoint, then both CLIs resumed from it, the JAX one
    in a thread beside the port's, whose passes wait for the JAX passes'
    draws (one intra-op thread for the port's plain compositors)."""
    spec = MODES[mode]
    tmp = tmp_path_factory.mktemp(f"resume_{mode}")
    if mode == "dnerf":
        dnerf.toy_scene(str(tmp / "layout"))
        roots = {k: shutil.copytree(tmp / "layout", tmp / k)
                 for k in ("ckpt", "jax", "torch")}
    else:
        n3d.toy_scene(str(tmp / "layout"))
        roots = {k: os.path.join(shutil.copytree(tmp / "layout", tmp / k),
                                 "colmap_0") for k in ("ckpt", "jax",
                                                       "torch")}
    with open(spec["config"]) as f:
        config = json.load(f)
    config.update(spec["over"])
    cfg_path = str(tmp / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jreaders.SCENE_READERS[LOADER] = _small_reader(
        jreaders.read_blender_scene, jgm.PointCloud, 600)
    treaders.SCENE_READERS[LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud, 600)
    rec = {"jax": {"events": []}, "torch": {"events": []},
           "draws": queue.Queue(), "jax_passes": 0, "port_passes": 0,
           "recording": True}
    j_cls, t_cls = jtrainer.Trainer, ttrainer.Trainer
    densify = tdens.densify_pruneclone
    JT, TT, with_jax_draws = _trainers(rec)
    try:
        ckpt_model = str(tmp / "model_ckpt")
        ply = _write_checkpoint(mode, spec, str(roots["ckpt"]), cfg_path,
                                ckpt_model)
        models = {k: str(shutil.copytree(ckpt_model, tmp / f"model_{k}"))
                  for k in ("jax", "torch")}
        rel = os.path.relpath(ply, ckpt_model)
        with open(os.path.join(ckpt_model, "point_cloud", "iteration_best",
                               "point_cloud.ply"), "rb") as f:
            best_bytes = f.read()
        jtrainer.Trainer, ttrainer.Trainer = JT, TT
        tdens.densify_pruneclone = with_jax_draws
        args = {pkg: ["-s", str(roots[pkg]), "--config", cfg_path, "-m",
                      models[pkg], "--start_checkpoint",
                      os.path.join(models[pkg], rel), "--start_iteration",
                      str(spec["start"])] for pkg in ("jax", "torch")}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            rec["jax_job"] = pool.submit(jcli.train_main, args["jax"])
            ttr = tcli.train_main(args["torch"] + ["--device", "cpu"])
            jtr = rec["jax_job"].result()
        rec["recording"] = False
    finally:
        jtrainer.Trainer, ttrainer.Trainer = j_cls, t_cls
        tdens.densify_pruneclone = densify
        torch.set_num_threads(threads)
        jreaders.SCENE_READERS.pop(LOADER, None)
        treaders.SCENE_READERS.pop(LOADER, None)
    yield dict(mode=mode, spec=spec, rec=rec, ply=ply, models=models,
               best_bytes=best_bytes, jtr=jtr, ttr=ttr)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Mode 5 (tests/test_torch_resume_n3d.py runs these tests in mode
    2)."""
    yield from resume_both("dnerf", tmp_path_factory)


def test_resumed_losses_match_jax(resumed):
    """Every iteration after N logged by both, the losses within 1e-5
    relative and the live points equal; no bad step; the eval at the end
    within 1e-5."""
    jh, th = resumed["jtr"].history, resumed["ttr"].history
    start = resumed["spec"]["start"]
    end = resumed["ttr"].cfg.iterations
    assert [h["it"] for h in jh] == [h["it"] for h in th] == list(
        range(start + 1, end + 1))
    assert not any("bad_step" in h for h in jh + th)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=LOSS_RTOL)
    assert [h["points"] for h in th] == [h["points"] for h in jh]
    reports = []
    for pkg in ("jax", "torch"):
        with open(os.path.join(resumed["models"][pkg],
                               f"{end}_runtimeresults.json")) as f:
            reports.append(json.load(f))
    for k in ("PSNR", "SSIM", "MS-SSIM", "L1"):
        assert reports[1][k] == pytest.approx(reports[0][k], rel=1e-5), k


def test_resumed_events_match_jax(resumed):
    """The same schedule events after N in both packages (the densify
    passes with their size flag, counts and overflow; the resets; the
    integral refreshes with their flag; the z prunes with the points
    left), and the schedule the mode's code states for N + 1 to the
    end."""
    rec, mode = resumed["rec"], resumed["mode"]
    events = [e for e in rec["torch"]["events"] if e[0] != "sh"]
    assert events == [e for e in rec["jax"]["events"] if e[0] != "sh"]
    assert rec["port_passes"] == rec["jax_passes"] > 0
    assert rec["draws"].empty()
    by = {}
    for e in events:
        by.setdefault(e[0], []).append(e[1:])
    print(mode, events)
    if mode == "dnerf":
        assert [(p[0], p[1]) for p in by["densify"]] == [
            (1998, False), (2001, True), (2004, True)]
        assert by["reset"] == [(2000,)]
        assert by["refresh"] == [(2000, True)]
        assert "zprune" not in by
        order = [e[0] for e in events if e[1] == 2000]
        assert order == ["refresh", "reset"]
        assert not any(p[5] for p in by["densify"])
    else:
        # the pass at 5,000 overflows the padded rows: the capacity
        # doubles and the pass runs again
        assert [(p[0], p[1], p[5]) for p in by["densify"]] == [
            (5000, True, True), (5000, True, False)]
        assert by["reset"] == [(5000,)]
        assert by["refresh"] == [(5000, True)]
        assert [z[0] for z in by["zprune"]] == [5001]
        cap = resumed["rec"]["torch"]["start"]["alive"].shape[0]
        assert resumed["ttr"].state.alive.shape[0] == 2 * cap == int(
            resumed["jtr"].state.alive.shape[0])
    for h in resumed["ttr"].densify_log:
        assert h["after"] == h["before"] + h["cloned"] + h["split"] \
            - h["pruned"], h


def test_resumed_capacity_is_padded(resumed):
    """Both trainers start from the checkpoint's N points padded to
    max(cfg.capacity, next power of two of N) rows, at step N."""
    n_points = tply.load_gaussian_ply(resumed["ply"])["xyz"].shape[0]
    cap = resumed["ttr"].cfg.capacity
    want = max(cap, 1 << (n_points - 1).bit_length())
    rec = resumed["rec"]
    for pkg in ("jax", "torch"):
        assert rec[pkg]["start"]["alive"].shape == (want,), pkg
        assert rec[pkg]["start"]["step"] == resumed["spec"]["start"]
    # one mode pads to the config's capacity, the other to the power of two
    assert (want == cap) == (resumed["mode"] == "dnerf"), (want, cap)


def test_resumed_best_psnr_is_seeded(resumed):
    """``best_psnr`` starts from the earlier <N>_runtimeresults.json in
    both packages, so the worse eval after the resume leaves
    iteration_best as it was."""
    end = resumed["ttr"].cfg.iterations
    for pkg in ("jax", "torch"):
        assert resumed["rec"][pkg]["start"]["best"] == SEED_PSNR, pkg
        tr = resumed[f"{pkg[0]}tr"]
        assert tr.best_psnr == SEED_PSNR
        model = resumed["models"][pkg]
        with open(os.path.join(model, f"{end}_runtimeresults.json")) as f:
            assert json.load(f)["PSNR"] < SEED_PSNR
        with open(os.path.join(model, "point_cloud", "iteration_best",
                               "point_cloud.ply"), "rb") as f:
            assert f.read() == resumed["best_bytes"], pkg


def test_resumed_sh_degree_restarts_at_zero(resumed):
    """The SH degree of a resumed run starts at 0 in both packages and
    steps only at the next multiple of 1,000 (the reference warm-starts
    from iteration 0 only, so the JAX package is the rule)."""
    rec = resumed["rec"]
    start, end = resumed["spec"]["start"], resumed["ttr"].cfg.iterations
    step_at = (start // 1000 + 1) * 1000
    want = [("sh", it, 0 if it < step_at else 1)
            for it in range(start + 1, end + 1)]
    for pkg in ("jax", "torch"):
        assert rec[pkg]["start"]["sh"] == 0, pkg
        assert [e for e in rec[pkg]["events"] if e[0] == "sh"] == want, pkg


def test_resumed_zprune_of_the_loaded_checkpoint(resumed):
    """The CLI's z < 4.5 prune (densify modes 1, 2, 4) applied to the
    loaded checkpoint: the same alive mask in both packages; in mode 2
    the checkpoint's rows below z 4.5 dead (some of them), in mode 5 every
    row of the checkpoint alive."""
    rec = resumed["rec"]
    ja, ta = rec["jax"]["start"]["alive"], rec["torch"]["start"]["alive"]
    np.testing.assert_array_equal(ja, ta)
    xyz = tply.load_gaussian_ply(resumed["ply"])["xyz"]
    loaded = np.arange(ta.shape[0]) < xyz.shape[0]
    if resumed["mode"] == "n3d":
        low = np.zeros_like(loaded)
        low[:xyz.shape[0]] = xyz[:, 2] < 4.5
        np.testing.assert_array_equal(ta > 0, loaded & ~low)
        assert low.sum() >= 3
    else:
        np.testing.assert_array_equal(ta > 0, loaded)


class Built(Exception):
    """Raised by the stand-in Scene once the CLI has built its config."""


def _cli_config(pkg, path, tmp, monkeypatch):
    """The config ``pkg``'s ``cli train`` builds from the file at ``path``
    (testing_iterations included), caught where it makes its Scene."""
    def scene(cfg, *a, **k):
        raise Built(cfg)
    monkeypatch.setattr(jscene if pkg == "jax" else tscene, "Scene", scene)
    main = jcli.train_main if pkg == "jax" else tcli.train_main
    with pytest.raises(Built) as got:
        main(["-s", str(tmp / "none"), "--config", path, "-m",
              str(tmp / f"model_{pkg}")]
             + (["--device", "cpu"] if pkg == "torch" else []))
    monkeypatch.undo()
    return got.value.args[0]


@pytest.mark.parametrize("path", [STANDUP, FLAME])
def test_cli_testing_iterations_match_jax(path, tmp_path, monkeypatch):
    """The test iterations both CLIs build from the file
    ([test_iteration] + every 500th iteration from densify_until_iter up
    to the last): standup.json's test_iteration 20,001 lies past its
    20,000 iterations, so its evals are 15,000 to 19,500 only;
    flame_steak.json's are 20,001 and 5,000 to 29,500."""
    got = [_cli_config(pkg, path, tmp_path, monkeypatch).testing_iterations
           for pkg in ("jax", "torch")]
    assert got[0] == got[1]
    if path == STANDUP:
        assert got[1] == [20001] + list(range(15000, 20000, 500))
    else:
        assert got[1] == [20001] + list(range(5000, 30000, 500))


def test_full_schedule_matches_jax(resumed, tmp_path, monkeypatch):
    """``Trainer.run`` of both packages over the whole of standup.json
    (20,000 iterations, mode 5) or flame_steak.json (30,000, mode 2)
    under the config each CLI builds from the file, with the step, the
    loader and the density moves stubbed: the same record, event for
    event, and the record is the schedule the trainers' code states."""
    mode = resumed["mode"]
    path = MODES[mode]["config"]
    recs = {}
    for pkg in ("jax", "torch"):
        tr = resumed[f"{pkg[0]}tr"]
        cfg = _cli_config(pkg, path, tmp_path, monkeypatch)
        recs[pkg] = []
        saved = tr.state, tr.active_sh_degree, tr.rcfg, tr.history
        try:
            tr.state = tr.state._replace(
                step=0 if pkg == "torch" else jax.numpy.zeros((), "int32"))
            tr.history = []
            _stub_run(tr, recs[pkg], monkeypatch, pkg == "jax", cfg)
        finally:
            tr.state, tr.active_sh_degree, tr.rcfg, tr.history = saved
            monkeypatch.undo()
    assert recs["jax"] == recs["torch"]
    _check_full_schedule(mode, recs["torch"], cfg)


def _check_full_schedule(mode, rec, cfg):
    """The record of a stubbed run of the whole file against the schedule
    of saro_gs_tpu/train/trainer.py:run and _density_control."""
    end = cfg.iterations
    steps = [r for r in rec if r[0] == "step"]
    assert [r[1] for r in steps] == list(range(1, end + 1))
    # the SH degree a step renders with lags its update by one iteration:
    # 3 from the step after 3,000
    for _, it, stage, scale, deg in steps:
        assert stage == ("static" if it <= cfg.static_iteration
                         else "dynamatic"), it
        assert scale == (it <= cfg.densify_until_iter), it
        assert deg == min((it - 1) // 1000, 3), it
    passes = [r[1:] for r in rec if r[0] == "densify"]
    resets = [r[1] for r in rec if r[0] == "reset"]
    zprunes = [r[1] for r in rec if r[0] == "zprune"]
    refreshes = [r[1:] for r in rec if r[0] == "refresh"]
    tests = [r[1:] for r in rec if r[0] == "test"]
    assert not [r for r in rec if r[0] in ("save", "grow")]
    if mode == "dnerf":
        # resets every 2,000 up to 14,000; the last pass at 14,900;
        # nothing after 15,000; evals at 15,000 to 19,500 only
        assert [p[0] for p in passes] == list(range(600, 15000, 100))
        assert [p[1] for p in passes] == [p[0] > 2000 for p in passes]
        assert resets == list(range(2000, 15000, 2000))
        assert zprunes == []
        assert refreshes == [(it, it <= 15000)
                             for it in range(1050, 20001, 50)]
        assert tests == [(it, 3) for it in range(15000, 20000, 500)]
    else:
        # one reset at 3,000; passes until 4,900; the base-time z prune
        # at every it % 500 == 1 from 5,001
        assert [p[0] for p in passes] == list(range(600, 5000, 100))
        assert [p[1] for p in passes] == [p[0] > 3000 for p in passes]
        assert resets == [3000]
        assert zprunes == list(range(5001, 30000, 500))
        assert refreshes == [(it, True) for it in range(50, 30001, 50)]
        assert tests == [(it, 3) for it in sorted(
            [20001] + list(range(5000, 30000, 500)))]
    # the SH degree a pass sees: 1 from 1,000, 2 from 2,000, 3 from 3,000
    for p in passes:
        assert p[2] == min(p[0] // 1000, 3), p
