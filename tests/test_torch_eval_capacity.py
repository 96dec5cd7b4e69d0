"""The eval's instance capacity (F5) in both packages, on the CPU.

A toy model of 1,000 Gaussians (random nets, a checkpoint written once and
loaded by both packages) seen by 64x64 test cameras at 16x16 tiles:
``LIGHT`` is turned toward the cloud's edge and sees few of the Gaussians,
``HEAVY`` looks at its centre from close by and needs more than 3x
LIGHT's instances.  The ground truth of each view is the port's render of
it at ample capacity.

``Evaluator.render_set`` sizes the capacity from its first view (30%
headroom, a power of two), and ``quick_test_report`` renders at the
config's ``max_instances``.  With LIGHT first, the JAX package drops
HEAVY's instances and scores the truncated image.  The port renders such
a view again at a capacity that holds it (``Evaluator.render_view``):
its metrics and dumps are those of the ample render, and where neither
package drops, both give the same metrics.
"""
import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

from saro_gs_torch import config as tconfig
from saro_gs_torch import eval as teval
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import ply as tply
from saro_gs_torch.data.cameras import Camera as TCamera
from saro_gs_torch.data.cameras import camera_from_c2w
from saro_gs_torch.models import gaussians as tgm
from saro_gs_tpu import config as jconfig
from saro_gs_tpu import eval as jeval
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.data.cameras import Camera as JCamera
from saro_gs_tpu.models import gaussians as jgm
from tests.torch_parity import n

N_GAUSS, SIZE, FOVX = 1000, 64, math.radians(60)
# toy widths; the pure-JAX compositor walks every instance of a tile
CFG = dict(duration=10, sh_degree=1, raster_backend="jax", max_slots=1024,
           kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                           "output_coordinate_dim": 8,
                           "resolution": [16, 16, 16, 8]})
# camera position, the point it looks at, timestamp
LIGHT = ((0.0, -3.0, 0.4), (2.6, 0.0, 0.4), 0.3)
HEAVY = ((0.0, -2.2, 0.3), (0.0, 0.0, 0.0), 0.6)
# metrics of the two packages on the same renders (the render tolerance
# of tests/test_torch_trainer.py is 1e-4 a value)
RTOL = 1e-5
KEYS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS-alex")


def _c2w(pos, target):
    """Camera-to-world (OpenGL: x right, y up, z backward) at ``pos``
    looking at ``target``, z up."""
    pos, target = np.asarray(pos, float), np.asarray(target, float)
    fwd = (target - pos) / np.linalg.norm(target - pos)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
        right, np.cross(right, fwd), -fwd, pos)
    return c2w


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The checkpoint loaded by both packages, both packages' cameras of
    LIGHT and HEAVY with the ample renders as ground truth, and each
    view's instance count."""
    tmp = tmp_path_factory.mktemp("eval_capacity")
    rng = np.random.RandomState(11)
    tcfg = tconfig.load_config(model_path=str(tmp / "torch"), **CFG)
    jcfg = jconfig.load_config(model_path=str(tmp / "jax"), **CFG)
    mcfg_t, mcfg_j = tcfg.model_config(), jcfg.model_config()
    quat = rng.normal(size=(N_GAUSS, 4)).astype(np.float32)
    path = str(tmp / "ckpt" / "point_cloud.ply")
    os.makedirs(os.path.dirname(path))
    tply.save_gaussian_ply(
        path, rng.uniform(-1, 1, (N_GAUSS, 3)).astype(np.float32),
        rng.normal(0, 1, (N_GAUSS, 1, 3)).astype(np.float32),
        rng.normal(0, 0.2, (N_GAUSS, 3, 3)).astype(np.float32),
        rng.uniform(-1, 3, (N_GAUSS, 1)).astype(np.float32),
        np.log(rng.uniform(0.04, 0.12, (N_GAUSS, 3))).astype(np.float32),
        quat / np.linalg.norm(quat, axis=1, keepdims=True),
        rng.uniform(0, 1, (N_GAUSS, 1)).astype(np.float32))
    tpl = jgm.init_nets(jax.random.PRNGKey(0), mcfg_j)
    leaves = [n(x) for x in jax.tree_util.tree_leaves(tpl)]
    np.savez(path.replace(".ply", ".npz"),
             aabb_min=np.full(3, -1.5, np.float32),
             aabb_max=np.full(3, 1.5, np.float32),
             duration=np.float32(CFG["duration"]), num_leaves=len(leaves),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    jp, jnets, jalive, jfs, _ = jscene.load_gaussian_checkpoint(path, tpl)
    tp, tnets, talive, tfs, _ = tscene.load_gaussian_checkpoint(
        path, mcfg_t, device="cpu")
    tsc = types.SimpleNamespace(device=torch.device("cpu"), fstatic=tfs)
    jsc = types.SimpleNamespace(fstatic=jfs)
    ev = teval.Evaluator(tcfg, tsc, max_instances=1 << 20)
    with torch.no_grad():
        feat = tgm.field_feat(tp, tnets, mcfg_t, tfs)
    cams, need = {}, {}
    for name, (pos, target, ts) in (("light", LIGHT), ("heavy", HEAVY)):
        tc = camera_from_c2w(_c2w(pos, target), FOVX, SIZE, SIZE, ts)
        out, _ = ev.render(tc, tp, tnets, talive, feat, mcfg_t.sh_degree)
        assert out.num_dropped == 0
        need[name] = out.num_instances
        gt = str(tmp / f"{name}.png")
        teval.save_png(gt, n(torch.clamp(out.color, 0, 1)))
        args = dict(uid=0, R=tc.R, T=tc.T, fovx=tc.fovx, fovy=tc.fovy,
                    width=SIZE, height=SIZE, timestamp=ts, image_name=name,
                    image_path=gt)
        cams[name] = (JCamera(**args), TCamera(**args))
    print("instances", need)
    assert need["heavy"] >= 3 * need["light"] and need["light"] > 0
    return dict(tmp=tmp, tcfg=tcfg, jcfg=jcfg, cams=cams, need=need,
                port=(tp, tnets, talive), jax=(jp, jnets, jalive), tsc=tsc,
                jsc=jsc)


def _views(toy, *names, pkg):
    return [toy["cams"][k][pkg == "torch"] for k in names]


def _port_render_set(toy, names, monkeypatch, tag):
    """The port's render_set over the views ``names`` at model path
    ``<tmp>/torch_<tag>``: (results, per-view PSNR, the evaluator, the
    rendered images it dumped, the drops of the views it reported)."""
    cfg = toy["tcfg"]
    cfg.model_path = str(toy["tmp"] / f"torch_{tag}")
    ev = teval.Evaluator(cfg, toy["tsc"])
    dumped, reported = {}, []
    save = teval.save_png
    render_view = teval.Evaluator.render_view

    def save_png(path, img):
        if f"{os.sep}renders{os.sep}" in path:
            dumped[os.path.basename(path)] = np.array(img)
        return save(path, img)

    def checked(self, *a, **k):
        out = render_view(self, *a, **k)
        reported.append(out[0].num_dropped)
        return out
    monkeypatch.setattr(teval, "save_png", save_png)
    monkeypatch.setattr(teval.Evaluator, "render_view", checked)
    res = ev.render_set("test", _views(toy, *names, pkg="torch"),
                        *toy["port"], iteration="7")
    monkeypatch.undo()
    with open(os.path.join(cfg.model_path, "7_runtimeperview.json")) as f:
        per_view = [v for _, v in sorted(json.load(f)["PSNR"].items())]
    return res, per_view, ev, [dumped[k] for k in sorted(dumped)], reported


def _jax_render_set(toy, names, tag):
    """The JAX render_set over ``names``: (results, per-view PSNR, the
    evaluator)."""
    cfg = toy["jcfg"]
    cfg.model_path = str(toy["tmp"] / f"jax_{tag}")
    ev = jeval.Evaluator(cfg, toy["jsc"])
    res = ev.render_set("test", _views(toy, *names, pkg="jax"),
                        *toy["jax"], iteration="7")
    with open(os.path.join(cfg.model_path, "7_runtimeperview.json")) as f:
        per_view = [v for _, v in sorted(json.load(f)["PSNR"].items())]
    return res, per_view, ev


def _jax_dropped(toy, ev, name):
    """HEAVY's or LIGHT's dropped instances in the JAX package at ``ev``'s
    capacity."""
    cam = toy["cams"][name][0]
    jp, jnets, jalive = toy["jax"]
    feat = jgm.field_feat(jp, jnets, ev.mcfg, toy["jsc"].fstatic)
    render = ev._render_fn(cam.width, cam.height, ev.mcfg.sh_degree, False)
    out, _ = render(cam.raster_params(), np.float32(cam.timestamp), jp,
                    jnets, jalive, feat)
    return int(out.num_dropped)


def test_jax_render_set_drops_a_later_view(toy):
    """F5 in the JAX package: with LIGHT first, render_set sizes the
    capacity from LIGHT's instances, so HEAVY drops some at that capacity
    and its PSNR differs from HEAVY's scored alone (a capacity that holds
    it) by more than 1 dB; LIGHT itself is scored alike."""
    res, per_view, ev = _jax_render_set(toy, ("light", "heavy"), "f5")
    cap = ev.rcfg.max_instances
    assert cap == teval.capacity_for(toy["need"]["light"]) < \
        toy["need"]["heavy"]
    dropped = _jax_dropped(toy, ev, "heavy")
    assert dropped == toy["need"]["heavy"] - cap > 0
    _, alone, ev_alone = _jax_render_set(toy, ("heavy",), "f5_alone")
    assert _jax_dropped(toy, ev_alone, "heavy") == 0
    print("JAX PSNR of HEAVY: truncated", per_view[1], "whole", alone[0])
    assert abs(per_view[1] - alone[0]) > 1.0
    assert np.isfinite(res["PSNR"])


def test_port_render_set_renders_the_view_again(toy, monkeypatch):
    """The port's render_set with LIGHT first: HEAVY drops at the probe's
    capacity and is rendered again (one entry in ``rerendered``, the
    capacity raised to capacity_for HEAVY's instances); every reported
    view drops nothing; HEAVY's PSNR and dumped render equal, to the bit,
    those of HEAVY rendered alone; LIGHT's those of LIGHT alone."""
    res, per_view, ev, imgs, reported = _port_render_set(
        toy, ("light", "heavy"), monkeypatch, "f5")
    need = toy["need"]
    assert reported == [0, 0]
    probe = teval.capacity_for(need["light"])
    assert ev.rerendered == [("heavy", need["heavy"] - probe, probe,
                              teval.capacity_for(need["heavy"]))]
    assert ev.rcfg.max_instances == teval.capacity_for(need["heavy"])
    for name, i in (("heavy", 1), ("light", 0)):
        _, alone, ev_alone, img, _ = _port_render_set(
            toy, (name,), monkeypatch, f"alone_{name}")
        assert not ev_alone.rerendered
        assert per_view[i] == alone[0], name
        np.testing.assert_array_equal(imgs[i], img[0], err_msg=name)
    assert res["PSNR"] == np.mean(per_view)


def test_metrics_match_jax_when_nothing_drops(toy, monkeypatch):
    """With HEAVY first neither package drops: the means (PSNR, SSIM,
    MS-SSIM, LPIPS-alex) and the per-view PSNR within RTOL of each other;
    and the port's repaired run with LIGHT first scores each view as the
    JAX package does with HEAVY first."""
    jres, jper, jev = _jax_render_set(toy, ("heavy", "light"), "ample")
    assert _jax_dropped(toy, jev, "heavy") == 0
    assert _jax_dropped(toy, jev, "light") == 0
    tres, tper, tev, _, reported = _port_render_set(
        toy, ("heavy", "light"), monkeypatch, "ample")
    assert not tev.rerendered and reported == [0, 0]
    for k in KEYS:
        assert tres[k] == pytest.approx(jres[k], rel=RTOL), k
    np.testing.assert_allclose(tper, jper, rtol=RTOL)
    _, fixed, _, _, _ = _port_render_set(toy, ("light", "heavy"),
                                         monkeypatch, "fixed")
    np.testing.assert_allclose(fixed[::-1], jper, rtol=RTOL)


def _trainer(toy, pkg, max_instances):
    """What quick_test_report reads of a trainer: the config, the scene,
    the state, the model config, the SH degree and (the port) the
    trainer's raster config at ``max_instances``."""
    cfg = toy[f"{pkg[0]}cfg"]
    points, nets, alive = toy["port" if pkg == "torch" else "jax"]
    tr = types.SimpleNamespace(
        cfg=cfg, mcfg=cfg.model_config(), active_sh_degree=1,
        state=types.SimpleNamespace(points=points, nets=nets, alive=alive))
    if pkg == "torch":
        tr.scene, tr.device = toy["tsc"], torch.device("cpu")
        tr.rcfg = cfg.raster_config()._replace(max_instances=max_instances)
    else:
        tr.scene = toy["jsc"]
    return tr


@pytest.mark.parametrize("capacity", ["probe", "ample"])
def test_quick_test_report(toy, monkeypatch, capacity):
    """quick_test_report over LIGHT then HEAVY.  At the probe's capacity
    (the config's max_instances in the JAX package, the trainer's in the
    port): the JAX package drops HEAVY's instances and reports a PSNR
    other than the ample one; the port renders HEAVY again and reports
    the ample values to the bit.  At ample capacity both report the same
    values within RTOL, and the port renders nothing again.  The port
    starts from the trainer's capacity, not the config's."""
    need = toy["need"]
    small = teval.capacity_for(need["light"])
    cap = small if capacity == "probe" else 1 << 20
    reports, rerendered = {}, []
    init = teval.Evaluator.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        rerendered.append(self.rerendered)
    monkeypatch.setattr(teval.Evaluator, "__init__", spy)
    for pkg in ("jax", "torch"):
        cfg = toy[f"{pkg[0]}cfg"]
        # the port's config says otherwise: the trainer's capacity rules
        monkeypatch.setattr(cfg, "max_instances",
                            cap if pkg == "jax" else 1 << 8)
        reports[pkg] = (teval if pkg == "torch" else jeval) \
            .quick_test_report(_trainer(toy, pkg, cap),
                               _views(toy, "light", "heavy", pkg=pkg),
                               histograms=False)
    monkeypatch.undo()
    jrep, trep = reports["jax"], reports["torch"]
    assert len(rerendered) == 1
    if capacity == "probe":
        assert rerendered[0] == [("heavy", need["heavy"] - small, small,
                                  teval.capacity_for(need["heavy"]))]
        ample = teval.quick_test_report(
            _trainer(toy, "torch", 1 << 20),
            _views(toy, "light", "heavy", pkg="torch"), histograms=False)
        assert trep == ample
        assert abs(jrep["PSNR_per_view"][1] - ample["PSNR_per_view"][1]) \
            > 1.0
    else:
        assert rerendered[0] == []
        for k in ("PSNR", "SSIM", "MS-SSIM", "L1"):
            assert trep[k] == pytest.approx(jrep[k], rel=RTOL), k


def test_render_view_raises_at_the_last_capacity(toy, monkeypatch):
    """A view that still drops at MAX_INSTANCES slots raises, naming the
    view; the capacity never passes MAX_INSTANCES."""
    need = toy["need"]
    last = teval.capacity_for(need["light"])
    monkeypatch.setattr(teval, "MAX_INSTANCES", last)
    ev = teval.Evaluator(toy["tcfg"], toy["tsc"], max_instances=last // 4)
    points, nets, alive = toy["port"]
    with torch.no_grad():
        feat = tgm.field_feat(points, nets, ev.mcfg, toy["tsc"].fstatic)
    light, heavy = _views(toy, "light", "heavy", pkg="torch")
    out, _ = ev.render_view(light, points, nets, alive, feat, 1)
    assert out.num_dropped == 0 and ev.rcfg.max_instances == last
    with pytest.raises(RuntimeError, match="'heavy'.*dropped at"):
        ev.render_view(heavy, points, nets, alive, feat, 1)
    assert ev.rcfg.max_instances == last
