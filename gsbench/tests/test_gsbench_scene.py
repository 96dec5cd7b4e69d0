"""The inputs come from the seed: the same seed gives the same inputs to
the bit, another seed other inputs; seeds past 32 bits work."""
import torch

from gsbench.common import registry, scene
from gsbench.tests import toy


def _inputs(bench, name, seed):
    cfg = registry.config(bench, name)
    return scene.make_inputs(cfg, seed, "cpu")


def _same(a, b):
    return (all(torch.equal(a.leaves[k], b.leaves[k]) for k in a.leaves)
            and all(torch.equal(a.cams[k], b.cams[k]) for k in a.cams)
            and torch.equal(a.alive, b.alive))


def test_seed_makes_the_inputs(tmp_path, monkeypatch):
    bench = toy.use(monkeypatch, str(tmp_path))
    for name in ("n3d_flame_steak", "dnerf_standup"):
        big = 2 ** 31 + 12345
        a, b = _inputs(bench, name, big), _inputs(bench, name, big)
        c = _inputs(bench, name, big + 1)
        assert _same(a, b)
        assert not torch.equal(a.leaves["xyz"], c.leaves["xyz"])
        assert not torch.equal(a.leaves["motion_mlp.layers.0.weight"],
                               c.leaves["motion_mlp.layers.0.weight"])


def test_dead_rows_and_widths(tmp_path, monkeypatch):
    bench = toy.use(monkeypatch, str(tmp_path))
    inp = _inputs(bench, "dnerf_standup", 5)
    n = int(inp.alive.sum())
    assert n == inp.live == 200 and inp.alive.shape[0] == 256
    assert torch.all(inp.leaves["scaling"][n:] == -10.0)
    assert torch.all(inp.leaves["opacity"][n:] == -10.0)
    assert torch.all(inp.leaves["temporal_pos"][n:] == 0.5)
    assert inp.leaves["field.planes.0"].shape == (32, 16, 16)
    assert not inp.leaves["field.planes.0"].any()
    # the viewer's model has a trained model's planes, drawn from the seed
    cfg = registry.config(bench, "n3d_flame_steak")
    planes = torch.cat([v.flatten() for k, v in _inputs(
        bench, "n3d_flame_steak", 5).leaves.items()
        if k.startswith("field.planes.")])
    assert abs(float(planes.std()) / cfg["bench"]["planes"]["std"] - 1) < 0.05
    g = scene.generator(5, "cpu")
    assert scene.gt_pool(2, 8, 6, g, "cpu").dtype == torch.uint8
