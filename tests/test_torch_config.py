"""saro_gs_torch.config loads every config to the JAX package's fields."""
import dataclasses
import glob
import os

import pytest

from saro_gs_torch import config as tcfg
from saro_gs_tpu import config as jcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.json"),
                           recursive=True))
ARENA = os.path.join(ROOT, "checkpoints", "arena", "cfg_args.json")


def _rel(p):
    return os.path.relpath(p, ROOT)


def test_defaults_match():
    assert dataclasses.asdict(tcfg.Config()) == \
        dataclasses.asdict(jcfg.Config())


@pytest.mark.parametrize("path", CONFIGS, ids=_rel)
def test_scene_config_matches(path):
    a = jcfg.load_config(path)
    b = tcfg.load_config(path)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert tuple(b.model_config()) == tuple(a.model_config())


def test_arena_cfg_args_matches():
    a = jcfg.load_cfg_args(ARENA)
    b = tcfg.load_cfg_args(ARENA)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert b.model_config()._asdict() == a.model_config()._asdict()
    assert b.model_config().field == a.model_config().field
    rb, ra = b.raster_config(), a.raster_config()
    for f in ("tile_x", "tile_y", "chunk", "max_instances", "tight_rect",
              "need_aux"):
        assert getattr(rb, f) == getattr(ra, f), f
    assert (rb.tile_x, rb.chunk, rb.tight_rect) == (32, 128, True)


def test_jax_backend_tiling_matches():
    a = jcfg.load_config(None, raster_backend="jax", tight_rect=False)
    b = tcfg.load_config(None, raster_backend="jax", tight_rect=False)
    ra, rb = a.raster_config(), b.raster_config()
    assert (rb.tile_x, rb.tile_y, rb.chunk, rb.tight_rect) == \
        (ra.tile_x, ra.tile_y, ra.chunk, ra.tight_rect)
