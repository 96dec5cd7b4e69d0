"""saro_gs_torch stands alone: it imports neither jax nor saro_gs_tpu, and
its entry points refuse to run on CUDA without a card."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "saro_gs_torch")


def _modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or\n"
            "             k.startswith(('jax.', 'jaxlib', 'saro_gs_tpu')))\n"
            "print(len(sys.modules))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|saro_gs_tpu)\b",
                     re.M)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f
    # chip_smoke.py and the one tests module it imports
    for f in ("chip_smoke.py", os.path.join("tests", "torch_parity.py")):
        with open(os.path.join(ROOT, f)) as fh:
            assert not pat.search(fh.read()), f


def test_tf32_disabled():
    import saro_gs_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_cuda(monkeypatch):
    from saro_gs_torch import resolve_device
    from saro_gs_torch.data import cameras
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    cam = cameras.camera_from_c2w(cameras.ring_cameras(3)[0], 0.85, 32, 32,
                                  0.0)
    with pytest.raises(RuntimeError):
        cam.raster_params()
    assert cam.raster_params(device="cpu").viewmat.device.type == "cpu"


def test_rasterize_refuses_gradients():
    """A render without n_contrib (need_aux=False) is forward-only: it
    refuses inputs that require gradients; with need_aux it takes them."""
    from saro_gs_torch.data import cameras
    from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
    cam = cameras.camera_from_c2w(cameras.ring_cameras(3)[0], 0.85, 32, 32,
                                  0.0).raster_params(device="cpu")
    means = torch.zeros(4, 3, requires_grad=True)
    args = (means, torch.ones(4, 3), torch.ones(4, 4), torch.ones(4), cam,
            torch.ones(3))
    with pytest.raises(RuntimeError, match="forward-only"):
        rasterize(*args, width=32, height=32,
                  config=RasterConfig(need_aux=False),
                  colors_precomp=torch.ones(4, 3))
    out = rasterize(*args, width=32, height=32,
                    colors_precomp=torch.ones(4, 3))
    out.color.sum().backward()
    assert means.grad is not None and torch.isfinite(means.grad).all()


def test_kernels_use_no_atomics_and_wrappers_do_not_fall_back():
    """The backward kernels sum in a fixed order (no atomicAdd), share the
    forward's alpha chain through one header, and every wrapper sends a
    CUDA tensor to its kernel: without a card that raises, it does not
    quietly take the plain version."""
    csrc = os.path.join(PKG, "csrc")
    code = {}
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as fh:
            # comments may name what the kernels avoid
            code[f] = re.sub(r"//[^\n]*", "", fh.read())
    assert {"forward.cu", "backward.cu", "expand.cu", "grid_scatter.cu",
            "alpha_chain.cuh"} <= set(code)
    for f, src in code.items():
        assert "atomic" not in src, f
    for f in ("forward.cu", "backward.cu"):
        assert '#include "alpha_chain.cuh"' in code[f]
        assert "eval_alpha(" in code[f] and "expf" not in code[f], f
    from saro_gs_torch.ops import tile_kernels
    assert set(tile_kernels.launches) == {"expand", "forward", "backward",
                                          "grid_scatter"}
    for name in ("tile_kernels.py", "grid_scatter.py"):
        with open(os.path.join(PKG, "ops", name)) as fh:
            src = fh.read()
        assert "except" not in src, name
