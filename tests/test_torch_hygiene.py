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
    # chip_smoke.py and the tests modules it imports
    for f in ("chip_smoke.py", os.path.join("tests", "torch_parity.py"),
              os.path.join("tests", "torch_n3d_scene.py"),
              os.path.join("tests", "torch_dnerf_scene.py"),
              os.path.join("tests", "torch_hypernerf_scene.py")):
        with open(os.path.join(ROOT, f)) as fh:
            assert not pat.search(fh.read()), f


def test_ported_surface_is_covered():
    """Every module of the JAX package has its namesake here, so the two
    checks above reach the whole port: parallel/, utils/, prep.py and
    native.py too, data/synth.py, the port of
    scripts/make_synth_scene.py, and bench.py, the port of bench.py and
    __graft_entry__.py's synthetic state."""
    jax_pkg = os.path.join(ROOT, "saro_gs_tpu")
    theirs = set()
    for dirpath, _, files in os.walk(jax_pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), jax_pkg)
                theirs.add(rel[:-3].replace(os.sep, "."))
    theirs = {m[:-len(".__init__")] if m.endswith(".__init__") else m
              for m in theirs}
    mine = {m[len("saro_gs_torch."):] for m in _modules()
            if m != "saro_gs_torch"}
    theirs.discard("__init__")
    assert theirs <= mine, sorted(theirs - mine)
    assert {"native", "prep", "utils", "utils.visual", "train.lpips",
            "data.hypernerf", "data.preprocess", "data.synth", "parallel",
            "parallel.runtime", "parallel.shard", "bench"} <= mine


def test_native_build_writes_only_under_build(tmp_path, monkeypatch):
    """The port's native library compiles from native/src into
    build/saro_gs_torch/native and leaves native/ as it found it."""
    from saro_gs_torch import native

    def snapshot():
        # native/build is the JAX package's own make output, which its
        # binding may write from another test process meanwhile
        out = {}
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, "native")):
            if dirpath == os.path.join(ROOT, "native"):
                dirs[:] = [d for d in dirs if d != "build"]
            for f in files:
                path = os.path.join(dirpath, f)
                out[path] = os.stat(path).st_mtime_ns
        return out
    assert native.SO_PATH == os.path.join(
        ROOT, "build", "saro_gs_torch", "native", "libsaro_native.so")
    assert native.SRC_DIR == os.path.join(ROOT, "native", "src")
    before = snapshot()
    out_dir = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", str(out_dir))
    monkeypatch.setattr(native, "SO_PATH", str(out_dir / "lib.so"))
    assert native.build() > 0
    assert os.listdir(out_dir) == ["lib.so"]
    assert snapshot() == before


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


def test_trainer_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Scene and the CLI's --device default to cuda and refuse it without
    a card, before reading any data; Trainer and Evaluator run where
    their scene's model lives, so they default to it too."""
    import inspect
    import types

    from saro_gs_torch import cli, scene
    from saro_gs_torch.config import load_config
    from saro_gs_torch.eval import Evaluator
    from saro_gs_torch.train.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(scene.Scene).parameters["device"].default \
        == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        scene.Scene(load_config(source_path=str(tmp_path / "none")))
    model = str(tmp_path / "model")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.train_main(["-s", str(tmp_path / "none"), "-m", model])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.test_main(["-m", model])
    for cls in (Trainer, Evaluator):
        assert "device" not in inspect.signature(cls).parameters
    cpu_scene = types.SimpleNamespace(device=torch.device("cpu"))
    ev = Evaluator(load_config(), cpu_scene)
    assert ev.device == cpu_scene.device and ev.bg.device.type == "cpu"


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


_INT_TYPES = r"(?:int|unsigned|unsigned int|long long|unsigned long long)"


def _float_atomics(src: str):
    """Atomic calls in ``src`` that may add floats or place by atomic
    order: any atomicExch/atomicCAS, and any other atomic whose target is
    not declared with an integer type in the same source."""
    bad = []
    for m in re.finditer(r"\batomic(\w+)\s*\(\s*&?\s*(\w+)", src):
        op, target = m.groups()
        declared_int = re.search(
            rf"\b{_INT_TYPES}\s+(?:\*\s*)?{target}\b", src)
        if op in ("Exch", "CAS") or not declared_int:
            bad.append(m.group(0))
    return bad


def test_kernels_use_no_atomics_and_wrappers_do_not_fall_back():
    """The kernels sum floats in a fixed order: integer atomics may count,
    but no atomic adds a float and none places by atomic order.  The
    backward compositor shares the forward's alpha chain through one
    header, and every wrapper sends a CUDA tensor to its kernel: without a
    card that raises, it does not quietly take the plain version."""
    # the check itself: a float sum and an atomic placement are caught, an
    # integer count is not
    assert _float_atomics("float acc[4]; atomicAdd(&acc[0], v);")
    assert _float_atomics("int slot; p[atomicExch(&slot, 1)] = v;")
    assert not _float_atomics("__shared__ int hist[256];\n"
                              "atomicAdd(&hist[d], 1);")
    csrc = os.path.join(PKG, "csrc")
    code = {}
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as fh:
            # comments may name what the kernels avoid
            code[f] = re.sub(r"//[^\n]*", "", fh.read())
    assert {"forward.cu", "backward.cu", "expand.cu", "grid_scatter.cu",
            "ssim.cu", "alpha_chain.cuh"} <= set(code)
    for f, src in code.items():
        assert not _float_atomics(src), (f, _float_atomics(src))
    for f in ("forward.cu", "backward.cu"):
        assert '#include "alpha_chain.cuh"' in code[f]
        assert "eval_alpha(" in code[f] and "expf" not in code[f], f
    from saro_gs_torch.ops import tile_kernels
    assert set(tile_kernels.launches) == {"expand", "forward", "backward",
                                          "grid_scatter", "ssim"}
    for name in ("tile_kernels.py", "grid_scatter.py", "ssim.py"):
        with open(os.path.join(PKG, "ops", name)) as fh:
            src = fh.read()
        assert "except" not in src, name
