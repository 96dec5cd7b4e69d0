"""LPIPS perceptual metric (counterpart of train/lpips.py; the reference's
lpipsPyTorch ``lpips(x, y, net_type='alex'|'vgg')``).

A frozen AlexNet or VGG16 trunk, unit-normalised channel activations at 5
taps, squared differences weighted by the non-negative "lin" heads,
averaged over space and summed over taps (Zhang et al. 2018).  The
convolutions are ``F.conv2d`` (the JAX package's are ``lax.conv``, outside
any kernel of its own); TF32 is off package-wide, so they run in full
float32.

Weights resolve as in the JAX package, and nothing is downloaded:

  1. ``$SARO_LPIPS_WEIGHTS/lpips_{net}.npz``, else
     ``weights/lpips_{net}.npz`` at the repository root, in the
     ``save_weights_npz`` layout (``convert_torch_state`` maps torchvision
     ``features`` and LPIPS ``lin{i}.model.1.weight`` state dicts into it);
  2. otherwise the deterministic fixture: the JAX package's
     ``init_random_weights(PRNGKey(0))``, the same ``RandomState`` draws in
     the same order from the seed that key gives (``FIXTURE_SEED``).  Its
     values are a relative random-feature distance, not comparable to
     published LPIPS numbers; reports name the source under
     ``LPIPS-weights``.

``SARO_LPIPS_FIXTURE=0`` turns the fixture off: without a weight file
``lpips`` then raises ``FileNotFoundError`` and ``lpips_available`` is
False.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import DEFAULT_DEVICE, resolve_device

# ImageNet normalisation of LPIPS's ScalingLayer, in [-1, 1] space
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet features: (out_channels, kernel, stride, pad), a tap after each
# ReLU; maxpool(3, 2) before convs 1 and 2
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
         (256, 3, 1, 1)]
_ALEX_POOL_BEFORE = {1, 2}
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
            "M", 512, 512, 512]
_VGG_TAPS = {1, 3, 6, 9, 12}  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

# int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 2**31 - 1)): the
# RandomState seed of the JAX package's fixture
FIXTURE_SEED = 31327077
FIXTURE_SOURCE = "fixture-random-seed0"

Params = Dict[str, torch.Tensor]


def param_shapes(net_type: str = "alex") -> Dict[str, Tuple[int, ...]]:
    """The npz layout: conv{i}_w [O, I, kh, kw], conv{i}_b [O],
    lin{i}_w [C] for each of the 5 taps."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    in_c, taps = 3, []
    if net_type == "alex":
        convs = [(out_c, k) for out_c, k, _, _ in _ALEX]
        taps = [c for c, *_ in _ALEX]
    elif net_type == "vgg":
        convs = [(c, 3) for c in _VGG_CFG if c != "M"]
        taps = [c for i, (c, _) in enumerate(convs) if i in _VGG_TAPS]
    else:
        raise ValueError(f"unknown LPIPS net {net_type!r}")
    for i, (out_c, k) in enumerate(convs):
        shapes[f"conv{i}_w"] = (out_c, in_c, k, k)
        shapes[f"conv{i}_b"] = (out_c,)
        in_c = out_c
    for i, c in enumerate(taps):
        shapes[f"lin{i}_w"] = (c,)
    return shapes


def _conv(x, w, b, stride, pad):
    if x.numel() == 0:
        # lax.conv's output of an empty map: only its zero padding
        k = w.shape[-1]
        h, wd = (max((n + 2 * pad - k) // stride + 1, 0)
                 for n in x.shape[-2:])
        x = x.new_zeros((x.shape[0], w.shape[0], h, wd))
        return x + b.reshape(1, -1, 1, 1)
    return F.conv2d(x, w, None, stride, pad) + b.reshape(1, -1, 1, 1)


def _max_pool(x, k, s):
    """F.max_pool2d, or the empty map the JAX package's VALID
    reduce_window gives where the window does not fit (an image too small
    for the trunk: the distance is then NaN in both packages)."""
    if min(x.shape[-2:]) < k:
        h, w = (max((n - k) // s + 1, 0) for n in x.shape[-2:])
        return x.new_zeros(tuple(x.shape[:2]) + (h, w))
    return F.max_pool2d(x, k, s)


def _alex_features(params: Params, x) -> List[torch.Tensor]:
    feats = []
    for i, (_, _, stride, pad) in enumerate(_ALEX):
        if i in _ALEX_POOL_BEFORE:
            x = _max_pool(x, 3, 2)
        x = F.relu(_conv(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                         stride, pad))
        feats.append(x)
    return feats


def _vgg_features(params: Params, x) -> List[torch.Tensor]:
    feats = []
    ci = 0
    for spec in _VGG_CFG:
        if spec == "M":
            x = _max_pool(x, 2, 2)
            continue
        x = F.relu(_conv(x, params[f"conv{ci}_w"], params[f"conv{ci}_b"],
                         1, 1))
        if ci in _VGG_TAPS:
            feats.append(x)
        ci += 1
    return feats


def _normalize(feat, eps=1e-10):
    norm = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
    return feat / (norm + eps)


def lpips_from_params(params: Params, x: torch.Tensor, y: torch.Tensor,
                      net_type: str = "alex") -> torch.Tensor:
    """LPIPS distance between images in [0, 1], [3, H, W] (a 0-d result)
    or [B, 3, H, W] ([B]), on the device of ``x``."""
    if x.ndim == 3:
        x, y = x[None], y[None]
    shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)

    def prep(img):
        return (img * 2.0 - 1.0 - shift) / scale

    extract = _alex_features if net_type == "alex" else _vgg_features
    with torch.no_grad():
        total = 0.0
        for i, (a, b) in enumerate(zip(extract(params, prep(x)),
                                       extract(params, prep(y)))):
            d = (_normalize(a) - _normalize(b)) ** 2
            w = params[f"lin{i}_w"].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return total.squeeze()


# ---------------------------------------------------------------- weights

def weights_path(net_type: str) -> str:
    root = os.environ.get(
        "SARO_LPIPS_WEIGHTS",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "weights"))
    return os.path.join(root, f"lpips_{net_type}.npz")


def _fixture_enabled() -> bool:
    return os.environ.get("SARO_LPIPS_FIXTURE", "1") == "1"


# (net, weight file or the fixture, device) -> (params, source)
_CACHE: Dict[Tuple[str, str, str], Tuple[Params, str]] = {}


def load_weights(net_type: str = "alex", device="cpu"
                 ) -> Optional[Tuple[Params, str]]:
    """(params on ``device``, their source: the npz file's name or
    ``FIXTURE_SOURCE``), or None when there is no weight file and the
    fixture is off."""
    path = weights_path(net_type)
    found = os.path.exists(path)
    if not found and not _fixture_enabled():
        return None
    dev = torch.device(device)
    key = (net_type, path if found else FIXTURE_SOURCE, str(dev))
    if key not in _CACHE:
        from ..convert import lpips_params_from_numpy
        if found:
            with np.load(path) as raw:
                arrays = {k: raw[k] for k in raw.files}
            source = os.path.basename(path)
        else:
            arrays, source = init_random_weights(net_type), FIXTURE_SOURCE
        _CACHE[key] = (lpips_params_from_numpy(arrays, net_type, dev),
                       source)
    return _CACHE[key]


def weights_source(net_type: str = "alex") -> Optional[str]:
    """Where the weights come from (``FIXTURE_SOURCE`` or the npz file's
    name); None when nothing can be loaded."""
    loaded = load_weights(net_type)
    return None if loaded is None else loaded[1]


def lpips_available(net_type: str = "alex") -> bool:
    return load_weights(net_type) is not None


def save_weights_npz(params: Dict[str, np.ndarray], net_type: str,
                     path: Optional[str] = None) -> str:
    """Write ``params`` (numpy arrays in the ``param_shapes`` layout) to
    ``path`` (default: where ``lpips`` looks)."""
    path = path or weights_path(net_type)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return path


def convert_torch_state(trunk_state: Dict[str, np.ndarray],
                        lin_state: Dict[str, np.ndarray],
                        net_type: str = "alex") -> Dict[str, np.ndarray]:
    """Map torchvision ``alexnet().features`` / ``vgg16().features`` and
    LPIPS ``lin{i}.model.1.weight`` state dicts (as numpy) into the npz
    layout."""
    params: Dict[str, np.ndarray] = {}
    conv_keys = sorted(
        {k.split(".")[0] for k in trunk_state if k.endswith(".weight")},
        key=int)
    for i, k in enumerate(conv_keys):
        params[f"conv{i}_w"] = np.asarray(trunk_state[f"{k}.weight"])
        params[f"conv{i}_b"] = np.asarray(trunk_state[f"{k}.bias"])
    for i in range(5):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in lin_state:
                params[f"lin{i}_w"] = np.asarray(lin_state[cand]).reshape(-1)
                break
        else:
            raise KeyError(f"lin head {i} not found in lin state dict")
    return params


def init_random_weights(net_type: str = "alex",
                        seed: int = FIXTURE_SEED) -> Dict[str, np.ndarray]:
    """The fixture: Kaiming-scaled normal convs, zero biases and
    |N(0, 1)| * 0.01 lin heads, drawn in the JAX package's order."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}
    shapes = param_shapes(net_type)
    n_convs = sum(k.endswith("_b") for k in shapes)
    for i in range(n_convs):
        out_c, in_c, k, _ = shapes[f"conv{i}_w"]
        params[f"conv{i}_w"] = rng.randn(out_c, in_c, k, k).astype(
            np.float32) * np.sqrt(2.0 / (in_c * k * k))
        params[f"conv{i}_b"] = np.zeros(out_c, np.float32)
    for i in range(5):
        c, = shapes[f"lin{i}_w"]
        params[f"lin{i}_w"] = np.abs(rng.randn(c).astype(np.float32)) * 0.01
    return params


def lpips(x, y, net_type: str = "alex", device=None) -> torch.Tensor:
    """The reference's entry point (lpipsPyTorch/__init__.py:6-21): images
    in [0, 1] as tensors (computed on their device) or numpy arrays
    (computed on ``device``, default cuda).  Raises FileNotFoundError when
    there is no weight file and the fixture is off."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else DEFAULT_DEVICE
    dev = resolve_device(device)
    loaded = load_weights(net_type, dev)
    if loaded is None:
        raise FileNotFoundError(
            f"LPIPS weights not found at {weights_path(net_type)} and "
            "SARO_LPIPS_FIXTURE=0; convert them with convert_torch_state + "
            "save_weights_npz, or point SARO_LPIPS_WEIGHTS at them")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    return lpips_from_params(loaded[0], x, y, net_type)
