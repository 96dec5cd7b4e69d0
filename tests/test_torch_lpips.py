"""The port's LPIPS (saro_gs_torch/train/lpips.py) against the JAX
package's (saro_gs_tpu/train/lpips.py), on the CPU.

The fixture weights must equal ``init_random_weights(PRNGKey(0))`` to the
bit; distances on 64x64 pairs agree within 1e-5 relative (float32
convolutions summed in another order); the weight file round trip, the
environment switches and the torchvision state mapping behave as the JAX
package's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import convert
from saro_gs_torch.train import lpips as T
from saro_gs_tpu.train import lpips as J

NETS = ("alex", "vgg")


@pytest.fixture(scope="module")
def jax_fixture():
    return {net: J.init_random_weights(jax.random.PRNGKey(0), net)
            for net in NETS}


def _pairs(seed, size=64):
    rng = np.random.RandomState(seed)
    x = rng.rand(3, size, size).astype(np.float32)
    near = np.clip(x + rng.randn(3, size, size) * 0.02, 0, 1).astype(
        np.float32)
    far = rng.rand(3, size, size).astype(np.float32)
    return x, near, far


@pytest.mark.parametrize("net", NETS)
def test_fixture_equals_jax_to_the_bit(net, jax_fixture):
    mine = T.init_random_weights(net)
    theirs = jax_fixture[net]
    assert set(mine) == set(theirs) == set(T.param_shapes(net))
    tensors = convert.lpips_params_from_numpy(mine, net)
    for k, v in theirs.items():
        # the JAX package holds them as float32 device arrays
        ref = np.asarray(jnp.asarray(v))
        assert ref.dtype == np.float32
        np.testing.assert_array_equal(tensors[k].numpy(), ref, err_msg=k)


@pytest.mark.parametrize("net", NETS)
def test_distance_matches_jax(net, jax_fixture):
    """Both a near pair and an unrelated pair, one image and a batch."""
    jp = {k: jnp.asarray(v) for k, v in jax_fixture[net].items()}
    x, near, far = _pairs(0)
    xb, yb = np.stack([x, x]), np.stack([near, far])
    ref = np.asarray(J.lpips_from_params(jp, jnp.asarray(xb),
                                         jnp.asarray(yb), net))
    assert (ref > 0).all()
    got = T.lpips(torch.as_tensor(xb), torch.as_tensor(yb), net).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    for y, r in zip((near, far), ref):
        got = T.lpips(x, y, net, device="cpu")
        assert got.shape == () and float(got) == pytest.approx(r, rel=1e-5)


def test_alex_tap_shapes():
    params = convert.lpips_params_from_numpy(T.init_random_weights("alex"))
    feats = T._alex_features(params, torch.zeros(1, 3, 64, 64))
    assert [f.shape[1] for f in feats] == [64, 192, 384, 256, 256]
    # 64x64 through AlexNet: 15 -> 7 -> 3 -> 3 -> 3
    assert [f.shape[-1] for f in feats] == [15, 7, 3, 3, 3]


def test_vgg_tap_shapes():
    params = convert.lpips_params_from_numpy(T.init_random_weights("vgg"),
                                             "vgg")
    feats = T._vgg_features(params, torch.zeros(1, 3, 64, 64))
    assert [f.shape[1] for f in feats] == [64, 128, 256, 512, 512]
    assert [f.shape[-1] for f in feats] == [64, 32, 16, 8, 4]


def test_conv_matches_numpy():
    """The first conv (stride 4, pad 2) against an explicit correlation."""
    params = T.init_random_weights("alex")
    rng = np.random.RandomState(0)
    x = rng.randn(1, 3, 16, 16).astype(np.float32)
    w = params["conv0_w"][:2].astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    out = T._conv(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                  4, 2).numpy()
    xp = np.pad(x, ((0, 0), (0, 0), (2, 2), (2, 2)))
    for oy in range(out.shape[2]):
        for ox in range(out.shape[3]):
            patch = xp[0, :, oy * 4:oy * 4 + 11, ox * 4:ox * 4 + 11]
            ref = (patch[None] * w).sum(axis=(1, 2, 3)) + b
            np.testing.assert_allclose(out[0, :, oy, ox], ref, rtol=1e-4,
                                       atol=1e-4)


def test_identity_zero_and_symmetric():
    x, _, far = _pairs(1, 32)
    assert float(T.lpips(x, x, device="cpu")) == pytest.approx(0.0,
                                                               abs=1e-6)
    assert float(T.lpips(x, far, device="cpu")) == pytest.approx(
        float(T.lpips(far, x, device="cpu")), rel=1e-5)


def test_fixture_fallback(tmp_path, monkeypatch):
    """Without a weight file the fixture loads and names itself, as the
    JAX package's does."""
    monkeypatch.setenv("SARO_LPIPS_WEIGHTS", str(tmp_path / "none"))
    monkeypatch.setenv("SARO_LPIPS_FIXTURE", "1")
    J._CACHE.clear()
    J._SOURCE.clear()
    try:
        assert T.lpips_available("alex") and J.lpips_available("alex")
        assert T.weights_source("alex") == J.weights_source("alex") \
            == "fixture-random-seed0"
        x, _, far = _pairs(3, 32)
        assert float(T.lpips(x, far, device="cpu")) == pytest.approx(
            float(J.lpips(x, far)), rel=1e-5)
    finally:
        J._CACHE.clear()
        J._SOURCE.clear()


def test_npz_roundtrip_and_switches(tmp_path, monkeypatch):
    """SARO_LPIPS_FIXTURE=0 without a file: unavailable, and ``lpips``
    raises; a file in the save_weights_npz layout under
    SARO_LPIPS_WEIGHTS is then used, whichever package wrote it."""
    monkeypatch.setenv("SARO_LPIPS_WEIGHTS", str(tmp_path))
    monkeypatch.setenv("SARO_LPIPS_FIXTURE", "0")
    assert not T.lpips_available("alex")
    assert T.weights_source("alex") is None
    with pytest.raises(FileNotFoundError):
        T.lpips(np.zeros((3, 16, 16)), np.zeros((3, 16, 16)), device="cpu")
    # weights other than the fixture's: the file, not the fixture, is read
    params = T.init_random_weights("alex", seed=5)
    path = J.save_weights_npz(params, "alex")
    assert path == T.weights_path("alex")
    assert T.lpips_available("alex")
    assert T.weights_source("alex") == "lpips_alex.npz"
    x, _, far = _pairs(4, 32)
    got = float(T.lpips(x, far, device="cpu"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = float(J.lpips_from_params(jp, jnp.asarray(x), jnp.asarray(far)))
    assert got == pytest.approx(ref, rel=1e-5)
    fixture = float(T.lpips_from_params(convert.lpips_params_from_numpy(
        T.init_random_weights("alex")), torch.as_tensor(x),
        torch.as_tensor(far)))
    assert got != fixture
    # the port's writer gives the same file layout
    other = T.save_weights_npz(params, "alex", str(tmp_path / "b" / "x.npz"))
    with np.load(other) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_bad_layout_is_refused():
    params = T.init_random_weights("alex")
    params["conv1_w"] = params["conv1_w"][:, :3]
    with pytest.raises(ValueError, match="conv1_w"):
        convert.lpips_params_from_numpy(params, "alex")
    with pytest.raises(ValueError, match="keys"):
        convert.lpips_params_from_numpy(T.init_random_weights("alex"), "vgg")


def test_convert_torch_state_layout():
    """A torchvision-style alexnet.features state dict and LPIPS lin heads
    map to the npz layout as the JAX package maps them."""
    params = T.init_random_weights("alex")
    trunk = {}
    for i, k in enumerate([0, 3, 6, 8, 10]):
        trunk[f"{k}.weight"] = params[f"conv{i}_w"]
        trunk[f"{k}.bias"] = params[f"conv{i}_b"]
    lin = {f"lins.{i}.model.1.weight": params[f"lin{i}_w"].reshape(
        -1, 1, 1, 1) for i in range(5)}
    out = T.convert_torch_state(trunk, lin, "alex")
    ref = J.convert_torch_state(trunk, lin, "alex")
    assert set(out) == set(ref) == set(params)
    for k in params:
        np.testing.assert_array_equal(out[k], params[k])
        np.testing.assert_array_equal(out[k], ref[k])
    with pytest.raises(KeyError):
        T.convert_torch_state(trunk, {}, "alex")
