"""The SSIM term of the training loss (saro_gs_torch/ops/ssim.py) on the
CPU: K5's plain version, ``parts`` with autograd, against the eager
expression it replaced (the map and the gradient to the bit), gradcheck in
float64, and what ``ssim`` refuses.  The kernel itself is held to this
version on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from saro_gs_torch.ops import ssim as ssim_ops
from saro_gs_torch.train import losses


def _eager_blur(img, taps):
    # the blur as the loss wrote it before K5
    k = len(taps)
    h = k // 2
    _, height, width = img.shape
    x = F.pad(img, (0, 0, h, h))
    x = sum(taps[i] * x[:, i:i + height, :] for i in range(k))
    x = F.pad(x, (h, h))
    return sum(taps[i] * x[:, :, i:i + width] for i in range(k))


def _eager_map(img1, img2):
    # the SSIM map as the loss wrote it before K5
    taps = ssim_ops.WINDOW
    mu1 = _eager_blur(img1, taps)
    mu2 = _eager_blur(img2, taps)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _eager_blur(img1 * img1, taps) - mu1_sq
    s2 = _eager_blur(img2 * img2, taps) - mu2_sq
    s12 = _eager_blur(img1 * img2, taps) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * s12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def _images(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1)
    return torch.as_tensor(a.astype(dtype)), torch.as_tensor(b.astype(dtype))


@pytest.mark.parametrize("shape", [(3, 400, 400), (3, 17, 33), (1, 7, 5)])
def test_plain_forward_is_the_eager_expression(shape):
    a, b = _images(shape)
    want = _eager_map(a, b)
    p = ssim_ops.parts(a, b)
    assert torch.equal(p.ssim_map, want)
    assert torch.equal(ssim_ops.ssim(a, b), want.mean())
    assert torch.equal(losses.ssim(a, b), want.mean())
    assert torch.equal(losses.ssim_map(a, b), want)


def _autograd_grad(a, b, g):
    x = a.clone().requires_grad_()
    (g * (1.0 - _eager_map(x, b).mean())).backward()
    return x.grad


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(3, 400, 400), (3, 17, 33), (1, 7, 5)])
def test_plain_gradient_matches_autograd(shape, dtype):
    """The gradient is autograd's through the eager expression to the bit,
    in the training loss's use: g * (1 - ssim)."""
    a, b = _images(shape, seed=1, dtype=dtype)
    y = a.clone().requires_grad_()
    loss = losses.ssim(y, b)
    assert torch.equal(loss.detach(), _eager_map(a, b).mean())
    (0.2 * (1.0 - loss)).backward()
    want = _autograd_grad(a, b, 0.2)
    assert float(want.abs().max()) > 0
    assert torch.equal(y.grad, want)


def test_plain_gradcheck_float64():
    a, b = _images((1, 9, 12), seed=2, dtype=np.float64)
    x = a.clone().requires_grad_()
    assert torch.autograd.gradcheck(lambda u: ssim_ops.ssim(u, b), (x,))


def test_no_gradient_to_img2_and_no_maps_without_grad():
    a, b = _images((3, 17, 33), seed=3)
    with pytest.raises(ValueError, match="img2"):
        ssim_ops.ssim(a.clone().requires_grad_(), b.clone().requires_grad_())
    with torch.no_grad():
        out = ssim_ops.ssim(a.clone().requires_grad_(), b)
    assert not out.requires_grad
    assert torch.equal(out, _eager_map(a, b).mean())


def test_wrapper_checks_refuse_bad_images():
    a, b = _images((3, 17, 33), seed=4)
    bad = [(a[0], b[0], "shape"), (a.double(), b.double(), "dtype"),
           (a.transpose(1, 2), b.transpose(1, 2), "contiguous"),
           (a[:, :, ::2], b[:, :, ::2], "contiguous"), (a, b[:2], "shape")]
    for x, y, what in bad:
        with pytest.raises(ValueError, match=what):
            ssim_ops._check_images(x, y)
    ssim_ops._check_images(a, b)
