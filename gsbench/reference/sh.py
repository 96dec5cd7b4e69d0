"""The benchmark's frozen copy of saro_gs_torch/ops/sh.py, plain
PyTorch, part of the reference that decides `correct`; it imports
nothing of the program.  The original's docstring follows.

Spherical-harmonics colour, degree <= 3 (counterpart of ops/sh.py).

Real SH basis with the reference's constants (forward.cu:20-71), a +0.5
offset and a clamp at 0 whose mask is kept for the backward.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def sh_basis_cols(degree: int, x, y, z):
    """The first ``(degree+1)^2`` basis functions at unit directions given
    as columns, as a list of 1-D tensors."""
    b = [SH_C0 * torch.ones_like(x)]
    if degree > 0:
        b += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        b += [SH_C2[0] * xy,
              SH_C2[1] * yz,
              SH_C2[2] * (2.0 * zz - xx - yy),
              SH_C2[3] * xz,
              SH_C2[4] * (xx - yy)]
    if degree > 2:
        b += [SH_C3[0] * y * (3.0 * xx - yy),
              SH_C3[1] * xy * z,
              SH_C3[2] * y * (4.0 * zz - xx - yy),
              SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
              SH_C3[4] * x * (4.0 * zz - xx - yy),
              SH_C3[5] * z * (xx - yy),
              SH_C3[6] * x * (xx - 3.0 * yy)]
    return b


def sh_raw_cols(degree: int, shs: torch.Tensor, px, py, pz, campos):
    """SH [N, 16, 3] and position columns -> the unclamped colour
    sum_k basis_k * sh_k + 0.5 [N, 3], summed in k order like the JAX
    package."""
    dx = px - campos[0]
    dy = py - campos[1]
    dz = pz - campos[2]
    inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    basis = sh_basis_cols(degree, dx * inv_n, dy * inv_n, dz * inv_n)
    raw = basis[0][:, None] * shs[:, 0]
    for k in range(1, len(basis)):
        raw = raw + basis[k][:, None] * shs[:, k]
    return raw + 0.5


def eval_sh_color_cols(degree: int, shs: torch.Tensor, px, py, pz, campos):
    """SH [N, 16, 3] and position columns -> (rgb [N, 3], clamped [N, 3]):
    rgb = max(raw, 0) of ``sh_raw_cols``; ``clamped`` marks the channels
    the clamp cut."""
    raw = sh_raw_cols(degree, shs, px, py, pz, campos)
    return torch.clamp_min(raw, 0.0), raw < 0


def rgb2sh(rgb):
    """DC-band conversion (utils/sh_utils.py:114); tensors or arrays."""
    return (rgb - 0.5) / SH_C0


def sh2rgb(shs):
    return shs * SH_C0 + 0.5
