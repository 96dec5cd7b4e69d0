"""The benchmark's frozen copy of saro_gs_torch/ops/math3d.py, plain
PyTorch, part of the reference that decides `correct`; it imports
nothing of the program.  The original's docstring follows.

Core 3D math for Gaussian splatting (counterpart of saro_gs_tpu/ops/math3d.py).

Conventions, as in the JAX package and the reference CUDA rasterizer:

  * matrices are ROW-VECTOR convention: ``p_out = p_hom @ M``;
  * quaternions are (r, x, y, z) and the rasterizer-side covariance uses
    them un-normalized (forward.cu:127);
  * cov3d is the symmetric 3x3 packed as [xx, xy, xz, yy, yz, zz].

Camera matrices are built on the host in numpy; the per-point math works
on 1-D [N] tensor columns with the JAX package's evaluation order, so the
two packages round alike.  The row forms on [..., k] tensors
(``transform_point_4x3`` ... ``unpack_sym3``) are the JAX package's public
helpers, off the render path.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# w-epsilon of the homogeneous divide (forward.cu:199).
W_EPS = 1e-7
# Low-pass filter added to the 2D covariance diagonal (forward.cu:110-111).
COV2D_LOWPASS = 0.3
# Frustum near-cull threshold on view-space z (auxiliary.h:154).
NEAR_CULL_Z = 0.2


# ---------------------------------------------------------------------------
# camera matrices (host side, numpy)
# ---------------------------------------------------------------------------

def world_to_view_matrix(R: np.ndarray, t: np.ndarray,
                         translate=np.array([0.0, 0.0, 0.0]),
                         scale: float = 1.0) -> np.ndarray:
    """World->view 4x4, row-vector convention
    (``getWorld2View2(R, t, translate, scale).T``)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt.T)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      cx: float = 0.0, cy: float = 0.0) -> np.ndarray:
    """GL-style projection 4x4 with the (zfar+znear)/(zfar-znear) z-scale,
    row-vector convention; ``cx, cy`` are principal-point offsets in the
    [-0.5, 0.5] ratio convention."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    dx = (2 * tan_half_fovx * znear) * cx
    dy = (2 * tan_half_fovy * znear) * cy
    left += dx
    right += dx
    top += dy
    bottom += dy

    P = np.zeros((4, 4))
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P.T)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


# ---------------------------------------------------------------------------
# per-point math on 1-D tensor columns
# ---------------------------------------------------------------------------

def transform_point_4x3_cols(px, py, pz, m):
    """(x, y, z) columns through a row-vector 4x4, no homogeneous divide."""
    return (px * m[0, 0] + py * m[1, 0] + pz * m[2, 0] + m[3, 0],
            px * m[0, 1] + py * m[1, 1] + pz * m[2, 1] + m[3, 1],
            px * m[0, 2] + py * m[1, 2] + pz * m[2, 2] + m[3, 2])


def project_points_cols(px, py, pz, projmat):
    """World columns -> NDC (x, y, z) with the reference's w-epsilon.

    The denominator is replaced by 1 where |hw + eps| < 1e-4 (the r5 primal
    sanitization): such points sit at the camera plane and are culled at
    z <= 0.2, and keeping 1/~0 out of the primal keeps the later backward
    free of 0 * inf.  Visible points have hw + eps >= 0.2, so their values
    are unchanged."""
    m = projmat
    hx = px * m[0, 0] + py * m[1, 0] + pz * m[2, 0] + m[3, 0]
    hy = px * m[0, 1] + py * m[1, 1] + pz * m[2, 1] + m[3, 1]
    hz = px * m[0, 2] + py * m[1, 2] + pz * m[2, 2] + m[3, 2]
    hw = px * m[0, 3] + py * m[1, 3] + pz * m[2, 3] + m[3, 3]
    denom = hw + W_EPS
    denom = torch.where(denom.abs() < 1e-4, torch.ones_like(denom), denom)
    inv_w = 1.0 / denom
    return hx * inv_w, hy * inv_w, hz * inv_w


def quat_to_rotmat_cols(qr, qx, qy, qz):
    """Raw-quaternion rotation entries r00..r22 as nine columns."""
    r, x, y, z = qr, qx, qy, qz
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def build_cov3d_cols(sx, sy, sz, mod, qr, qx, qy, qz):
    """Scale + raw quaternion columns -> (xx, xy, xz, yy, yz, zz) of
    Sigma = M M^T, M = R diag(s) (forward.cu:118-152)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(
        qr, qx, qy, qz)
    sx = mod * sx
    sy = mod * sy
    sz = mod * sz
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    xx = m00 * m00 + m01 * m01 + m02 * m02
    xy = m00 * m10 + m01 * m11 + m02 * m12
    xz = m00 * m20 + m01 * m21 + m02 * m22
    yy = m10 * m10 + m11 * m11 + m12 * m12
    yz = m10 * m20 + m11 * m21 + m12 * m22
    zz = m20 * m20 + m21 * m21 + m22 * m22
    return xx, xy, xz, yy, yz, zz


def compute_cov2d_cols(px, py, pz, focal_x, focal_y, tan_fovx, tan_fovy,
                       cov6, viewmat):
    """EWA 2D covariance (a, b, c) of [[a, b], [b, c]] (forward.cu:74-113):
    view position clamped at 1.3*tanfov, +0.3 low-pass on the diagonal."""
    xx, xy, xz, yy, yz, zz = cov6
    tx_, ty_, tz = transform_point_4x3_cols(px, py, pz, viewmat)
    # near-culled points (z <= NEAR_CULL_Z, masked by the caller) get z = 1
    # so no 1/~0 enters the primal (r5 sanitization); surviving values are
    # unchanged because the caller's in-front test is the same predicate
    tz = torch.where(tz > NEAR_CULL_Z, tz, torch.ones_like(tz))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = tx_ / tz
    tytz = ty_ / tz
    tx = torch.minimum(torch.maximum(txtz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(tytz, -limy), limy) * tz

    fxtz = focal_x / tz
    fytz = focal_y / tz
    jx = -(focal_x * tx) / (tz * tz)
    jy = -(focal_y * ty) / (tz * tz)
    w = viewmat[:3, :3]
    u0 = w[0, 0] * fxtz + w[0, 2] * jx
    u1 = w[1, 0] * fxtz + w[1, 2] * jx
    u2 = w[2, 0] * fxtz + w[2, 2] * jx
    v0 = w[0, 1] * fytz + w[0, 2] * jy
    v1 = w[1, 1] * fytz + w[1, 2] * jy
    v2 = w[2, 1] * fytz + w[2, 2] * jy
    a = (xx * u0 * u0 + yy * u1 * u1 + zz * u2 * u2
         + 2.0 * (xy * u0 * u1 + xz * u0 * u2 + yz * u1 * u2))
    b = (xx * u0 * v0 + yy * u1 * v1 + zz * u2 * v2
         + xy * (u0 * v1 + u1 * v0) + xz * (u0 * v2 + u2 * v0)
         + yz * (u1 * v2 + u2 * v1))
    c = (yy * v1 * v1 + xx * v0 * v0 + zz * v2 * v2
         + 2.0 * (xy * v0 * v1 + xz * v0 * v2 + yz * v1 * v2))
    return a + COV2D_LOWPASS, b, c + COV2D_LOWPASS


def ndc2pix(v, size):
    """NDC [-1, 1] -> pixel coordinates (auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5


# ---------------------------------------------------------------------------
# stacked forms
# ---------------------------------------------------------------------------

def transform_point_4x3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[..., 3] through a row-vector 4x4 -> [..., 3], no homogeneous
    divide."""
    return p @ m[:3, :3] + m[3, :3]


def transform_point_4x4(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> homogeneous [..., 4] through a row-vector 4x4."""
    return p @ m[:3, :4] + m[3, :4]


def project_points(p: torch.Tensor, projmat: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> NDC [..., 3] with the reference's w-epsilon
    (forward.cu:198-200)."""
    hom = transform_point_4x4(p, projmat)
    return hom[..., :3] * (1.0 / (hom[..., 3:4] + W_EPS))


def quat_to_rotmat_raw(q: torch.Tensor) -> torch.Tensor:
    """Un-normalised (r, x, y, z) quaternions [..., 4] -> rotation matrices
    [..., 3, 3] (forward.cu:127), ``v_rot = R @ v``."""
    entries = quat_to_rotmat_cols(q[..., 0], q[..., 1], q[..., 2], q[..., 3])
    return torch.stack(entries, dim=-1).reshape(*q.shape[:-1], 3, 3)


def unpack_sym3(c6: torch.Tensor) -> torch.Tensor:
    """Packed [..., 6] -> symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = c6.unbind(-1)
    return torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz],
                       dim=-1).reshape(*c6.shape[:-1], 3, 3)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions as q / sqrt(|q|^2 + eps^2) (finite at 0)."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q / torch.sqrt(n2 + eps * eps)


def build_cov3d(scale: torch.Tensor, mod, quat: torch.Tensor) -> torch.Tensor:
    """[..., 3] scales and raw [..., 4] quaternions -> packed [..., 6]."""
    cols = build_cov3d_cols(scale[..., 0], scale[..., 1], scale[..., 2], mod,
                            quat[..., 0], quat[..., 1], quat[..., 2],
                            quat[..., 3])
    return torch.stack(cols, dim=-1)


def compute_cov2d(mean: torch.Tensor, focal_x, focal_y, tan_fovx, tan_fovy,
                  cov3d6: torch.Tensor, viewmat: torch.Tensor) -> torch.Tensor:
    """[..., 3] means and packed [..., 6] cov3d -> [..., 3] (a, b, c)."""
    cov6 = tuple(cov3d6[..., i] for i in range(6))
    a, b, c = compute_cov2d_cols(mean[..., 0], mean[..., 1], mean[..., 2],
                                 focal_x, focal_y, tan_fovx, tan_fovy,
                                 cov6, viewmat)
    return torch.stack([a, b, c], dim=-1)


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))
