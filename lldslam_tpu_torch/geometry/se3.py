"""Batched SE(3) manifold operations on tensors.

Counterpart of lldslam_tpu/geometry/se3.py, same conventions: a pose is a
4x4 homogeneous matrix (T_cw in the pipeline), a tangent vector is (..., 6)
ordered (upsilon, omega), and every function broadcasts over leading batch
dimensions. Small-angle branches use Taylor expansions selected by `where`
on safe operands.
"""
from __future__ import annotations

import torch

_EPS = 1e-8
# float32-safe small-angle cutoff (see the JAX module)
_EPS_ANGLE = 1e-5


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe."""
    small = theta_sq < _EPS_ANGLE
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / ts_safe)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - A) / ts_safe)
    return A, B, C


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    A, B, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye(3, w, W.shape) + A[..., None, None] * W \
        + B[..., None, None] * (W @ W)


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z) with w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    sw = torch.clamp(1.0 + tr, min=1e-12)
    sx = torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)
    sy = torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)
    sz = torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)
    case = torch.argmax(torch.stack([sw, sx, sy, sz], dim=-1), dim=-1)
    rw, rx, ry, rz = sw.sqrt(), sx.sqrt(), sy.sqrt(), sz.sqrt()
    q_w = torch.stack([rw, (m21 - m12) / rw, (m02 - m20) / rw, (m10 - m01) / rw], -1)
    q_x = torch.stack([(m21 - m12) / rx, rx, (m10 + m01) / rx, (m02 + m20) / rx], -1)
    q_y = torch.stack([(m02 - m20) / ry, (m10 + m01) / ry, ry, (m21 + m12) / ry], -1)
    q_z = torch.stack([(m10 - m01) / rz, (m02 + m20) / rz, (m21 + m12) / rz, rz], -1)
    qs = 0.5 * torch.stack([q_w, q_x, q_y, q_z], dim=-2)      # (..., 4, 4)
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(qs, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack([
        torch.stack([1 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
        torch.stack([txy + twz, 1 - (txx + tzz), tyz - twx], dim=-1),
        torch.stack([txz - twy, tyz + twx, 1 - (txx + tyy)], dim=-1),
    ], dim=-2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    q = quat_from_mat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    nv = torch.linalg.norm(qv, dim=-1)
    small = nv < _EPS
    nv_safe = torch.where(small, torch.ones_like(nv), nv)
    angle = 2.0 * torch.atan2(nv, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), angle / nv_safe)
    return qv * scale[..., None]


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:] \
        .expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: (..., 6) (upsilon, omega) -> (..., 4, 4)."""
    v = xi[..., :3]
    w = xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    WW = W @ W
    I = _eye(3, xi, W.shape)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return from_Rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: (..., 4, 4) -> (..., 6) (upsilon, omega)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    WW = W @ W
    small = theta_sq < _EPS_ANGLE
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    coef = torch.where(small, torch.full_like(theta_sq, 1.0 / 12.0),
                       (1.0 - A / (2.0 * B)) / ts_safe)
    Vinv = _eye(3, T, W.shape) - 0.5 * W + coef[..., None, None] * WW
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform, (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def apply(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Transform points: T (..., 4, 4) applied to X (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return (R @ X[..., None])[..., 0] + t


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction exp(xi) * T."""
    return exp(xi) @ T


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(
        *tuple(batch_shape), 4, 4)
