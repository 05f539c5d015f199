"""Batched Sim(3) operations for loop closure and the essential graph.

Counterpart of lldslam_tpu/geometry/sim3.py, same conventions: a Sim(3)
element is the triple (R (..., 3, 3), t (..., 3), s (...,)), packed as
(..., 8) [q(w, x, y, z), t, s] for storage; a tangent vector is (..., 7)
ordered (upsilon, omega, sigma) with sigma = log s. Every function
broadcasts over leading batch dimensions and is safe under
`torch.func.vmap` and forward-mode differentiation (no data-dependent
Python branches).
"""
from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8
_EPS_ANGLE = 1e-5


def make(R: torch.Tensor, t: torch.Tensor, s):
    return R, t, torch.as_tensor(s, dtype=t.dtype, device=t.device)


def identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    shape = tuple(batch_shape)
    R = torch.eye(3, dtype=dtype, device=device).expand(shape + (3, 3))
    return R, torch.zeros(shape + (3,), dtype=dtype, device=device), \
        torch.ones(shape, dtype=dtype, device=device)


def from_se3(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3], torch.ones(
        T.shape[:-2], dtype=T.dtype, device=T.device)


def to_se3(S) -> torch.Tensor:
    """Drop the scale into the translation: (R, t / s)."""
    R, t, s = S
    return se3.from_Rt(R, t / s[..., None])


def compose(A, B):
    """A * B: R = RA RB, t = sA RA tB + tA, s = sA sB."""
    RA, tA, sA = A
    RB, tB, sB = B
    R = RA @ RB
    t = sA[..., None] * (RA @ tB[..., None])[..., 0] + tA
    return R, t, sA * sB


def inv(S):
    R, t, s = S
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ t[..., None])[..., 0]
    return Rt, t_inv, s_inv


def apply(S, X: torch.Tensor) -> torch.Tensor:
    """map(X) = s R X + t."""
    R, t, s = S
    return s[..., None] * (R @ X[..., None])[..., 0] + t


def exp(xi: torch.Tensor):
    """(..., 7) (upsilon, omega, sigma) -> (R, t, s), with the closed-form
    V = A I + B W + C W^2 of the similarity group and its sigma -> 0 and
    theta -> 0 limits."""
    v = xi[..., 0:3]
    w = xi[..., 3:6]
    sigma = xi[..., 6]
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS_ANGLE))
    small_t = theta_sq < _EPS_ANGLE
    s = torch.exp(sigma)
    W = se3.hat(w)
    WW = W @ W
    I = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    A_, B_, _ = se3._sinc_coeffs(theta_sq)
    R = I + A_[..., None, None] * W + B_[..., None, None] * WW

    one_s = torch.ones_like(sigma)
    one_t = torch.ones_like(theta_sq)
    small_s = sigma.abs() < 1e-4
    sigma_safe = torch.where(small_s, one_s, sigma)
    A_coef = torch.where(small_s, one_s, (s - 1.0) / sigma_safe)

    den = theta_sq + sigma * sigma
    den_safe = torch.where(den < _EPS, torch.ones_like(den), den)
    theta_safe = torch.where(small_t, torch.ones_like(theta), theta)
    ts_safe = torch.where(small_t, one_t, theta_sq)

    # general case (sigma != 0, theta != 0)
    B_gen = ((s * torch.sin(theta) * sigma
              + (1.0 - s * torch.cos(theta)) * theta)
             / (theta_safe * den_safe))
    C_gen = (A_coef - ((s * torch.cos(theta) - 1.0) * sigma
                       + s * torch.sin(theta) * theta) / den_safe) / ts_safe
    # sigma == 0 limits
    C_s0 = torch.where(small_t, torch.full_like(theta_sq, 1.0 / 6.0),
                       (1.0 - A_) / ts_safe)
    # theta == 0, sigma != 0 limits
    B_t0 = torch.where(small_s, torch.full_like(sigma, 0.5),
                       (sigma_safe * s - s + 1.0) / (sigma_safe * sigma_safe))
    C_t0 = torch.where(
        small_s, torch.full_like(sigma, 1.0 / 6.0),
        (0.5 * sigma_safe * sigma_safe * s - s + 1.0 + sigma_safe * s
         - sigma_safe) / torch.where(small_s, one_s, sigma_safe ** 3))
    B_coef = torch.where(small_s, B_, torch.where(small_t, B_t0, B_gen))
    C_coef = torch.where(small_s, C_s0, torch.where(small_t, C_t0, C_gen))
    V = A_coef[..., None, None] * I + B_coef[..., None, None] * W \
        + C_coef[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return R, t, s


def log(S) -> torch.Tensor:
    """Inverse of `exp`: V's columns are the three unit translations pushed
    through `exp`, then V v = t is solved."""
    R, t, s = S
    w = se3.so3_log(R)
    sigma = torch.log(s)
    e = torch.eye(3, dtype=w.dtype, device=w.device)
    cols = []
    for k in range(3):
        xi_k = torch.cat([e[k].expand(w.shape), w, sigma[..., None]], dim=-1)
        cols.append(exp(xi_k)[1])
    V = torch.stack(cols, dim=-1)
    v = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def retract(S, xi: torch.Tensor):
    """Left-multiplicative retraction exp(xi) * S."""
    return compose(exp(xi), S)


def pack(S) -> torch.Tensor:
    """(R, t, s) -> (..., 8) [quat wxyz, t, s]."""
    R, t, s = S
    return torch.cat([se3.quat_from_mat(R), t, s[..., None]], dim=-1)


def unpack(p: torch.Tensor):
    return se3.mat_from_quat(p[..., 0:4]), p[..., 4:7], p[..., 7]
