"""Stereo point reprojection residuals, analytic Jacobians and the Huber
kernel.

Counterpart of the point half of lldslam_tpu/optim/residuals.py (g2o's
EdgeStereoSE3ProjectXYZ): residual r = observation - prediction, camera
tangent ordered (upsilon, omega) and applied as exp(xi) * T_cw. Line edges
are not part of this port yet.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..geometry.camera import StereoCamera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def point_residual_stereo(cam: StereoCamera, T_cw: torch.Tensor,
                          X: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """obs (..., 3) = (uL, v, uR). Returns residual (..., 3)."""
    Xc = se3.apply(T_cw, X)
    z = _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] / z + cam.cx
    pred = torch.stack([
        u,
        cam.fy * Xc[..., 1] / z + cam.cy,
        u - torch.full_like(z, cam.bf) / z,
    ], dim=-1)
    return obs - pred


def point_jacobians_stereo(cam: StereoCamera, T_cw: torch.Tensor,
                           X: torch.Tensor):
    """Returns (J_pose (..., 3, 6), J_point (..., 3, 3), Xc (..., 3))."""
    R = T_cw[..., :3, :3]
    Xc = se3.apply(T_cw, X)
    x, y = Xc[..., 0], Xc[..., 1]
    z = _safe_z(Xc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    zero = torch.zeros_like(x)
    dproj = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=-1),
    ], dim=-2)
    # d Xc / d xi = [I | -hat(Xc)]: J_pose = [-dproj | dproj @ hat(Xc)],
    # row i of A @ hat(v) being a_i x v
    Jw = torch.linalg.cross(dproj, Xc[..., None, :].expand_as(dproj), dim=-1)
    J_pose = torch.cat([-dproj, Jw], dim=-1)
    J_point = -(dproj @ R)
    return J_pose, J_point, Xc


def huber_weight(chi2: torch.Tensor, delta_sq) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside."""
    d2 = torch.as_tensor(delta_sq, dtype=chi2.dtype, device=chi2.device)
    return torch.where(chi2 <= d2, torch.ones_like(chi2),
                       torch.sqrt(d2 / torch.clamp(chi2, min=1e-12)))


def huber_rho(chi2: torch.Tensor, delta_sq) -> torch.Tensor:
    """Huber robust cost: quadratic inside delta, linear in |e| outside."""
    return torch.where(chi2 <= delta_sq, chi2,
                       2.0 * torch.sqrt(delta_sq * torch.clamp(chi2, min=0.0))
                       - delta_sq)
