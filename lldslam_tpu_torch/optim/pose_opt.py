"""Pose-only optimization: Levenberg-Marquardt with Huber IRLS and
round-based inlier reclassification, points only.

Counterpart of lldslam_tpu/optim/pose_opt.py (`optimize_pose` without line
edges): 4 rounds x 10 LM iterations on the frame pose, stereo/mono point
edges with per-octave information, a damped 6x6 solve per iteration, and
after each round every edge is reclassified against chi2 5.991 (mono) /
7.815 (stereo). Accept/reject stays on the device (`torch.where`), so the
solver never waits for the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import StereoCamera
from . import residuals as res


class PointPoseObs(NamedTuple):
    """Fixed-capacity point observations for one frame."""

    X: torch.Tensor           # (N, 3) world points
    obs: torch.Tensor         # (N, 3) (uL, v, uR); uR ignored when mono
    inv_sigma2: torch.Tensor  # (N,) per-octave information
    is_stereo: torch.Tensor   # (N,) bool
    valid: torch.Tensor       # (N,) bool


def _row_weights(is_stereo: torch.Tensor) -> torch.Tensor:
    """(N, 3) per-row weights: the uR row is dropped for mono edges."""
    mono = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float32,
                        device=is_stereo.device)
    return torch.where(is_stereo[..., None], torch.ones_like(mono), mono)


def _point_terms(cam, T, p: PointPoseObs, inlier, delta_m2, delta_s2,
                 need_system: bool = True):
    r = res.point_residual_stereo(cam, T, p.X, p.obs)           # (N, 3)
    row_w = _row_weights(p.is_stereo)
    chi2 = p.inv_sigma2 * torch.sum(r * r * row_w, dim=-1)
    delta_sq = torch.where(p.is_stereo, delta_s2, delta_m2)
    cost = torch.sum(res.huber_rho(chi2, delta_sq) * inlier)
    if not need_system:
        return None, None, cost, chi2
    Jp, _, _ = res.point_jacobians_stereo(cam, T, p.X)          # (N, 3, 6)
    w = p.inv_sigma2 * res.huber_weight(chi2, delta_sq) * inlier
    W = w[:, None] * row_w
    H = torch.einsum("nri,nr,nrj->ij", Jp, W, Jp)
    b = -torch.einsum("nri,nr,nr->i", Jp, W, r)                  # -J^T W r
    return H, b, cost, chi2


def optimize_pose(cam: StereoCamera, T_init: torch.Tensor, pts: PointPoseObs,
                  rounds: int = 4, iters: int = 10):
    """Returns (T_opt (4, 4), point_inlier_mask (N,), n_inliers (0-d))."""
    delta_m2, delta_s2 = res.CHI2_MONO, res.CHI2_STEREO
    dev, dt = T_init.device, T_init.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    T = T_init
    pt_in = pts.valid.to(torch.float32)
    for _ in range(rounds):
        lam = torch.tensor(1e-5, dtype=dt, device=dev)
        for _ in range(iters):
            H, b, cost, _ = _point_terms(cam, T, pts, pt_in, delta_m2, delta_s2)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            dx = torch.linalg.solve_ex(Hd, b)[0]
            T_new = se3.exp(dx) @ T
            _, _, cost_new, _ = _point_terms(cam, T_new, pts, pt_in, delta_m2,
                                             delta_s2, need_system=False)
            accept = cost_new < cost
            T = torch.where(accept, T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e3)
        # reclassify every edge (outliers may return next round)
        _, _, _, chi2 = _point_terms(cam, T, pts, pts.valid.to(torch.float32),
                                     delta_m2, delta_s2, need_system=False)
        th = torch.where(pts.is_stereo, delta_s2, delta_m2)
        pt_in = (pts.valid & (chi2 <= th)).to(torch.float32)
    return T, pt_in > 0, pt_in.sum().to(torch.int32)
