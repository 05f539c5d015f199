"""Windowed local bundle adjustment on a dense (K, P) observation grid.

Counterpart of the grid path of lldslam_tpu/optim/ba.py (`_densify_obs`
through `local_ba`): Levenberg-Marquardt with Huber IRLS and graduated
non-convexity, Schur elimination of the points through a dense (K, P, 6, 3)
coupling tensor, a Jacobi-scaled solve of the reduced camera system, and the
reference LocalBundleAdjustment schedule (5 iterations, drop outliers, 10
more, classify). The sparse `ba_solve`, its CG variant and the packed
readback are not part of this port yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import StereoCamera
from . import residuals as res
from .pose_opt import _row_weights


class BAObs(NamedTuple):
    """Padded point-observation table."""

    k: torch.Tensor           # (O,) int64 keyframe index
    p: torch.Tensor           # (O,) int64 point index
    uvr: torch.Tensor         # (O, 3)
    inv_sigma2: torch.Tensor  # (O,)
    is_stereo: torch.Tensor   # (O,) bool
    valid: torch.Tensor       # (O,) bool


class BAProblem(NamedTuple):
    poses: torch.Tensor       # (K, 4, 4) T_cw
    points: torch.Tensor      # (P, 3)
    pose_fixed: torch.Tensor  # (K,) bool — fixed frontier + gauge
    point_valid: torch.Tensor  # (P,) bool
    obs: BAObs


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - b * i, b * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c00 + b * c10 + c * c20
    idet = 1.0 / torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj * idet[..., None, None]


def _damp_diag(H: torch.Tensor, lam) -> torch.Tensor:
    """H + lam*diag(H) + eps I, batched."""
    n = H.shape[-1]
    I = torch.eye(n, dtype=H.dtype, device=H.device)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + (lam * d + 1e-8)[..., None] * I


def _fix_gauge(S: torch.Tensor, b: torch.Tensor, fixed: torch.Tensor):
    """Zero the rows/cols of fixed poses in the reduced system; unit
    diagonal on their blocks."""
    K = fixed.shape[0]
    free = (~fixed).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    b = b * free[:, None]
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    eyeK = torch.eye(K, dtype=S.dtype, device=S.device)
    S = S + (fixed.to(S.dtype)[:, None, None, None] * eyeK[:, None, :, None]
             * eye6[None, :, None, :])
    return S, b


def _densify_obs(problem: BAProblem):
    """Scatter the (O,) observation table into dense (K, P) grids once,
    before the LM loop; invalid rows land in a dropped extra cell."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    o = problem.obs
    dev = problem.points.device
    cell = torch.where(o.valid, o.k * P + o.p, torch.full_like(o.k, K * P))
    n = K * P + 1

    def grid(vals, shape, dtype):
        g = torch.zeros((n,) + shape, dtype=dtype, device=dev)
        g[cell] = vals.to(dtype)
        return g[:K * P].reshape((K, P) + shape)

    uvr_g = grid(o.uvr, (3,), torch.float32)
    w_g = grid(o.inv_sigma2, (), torch.float32)
    st_g = grid(o.is_stereo, (), torch.bool)
    val_g = grid(torch.ones_like(o.valid), (), torch.bool)
    return uvr_g, w_g, st_g, val_g


def _terms_grid(cam, poses, points, point_valid, uvr_g, w_g, st_g, val_g,
                robust: bool, dscale: float):
    """Residuals, Jacobians and IRLS weights over the dense (K, P) grid;
    also the current robust cost (raw chi2, no 1e6 gate)."""
    T = poses[:, None]                                      # (K, 1, 4, 4)
    X = points[None]                                        # (1, P, 3)
    r = res.point_residual_stereo(cam, T, X, uvr_g)         # (K, P, 3)
    Jc, Jp, Xc = res.point_jacobians_stereo(cam, T, X)
    row_w = _row_weights(st_g)
    chi2_raw = w_g * torch.sum(r * r * row_w, dim=-1)
    in_front = val_g & point_valid[None, :] & (Xc[..., 2] > 0.05)
    active = (in_front & (chi2_raw < 1e6)).to(r.dtype)
    r = r * active[..., None]
    Jc = Jc * active[..., None, None]
    Jp = Jp * active[..., None, None]
    chi2 = w_g * torch.sum(r * r * row_w, dim=-1)
    delta_sq = torch.where(st_g, res.CHI2_STEREO, res.CHI2_MONO) * dscale
    hub = res.huber_weight(chi2, delta_sq) if robust else 1.0
    W = (w_g * hub * active)[..., None] * row_w             # (K, P, 3)
    rho = res.huber_rho(chi2_raw, delta_sq) if robust else chi2_raw
    cost = torch.sum(rho * in_front.to(r.dtype))
    return r, Jc, Jp, W, cost


def _build_blocks_grid(r, Jc, Jp, W):
    """Normal-equation blocks from grid terms."""
    JcW = Jc * W[..., None]                                  # (K, P, 3, 6)
    Hcc = torch.einsum("kpri,kprj->kij", JcW, Jc)
    bc = -torch.einsum("kpri,kpr->ki", JcW, r)
    JpW = Jp * W[..., None]
    Hpp = torch.einsum("kpri,kprj->pij", JpW, Jp)
    bp = -torch.einsum("kpri,kpr->pi", JpW, r)
    B = torch.einsum("kpri,kprj->kpij", JcW, Jp)             # (K, P, 6, 3)
    return Hcc, bc, Hpp, bp, B


def _schur_solve_from_B(pose_fixed, point_valid, Hcc, bc, Hpp, bp, B, lam):
    """Reduced camera system from the dense coupling tensor, gauge fix,
    Jacobi-scaled solve, landmark back-substitution."""
    K = Hcc.shape[0]
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = _damp_diag(Hpp, lam)
    seen = B.abs().sum(dim=(0, 2, 3)) > 0
    Hpp_d = torch.where(seen[:, None, None], Hpp_d, eye3)
    Hpp_inv = _inv3x3(Hpp_d)
    BHinv = torch.einsum("kpij,pjl->kpil", B, Hpp_inv)
    S = torch.einsum("kpil,qpjl->kiqj", BHinv, B)             # (K, 6, K, 6)
    Hcc_d = _damp_diag(Hcc, lam)
    eyeK = torch.eye(K, dtype=Hcc.dtype, device=Hcc.device)
    S = torch.einsum("kij,kq->kiqj", Hcc_d, eyeK) - S
    rhs = bc - torch.einsum("kpil,pl->ki", BHinv, bp)
    S, rhs = _fix_gauge(S, rhs, pose_fixed)
    Sm = S.reshape(6 * K, 6 * K)
    Sm = 0.5 * (Sm + Sm.T)
    dsi = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Sm).abs(), min=1e-12))
    Ss = Sm * dsi[:, None] * dsi[None, :] \
        + 1e-6 * torch.eye(6 * K, dtype=Sm.dtype, device=Sm.device)
    y = torch.linalg.solve_ex(Ss, rhs.reshape(6 * K) * dsi)[0]
    dc = (y * dsi).reshape(K, 6)
    dp = torch.einsum("pij,pj->pi", Hpp_inv,
                      bp - torch.einsum("kpij,ki->pj", B, dc))
    return dc, dp * point_valid[:, None]


def _total_cost_grid(cam, poses, points, point_valid, uvr_g, w_g, st_g,
                     val_g, robust: bool, dscale: float):
    T = poses[:, None]
    X = points[None]
    r = res.point_residual_stereo(cam, T, X, uvr_g)
    Xc = se3.apply(T, X)
    chi2 = w_g * torch.sum(r * r * _row_weights(st_g), dim=-1)
    delta_sq = torch.where(st_g, res.CHI2_STEREO, res.CHI2_MONO) * dscale
    active = (val_g & point_valid[None, :] & (Xc[..., 2] > 0.05)).to(r.dtype)
    c = res.huber_rho(chi2, delta_sq) if robust else chi2
    return torch.sum(c * active)


def ba_solve_grid(cam: StereoCamera, problem: BAProblem, iters: int = 5,
                  robust: bool = True, gnc: bool = True):
    """LM on the dense grid: GNC (the Huber delta starts 8x inflated and
    halves per iteration), accept on cost decrease. Returns (problem', final
    chi2 per observation)."""
    uvr_g, w_g, st_g, val_g = _densify_obs(problem)
    poses, points = problem.poses, problem.points
    free = (~problem.pose_fixed).to(poses.dtype)
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    for i in range(iters):
        dscale = max(1.0, 64.0 * 0.5 ** i) if gnc else 1.0
        r, Jc, Jp, W, c_old = _terms_grid(
            cam, poses, points, problem.point_valid, uvr_g, w_g, st_g, val_g,
            robust, dscale)
        dc, dp = _schur_solve_from_B(problem.pose_fixed, problem.point_valid,
                                     *_build_blocks_grid(r, Jc, Jp, W), lam)
        poses_c = se3.exp(dc * free[:, None]) @ poses
        points_c = points + dp
        c_new = _total_cost_grid(cam, poses_c, points_c, problem.point_valid,
                                 uvr_g, w_g, st_g, val_g, robust, dscale)
        accept = c_new < c_old
        poses = torch.where(accept, poses_c, poses)
        points = torch.where(accept, points_c, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
    problem = problem._replace(poses=poses, points=points)
    o = problem.obs
    r = res.point_residual_stereo(cam, poses[o.k], points[o.p], o.uvr)
    chi2 = o.inv_sigma2 * torch.sum(r * r * _row_weights(o.is_stereo), dim=-1)
    return problem, chi2


def classify_outliers(problem: BAProblem, chi2: torch.Tensor,
                      cam: StereoCamera) -> torch.Tensor:
    """Observation inlier mask: chi2 gate + positive depth."""
    o = problem.obs
    th = torch.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
    Xc = se3.apply(problem.poses[o.k], problem.points[o.p])
    return o.valid & (chi2 <= th) & (Xc[..., 2] > 0)


def local_ba(cam: StereoCamera, problem: BAProblem):
    """LocalBundleAdjustment schedule: 5 iterations, drop outliers, 10 more,
    final outlier classification. Returns (problem', keep (O,))."""
    problem, chi2 = ba_solve_grid(cam, problem, iters=5)
    keep = classify_outliers(problem, chi2, cam)
    problem = problem._replace(obs=problem.obs._replace(valid=keep))
    problem, chi2 = ba_solve_grid(cam, problem, iters=10)
    return problem, classify_outliers(problem, chi2, cam)
