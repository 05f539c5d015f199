"""Pose-only optimization: Levenberg-Marquardt with Huber IRLS and
round-based inlier reclassification, with point and line edges.

Counterpart of lldslam_tpu/optim/pose_opt.py (`optimize_pose`): `rounds` x
`iters` LM iterations on the frame pose (4 x 10 by default; the tracker's
line step runs 2 x 6), a damped 6x6 solve per iteration, and after each
round every edge is reclassified:
- stereo/mono point edges with per-octave information, against chi2 5.991
  (mono) / 7.815 (stereo);
- line edges of fixed 3D lines, two per stereo line observation (left and
  right camera), information gamma^2 / 1.44^(2 octave), Huber delta and
  threshold gamma^2-scaled, inliers at twice the threshold, with analytic
  Jacobians (`residuals.line_pose_jacobian`) for the increment of the left
  pose that the step moves, the right view's too (T_rl exp(xi) T; the JAX
  package takes the right camera's own increment there, so its step stops
  short of its cost's minimum).
Accept/reject stays on the device (`torch.where`), so the solver never
waits for the host. Point-only problems take a leading batch axis (poses
(S, 4, 4), observations (S, N, ...)): the multi-sequence driver's S frames
solved together, with lambda, the accept test and the inlier rounds kept
per sequence.

`optimize_pose` routes by its input's device: a call on CUDA tensors,
points only or the joint point+line LM, is one launch of the pose LM
kernel (ops/pose_lm.py, csrc/pose_lm.cu); CPU tensors run
`optimize_pose_plain`, the same algorithm op by op.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lines as glines, se3
from ..geometry.camera import StereoCamera
from ..ops import pose_lm
from . import residuals as res

LINE_PYR_FACTOR = 1.44


class PointPoseObs(NamedTuple):
    """Fixed-capacity point observations for one frame."""

    X: torch.Tensor           # (N, 3) world points
    obs: torch.Tensor         # (N, 3) (uL, v, uR); uR ignored when mono
    inv_sigma2: torch.Tensor  # (N,) per-octave information
    is_stereo: torch.Tensor   # (N,) bool
    valid: torch.Tensor       # (N,) bool


class LinePoseObs(NamedTuple):
    """Fixed-capacity line observations (fixed 3D geometry) for one frame."""

    X0: torch.Tensor          # (M, 3) world closest point
    d: torch.Tensor           # (M, 3) world unit direction
    x1_l: torch.Tensor        # (M, 2) observed left endpoints
    x2_l: torch.Tensor
    x1_r: torch.Tensor        # (M, 2) observed right endpoints
    x2_r: torch.Tensor
    octave: torch.Tensor      # (M,) int32
    has_right: torch.Tensor   # (M,) bool: stereo observation present
    valid: torch.Tensor       # (M,) bool


def _row_weights(is_stereo: torch.Tensor) -> torch.Tensor:
    """(N, 3) per-row weights: the uR row is dropped for mono edges."""
    s = is_stereo.to(torch.float32)
    return torch.stack([torch.ones_like(s), torch.ones_like(s), s], dim=-1)


def _point_terms(cam, T, p: PointPoseObs, inlier, delta_m2, delta_s2,
                 need_system: bool = True):
    Tn = T.unsqueeze(-3)                                        # per edge
    r = res.point_residual_stereo(cam, Tn, p.X, p.obs)          # (..., N, 3)
    row_w = _row_weights(p.is_stereo)
    chi2 = p.inv_sigma2 * torch.sum(r * r * row_w, dim=-1)
    delta_sq = torch.where(p.is_stereo, delta_s2, delta_m2)
    cost = torch.sum(res.huber_rho(chi2, delta_sq) * inlier, dim=-1)
    if not need_system:
        return None, None, cost, chi2
    Jp, _, _ = res.point_jacobians_stereo(cam, Tn, p.X)     # (..., N, 3, 6)
    w = p.inv_sigma2 * res.huber_weight(chi2, delta_sq) * inlier
    W = w[..., None] * row_w
    H = torch.einsum("...nri,...nr,...nrj->...ij", Jp, W, Jp)
    b = -torch.einsum("...nri,...nr,...nr->...i", Jp, W, r)     # -J^T W r
    return H, b, cost, chi2


def _line_terms(cam, T, l: LinePoseObs, inlier, gamma: float,
                need_system: bool = True):
    """Left and right line edges: (H, b, cost, chi2 (M,), delta_sq (M,));
    H and b are None without `need_system`."""
    info = (gamma * gamma) / (LINE_PYR_FACTOR
                              ** (2.0 * l.octave.to(torch.float32)))
    delta_sq = torch.where(l.has_right, res.CHI2_STEREO * gamma * gamma,
                           res.CHI2_MONO * gamma * gamma)
    T_r = glines.right_camera_pose(T, cam.baseline)
    right = l.has_right.to(torch.float32)
    H = b = None
    cost = torch.zeros((), dtype=T.dtype, device=T.device)
    chi2 = []
    for T_cam, x1, x2, active, off in (
            (T, l.x1_l, l.x2_l, inlier, 0.0),
            (T_r, l.x1_r, l.x2_r, inlier * right, cam.baseline)):
        r = glines.endpoint_residual(cam, T_cam, l.X0, l.d, x1, x2)  # (M, 2)
        c2 = info * torch.sum(r * r, dim=-1)
        chi2.append(c2)
        cost = cost + torch.sum(res.huber_rho(c2, delta_sq) * active)
        if need_system:
            # (M, 2, 6), w.r.t. the increment of the left pose that the
            # step moves (exp(xi) T; the right view sees T_rl exp(xi) T),
            # where the JAX package takes the right camera's own exp(xi) T_r
            J = res.line_pose_jacobian(cam, T, l.X0, l.d, x1, x2, off)
            w = info * res.huber_weight(c2, delta_sq) * active
            Hc = torch.einsum("mri,m,mrj->ij", J, w, J)
            bc = -torch.einsum("mri,m,mr->i", J, w, r)
            H, b = (Hc, bc) if H is None else (H + Hc, b + bc)
    chi2 = chi2[0] + torch.where(l.has_right, chi2[1], torch.zeros_like(chi2[1]))
    return H, b, cost, chi2, delta_sq


def optimize_pose(cam: StereoCamera, T_init: torch.Tensor, pts: PointPoseObs,
                  lns: LinePoseObs | None = None, gamma: float = 0.5,
                  rounds: int = 4, iters: int = 10, site: str = "other"):
    """Returns (T_opt (4, 4), point inlier mask (N,), line inlier mask (M,)
    (empty without lines), n_inliers (0-d): the point inliers); each with
    the leading S of a batched call (T_init (S, 4, 4)). On CUDA tensors,
    with or without lines: one launch of the kernel (`site` labels it in
    `pose_lm.launches_by_site`); otherwise `optimize_pose_plain`."""
    if T_init.device.type == "cuda":
        rows = (*pts, *lns) if lns is not None else pts
        T, inl, n, ln_in = pose_lm.pose_lm(
            cam, T_init.contiguous(), *(t.contiguous() for t in rows),
            rounds=rounds, iters=iters, gamma=gamma, site=site)
        return T, inl, ln_in, n
    return optimize_pose_plain(cam, T_init, pts, lns, gamma, rounds, iters)


def optimize_pose_plain(cam: StereoCamera, T_init: torch.Tensor,
                        pts: PointPoseObs, lns: LinePoseObs | None = None,
                        gamma: float = 0.5, rounds: int = 4, iters: int = 10):
    """`optimize_pose` op by op on any device: the CPU's path and the plain
    version the kernel is held to."""
    delta_m2, delta_s2 = res.CHI2_MONO, res.CHI2_STEREO
    dev, dt = T_init.device, T_init.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    T = T_init
    pt_in = pts.valid.to(torch.float32)
    ln_in = (lns.valid.to(torch.float32) if lns is not None
             else torch.zeros(0, dtype=torch.float32, device=dev))
    for _ in range(rounds):
        lam = torch.full(T.shape[:-2], 1e-5, dtype=dt, device=dev)
        for _ in range(iters):
            H, b, cost, _ = _point_terms(cam, T, pts, pt_in, delta_m2, delta_s2)
            if lns is not None:
                Hl, bl, cl, _, _ = _line_terms(cam, T, lns, ln_in, gamma)
                H, b, cost = H + Hl, b + bl, cost + cl
            Hd = H + lam[..., None, None] * torch.diag_embed(
                torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-8 * eye6
            dx = torch.linalg.solve_ex(Hd, b)[0]
            T_new = se3.exp(dx) @ T
            _, _, cost_new, _ = _point_terms(cam, T_new, pts, pt_in, delta_m2,
                                             delta_s2, need_system=False)
            if lns is not None:
                cost_new = cost_new + _line_terms(
                    cam, T_new, lns, ln_in, gamma, need_system=False)[2]
            accept = cost_new < cost
            T = torch.where(accept[..., None, None], T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e3)
        # reclassify every edge (outliers may return next round)
        _, _, _, chi2 = _point_terms(cam, T, pts, pts.valid.to(torch.float32),
                                     delta_m2, delta_s2, need_system=False)
        th = torch.where(pts.is_stereo, delta_s2, delta_m2)
        pt_in = (pts.valid & (chi2 <= th)).to(torch.float32)
        if lns is not None:
            _, _, _, chi2_l, th_l = _line_terms(
                cam, T, lns, lns.valid.to(torch.float32), gamma,
                need_system=False)
            ln_in = (lns.valid & (chi2_l <= 2.0 * th_l)).to(torch.float32)
    return T, pt_in > 0, ln_in > 0, pt_in.sum(-1).to(torch.int32)
