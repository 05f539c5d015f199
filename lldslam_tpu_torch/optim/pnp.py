"""Perspective-n-Point: batched EPnP inside all-hypotheses RANSAC.

Counterpart of lldslam_tpu/optim/pnp.py, used by relocalization: EPnP
(4 control points, barycentric coordinates, the 1-dimensional null space of
the 2n x 12 system, the N=1 beta from control-point distances, then a Horn
alignment) on every 6-point hypothesis at once, scored by one (H, N)
reprojection pass with the per-octave chi2 5.991 sigma^2 gate. The
hypothesis draw takes an explicit `torch.Generator` and is split from the
scoring (`score_pnp`).
"""
from __future__ import annotations

import torch

from .. import tracing
from ..geometry.camera import StereoCamera
from .sim3_solver import draw_hypotheses, horn_sim3

CHI2_PNP = 5.991


def _control_points(Pw: torch.Tensor) -> torch.Tensor:
    """Centroid + principal directions: (..., n, 3) -> (..., 4, 3)."""
    c0 = Pw.mean(dim=-2)
    Pc = Pw - c0[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", Pc, Pc) / Pw.shape[-2]
    tracing.count("host_waits")         # eigh's error check
    w, V = torch.linalg.eigh(cov)                       # ascending
    sig = torch.sqrt(torch.clamp(w, min=1e-12))
    dirs = V.transpose(-1, -2) * sig[..., None]
    return torch.cat([c0[..., None, :], c0[..., None, :] + dirs], dim=-2)


def _barycentric(Pw: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """alphas (..., n, 4) with rows summing to 1."""
    B = (C[..., 1:, :] - C[..., :1, :]).transpose(-1, -2)
    Binv = torch.linalg.inv_ex(
        B + 1e-9 * torch.eye(3, dtype=Pw.dtype, device=Pw.device))[0]
    a123 = torch.einsum("...ij,...nj->...ni", Binv, Pw - C[..., :1, :])
    return torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)


def epnp(cam: StereoCamera, Pw: torch.Tensor, uv: torch.Tensor):
    """EPnP solve. Pw (..., n, 3) world points, uv (..., n, 2) pixels.
    Returns T_cw (..., 4, 4)."""
    batch = Pw.shape[:-2]
    n = Pw.shape[-2]
    C = _control_points(Pw)
    A = _barycentric(Pw, C)                              # (..., n, 4)
    du = cam.cx - uv[..., 0]
    dv = cam.cy - uv[..., 1]
    zeros = torch.zeros_like(A)
    rows_u = torch.stack([A * cam.fx, zeros, A * du[..., None]], dim=-1)
    rows_v = torch.stack([zeros, A * cam.fy, A * dv[..., None]], dim=-1)
    M = torch.cat([rows_u.reshape(*batch, n, 12),
                   rows_v.reshape(*batch, n, 12)], dim=-2)  # (..., 2n, 12)
    tracing.count("host_waits", 2)      # svd waits twice on the card
    Vh = torch.linalg.svd(M, full_matrices=True)[2]
    v = Vh[..., -1, :].reshape(*batch, 4, 3)              # null-space ctrl pts
    i0, i1 = torch.triu_indices(4, 4, 1, device=Pw.device)   # the 6 pairs
    dv_cam = torch.linalg.norm(v[..., i0, :] - v[..., i1, :], dim=-1)
    dc_w = torch.linalg.norm(C[..., i0, :] - C[..., i1, :], dim=-1)
    beta = torch.sum(dv_cam * dc_w, dim=-1) / torch.clamp(
        torch.sum(dv_cam * dv_cam, dim=-1), min=1e-12)
    Pc = torch.einsum("...ni,...ij->...nj", A, beta[..., None, None] * v)
    # cheirality: flip when the depths come out negative
    flip = torch.sum(Pc[..., 2], dim=-1) < 0
    Pc = torch.where(flip[..., None, None], -Pc, Pc)
    R, t, _ = horn_sim3(Pc, Pw)
    T = torch.zeros(batch + (4, 4), dtype=Pw.dtype, device=Pw.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def score_pnp(cam: StereoCamera, Pw, uv, sigma2, valid, idx):
    """EPnP on each (H, 6) set of `idx`, scored by reprojection. Returns
    (T_cw best, inlier mask (N,), n_inliers)."""
    n_hyp = idx.shape[0]
    T = epnp(cam, Pw[idx], uv[idx])                      # (H, 4, 4)
    Xc = torch.einsum("hij,nj->hni", T[:, :3, :3], Pw) + T[:, None, :3, 3]
    z = torch.clamp(Xc[..., 2], min=1e-6)
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    err2 = ((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2) \
        / sigma2[None]
    inl = (err2 < CHI2_PNP) & (Xc[..., 2] > 0) & valid[None]
    finite = torch.isfinite(T.reshape(n_hyp, -1)).all(dim=-1)
    scores = torch.where(finite, inl.sum(-1), torch.full_like(inl.sum(-1), -1))
    best = torch.argmax(scores)
    tracing.count("host_waits", 3)      # each index by a device scalar
    return T[best], inl[best], torch.clamp(scores[best], min=0)


def ransac_pnp(cam: StereoCamera, Pw, uv, sigma2, valid,
               generator: torch.Generator, n_hyp: int = 256):
    """All-hypotheses EPnP RANSAC over 6-point sets (a 6-point set keeps
    the null space 1-dimensional, so the N=1 beta case holds). Returns
    (T_cw best, inlier mask, n_inliers)."""
    idx = draw_hypotheses(valid, n_hyp, 6, generator)
    return score_pnp(cam, Pw, uv, sigma2, valid, idx)
