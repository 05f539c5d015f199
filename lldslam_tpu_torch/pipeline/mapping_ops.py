"""Keyframe-rate mapping operations on tensors.

Counterpart of lldslam_tpu/pipeline/mapping_ops.py:
- `triangulate_pair(s)`: epipolar-gated descriptor matching between two
  keyframes plus midpoint triangulation with parallax, cheirality and
  reprojection checks (CreateNewMapPoints + SearchForTriangulation),
- `fuse_candidates(_multi)`: project a keyframe's map points into a
  neighbour with the radius-3 projection search (ORBmatcher::Fuse), which
  goes through K2.
Results are returned as tensors (no packed buffer).
"""
from __future__ import annotations

import torch

from .. import tracing
from ..frontend import matching
from ..geometry import se3
from ..geometry.camera import StereoCamera
from ..ops import hamming


def triangulate_pair(cam: StereoCamera, T1: torch.Tensor, T2: torch.Tensor,
                     xy1, desc1, oct1, free1, xy2, desc2, oct2, free2,
                     inv_sigma2_lut: torch.Tensor):
    """KF1 (the new keyframe) against KF2. Returns (n_good (0-d int),
    match (N,) int32 KF2 feature per KF1 feature or -1, X (N, 3) world point
    per KF1 feature)."""
    N = xy1.shape[0]
    dev, dt = T1.device, T1.dtype
    # two host waits: inv's error check, and Kinv's blocking upload
    tracing.count("host_waits", 2)
    T21 = T2 @ torch.linalg.inv(T1)
    R, t = T21[:3, :3], T21[:3, 3]
    E = se3.hat(t) @ R
    Kinv = torch.tensor([[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
                         [0.0, 1.0 / cam.fy, -cam.cy / cam.fy],
                         [0.0, 0.0, 1.0]], dtype=dt, device=dev)
    F = Kinv.T @ E @ Kinv
    ones = torch.ones((N, 1), dtype=dt, device=dev)
    h1 = torch.cat([xy1, ones], dim=-1)
    h2 = torch.cat([xy2, ones], dim=-1)
    l2 = h1 @ F.T                                   # epipolar lines in KF2
    nrm = torch.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)
    d_epi = ((h2 @ l2.T).abs() / torch.clamp(nrm[None, :], min=1e-9)).T
    sigma2 = (1.0 / inv_sigma2_lut)[oct2.long()]
    epi_ok = d_epi < 3.84 * torch.sqrt(sigma2)[None, :]

    dist = hamming.distance_matrix(desc1, desc2)
    oct_ok = (oct1[:, None] - oct2[None, :]).abs() <= 1
    cand = epi_ok & oct_ok & free1[:, None] & free2[None, :] \
        & (dist <= hamming.TH_LOW)
    d = torch.where(cand, dist, torch.full_like(dist, hamming.INF_DIST))
    best = torch.argmin(d, dim=1)
    bd = torch.gather(d, 1, best[:, None])[:, 0]
    ok = bd <= hamming.TH_LOW
    # mutual exclusion per KF2 feature (lowest distance, then lowest KF1 id)
    won, _ = matching._resolve_conflicts(ok, best, bd, N)
    win = won >= 0

    def ray(T, xy):
        d_c = torch.stack([(xy[:, 0] - cam.cx) / cam.fx,
                           (xy[:, 1] - cam.cy) / cam.fy,
                           torch.ones(xy.shape[0], dtype=dt, device=dev)], -1)
        dirs = d_c @ T[:3, :3]                       # R^T d
        c = -(T[:3, :3].T @ T[:3, 3])
        return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True), c

    r1, c1 = ray(T1, xy1)
    r2all, c2 = ray(T2, xy2)
    bi = torch.clamp(best, min=0)
    r2 = r2all[bi]
    b_vec = c2 - c1
    d11 = torch.sum(r1 * r1, -1)
    d12 = torch.sum(r1 * r2, -1)
    d22 = torch.sum(r2 * r2, -1)
    det = d11 * d22 - d12 * d12
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    br1 = torch.sum(b_vec[None] * r1, -1)
    br2 = torch.sum(b_vec[None] * r2, -1)
    s1 = (br1 * d22 - br2 * d12) / det
    s2 = (br1 * d12 - br2 * d11) / det
    X = 0.5 * (c1 + s1[:, None] * r1 + c2 + s2[:, None] * r2)

    cospar = torch.sum(r1 * r2, -1)
    z1 = se3.apply(T1, X)[:, 2]
    z2 = se3.apply(T2, X)[:, 2]

    def reproj_ok(T, xy, oct_):
        Xc = se3.apply(T, X)
        z = torch.clamp(Xc[:, 2], min=1e-6)
        u = cam.fx * Xc[:, 0] / z + cam.cx
        v = cam.fy * Xc[:, 1] / z + cam.cy
        e2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        return e2 * inv_sigma2_lut[oct_.long()] < 5.991

    good = (win & (cospar < 0.9998) & (z1 > 0) & (z2 > 0)
            & reproj_ok(T1, xy1, oct1) & reproj_ok(T2, xy2[bi], oct2[bi]))
    match = torch.where(good, best, -1).to(torch.int32)
    return good.sum(), match, X


def triangulate_pairs(cam: StereoCamera, T1, xy1, desc1, oct1, free1,
                      T2s, xy2s, desc2s, oct2s, free2s, inv_sigma2_lut):
    """`triangulate_pair` over B neighbour keyframes (axis 0 of `*2s`).
    Returns a list of B (n_good, match, X) tuples."""
    return [triangulate_pair(cam, T1, T2s[b], xy1, desc1, oct1, free1,
                             xy2s[b], desc2s[b], oct2s[b], free2s[b],
                             inv_sigma2_lut)
            for b in range(T2s.shape[0])]


def fuse_candidates(cam: StereoCamera, T_kf: torch.Tensor,
                    view: matching.MapPointView,
                    kf_feats: matching.FrameFeatures, n_levels: int = 8,
                    scale: float = 1.2):
    """Fuse pass: associate source map points with the target keyframe's
    features (radius-3 projection search through K2). Returns (pt2kp (P,),
    kp2pt (N,))."""
    pt2kp, kp2pt, _, _ = matching.search_by_projection(
        cam, T_kf, view, kf_feats, n_levels=n_levels, scale=scale, th=0.75,
        site="fusion")
    return pt2kp, kp2pt


def fuse_candidates_multi(cam: StereoCamera, T_kfs, view, kf_feats_s,
                          n_levels: int = 8, scale: float = 1.2):
    """`fuse_candidates` over B target keyframes; returns a list."""
    return [fuse_candidates(cam, T_kfs[b], view, f, n_levels, scale)
            for b, f in enumerate(kf_feats_s)]
