"""Line matching: stereo left/right and temporal map-line association.

Counterpart of lldslam_tpu/frontend/line_match.py. The reference's greedy
O(L^2) loops are masked dense cost matrices; the greedy claims (one right
line per left line, one detection per map line, lowest cost wins, lower
index on equal cost) are `scatter_reduce` passes on pre-filled tensors.
The descriptor distance is one (Na, D) @ (D, Nb) product (TF32 is off in
the package, so it runs in full float32). The stereo triangulation's line
fit takes its top eigenvector by power iteration (`_top_eigvec`) where the
JAX package calls `eigh`, so the matcher never makes the host wait.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import lines as gl
from ..geometry.camera import StereoCamera
from .line_extract import KeyLines


class FrameLines(NamedTuple):
    """Per-frame line state: left detections + stereo triangulation."""

    kl: KeyLines             # left-image detections
    r_idx: torch.Tensor      # (L,) matched right line or -1
    X0: torch.Tensor         # (L, 3) closest point, left camera frame
    d: torch.Tensor          # (L, 3) direction, left camera frame
    has_stereo: torch.Tensor  # (L,) bool
    p1_r: torch.Tensor       # (L, 2) matched right endpoints (0 when none)
    p2_r: torch.Tensor


def _desc_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise L2 distance (Na, Nb) by the matmul identity."""
    sq = torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None] \
        - 2.0 * (a @ b.T)
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _top_eigvec(cov: torch.Tensor, v: torch.Tensor,
                iters: int = 4) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of each symmetric PSD
    (..., 3, 3) `cov` by power iteration from `v`. The stereo samples of a
    line lie on one 3D line (the intersection of the two back-projected
    planes), so `cov` is rank one up to rounding and the chord `v` is
    already its eigenvector: the iterations only absorb the rounding. This
    replaces `torch.linalg.eigh` (the JAX package's route), whose error
    check makes the host wait for the card on every frame; the sign, which
    eigh leaves free, follows the chord."""
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    for _ in range(iters):
        w = (cov @ v[..., None])[..., 0]
        n = torch.linalg.norm(w, dim=-1, keepdim=True)
        v = torch.where(n > 1e-30, w / torch.clamp(n, min=1e-30), v)
    return v


def _greedy_claim(best: torch.Tensor, best_cost: torch.Tensor,
                  ok: torch.Tensor, n_targets: int):
    """Each source claims `best` at `best_cost` (where ok); a target keeps its
    lowest-cost claimant, the lowest source index among equal costs.
    Returns the winner mask (sources,)."""
    inf = torch.full((n_targets,), math.inf, dtype=best_cost.dtype,
                     device=best_cost.device)
    t_best = inf.scatter_reduce(
        0, best, torch.where(ok, best_cost, inf[:1].expand_as(best_cost)),
        "amin")
    winner = ok & (best_cost == t_best[best])
    n_src = best.shape[0]
    src = torch.arange(n_src, dtype=torch.int64, device=best.device)
    claim = torch.full((n_targets,), n_src, dtype=torch.int64,
                       device=best.device).scatter_reduce(
        0, best, torch.where(winner, src, n_src), "amin")
    return winner & (claim[best] == src)


def match_stereo_lines(cam: StereoCamera, kl: KeyLines, kr: KeyLines,
                       md_thr: float = 0.6, min_len: float = 25.0) -> FrameLines:
    """Greedy stereo line matching + triangulation of each match by lifting
    8 samples of the left segment through their disparity against the right
    infinite line and fitting the 3D line by PCA."""
    L, R = kl.p1.shape[0], kr.p1.shape[0]
    lr = gl.line_eq_from_endpoints(kr.p1, kr.p2)                 # (R, 3)
    a_r = lr[:, 0]
    vert_ok = a_r.abs() > 0.2                                    # not horizontal
    a_safe = torch.where(a_r.abs() < 1e-6, torch.full_like(a_r, 1e-6), a_r)

    # cheap per-pair geometry proxy: the two left endpoints lifted against
    # every right line must have a positive, bounded disparity
    Pe = torch.stack([kl.p1, kl.p2], dim=1)                      # (L, 2, 2)
    xr_e = -(lr[None, None, :, 1] * Pe[..., 1][:, :, None]
             + lr[None, None, :, 2]) / a_safe[None, None]
    disp_e = Pe[..., 0][:, :, None] - xr_e                       # (L, 2, R)
    ze = cam.bf / torch.clamp(disp_e, min=1e-6)
    geom_ok = ((disp_e > 0.5) & (ze > 0.3)).all(dim=1) & vert_ok[None, :]

    # rectified-stereo consistency: same orientation (mod pi), overlapping
    # vertical extent, non-negative disparity at the midpoint
    def seg_angle(p1, p2):
        d2 = p2 - p1
        a = torch.atan2(d2[..., 1], d2[..., 0])
        return torch.where(a < 0, a + math.pi, a)

    da = (seg_angle(kl.p1, kl.p2)[:, None] - seg_angle(kr.p1, kr.p2)[None]).abs()
    da = torch.minimum(da, math.pi - da)
    yl_lo = torch.minimum(kl.p1[:, 1], kl.p2[:, 1])
    yl_hi = torch.maximum(kl.p1[:, 1], kl.p2[:, 1])
    yr_lo = torch.minimum(kr.p1[:, 1], kr.p2[:, 1])
    yr_hi = torch.maximum(kr.p1[:, 1], kr.p2[:, 1])
    overlap = torch.minimum(yl_hi[:, None], yr_hi[None]) \
        - torch.maximum(yl_lo[:, None], yr_lo[None])
    span = torch.clamp(torch.minimum(yl_hi[:, None] - yl_lo[:, None],
                                     yr_hi[None] - yr_lo[None]), min=1.0)
    mid_xl = 0.5 * (kl.p1[:, 0] + kl.p2[:, 0])
    mid_xr = 0.5 * (kr.p1[:, 0] + kr.p2[:, 0])
    stereo_ok = (da < 0.1) & (overlap > 0.5 * span) \
        & ((mid_xl[:, None] - mid_xr[None]) > -3.0)

    dist = _desc_dist(kl.desc, kr.desc)
    gate = (kl.octave[:, None] == kr.octave[None]) \
        & (kl.length[:, None] >= min_len) & (kr.length[None] >= min_len) \
        & kl.valid[:, None] & kr.valid[None] & geom_ok & stereo_ok \
        & (dist < md_thr)
    cost = torch.where(gate, dist, torch.full_like(dist, math.inf))
    best = torch.argmin(cost, dim=1)
    best_cost = torch.gather(cost, 1, best[:, None])[:, 0]
    ok = torch.isfinite(best_cost)
    winner = _greedy_claim(best, best_cost, ok, R)

    # triangulation of the selected pair only
    bsel0 = torch.where(ok, best, torch.zeros_like(best))
    S = 8
    ts = torch.linspace(0.0, 1.0, S, dtype=kl.p1.dtype, device=kl.p1.device)
    P = kl.p1[:, None, :] + ts[None, :, None] * (kl.p2 - kl.p1)[:, None, :]
    lr_s = lr[bsel0]
    x_r = -(lr_s[:, None, 1] * P[..., 1] + lr_s[:, None, 2]) \
        / a_safe[bsel0][:, None]
    disp = P[..., 0] - x_r                                       # (L, S)
    z = cam.bf / torch.clamp(disp, min=1e-6)
    X = torch.stack([(P[..., 0] - cam.cx) * z / cam.fx,
                     (P[..., 1] - cam.cy) * z / cam.fy, z], dim=-1)
    ok_s = ((disp > 0.5) & (z > 0.3)).all(dim=-1)
    ctr = X.mean(dim=1)
    Xc = X - ctr[:, None, :]
    cov = torch.einsum("lsi,lsj->lij", Xc, Xc) / S
    dvec = _top_eigvec(cov, X[:, -1] - X[:, 0])
    spread = torch.einsum("lsi,li->ls", Xc, dvec).var(dim=-1, correction=0)
    span3 = 2.0 * torch.sqrt(torch.clamp(spread, min=1e-12))
    X0, d = gl.closest_point_form(ctr, dvec)
    winner = winner & ok_s & (torch.linalg.norm(X0, dim=-1) >= 0.5) \
        & (span3 > 1e-3)

    r_idx = torch.where(winner, best, -1)
    bsel = torch.clamp(r_idx, min=0)
    w = winner[:, None].to(X0.dtype)
    return FrameLines(kl=kl, r_idx=r_idx.to(torch.int32), X0=X0 * w, d=d * w,
                      has_stereo=winner, p1_r=kr.p1[bsel] * w,
                      p2_r=kr.p2[bsel] * w)


def associate_lines(cam: StereoCamera, T_cw: torch.Tensor, ln_X0: torch.Tensor,
                    ln_d: torch.Tensor, ln_desc: torch.Tensor,
                    ln_oct: torch.Tensor, ln_valid: torch.Tensor,
                    fl: FrameLines, md_thr: float = 0.6,
                    reproj_thr: float = 8.0):
    """Temporal line association: every (map line, detection) pair is gated
    on the per-octave L1 endpoint distance to the projected map line in
    both views (threshold 8 px x 1.44^octave), the map line's closest point
    in front, and descriptor distance < md_thr; greedy best per detection.
    Returns ln2det (M,) and det2ln (L,) int32."""
    kl = fl.kl
    L, M = kl.p1.shape[0], ln_X0.shape[0]
    T_r = gl.right_camera_pose(T_cw, cam.baseline)

    def l1_err(T, p1, p2):
        lproj = gl.project_line(cam, T, ln_X0, ln_d)[:, None]   # (M, 1, 3)
        return (gl.point_line_distance(lproj, p1[None]).abs()
                + gl.point_line_distance(lproj, p2[None]).abs())  # (M, L)

    err_l = l1_err(T_cw, kl.p1, kl.p2)
    err_r = l1_err(T_r, fl.p1_r, fl.p2_r)
    th = reproj_thr * (1.44 ** kl.octave.to(torch.float32))[None, :]
    reproj_ok = (err_l < th) & (torch.where(
        fl.has_stereo[None], err_r, torch.zeros_like(err_r)) < th)
    Xc0, _ = gl.transform_line(T_cw, ln_X0, ln_d)
    front = Xc0[..., 2] > 0

    dist = _desc_dist(ln_desc, kl.desc)
    gate = reproj_ok & (dist < md_thr) & ln_valid[:, None] & kl.valid[None] \
        & front[:, None]
    cost = torch.where(gate, dist, torch.full_like(dist, math.inf))
    best = torch.argmin(cost, dim=1)                    # per map line
    best_cost = torch.gather(cost, 1, best[:, None])[:, 0]
    winner = _greedy_claim(best, best_cost, torch.isfinite(best_cost), L)
    midx = torch.arange(M, dtype=torch.int64, device=best.device)
    ln2det = torch.where(winner, best, -1)
    det2ln = torch.full((L,), -1, dtype=torch.int64,
                        device=best.device).scatter_reduce(
        0, best, torch.where(winner, midx, -1), "amax")
    return ln2det.to(torch.int32), det2ln.to(torch.int32)
