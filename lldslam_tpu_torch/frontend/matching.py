"""Projection-based data association.

Counterpart of lldslam_tpu/frontend/matching.py: dense masked Hamming
association of projected map points (or last-frame points) with the frame's
keypoints, with the frustum, predicted-octave, search-window, stereo
right-u and ratio gates of ORBmatcher::SearchByProjection.

`search_by_projection` goes through K2g (ops/match_best2.py) on every call:
the gates are evaluated in the kernel, so neither the (P, N) candidate mask
nor the distance matrix is built on the card. `search_for_initialization`,
the monocular bootstrap's windowed matcher, runs on the dense Hamming matrix,
as the JAX package runs it in XLA.

`search_by_projection` and `match_last_frame` also take a leading sequence
axis S on every tensor (T_cw (S, 4, 4)): the multi-sequence driver's S
frames, each matched against its own map points or last frame alone, with
one K2g launch for all S (`jax.vmap` in lldslam_tpu/parallel/multi_seq.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import StereoCamera
from ..ops import hamming, match_best2


class MapPointView(NamedTuple):
    """Candidate map points for one frame's association."""

    pos: torch.Tensor        # (P, 3) world
    desc: torch.Tensor       # (P, 8) int32 distinctive descriptor
    normal: torch.Tensor     # (P, 3) mean viewing direction
    min_dist: torch.Tensor   # (P,) scale-invariance range
    max_dist: torch.Tensor   # (P,)
    valid: torch.Tensor      # (P,) bool


class FrameFeatures(NamedTuple):
    """One frame's left keypoints (level-0 coords)."""

    xy: torch.Tensor       # (N, 2)
    ur: torch.Tensor       # (N,) right-u or -1
    octave: torch.Tensor   # (N,) int32
    angle: torch.Tensor    # (N,)
    desc: torch.Tensor     # (N, 8) int32
    valid: torch.Tensor    # (N,) bool


@functools.lru_cache(maxsize=None)
def _level_scales(scale: float, n_levels: int, device) -> torch.Tensor:
    """float32 scale ** l, l < n_levels, as the JAX package computes it;
    built on the device from fills (no host-to-device copy), once."""
    return torch.full((), scale, dtype=torch.float32, device=device) ** \
        torch.arange(n_levels, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _log_scale(scale: float, device) -> torch.Tensor:
    return torch.log(torch.full((), scale, dtype=torch.float32, device=device))


def predict_octave(dist: torch.Tensor, max_dist: torch.Tensor, n_levels: int,
                   log_scale: torch.Tensor) -> torch.Tensor:
    """nScale = ceil(log(maxDist/d)/log(1.2)), clamped to the pyramid."""
    ratio = max_dist / torch.clamp(dist, min=1e-6)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / log_scale)
    return torch.clamp(lvl.to(torch.int64), 0, n_levels - 1)


def _resolve_conflicts(ok, best_kp, best, n_kp: int):
    """One keypoint per source row: lowest distance wins, then the lowest
    source index (per batch entry of the leading axes). Returns
    (src2kp (..., P), kp2src (..., N)) with -1 for none."""
    P = best_kp.shape[-1]
    lead = tuple(best_kp.shape[:-1])
    dev = best_kp.device
    best_kp = best_kp.long()
    inf = hamming.INF_DIST
    at = lambda t: torch.gather(t, -1, best_kp)
    best_masked = torch.where(ok, best, torch.full_like(best, inf))
    kp_best = torch.full(lead + (n_kp,), inf, dtype=best.dtype, device=dev) \
        .scatter_reduce(-1, best_kp, best_masked, "amin", include_self=True)
    winner = ok & (best_masked == at(kp_best))
    pidx = torch.arange(P, dtype=torch.int64, device=dev).expand_as(best_kp)
    kp_winner = torch.full(lead + (n_kp,), P, dtype=torch.int64, device=dev) \
        .scatter_reduce(-1, best_kp, torch.where(winner, pidx, P), "amin",
                        include_self=True)
    winner = winner & (at(kp_winner) == pidx)
    src2kp = torch.where(winner, best_kp, -1).to(torch.int32)
    kp2src = torch.full(lead + (n_kp,), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce(-1, best_kp, torch.where(winner, pidx, -1), "amax",
                        include_self=True).to(torch.int32)
    return src2kp, kp2src


def search_by_projection(cam: StereoCamera, T_cw: torch.Tensor,
                         pts: MapPointView, frame: FrameFeatures,
                         n_levels: int = 8, scale: float = 1.2,
                         th: float = 1.0, nn_ratio: float = 0.8,
                         check_rot: bool = False,
                         ref_angle: torch.Tensor | None = None,
                         site: str = "tracking"):
    """Associate map points to frame keypoints. Returns (pt2kp (P,) int32,
    kp2pt (N,) int32, uvr_pred (P, 3), in_frustum (P,) bool), each with the
    leading S of a batched call. `site` labels the caller in K2g's launch
    counts."""
    dev = T_cw.device
    scales = _level_scales(scale, n_levels, dev)
    log_scale = _log_scale(scale, dev)
    Xc = se3.apply(T_cw.unsqueeze(-3), pts.pos)
    z = Xc[..., 2]
    uv_z = torch.clamp(z, min=1e-6)
    u = cam.fx * Xc[..., 0] / uv_z + cam.cx
    v = cam.fy * Xc[..., 1] / uv_z + cam.cy
    ur = u - torch.full_like(uv_z, cam.bf) / uv_z
    cam_center = se3.inv(T_cw)[..., None, :3, 3]
    PO = pts.pos - cam_center
    dist = torch.linalg.norm(PO, dim=-1)
    viewcos = torch.sum(PO * pts.normal, dim=-1) / torch.clamp(dist, min=1e-6)
    in_frustum = (pts.valid & (z > 0.0) & (u >= 0) & (u < cam.width)
                  & (v >= 0) & (v < cam.height) & (dist >= pts.min_dist)
                  & (dist <= pts.max_dist) & (viewcos > 0.5))
    # max_dist carries the +20% gate slack; PredictScale uses mfMaxDistance
    pred_oct = predict_octave(dist, pts.max_dist / 1.2, n_levels, log_scale)
    r = torch.where(viewcos > 0.998, 2.5, 4.0) * th * scales[pred_oct]

    best_kp, best, second, second_kp = match_best2.gated_best2(
        pts.desc.contiguous(), u, v, ur, r, pred_oct.to(torch.int32),
        in_frustum, frame.desc.contiguous(), frame.xy.contiguous(),
        frame.ur.contiguous(), frame.octave.contiguous(),
        frame.valid.contiguous(), site=site)
    best_kp = best_kp.long()
    same_lvl = (torch.gather(frame.octave, -1, best_kp)
                == torch.gather(frame.octave, -1, second_kp.long()))
    ratio_ok = (~same_lvl) | (best.to(torch.float32)
                              <= nn_ratio * second.to(torch.float32))
    ok = (best <= hamming.TH_HIGH) & ratio_ok & in_frustum
    if check_rot and ref_angle is not None:
        ok = ok & hamming.rotation_consistency_mask(ref_angle, frame.angle,
                                                    best_kp, ok)
    pt2kp, kp2pt = _resolve_conflicts(ok, best_kp, best,
                                      frame.desc.shape[-2])
    return pt2kp, kp2pt, torch.stack([u, v, ur], dim=-1), in_frustum


def match_last_frame(cam: StereoCamera, T_cw: torch.Tensor,
                     last: FrameFeatures, last_pt_pos: torch.Tensor,
                     last_has_pt: torch.Tensor, cur: FrameFeatures,
                     n_levels: int = 8, scale: float = 1.2,
                     radius: float = 7.0) -> torch.Tensor:
    """Last-frame projection matching: radius*scale(octave) window, octave
    within +-1, Hamming best under TH_HIGH, rotation-consistency histogram.
    Returns kp2last (N_cur,) int32 index into the last frame or -1 (with
    the leading S of a batched call)."""
    scales = _level_scales(scale, n_levels, T_cw.device)
    Xc = se3.apply(T_cw.unsqueeze(-3), last_pt_pos)
    z = torch.clamp(Xc[..., 2], min=1e-6)
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    ur = u - torch.full_like(z, cam.bf) / z
    visible = (last_has_pt & last.valid & (Xc[..., 2] > 0)
               & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height))
    r = radius * scales[last.octave.long()]
    rows = lambda x: x[..., :, None]
    cols = lambda x: x[..., None, :]
    du = (rows(u) - cols(cur.xy[..., 0])).abs()
    dv = (rows(v) - cols(cur.xy[..., 1])).abs()
    win = (du <= rows(r)) & (dv <= rows(r))
    oct_ok = (cols(cur.octave) - rows(last.octave)).abs() <= 1
    dur = (rows(ur) - cols(cur.ur)).abs()
    ur_ok = (cols(cur.ur) < 0) | (dur <= rows(r))
    cand = win & oct_ok & ur_ok & rows(visible) & cols(cur.valid)

    d = torch.where(cand, hamming.distance_matrix(last.desc, cur.desc),
                    torch.full((), hamming.INF_DIST, dtype=torch.int32,
                               device=cand.device))
    best_kp = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_kp[..., None])[..., 0]
    ok = best <= hamming.TH_HIGH
    ok = ok & hamming.rotation_consistency_mask(last.angle, cur.angle,
                                                best_kp, ok)
    _, kp2last = _resolve_conflicts(ok, best_kp, best, d.shape[-1])
    return kp2last


def search_for_initialization(f0: FrameFeatures, f1: FrameFeatures,
                              radius: float = 100.0,
                              nn_ratio: float = 0.9) -> torch.Tensor:
    """Windowed descriptor matching for the monocular bootstrap: same
    octave, within +-radius px of the same image location, Hamming at most
    TH_LOW with the nn_ratio test, mutual best, rotation-consistency
    filtered. The JAX package keeps every octave where the reference keeps
    only level 0 (its divergence, kept here). Returns idx0to1 (N,) int64,
    -1 where unmatched."""
    win = ((f0.xy[:, None, 0] - f1.xy[None, :, 0]).abs() <= radius) \
        & ((f0.xy[:, None, 1] - f1.xy[None, :, 1]).abs() <= radius)
    cand = (win & (f0.octave[:, None] == f1.octave[None, :])
            & f0.valid[:, None] & f1.valid[None, :])
    dist = hamming.distance_matrix(f0.desc, f1.desc)
    best_t = torch.argmin(torch.where(cand, dist, hamming.INF_DIST), dim=0)
    best, bd, second = hamming.masked_argmin(dist, cand)
    ok = (bd <= hamming.TH_LOW) & (bd.to(torch.float32)
                                   <= nn_ratio * second.to(torch.float32))
    ok = ok & (best_t[best] == torch.arange(best.shape[0], device=ok.device))
    ok = hamming.rotation_consistency_mask(f0.angle, f1.angle, best, ok)
    return torch.where(ok, best, -1)
