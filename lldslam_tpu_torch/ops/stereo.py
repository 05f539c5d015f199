"""Stereo keypoint matching: row-banded Hamming argmin + subpixel SAD parabola.

Counterpart of lldslam_tpu/ops/stereo.py (`match_stereo`): candidates in a
+-2*scale row band, octave within +-1 and disparity in [0, bf/baseline]; best
Hamming match under TH_HIGH; 11x11 SAD over a +-5 disparity sweep on the
left keypoint's octave images with a parabola fit; outlier sweep at twice
the median SAD cost. The SAD stage (windows, sweep, argmin, parabola) is
K1b (ops/stereo_sad.py), one launch over the padded stack of all levels of
both views.

Output per left keypoint: `u_right` (level-0 px, subpixel) and `depth`, -1
for unmatched. A batch of frames rides a leading axis (keypoints (S, N, ...),
stack (S, L*2, H0, W0)): each frame's candidates are gated, matched and
median-filtered on their own, with one K1b launch for all S.
"""
from __future__ import annotations

import torch

from ..geometry.camera import StereoCamera
from . import consts, hamming, stereo_sad
from .orb import Keypoints, OrbConfig


def _nanmedian_of(vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median of vals[ok] along the last axis (mean of the two middle
    values for an even count, like jnp.nanmedian), keeping that axis with
    size 1; +inf when nothing is ok. No host sync."""
    s = torch.sort(torch.where(ok, vals, torch.full_like(vals, float("inf"))),
                   dim=-1).values
    cnt = ok.sum(dim=-1, keepdim=True)
    lo = torch.gather(s, -1, torch.clamp((cnt - 1) // 2, min=0))
    hi = torch.gather(s, -1, torch.clamp(cnt // 2, max=vals.shape[-1] - 1))
    return torch.where(cnt > 0, (lo + hi) / 2, torch.full_like(lo, float("inf")))


def match_stereo(kp_l: Keypoints, kp_r: Keypoints, pyr_stack: torch.Tensor,
                 level_hw, cam: StereoCamera, cfg: OrbConfig = OrbConfig()):
    """Returns (u_right (..., N), depth (..., N)) float32 with -1 for
    unmatched. kp_l / kp_r are single-view Keypoints (..., N, ...);
    pyr_stack (..., L*2, H0, W0) holds left level l at 2l and right level l
    at 2l + 1; level_hw the L level shapes (h, w) as host ints."""
    L = stereo_sad.L_SWEEP
    dev = kp_l.xy.device
    scales = consts.table(tuple(cfg.scale_factors()), torch.float32, dev)
    oct_l = kp_l.octave.long()
    sl = scales[oct_l]
    # --- candidate gating (row band, octave band, disparity range) ---
    rows = lambda x: x[..., :, None]
    cols = lambda x: x[..., None, :]
    row_ok = (rows(kp_l.xy[..., 1]) - cols(kp_r.xy[..., 1])).abs() \
        <= rows(2.0 * sl)
    oct_ok = (rows(kp_l.octave) - cols(kp_r.octave)).abs() <= 1
    max_d = cam.bf / cam.baseline
    disp = rows(kp_l.xy[..., 0]) - cols(kp_r.xy[..., 0])
    cand = row_ok & oct_ok & (disp >= 0.0) & (disp <= max_d)
    idx, ok, _ = hamming.match_descriptors(
        kp_l.desc, kp_l.valid, kp_r.desc, kp_r.valid,
        max_dist=hamming.TH_HIGH, cand_mask=cand, mutual=False)

    # --- subpixel SAD refinement on the octave-level images ---
    inv_s = 1.0 / sl
    ul = torch.round(kp_l.xy[..., 0] * inv_s).to(torch.int32)
    vl = torch.round(kp_l.xy[..., 1] * inv_s).to(torch.int32)
    ur = torch.round(torch.take_along_dim(kp_r.xy[..., 0], idx, dim=-1)
                     * inv_s).to(torch.int32)
    lvl = torch.clamp(kp_l.octave, 0, len(level_hw) - 1).to(torch.int32)
    best_d, best_c, delta = stereo_sad.sad_refine(
        pyr_stack, level_hw, *(x.contiguous() for x in (lvl, ul, vl, ur)))
    u_r_ref = (ur.to(torch.float32) + (best_d - L).to(torch.float32) + delta) * sl

    disparity = kp_l.xy[..., 0] - u_r_ref
    ok = ok & (disparity > 1e-3) & (disparity <= max_d)
    med = _nanmedian_of(best_c, ok)
    ok = ok & (best_c <= 2.0 * med)
    depth = torch.full_like(disparity, cam.bf) / torch.clamp(disparity, min=1e-6)
    depth = torch.where(ok, depth, torch.full_like(depth, -1.0))
    u_right = torch.where(ok, u_r_ref, torch.full_like(u_r_ref, -1.0))
    return u_right, depth
