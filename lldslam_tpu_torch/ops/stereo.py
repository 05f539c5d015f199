"""Stereo keypoint matching: row-banded Hamming argmin + subpixel SAD parabola.

Counterpart of lldslam_tpu/ops/stereo.py (`match_stereo`): candidates in a
+-2*scale row band, octave within +-1 and disparity in [0, bf/baseline]; best
Hamming match under TH_HIGH; 11x11 SAD over a +-5 disparity sweep on the
left keypoint's octave images with a parabola fit; outlier sweep at twice
the median SAD cost. The SAD windows (patch from the left level image, strip
from the right) are read by K1 (ops/patch_sample.py), one launch each over
the padded stack of all levels of both views.

Output per left keypoint: `u_right` (level-0 px, subpixel) and `depth`, -1
for unmatched.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.camera import StereoCamera
from . import hamming, patch_sample
from .orb import Keypoints, OrbConfig

W_HALF = 5   # 11x11 SAD window
L_SWEEP = 5  # disparity sweep +-5


def _nanmedian_of(vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median of vals[ok] (mean of the two middle values for an even count,
    like jnp.nanmedian); +inf when nothing is ok. No host sync."""
    s = torch.sort(torch.where(ok, vals, torch.full_like(vals, float("inf")))).values
    cnt = ok.sum()
    lo = s[torch.clamp((cnt - 1) // 2, min=0)]
    hi = s[torch.clamp(cnt // 2, max=vals.shape[0] - 1)]
    return torch.where(cnt > 0, (lo + hi) / 2, torch.full_like(lo, float("inf")))


def _sample_windows(pyr_stack: torch.Tensor, level_hw: torch.Tensor,
                    lvl: torch.Tensor, ul, vl, ur):
    """SAD windows via K1. pyr_stack (L*2, H0, W0) with left level l at 2l,
    right at 2l+1; level_hw (L, 2) level shapes. Returns (patch (n, 11, 11)
    from the left, strip (n, 11, 11 + 2L) from the right); coordinates are
    clipped into each keypoint's level image."""
    W, L = W_HALF, L_SWEEP
    dev = pyr_stack.device
    hk = level_hw[lvl, 0][:, None]
    wk = level_hw[lvl, 1][:, None]
    oy = torch.arange(-W, W + 1, dtype=torch.int32, device=dev)
    ox_p = torch.arange(-W, W + 1, dtype=torch.int32, device=dev)
    ox_s = torch.arange(-W - L, W + L + 1, dtype=torch.int32, device=dev)
    yy = torch.minimum(torch.clamp(vl[:, None] + oy[None], min=0), hk - 1)

    def taps(u, ox, view):
        xx = torch.minimum(torch.clamp(u[:, None] + ox[None], min=0), wk - 1)
        iy = yy[:, :, None].expand(-1, -1, len(ox)).reshape(len(u), -1)
        ix = xx[:, None, :].expand(-1, len(oy), -1).reshape(len(u), -1)
        meta = F.pad((lvl * 2 + view).to(torch.int32)[:, None], (0, 3))
        vals = patch_sample.sample_patches(pyr_stack, meta.contiguous(),
                                           iy.contiguous(), ix.contiguous())
        return vals.reshape(len(u), len(oy), len(ox))

    return taps(ul, ox_p, 0), taps(ur, ox_s, 1)


def match_stereo(kp_l: Keypoints, kp_r: Keypoints, pyr_stack: torch.Tensor,
                 level_hw: torch.Tensor, cam: StereoCamera,
                 cfg: OrbConfig = OrbConfig()):
    """Returns (u_right (N,), depth (N,)) float32 with -1 for unmatched.
    kp_l / kp_r are single-view Keypoints; pyr_stack / level_hw as in
    `_sample_windows`."""
    W, L = W_HALF, L_SWEEP
    dev = kp_l.xy.device
    scales = torch.tensor(cfg.scale_factors(), dtype=torch.float32, device=dev)
    oct_l = kp_l.octave.long()
    sl = scales[oct_l]
    # --- candidate gating (row band, octave band, disparity range) ---
    row_ok = (kp_l.xy[:, 1:2] - kp_r.xy[None, :, 1]).abs() <= (2.0 * sl)[:, None]
    oct_ok = (kp_l.octave[:, None] - kp_r.octave[None, :]).abs() <= 1
    max_d = cam.bf / cam.baseline
    disp = kp_l.xy[:, 0:1] - kp_r.xy[None, :, 0]
    cand = row_ok & oct_ok & (disp >= 0.0) & (disp <= max_d)
    idx, ok, _ = hamming.match_descriptors(
        kp_l.desc, kp_l.valid, kp_r.desc, kp_r.valid,
        max_dist=hamming.TH_HIGH, cand_mask=cand, mutual=False)

    # --- subpixel SAD refinement on the octave-level images ---
    inv_s = 1.0 / sl
    ul = torch.round(kp_l.xy[:, 0] * inv_s).to(torch.int32)
    vl = torch.round(kp_l.xy[:, 1] * inv_s).to(torch.int32)
    ur = torch.round(kp_r.xy[idx, 0] * inv_s).to(torch.int32)
    lvl = torch.clamp(oct_l, 0, level_hw.shape[0] - 1)
    patch, strip = _sample_windows(pyr_stack, level_hw, lvl, ul, vl, ur)
    patch_c = patch - patch[:, W, W][:, None, None]
    wins = strip.unfold(2, 2 * W + 1, 1).permute(0, 2, 1, 3)   # (n, d, 11, 11)
    wins_c = wins - wins[:, :, W, W][:, :, None, None]
    sad = (patch_c[:, None] - wins_c).abs().sum(dim=(2, 3))    # (n, 2L+1)

    best_d = torch.argmin(sad, dim=-1)
    best_c = torch.gather(sad, -1, best_d[:, None])[:, 0]
    interior = (best_d > 0) & (best_d < 2 * L)
    cm1 = torch.gather(sad, -1, torch.clamp(best_d - 1, min=0)[:, None])[:, 0]
    cp1 = torch.gather(sad, -1, torch.clamp(best_d + 1, max=2 * L)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (cm1 + cp1 - 2.0 * best_c), min=1e-6)
    delta = (cm1 - cp1) / denom
    delta = torch.clamp(torch.where(interior, delta, torch.zeros_like(delta)),
                        -1.0, 1.0)
    u_r_ref = (ur.to(torch.float32) + (best_d - L).to(torch.float32) + delta) * sl

    disparity = kp_l.xy[:, 0] - u_r_ref
    ok = ok & (disparity > 1e-3) & (disparity <= max_d)
    med = _nanmedian_of(best_c, ok)
    ok = ok & (best_c <= 2.0 * med)
    depth = torch.full_like(disparity, cam.bf) / torch.clamp(disparity, min=1e-6)
    depth = torch.where(ok, depth, torch.full_like(depth, -1.0))
    u_right = torch.where(ok, u_r_ref, torch.full_like(u_r_ref, -1.0))
    return u_right, depth
