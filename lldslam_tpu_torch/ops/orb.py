"""Batched ORB keypoint extraction: pyramid FAST + orientation + rotated BRIEF.

Counterpart of lldslam_tpu/ops/orb.py (`extract_stack_pyr` and helpers):
dense FAST score maps per level, per-cell top-k then per-level top-n
selection, intensity-centroid orientation over the radius-15 circular patch,
and rotated BRIEF-256 on the 7x7 blurred level packed into 8 int32 words.

The two gathers of the frame build go through K1 (ops/patch_sample.py), one
launch per consumer over a padded stack of every pyramid level of both views
(`stack_levels`): the orientation moments (the JAX package computes them as
dense prefix-sum maps; summing the 31x31 circular patch at each keypoint
gives the same integers with one gather) and the 512 BRIEF taps.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast, hamming, image, patch_sample

EDGE_MARGIN = 16  # detection border, EDGE_THRESHOLD-3



@functools.cache
def _pattern() -> np.ndarray:
    """The rotated-BRIEF point pairs (256, 2, 2): this package's copy of
    lldslam_tpu/ops/orb_pattern.npy, read at first use."""
    return np.load(Path(__file__).parent / "orb_pattern.npy")


def _umax_mask() -> np.ndarray:
    """31x31 boolean mask of the IC_Angle circular patch (the reference's
    umax table)."""
    HALF = 15
    umax = np.zeros(HALF + 2, dtype=np.int32)
    vmax = int(math.floor(HALF * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(HALF * HALF - v * v)))
    v0 = 0
    for v in range(HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    ys, xs = np.mgrid[-HALF: HALF + 1, -HALF: HALF + 1]
    return np.abs(xs) <= umax[np.abs(ys)]


_IC_MASK = _umax_mask()                                   # (31, 31) bool
_IC_DY, _IC_DX = (np.nonzero(_IC_MASK)[0] - 15, np.nonzero(_IC_MASK)[1] - 15)


@dataclass(frozen=True)
class OrbConfig:
    """ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}."""

    n_features: int = 2000
    n_levels: int = 8
    scale: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 30          # detection cell size in px
    cell_k: int = 4         # candidates kept per cell before global top-n

    def per_level_budget(self):
        """Geometric split of n_features over levels."""
        factor = 1.0 / self.scale
        n0 = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        out = []
        acc = 0
        for l in range(self.n_levels - 1):
            n = int(round(n0 * factor**l))
            out.append(n)
            acc += n
        out.append(max(self.n_features - acc, 0))
        return out

    def scale_factors(self):
        return [self.scale**l for l in range(self.n_levels)]

    @property
    def max_kp(self) -> int:
        total = sum(self.per_level_budget())
        return ((total + 127) // 128) * 128


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set with a leading view dim (V, N, ...);
    invalid slots are masked by `valid`, coords are level-0 pixels."""

    xy: torch.Tensor        # (V, N, 2) float32 (x, y)
    response: torch.Tensor  # (V, N) float32
    octave: torch.Tensor    # (V, N) int32
    angle: torch.Tensor     # (V, N) float32 radians
    desc: torch.Tensor      # (V, N, 8) int32 packed 256-bit BRIEF
    valid: torch.Tensor     # (V, N) bool

    def view_of(self, v: int) -> "Keypoints":
        return Keypoints(*(a[v] for a in self))


def stack_levels(levels) -> torch.Tensor:
    """List of L (V, h_l, w_l) images -> one zero-padded (L*V, H0, W0)
    stack; image index of (level l, view v) is l*V + v."""
    H0, W0 = levels[0].shape[-2:]
    return torch.cat([F.pad(p, (0, W0 - p.shape[-1], 0, H0 - p.shape[-2]))
                      for p in levels])


def _select_level_keypoints(score: torch.Tensor, n_out: int, cfg: OrbConfig):
    """Spatially uniform selection for (V, h, w) score maps: per-cell top-k
    (k ~ budget/cells) then per-level top-n. Two-tier FAST threshold: in a
    cell holding any corner stronger than ini_th, weaker ones are dropped.
    Returns (xy int64 (V, n_out, 2), score (V, n_out)); zero-score slots are
    invalid."""
    V, h, w = score.shape
    c = cfg.cell
    ch, cw = -(-h // c), -(-w // c)
    pad = F.pad(score, (0, cw * c - w, 0, ch * c - h))
    cells = pad.reshape(V, ch, c, cw, c).permute(0, 1, 3, 2, 4) \
        .reshape(V, ch, cw, c * c)
    if cfg.ini_th > cfg.min_th:
        strong = cells.amax(dim=-1, keepdim=True) > cfg.ini_th
        cells = torch.where(strong & (cells <= cfg.ini_th),
                            torch.zeros_like(cells), cells)
    k = min(max(1, -(-n_out // (ch * cw))) + 1, cfg.cell_k, c * c)
    vs, ids = [], []
    rest = cells.clone()
    for _ in range(k):
        a = torch.argmax(rest, dim=-1, keepdim=True)      # first max
        vs.append(torch.gather(rest, -1, a)[..., 0])
        ids.append(a[..., 0])
        rest.scatter_(-1, a, float("-inf"))
    cell_scores = torch.stack(vs, dim=-1)                  # (V, ch, cw, k)
    cell_idx = torch.stack(ids, dim=-1)
    cy = torch.arange(ch, device=score.device)[:, None, None]
    cx = torch.arange(cw, device=score.device)[None, :, None]
    ys = (cy * c + cell_idx // c).reshape(V, -1)
    xs = (cx * c + cell_idx % c).reshape(V, -1)
    flat_s = cell_scores.reshape(V, -1)
    n = min(n_out, flat_s.shape[-1])
    top_i = hamming._topk_stable(flat_s, n)                # lax.top_k ties
    top_s = torch.gather(flat_s, -1, top_i)
    xy = torch.stack([torch.gather(xs, -1, top_i),
                      torch.gather(ys, -1, top_i)], dim=-1)
    if n < n_out:
        xy = F.pad(xy, (0, 0, 0, n_out - n))
        top_s = F.pad(top_s, (0, n_out - n))
    return xy, top_s


def _ic_angle_stack(img_stack: torch.Tensor, xy: torch.Tensor,
                    img_idx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (IC_Angle) of keypoints spread over an
    image stack: xy (n, 2) integer level coords, img_idx (n,). Moments
    m10 = sum dx*I, m01 = sum dy*I over the radius-15 circular patch, read
    with one K1 gather. Integer images keep both sums exact in float32
    (|m| < 2^24), equal to the JAX package's int32 prefix-sum maps (whose
    -128 intensity shift cancels over the symmetric patch). Returns (n,)
    radians."""
    dev = img_stack.device
    dy = torch.from_numpy(_IC_DY.astype(np.int32)).to(dev)
    dx = torch.from_numpy(_IC_DX.astype(np.int32)).to(dev)
    n = xy.shape[0]
    iy = (xy[:, 1:2].to(torch.int32) + dy[None, :]).contiguous()
    ix = (xy[:, 0:1].to(torch.int32) + dx[None, :]).contiguous()
    meta = F.pad(img_idx.to(torch.int32)[:, None], (0, 3)).contiguous()
    vals = patch_sample.sample_patches(img_stack, meta, iy, ix)   # (n, S)
    m10 = (vals * dx.to(torch.float32)).sum(dim=-1)
    m01 = (vals * dy.to(torch.float32)).sum(dim=-1)
    return torch.atan2(m01, m10).reshape(n)


def _ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC_Angle for one (h, w) image; xy (n, 2) integer level coords."""
    idx = torch.zeros(xy.shape[0], dtype=torch.int32, device=img.device)
    return _ic_angle_stack(img[None].contiguous(), xy, idx)


def _rotated_taps(xy: torch.Tensor, angle: torch.Tensor, h, w):
    """Rotated-BRIEF tap coordinates (GET_VALUE): (gy, gx) each
    (n, 256, 2) int32, clipped into the image. h, w are ints or per-keypoint
    (n,) tensors."""
    pat = torch.from_numpy(_pattern().astype(np.float32)).to(xy.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    rx = torch.round(px * ca[:, None, None] - py * sa[:, None, None]).to(torch.int32)
    ry = torch.round(px * sa[:, None, None] + py * ca[:, None, None]).to(torch.int32)
    if not torch.is_tensor(h):
        h = torch.full((xy.shape[0],), h, dtype=torch.int32, device=xy.device)
        w = torch.full((xy.shape[0],), w, dtype=torch.int32, device=xy.device)
    gx = torch.minimum(torch.clamp(xy[:, None, None, 0].to(torch.int32) + rx, min=0),
                       (w - 1)[:, None, None])
    gy = torch.minimum(torch.clamp(xy[:, None, None, 1].to(torch.int32) + ry, min=0),
                       (h - 1)[:, None, None])
    return gy, gx


def _brief_desc_stack(blur_stack: torch.Tensor, xy: torch.Tensor,
                      img_idx: torch.Tensor, angle: torch.Tensor, h, w):
    """Rotated BRIEF-256 for keypoints spread over a stack of blurred level
    images, the 512 taps (256 'a' then 256 'b') read with one K1 gather.
    Returns (n, 8) int32."""
    gy, gx = _rotated_taps(xy, angle, h, w)
    iy = torch.cat([gy[:, :, 0], gy[:, :, 1]], dim=1).contiguous()
    ix = torch.cat([gx[:, :, 0], gx[:, :, 1]], dim=1).contiguous()
    meta = F.pad(img_idx.to(torch.int32)[:, None], (0, 3)).contiguous()
    vals = patch_sample.sample_patches(blur_stack, meta, iy, ix)
    return hamming.pack_bits(vals[:, :256] < vals[:, 256:])


def extract_stack_pyr(pyr, cfg: OrbConfig = OrbConfig(),
                      pyr_stack: torch.Tensor | None = None) -> Keypoints:
    """ORB extraction for a stack of same-shape views per level (pyr: list of
    (V, h_l, w_l) float32 integer-valued levels; V=2 for a stereo pair).
    `pyr_stack` optionally passes `stack_levels(pyr)` when the caller already
    built it. Returns Keypoints with leading dim V."""
    V = pyr[0].shape[0]
    dev = pyr[0].device
    budgets = cfg.per_level_budget()
    scales = cfg.scale_factors()
    xy_l, resp, octv, blurs, hs, ws = [], [], [], [], [], []
    for l, (im_l, n_l) in enumerate(zip(pyr, budgets)):
        h, w = im_l.shape[-2:]
        score = fast.nms3x3(fast.fast_score_map(im_l, cfg.min_th))
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        inside = ((ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN)
                  & (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN))
        score = torch.where(inside, score, torch.zeros_like(score))
        xy, r = _select_level_keypoints(score, n_l, cfg)
        xy_l.append(xy)
        resp.append(r)
        octv.append(torch.full((V, n_l), l, dtype=torch.int32, device=dev))
        hs.append(torch.full((V, n_l), h, dtype=torch.int32, device=dev))
        ws.append(torch.full((V, n_l), w, dtype=torch.int32, device=dev))
        # the oracle blurs uint8 -> uint8: integer rounding gives bit-exact
        # BRIEF comparisons
        blurs.append(torch.round(image.gaussian_blur(im_l)))
    # per-keypoint image index into the (L*V, H0, W0) stacks: l*V + v
    octave = torch.cat(octv, dim=1)
    img_idx = (octave * V + torch.arange(V, device=dev, dtype=torch.int32)[:, None])
    xy_lvl = torch.cat(xy_l, dim=1).reshape(-1, 2)
    flat_idx = img_idx.reshape(-1)
    if pyr_stack is None:
        pyr_stack = stack_levels(pyr)
    angle = _ic_angle_stack(pyr_stack, xy_lvl, flat_idx)
    desc = _brief_desc_stack(stack_levels(blurs), xy_lvl, flat_idx, angle,
                             torch.cat(hs, dim=1).reshape(-1),
                             torch.cat(ws, dim=1).reshape(-1))
    resp = torch.cat(resp, dim=1)
    scale_kp = torch.tensor(scales, dtype=torch.float32, device=dev)[octave.long()]
    xy0 = torch.cat(xy_l, dim=1).to(torch.float32) * scale_kp[..., None]
    n = xy0.shape[1]
    kp = Keypoints(xy0, resp, octave, angle.reshape(V, n),
                   desc.reshape(V, n, 8), resp > 0)
    cap = cfg.max_kp
    if n < cap:
        kp = Keypoints(*(F.pad(a, (0, 0) * (a.dim() - 2) + (0, cap - n))
                         for a in kp))
    return kp
