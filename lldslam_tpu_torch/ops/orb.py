"""Batched ORB keypoint extraction: pyramid FAST + orientation + rotated BRIEF.

Counterpart of lldslam_tpu/ops/orb.py (`extract_stack_pyr` for a stereo
pair, `extract` / `extract_pyr` for one view, and helpers): dense FAST score
maps per level, per-cell top-k then per-level top-n selection,
intensity-centroid orientation over the radius-15 circular patch, and
rotated BRIEF-256 on the 7x7 blurred level packed into 8 int32 words.

Orientation and descriptor are one launch of K1a (ops/orb_describe.py) over
padded stacks of every pyramid level of every view (`stack_levels`): the
orientation moments (the JAX package computes them as dense prefix-sum maps;
summing the 31x31 circular patch at each keypoint gives the same integers)
and the 512 BRIEF taps, compared and packed in the kernel. K1a reads
integer-valued stacks: the stereo pair's quantized pyramid as it is; for one
view the JAX package detects on the float pyramid and rounds only inside
the orientation and the blur, so `extract_pyr` gives K1a round(level) and
round(blur(level)). A batch of frames (the multi-sequence driver's S stereo
pairs) rides the leading axes: levels (S, V, h, w) are detected as S*V
views and described by one K1a launch over the (S, L*V, H0, W0) stacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import consts, fast, hamming, image, orb_describe

EDGE_MARGIN = 16  # detection border, EDGE_THRESHOLD-3


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
    """Fixed-capacity keypoint set with a view dim (V, N, ...), after any
    batch dims; invalid slots are masked by `valid`, coords are level-0
    pixels."""

    xy: torch.Tensor        # (V, N, 2) float32 (x, y)
    response: torch.Tensor  # (V, N) float32
    octave: torch.Tensor    # (V, N) int32
    angle: torch.Tensor     # (V, N) float32 radians
    desc: torch.Tensor      # (V, N, 8) int32 packed 256-bit BRIEF
    valid: torch.Tensor     # (V, N) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def view_of(self, v: int) -> "Keypoints":
        """View v (the axis before the keypoints), batch dims kept."""
        axis = self.valid.dim() - 2
        return Keypoints(*(a.select(axis, v) for a in self))

    def seq(self, i: int) -> "Keypoints":
        """Entry i of the leading batch axis."""
        return Keypoints(*(a[i] for a in self))


def stack_levels(levels) -> torch.Tensor:
    """List of L (..., V, h_l, w_l) images -> one zero-padded
    (..., L*V, H0, W0) stack; image index of (level l, view v) is
    l*V + v."""
    H0, W0 = levels[0].shape[-2:]
    return torch.cat([F.pad(p, (0, W0 - p.shape[-1], 0, H0 - p.shape[-2]))
                      for p in levels], dim=-3)


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


def _ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC_Angle for one (h, w) image; xy (n, 2) integer level coords (the
    plain moments of K1a)."""
    idx = torch.zeros(xy.shape[0], dtype=torch.int32, device=img.device)
    return orb_describe.ic_angle_plain(img[None].contiguous(), xy, idx)


def detect_level(im_l: torch.Tensor, n_l: int, cfg: OrbConfig):
    """One level's share of `extract_stack_pyr`: FAST, NMS and the
    selection of n_l keypoints on (..., V, h, w), and round(blur(level)),
    which BRIEF reads. Returns (xy (..., V, n_l, 2), response (..., V,
    n_l), the rounded blur)."""
    lead = im_l.shape[:-2]
    dev = im_l.device
    h, w = im_l.shape[-2:]
    score = fast.nms3x3(fast.fast_score_map(im_l, cfg.min_th))
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = ((ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN)
              & (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN))
    score = torch.where(inside, score, torch.zeros_like(score))
    xy, r = _select_level_keypoints(score.reshape(-1, h, w), n_l, cfg)
    # the oracle blurs uint8 -> uint8: integer rounding gives bit-exact
    # BRIEF comparisons
    return (xy.reshape(*lead, n_l, 2), r.reshape(*lead, n_l),
            torch.round(image.gaussian_blur(im_l)))


def describe_levels(pyr, levels, cfg: OrbConfig,
                    pyr_stack: torch.Tensor) -> Keypoints:
    """The rest of `extract_stack_pyr` once every level is detected
    (`levels`: detect_level's output per level): orientation and BRIEF
    (K1a) of every keypoint, level coordinates scaled to level 0, the
    keypoint axis padded to cfg.max_kp."""
    lead = tuple(pyr[0].shape[:-3])
    V = pyr[0].shape[-3]
    dev = pyr[0].device
    xy_l, resp, blurs = zip(*levels)
    # per-keypoint image index into the (L*V, H0, W0) stacks: l*V + v
    octave = torch.cat([torch.full(lead + (V, r.shape[-1]), l,
                                   dtype=torch.int32, device=dev)
                        for l, r in enumerate(resp)], dim=-1)
    img_idx = (octave * V + torch.arange(V, device=dev, dtype=torch.int32)[:, None])
    xy_lvl = torch.cat(xy_l, dim=-2)
    image_hw = [tuple(p.shape[-2:]) for p in pyr for _ in range(V)]
    angle, desc = orb_describe.describe(
        pyr_stack, stack_levels(list(blurs)),
        xy_lvl.reshape(*lead, -1, 2).to(torch.int32),
        img_idx.reshape(*lead, -1), image_hw)
    resp = torch.cat(resp, dim=-1)
    scale_kp = consts.table(tuple(cfg.scale_factors()), torch.float32,
                            dev)[octave.long()]
    xy0 = xy_lvl.to(torch.float32) * scale_kp[..., None]
    n = xy0.shape[-2]
    kp = Keypoints(xy0, resp, octave, angle.reshape(*lead, V, n),
                   desc.reshape(*lead, V, n, 8), resp > 0)
    cap = cfg.max_kp
    if n < cap:
        # pad the keypoint axis (the one after the view axis)
        kp = Keypoints(*(F.pad(a, (0, 0) * (a.dim() - resp.dim())
                               + (0, cap - n)) for a in kp))
    return kp


def extract_stack_pyr(pyr, cfg: OrbConfig = OrbConfig(),
                      pyr_stack: torch.Tensor | None = None) -> Keypoints:
    """ORB extraction for a stack of same-shape views per level (pyr: list of
    (..., V, h_l, w_l) float32 levels; V=2 for a stereo pair, leading dims
    a batch of frames). FAST, NMS and selection run on `pyr`, BRIEF on
    round(blur(level)); the orientation reads `pyr_stack`, the
    integer-valued levels stacked, by default `stack_levels(pyr)` (a
    quantized pyramid). Returns Keypoints with dims (..., V)."""
    levels = [detect_level(im_l, n_l, cfg)
              for im_l, n_l in zip(pyr, cfg.per_level_budget())]
    if pyr_stack is None:
        pyr_stack = stack_levels(pyr)
    return describe_levels(pyr, levels, cfg, pyr_stack)


def extract_pyr(pyr, cfg: OrbConfig = OrbConfig()) -> Keypoints:
    """ORB extraction for one view from its float32 pyramid (list of
    (h_l, w_l) levels, not quantized), as the JAX package's single-view
    `extract_pyr`: detection on the float levels, the orientation on
    round(level). Returns Keypoints without the view dim."""
    views = [p[None] for p in pyr]
    return extract_stack_pyr(
        views, cfg, pyr_stack=stack_levels([torch.round(p) for p in views])
    ).view_of(0)


def extract(img: torch.Tensor, cfg: OrbConfig = OrbConfig()) -> Keypoints:
    """Full ORB extraction for one grayscale (H, W) image."""
    return extract_pyr(image.build_pyramid(img.to(torch.float32),
                                           cfg.n_levels, cfg.scale), cfg)
