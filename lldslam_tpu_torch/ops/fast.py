"""FAST-9/16 corner scoring as a dense map, and 3x3 non-maximum suppression.

Counterpart of lldslam_tpu/ops/fast.py: the score of every pixel is the
largest threshold at which it is still a FAST-9 corner (max over contiguous
9-arcs of the min absolute difference on the qualifying side), computed with
16 shifted images and log-depth circular window minima. Integer-valued
images give exact scores. Both functions take (..., H, W).
"""
from __future__ import annotations

import torch

# Bresenham circle radius 3, 16 points in circular order, (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[y+dy, x+dx] with wrap (borders are masked by callers)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _arc9_min(d: torch.Tensor) -> torch.Tensor:
    w2 = torch.minimum(d, torch.roll(d, -1, dims=0))
    w4 = torch.minimum(w2, torch.roll(w2, -2, dims=0))
    w8 = torch.minimum(w4, torch.roll(w4, -4, dims=0))
    w9 = torch.minimum(w8, torch.roll(d, -8, dims=0))
    return w9.max(dim=0).values


def fast_score_map(img: torch.Tensor, threshold: float = 7.0) -> torch.Tensor:
    """(..., H, W) float32 -> FAST-9 score, 0 where not a corner; the 3-px
    border is zeroed."""
    diffs = torch.stack([_shift2d(img, dy, dx) - img for dy, dx in CIRCLE])
    score = torch.maximum(_arc9_min(diffs), _arc9_min(-diffs))
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    h, w = img.shape[-2:]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(inside, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 NMS with the scan-order plateau tie-break: a pixel survives iff it
    is strictly greater than every earlier neighbour and >= every later one."""
    earlier = [(-1, -1), (-1, 0), (-1, 1), (0, -1)]
    later = [(0, 1), (1, -1), (1, 0), (1, 1)]
    max_e = torch.stack([_shift2d(score, dy, dx) for dy, dx in earlier]).amax(0)
    max_l = torch.stack([_shift2d(score, dy, dx) for dy, dx in later]).amax(0)
    keep = (score > max_e) & (score >= max_l)
    return torch.where(keep, score, torch.zeros_like(score))
