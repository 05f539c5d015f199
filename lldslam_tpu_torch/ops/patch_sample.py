"""Batched per-keypoint patch sampling — the gather of the plain versions.

Counterpart of lldslam_tpu/ops/patch_sample.py (the Pallas kernel
`sample_patches`). Same contract minus the Mosaic preconditions:

    vals[i, s] = img[meta[i, 0], meta[i, 1] + iy[i, s], meta[i, 2] + ix[i, s]]

with reads clamped into the image. On the card its consumers are fused
kernels that compute their taps themselves (K1a `ops/orb_describe.py`, K1b
`ops/stereo_sad.py`); their plain versions read their taps through this
function.
"""
from __future__ import annotations

import torch


def sample_patches_plain(img: torch.Tensor, meta: torch.Tensor,
                         iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Advanced-indexing gather: vals (n, S) float32 from img (V, H, W);
    meta (n, 4) [image, row0, col0, unused]; iy, ix (n, S) offsets."""
    V, H, W = img.shape
    v = meta[:, 0].long().clamp(0, V - 1)[:, None]
    y = (meta[:, 1:2].long() + iy.long()).clamp(0, H - 1)
    x = (meta[:, 2:3].long() + ix.long()).clamp(0, W - 1)
    return img[v, y, x].to(torch.float32)
