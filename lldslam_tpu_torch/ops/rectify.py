"""Stereo undistortion and rectification.

Counterpart of lldslam_tpu/ops/rectify.py, for the EuRoC example's
LEFT.* / RIGHT.* K, D, R, P blocks: the inverse maps are computed once on the
host (numpy, radial-tangential distortion), and each frame is remapped on
the device by a bilinear gather with BORDER_CONSTANT. The JAX package has no
Pallas kernel here (an XLA gather), so the remap is PyTorch ops.
"""
from __future__ import annotations

import numpy as np
import torch


def make_rectify_maps(K, D, R, P, size):
    """Inverse rectification maps. K (3, 3) intrinsics, D (k1, k2, p1, p2
    [, k3]) distortion, R (3, 3) rectifying rotation, P (3, 4 or 3, 3) new
    projection, size (w, h). Returns (map_x, map_y) float32 (h, w): the
    source pixel of each rectified pixel."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    k1, k2 = D[0], D[1]
    p1, p2 = (D[2], D[3]) if len(D) >= 4 else (0.0, 0.0)
    k3 = D[4] if len(D) >= 5 else 0.0
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    w, h = size
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    ray = np.stack([x, y, np.ones_like(x)], -1) @ np.linalg.inv(R).T
    xn = ray[..., 0] / ray[..., 2]
    yn = ray[..., 1] / ray[..., 2]
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap(img: torch.Tensor, map_x: torch.Tensor,
          map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of img (h, w) by the maps (H, W), float32 out; the
    sample position is clamped to [0, w - 1.001] x [0, h - 1.001], and a
    pixel whose map falls outside the source is 0 (BORDER_CONSTANT)."""
    img = img.to(torch.float32)
    h, w = img.shape
    x = torch.clamp(map_x, 0.0, w - 1.001)
    y = torch.clamp(map_y, 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    dx = x - x0
    dy = y - y0
    out = ((1 - dy) * (1 - dx) * img[y0, x0] + (1 - dy) * dx * img[y0, x0 + 1]
           + dy * (1 - dx) * img[y0 + 1, x0] + dy * dx * img[y0 + 1, x0 + 1])
    inside = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    return torch.where(inside, out, torch.zeros_like(out))


class StereoRectifier:
    """Per-sequence rectifier built from the EuRoC settings blocks (the
    dict of config.parse_opencv_yaml); the maps live on `device`."""

    def __init__(self, cfg_dict: dict, device="cuda"):
        def mat(key):
            rows, cols, vals = cfg_dict[key]
            return np.asarray(vals, np.float64).reshape(rows, cols)

        def maps(side):
            m = make_rectify_maps(
                mat(f"{side}.K"), mat(f"{side}.D"), mat(f"{side}.R"),
                mat(f"{side}.P"), (int(cfg_dict[f"{side}.width"]),
                                   int(cfg_dict[f"{side}.height"])))
            return tuple(torch.from_numpy(a).to(device) for a in m)

        self.device = torch.device(device)
        self.maps_l = maps("LEFT")
        self.maps_r = maps("RIGHT")

    def __call__(self, img_l, img_r):
        """Raw (h, w) images (numpy or tensors) -> the rectified pair as
        float32 tensors on the device."""
        t = lambda a: torch.as_tensor(a, device=self.device)
        return (remap(t(img_l), *self.maps_l), remap(t(img_r), *self.maps_r))
