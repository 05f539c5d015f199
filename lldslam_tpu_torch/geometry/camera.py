"""Pinhole + rectified-stereo camera model, batched.

Counterpart of lldslam_tpu/geometry/camera.py. A `StereoCamera` is a
NamedTuple of Python scalars; every function broadcasts over leading batch
dims of the point tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class StereoCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx
    width: int
    height: int

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: StereoCamera, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel (..., 2) (u, v)."""
    z = _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def backproject(cam: StereoCamera, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) + depth (...,) -> camera-frame (..., 3)."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)
