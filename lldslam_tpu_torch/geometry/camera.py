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

    def K(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The 3x3 intrinsic matrix."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: StereoCamera, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel (..., 2) (u, v)."""
    z = _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: StereoCamera, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> (..., 3) (uL, v, uR) with
    uR = uL - bf/z."""
    uv = project(cam, Xc)
    ur = uv[..., 0] - cam.bf / _safe_z(Xc[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: StereoCamera, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) + depth (...,) -> camera-frame (..., 3)."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)


def disparity_to_depth(cam: StereoCamera, uL: torch.Tensor,
                       uR: torch.Tensor) -> torch.Tensor:
    """depth = bf / (uL - uR); -1 where the disparity is not above 1e-6."""
    disp = uL - uR
    ok = disp > 1e-6
    return torch.where(ok, cam.bf / torch.where(ok, disp, 1.0), -1.0)


def in_image(cam: StereoCamera, uv: torch.Tensor,
             margin: float = 0.0) -> torch.Tensor:
    """(...,) bool: the pixel lies `margin` or more inside the image."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u < cam.width - margin) & (v >= margin)
            & (v < cam.height - margin))
