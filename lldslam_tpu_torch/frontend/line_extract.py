"""Line detection types.

Counterpart of the types of lldslam_tpu/frontend/line_extract.py. The port
runs the stored-line route (`ldType: LBDFloat` with `lineDetectionsPath`,
the reference's benchmark configuration): detections come from files
(`io/stored_lines.py`), never from pixels. The JAX package's native
detector (a gradient-aligned Hough transform with LBD-style band
descriptors) is not ported; `detect_lines` raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class LineDetConfig:
    max_lines: int = 64
    rho_res: float = 2.0          # Hough distance resolution (px)
    n_phi: int = 120              # angle bins over [0, pi)
    mag_factor: float = 4.0       # edge threshold = factor * mean |grad|
    min_len: float = 25.0         # `minLineLen`
    min_support: float = 12.0     # minimum accumulated vote mass
    band_samples: int = 24        # descriptor samples along the line
    band_offsets: int = 15        # perpendicular offsets (-7..7 px)
    n_bands: int = 5
    desc_dim: int = 40            # n_bands * 8
    desc_thr: float = 0.6         # native-descriptor match gate


class KeyLines(NamedTuple):
    """Fixed-capacity 2D segments of one image."""

    p1: torch.Tensor       # (L, 2) endpoint (x, y), level-0 px
    p2: torch.Tensor       # (L, 2)
    octave: torch.Tensor   # (L,) int32
    length: torch.Tensor   # (L,)
    desc: torch.Tensor     # (L, D) float32
    valid: torch.Tensor    # (L,) bool


def detect_lines(img: torch.Tensor, cfg: LineDetConfig = LineDetConfig()):
    raise NotImplementedError(
        "the native line detector (lldslam_tpu frontend/line_extract."
        "detect_lines with its LBD descriptor) is not ported to "
        "lldslam_tpu_torch yet; use stored detections (lineDetectionsPath); "
        "see ROADMAP queue 1 item 5")
