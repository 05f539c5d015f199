"""Frame construction for one stereo pair.

Counterpart of lldslam_tpu/frontend/frame.py (`FrameData`,
`build_frame_pair`): integer-quantized pyramid of both views, batched ORB
extraction, stereo matching, and the feature set tracking consumes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import StereoCamera
from ..ops import image, orb, stereo
from .matching import FrameFeatures


class FrameData(NamedTuple):
    """Everything tracking needs from one stereo frame."""

    feats: FrameFeatures     # left keypoints + stereo ur
    depth: torch.Tensor      # (N,) stereo depth or -1
    right: orb.Keypoints     # right keypoints (single view)


def build_frame_pair(pair: torch.Tensor, cam: StereoCamera,
                     cfg: orb.OrbConfig = orb.OrbConfig()) -> FrameData:
    """pair (2, H, W) uint8/float stacked left, right on the working device."""
    stack = pair.to(torch.float32)
    pyr = image.build_pyramid(stack, cfg.n_levels, cfg.scale, quantize=True)
    pyr_stack = orb.stack_levels(pyr)            # (L*2, H0, W0), index 2l+v
    kp = orb.extract_stack_pyr(pyr, cfg, pyr_stack=pyr_stack)
    kp_l, kp_r = kp.view_of(0), kp.view_of(1)
    level_hw = torch.tensor([p.shape[-2:] for p in pyr], dtype=torch.int32,
                            device=pair.device)
    u_right, depth = stereo.match_stereo(kp_l, kp_r, pyr_stack, level_hw, cam,
                                         cfg)
    feats = FrameFeatures(xy=kp_l.xy, ur=u_right, octave=kp_l.octave,
                          angle=kp_l.angle, desc=kp_l.desc, valid=kp_l.valid)
    return FrameData(feats=feats, depth=depth, right=kp_r)
