"""Frame construction for a stereo pair, one monocular image or an RGB-D
image.

Counterpart of lldslam_tpu/frontend/frame.py (`FrameData`, `build_frame`,
`build_frame_pair`, `build_frame_mono`, `build_frame_rgbd`): the stereo
build extracts from the integer-quantized pyramid of both views and matches
them; the monocular and RGB-D builds extract from one view's float pyramid
(`orb.extract`). RGB-D samples the depth map at each keypoint and sets the
virtual right coordinate ur = u - bf / z, so the stereo pipeline applies
unchanged. `build_frame_batch` builds S stereo pairs at once (the
multi-sequence driver's frames; counterpart of
lldslam_tpu/parallel/multi_seq.py `batched_build_frame`): one pyramid, one
detection over S*2 views, one K1a and one K1b launch for the S frames;
`build_frame_pair` is its S = 1 case.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import StereoCamera
from ..ops import image, orb, stereo
from .matching import FrameFeatures


class FrameData(NamedTuple):
    """Everything tracking needs from one stereo frame (with a leading S
    for a batch of frames)."""

    feats: FrameFeatures     # left keypoints + stereo ur
    depth: torch.Tensor      # (N,) stereo depth or -1
    right: orb.Keypoints     # right keypoints (single view)

    def seq(self, i: int) -> "FrameData":
        """Frame i of a batch."""
        return FrameData(feats=FrameFeatures(*(a[i] for a in self.feats)),
                         depth=self.depth[i], right=self.right.seq(i))


def build_frame_batch(pairs: torch.Tensor, cam: StereoCamera,
                      cfg: orb.OrbConfig = orb.OrbConfig()) -> FrameData:
    """pairs (S, 2, H, W) uint8/float, S stereo pairs (left, right)
    stacked on the working device. Returns FrameData with a leading S."""
    stack = pairs.to(torch.float32)
    pyr = image.build_pyramid(stack, cfg.n_levels, cfg.scale, quantize=True)
    pyr_stack = orb.stack_levels(pyr)        # (S, L*2, H0, W0), index 2l+v
    kp = orb.extract_stack_pyr(pyr, cfg, pyr_stack=pyr_stack)
    kp_l, kp_r = kp.view_of(0), kp.view_of(1)
    level_hw = [tuple(p.shape[-2:]) for p in pyr]
    u_right, depth = stereo.match_stereo(kp_l, kp_r, pyr_stack, level_hw, cam,
                                         cfg)
    feats = FrameFeatures(xy=kp_l.xy, ur=u_right, octave=kp_l.octave,
                          angle=kp_l.angle, desc=kp_l.desc, valid=kp_l.valid)
    return FrameData(feats=feats, depth=depth, right=kp_r)


def build_frame_pair(pair: torch.Tensor, cam: StereoCamera,
                     cfg: orb.OrbConfig = orb.OrbConfig()) -> FrameData:
    """pair (2, H, W) uint8/float stacked left, right on the working
    device: `build_frame_batch` of one frame."""
    return build_frame_batch(pair[None], cam, cfg).seq(0)


def build_frame(img_l, img_r, cam: StereoCamera,
                cfg: orb.OrbConfig = orb.OrbConfig()) -> FrameData:
    """`build_frame_pair` of separate left and right (H, W) images (tensors
    on the working device, or arrays for the CPU); prefer one stacked pair
    per frame."""
    return build_frame_pair(torch.stack([torch.as_tensor(img_l),
                                         torch.as_tensor(img_r)]), cam, cfg)


def build_frame_mono(img: torch.Tensor,
                     cfg: orb.OrbConfig = orb.OrbConfig()) -> FrameData:
    """img (H, W) uint8/float on the working device: keypoints only, no
    stereo coordinate, no depth."""
    kp = orb.extract(img, cfg)
    n = kp.xy.shape[0]
    none = torch.full((n,), -1.0, device=kp.xy.device)
    feats = FrameFeatures(xy=kp.xy, ur=none, octave=kp.octave,
                          angle=kp.angle, desc=kp.desc, valid=kp.valid)
    return FrameData(feats=feats, depth=none, right=kp)


def build_frame_rgbd(img: torch.Tensor, depthmap: torch.Tensor,
                     cam: StereoCamera, cfg: orb.OrbConfig = orb.OrbConfig(),
                     depth_factor: float = 1.0) -> FrameData:
    """img (H, W) and its registered depth map (H, W) on the working device;
    depth = depthmap * depth_factor, sampled at the keypoint rounded half to
    even; 0 (no reading) leaves the keypoint monocular."""
    kp = orb.extract(img, cfg)
    dm = depthmap.to(torch.float32) * depth_factor
    h, w = dm.shape
    xi = torch.clamp(torch.round(kp.xy[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(kp.xy[:, 1]).long(), 0, h - 1)
    z = dm[yi, xi]
    has_d = (z > 0.0) & kp.valid
    none = torch.full_like(z, -1.0)
    # a tensor divided, not a scalar: `scalar / t` multiplies by 1 / t
    ur = torch.where(has_d, kp.xy[:, 0] - torch.full_like(z, cam.bf)
                     / torch.clamp(z, min=1e-6), none)
    feats = FrameFeatures(xy=kp.xy, ur=ur, octave=kp.octave, angle=kp.angle,
                          desc=kp.desc, valid=kp.valid)
    return FrameData(feats=feats, depth=torch.where(has_d, z, none), right=kp)
