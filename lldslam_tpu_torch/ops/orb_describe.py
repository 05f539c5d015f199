"""K1a: fused ORB describe (IC angle + rotated BRIEF-256) — CUDA kernel +
plain version.

Replaces, for the orientation and descriptor gathers of the frame build, the
Pallas kernel `sample_patches` of lldslam_tpu/ops/patch_sample.py and the
XLA ops the JAX package runs around it (lldslam_tpu/ops/orb.py `_ic_angle`,
`_brief_desc_stack`). For keypoints spread over a stack of pyramid levels of
both views it returns

    angle (n,) float32   atan2(m01, m10), moments m10 = sum dx*I and
                         m01 = sum dy*I over the radius-15 circular patch
    desc  (n, 8) int32   rotated BRIEF-256 on the blurred level, packed as
                         hamming.pack_bits (bit k of word w is pair 32w + k)

The kernel source is `lldslam_tpu_torch/csrc/orb_describe.cu`; a CUDA tensor
always goes to it, a CPU tensor to `describe_plain`, the gather chain that
`sample_patches_plain` feeds. The images must be integer-valued (the
quantized pyramid and the rounded blur): the moments are then exact integers
below 2^24 in float32, equal to the JAX package's int32 prefix-sum maps
(whose -128 intensity shift cancels over the symmetric patch).

The stacks and keypoint arrays may carry a leading sequence axis S (the
multi-sequence driver's S frames, one launch for all of them; the level
shapes are shared); without it the call is the S = 1 case.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import consts, cuda_build, hamming, patch_sample

IC_HALF = 15
# launches of the CUDA kernel (incremented where the kernel is launched)
launches = 0


@functools.cache
def _pattern() -> np.ndarray:
    """The rotated-BRIEF point pairs (256, 2, 2) [pair][a, b][x, y]: this
    package's copy of lldslam_tpu/ops/orb_pattern.npy, read at first use."""
    return np.load(Path(__file__).parent / "orb_pattern.npy")


def umax_table() -> np.ndarray:
    """Half-width of each row |dy| = 0..15 of the IC_Angle circular patch
    (the reference's umax table)."""
    umax = np.zeros(IC_HALF + 2, dtype=np.int32)
    vmax = int(math.floor(IC_HALF * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(IC_HALF * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(IC_HALF * IC_HALF - v * v)))
    v0 = 0
    for v in range(IC_HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:IC_HALF + 1]


def _ic_offsets() -> tuple[tuple, tuple]:
    """(dy, dx) of the 749 pixels of the circular patch, row-major."""
    ys, xs = np.mgrid[-IC_HALF: IC_HALF + 1, -IC_HALF: IC_HALF + 1]
    inside = np.abs(xs) <= umax_table()[np.abs(ys)]
    return tuple(ys[inside].tolist()), tuple(xs[inside].tolist())


IC_DY, IC_DX = _ic_offsets()


def _meta(img_idx: torch.Tensor) -> torch.Tensor:
    """The gather's (n, 4) [image, 0, 0, 0] rows."""
    return F.pad(img_idx.to(torch.int32)[:, None], (0, 3)).contiguous()


def ic_angle_plain(img_stack: torch.Tensor, xy: torch.Tensor,
                   img_idx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (IC_Angle) of keypoints spread over
    an image stack: xy (n, 2) integer level coords, img_idx (n,). Returns
    (n,) radians."""
    dev = img_stack.device
    dy = consts.table(IC_DY, torch.int32, dev)
    dx = consts.table(IC_DX, torch.int32, dev)
    iy = (xy[:, 1:2].to(torch.int32) + dy[None, :]).contiguous()
    ix = (xy[:, 0:1].to(torch.int32) + dx[None, :]).contiguous()
    vals = patch_sample.sample_patches_plain(img_stack, _meta(img_idx), iy, ix)
    m10 = (vals * dx.to(torch.float32)).sum(dim=-1)
    m01 = (vals * dy.to(torch.float32)).sum(dim=-1)
    return torch.atan2(m01, m10).reshape(xy.shape[0])


def rotated_taps(xy: torch.Tensor, angle: torch.Tensor, h: torch.Tensor,
                 w: torch.Tensor):
    """Rotated-BRIEF tap coordinates (GET_VALUE): (gy, gx) each
    (n, 256, 2) int32, clipped into each keypoint's (h, w) level image."""
    pat = consts.table(tuple(_pattern().reshape(-1).tolist()), torch.float32,
                       xy.device).reshape(256, 2, 2)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    rx = torch.round(px * ca[:, None, None] - py * sa[:, None, None]).to(torch.int32)
    ry = torch.round(px * sa[:, None, None] + py * ca[:, None, None]).to(torch.int32)
    gx = torch.minimum(torch.clamp(xy[:, None, None, 0].to(torch.int32) + rx, min=0),
                       (w - 1)[:, None, None])
    gy = torch.minimum(torch.clamp(xy[:, None, None, 1].to(torch.int32) + ry, min=0),
                       (h - 1)[:, None, None])
    return gy, gx


def brief_plain(blur_stack: torch.Tensor, xy: torch.Tensor,
                img_idx: torch.Tensor, angle: torch.Tensor, h: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 for keypoints spread over a stack of blurred level
    images, the 512 taps (256 'a' then 256 'b') read with one gather; h, w
    (n,) level shapes. Returns (n, 8) int32."""
    gy, gx = rotated_taps(xy, angle, h, w)
    iy = torch.cat([gy[:, :, 0], gy[:, :, 1]], dim=1).contiguous()
    ix = torch.cat([gx[:, :, 0], gx[:, :, 1]], dim=1).contiguous()
    vals = patch_sample.sample_patches_plain(blur_stack, _meta(img_idx), iy, ix)
    return hamming.pack_bits(vals[:, :256] < vals[:, 256:])


def describe_plain(pyr_stack: torch.Tensor, blur_stack: torch.Tensor,
                   xy: torch.Tensor, img_idx: torch.Tensor,
                   image_hw: Sequence[tuple[int, int]]):
    """The plain version of the kernel: `ic_angle_plain` then
    `brief_plain`. Returns (angle (..., n) float32, desc (..., n, 8)
    int32). With a leading S the S stacks are gathered as one stack of S*I
    images, each keypoint's index offset into its own frame's images."""
    dev = pyr_stack.device
    I, H, W = pyr_stack.shape[-3:]
    lead = xy.shape[:-2]
    seq = torch.arange(math.prod(lead), dtype=torch.int32,
                       device=dev).reshape(*lead, 1)
    img_idx = (img_idx + seq * I).reshape(-1)
    xy = xy.reshape(-1, 2)
    pyr_stack, blur_stack = (t.reshape(-1, H, W) for t in (pyr_stack,
                                                           blur_stack))
    hs = consts.table(tuple(h for h, _ in image_hw), torch.int32, dev)
    ws = consts.table(tuple(w for _, w in image_hw), torch.int32, dev)
    lvl = img_idx.long() % I
    angle = ic_angle_plain(pyr_stack, xy, img_idx)
    desc = brief_plain(blur_stack, xy, img_idx, angle, hs[lvl], ws[lvl])
    return angle.reshape(*lead, -1), desc.reshape(*lead, -1, 8)


def describe(pyr_stack: torch.Tensor, blur_stack: torch.Tensor,
             xy: torch.Tensor, img_idx: torch.Tensor,
             image_hw: Sequence[tuple[int, int]]):
    """pyr_stack, blur_stack (S, I, H, W) float32 stacks of
    integer-valued level images (zero-padded to level 0's shape); xy (S, n,
    2) int32 level coords; img_idx (S, n) int32 image of each keypoint in
    its own frame's stack; image_hw the I level shapes (h, w) as host ints,
    shared by the S frames. Returns (angle (S, n) float32, desc (S, n, 8)
    int32); without the leading S every shape drops it (S = 1). One launch
    for all S, counted once."""
    if pyr_stack.device.type != "cuda":
        return describe_plain(pyr_stack, blur_stack, xy, img_idx, image_hw)
    global launches
    lead = tuple(xy.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"xy must be (n, 2) or (S, n, 2), got "
                         f"{tuple(xy.shape)}")
    S = lead[0] if lead else 1
    n = xy.shape[-2]
    I, H, W = pyr_stack.shape[-3:]
    for name, t in (("pyr_stack", pyr_stack), ("blur_stack", blur_stack)):
        if t.dtype != torch.float32 or tuple(t.shape) != lead + (I, H, W):
            raise ValueError(f"{name} must be float32 {lead + (I, H, W)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 1 <= S <= 65535:
        raise ValueError(f"K1a takes 1 to 65535 frames, got {S}")
    for name, t, shape in (("xy", xy, lead + (n, 2)),
                           ("img_idx", img_idx, lead + (n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if len(image_hw) != I or not 1 <= I <= 64:
        raise ValueError(f"image_hw must give the shapes of the {I} images "
                         f"(at most 64), got {len(image_hw)}")
    for t in (pyr_stack, blur_stack, xy, img_idx):
        if t.device != pyr_stack.device or not t.is_contiguous():
            raise ValueError("K1a inputs must be contiguous on one CUDA device")
    hs = (ctypes.c_int * I)(*(int(h) for h, _ in image_hw))
    ws = (ctypes.c_int * I)(*(int(w) for _, w in image_hw))
    angle = torch.empty(lead + (n,), dtype=torch.float32, device=xy.device)
    desc = torch.empty(lead + (n, 8), dtype=torch.int32, device=xy.device)
    p = cuda_build.ptr
    cuda_build.launch(
        "lld_orb_describe", "K1a orb_describe launch", xy.device,
        p(pyr_stack), p(blur_stack), S, I, H, W, hs, ws, p(xy), p(img_idx),
        n, p(angle), p(desc))
    launches += 1
    return angle, desc
