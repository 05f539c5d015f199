"""K1: batched per-keypoint patch sampling — CUDA kernel + plain version.

Counterpart of lldslam_tpu/ops/patch_sample.py (the Pallas kernel
`sample_patches`). Same contract minus the Mosaic preconditions:

    vals[i, s] = img[meta[i, 0], meta[i, 1] + iy[i, s], meta[i, 2] + ix[i, s]]

with reads clamped into the image. The kernel source is
`lldslam_tpu_torch/csrc/patch_sample.cu`; a CUDA tensor always goes to it, a
CPU tensor to `sample_patches_plain`.
"""
from __future__ import annotations

import torch

from . import cuda_build

# launches of the CUDA kernel (incremented where the kernel is launched)
launches = 0


def sample_patches_plain(img: torch.Tensor, meta: torch.Tensor,
                         iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Advanced-indexing version of the kernel (the CPU path)."""
    V, H, W = img.shape
    v = meta[:, 0].long().clamp(0, V - 1)[:, None]
    y = (meta[:, 1:2].long() + iy.long()).clamp(0, H - 1)
    x = (meta[:, 2:3].long() + ix.long()).clamp(0, W - 1)
    return img[v, y, x].to(torch.float32)


def sample_patches(img: torch.Tensor, meta: torch.Tensor, iy: torch.Tensor,
                   ix: torch.Tensor) -> torch.Tensor:
    """vals (n, S) float32. img (V, H, W) uint8 or float32; meta (n, 4)
    int32 [image, row0, col0, unused]; iy, ix (n, S) int32 offsets."""
    if img.device.type != "cuda":
        return sample_patches_plain(img, meta, iy, ix)
    global launches
    n, S = iy.shape
    if img.dim() != 3 or img.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"img must be (V, H, W) uint8/float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    for name, t, shape in (("meta", meta, (n, 4)), ("iy", iy, (n, S)),
                           ("ix", ix, (n, S))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (img, meta, iy, ix):
        if t.device != img.device or not t.is_contiguous():
            raise ValueError("K1 inputs must be contiguous on one CUDA device")
    out = torch.empty((n, S), dtype=torch.float32, device=img.device)
    V, H, W = img.shape
    err = cuda_build.library().lld_sample_patches(
        cuda_build.ptr(img), 0 if img.dtype == torch.uint8 else 1, V, H, W,
        cuda_build.ptr(meta), cuda_build.ptr(iy), cuda_build.ptr(ix),
        cuda_build.ptr(out), n, S, cuda_build.stream_ptr(img))
    cuda_build.check(err, "K1 sample_patches launch")
    launches += 1
    return out
