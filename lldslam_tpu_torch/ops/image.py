"""Image-level ops: pyramid construction and Gaussian blur on tensors.

Counterpart of lldslam_tpu/ops/image.py. Both functions reproduce the JAX
package's float32 arithmetic on the CPU operation for operation, so the
integer-rounded pyramid and blur agree exactly with it:

- the bilinear resize (jax.image.resize, method="linear", antialias=False)
  is two weight-matrix contractions, rows first, with the weights built by
  JAX's formula; XLA evaluates the sample positions (i + 0.5) * inv - 0.5
  as one fused multiply-add, which `_fma` reproduces;
- the separable 7x7 blur accumulates its taps as XLA's fused loop does:
  fma(k0, s0, k1 * s1), then fma(k_i, s_i, acc) for the remaining taps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import consts


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (H, W) list, round(H / scale^l)."""
    return [(int(round(h / scale**l)), int(round(w / scale**l)))
            for l in range(n_levels)]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add (one rounding), evaluated in float64: the
    product of two floats is exact there."""
    return (a.double() * b.double() + c.double()).float()


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) triangle-kernel weights of jax.image.resize (linear,
    antialias=False)."""
    inv = 1.0 / (n_out / n_in)
    i = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    # fills, not torch.tensor: a copy from host memory makes the host wait
    inv32 = torch.full((), inv, dtype=torch.float32, device=device)
    sf = _fma(i, inv32, torch.full((), -0.5, dtype=torch.float32,
                                   device=device))
    x = (sf[None, :] - torch.arange(n_in, dtype=torch.float32,
                                    device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x, min=0.0)
    tot = w.sum(dim=0, keepdim=True)
    ok_tot = tot.abs() > 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(ok_tot, w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sf >= -0.5) & (sf <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _two_taps(n_in: int, n_out: int, device):
    """The triangle kernel without antialiasing touches at most two inputs
    per output: (first input index, its weight, the next input's weight)."""
    w = _resize_weights(n_in, n_out, device)
    i0 = (w != 0).to(torch.int32).argmax(dim=0)
    cols = torch.arange(n_out, device=device)
    w0 = w[i0, cols]
    i1 = (i0 + 1).clamp(max=n_in - 1)
    w1 = torch.where(i0 + 1 < n_in, w[i1, cols], torch.zeros_like(w0))
    return i0, i1, w0, w1


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """(..., H, W) float32 -> (..., h, w). XLA contracts rows first, as
    fma(w1, x1, w0 * x0), then columns as w0 * x0 + w1 * x1 with both
    products rounded; the two-tap form here repeats exactly that."""
    H, W = img.shape[-2:]
    h, w = shape
    x = img.reshape(-1, H, W)
    r0, r1, a0, a1 = _two_taps(H, h, img.device)
    rows = _fma(a1[:, None], x[:, r1, :], a0[:, None] * x[:, r0, :])
    c0, c1, b0, b1 = _two_taps(W, w, img.device)
    out = b0 * rows[..., c0] + b1 * rows[..., c1]
    return out.reshape(*img.shape[:-2], h, w)


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float,
                  quantize: bool = False):
    """img (..., H, W) float32 -> list of n_levels float32 tensors, each
    resized from the previous level. `quantize` rounds every level to integer
    intensities (the reference's uint8 pyramid); the JAX package stores those
    levels as bfloat16, which holds integers <= 255 exactly, so float32 here
    carries identical values."""
    h, w = img.shape[-2:]
    shapes = pyramid_shapes(h, w, n_levels, scale)
    out = [torch.round(img) if quantize else img]
    for l in range(1, n_levels):
        nxt = resize_linear(out[-1], shapes[l])
        out.append(torch.round(nxt) if quantize else nxt)
    return out


def _gauss_kernel(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _taps_sum(k: torch.Tensor, slices) -> torch.Tensor:
    acc = _fma(k[0], slices[0], k[1] * slices[1])
    for i in range(2, len(slices)):
        acc = _fma(k[i], slices[i], acc)
    return acc


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with BORDER_REFLECT_101."""
    # a cached table of fills: an upload from host memory makes the host wait
    k = consts.table(tuple(_gauss_kernel(ksize, sigma).tolist()),
                     torch.float32, img.device)
    r = ksize // 2
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W).to(torch.float32)
    p = F.pad(x, (0, 0, r, r), mode="reflect")
    v = _taps_sum(k, [p[..., i:i + H, :] for i in range(ksize)])
    p = F.pad(v, (r, r, 0, 0), mode="reflect")
    o = _taps_sum(k, [p[..., i:i + W] for i in range(ksize)])
    return o.reshape(img.shape)


def to_gray_f32(img: np.ndarray) -> np.ndarray:
    """Host side: uint8 gray or BGR -> float32 gray in [0, 255], with
    OpenCV's BGR weights."""
    if img.ndim == 3:
        img = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    return np.asarray(img, dtype=np.float32)
