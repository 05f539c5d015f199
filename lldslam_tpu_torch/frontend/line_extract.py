"""Line segment detection and band descriptors on tensors.

Counterpart of lldslam_tpu/frontend/line_extract.py, on the image tensor's
device. Two routes feed the line path: stored detections
(`io/stored_lines.py`, `ldType: LBDFloat` with `lineDetectionsPath`, the
reference's benchmark configuration) and this native detector
(`ldType: LBDFloat` without a path), which the tracker runs on both views
of every stereo frame.

Detector (the JAX package's formulation): a gradient-aligned Hough
transform. Sobel gradients; edge pixels (magnitude above `mag_factor` times
the mean) vote their magnitude into the (rho, phi) bin of their own
gradient orientation; a 3x3 max-NMS of the accumulator (wrapping around in
phi) and its top `max_lines` peaks, ties to the lower bin first; each
peak's supporting edge pixels (near the peak line, orientation within 2.5
bins) refit the line by magnitude-weighted PCA and give its span; a density
gate and duplicate suppression (the stronger of two refits on one line
stays, the lower slot on a tie).

Two things differ from the JAX code in form, not in result:
- the vote accumulates with `index_put_(accumulate=True)` on the card,
  which sorts the votes by bin and is deterministic there (the card's
  `index_add_` adds with atomics, in an order that changes from run to
  run), and with `index_add_`, a serial loop, on the CPU;
- the support pass (the (peaks, pixels) masks and sums) runs in chunks of
  `SUPPORT_CHUNK` peaks, so one call holds a chunk's float (chunk, H*W)
  arrays at a time and the (max_lines, H*W) support masks as bool, instead
  of ten (max_lines, H*W) float arrays (about 478 MB each at KITTI size and
  256 lines). Every per-line sum runs over that line's pixels only.

Descriptor: LBD-style line band descriptor, gradients sampled bilinearly
on a (samples x offsets) grid in the line frame, band-pooled means and
standard deviations of the four half-wave gradient channels, L2-normalized,
compared by L2 distance (the tracker's `mdThr` gate maps onto it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# peaks per support-pass chunk: a chunk's float (32, H*W) arrays are about
# 60 MB each at KITTI size
SUPPORT_CHUNK = 32


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
    desc: torch.Tensor     # (L, D) float32, L2-normalized
    valid: torch.Tensor    # (L,) bool


def _sobel(img: torch.Tensor):
    """(gx, gy) of an (H, W) float32 image: the 3x3 Sobel cross-correlation
    over its edge-replicated border, its six nonzero taps summed one after
    the other in row-major order (XLA's order on the CPU: every product is
    exact, so the sums are bit-equal to the JAX package's)."""
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    H, W = img.shape
    s = lambda dy, dx: p[dy:dy + H, dx:dx + W]
    gx = -s(0, 0) + s(0, 2) - 2.0 * s(1, 0) + 2.0 * s(1, 2) - s(2, 0) + s(2, 2)
    gy = -s(0, 0) - 2.0 * s(0, 1) - s(0, 2) + s(2, 0) + 2.0 * s(2, 1) + s(2, 2)
    return gx, gy


def _phi_to_bin(n_phi: int) -> float:
    """phi / pi * n_phi as XLA folds it: one multiply by the float32
    constant 1 / pi * n_phi."""
    f = np.float32
    return float(f(f(1) / f(np.pi)) * f(n_phi))


def _bin_to_phi(n_phi: int) -> float:
    """x * pi / n_phi as XLA folds it: one multiply by the float32 constant
    pi * (1 / n_phi)."""
    f = np.float32
    return float(f(np.pi) * f(f(1) / f(n_phi)))


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula, max * sqrt(1 + (min / max)^2), with XLA's fused
    multiply-add for 1 + r^2 (evaluated in float64, rounded once)."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    r = (lo / torch.where(zero, 1.0, hi)).double()
    return torch.where(zero, hi, hi * torch.sqrt((r * r + 1.0).float()))


def _votes(img: torch.Tensor, cfg: LineDetConfig):
    """Per pixel: gradients, magnitude, edge mask, the line normal's angle
    phi in [0, pi), and its flat (rho, phi) accumulator bin."""
    H, W = img.shape
    diag = float(np.hypot(H, W))
    n_rho = int(np.ceil(diag / cfg.rho_res))
    gx, gy = _sobel(img)
    mag = _hypot(gx, gy)
    edge = mag > cfg.mag_factor * mag.mean()
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    phi = torch.atan2(gy, gx)
    phi = torch.where(phi < 0, phi + math.pi, phi)
    phi = torch.where(phi >= math.pi, phi - math.pi, phi)
    rho = xs * torch.cos(phi) + ys * torch.sin(phi)
    pi_bin = torch.clamp((phi * _phi_to_bin(cfg.n_phi)).to(torch.int32), 0,
                         cfg.n_phi - 1)
    r_bin = torch.clamp(((rho + diag) / cfg.rho_res / 2.0).to(torch.int32), 0,
                        n_rho - 1)
    return gx, gy, mag, edge, phi, r_bin * cfg.n_phi + pi_bin, n_rho


def _accumulate(bins: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of `w` per bin, (n,), the same on every call: on the card
    through `index_put_(accumulate=True)` (sorted by bin), on the CPU
    through `index_add_` (a serial loop in pixel order)."""
    acc = torch.zeros(n, dtype=w.dtype, device=w.device)
    if acc.is_cuda:
        return acc.index_put_((bins,), w, accumulate=True)
    return acc.index_add_(0, bins, w)


def _top_k(x: torch.Tensor, k: int):
    """The k largest values of a 1-D tensor and their indices, equal values
    in ascending index order (jax.lax.top_k's order): a stable descending
    sort keeps equal values in their index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _support(xs_f, ys_f, phi_f, edge_f, rho_k, cos_k, sin_k, phi_k,
             cfg: LineDetConfig):
    """(K, H*W) support mask of K peak lines over the flattened (1, H*W)
    pixel grid: edge pixels within 1.5 rho bins of the line whose gradient
    orientation is within 2.5 phi bins of its normal."""
    d_line = xs_f * cos_k[:, None] + ys_f * sin_k[:, None] - rho_k[:, None]
    dphi = (phi_f - phi_k[:, None]).abs()
    dphi = torch.minimum(dphi, math.pi - dphi)
    return ((d_line.abs() < 1.5 * cfg.rho_res)
            & (dphi < 2.5 * math.pi / cfg.n_phi) & edge_f)


def _support_fit(mag, edge, phi, rho_k, phi_k, cfg: LineDetConfig,
                 chunk: int):
    """For each peak line (rho_k, phi_k): its supporting edge pixels' count,
    the magnitude-weighted PCA refit (rho_r, unit normal, unit direction)
    and the span [s_min, s_max] of their projections along the line.

    The pixel passes run over `chunk` peaks at a time (the last chunk
    padded with lines that no pixel supports, so every chunk has one
    shape); the per-line functions (cos, sin, atan2) run once over all
    peaks. Every sum runs over the pixels of one line, so the chunking
    changes no sum's terms; on the CPU the results are bit-equal for any
    chunk size of two or more."""
    H, W = mag.shape
    K, dev = rho_k.shape[0], mag.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    xs_f, ys_f = xs.reshape(1, -1), ys.reshape(1, -1)
    phi_f, edge_f = phi.reshape(1, -1), edge.reshape(1, -1)
    mag_f = mag.reshape(1, -1)
    pad = (-K) % chunk
    fill = lambda x, v: torch.cat([x, torch.full((pad,), v, dtype=x.dtype,
                                                 device=dev)])
    rho_p, phi_p = fill(rho_k, math.inf), fill(phi_k, 0.0)
    cos_p, sin_p = fill(torch.cos(phi_k), 1.0), fill(torch.sin(phi_k), 0.0)
    supports, sums = [], []
    for a in range(0, K + pad, chunk):
        c = slice(a, a + chunk)
        support = _support(xs_f, ys_f, phi_f, edge_f, rho_p[c], cos_p[c],
                           sin_p[c], phi_p[c], cfg)
        wgt = torch.where(support, mag_f, 0.0)
        wsum = torch.clamp(wgt.sum(-1), min=1e-6)
        mx = (wgt * xs_f).sum(-1) / wsum
        my = (wgt * ys_f).sum(-1) / wsum
        dxs = xs_f - mx[:, None]
        dys = ys_f - my[:, None]
        sums.append((mx, my, (wgt * dxs * dxs).sum(-1) / wsum,
                     (wgt * dxs * dys).sum(-1) / wsum,
                     (wgt * dys * dys).sum(-1) / wsum, support.sum(-1)))
        supports.append(support)
        del wgt, dxs, dys
    mx, my, cxx, cxy, cyy, n_sup = (torch.cat(x)[:K] for x in zip(*sums))
    # principal direction of the 2x2 covariance (largest eigenvector)
    ang2 = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
    t = torch.stack([torch.cos(ang2), torch.sin(ang2)], -1)    # along-line
    nvec = torch.stack([-t[:, 1], t[:, 0]], -1)
    rho_r = mx * nvec[:, 0] + my * nvec[:, 1]
    t_p = torch.cat([t, torch.zeros((pad, 2), device=dev)])
    spans = []
    for a, support in zip(range(0, K + pad, chunk), supports):
        tc = t_p[a:a + chunk]
        s = xs_f * tc[:, 0:1] + ys_f * tc[:, 1:2]
        spans.append((torch.where(support, s, math.inf).amin(-1),
                      torch.where(support, s, -math.inf).amax(-1)))
    s_min, s_max = (torch.cat(x)[:K] for x in zip(*spans))
    return n_sup, rho_r, nvec, t, s_min, s_max


def detect_lines(img: torch.Tensor, cfg: LineDetConfig = LineDetConfig()
                 ) -> KeyLines:
    """Up to `cfg.max_lines` segments of an (H, W) image, on its device."""
    img = img.to(torch.float32)
    gx, gy, mag, edge, phi, bins, n_rho = _votes(img, cfg)
    L = cfg.max_lines
    diag = float(np.hypot(*img.shape))
    votes = torch.where(edge, mag, 0.0).reshape(-1)
    acc = _accumulate(bins.reshape(-1), votes,
                      n_rho * cfg.n_phi).reshape(n_rho, cfg.n_phi)
    # 3x3 NMS, zero rows beyond rho, wrap-around in phi
    accp = torch.nn.functional.pad(acc, (0, 0, 1, 1))
    accp = torch.cat([accp[:, -1:], accp, accp[:, :1]], dim=1)
    win = torch.nn.functional.max_pool2d(accp[None, None], 3, stride=1)[0, 0]
    peaks = torch.where((acc >= win) & (acc >= cfg.min_support), acc, 0.0)

    vals, flat_idx = _top_k(peaks.reshape(-1), L)
    pr, pp = flat_idx // cfg.n_phi, flat_idx % cfg.n_phi
    rho_k = (pr.to(torch.float32) + 0.5) * cfg.rho_res * 2.0 - diag
    phi_k = (pp.to(torch.float32) + 0.5) * _bin_to_phi(cfg.n_phi)
    n_sup, rho_r, nvec, t, s_min, s_max = _support_fit(
        mag, edge, phi, rho_k, phi_k, cfg, SUPPORT_CHUNK)

    length = torch.clamp(s_max - s_min, min=0.0)
    p1 = rho_r[:, None] * nvec + s_min[:, None] * t
    p2 = rho_r[:, None] * nvec + s_max[:, None] * t
    # density gate: support must fill a reasonable fraction of the span
    dense = n_sup.to(torch.float32) >= 0.5 * length
    valid = (vals > 0.0) & (length >= cfg.min_len) & dense \
        & torch.isfinite(length)

    # duplicate suppression: refits on one (rho, phi) keep the strongest
    phi_r = torch.atan2(nvec[:, 1], nvec[:, 0])
    phi_r = torch.where(phi_r < 0, phi_r + math.pi, phi_r)
    rho_c = rho_r.abs()
    drho = (rho_c[:, None] - rho_c[None]).abs()
    dph = (phi_r[:, None] - phi_r[None]).abs()
    dph = torch.minimum(dph, math.pi - dph)
    same = (drho < 3.0) & (dph < 0.05) & valid[:, None] & valid[None]
    score = n_sup.to(torch.float32) * length
    slot = torch.arange(L, device=img.device)
    better = same & ((score[None] > score[:, None])
                     | ((score[None] == score[:, None])
                        & (slot[None] < slot[:, None])))
    valid = valid & ~better.any(dim=1)
    p1 = torch.where(valid[:, None], p1, 0.0)
    p2 = torch.where(valid[:, None], p2, 0.0)

    desc = _lbd_descriptor(img, gx, gy, p1, p2, cfg)
    vf = valid.to(torch.float32)
    return KeyLines(p1=p1, p2=p2,
                    octave=torch.zeros(L, dtype=torch.int32,
                                       device=img.device),
                    length=length * vf, desc=desc * vf[:, None], valid=valid)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img sampled at (x, y), clamped inside the image."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    dx = x - x0
    dy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - dy) * (1 - dx) * v00 + (1 - dy) * dx * v01
            + dy * (1 - dx) * v10 + dy * dx * v11)


def _lbd_descriptor(img, gx, gy, p1, p2, cfg: LineDetConfig) -> torch.Tensor:
    """Band descriptor: (L, n_bands * 8) from gradients in the line frame."""
    L = p1.shape[0]
    d = p2 - p1
    ln = torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
    t = d / ln                                  # along line
    n = torch.stack([-t[..., 1], t[..., 0]], -1)  # normal
    S, O = cfg.band_samples, cfg.band_offsets
    ss = torch.linspace(0.05, 0.95, S, device=img.device)
    oo = torch.arange(O, dtype=torch.float32, device=img.device) \
        - (O - 1) / 2.0
    base = p1[:, None, :] + ss[None, :, None] * d[:, None, :]
    pts = base[:, :, None, :] + oo[None, None, :, None] * n[:, None, None, :]
    gxs = _bilinear(gx, pts[..., 0], pts[..., 1])
    gys = _bilinear(gy, pts[..., 0], pts[..., 1])
    g_par = gxs * t[:, None, None, 0] + gys * t[:, None, None, 1]
    g_per = gxs * n[:, None, None, 0] + gys * n[:, None, None, 1]
    ch = torch.stack([torch.clamp(g_per, min=0), torch.clamp(-g_per, min=0),
                      torch.clamp(g_par, min=0), torch.clamp(-g_par, min=0)],
                     -1)
    per_band = O // cfg.n_bands
    ch = ch[:, :, : per_band * cfg.n_bands].reshape(
        L, S, cfg.n_bands, per_band, 4).sum(dim=3)   # (L, S, B, 4)
    mean = ch.mean(dim=1)
    std = ch.std(dim=1, correction=0)
    desc = torch.cat([mean, std], -1).reshape(L, cfg.n_bands * 8)
    nn = torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)
    return desc / nn
