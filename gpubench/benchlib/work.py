"""The yardstick of the kernels' rooflines: the card's peaks and the work
(bytes, operations) of each kernel's call, from that call's inputs.

Frozen copies of the program's own arithmetic (`chip_smoke.py`'s `bound`,
`k1a_work`, `k1b_work` and K2g's gated-pair count): bytes count every
distinct pixel a call's taps touch once, and every input and output once;
operations are those the algorithm needs for these inputs. The share counts
the same work whatever implements the op, so a later change that splits or
fuses a kernel cannot move it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

# NVIDIA H100 SXM data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time (s) the card could take for this work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def distinct_pixels(shape, *taps) -> int:
    """Distinct pixels of an (I, H, W) stack that the taps (image, row,
    column; broadcast) touch, each clamped into the stack."""
    _, H, W = shape
    flat = [((i.long() * H + y.long().clamp(0, H - 1)) * W
             + x.long().clamp(0, W - 1)).reshape(-1) for i, y, x in taps]
    return int(torch.unique(torch.cat(flat)).numel())


def _ic_offsets(device):
    ys, xs = np.mgrid[-ref.IC_HALF:ref.IC_HALF + 1,
                      -ref.IC_HALF:ref.IC_HALF + 1]
    inside = np.abs(xs) <= ref._umax()[np.abs(ys)]
    return (torch.tensor(ys[inside], device=device),
            torch.tensor(xs[inside], device=device))


def k1a(pyr_stack, xy, img_idx, image_hw, angle) -> tuple[int, int]:
    """(bytes, operations) of one K1a call over S frames: the moment taps
    clamped to the stack and the BRIEF taps rotated by the returned angles
    and clamped to the level, each distinct pixel read once from each of
    the two stacks; xy and image in, angle and 8 words out; two
    multiply-adds a moment tap, a rotation (6 operations) and a compare a
    BRIEF tap."""
    dy, dx = _ic_offsets(xy.device)
    pat = torch.tensor(np.load(ref.PATTERN), dtype=torch.float32,
                       device=xy.device)
    S, I, H, W = pyr_stack.shape
    n_bytes = n_ops = 0
    for s in range(S):
        x, y, idx = xy[s, :, 0:1], xy[s, :, 1:2], img_idx[s]
        a = angle[s]
        ca, sa = torch.cos(a)[:, None, None], torch.sin(a)[:, None, None]
        px, py = pat[None, :, :, 0], pat[None, :, :, 1]
        rx = torch.round(px * ca - py * sa).long()
        ry = torch.round(px * sa + py * ca).long()
        hw = torch.tensor(image_hw, device=xy.device)[idx.long()]
        gx = torch.minimum((x[:, :, None] + rx).clamp(min=0),
                           hw[:, 1, None, None] - 1)
        gy = torch.minimum((y[:, :, None] + ry).clamp(min=0),
                           hw[:, 0, None, None] - 1)
        px_n = (distinct_pixels((I, H, W), (idx[:, None], y + dy, x + dx))
                + distinct_pixels((I, H, W), (idx[:, None, None], gy, gx)))
        n = xy.shape[1]
        n_bytes += 4 * px_n + n * (12 + 36)
        n_ops += n * (4 * len(dx) + 13 * 256)
    return n_bytes, n_ops


def k1b(pyr_stack, level_hw, lvl, ul, vl, ur) -> tuple[int, int]:
    """(bytes, operations) of one K1b call over S frames: the left patches
    and right strips clamped to the level, each distinct pixel once; 4
    ints in, 3 values out; 3 operations a SAD term."""
    S, I, H, W = pyr_stack.shape
    dev = lvl.device
    o = torch.arange(-ref.W_HALF, ref.W_HALF + 1, device=dev)
    o_s = torch.arange(-ref.W_HALF - ref.L_SWEEP,
                       ref.W_HALF + ref.L_SWEEP + 1, device=dev)
    n_bytes = n_ops = 0
    for s in range(S):
        hw = torch.tensor(level_hw, device=dev)[lvl[s].long()]
        h, w = hw[:, 0, None], hw[:, 1, None]
        clip = lambda c, hi: torch.minimum(c.clamp(min=0), hi - 1)
        rows = clip(vl[s, :, None] + o, h)[:, :, None]
        left = (2 * lvl[s].long())[:, None, None]
        px_n = distinct_pixels(
            (I, H, W), (left, rows, clip(ul[s, :, None] + o, w)[:, None, :]),
            (left + 1, rows, clip(ur[s, :, None] + o_s, w)[:, None, :]))
        n = lvl.shape[1]
        n_bytes += 4 * px_n + n * (16 + 12)
        n_ops += n * 11 * 121 * 3
    return n_bytes, n_ops


def k2g(a, u, v, ur, r, pred_oct, in_frustum, b, xy, kp_ur, octave,
        valid) -> tuple[int, int]:
    """(bytes, operations) of one K2g call over S problems: row fields and
    descriptors, column fields and descriptors, 4 outputs; deciding a pair
    takes a subtraction, an absolute value and a comparison, and a gated
    pair 8 XORs, 8 popcounts and 7 adds."""
    S, M, N = a.shape[0], a.shape[1], b.shape[1]
    gated = ref.gate_count(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur,
                           octave, valid)
    n_bytes = S * (M * (32 + 16 + 4 + 1 + 16) + N * (32 + 8 + 4 + 4 + 1))
    return n_bytes, 3 * S * M * N + 23 * gated
