"""K1b: fused stereo SAD refinement — CUDA kernel + plain version.

Replaces, for the stereo windows of the frame build, the Pallas kernel
`sample_patches` of lldslam_tpu/ops/patch_sample.py and the XLA SAD sweep
the JAX package runs on its output (lldslam_tpu/ops/stereo.py
`match_stereo`, the subpixel refinement). For each left keypoint, at its
level l of a stack holding left level l at image 2l and right level l at
2l + 1, it takes the 11x11 patch around (ul, vl) on the left image and the
11x21 strip around (ur, vl) on the right one (rows and columns clamped to
the level's (h, w)), the 11 centred SADs over the +-5 disparity sweep, and
returns

    best_d (n,) int32    first disparity index of the smallest SAD (argmin)
    best_c (n,) float32  that SAD
    delta  (n,) float32  the parabola vertex offset through best_d's
                         neighbours, 0 at the ends of the sweep, in [-1, 1]

The kernel source is `lldslam_tpu_torch/csrc/stereo_sad.cu`; a CUDA tensor
always goes to it, a CPU tensor to `sad_refine_plain`. The images must be
integer-valued (the quantized pyramid): every SAD is then an exact integer.
The stack and the keypoint arrays may carry a leading sequence axis S (the
multi-sequence driver's S frames, one launch for all of them; the level
shapes are shared); without it the call is the S = 1 case.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from . import consts, cuda_build, patch_sample

W_HALF = 5   # 11x11 SAD window
L_SWEEP = 5  # disparity sweep +-5
# launches of the CUDA kernel (incremented where the kernel is launched)
launches = 0


def _sample_windows(pyr_stack: torch.Tensor, level_hw, lvl: torch.Tensor,
                    ul, vl, ur, left: torch.Tensor):
    """The SAD windows through one gather each: (patch (n, 11, 11) from the
    left image `left` of the stack, strip (n, 11, 11 + 2L) from the right
    one, `left` + 1), coordinates clipped into each keypoint's level
    image."""
    W, L = W_HALF, L_SWEEP
    dev = pyr_stack.device
    idx = lvl.long()
    hk = consts.table(tuple(h for h, _ in level_hw), torch.int32, dev)[idx][:, None]
    wk = consts.table(tuple(w for _, w in level_hw), torch.int32, dev)[idx][:, None]
    oy = torch.arange(-W, W + 1, dtype=torch.int32, device=dev)
    ox_p = torch.arange(-W, W + 1, dtype=torch.int32, device=dev)
    ox_s = torch.arange(-W - L, W + L + 1, dtype=torch.int32, device=dev)
    yy = torch.minimum(torch.clamp(vl[:, None] + oy[None], min=0), hk - 1)

    def taps(u, ox, view):
        xx = torch.minimum(torch.clamp(u[:, None] + ox[None], min=0), wk - 1)
        iy = yy[:, :, None].expand(-1, -1, len(ox)).reshape(len(u), -1)
        ix = xx[:, None, :].expand(-1, len(oy), -1).reshape(len(u), -1)
        meta = F.pad((left + view).to(torch.int32)[:, None], (0, 3))
        vals = patch_sample.sample_patches_plain(
            pyr_stack, meta.contiguous(), iy.contiguous(), ix.contiguous())
        return vals.reshape(len(u), len(oy), len(ox))

    return taps(ul, ox_p, 0), taps(ur, ox_s, 1)


def sad_refine_plain(pyr_stack: torch.Tensor,
                     level_hw: Sequence[tuple[int, int]], lvl: torch.Tensor,
                     ul: torch.Tensor, vl: torch.Tensor, ur: torch.Tensor):
    """The plain version of the kernel: the windows, the SAD sweep, argmin
    and the clamped parabola. Returns (best_d, best_c, delta), each shaped
    as lvl. With a leading S the S stacks are gathered as one stack of
    S*2L images, each keypoint reading its own frame's."""
    W, L = W_HALF, L_SWEEP
    lead = lvl.shape[:-1]
    I, H, Wd = pyr_stack.shape[-3:]
    seq = torch.arange(math.prod(lead), dtype=torch.int32,
                       device=lvl.device).reshape(*lead, 1)
    left = (seq * I + lvl * 2).reshape(-1)
    lvl, ul, vl, ur = (x.reshape(-1) for x in (lvl, ul, vl, ur))
    patch, strip = _sample_windows(pyr_stack.reshape(-1, H, Wd), level_hw,
                                   lvl, ul, vl, ur, left)
    patch_c = patch - patch[:, W, W][:, None, None]
    wins = strip.unfold(2, 2 * W + 1, 1).permute(0, 2, 1, 3)   # (n, d, 11, 11)
    wins_c = wins - wins[:, :, W, W][:, :, None, None]
    sad = (patch_c[:, None] - wins_c).abs().sum(dim=(2, 3))    # (n, 2L+1)

    best_d = torch.argmin(sad, dim=-1)
    best_c = torch.gather(sad, -1, best_d[:, None])[:, 0]
    interior = (best_d > 0) & (best_d < 2 * L)
    cm1 = torch.gather(sad, -1, torch.clamp(best_d - 1, min=0)[:, None])[:, 0]
    cp1 = torch.gather(sad, -1, torch.clamp(best_d + 1, max=2 * L)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (cm1 + cp1 - 2.0 * best_c), min=1e-6)
    delta = (cm1 - cp1) / denom
    delta = torch.clamp(torch.where(interior, delta, torch.zeros_like(delta)),
                        -1.0, 1.0)
    return (best_d.to(torch.int32).reshape(*lead, -1),
            best_c.reshape(*lead, -1), delta.reshape(*lead, -1))


def sad_refine(pyr_stack: torch.Tensor, level_hw: Sequence[tuple[int, int]],
               lvl: torch.Tensor, ul: torch.Tensor, vl: torch.Tensor,
               ur: torch.Tensor):
    """pyr_stack (S, 2L, H, W) float32, left level l at 2l, right at
    2l + 1; level_hw the L level shapes (h, w) as host ints, shared by the
    S frames; lvl, ul, vl, ur (S, n) int32 (level in [0, L), left u and v,
    right u, at the level). Returns (best_d (S, n) int32, best_c (S, n)
    float32, delta (S, n) float32); without the leading S every shape drops
    it (S = 1). One launch for all S, counted once."""
    if pyr_stack.device.type != "cuda":
        return sad_refine_plain(pyr_stack, level_hw, lvl, ul, vl, ur)
    global launches
    lead = tuple(lvl.shape[:-1])
    S = lead[0] if lead else 1
    n = lvl.shape[-1]
    I, H, W = pyr_stack.shape[-3:]
    if pyr_stack.dtype != torch.float32 or tuple(pyr_stack.shape[:-3]) != lead \
            or len(lead) > 1:
        raise ValueError(f"pyr_stack must be float32 {lead + ('2L', 'H', 'W')}"
                         f", got {pyr_stack.dtype} {tuple(pyr_stack.shape)}")
    if I != 2 * len(level_hw) or not 2 <= I <= 64:
        raise ValueError(f"pyr_stack holds {I} images; level_hw gives "
                         f"{len(level_hw)} levels (two views each, at most 32)")
    if not 1 <= S <= 65535:
        raise ValueError(f"K1b takes 1 to 65535 frames, got {S}")
    for name, t in (("lvl", lvl), ("ul", ul), ("vl", vl), ("ur", ur)):
        if t.dtype != torch.int32 or tuple(t.shape) != lead + (n,):
            raise ValueError(f"{name} must be int32 {lead + (n,)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (pyr_stack, lvl, ul, vl, ur):
        if t.device != pyr_stack.device or not t.is_contiguous():
            raise ValueError("K1b inputs must be contiguous on one CUDA device")
    hw = [hw_ for hw_ in level_hw for _ in range(2)]
    hs = (ctypes.c_int * I)(*(int(h) for h, _ in hw))
    ws = (ctypes.c_int * I)(*(int(w) for _, w in hw))
    best_d = torch.empty(lead + (n,), dtype=torch.int32, device=lvl.device)
    best_c = torch.empty(lead + (n,), dtype=torch.float32, device=lvl.device)
    delta = torch.empty(lead + (n,), dtype=torch.float32, device=lvl.device)
    p = cuda_build.ptr
    cuda_build.launch(
        "lld_stereo_sad", "K1b stereo_sad launch", lvl.device, p(pyr_stack),
        S, I, H, W, hs, ws, p(lvl), p(ul), p(vl), p(ur), n, p(best_d),
        p(best_c), p(delta))
    launches += 1
    return best_d, best_c, delta
