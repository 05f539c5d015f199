"""The frame-pose LM as one CUDA kernel (csrc/pose_lm.cu).

Counterpart of the XLA-compiled `optimize_pose` of
lldslam_tpu/optim/pose_opt.py: `rounds` x `iters` Levenberg-Marquardt steps
with Huber IRLS and round-based inlier reclassification on one frame pose,
over point rows alone or point and line rows (the tracker's joint
point+line step), the whole solve in one launch (one thread block a
problem). `optim.pose_opt.optimize_pose` routes here a call on CUDA
tensors; its plain version (`optim.pose_opt.optimize_pose_plain`) takes CPU
tensors.

Every tensor may carry a leading sequence axis S (T_init (S, 4, 4),
observations (S, N, ...)): S independent problems, the multi-sequence
driver's S frames, in one launch; without the axis the call is the S = 1
case.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from ..optim import residuals as res
from . import cuda_build

MAX_N = 512 * 32   # point rows, and line rows, a problem: 32 a thread
# launches of the CUDA kernel, in all and by the caller's site label
launches = 0
launches_by_site: dict[str, int] = {}

_POINT_ROWS = (("X", torch.float32, (3,)), ("obs", torch.float32, (3,)),
               ("inv_sigma2", torch.float32, ()),
               ("is_stereo", torch.bool, ()), ("valid", torch.bool, ()))
_LINE_ROWS = (("X0", torch.float32, (3,)), ("d", torch.float32, (3,)),
              ("x1_l", torch.float32, (2,)), ("x2_l", torch.float32, (2,)),
              ("x1_r", torch.float32, (2,)), ("x2_r", torch.float32, (2,)),
              ("octave", torch.int32, ()), ("has_right", torch.bool, ()),
              ("line_valid", torch.bool, ()))


def pose_lm(cam, T_init: torch.Tensor, X: torch.Tensor, obs: torch.Tensor,
            inv_sigma2: torch.Tensor, is_stereo: torch.Tensor,
            valid: torch.Tensor, *lines: torch.Tensor, rounds: int = 4,
            iters: int = 10, gamma: float = 0.5, site: str = "other"):
    """T_init (S, 4, 4) float32; X, obs (S, N, 3) float32 (obs = uL, v,
    uR; uR ignored when mono); inv_sigma2 (S, N) float32; is_stereo, valid
    (S, N) bool. `lines`, none or the nine fields of a
    `pose_opt.LinePoseObs` with the same leading S: X0, d (S, M, 3) float32,
    x1_l, x2_l, x1_r, x2_r (S, M, 2) float32, octave (S, M) int32,
    has_right, valid (S, M) bool; their edges weigh gamma^2 / 1.44^(2
    octave). All contiguous on one CUDA device, N, M <= MAX_N. Returns
    (T (S, 4, 4), point inlier mask (S, N) bool, n_inliers (S,) int32 (the
    point inliers), line inlier mask (S, M) bool (M = 0 without lines)),
    each without S when T_init has none. One launch, counted in
    `launches`, in `launches_by_site[site]` and in the current frame
    record's `pose_lm_kernel` counter; one with lines also in its
    `line_lm_kernel` counter, its rows (N + 2 M a problem: a line row is
    two edges) in `line_lm_rows` and its line rows (M a problem) in
    `line_lm_lines`. Raises ValueError on any other input."""
    global launches
    batched = T_init.dim() == 3
    S = T_init.shape[0] if batched else 1
    N = X.shape[-2] if X.dim() >= 2 else -1
    M = lines[0].shape[-2] if lines and lines[0].dim() >= 2 else 0
    lead = (S,) if batched else ()
    if lines and len(lines) != len(_LINE_ROWS):
        raise ValueError(f"line rows must be the {len(_LINE_ROWS)} fields "
                         f"of a LinePoseObs, got {len(lines)} tensors")
    specs = [("T_init", T_init, torch.float32, lead + (4, 4))]
    for rows, fields, tensors in ((N, _POINT_ROWS, (X, obs, inv_sigma2,
                                                    is_stereo, valid)),
                                  (M, _LINE_ROWS, lines)):
        specs += [(name, t, dtype, lead + (rows,) + tail)
                  for (name, dtype, tail), t in zip(fields, tensors)]
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != T_init.device or not t.is_contiguous():
            raise ValueError("pose LM inputs must be contiguous on one device")
    if N > MAX_N or M > MAX_N:
        raise ValueError(f"the pose LM kernel takes at most {MAX_N} rows of "
                         f"each kind, got {N} point and {M} line rows")
    if rounds < 0 or iters < 0:
        raise ValueError(f"rounds and iters must be >= 0, got {rounds}, "
                         f"{iters}")
    if T_init.device.type != "cuda":
        raise ValueError("the pose LM kernel takes CUDA tensors (the CPU's "
                         "is optim.pose_opt.optimize_pose_plain)")
    dev = T_init.device
    T = torch.empty(lead + (4, 4), dtype=torch.float32, device=dev)
    inl = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    n = torch.empty(lead, dtype=torch.int32, device=dev)
    ln_inl = torch.empty(lead + (M,), dtype=torch.bool, device=dev)
    p, f = cuda_build.ptr, ctypes.c_float
    line_args = [p(t) for t in lines] if lines else [None] * len(_LINE_ROWS)
    cuda_build.launch(
        "lld_pose_lm", "pose LM launch", dev, p(T_init), p(X), p(obs),
        p(inv_sigma2), p(is_stereo), p(valid), S, N, f(cam.fx), f(cam.fy),
        f(cam.cx), f(cam.cy), f(cam.bf), rounds, iters, *line_args, M,
        f(gamma * gamma), f(res.CHI2_MONO * gamma * gamma),
        f(res.CHI2_STEREO * gamma * gamma),
        f(cam.baseline), p(T), p(inl), p(n), p(ln_inl))
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    tracing.count("pose_lm_kernel")
    if lines:
        tracing.count("line_lm_kernel")
        tracing.count("line_lm_rows", S * (N + 2 * M))
        tracing.count("line_lm_lines", S * M)
    return T, inl, n, ln_inl
