"""The points-only pose LM as one CUDA kernel (csrc/pose_lm.cu).

Counterpart of the XLA-compiled `optimize_pose` of
lldslam_tpu/optim/pose_opt.py without lines: `rounds` x `iters`
Levenberg-Marquardt steps with Huber IRLS and round-based inlier
reclassification on one frame pose, the whole solve in one launch (one
thread block a problem). `optim.pose_opt.optimize_pose` routes here a
points-only call on CUDA tensors; its plain version
(`optim.pose_opt.optimize_pose_plain`) takes CPU tensors and the joint
point+line LM.

Every tensor may carry a leading sequence axis S (T_init (S, 4, 4),
observations (S, N, ...)): S independent problems, the multi-sequence
driver's S frames, in one launch; without the axis the call is the S = 1
case.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import cuda_build

MAX_N = 512 * 32   # rows a problem: 32 per thread of a 512-thread block
# launches of the CUDA kernel, in all and by the caller's site label
launches = 0
launches_by_site: dict[str, int] = {}


def pose_lm(cam, T_init: torch.Tensor, X: torch.Tensor, obs: torch.Tensor,
            inv_sigma2: torch.Tensor, is_stereo: torch.Tensor,
            valid: torch.Tensor, rounds: int = 4, iters: int = 10,
            site: str = "other"):
    """T_init (S, 4, 4) float32; X, obs (S, N, 3) float32 (obs = uL, v,
    uR; uR ignored when mono); inv_sigma2 (S, N) float32; is_stereo, valid
    (S, N) bool; all contiguous on one CUDA device, N <= MAX_N. Returns
    (T (S, 4, 4), inlier mask (S, N) bool, n_inliers (S,) int32), each
    without S when T_init has none. One launch, counted in `launches`, in
    `launches_by_site[site]` and in the current frame record's
    `pose_lm_kernel` counter. Raises ValueError on any other input."""
    global launches
    batched = T_init.dim() == 3
    S = T_init.shape[0] if batched else 1
    N = X.shape[-2] if X.dim() >= 2 else -1
    lead = (S,) if batched else ()
    specs = (("T_init", T_init, torch.float32, (4, 4)),
             ("X", X, torch.float32, (N, 3)),
             ("obs", obs, torch.float32, (N, 3)),
             ("inv_sigma2", inv_sigma2, torch.float32, (N,)),
             ("is_stereo", is_stereo, torch.bool, (N,)),
             ("valid", valid, torch.bool, (N,)))
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != lead + shape:
            raise ValueError(f"{name} must be {dtype} {lead + shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != T_init.device or not t.is_contiguous():
            raise ValueError("pose LM inputs must be contiguous on one device")
    if N > MAX_N:
        raise ValueError(f"the pose LM kernel takes at most {MAX_N} rows, "
                         f"got {N}")
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
    p, f = cuda_build.ptr, ctypes.c_float
    cuda_build.launch(
        "lld_pose_lm", "pose LM launch", dev, p(T_init), p(X), p(obs),
        p(inv_sigma2), p(is_stereo), p(valid), S, N, f(cam.fx), f(cam.fy),
        f(cam.cx), f(cam.cy), f(cam.bf), rounds, iters, p(T), p(inl), p(n))
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    tracing.count("pose_lm_kernel")
    return T, inl, n
