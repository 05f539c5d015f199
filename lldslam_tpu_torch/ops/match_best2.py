"""K2: fused masked Hamming best-2 matcher — CUDA kernel + plain version.

Counterpart of lldslam_tpu/ops/pallas_match.py (the Pallas kernel
`masked_best2`). Descriptors travel as int32 tensors holding the uint32 bits
(torch.uint32 lacks bitwise ops on the CPU); the kernel reads them as
`const uint32_t*`. The kernel source is `lldslam_tpu_torch/csrc/
match_best2.cu`; a CUDA tensor always goes to it, a CPU tensor to
`masked_best2_plain`.

Tie contract: the XLA sequence of lldslam_tpu/frontend/matching.py (argmin,
mask the best column, argmin again) — lowest column at each minimum, and
INF_DIST with column 0 for rows without a (second) candidate.
"""
from __future__ import annotations

import torch

from . import cuda_build, hamming

# launches of the CUDA kernel (incremented where the kernel is launched),
# in all and by the caller's site label
launches = 0
launches_by_site: dict[str, int] = {}


def masked_best2_plain(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Distance matrix by the float32 bit-matmul identity (exact: values
    <= 256), then the XLA argmin sequence."""
    d = torch.where(mask, hamming.distance_matrix(a, b),
                    torch.full((), hamming.INF_DIST, dtype=torch.int32,
                               device=a.device))
    rows = torch.arange(d.shape[0], device=d.device)
    best_idx = torch.argmin(d, dim=1)
    best = d[rows, best_idx]
    d[rows, best_idx] = hamming.INF_DIST
    second_idx = torch.argmin(d, dim=1)
    second = d[rows, second_idx]
    return (best_idx.to(torch.int32), best, second,
            second_idx.to(torch.int32))


def masked_best2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                 site: str = "other"):
    """a (M, 8) int32, b (N, 8) int32, mask (M, N) bool. Returns
    (best_idx, best, second, second_idx), each (M,) int32. `site` labels
    the caller in `launches_by_site`."""
    if a.device.type != "cuda":
        return masked_best2_plain(a, b, mask)
    global launches
    M, N = a.shape[0], b.shape[0]
    if a.dtype != torch.int32 or tuple(a.shape) != (M, 8) \
            or b.dtype != torch.int32 or tuple(b.shape) != (N, 8):
        raise ValueError(f"descriptors must be int32 (M, 8)/(N, 8), got "
                         f"{a.dtype} {tuple(a.shape)}, {b.dtype} {tuple(b.shape)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (M, N):
        raise ValueError(f"mask must be bool {(M, N)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for t in (a, b, mask):
        if t.device != a.device or not t.is_contiguous():
            raise ValueError("K2 inputs must be contiguous on one CUDA device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("K2 descriptor rows must be 16-byte aligned")
    out = torch.empty((4, M), dtype=torch.int32, device=a.device)
    err = cuda_build.library().lld_masked_best2(
        cuda_build.ptr(a), cuda_build.ptr(b), cuda_build.ptr(mask), M, N,
        cuda_build.ptr(out[0]), cuda_build.ptr(out[1]),
        cuda_build.ptr(out[2]), cuda_build.ptr(out[3]),
        cuda_build.stream_ptr(a))
    cuda_build.check(err, "K2 masked_best2 launch")
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    return out[0], out[1], out[2], out[3]
