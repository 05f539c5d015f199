"""K2g: gated Hamming best-2 matcher — CUDA kernel + plain version.

Counterpart of lldslam_tpu/ops/pallas_match.py (the Pallas kernel
`masked_best2`) together with the projection gates the JAX package builds as
an (M, N) mask before calling it (lldslam_tpu/frontend/matching.py
`search_by_projection`). Row i (a projected map point) and column j (a frame
keypoint) are candidates when

    |u_i - x_j| <= r_i  and  |v_i - y_j| <= r_i
    and  pred_oct_i - 1 <= octave_j <= pred_oct_i
    and  (ur_j < 0  or  |ur_i - ur_j| <= r_i)
    and  in_frustum_i  and  valid_j

and each row gets the best and second-best Hamming distance over its
candidates. Descriptors travel as int32 tensors holding the uint32 bits
(torch.uint32 lacks bitwise ops on the CPU); the kernel reads them as
`const uint32_t*`. The kernel source is `lldslam_tpu_torch/csrc/
match_best2.cu`; a CUDA tensor always goes to it, a CPU tensor to
`gated_best2_plain`, which builds the mask (`gate_mask`) and runs
`masked_best2_plain` on it.

Tie contract: the XLA sequence of lldslam_tpu/frontend/matching.py (argmin,
mask the best column, argmin again) — lowest column at each minimum, and
INF_DIST with column 0 for rows without a (second) candidate.
"""
from __future__ import annotations

import torch

from . import cuda_build, hamming

MAX_COLUMNS = 12288   # the kernel stages 16 B per column in shared memory
# launches of the CUDA kernel (incremented where the kernel is launched),
# in all and by the caller's site label
launches = 0
launches_by_site: dict[str, int] = {}


def masked_best2_plain(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor):
    """Best-2 over a given (M, N) mask: the distance matrix by the float32
    bit-matmul identity (exact: values <= 256), then the XLA argmin
    sequence."""
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


def gate_mask(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave, valid):
    """The (M, N) candidate mask of the projection gates."""
    du = (u[:, None] - xy[None, :, 0]).abs()
    dv = (v[:, None] - xy[None, :, 1]).abs()
    win = (du <= r[:, None]) & (dv <= r[:, None])
    oct_f = octave[None, :].long()
    po = pred_oct[:, None].long()
    oct_ok = (oct_f >= po - 1) & (oct_f <= po)
    dur = (ur[:, None] - kp_ur[None, :]).abs()
    ur_ok = (kp_ur[None, :] < 0) | (dur <= r[:, None])
    return win & oct_ok & ur_ok & in_frustum[:, None] & valid[None, :]


def gated_best2_plain(a, u, v, ur, r, pred_oct, in_frustum, b, xy, kp_ur,
                      octave, valid):
    """The plain version of the kernel: `gate_mask`, then
    `masked_best2_plain`."""
    mask = gate_mask(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave,
                     valid)
    return masked_best2_plain(a, b, mask)


def gated_best2(a, u, v, ur, r, pred_oct, in_frustum, b, xy, kp_ur, octave,
                valid, site: str = "other"):
    """Rows: a (M, 8) int32 descriptors, u, v, ur, r (M,) float32
    projection and search radius, pred_oct (M,) int32, in_frustum (M,)
    bool. Columns: b (N, 8) int32 descriptors, xy (N, 2) float32, kp_ur
    (N,) float32 right u (< 0 for none), octave (N,) int32, valid (N,)
    bool. Returns (best_idx, best, second, second_idx), each (M,) int32.
    `site` labels the caller in `launches_by_site`."""
    if a.device.type != "cuda":
        return gated_best2_plain(a, u, v, ur, r, pred_oct, in_frustum, b, xy,
                                 kp_ur, octave, valid)
    global launches
    M, N = a.shape[0], b.shape[0]
    specs = (("a", a, torch.int32, (M, 8)), ("u", u, torch.float32, (M,)),
             ("v", v, torch.float32, (M,)), ("ur", ur, torch.float32, (M,)),
             ("r", r, torch.float32, (M,)),
             ("pred_oct", pred_oct, torch.int32, (M,)),
             ("in_frustum", in_frustum, torch.bool, (M,)),
             ("b", b, torch.int32, (N, 8)), ("xy", xy, torch.float32, (N, 2)),
             ("kp_ur", kp_ur, torch.float32, (N,)),
             ("octave", octave, torch.int32, (N,)),
             ("valid", valid, torch.bool, (N,)))
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError("K2g inputs must be contiguous on one CUDA device")
    if N > MAX_COLUMNS:
        raise ValueError(f"K2g takes at most {MAX_COLUMNS} columns, got {N}")
    if a.data_ptr() % 16 or b.data_ptr() % 16 or xy.data_ptr() % 8:
        raise ValueError("K2g descriptor rows must be 16-byte aligned and xy "
                         "8-byte aligned")
    out = torch.empty((4, M), dtype=torch.int32, device=a.device)
    p = cuda_build.ptr
    err = cuda_build.library().lld_gated_best2(
        p(a), p(u), p(v), p(ur), p(r), p(pred_oct), p(in_frustum), M, p(b),
        p(xy), p(kp_ur), p(octave), p(valid), N, p(out),
        cuda_build.stream_ptr(a))
    cuda_build.check(err, "K2g gated_best2 launch")
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    return out[0], out[1], out[2], out[3]
