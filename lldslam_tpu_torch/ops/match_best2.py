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

Every tensor may carry a leading sequence axis S (rows (S, M, ...), columns
(S, N, ...)): S independent problems, the multi-sequence driver's S frames
at the tracking site, in one launch (`jax.vmap` over the Pallas kernel in
lldslam_tpu/parallel/multi_seq.py). Sequence s's rows see only sequence s's
columns; without the axis the call is the S = 1 case.
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
    """Best-2 over a given (..., M, N) mask: the distance matrix by the
    float32 bit-matmul identity (exact: values <= 256), then the XLA argmin
    sequence."""
    d = torch.where(mask, hamming.distance_matrix(a, b),
                    torch.full((), hamming.INF_DIST, dtype=torch.int32,
                               device=a.device))
    best_idx = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, best_idx)
    d.scatter_(-1, best_idx, hamming.INF_DIST)
    second_idx = torch.argmin(d, dim=-1, keepdim=True)
    second = torch.gather(d, -1, second_idx)
    return (best_idx[..., 0].to(torch.int32), best[..., 0], second[..., 0],
            second_idx[..., 0].to(torch.int32))


def gate_mask(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave, valid):
    """The (..., M, N) candidate mask of the projection gates."""
    rows = lambda x: x[..., :, None]
    cols = lambda x: x[..., None, :]
    du = (rows(u) - cols(xy[..., 0])).abs()
    dv = (rows(v) - cols(xy[..., 1])).abs()
    win = (du <= rows(r)) & (dv <= rows(r))
    oct_f = cols(octave).long()
    po = rows(pred_oct).long()
    oct_ok = (oct_f >= po - 1) & (oct_f <= po)
    dur = (rows(ur) - cols(kp_ur)).abs()
    ur_ok = (cols(kp_ur) < 0) | (dur <= rows(r))
    return win & oct_ok & ur_ok & rows(in_frustum) & cols(valid)


def gated_best2_plain(a, u, v, ur, r, pred_oct, in_frustum, b, xy, kp_ur,
                      octave, valid):
    """The plain version of the kernel: `gate_mask`, then
    `masked_best2_plain`."""
    mask = gate_mask(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave,
                     valid)
    return masked_best2_plain(a, b, mask)


def gated_best2(a, u, v, ur, r, pred_oct, in_frustum, b, xy, kp_ur, octave,
                valid, site: str = "other"):
    """Rows: a (S, M, 8) int32 descriptors, u, v, ur, r (S, M) float32
    projection and search radius, pred_oct (S, M) int32, in_frustum (S, M)
    bool. Columns: b (S, N, 8) int32 descriptors, xy (S, N, 2) float32,
    kp_ur (S, N) float32 right u (< 0 for none), octave (S, N) int32, valid
    (S, N) bool. Returns (best_idx, best, second, second_idx), each (S, M)
    int32; without the leading S every shape drops it (S = 1). One launch
    for all S, counted once; `site` labels the caller in
    `launches_by_site`."""
    if a.device.type != "cuda":
        return gated_best2_plain(a, u, v, ur, r, pred_oct, in_frustum, b, xy,
                                 kp_ur, octave, valid)
    global launches
    batched = a.dim() == 3
    S = a.shape[0] if batched else 1
    M, N = a.shape[-2], b.shape[-2]
    lead = (S,) if batched else ()
    specs = (("a", a, torch.int32, (M, 8)), ("u", u, torch.float32, (M,)),
             ("v", v, torch.float32, (M,)), ("ur", ur, torch.float32, (M,)),
             ("r", r, torch.float32, (M,)),
             ("pred_oct", pred_oct, torch.int32, (M,)),
             ("in_frustum", in_frustum, torch.bool, (M,)),
             ("b", b, torch.int32, (N, 8)), ("xy", xy, torch.float32, (N, 2)),
             ("kp_ur", kp_ur, torch.float32, (N,)),
             ("octave", octave, torch.int32, (N,)),
             ("valid", valid, torch.bool, (N,)))
    specs = tuple((n, t, dt, lead + sh) for n, t, dt, sh in specs)
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError("K2g inputs must be contiguous on one CUDA device")
    if N > MAX_COLUMNS:
        raise ValueError(f"K2g takes at most {MAX_COLUMNS} columns, got {N}")
    if not 1 <= S <= 65535:
        raise ValueError(f"K2g takes 1 to 65535 sequences, got {S}")
    if a.data_ptr() % 16 or b.data_ptr() % 16 or xy.data_ptr() % 8:
        raise ValueError("K2g descriptor rows must be 16-byte aligned and xy "
                         "8-byte aligned")
    out = torch.empty((4,) + lead + (M,), dtype=torch.int32, device=a.device)
    p = cuda_build.ptr
    cuda_build.launch(
        "lld_gated_best2", "K2g gated_best2 launch", a.device, p(a), p(u),
        p(v), p(ur), p(r), p(pred_oct), p(in_frustum), S, M, p(b), p(xy),
        p(kp_ur), p(octave), p(valid), N, p(out))
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    return out[0], out[1], out[2], out[3]
