"""Fixed-order segment sum: `index_add_` that gives the same bits every run.

The sparse solvers of a loop event (global BA `optim/ba.ba_solve`, the
joint point+line global BA `optim/lines_ba.joint_ba_solve_cg`, the line
refinement `lines_ba.refine_lines_fixed_poses` and the pose graph
`optim/pose_graph.optimize_pose_graph`) sum per-observation terms into
per-pose and per-landmark blocks: `out.index_add_(0, index, src)`. The JAX
package writes these sums as `.at[].add` (lldslam_tpu/optim/ba.py:104-108,
208, 217-222; lldslam_tpu/optim/lines_ba.py:115-119, 398-428, 542-547;
lldslam_tpu/optim/pose_graph.py:80-84, 104-105); they are XLA scatters, not
Pallas kernels. On the card `index_add_` adds with atomics, so the order of
the float adds, and with it the last bits of a sum, changes from run to
run, and the LM and CG steps amplify those bits into centimetres.

`segment_sum_(out, layout, src)` computes exactly `out.index_add_(0,
layout.index, src)`: it adds into `out`'s current values, each output row
taking its source rows in ascending row order, one IEEE add at a time. On
the CPU it is `index_add_` itself (a serial loop in that order). On the card
it launches `lldslam_tpu_torch/csrc/segment_sum.cu`, which makes the same
sequence of float adds through a CSR layout, so its result is bit-equal to
the CPU's on the same inputs and the same on every run.

`segment_layout(index, n_segments)` builds that layout once per solve (the
observation tables do not change inside one): `perm`, the stable sort order
of `index`, and `offsets`, where segment s's rows are `perm[offsets[s]:
offsets[s + 1]]`. It makes the host wait for nothing: a sort and a search,
with every shape known on the host. On the card, rows whose index lies
outside [0, n_segments) are left out of every segment; on the CPU
`index_add_` raises for them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cuda_build

MAX_COLUMNS = 64      # a thread of the kernel owns at most two columns
# launches of the CUDA kernel (incremented where the kernel is launched)
launches = 0


class SegmentLayout(NamedTuple):
    """Rows of an (O,) index grouped by segment, in ascending row order."""

    index: torch.Tensor    # (O,) int64 segment of each row
    perm: torch.Tensor     # (O,) int64 rows sorted by segment, stable
    offsets: torch.Tensor  # (n_segments + 1,) int64 segment starts in perm


def segment_layout(index: torch.Tensor, n_segments: int) -> SegmentLayout:
    """The CSR layout of an (O,) int64 `index` over `n_segments` segments."""
    if index.dtype != torch.int64 or index.dim() != 1:
        raise ValueError(f"index must be (O,) int64, got {index.dtype} "
                         f"{tuple(index.shape)}")
    ordered, perm = torch.sort(index, stable=True)
    offsets = torch.searchsorted(
        ordered, torch.arange(n_segments + 1, dtype=torch.int64,
                              device=index.device))
    return SegmentLayout(index, perm, offsets)


def _check(out: torch.Tensor, layout: SegmentLayout, src: torch.Tensor):
    """Raises unless out (n_segments, *cols) and src (O, *cols) are
    contiguous float32 and the layout's three tensors contiguous 1-D int64
    of the right lengths, all on one device. Returns the columns per row.
    (It runs on every call of a solver's inner loop, so it reads each
    attribute once.)"""
    index, perm, offsets = layout
    f32, i64 = torch.float32, torch.int64
    if not (out.dtype == f32 and src.dtype == f32 and index.dtype == i64
            and perm.dtype == i64 and offsets.dtype == i64):
        raise ValueError(
            f"segment_sum_: out and src must be float32 and the layout int64,"
            f" got out {out.dtype}, src {src.dtype}, layout "
            f"{[t.dtype for t in layout]}")
    shape, cols = index.shape, src.shape[1:]
    n = offsets.shape[0] - 1
    if not (len(shape) == 1 and perm.shape == shape and offsets.dim() == 1
            and src.dim() >= 1 and src.shape[0] == shape[0]
            and out.shape == (n,) + cols):
        raise ValueError(
            f"segment_sum_: out {tuple(out.shape)} and src {tuple(src.shape)} "
            f"do not fit a layout of {tuple(shape)} rows over {n} segments "
            f"(perm {tuple(perm.shape)})")
    dev = out.device
    if not (src.device == dev and index.device == dev and perm.device == dev
            and offsets.device == dev):
        raise ValueError("segment_sum_: out, src and the layout must be on "
                         "one device")
    if not (out.is_contiguous() and src.is_contiguous()
            and index.is_contiguous() and perm.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("segment_sum_: out, src and the layout must be "
                         "contiguous")
    return math.prod(cols)


def segment_sum_(out: torch.Tensor, layout: SegmentLayout,
                 src: torch.Tensor) -> torch.Tensor:
    """`out.index_add_(0, layout.index, src)` in a fixed order, in place;
    returns `out`. A CUDA tensor goes to the kernel, a CPU tensor to
    `index_add_` (its plain version)."""
    C = _check(out, layout, src)
    if out.device.type != "cuda":
        return out.index_add_(0, layout.index, src)
    if C > MAX_COLUMNS:
        raise ValueError(f"segment_sum_ takes at most {MAX_COLUMNS} columns, "
                         f"got {C}")
    n, O = out.shape[0], src.shape[0]
    if n == 0 or O == 0:
        return out
    global launches
    p = cuda_build.ptr
    cuda_build.launch("lld_segment_sum", "segment_sum_ launch", out.device,
                      p(src), p(layout.perm), p(layout.offsets), p(out), O, n,
                      C)
    launches += 1
    return out
