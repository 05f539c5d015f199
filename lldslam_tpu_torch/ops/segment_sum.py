"""Fixed-order segment sums: `index_add_` that gives the same bits every run.

The sparse solvers of a loop event (global BA `optim/ba.ba_solve`, the
joint point+line global BA `optim/lines_ba.joint_ba_solve_cg`, the line
refinement `lines_ba.refine_lines_fixed_poses` and the pose graph
`optim/pose_graph.optimize_pose_graph`) sum per-observation terms into
per-pose and per-landmark blocks: `out.index_add_(0, index, src)`. The
native line detector sums each pixel's vote into its Hough bin
(`frontend/line_extract._accumulate`). The JAX package writes these sums
as `.at[].add` (lldslam_tpu/optim/ba.py:104-108, 208, 217-222;
lldslam_tpu/optim/lines_ba.py:115-119, 398-428, 542-547;
lldslam_tpu/optim/pose_graph.py:80-84, 104-105;
lldslam_tpu/frontend/line_extract.py:93); they are XLA scatters, not
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
of `index`, `ordered` = `index[perm]`, and `offsets`, where segment s's rows
are `perm[offsets[s]:offsets[s + 1]]`. It makes the host wait for nothing:
a sort and a search, with every shape known on the host. It checks its
tensors once, when it is built (or at its first use, for a layout put
together by hand), so that a call of `segment_sum_` in a solver's inner
loop checks only `out` and `src`, and a pair of their shapes once. On the
card, rows whose index lies outside [0, n_segments) are left out of every
segment; on the CPU `index_add_` raises for them.

`bin_sum(bins, w, n)` is the vote: `torch.zeros(n).index_add_(0, bins,
w)`, on the CPU that call itself. On the card it sums only the pixels whose
vote is not zero, each bin's in ascending pixel order, through a layout
built with no sort (`bin_layout`: count, scan, scatter) and a kernel that
orders each bin's pixels and adds their votes (`bin_reduce`). A bin's sum
starts at +0.0 and the pixels left out add +0.0 on the CPU, which changes
nothing, so the card's bits are the CPU's. Voting pixels whose bin lies
outside [0, n) are left out on the card; on the CPU `index_add_` raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cuda_build

MAX_COLUMNS = 64      # columns a row the kernel takes
MAX_ROWS = (2**31 - 1) // MAX_COLUMNS   # rows (segments) a layout may have
SMALL_BIN = 16        # csrc/segment_sum.cu kSmallBin: a longer bin, a block
SCAN_TILE_INT4 = 256  # csrc/segment_sum.cu kScanThreads: int4 a scan tile
# launches of the CUDA kernels (incremented where a kernel is launched:
# one a segment_sum_ call, three a bin_layout, one a bin_reduce)
launches = 0

_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
_kernels: dict = {}


def _kernel(name: str):
    """The library's function `name`, bound once."""
    fn = _kernels.get(name)
    if fn is None:
        fn = _kernels[name] = getattr(cuda_build.library(), name)
    return fn


class _LayoutFields(NamedTuple):
    index: torch.Tensor    # (O,) int64 segment of each row
    perm: torch.Tensor     # (O,) int64 rows sorted by segment, stable
    offsets: torch.Tensor  # (n_segments + 1,) int64 segment starts in perm
    ordered: torch.Tensor  # (O,) int64 index[perm], the sorted segments


class SegmentLayout(_LayoutFields):
    """Rows of an (O,) index grouped by segment, in ascending row order.

    Once checked, an instance carries `_meta` (a `_Meta`); `_replace`, the
    constructor, a copy and a pickle give an unchecked instance."""

    def __reduce__(self):
        return (SegmentLayout, tuple(self))


class _Meta:
    """A checked layout's rows, segments, card index (-1 off the card), its
    tensors' data pointers, and the (out shape, src shape) pairs checked
    against it, with their columns a row."""

    __slots__ = ("rows", "n", "device", "ptrs", "shapes")

    def __init__(self, rows: int, n: int, device: int, ptrs: tuple):
        self.rows, self.n, self.device, self.ptrs = rows, n, device, ptrs
        self.shapes: dict = {}


def _check_layout(layout: SegmentLayout) -> _Meta:
    """Raises unless the layout's tensors are contiguous 1-D int64 of
    fitting lengths on one device; stores and returns its `_meta`."""
    index, perm, offsets, ordered = layout
    if not all(t.dtype == _I64 for t in layout):
        raise ValueError(f"segment_sum_: the layout must be int64, got "
                         f"{[t.dtype for t in layout]}")
    shape = index.shape
    if not (len(shape) == 1 and perm.shape == shape
            and ordered.shape == shape and offsets.dim() == 1
            and offsets.shape[0] >= 1):
        raise ValueError(f"segment_sum_: a layout of {tuple(shape)} rows has "
                         f"perm {tuple(perm.shape)}, ordered "
                         f"{tuple(ordered.shape)} and offsets "
                         f"{tuple(offsets.shape)}")
    dev = index.device
    if not all(t.device == dev for t in layout):
        raise ValueError("segment_sum_: out, src and the layout must be on "
                         "one device")
    if not all(t.is_contiguous() for t in layout):
        raise ValueError("segment_sum_: out, src and the layout must be "
                         "contiguous")
    rows, n = shape[0], offsets.shape[0] - 1
    cuda = dev.type == "cuda"
    if cuda and (rows > MAX_ROWS or n > MAX_ROWS):
        raise ValueError(f"segment_sum_ takes at most {MAX_ROWS} rows and "
                         f"segments, got {rows} and {n}")
    meta = _Meta(rows, n, index.get_device() if cuda else -1,
                 (perm.data_ptr(), ordered.data_ptr(), offsets.data_ptr())
                 if cuda else ())
    layout._meta = meta
    return meta


def segment_layout(index: torch.Tensor, n_segments: int) -> SegmentLayout:
    """The CSR layout of an (O,) int64 `index` over `n_segments` segments."""
    if index.dtype != _I64 or index.dim() != 1:
        raise ValueError(f"index must be (O,) int64, got {index.dtype} "
                         f"{tuple(index.shape)}")
    ordered, perm = torch.sort(index, stable=True)
    offsets = torch.searchsorted(
        ordered, torch.arange(n_segments + 1, dtype=_I64,
                              device=index.device))
    layout = SegmentLayout(index.contiguous(), perm, offsets, ordered)
    _check_layout(layout)
    return layout


def _bad_args(out, src, rows: int, n: int, device: int) -> str:
    """Why `out` and `src` do not fit a checked layout, or ""."""
    if out.dtype != _F32 or src.dtype != _F32:
        return (f"out and src must be float32, got out {out.dtype}, src "
                f"{src.dtype}")
    if not (src.dim() >= 1 and src.shape[0] == rows
            and out.shape == (n,) + src.shape[1:]):
        return (f"out {tuple(out.shape)} and src {tuple(src.shape)} do not "
                f"fit a layout of {rows} rows over {n} segments")
    here = out.get_device() if out.is_cuda else -1
    if not (here == device and (src.get_device() if src.is_cuda else -1)
            == device and (device >= 0 or out.device == src.device
                           == torch.device("cpu"))):
        return "out, src and the layout must be on one device"
    if not (out.is_contiguous() and src.is_contiguous()):
        return "out, src and the layout must be contiguous"
    return ""


def segment_sum_(out: torch.Tensor, layout: SegmentLayout,
                 src: torch.Tensor) -> torch.Tensor:
    """`out.index_add_(0, layout.index, src)` in a fixed order, in place;
    returns `out`. A CUDA tensor goes to the kernel, a CPU tensor to
    `index_add_` (its plain version). Raises ValueError on anything the
    kernel does not take, RuntimeError on a failed launch. (A solver's
    inner loop calls it thousands of times a loop event: the layout was
    checked when it was built, and a pair of shapes once per layout.)"""
    meta = getattr(layout, "_meta", None) or _check_layout(layout)
    device = meta.device
    shapes = (out.shape, src.shape)
    C = meta.shapes.get(shapes)
    if not (C is not None and out.is_cuda and src.is_cuda
            and out.dtype is _F32 and src.dtype is _F32
            and out.get_device() == device and src.get_device() == device
            and out.is_contiguous() and src.is_contiguous()):
        bad = _bad_args(out, src, meta.rows, meta.n, device)
        if bad:
            raise ValueError("segment_sum_: " + bad)
        if device < 0:
            return out.index_add_(0, layout.index, src)
        C = math.prod(src.shape[1:])
        if C > MAX_COLUMNS:
            raise ValueError(f"segment_sum_ takes at most {MAX_COLUMNS} "
                             f"columns, got {tuple(src.shape[1:])}")
        meta.shapes[shapes] = C
    rows, n = meta.rows, meta.n
    if n == 0 or rows == 0:
        return out
    global launches
    perm, ordered, offsets = meta.ptrs
    cuda_build.call(_kernel("lld_segment_sum"), "segment_sum_ launch",
                    device, src.data_ptr(), perm, ordered, offsets,
                    out.data_ptr(), rows, n, C)
    launches += 1
    return out


class BinLayout(NamedTuple):
    """The voting pixels of a vote grouped by bin (`bin_layout`)."""

    offsets: torch.Tensor    # (>= n + 1,) int32: bin b's pixels are
    #                          slots[offsets[b]:offsets[b + 1]]
    slots: torch.Tensor      # (O,) int32 voting pixels, any order in a bin
    long_bins: torch.Tensor  # (n, 4) int32 (bin, first slot, length, 0) of
    #                          the bins of more than SMALL_BIN pixels
    n_long: torch.Tensor     # (1,) int32 how many: long_bins[:n_long]


def _check_vote(bins: torch.Tensor, w: torch.Tensor, n: int) -> None:
    if not (bins.dtype == _I32 and w.dtype == _F32 and bins.dim() == 1
            and w.shape == bins.shape):
        raise ValueError(f"bin_sum: bins must be (O,) int32 and w (O,) "
                         f"float32, got {bins.dtype} {tuple(bins.shape)} and "
                         f"{w.dtype} {tuple(w.shape)}")
    if bins.device != w.device:
        raise ValueError("bin_sum: bins and w must be on one device")
    if not (bins.is_contiguous() and w.is_contiguous()):
        raise ValueError("bin_sum: bins and w must be contiguous")
    if not (isinstance(n, int) and n >= 0):
        raise ValueError(f"bin_sum: n must be an int >= 0, got {n!r}")
    if bins.is_cuda and bins.shape[0] > MAX_ROWS:
        raise ValueError(f"bin_sum takes at most {MAX_ROWS} pixels on the "
                         f"card, got {bins.shape[0]}")


def bin_layout(bins: torch.Tensor, w: torch.Tensor, n: int) -> BinLayout:
    """The layout of the pixels with w != 0 over n >= 1 bins, on the card:
    three kernels, no sort, no host sync."""
    _check_vote(bins, w, n)
    if not bins.is_cuda or n < 1:
        raise ValueError("bin_layout: CUDA tensors and n >= 1 only")
    rows, n4 = bins.shape[0], (n + 4) // 4
    tiles = -(-n4 // SCAN_TILE_INT4)
    z = 4 * n4 + tiles + 1
    z += -z % 4                      # keeps the next parts 16-byte aligned
    o = z + 4 * n4
    s = o + 4 * tiles                # two uint64 sums a tile before it
    buf = torch.empty(s + 4 * n + 4 + rows, dtype=_I32, device=bins.device)
    offsets, long_bins = buf[z:o], buf[s:s + 4 * n].view(n, 4)
    n_long, slots = buf[s + 4 * n:s + 4 * n + 1], buf[s + 4 * n + 4:]
    global launches
    cuda_build.call(_kernel("lld_bin_layout"), "bin_layout launch",
                    bins.get_device(), bins.data_ptr(), w.data_ptr(),
                    buf.data_ptr(), offsets.data_ptr(), buf[o:].data_ptr(),
                    long_bins.data_ptr(), n_long.data_ptr(), slots.data_ptr(),
                    rows, n, n4)
    launches += 3
    return BinLayout(offsets, slots, long_bins, n_long)


def bin_reduce(layout: BinLayout, w: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32: each bin's voting pixels' w added in ascending pixel
    order, from `bin_layout(bins, w, n)`; one kernel."""
    offsets, slots, long_bins, n_long = layout
    if not (w.is_cuda and w.dtype == _F32 and w.dim() == 1
            and w.is_contiguous() and slots.shape == w.shape
            and slots.device == w.device and offsets.shape[0] >= n + 1
            and long_bins.shape == (n, 4) and n >= 1):
        raise ValueError("bin_reduce: w must be the (O,) contiguous float32 "
                         "CUDA tensor of its bin_layout over n >= 1 bins")
    out = torch.empty(n, dtype=_F32, device=w.device)
    global launches
    cuda_build.call(_kernel("lld_bin_reduce"), "bin_reduce launch",
                    w.get_device(), w.data_ptr(), offsets.data_ptr(),
                    slots.data_ptr(), long_bins.data_ptr(), n_long.data_ptr(),
                    out.data_ptr(), w.shape[0], n)
    launches += 1
    return out


def bin_sum(bins: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32 `torch.zeros(n).index_add_(0, bins, w)` for (O,) int32
    bins and (O,) float32 votes: `index_add_` itself on the CPU, on the card
    `bin_layout` and `bin_reduce` over the pixels with w != 0 (four
    kernels), bit-equal to it."""
    _check_vote(bins, w, n)
    if not bins.is_cuda:
        return torch.zeros(n, dtype=_F32, device=w.device).index_add_(
            0, bins, w)
    if n == 0:
        return torch.zeros(0, dtype=_F32, device=w.device)
    return bin_reduce(bin_layout(bins, w, n), w, n)
