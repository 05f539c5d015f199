"""The port's fixed-order segment sum (lldslam_tpu_torch/ops/segment_sum.py)
on the CPU.

`segment_layout` is held to numpy's stable argsort and searchsorted, and
`segment_sum_` bit for bit to a serial float32 loop in row order (the
sequence of adds the CUDA kernel makes, and the order of CPU `index_add_`)
and to the JAX package's `.at[].add` on its CPU. Malformed inputs raise. A
source guard keeps every float scatter-sum of the sparse solvers
(optim/ba.py, optim/lines_ba.py, optim/pose_graph.py, parallel/) on
`segment_sum_`, and the package off torch's deterministic mode. The
solvers' own parity with JAX is held, unchanged, by tests/test_torch_loop.py,
tests/test_torch_lines.py, tests/test_torch_line_extras.py and
tests/test_torch_dist_ba.py.
"""
from pathlib import Path
import re

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lldslam_tpu_torch.ops.segment_sum import (SegmentLayout,  # noqa: E402
                                               segment_layout, segment_sum_)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "lldslam_tpu_torch"


def _index(case: str, rng) -> tuple[np.ndarray, int]:
    """(index, n_segments) of one layout case."""
    if case == "shuffled":
        return rng.permutation(np.repeat(np.arange(40), 7)), 40
    if case == "empty_segments":      # segments 0, 3, 4 and the last two
        return rng.choice([1, 2, 5, 6, 7], 300), 10
    if case == "one_segment":         # every row in segment 3 of 5
        return np.full(257, 3), 5
    if case == "long_and_short":      # the pose side's 29 long segments
        return rng.integers(0, 29, 20000), 29
    if case == "no_rows":
        return np.zeros(0, np.int64), 6
    raise ValueError(case)


CASES = ("shuffled", "empty_segments", "one_segment", "long_and_short",
         "no_rows")


@pytest.mark.parametrize("case", CASES)
def test_segment_layout_matches_numpy(case):
    idx, n = _index(case, np.random.default_rng(0))
    lay = segment_layout(torch.from_numpy(idx.astype(np.int64)), n)
    perm = np.argsort(idx, kind="stable")
    assert np.array_equal(lay.perm.numpy(), perm)
    assert np.array_equal(lay.offsets.numpy(),
                          np.searchsorted(idx[perm], np.arange(n + 1)))
    assert np.array_equal(lay.index.numpy(), idx)
    assert all(t.dtype == torch.int64 for t in lay)


def _serial(out: np.ndarray, idx: np.ndarray, src: np.ndarray) -> np.ndarray:
    """out[idx[i]] += src[i] for i in order, in float32."""
    out = out.copy()
    for i in range(len(idx)):
        out[idx[i]] = out[idx[i]] + src[i]
    return out


@pytest.mark.parametrize("cols", [(), (3,), (6, 6)])
@pytest.mark.parametrize("start", ["zero", "nonzero"])
@pytest.mark.parametrize("case", CASES)
def test_segment_sum_on_cpu_is_the_serial_loop(case, start, cols):
    """Bit-equal to a numpy float32 loop in row order and to JAX's
    `.at[].add` on the CPU, on addends spread over twelve decades (so the
    order of the adds shows in the bits)."""
    rng = np.random.default_rng(1)
    idx, n = _index(case, rng)
    O = len(idx)
    src = (rng.normal(size=(O,) + cols)
           * np.exp(3.0 * rng.normal(size=(O,) + (1,) * len(cols)))
           ).astype(np.float32)
    out0 = (np.zeros((n,) + cols, np.float32) if start == "zero" else
            rng.normal(size=(n,) + cols).astype(np.float32))
    out = torch.from_numpy(out0.copy())
    lay = segment_layout(torch.from_numpy(idx.astype(np.int64)), n)
    got = segment_sum_(out, lay, torch.from_numpy(src))
    assert got is out
    want = _serial(out0, idx, src)
    assert np.array_equal(got.numpy(), want)
    jax_sum = np.asarray(jnp.asarray(out0).at[jnp.asarray(idx)].add(
        jnp.asarray(src)))
    assert np.array_equal(got.numpy(), jax_sum)


def _bad_inputs(kind: str):
    """(out, layout, src) broken in one way."""
    idx = torch.tensor([2, 0, 2, 1], dtype=torch.int64)
    lay = segment_layout(idx, 3)
    out, src = torch.zeros(3, 6), torch.ones(4, 6)
    if kind == "src_float64":
        return out, lay, src.double()
    if kind == "out_float16":
        return out.half(), lay, src
    if kind == "layout_int32":
        return out, lay._replace(perm=lay.perm.int()), src
    if kind == "src_on_meta":
        return out, lay, src.to("meta")
    if kind == "layout_on_meta":
        return out, lay._replace(offsets=lay.offsets.to("meta")), src
    if kind == "out_strided":
        return torch.zeros(6, 3).t(), lay, src
    if kind == "src_strided":
        return out, lay, torch.ones(6, 4).t()
    if kind == "rows_mismatch":
        return out, lay, torch.ones(5, 6)
    if kind == "columns_mismatch":
        return out, lay, torch.ones(4, 3)
    if kind == "segments_mismatch":
        return torch.zeros(4, 6), lay, src
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "src_float64", "out_float16", "layout_int32", "src_on_meta",
    "layout_on_meta", "out_strided", "src_strided", "rows_mismatch",
    "columns_mismatch", "segments_mismatch"])
def test_segment_sum_rejects_bad_inputs(kind):
    out, lay, src = _bad_inputs(kind)
    with pytest.raises(ValueError, match="segment_sum_"):
        segment_sum_(out, lay, src)


def test_segment_layout_rejects_bad_index():
    with pytest.raises(ValueError, match="int64"):
        segment_layout(torch.tensor([0, 1], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="int64"):
        segment_layout(torch.zeros((2, 2), dtype=torch.int64), 2)
    assert isinstance(segment_layout(torch.tensor([1, 0]), 2), SegmentLayout)


SCATTER = re.compile(r"\b(index_add_?|scatter_add_?)\s*\(")
SOLVER_FILES = ("optim/ba.py", "optim/lines_ba.py", "optim/pose_graph.py")


def test_solvers_sum_through_the_segment_kernel():
    """No float index_add / index_add_ / scatter_add call is left in the
    sparse solvers or in parallel/ (every one went to segment_sum_, whose
    card route is the fixed-order kernel), each solver file calls
    segment_sum_, and no module of the package switches torch's
    deterministic mode."""
    files = [PKG / f for f in SOLVER_FILES] + sorted(
        (PKG / "parallel").glob("*.py"))
    bad = [f"{f.relative_to(PKG)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if SCATTER.search(line)]
    assert not bad, bad
    for f in SOLVER_FILES:
        assert "segment_sum_(" in (PKG / f).read_text(), f
    det = [str(f.relative_to(PKG)) for f in PKG.rglob("*.py")
           if "use_deterministic_algorithms" in f.read_text()]
    assert not det, det
