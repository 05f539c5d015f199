"""The port's CUDA kernels and its frame build on an NVIDIA GPU.

These tests need the card and `nvcc`: a CUDA kernel has no CPU mode, so
without a card each test skips with the reason. They import no JAX, so they
run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same device tensors
at the main path's shapes (lldslam_tpu_torch.io.kernel_inputs; exact: K1a
and K1b sum integer intensities and round as eager PyTorch does, K2g
computes integer distances under one tie contract), the three kernels and
the projection search run without a host synchronisation, and the frame
build on the card is held to the frame build on the CPU (integer pipeline exact; descriptors and stereo through the same
tolerances as the JAX parity tests, since sin/cos/atan2 may differ by an ulp
between the card's and the CPU's math libraries). One loop correction on the
card is held to the same correction on the CPU within the tolerances the
JAX parity test (tests/test_torch_loop.py) states, and the solver loops of
a loop event run without a host synchronisation. The single-view frame
build of the monocular and RGB-D paths launches K1a once on one view's
rounded float levels, exact against the plain version; the monocular
initializer and the rectifier's remap on the card agree with the CPU. With a
leading sequence axis (the multi-sequence driver's S frames) each kernel
launches once for all S and equals both its plain version and S = 1
launches; a kernel given tensors on a second card launches there while the
first is current (skipped on a one-card machine); a loop correction with
map lines on the card is held to the CPU like the points-only one; the
native line detector is bit-identical across calls on the card and agrees
with the CPU; the pipelined tracker's chained step runs without a host
synchronisation (with native lines, the whole dispatch of a frame: build,
line detector on both views, stereo line match, chained line step), the
detector alone makes none and its vote equals the CPU's bit for bit, and a
pipelined run on the card gives the CPU's keyframes. Bundle adjustment on
the dense reduced system agrees with the CPU and repeats bit for bit.
The distributed bundle adjustment on a one-rank NCCL group runs without a
host synchronisation, and the loop closer's distributed global BA on the
card equals its single route bit for bit. The fixed-order segment-sum
kernel equals CPU index_add_ bit for bit on random layouts (every width it
is compiled for, long and short segments, a segment of 8,000 rows, every
row in one segment, segments far above rows), the vote's entry (bin_sum)
equals CPU index_add_ over every pixel on a KITTI view and on synthetic
votes with bins of thousands of pixels, and the sparse solvers of a loop
event (pose graph, global BA, joint point+line global BA, line
refinement) give the same bits in two runs.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lldslam_tpu_torch.config import CameraConfig, SlamConfig
from lldslam_tpu_torch.frontend import frame
from lldslam_tpu_torch.frontend.matching import (FrameFeatures, MapPointView,
                                                 search_by_projection)
from lldslam_tpu_torch.geometry import lines as glines, se3
from lldslam_tpu_torch.io.synthetic import (add_loop_lines, make_loop_map,
                                            make_sequence)
from lldslam_tpu_torch.loop.closing import LoopCloser
from lldslam_tpu_torch.io import kernel_inputs
from lldslam_tpu_torch.ops import (match_best2, orb_describe, segment_sum,
                                   stereo_sad)
from lldslam_tpu_torch.ops.orb import OrbConfig
from lldslam_tpu_torch.ops import rectify
from lldslam_tpu_torch.optim import (ba, initializer, lines_ba, pose_graph,
                                     pose_opt, sim3_solver)
from lldslam_tpu_torch.slammap.map_store import MapStore
from lldslam_tpu_torch.system import _default_vocabulary

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels of "
                    "lldslam_tpu_torch have no CPU mode")
    return torch.device("cuda", 0)


def _equal(got, want):
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_orb_describe_equals_plain(dev):
    """K1a at the frame build's shapes: angles and descriptors exact."""
    args = kernel_inputs.describe_inputs(np.random.default_rng(0), dev)
    before = orb_describe.launches
    got = orb_describe.describe(*args)
    assert orb_describe.launches == before + 1
    _equal(got, orb_describe.describe_plain(*args))


def test_stereo_sad_equals_plain(dev):
    """K1b at the frame build's shapes with forced SAD ties: exact."""
    args = kernel_inputs.sad_inputs(np.random.default_rng(1), dev)
    before = stereo_sad.launches
    got = stereo_sad.sad_refine(*args)
    assert stereo_sad.launches == before + 1
    _equal(got, stereo_sad.sad_refine_plain(*args))
    assert int((got[1] == 0).sum()) >= 32


@pytest.mark.parametrize("M,N", [(4096, 2048), (2048, 2048), (8192, 2048),
                                 (300, 77)])
def test_gated_best2_equals_plain(dev, M, N):
    """K2g: all four outputs exact, tied columns go to the lower index, an
    empty row and a one-candidate row follow the XLA contract."""
    args = kernel_inputs.gated_best2_inputs(np.random.default_rng(2), dev, M,
                                            N)
    before = match_best2.launches
    got = match_best2.gated_best2(*args, site="test")
    assert match_best2.launches == before + 1
    _equal(got, match_best2.gated_best2_plain(*args))
    e, o = kernel_inputs.EMPTY_ROW, kernel_inputs.ONE_ROW
    assert int(got[1][e]) == 10000 and int(got[0][e]) == 0
    assert int(got[0][o]) == kernel_inputs.ONE_COL
    assert int(got[2][o]) == 10000


def _batched_sets(dev, S=4):
    """S seeded argument sets of each kernel at the main path's shapes."""
    rng = np.random.default_rng(7)
    return dict(
        describe=[kernel_inputs.describe_inputs(rng, dev) for _ in range(S)],
        sad=[kernel_inputs.sad_inputs(rng, dev) for _ in range(S)],
        gated=[kernel_inputs.gated_best2_inputs(rng, dev, 4096)
               for _ in range(S)])


def _stack_args(sets):
    return tuple(torch.stack(xs) if torch.is_tensor(xs[0]) else xs[0]
                 for xs in zip(*sets))


@pytest.mark.parametrize("kernel", ["describe", "sad", "gated"])
def test_batched_kernels_equal_plain_and_single_launches(dev, kernel):
    """S = 4 frames at the main path's shapes in one launch: every output
    exact against the plain version of the batch and, sequence by sequence,
    against an S = 1 launch on that sequence alone; one launch counted."""
    mod, fn, plain = dict(
        describe=(orb_describe, orb_describe.describe,
                  orb_describe.describe_plain),
        sad=(stereo_sad, stereo_sad.sad_refine, stereo_sad.sad_refine_plain),
        gated=(match_best2, match_best2.gated_best2,
               match_best2.gated_best2_plain))[kernel]
    sets = _batched_sets(dev)[kernel]
    args = _stack_args(sets)
    before = mod.launches
    got = fn(*args)
    assert mod.launches == before + 1
    _equal(got, plain(*args))
    for s, one in enumerate(sets):
        _equal([g[s] for g in got], fn(*one))


def test_kernels_launch_on_the_tensors_device():
    """With card 0 current, each kernel given tensors on card 1 launches
    on card 1 (on its current stream) and equals its plain version there.
    Needs two cards: the machine the port is measured on has one, so this
    test skips there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    d1 = torch.device("cuda", 1)
    rng = np.random.default_rng(8)
    cases = ((orb_describe.describe, orb_describe.describe_plain,
              kernel_inputs.describe_inputs(rng, d1)),
             (stereo_sad.sad_refine, stereo_sad.sad_refine_plain,
              kernel_inputs.sad_inputs(rng, d1)),
             (match_best2.gated_best2, match_best2.gated_best2_plain,
              kernel_inputs.gated_best2_inputs(rng, d1, 4096)))
    with torch.cuda.device(0):
        for fn, plain, args in cases:
            got = fn(*args)
            assert torch.cuda.current_device() == 0
            assert all(g.device == d1 for g in got)
            torch.cuda.synchronize(d1)
            want = plain(*args)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_gated_best2_rejects_bad_inputs(dev):
    args = list(kernel_inputs.gated_best2_inputs(np.random.default_rng(3), dev,
                                                 300, 77))
    bad = dict(a=(0, args[0][:, :4]), pred_oct=(5, args[5].long()),
               xy=(8, args[8].t().contiguous().t()),
               valid=(11, args[11][:10]))
    for i, t in bad.values():
        with pytest.raises(ValueError):
            match_best2.gated_best2(*args[:i], t, *args[i + 1:])


SEGMENT_CASES = {
    # (rows, segments, columns per row, nonzero start)
    "pose_side_hcc": (20000, 29, (6, 6), False),   # long segments
    "pose_side_vec": (20000, 29, (6,), True),
    "point_side": (20000, 5000, (3, 3), False),    # about 4 rows a segment
    "point_seen": (20000, 5000, (), True),
    "pose_graph": (120, 29, (7, 7), True),
    "empty_segments": (3000, 400, (4,), True),
    # every width the kernel is compiled for, and two generic ones
    "width_3": (9000, 3000, (3,), True),
    "width_7": (300, 24, (7,), False),
    "width_16": (8000, 300, (4, 4), True),
    "width_18_dense_cells": (8000, 29 * 5000, (6, 3), False),  # by row
    "generic_5": (5000, 700, (5,), True),
    "generic_64": (4000, 40, (8, 8), True),
    # a segment of more than 4,096 rows; every row in one segment; segments
    # far above rows (mostly empty)
    "long_segment": (12000, 3, (6,), True),
    "long_with_empty": (20000, 60, (6,), True),
    "one_segment": (10000, 1, (9,), True),
    "mostly_empty": (3000, 400000, (), True),
}


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_sum_equals_cpu_index_add(dev, case):
    """The segment-sum kernel against CPU index_add_ (its plain version)
    on random layouts, bit for bit, and against a second launch; addends
    spread over twelve decades so the order of the adds shows in the
    bits. "empty_segments" and "long_with_empty" leave every other
    segment without rows;
    "long_segment" puts 8,000 rows in segment 1; the cases cover every
    width the kernel is compiled for (1, 3, 4, 6, 7, 9, 16, 18, 36, 49) and
    two others, long segments (a thread per output) and short ones (a
    thread per row; segments far above rows too), and nonzero start
    values."""
    O, n, cols, nonzero = SEGMENT_CASES[case]
    rng = np.random.default_rng(7)
    idx = rng.integers(0, n, O)
    if case in ("empty_segments", "long_with_empty"):
        idx = 2 * (idx // 2)
    if case == "long_segment":
        idx[rng.choice(O, 8000, replace=False)] = 1
    src = (rng.normal(size=(O,) + cols) * np.exp(
        3.0 * rng.normal(size=(O,) + (1,) * len(cols)))).astype(np.float32)
    out0 = (rng.normal(size=(n,) + cols) if nonzero else
            np.zeros((n,) + cols)).astype(np.float32)
    want = torch.from_numpy(out0.copy()).index_add_(
        0, torch.from_numpy(idx), torch.from_numpy(src))
    lay = segment_sum.segment_layout(torch.from_numpy(idx).to(dev), n)
    before = segment_sum.launches
    runs = [segment_sum.segment_sum_(torch.from_numpy(out0).to(dev), lay,
                                     torch.from_numpy(src).to(dev))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert segment_sum.launches - before == 2
    assert torch.equal(runs[0].cpu(), want)
    assert torch.equal(runs[0], runs[1])


def _vote_case(case: str, rng) -> tuple[np.ndarray, np.ndarray, int]:
    """(bins int32, votes float32, n) of a synthetic vote over the pixels
    of a KITTI view (1241 x 376) and 77,880 bins: a tenth of the pixels
    vote, their votes spread over twelve decades; "long_bin" gives bin 7
    6,000 voting pixels in one run of the image, bin 9 5,000 and bin 11
    800 spread over all of it; "all_zero" has no vote, "one_pixel" one;
    "negative_and_signed_zeros" flips half the signs and sets some votes
    to -0.0 (which the card leaves out and the CPU adds, to the same
    bits)."""
    O, n = 1241 * 376, 77880
    bins = rng.integers(0, n, O).astype(np.int32)
    w = np.where(rng.random(O) < 0.1,
                 np.exp(3.0 * rng.normal(size=O)), 0.0).astype(np.float32)
    if case == "long_bin":
        run = np.arange(100000, 106000)
        spread = rng.choice(np.setdiff1d(np.arange(O), run), 5800,
                            replace=False)
        bins[run], bins[spread[:5000]], bins[spread[5000:]] = 7, 9, 11
        w[run] = np.exp(3.0 * rng.normal(size=run.size))
        w[spread] = np.exp(3.0 * rng.normal(size=spread.size))
    elif case == "all_zero":
        w[:] = 0.0
    elif case == "one_pixel":
        w[:] = 0.0
        w[O // 3] = 3.25
    elif case == "negative_and_signed_zeros":
        w = np.where(rng.random(O) < 0.5, -w, w).astype(np.float32)
        w[rng.random(O) < 0.05] = -0.0
    return bins, w, n


@pytest.mark.parametrize("case", ["kitti_view", "long_bin", "all_zero",
                                  "one_pixel", "negative_and_signed_zeros"])
def test_bin_sum_equals_cpu_index_add(dev, case):
    """The vote's entry (ops/segment_sum.bin_sum: layout with no sort, then
    the ordering sum) against CPU index_add_ over every pixel, bit for bit
    (signs of zeros included), on a second call too: the seeded lines
    world's KITTI view (its Sobel bins and votes, computed on the CPU) and
    synthetic votes with bins of 6,000, 5,000 and 800 voting pixels, no
    vote, one vote. Four launches a call; the layout's offsets count each
    bin's voting pixels."""
    from lldslam_tpu_torch.frontend import line_extract as le
    if case == "kitti_view":
        cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=386.1448, width=1241, height=376).stereo_camera()
        img = make_sequence(cam, 1, seed=2, with_lines=True)[0][0]
        cfg = le.LineDetConfig(max_lines=256)
        _, _, mag, edge, _, b, n_rho = le._votes(
            torch.from_numpy(img).float(), cfg)
        bins = b.reshape(-1).numpy()
        w = torch.where(edge, mag, 0.0).reshape(-1).numpy()
        n = n_rho * cfg.n_phi
    else:
        bins, w, n = _vote_case(case, np.random.default_rng(11))
    bc, wc = torch.from_numpy(bins), torch.from_numpy(w)
    want = torch.zeros(n).index_add_(0, bc, wc)
    bd, wd = bc.to(dev), wc.to(dev)
    before = segment_sum.launches
    got = [segment_sum.bin_sum(bd, wd, n) for _ in range(2)]
    lay = segment_sum.bin_layout(bd, wd, n)
    torch.cuda.synchronize()
    assert segment_sum.launches - before == 11
    assert torch.equal(got[0].cpu(), want) and torch.equal(got[0], got[1])
    assert torch.equal(torch.signbit(got[0].cpu()), torch.signbit(want))
    counts = torch.bincount(bc[wc != 0].long(), minlength=n)
    offsets = lay.offsets[:n + 1].cpu().long()
    assert torch.equal(offsets[1:] - offsets[:-1], counts)
    assert int(lay.n_long) == int((counts > segment_sum.SMALL_BIN).sum())
    if case == "long_bin":
        assert int(counts.max()) == 6000


def test_bin_sum_rejects_bad_inputs_on_card(dev):
    """int64 bins and a CPU vote beside card bins raise before any
    launch."""
    bins = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    w = torch.ones(3, device=dev)
    before = segment_sum.launches
    with pytest.raises(ValueError, match="int32"):
        segment_sum.bin_sum(bins.long(), w, 2)
    with pytest.raises(ValueError, match="one device"):
        segment_sum.bin_sum(bins, w.cpu(), 2)
    assert segment_sum.launches == before


def test_segment_sum_rejects_bad_inputs_on_card(dev):
    """More than 64 columns a row, and a CPU tensor beside card tensors,
    raise before any launch."""
    lay = segment_sum.segment_layout(torch.tensor([1, 0, 1], device=dev), 2)
    before = segment_sum.launches
    with pytest.raises(ValueError, match="columns"):
        segment_sum.segment_sum_(torch.zeros((2, 65), device=dev), lay,
                                 torch.ones((3, 65), device=dev))
    with pytest.raises(ValueError, match="one device"):
        segment_sum.segment_sum_(torch.zeros((2, 6), device=dev), lay,
                                 torch.ones((3, 6)))
    assert segment_sum.launches == before


def test_frame_build_on_card_matches_cpu(dev):
    cam = CameraConfig().stereo_camera()
    frames = make_sequence(cam, 1, seed=3)
    pair = np.stack(frames[0])
    cfg = OrbConfig(n_features=2000)
    k1 = orb_describe.launches, stereo_sad.launches
    g = frame.build_frame_pair(torch.from_numpy(pair).to(dev), cam, cfg)
    torch.cuda.synchronize()
    assert (orb_describe.launches - k1[0], stereo_sad.launches - k1[1]) \
        == (1, 1)
    c = frame.build_frame_pair(torch.from_numpy(pair), cam, cfg)
    gf, cf = g.feats, c.feats
    assert torch.equal(gf.xy.cpu(), cf.xy)
    assert torch.equal(gf.octave.cpu(), cf.octave)
    assert torch.equal(gf.valid.cpu(), cf.valid)
    v = cf.valid
    assert (gf.angle.cpu() - cf.angle)[v].abs().max() <= 1e-5
    same = (gf.desc.cpu() == cf.desc).all(-1)[v]
    assert same.float().mean() >= 0.995
    gu, cu = gf.ur.cpu(), cf.ur
    assert ((gu >= 0) == (cu >= 0)).float().mean() >= 0.99
    both = (gu >= 0) & (cu >= 0)
    assert ((gu - cu)[both].abs() <= 1e-3).float().mean() >= 0.99


def _angle(Ra, Rb):
    d = np.einsum("kji,kjl->kil", Ra.astype(np.float64), Rb.astype(np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                  d[:, 1, 0] - d[:, 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1) / 2, 0, 1))


def test_loop_correct_on_card_matches_cpu(dev):
    """The synthetic loop map (io.synthetic.make_loop_map): Sim3 between
    keyframe 21 and keyframe 2 on the CPU, then the guided matches (K2 at
    8192 rows on the card, exact against the CPU) and `_correct` (pose
    graph, remap, fusion through K2, global BA) on both devices: poses
    within 2e-3 m and 1e-3 rad, points within 5e-3 m (median), the same
    observations on >= 99.9% of the slots."""
    cfg = SlamConfig(camera=CameraConfig(fx=400.0, fy=400.0, cx=256.0,
                                         cy=192.0, bf=200.0, width=512,
                                         height=384),
                     orb=OrbConfig(n_features=600))
    voc = _default_vocabulary()
    assert voc is not None
    cam = cfg.camera.stereo_camera()
    stores = [MapStore(cam, cfg.orb, max_kf=64, max_pt=20000) for _ in "ab"]
    for st in stores:
        make_loop_map(st)
    cpu = LoopCloser(stores[0], voc, cfg, device="cpu")
    card = LoopCloser(stores[1], voc, cfg, device=dev)
    res = cpu._compute_sim3(21, 2)
    assert res is not None
    S = res[0]
    Tm = stores[0].kf_pose[2]
    T_corr = np.eye(4, dtype=np.float32)
    T_corr[:3, :3] = S[0] @ Tm[:3, :3]
    T_corr[:3, 3] = S[2] * (S[0] @ Tm[:3, 3]) + S[1]
    pids = cpu._loop_points(2)
    before = match_best2.launches_by_site.get("loop", 0)
    kp2lp = card._project_match(21, pids, T_corr, th=2.5)
    torch.cuda.synchronize()
    assert match_best2.launches_by_site["loop"] == before + 1
    assert np.array_equal(kp2lp, cpu._loop_guided[0])
    card._loop_guided = (kp2lp, pids)
    cpu._correct(21, 2, S)
    card._correct(21, 2, S)
    torch.cuda.synchronize()
    assert match_best2.launches_by_site["loop"] > before + 1   # fusion
    a, b = stores
    K = a.n_kf
    np.testing.assert_allclose(b.kf_pose[:K, :3, 3], a.kf_pose[:K, :3, 3],
                               rtol=0, atol=2e-3)
    assert _angle(a.kf_pose[:K, :3, :3], b.kf_pose[:K, :3, :3]).max() < 1e-3
    assert (a.kf_pt_ids[:K] == b.kf_pt_ids[:K]).mean() >= 0.999
    live = a.pt_valid[:a.n_pt] & b.pt_valid[:b.n_pt]
    err = np.linalg.norm(a.pt_pos[:a.n_pt][live] - b.pt_pos[:b.n_pt][live],
                         axis=-1)
    assert np.median(err) < 5e-3


def test_loop_correct_with_lines_on_card_matches_cpu(dev):
    """The loop map with map lines (io.synthetic.add_loop_lines): the same
    correction as above, whose line half is the map-line remap and the joint
    point+line global BA, on both devices: poses within 2e-3 m and 1e-3
    rad, points within 5e-3 m (median), the map lines moved by the
    correction and, card against CPU, within 2e-3 of their distance
    (median; 2e-2 at most) and 1e-3 in direction (1 - |cos|)."""
    cfg = SlamConfig(camera=CameraConfig(fx=400.0, fy=400.0, cx=256.0,
                                         cy=192.0, bf=200.0, width=512,
                                         height=384),
                     orb=OrbConfig(n_features=600))
    voc = _default_vocabulary()
    cam = cfg.camera.stereo_camera()
    stores = [MapStore(cam, cfg.orb, max_kf=64, max_pt=20000) for _ in "ab"]
    for st in stores:
        add_loop_lines(st, make_loop_map(st))
    cpu = LoopCloser(stores[0], voc, cfg, device="cpu")
    card = LoopCloser(stores[1], voc, cfg, device=dev)
    S = cpu._compute_sim3(21, 2)[0]
    Tm = stores[0].kf_pose[2]
    T_corr = np.eye(4, dtype=np.float32)
    T_corr[:3, :3] = S[0] @ Tm[:3, :3]
    T_corr[:3, 3] = S[2] * (S[0] @ Tm[:3, 3]) + S[1]
    pids = cpu._loop_points(2)
    kp2lp = card._project_match(21, pids, T_corr, th=2.5)
    assert np.array_equal(kp2lp, cpu._loop_guided[0])
    card._loop_guided = (kp2lp, pids)
    before = stores[1].ln_x0[:stores[1].n_ln].copy()
    cpu._correct(21, 2, S)
    card._correct(21, 2, S)
    torch.cuda.synchronize()
    a, b = stores
    K, n = a.n_kf, a.n_ln
    np.testing.assert_allclose(b.kf_pose[:K, :3, 3], a.kf_pose[:K, :3, 3],
                               rtol=0, atol=2e-3)
    assert _angle(a.kf_pose[:K, :3, :3], b.kf_pose[:K, :3, :3]).max() < 1e-3
    live = a.pt_valid[:a.n_pt] & b.pt_valid[:b.n_pt]
    assert np.median(np.linalg.norm(
        a.pt_pos[:a.n_pt][live] - b.pt_pos[:b.n_pt][live], axis=-1)) < 5e-3
    lv = a.ln_valid[:n] & b.ln_valid[:n]
    assert lv.sum() >= 100
    assert np.isfinite(b.ln_x0[:n]).all() and np.isfinite(b.ln_dir[:n]).all()
    assert np.linalg.norm(b.ln_x0[:n] - before, axis=-1).max() > 0.05
    ex = np.linalg.norm(b.ln_x0[:n] - a.ln_x0[:n], axis=-1)[lv] \
        / np.maximum(1.0, np.linalg.norm(a.ln_x0[:n], axis=-1)[lv])
    ed = np.abs(np.abs(np.sum(b.ln_dir[:n] * a.ln_dir[:n], -1)) - 1.0)[lv]
    assert np.median(ex) < 2e-3 and ex.max() < 2e-2, (np.median(ex), ex.max())
    assert ed.max() < 1e-3


def _loop_solver_problems(dev) -> SimpleNamespace:
    """The solver inputs of the loop-event tests, seeded: a 24-keyframe
    Sim(3) chain with a loop edge (pose graph), a Sim(3) between two point
    sets (GN refinement), 4 keyframes x 300 points (sparse BA) with 40
    lines (joint BA, line refinement), keyframe 1's point and line
    observations (pose LM) and keyframes 1-3 batched."""
    rng = np.random.default_rng(0)
    cam = CameraConfig(fx=400.0, fy=400.0, cx=256.0, cy=192.0, bf=200.0,
                       width=512, height=384).stereo_camera()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    K = 24
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = 0.5 * np.arange(K)
    xi[:, 4] = 0.05 * np.arange(K)
    T = se3.exp(torch.from_numpy(xi)).numpy()
    T0 = se3.exp(torch.from_numpy(
        rng.normal(0, 0.02, (K, 6)).astype(np.float32))).numpy() @ T
    e_i = np.r_[np.arange(1, K), 0]
    e_j = np.r_[np.arange(K - 1), K - 1]
    M = T[e_i] @ np.linalg.inv(T[e_j])
    g = pose_graph.PoseGraph(
        R=t(T0[:, :3, :3]), t=t(T0[:, :3, 3]), s=t(np.ones(K, np.float32)),
        fixed=t(np.arange(K) == 0), e_i=t(e_i), e_j=t(e_j),
        m_R=t(M[:, :3, :3]), m_t=t(M[:, :3, 3]),
        m_s=t(np.ones(K, np.float32)), e_valid=t(np.ones(K, bool)))

    n = 100
    P2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(5, 15, n)], -1).astype(np.float32)
    R = T[1, :3, :3] @ T[2, :3, :3]
    P1 = (P2 @ R.T + np.array([0.3, 0.1, 0.5], np.float32)).astype(np.float32)
    uv = lambda P: np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx,
                             cam.fy * P[:, 1] / P[:, 2] + cam.cy], -1)
    ones = t(np.ones(n, np.float32))
    dR = se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.01, -0.005, 0.008])).numpy()
    S0 = (t(dR[:3, :3] @ R), t(np.array([0.35, 0.05, 0.45], np.float32)),
          t(np.float32(1.0)))
    sim3_args = (t(P1), t(P2), t(uv(P1).astype(np.float32)),
                 t(uv(P2).astype(np.float32)), ones, ones,
                 t(np.ones(n, bool)))

    Pw = np.stack([rng.uniform(-4, 4, 300), rng.uniform(-2, 2, 300),
                   rng.uniform(6, 15, 300)], -1).astype(np.float32)
    kk, pp = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(300),
                                             indexing="ij"))
    Xc = np.einsum("oij,oj->oi", T[kk, :3, :3], Pw[pp]) + T[kk, :3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
    uvr = np.stack([u, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy,
                    u - cam.bf / Xc[:, 2]], -1).astype(np.float32)
    problem = ba.BAProblem(
        poses=t(T0[:4]), points=t(Pw + rng.normal(0, 0.05, Pw.shape)
                                  .astype(np.float32)),
        pose_fixed=t(np.arange(4) == 0), point_valid=t(np.ones(300, bool)),
        obs=ba.BAObs(k=t(kk), p=t(pp), uvr=t(uvr),
                     inv_sigma2=t(np.ones(len(kk), np.float32)),
                     is_stereo=t(np.ones(len(kk), bool)),
                     valid=t(np.ones(len(kk), bool))))
    chi2_0 = ba._total_cost(cam, problem._replace(
        obs=problem.obs._replace(k=problem.obs.k.long(),
                                 p=problem.obs.p.long())))
    err_0 = pose_graph.total_error(g)

    # lines seen by the 4 keyframes in both views: the joint global BA
    # (noisy line states) and keyframe 1's joint point+line pose LM
    L = 40
    mid = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                    rng.uniform(6, 15, L)], -1)
    dl = rng.normal(size=(L, 3))
    dl /= np.linalg.norm(dl, axis=-1, keepdims=True)
    A, B = mid - dl, mid + dl
    X0 = (A - np.sum(A * dl, -1, keepdims=True) * dl).astype(np.float32)
    lk, ll = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(L),
                                             indexing="ij"))

    def line_px(P, off):
        Pc = np.einsum("oij,oj->oi", T[lk, :3, :3], P[ll]) + T[lk, :3, 3]
        Pc[:, 0] -= off
        return t(uv(Pc).astype(np.float32))

    ends = [line_px(P, off) for off in (0.0, cam.baseline) for P in (A, B)]
    lobs = lines_ba.LineBAObs(
        k=t(lk), l=t(ll), x1l=ends[0], x2l=ends[1], x1r=ends[2], x2r=ends[3],
        octave=t(np.zeros(len(lk), np.int32)),
        has_r=t(np.ones(len(lk), bool)), valid=t(np.ones(len(lk), bool)))
    q0, a0 = glines.minimal_from_x0dir(
        t(X0 + rng.normal(0, 0.05, X0.shape).astype(np.float32)),
        t(dl.astype(np.float32)))
    joint = lines_ba.JointProblem(base=problem, q=q0, alpha=a0,
                                  line_valid=t(np.ones(L, bool)), lobs=lobs)
    on1, ln1 = kk == 1, lk == 1
    pobs = pose_opt.PointPoseObs(
        X=t(Pw[pp[on1]]), obs=t(uvr[on1]),
        inv_sigma2=t(np.ones(on1.sum(), np.float32)),
        is_stereo=t(np.ones(on1.sum(), bool)), valid=t(np.ones(on1.sum(), bool)))
    lpobs = pose_opt.LinePoseObs(
        X0=t(X0), d=t(dl.astype(np.float32)), x1_l=ends[0][t(ln1)],
        x2_l=ends[1][t(ln1)], x1_r=ends[2][t(ln1)], x2_r=ends[3][t(ln1)],
        octave=t(np.zeros(L, np.int32)), has_right=t(np.ones(L, bool)),
        valid=t(np.ones(L, bool)))
    T1 = t(T0[1])
    on = [kk == k for k in (1, 2, 3)]
    pobs_b = pose_opt.PointPoseObs(
        X=t(np.stack([Pw[pp[o]] for o in on])),
        obs=t(np.stack([uvr[o] for o in on])),
        inv_sigma2=t(np.ones((3, 300), np.float32)),
        is_stereo=t(np.ones((3, 300), bool)), valid=t(np.ones((3, 300), bool)))
    T_b0 = t(T0[1:4])
    return SimpleNamespace(**{k: v for k, v in locals().items()
                              if k not in ("t", "dev")})


def test_loop_solvers_never_wait_for_the_host(dev):
    """The LM and GN loops of a loop event (the Sim(3) pose graph, 15 x 48
    CG steps; the Sim3 refinement, 10 GN steps; global BA on the CG path,
    10 x 64 CG steps, points only and joint point+line; the fixed-pose line
    refinement), the segment layout and segment sum they build and launch,
    and the tracker's joint point+line pose LM (2 x 6 steps) run under
    CUDA's sync debug mode set to "error": no operation inside them makes
    the host wait for the card. Their results are finite and reduce their
    errors."""
    p = _loop_solver_problems(dev)
    cam, g, T, T0, n = p.cam, p.g, p.T, p.T0, p.n
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the segment layout and sum of the sparse solvers, as they build
        # and launch them
        lay = segment_sum.segment_layout(p.problem.obs.k.long(), 4)
        seg = segment_sum.segment_sum_(
            torch.zeros((4, 6, 6), device=dev), lay,
            torch.ones((lay.index.shape[0], 6, 6), device=dev))
        g_opt = pose_graph.optimize_pose_graph(g, iters=15, cg_iters=48)
        (Rs, ts, ss), _, n_inl = sim3_solver.refine_sim3(cam, cam, p.S0,
                                                         *p.sim3_args)
        solved, chi2 = ba.ba_solve(cam, p.problem, iters=10, cg_iters=64)
        jsolved, _, chi2_l = lines_ba.joint_ba_solve_cg(cam, p.joint,
                                                        iters=10, cg_iters=64)
        q_r, a_r = lines_ba.refine_lines_fixed_poses(cam, p.joint)
        T_opt, _, ln_in, _ = pose_opt.optimize_pose(cam, p.T1, p.pobs,
                                                    p.lpobs, rounds=2, iters=6)
        # the multi-sequence driver's batched pose LM: keyframes 1-3 at once
        T_b, in_b, _, n_b = pose_opt.optimize_pose(cam, p.T_b0, p.pobs_b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(seg.sum((1, 2)).cpu(), 36 * torch.bincount(
        lay.index.cpu(), minlength=4).float())
    assert float(pose_graph.total_error(g_opt)) < 0.1 * float(p.err_0)
    assert torch.isfinite(Rs).all() and torch.isfinite(ts).all()
    assert int(n_inl) >= 0.9 * n
    assert torch.isfinite(chi2).all()
    assert float(ba._total_cost(cam, solved)) < 0.5 * float(p.chi2_0)
    assert torch.isfinite(jsolved.q).all() and torch.isfinite(chi2_l).all()
    assert float(chi2_l.median()) < 1e-2
    assert torch.isfinite(q_r).all() and torch.isfinite(a_r).all()
    err1 = np.linalg.norm(T_opt.cpu().numpy()[:3, 3] - T[1, :3, 3])
    assert err1 < 0.2 * np.linalg.norm(T0[1, :3, 3] - T[1, :3, 3])
    assert bool(ln_in.all())
    err_b = np.linalg.norm(T_b.cpu().numpy()[:, :3, 3] - T[1:4, :3, 3], axis=-1)
    assert (err_b < 0.2 * np.linalg.norm(T0[1:4, :3, 3] - T[1:4, :3, 3],
                                         axis=-1)).all()
    assert (n_b.cpu().numpy() >= 290).all() and tuple(in_b.shape) == (3, 300)


def test_loop_solvers_repeat_on_card(dev):
    """Two runs of each sparse solver of a loop event on the same inputs
    give the same bits: the pose graph (15 x 48), global BA (10 x 64), the
    joint point+line global BA (10 x 64) and the fixed-pose line
    refinement. Their float scatter-sums go through the fixed-order
    segment-sum kernel, which launches in each."""
    p = _loop_solver_problems(dev)
    cam = p.cam
    runs = (
        lambda: tuple(pose_graph.optimize_pose_graph(p.g, iters=15,
                                                     cg_iters=48)),
        lambda: ba.ba_solve(cam, p.problem, iters=10, cg_iters=64),
        lambda: lines_ba.joint_ba_solve_cg(cam, p.joint, iters=10,
                                           cg_iters=64),
        lambda: lines_ba.refine_lines_fixed_poses(cam, p.joint))
    flat = lambda x: [t for y in x for t in (flat(y) if isinstance(
        y, tuple) else [y])]
    for run in runs:
        before = segment_sum.launches
        a = flat(run())
        launched = segment_sum.launches - before
        b = flat(run())
        torch.cuda.synchronize()
        assert launched > 0
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))


def test_dist_solvers_on_nccl_never_wait_for_the_host(dev):
    """The landmark-sharded point BA and joint point+line BA
    (parallel.dist_schur) on the one-rank NCCL group of make_mesh, 10 x 64
    CG steps, under CUDA's sync debug mode set to "error": an all_reduce on
    NCCL makes the card's stream wait, never the host, and the segment
    layouts each solve builds of its shard and the segment sums it launches
    make no host sync either. Results finite, the robust cost at least
    halved, the lines' chi2 small."""
    from lldslam_tpu_torch import graft_entry
    from lldslam_tpu_torch.parallel import dist_schur

    cam = graft_entry.DRYRUN_CAM
    problem, joint = graft_entry.dryrun_problems(4)
    group = dist_schur.make_mesh(device=dev)
    dp, _ = dist_schur.make_dist_problem(problem, 1)
    local = dist_schur.place(dp, group, dev)
    djp, _, _ = dist_schur.make_dist_joint_problem(joint, 1)
    local_j = dist_schur.place_joint(djp, group, dev)
    cost_0 = float(ba._total_cost(cam, local))
    launches = segment_sum.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, points, chi2 = dist_schur.dist_ba_solve(
            cam, local, group, iters=10, cg_iters=64)
        poses_j, points_j, q, alpha, chi2_j = dist_schur.dist_joint_ba_solve(
            cam, local_j, group, iters=10, cg_iters=64)
        chi2_l = lines_ba._line_terms(cam, local_j._replace(
            base=local_j.base._replace(poses=poses_j, points=points_j),
            q=q, alpha=alpha), 0.5, need_jac=False)[4]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert segment_sum.launches - launches == 1350 + 2700
    for x in (poses, points, chi2, poses_j, points_j, q, alpha, chi2_j):
        assert bool(torch.isfinite(x).all())
    cost = float(ba._total_cost(cam, local._replace(poses=poses,
                                                    points=points)))
    assert cost < 0.5 * cost_0, (cost, cost_0)
    assert float(chi2_l.median()) < 1e-2


def test_dist_global_ba_on_card_matches_single(dev):
    """LoopCloser.global_ba on the card through the landmark-sharded route
    (force_dist=True: the one-rank NCCL group) against the single route on
    the card, on the loop map with map lines (the joint point+line
    problem): poses, points and map lines bit for bit, with no
    deterministic mode. The solvers sum in a fixed order (the segment-sum
    kernel), and on one rank the sharded route does the single route's
    arithmetic."""
    cfg = SlamConfig(camera=CameraConfig(fx=400.0, fy=400.0, cx=256.0,
                                         cy=192.0, bf=200.0, width=512,
                                         height=384),
                     orb=OrbConfig(n_features=600))
    voc = _default_vocabulary()
    cam = cfg.camera.stereo_camera()
    stores = [MapStore(cam, cfg.orb, max_kf=64, max_pt=20000) for _ in "ab"]
    for st in stores:
        add_loop_lines(st, make_loop_map(st))
    before = stores[0].ln_x0[:stores[0].n_ln].copy()
    LoopCloser(stores[0], voc, cfg, device=dev).global_ba(force_dist=True)
    LoopCloser(stores[1], voc, cfg, device=dev).global_ba(force_dist=False)
    a, b = stores
    K, P, n = a.n_kf, a.n_pt, a.n_ln
    assert np.array_equal(a.kf_pose[:K], b.kf_pose[:K])
    assert np.array_equal(a.pt_pos[:P], b.pt_pos[:P])
    assert np.isfinite(a.ln_x0[:n]).all() and np.isfinite(a.ln_dir[:n]).all()
    assert np.abs(a.ln_x0[:n] - before).max() > 1e-3
    assert np.array_equal(a.ln_x0[:n], b.ln_x0[:n])
    assert np.array_equal(a.ln_dir[:n], b.ln_dir[:n])


def test_kernels_and_projection_search_never_wait_for_the_host(dev):
    """The three kernel wrappers and search_by_projection (through K2g)
    under CUDA's sync debug mode set to "error": no host sync."""
    rng = np.random.default_rng(4)
    d = kernel_inputs.describe_inputs(rng, dev)
    s = kernel_inputs.sad_inputs(rng, dev)
    g = kernel_inputs.gated_best2_inputs(rng, dev, 4096)
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376).stereo_camera()
    P, N = 4096, 2048
    pos = np.stack([rng.uniform(-10, 10, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 40, P)], -1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dist = np.linalg.norm(pos, axis=-1).astype(np.float32)
    view = MapPointView(pos=t(pos), desc=g[0], normal=t(pos / dist[:, None]),
                        min_dist=t(0.5 * dist), max_dist=t(2.0 * dist),
                        valid=t(np.ones(P, bool)))
    feats = FrameFeatures(xy=g[8], ur=g[9], octave=g[10],
                          angle=t(rng.uniform(-3, 3, N).astype(np.float32)),
                          desc=g[7], valid=g[11])
    T = t(np.eye(4, dtype=np.float32))
    search_by_projection(cam, T, view, feats)      # builds cached constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        orb_describe.describe(*d)
        stereo_sad.sad_refine(*s)
        match_best2.gated_best2(*g, site="test")
        pt2kp, kp2pt, _, _ = search_by_projection(cam, T, view, feats,
                                                  check_rot=True,
                                                  ref_angle=feats.angle[:1]
                                                  .expand(P).contiguous())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((pt2kp >= 0).sum()) == int((kp2pt >= 0).sum())


def test_orb_describe_one_view_equals_plain(dev, monkeypatch):
    """The monocular frame build at KITTI size launches K1a once, on one
    view's stacks of round(level) and round(blur(level)) of the float
    pyramid; on those arguments the kernel equals its plain version. The
    build on the card keeps >= 99.5% of the CPU build's keypoints, and the
    RGB-D build samples the same depth where they agree."""
    cam = CameraConfig().stereo_camera()
    frames, _, _, depths = make_sequence(cam, 1, seed=3, return_poses=True,
                                         return_depth=True)
    img = torch.from_numpy(frames[0][0])
    cfg = OrbConfig(n_features=2000)
    kept, describe = [], orb_describe.describe
    monkeypatch.setattr(orb_describe, "describe",
                        lambda *a: kept.append(a) or describe(*a))
    before = orb_describe.launches
    g = frame.build_frame_mono(img.to(dev), cfg)
    torch.cuda.synchronize()
    assert orb_describe.launches == before + 1
    (args,) = kept
    assert args[0].shape[0] == cfg.n_levels          # one view per level
    assert torch.equal(args[0], torch.round(args[0]))
    _equal(describe(*args), orb_describe.describe_plain(*args))
    c = frame.build_frame_mono(img, cfg)
    same = ((g.feats.xy.cpu() == c.feats.xy).all(-1)
            & (g.feats.valid.cpu() == c.feats.valid))
    assert same.float().mean() >= 0.995
    dm = np.where(depths[0] < 8.0, depths[0], 0.0).astype(np.float32)
    gr = frame.build_frame_rgbd(img.to(dev), torch.from_numpy(dm).to(dev),
                                cam, cfg)
    cr = frame.build_frame_rgbd(img, torch.from_numpy(dm), cam, cfg)
    assert torch.equal(gr.depth.cpu()[same], cr.depth[same])


def test_remap_on_card_matches_cpu(dev):
    """The rectifier's bilinear remap on the card against the CPU on the
    EuRoC-size maps of a distorted camera, widened 1.2x about the centre so
    that the border reaches outside the image: within 1e-4."""
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    D = np.array([-0.28, 0.07, 2e-4, 1.8e-5])
    P = np.array([[435.2, 0, 367.45, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0]])
    mx, my = rectify.make_rectify_maps(K, D, np.eye(3), P, (752, 480))
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, (480, 752), dtype=np.uint8))
    mx = torch.from_numpy(1.2 * (mx - 367.215) + 367.215)
    my = torch.from_numpy(1.2 * (my - 248.375) + 248.375)
    got = rectify.remap(img.to(dev), mx.to(dev), my.to(dev)).cpu()
    want = rectify.remap(img, mx, my)
    assert (want == 0).any()
    assert torch.equal(got == 0, want == 0)
    assert (got - want).abs().max() <= 1e-4


def test_initializer_on_card_matches_cpu(dev):
    """The H/F RANSAC and reconstruction on the card (batched cuSOLVER SVDs)
    against the CPU on one general two-view scene with the same hypothesis
    sets: the same model verdict, R within 1e-3, the same good matches but
    for 1%."""
    rng = np.random.default_rng(0)
    n = 300
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                  rng.uniform(6, 20, n)], -1)
    T = se3.exp(torch.tensor([0.6, 0.1, 0.05, 0.0, -0.03, 0.0])).numpy()
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                       width=640, height=480).stereo_camera()

    def proj(P):
        return np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx,
                         cam.fy * P[:, 1] / P[:, 2] + cam.cy], -1)
    x1 = (proj(X) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    x2 = (proj(X @ T[:3, :3].T + T[:3, 3])
          + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    valid = torch.ones(n, dtype=torch.bool)
    hyp = initializer.draw_hypotheses(valid, torch.Generator().manual_seed(0))
    out = {}
    for d in (torch.device("cpu"), dev):
        t = lambda a: torch.as_tensor(a).to(d)
        out[d.type] = initializer.initialize(
            cam, t(x1), t(x2), t(valid), *(h.to(d) for h in hyp))
    (ok_c, R_c, _, _, g_c), (ok_g, R_g, _, _, g_g) = out["cpu"], out["cuda"]
    assert ok_c and ok_g
    assert np.abs(R_c - R_g).max() <= 1e-3
    assert (g_c != g_g).mean() <= 0.01


def test_detect_lines_on_card(dev):
    """The native line detector (frontend/line_extract.py, plain PyTorch
    ops and the segment-sum kernel for the vote) on the card: the vote
    accumulator on the card equals the CPU's `index_add_` bit for bit on
    the CPU's bins and votes; two calls on one view of the line corridor
    are bit-identical, and the card agrees with the CPU: the same valid
    lines, endpoints within 1e-3 px and descriptors within 1e-5 + 0.5 x
    the endpoint difference (px), the bounds of
    tests/test_torch_line_detect.py; at most one line, fed by a pixel an
    atan2 ulp moved, may differ, to 0.5 px and 0.02."""
    from lldslam_tpu_torch.frontend import line_extract as le
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                       width=640, height=240).stereo_camera()
    img = make_sequence(cam, 1, seed=3, with_lines=True)[0][0]
    cfg = le.LineDetConfig(max_lines=256)
    x = torch.from_numpy(img).to(dev)
    _, _, mag, edge, _, bins, n_rho = le._votes(x.cpu().float(), cfg)
    w = torch.where(edge, mag, 0.0).reshape(-1)
    n = n_rho * cfg.n_phi
    want = le._accumulate(bins.reshape(-1), w, n)
    before = segment_sum.launches
    got = le._accumulate(bins.reshape(-1).to(dev), w.to(dev), n)
    assert segment_sum.launches == before + 4
    assert torch.equal(got.cpu(), want) and int(edge.sum()) > 100
    a, b = le.detect_lines(x, cfg), le.detect_lines(x, cfg)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = le.detect_lines(x.cpu(), cfg)
    g = [t.cpu() for t in a]
    assert int(c.valid.sum()) >= 4
    ep = torch.maximum((g[0] - c.p1).abs().amax(-1),
                       (g[1] - c.p2).abs().amax(-1))
    dd = (g[4] - c.desc).abs().amax(-1)
    strict = (ep <= 1e-3) & (dd <= 1e-5 + 0.5 * ep) & (g[5] == c.valid)
    loose = ~strict
    assert int(loose.sum()) <= 1, (ep[loose], dd[loose])
    assert (ep[loose] <= 0.5).all()
    assert (torch.linalg.norm(g[4] - c.desc, dim=-1)[loose] <= 0.02).all()


def test_detect_lines_never_waits_for_the_host(dev):
    """The native line detector on a KITTI-size view of the line corridor
    under CUDA's sync debug mode set to "error": no host sync (the vote
    goes through the segment sum, whose layout is a sort and a search)."""
    from lldslam_tpu_torch.frontend import line_extract as le
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376).stereo_camera()
    img = make_sequence(cam, 1, seed=2, with_lines=True)[0][0]
    x = torch.from_numpy(img).to(dev)
    cfg = le.LineDetConfig(max_lines=256)
    le.detect_lines(x, cfg)                   # builds cached constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kl = le.detect_lines(x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(kl.valid.sum()) >= 4


def _corridor_system(device, lines: bool = False, **kw):
    from lldslam_tpu_torch.config import LineConfig, TrackingConfig
    from lldslam_tpu_torch.system import System
    cfg = SlamConfig(camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0,
                                         cy=120.0, bf=200.0, width=640,
                                         height=240),
                     orb=OrbConfig(n_features=600),
                     tracking=TrackingConfig(min_init_points=80),
                     **(dict(line=LineConfig(ld_type="LBDFloat", md_thr=0.6))
                        if lines else {}))
    frames = make_sequence(cfg.camera.stereo_camera(), 14, n_per_m=25.0,
                           seed=3, with_lines=lines)
    return System(cfg, enable_loops=False, device=device, **kw), frames


@pytest.mark.parametrize("case", ["points", "native_lines"])
def test_chained_step_never_waits_for_the_host(dev, case):
    """The pipelined tracker's dispatch on the card: after the first
    frames of the corridor, one chained step (`_track_step_chained`) on
    the tracker's own device chain state and the next frame runs under
    CUDA's sync debug mode set to "error". With native lines (the line
    corridor, no detections path) the whole dispatch of the next frame:
    its frame build, the line detector on both views, the stereo line
    match and `_track_step_chained_lines`."""
    from lldslam_tpu_torch.frontend import line_extract as le
    from lldslam_tpu_torch.frontend import line_match
    from lldslam_tpu_torch.pipeline import tracker as trk
    lines = case == "native_lines"
    s, frames = _corridor_system(dev, lines=lines, pipeline=True)
    for i in range(4):
        s.track_stereo(*frames[i], timestamp=0.1 * i)
    tr = s.tracker
    assert tr._line_source is None and tr.enable_lines == lines
    pair = tr.stage_pair(*frames[4])

    def dispatch():
        fd = frame.build_frame_pair(pair, tr.cam, tr.orb)
        c = tr._chain
        args = (tr.cam, c["T"], c["vel"], tr._last_feats, tr._last_ptpos,
                tr._last_haspt, fd.feats, fd.depth, tr._view,
                tr._inv_sigma2_lut, tr._last_ismap, tr._last_prov,
                c["since"], c["scal"], tr.orb.n_levels, tr.orb.scale,
                tr.cfg.tracking.min_motion_matches,
                float(tr.cfg.close_depth), 3, 10)
        if not lines:
            return trk._track_step_chained(*args)
        kl = le.detect_lines(pair[0], tr.line_cfg)
        kr = le.detect_lines(pair[1], tr.line_cfg)
        fl = line_match.match_stereo_lines(
            tr.cam, kl, kr, md_thr=tr._md_gate,
            min_len=tr.cfg.line.min_line_len)
        return trk._track_step_chained_lines(
            *args, tr._line_view, fl, float(tr.cfg.line.gamma), tr._md_gate)

    dispatch()                                # builds cached constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out["stats"][1]) > 100


def test_ba_solve_dense_on_card_matches_cpu(dev):
    """ba_solve with the dense reduced system (its (K, P, 6, 3) coupling a
    segment sum over the cells k * P + p) on the card against the CPU on a
    seeded 8-keyframe, 300-point problem: poses within 1e-4, points within
    1e-3; two card runs bit-equal."""
    rng = np.random.default_rng(11)
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376).stereo_camera()
    K, P, O = 8, 300, 1500
    pts = np.stack([rng.uniform(-5, 5, P), rng.uniform(-3, 3, P),
                    rng.uniform(8, 20, P)], -1).astype(np.float32)
    k, p = rng.integers(0, K, O), rng.integers(0, P, O)
    z = pts[p, 2]
    u = cam.fx * pts[p, 0] / z + cam.cx
    uvr = (np.stack([u, cam.fy * pts[p, 1] / z + cam.cy, u - cam.bf / z], -1)
           + rng.normal(0, 0.5, (O, 3))).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True

    def solve(d):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
        prob = ba.BAProblem(
            poses=t(np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))),
            points=t(pts + 0.1), pose_fixed=t(fixed),
            point_valid=t(np.ones(P, bool)),
            obs=ba.BAObs(k=t(k), p=t(p), uvr=t(uvr),
                         inv_sigma2=t(np.ones(O, np.float32)),
                         is_stereo=t(np.ones(O, bool)),
                         valid=t(np.ones(O, bool))))
        out, _ = ba.ba_solve(cam, prob, iters=6, dense=True)
        return out.poses.cpu(), out.points.cpu()

    before = segment_sum.launches
    g1, g2, c = solve(dev), solve(dev), solve(torch.device("cpu"))
    assert segment_sum.launches > before
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])
    assert (g1[0] - c[0]).abs().max() <= 1e-4
    assert (g1[1] - c[1]).abs().max() <= 1e-3


def test_pipelined_run_on_card_matches_cpu(dev):
    """The 14-frame corridor through the pipelined System on the card and
    on the CPU: the same keyframes, every frame OK, camera centres within
    0.05 m (the frame builds differ by an ulp of atan2 here and there)."""
    runs = []
    for device in (dev, "cpu"):
        s, frames = _corridor_system(device, pipeline=True)
        for i, (l, r) in enumerate(frames):
            s.track_stereo(l, r, timestamp=0.1 * i)
        s.flush()
        runs.append(s.tracker)
    card, cpu = runs
    kf = lambda tr: [m.frame_id for m in tr.metrics if m.new_kf]
    assert kf(card) == kf(cpu)
    assert [m.state for m in card.metrics] == ["OK"] * 14
    dp = np.linalg.norm(card.trajectory()[1][:, :3, 3]
                        - cpu.trajectory()[1][:, :3, 3], axis=-1)
    assert dp.max() < 0.05, dp.max()
