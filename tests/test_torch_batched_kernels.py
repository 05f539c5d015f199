"""The sequence axis of the port's three kernels' plain versions and of the
matchers around them, on the CPU: a batch of S problems must give, bit for
bit, what S separate calls give.

K1a (`orb_describe.describe`), K1b (`stereo_sad.sad_refine`) and K2g
(`match_best2.gated_best2`) take a leading S on every tensor; on a CPU
tensor each wrapper takes its plain version, which these tests hold to the
per-problem calls on seeded inputs (io/kernel_inputs.py at 640x240, 512
features; K2g at M = 300, N = 256, with tied columns, an empty row and a
one-candidate row). The card's kernels are held to the same plain versions
and to S = 1 launches in tests/test_torch_cuda.py. The projection search
and the last-frame matcher with a leading S are held to per-sequence calls
the same way (integer work on identical float gates).
"""
import numpy as np
import pytest
import torch

from lldslam_tpu_torch.frontend import matching
from lldslam_tpu_torch.geometry import se3
from lldslam_tpu_torch.geometry.camera import StereoCamera
from lldslam_tpu_torch.io import kernel_inputs
from lldslam_tpu_torch.ops import match_best2, orb_describe, stereo_sad
from lldslam_tpu_torch.ops.orb import OrbConfig

torch.set_num_threads(2)

S = 3
HW = (240, 640)
CFG = OrbConfig(n_features=512)
CAM = StereoCamera(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                   width=640, height=240)


def _stack(sets):
    """Per-argument stack of S argument tuples (host values kept)."""
    return tuple(torch.stack(xs) if torch.is_tensor(xs[0]) else xs[0]
                 for xs in zip(*sets))


def _equal_rows(batched, singles):
    for s, one in enumerate(singles):
        for b, o in zip(batched, one):
            assert torch.equal(b[s], o)


@pytest.mark.parametrize("kernel", ["orb_describe", "stereo_sad",
                                    "gated_best2"])
def test_sequence_axis_equals_separate_calls(kernel):
    rng = np.random.default_rng(11)
    if kernel == "orb_describe":
        sets = [kernel_inputs.describe_inputs(rng, "cpu", CFG, HW)
                for _ in range(S)]
        fn, plain = orb_describe.describe, orb_describe.describe_plain
    elif kernel == "stereo_sad":
        sets = [kernel_inputs.sad_inputs(rng, "cpu", CFG, HW)
                for _ in range(S)]
        fn, plain = stereo_sad.sad_refine, stereo_sad.sad_refine_plain
    else:
        sets = [kernel_inputs.gated_best2_inputs(rng, "cpu", 300, 256, cfg=CFG,
                                                 hw=HW) for _ in range(S)]
        fn, plain = match_best2.gated_best2, match_best2.gated_best2_plain
    batched = fn(*_stack(sets))
    singles = [plain(*a) for a in sets]
    assert batched[0].shape[0] == S
    _equal_rows(batched, singles)
    if kernel == "gated_best2":
        e, o = kernel_inputs.EMPTY_ROW, kernel_inputs.ONE_ROW
        for s in range(S):
            assert int(batched[1][s, e]) == 10000 and int(batched[0][s, e]) == 0
            assert int(batched[0][s, o]) == kernel_inputs.ONE_COL
    if kernel == "stereo_sad":
        assert int((batched[1] == 0).sum()) >= 32 * S      # forced SAD ties


def _problem(rng):
    """A projection-search problem: a view of P map points in front of a
    camera at T, frame keypoints near their projections and distractors,
    and a last frame that observes the same points."""
    P, N = 300, 256
    T = se3.exp(torch.from_numpy(np.concatenate([
        rng.normal(0, 0.2, 3), rng.normal(0, 0.03, 3)]).astype(np.float32)))
    Tw = torch.linalg.inv(T)
    Xc = np.stack([rng.uniform(-6, 6, P), rng.uniform(-1.2, 1.2, P),
                   rng.uniform(4, 25, P)], -1).astype(np.float32)
    X = (torch.from_numpy(Xc) @ Tw[:3, :3].T + Tw[:3, 3]).numpy()
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32)
    octave = rng.integers(0, 3, P).astype(np.int32)
    dist = np.linalg.norm(X - Tw[:3, 3].numpy(), axis=-1).astype(np.float32)
    view = matching.MapPointView(
        pos=torch.from_numpy(X), desc=torch.from_numpy(desc.view(np.int32)),
        normal=torch.from_numpy(Xc / np.linalg.norm(Xc, axis=-1)[:, None]),
        min_dist=torch.from_numpy(0.5 * dist),
        max_dist=torch.from_numpy(dist * 1.2 ** octave * 1.1),
        valid=torch.from_numpy(np.arange(P) < P - 10))
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    k = 200
    xy = np.stack([rng.uniform(0, 640, N), rng.uniform(0, 240, N)], -1)
    xy[:k] = np.stack([u[:k], v[:k]], -1) + rng.normal(0, 0.4, (k, 2))
    ur = np.where(rng.uniform(size=N) < 0.6, xy[:, 0] - CAM.bf / 10, -1.0)
    ur[:k] = np.where(ur[:k] >= 0, u[:k] - CAM.bf / Xc[:k, 2], -1.0)
    fdesc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    fdesc[:k] = desc[:k] ^ (rng.uniform(size=(k, 8)) < 0.3).astype(np.uint32)
    foct = rng.integers(0, 3, N).astype(np.int32)
    foct[:k] = octave[:k]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    feats = matching.FrameFeatures(
        xy=f32(xy), ur=f32(ur), octave=torch.from_numpy(foct),
        angle=f32(rng.uniform(-np.pi, np.pi, N)),
        desc=torch.from_numpy(fdesc.view(np.int32)),
        valid=torch.from_numpy(rng.uniform(size=N) < 0.97))
    last_pos = torch.zeros(N, 3)
    last_pos[:k] = torch.from_numpy(X[:k])
    return T, view, feats, last_pos, torch.arange(N) < k


def test_matchers_with_a_sequence_axis_equal_separate_calls():
    """search_by_projection (through the plain K2g) and match_last_frame
    (both radii) with a leading S: every output equal to the call of each
    sequence alone."""
    rng = np.random.default_rng(12)
    probs = [_problem(rng) for _ in range(S)]
    T = torch.stack([p[0] for p in probs])
    view = matching.MapPointView(*(torch.stack(x) for x in zip(
        *[p[1] for p in probs])))
    feats = matching.FrameFeatures(*(torch.stack(x) for x in zip(
        *[p[2] for p in probs])))
    last_pos = torch.stack([p[3] for p in probs])
    has = torch.stack([p[4] for p in probs])
    got = matching.search_by_projection(CAM, T, view, feats)
    assert int((got[0] >= 0).sum()) > 100 * S
    for s, (Ts, vs, fs, lp, hs) in enumerate(probs):
        want = matching.search_by_projection(CAM, Ts, vs, fs)
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)
    for radius in (7.0, 14.0):
        got = matching.match_last_frame(CAM, T, feats, last_pos, has, feats,
                                        radius=radius)
        assert int((got >= 0).sum()) > 100 * S
        for s, (Ts, _, fs, lp, hs) in enumerate(probs):
            want = matching.match_last_frame(CAM, Ts, fs, lp, hs, fs,
                                             radius=radius)
            assert torch.equal(got[s], want)
