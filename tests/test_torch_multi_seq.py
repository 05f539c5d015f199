"""CPU parity of the port's multi-sequence driver (lldslam_tpu_torch/
parallel/multi_seq.py) with the JAX package's (lldslam_tpu/parallel/
multi_seq.py) and with the port's own single-sequence path, at the sizes of
tests/test_multi_seq.py and tests/test_torch_system.py (640x240, 512 ORB
features; the tracking step at N = 256 keypoints and P = 512 map points).

- The batched frame build of S = 2 stereo pairs against JAX
  `batched_build_frame` under the contract of
  tests/test_torch_frontend.py::test_build_frame_pair_matches, and against
  the port's own `build_frame_pair` of each pair, exact.
- The batched tracking step of S = 3 sequences against JAX
  `batched_track_step` (provisional ids off): the contract of
  tests/test_torch_tracking.py::test_track_step_matches_jax; and against
  the port's step of each sequence alone: poses within 1e-4 m, the integer
  outputs equal on >= 99% of the keypoints (the pose LM sums in another
  order when batched, which can move an accept/reject step).
- The pipelined chained step of S = 3 sequences, each with a provisional
  table and its own decision state, against JAX `batched_chained_step`:
  poses and velocities within 1e-3 m / 1e-4 rad, the integers exact.
- `MultiSequenceDriver` with S = 3 for 8 frames against three solo
  `System`s with the same pinned view capacity: every frame OK, camera
  centres within 0.05 m (the bound of tests/test_multi_seq.py), frames 1-7
  tracked in the batch.
- `PipelinedMultiSequenceDriver` with S = 3 for 10 frames against three
  solo pipelined `System`s, all sequences to the end and with two ending
  early (a re-stack, then a lone survivor): every frame OK and finalized,
  camera centres within 0.35 m (tests/test_multi_seq.py's pipelined bound),
  no synchronous re-track.
"""
import inspect
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.frontend import matching as jm  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.ops import image as jimage  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.ops import stereo as jstereo  # noqa: E402
from lldslam_tpu.parallel import multi_seq as jms  # noqa: E402
from lldslam_tpu_torch.config import (CameraConfig, SlamConfig,  # noqa: E402
                                      TrackingConfig)
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.frontend import matching as tm  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.io.synthetic import make_sequence  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.parallel.multi_seq import (  # noqa: E402
    MultiSequenceDriver, PipelinedMultiSequenceDriver)
from lldslam_tpu_torch.pipeline import tracker as ttracker  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
              width=640, height=240)
JCAM = JCameraConfig(**CAM_KW).stereo_camera()
CAM = StereoCamera(*JCAM)
JCFG = jorb.OrbConfig(n_features=512)
TCFG = OrbConfig(n_features=512)
LUT = np.power(1.0 / 1.2 ** 2, np.arange(8)).astype(np.float32)
N, P = 256, 512
CLOSE_DEPTH = 200.0 * 35.0 / 450.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def pairs():
    """Frame 1 of the seed-10 and seed-11 corridors of tests/test_multi_seq.py."""
    return np.stack([np.stack(make_sequence(CAM, 2, n_per_m=25.0,
                                            seed=seed)[1])
                     for seed in (10, 11)]).astype(np.uint8)


def test_build_frame_batch_matches(pairs):
    """Per sequence: keypoints and descriptors agree with the JAX batched
    build on >= 99.5% of the slots; stereo against the JAX route on float32
    copies of that sequence's levels (the route the JAX package runs on the
    TPU, see tests/test_torch_frontend.py): matched sets on >= 99%, ur
    within 1e-3 px and depth within 1e-4 relative on >= 99% of the
    keypoints matched by both. And the batch equals the port's build of
    each pair alone, every output exact."""
    jb = jms.batched_build_frame(jnp.asarray(pairs), JCAM, JCFG)
    tb = tframe.build_frame_batch(_t(pairs), CAM, TCFG)
    assert tb.feats.xy.shape[:2] == (2, TCFG.max_kp)
    for s in range(2):
        jf = jax.tree.map(lambda a: np.asarray(a[s]), jb.feats)
        tf = tb.seq(s)
        same_kp = ((tf.feats.xy.numpy() == jf.xy).all(-1)
                   & (tf.feats.octave.numpy() == jf.octave)
                   & (tf.feats.valid.numpy() == jf.valid))
        assert same_kp.mean() >= 0.995
        v = jf.valid & same_kp
        same_desc = (tf.feats.desc.numpy() == jf.desc.view(np.int32)).all(-1)[v]
        assert same_desc.mean() >= 0.995

        pyr = [np.asarray(p.astype(jnp.float32)) for p in jimage.build_pyramid(
            jnp.asarray(pairs[s]).astype(jnp.float32), JCFG.n_levels,
            JCFG.scale, quantize=True)]
        # the batch's own keypoints of both views
        kl = jorb.Keypoints(xy=jf.xy, response=np.zeros_like(jf.ur),
                            octave=jf.octave, angle=jf.angle, desc=jf.desc,
                            valid=jf.valid)
        kr = jax.tree.map(lambda a: a[s], jb.right)
        ju, jd = jstereo.match_stereo(
            jax.tree.map(jnp.asarray, kl), kr,
            [jnp.asarray(p[0]) for p in pyr], [jnp.asarray(p[1]) for p in pyr],
            JCAM, JCFG)
        ju, jd = np.asarray(ju), np.asarray(jd)
        tu, td = tf.feats.ur.numpy(), tf.depth.numpy()
        assert ((ju >= 0) == (tu >= 0)).mean() >= 0.99
        both = (ju >= 0) & (tu >= 0)
        assert both.sum() > 100
        assert (np.abs(ju - tu)[both] <= 1e-3).mean() >= 0.99
        assert (np.abs(jd - td)[both] <= 1e-4 * np.abs(jd[both])).mean() >= 0.99

        alone = tframe.build_frame_pair(_t(pairs[s]), CAM, TCFG)
        for name, a, b in zip(("feats", "depth", "right"), tf, alone):
            for x, y in zip(a if name != "depth" else [a],
                            b if name != "depth" else [b]):
                assert torch.equal(x, y), name


def _pose(rng, rot, trans):
    xi = np.concatenate([rng.normal(0, trans, 3), rng.normal(0, rot, 3)])
    return np.asarray(jse3.exp(jnp.asarray(xi.astype(np.float32))))


def _flip(rng, desc, max_bits):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, rng.integers(0, max_bits + 1), replace=False):
            out[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    return u, v, u - CAM.bf / Xc[:, 2], Xc[:, 2]


def _sequence_step(rng):
    """One sequence's step inputs: P map points in front of the camera; the
    last frame's first 200 keypoints observe points 0-199 from T_last (80%
    of them map points, the rest temporal seeds), the current frame's first
    200 observe them from T_cur (0.3 px noise, descriptors a few bits off,
    60% stereo), the rest are distractors; the prediction is 5 cm / 0.5
    degree off T_cur."""
    T_cur = _pose(rng, rot=0.05, trans=0.3)
    T_last = np.linalg.inv(_pose(rng, rot=0.01, trans=0.15)) @ T_cur
    Tw = np.linalg.inv(T_cur)
    Xc = np.stack([rng.uniform(-6, 6, P), rng.uniform(-1.2, 1.2, P),
                   rng.uniform(4, 25, P)], -1)
    X = (Xc @ Tw[:3, :3].T + Tw[:3, 3]).astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32)
    octave = rng.integers(0, 3, P).astype(np.int32)
    dist = np.linalg.norm(X - Tw[:3, 3], axis=-1)
    view = dict(pos=X, desc=desc, normal=((X - Tw[:3, 3]) / dist[:, None])
                .astype(np.float32),
                min_dist=(0.5 * dist).astype(np.float32),
                max_dist=(dist * 1.2 ** octave * 1.1).astype(np.float32),
                valid=np.arange(P) < P - 16)
    k = 200

    def frame(T, max_bits, noise):
        u, v, ur, z = _project(T, X[:k])
        xy = np.stack([rng.uniform(0, CAM.width, N),
                       rng.uniform(0, CAM.height, N)], -1).astype(np.float32)
        xy[:k] = np.stack([u, v], -1) + rng.normal(0, noise, (k, 2))
        st = rng.uniform(size=k) < 0.6
        fur = np.full(N, -1.0, np.float32)
        fur[:k][st] = ur[st]
        depth = np.full(N, -1.0, np.float32)
        depth[:k][st] = z[st]
        oct_ = rng.integers(0, 3, N).astype(np.int32)
        oct_[:k] = octave[:k]
        fdesc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
        fdesc[:k] = _flip(rng, desc[:k], max_bits)
        feats = dict(xy=xy, ur=fur, octave=oct_,
                     angle=rng.uniform(-np.pi, np.pi, N).astype(np.float32),
                     desc=fdesc, valid=rng.uniform(size=N) < 0.97)
        return feats, depth

    last, _ = frame(T_last, 10, 0.0)
    cur, depth = frame(T_cur, 20, 0.3)
    cur["angle"][:k] = (last["angle"][:k] - 0.05
                        + rng.normal(0, 0.01, k)).astype(np.float32)
    ptpos = np.zeros((N, 3), np.float32)
    ptpos[:k] = X[:k]
    haspt = np.arange(N) < k
    ismap = haspt & (rng.uniform(size=N) < 0.8)
    T_pred = (_pose(rng, rot=0.009, trans=0.05) @ T_cur).astype(np.float32)
    return dict(T=T_pred, last=last, ptpos=ptpos, haspt=haspt, ismap=ismap,
                cur=cur, depth=depth, view=view)


def _pose_close(Ta, Tb):
    dt = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
    W = Ta[:3, :3].astype(np.float64).T @ Tb[:3, :3].astype(np.float64)
    w = 0.5 * np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]])
    return dt, float(np.arcsin(min(np.linalg.norm(w), 1.0)))


def _port_inputs(seqs):
    """The port's stacked step inputs of the sequences given (a leading
    S): last_feats, last_ptpos, last_haspt, last_ismap, cur, depth, view."""
    stack = lambda get: np.stack([get(a) for a in seqs])
    feats = lambda key: tm.FrameFeatures(*(
        _t(stack(lambda a: a[key][f].view(np.int32) if f == "desc"
                 else a[key][f])) for f in tm.FrameFeatures._fields))
    view = tm.MapPointView(*(
        _t(stack(lambda a: a["view"][f].view(np.int32) if f == "desc"
                 else a["view"][f])) for f in tm.MapPointView._fields))
    return (feats("last"), _t(stack(lambda a: a["ptpos"])),
            _t(stack(lambda a: a["haspt"])), _t(stack(lambda a: a["ismap"])),
            feats("cur"), _t(stack(lambda a: a["depth"])), view)


def _jax_inputs(seqs):
    """The same inputs stacked for the JAX package's vmapped steps."""
    jstack = lambda get: jax.tree.map(lambda *xs: jnp.stack(xs),
                                      *[get(a) for a in seqs])
    jfeats = lambda key: jstack(lambda a: jm.FrameFeatures(
        **{k: jnp.asarray(v) for k, v in a[key].items()}))
    arr = lambda key: jstack(lambda a: jnp.asarray(a[key]))
    view = jstack(lambda a: jm.MapPointView(
        **{k: jnp.asarray(v) for k, v in a["view"].items()}))
    return (jfeats("last"), arr("ptpos"), arr("haspt"), arr("ismap"),
            jfeats("cur"), arr("depth"), view)


def _port_step(seqs):
    """The port's `_track_core` over the sequences given (a leading S)."""
    last, ptpos, haspt, ismap, cur, depth, view = _port_inputs(seqs)
    return ttracker._track_core(
        CAM, _t(np.stack([a["T"] for a in seqs])), last, ptpos, haspt, ismap,
        cur, depth, view, _t(LUT), 8, 1.2, 7, CLOSE_DEPTH)


def test_batched_track_step_matches():
    """S = 3: each sequence of the port's batched step within 1e-3 m and
    1e-4 rad of JAX `batched_track_step` (last_prov -1), kp2last, kp2pt_l
    and the final inlier mask equal on >= 99% of the keypoints; and within
    1e-4 m of the port's step of that sequence alone, the same integers
    equal on >= 99%."""
    rng = np.random.default_rng(0)
    seqs = [_sequence_step(rng) for _ in range(3)]
    S = len(seqs)
    jl, jX, jh, jim, jc, jd, jv = _jax_inputs(seqs)
    out = jms.batched_track_step(
        JCAM, jnp.asarray(np.stack([a["T"] for a in seqs])), jl, jX, jh, jim,
        jnp.full((S, N), -1, jnp.int32), jc, jd, jv, jnp.asarray(LUT), 8,
        1.2, 7, CLOSE_DEPTH)
    packed, j_final, jT = (np.asarray(out[0]), np.asarray(out[5]),
                           np.asarray(out[6]))
    step = _port_step(seqs)
    for s in range(S):
        dt, da = _pose_close(step["T"][s].numpy(), jT[s])
        assert dt <= 1e-3 and da <= 1e-4, (s, dt, da)
        assert (step["kp2last"][s].numpy() == packed[s, 22:22 + N]).mean() \
            >= 0.99
        assert (step["kp2pt_l"][s].numpy()
                == packed[s, 22 + N:22 + 2 * N]).mean() >= 0.99
        assert (step["final"][s].numpy() == j_final[s]).mean() >= 0.99
        assert int(step["stats"][s][1]) > 60                # map inliers
        alone = _port_step([seqs[s]])
        dt, _ = _pose_close(step["T"][s].numpy(), alone["T"][0].numpy())
        assert dt <= 1e-4, (s, dt)
        for key in ("kp2last", "kp2pt_l", "final", "ok"):
            assert (step[key][s] == alone[key][0]).float().mean() >= 0.99, key


def test_batched_chained_step_matches_jax():
    """S = 3 pipelined chained steps (`_track_step_chained` with a leading
    S) against JAX `batched_chained_step`: T_pred = vel @ T_prev per
    sequence, a provisional table on 40% of each last frame's points, and
    each sequence's own decision state (past its gap with a high reference
    count, inside its gap, past its gap with none). Per sequence the pose
    and the velocity within 1e-3 m and 1e-4 rad; the stats, decide, since,
    [ref_m, kappa], kp2last, kp2pt_l and the next provisional table exact;
    the decision fires in one sequence and not in another."""
    rng = np.random.default_rng(5)
    seqs = [_sequence_step(rng) for _ in range(3)]
    S = len(seqs)
    T_prev, vel, prov = [], [], []
    for a in seqs:
        Tp = _pose(rng, rot=0.01, trans=0.15) @ a["T"]
        T_prev.append(Tp.astype(np.float32))
        vel.append((a["T"].astype(np.float64) @ np.linalg.inv(Tp))
                   .astype(np.float32))
        prov.append(np.where(a["haspt"] & (rng.uniform(size=N) < 0.4),
                             rng.integers(0, N, N), -1).astype(np.int32))
    T_prev, vel, prov = np.stack(T_prev), np.stack(vel), np.stack(prov)
    since = np.int32([5, 1, 4])
    scal = np.float32([[5000.0, 0.7], [5000.0, 0.7], [0.0, 0.7]])
    L = 23 + 3 * N + -(-N // 32) + -(-P // 32)
    jl, jX, jh, jim, jc, jd, jv = _jax_inputs(seqs)
    jout = jms.batched_chained_step(
        JCAM, jnp.asarray(T_prev), jnp.asarray(vel), jl, jX, jh, jc, jd, jv,
        jnp.asarray(LUT), jim, jnp.asarray(prov), jnp.asarray(since), jnp.asarray(scal),
        jnp.zeros((S, L), jnp.int32), jnp.int32(0), 8, 1.2, 7, CLOSE_DEPTH,
        3, 10)
    packed, jprov, jT, jvel, jsince, jscal = (
        np.asarray(jout[i]) for i in (0, 4, 5, 6, 8, 9))
    last, ptpos, haspt, ismap, cur, depth, view = _port_inputs(seqs)
    out = ttracker._track_step_chained(
        CAM, _t(T_prev), _t(vel), last, ptpos, haspt, cur, depth, view,
        _t(LUT), ismap, _t(prov), _t(since), _t(scal), 8, 1.2, 7,
        CLOSE_DEPTH, 3, 10)
    for s in range(S):
        for key, want in (("T", jT[s]), ("vel", jvel[s])):
            dt, da = _pose_close(out[key][s].numpy(), want)
            assert dt <= 1e-3 and da <= 1e-4, (s, key, dt, da)
        assert np.array_equal(out["stats"][s].numpy(), packed[s, 16:22]), s
        assert int(out["decide"][s]) == int(packed[s, 22]), s
        assert np.array_equal(out["kp2last"][s].numpy(),
                              packed[s, 23:23 + N]), s
        assert np.array_equal(out["kp2pt_l"][s].numpy(),
                              packed[s, 23 + N:23 + 2 * N]), s
        assert (out["carried"][s] >= 0).sum() > 10, s
    assert np.array_equal(out["since"].numpy(), jsince)
    assert np.array_equal(out["scal"].numpy(), jscal)
    assert np.array_equal(out["prov"].numpy(), jprov)
    assert set(out["decide"].tolist()) == {0, 1}


def _driver_cfg():
    return SlamConfig(camera=CameraConfig(**CAM_KW), orb=TCFG,
                      tracking=TrackingConfig(min_init_points=60))


def test_multi_sequence_driver_matches_solo():
    """S = 3 corridors (seeds 10-12) for 8 frames: every frame OK in both,
    camera centres of each sequence within 0.05 m of its solo System
    (view capacity pinned to 2048 in both), keyframe counts within one, and
    frames 1-7 tracked in the batch (frame 0 initializes on the solo path).
    A finished sequence (None) is skipped."""
    n_seq, n_frames = 3, 8
    seqs = [make_sequence(CAM, n_frames, n_per_m=25.0, seed=10 + s)
            for s in range(n_seq)]
    solo = []
    for s in range(n_seq):
        sys_ = System(_driver_cfg(), enable_loops=False, device="cpu")
        sys_.tracker.mapper.fixed_tv_cap = 2048
        for i, (l, r) in enumerate(seqs[s]):
            sys_.track_stereo(l, r, timestamp=i * 0.1)
        solo.append(sys_.tracker)
    drv = MultiSequenceDriver(_driver_cfg(), n_seq, enable_loops=False,
                              device="cpu")
    for i in range(n_frames):
        res = drv.process([seqs[s][i] for s in range(n_seq)],
                          [i * 0.1] * n_seq)
        assert all(r is not None for r in res)
    assert drv.process([None] * n_seq, [0.0] * n_seq) == [None] * n_seq
    for s, (ts, T) in enumerate(drv.trajectories()):
        tr, ref = drv.trackers[s], solo[s]
        assert len(ts) == n_frames
        assert [m.state for m in tr.metrics] == ["OK"] * n_frames
        assert [m.state for m in ref.metrics] == ["OK"] * n_frames
        _, T_solo = ref.trajectory()
        dp = np.linalg.norm(T[:, :3, 3] - T_solo[:, :3, 3], axis=-1)
        print(f"sequence {s}: max centre diff {dp.max():.5f} m; keyframes "
              f"{tr.store.n_kf} batched, {ref.store.n_kf} solo")
        assert dp.max() < 0.05, (s, dp.max())
        assert abs(tr.store.n_kf - ref.store.n_kf) <= 1
        assert len(tr._view_pid) == 2048
        batched = [m for m in tr.metrics if m.t_dispatch > 0]
        assert [m.frame_id for m in batched] == list(range(1, n_frames))
    # the pipelined driver is ported: pipelined trackers, one view shape,
    # the JAX driver's window of 4
    pdrv = PipelinedMultiSequenceDriver(_driver_cfg(), 2, device="cpu")
    assert pdrv.W == 4 and all(
        tr.pipeline and tr.mapper.fixed_tv_cap == 2048
        for tr in pdrv.trackers)
    # entry points: on the card unless the caller asks for the CPU
    for cls in (MultiSequenceDriver, PipelinedMultiSequenceDriver):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.mark.parametrize("ends", [(10, 10, 10), (10, 5, 7)],
                         ids=["all", "two_end_early"])
def test_pipelined_driver_matches_solo_pipelined(ends):
    """S = 3 corridors through PipelinedMultiSequenceDriver against each
    sequence's own pipelined System (view capacity 2048 in both), as
    tests/test_multi_seq.py holds the JAX driver: every frame finalized and
    OK, camera centres within 0.35 m. With sequences ending early the batch
    is flushed and re-stacked with the survivors, which continue from the
    last dispatched chain state, and the last survivor continues alone on
    its own pipelined tracker, its chain reseeded from its finalized
    state: no frame of any sequence falls back to a synchronous re-track
    (a stale chain would make that frame weak)."""
    n_seq, n_frames = 3, max(ends)
    short = min(ends) < n_frames
    seed0 = 30 if short else 10
    seqs = [make_sequence(CAM, n_frames, n_per_m=25.0, seed=seed0 + s)
            for s in range(n_seq)]
    solo = []
    for s in range(n_seq):
        sys_ = System(_driver_cfg(), enable_loops=False, pipeline=True,
                      device="cpu")
        sys_.tracker.mapper.fixed_tv_cap = 2048
        for i in range(ends[s]):
            sys_.track_stereo(*seqs[s][i], timestamp=i * 0.1)
        sys_.flush()
        solo.append(sys_.tracker)
    drv = PipelinedMultiSequenceDriver(_driver_cfg(), n_seq,
                                       enable_loops=False, device="cpu")
    retracks = [0] * n_seq
    for s, tr in enumerate(drv.trackers):
        def counted(*a, _f=tr._track, _s=s, **k):
            retracks[_s] += 1
            return _f(*a, **k)
        tr._track = counted
    for i in range(n_frames):
        drv.process([seqs[s][i] if i < ends[s] else None
                     for s in range(n_seq)], [i * 0.1] * n_seq)
    drv.flush()
    assert drv.n_rebuilds >= (3 if short else 1)
    assert retracks == [0] * n_seq, retracks
    for s, (ts, T) in enumerate(drv.trajectories()):
        tr = drv.trackers[s]
        assert len(ts) == ends[s]
        assert [m.frame_id for m in tr.metrics] == list(range(ends[s]))
        assert [m.state for m in tr.metrics] == ["OK"] * ends[s]
        _, T_solo = solo[s].trajectory()
        dp = np.linalg.norm(T[:, :3, 3] - T_solo[:, :3, 3], axis=-1)
        print(f"sequence {s}: max centre diff {dp.max():.5f} m; keyframes "
              f"{tr.store.n_kf} batched, {solo[s].store.n_kf} solo")
        assert dp.max() < 0.35, (s, dp.max())
        assert not (tr._pending or tr._windows or tr.mapper.busy)
    assert not (drv._pending or drv._inflight or drv._members)
