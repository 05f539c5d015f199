"""CPU parity of the port's pipelined tracker with the JAX package: the
on-device keyframe decision and provisional-identity update, the tracking
step with provisional identities, the chained steps with and without lines,
and the pipelined System on the 640x240 / 600-feature corridor of
tests/test_torch_system.py.

Inputs are made with numpy from a seed (frames by bench.py's generator,
built by the port's frame build) and go through both packages on the CPU.
Integer outputs are held exactly. Poses come out of the pose LM, whose sums
run in another order in the two frameworks: 1e-3 m and 1e-4 rad, as in
tests/test_torch_tracking.py. The pipelined System is held as the JAX
package holds its own (tests/test_pipelined.py): the keyframes of the
synchronous run, camera centres within 0.35 m of it, every frame finalized
once and in order (two runs bit-equal: tests/test_torch_pipelined_paths.py).
"""
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import _gen_stored_lines_ref_scale, _make_sequence  # noqa: E402
from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.config import TrackingConfig as JTrackingConfig  # noqa: E402
from lldslam_tpu.frontend import line_match as jlm  # noqa: E402
from lldslam_tpu.frontend import matching as jm  # noqa: E402
from lldslam_tpu.frontend.line_extract import KeyLines as JKeyLines  # noqa: E402
from lldslam_tpu.io import stored_lines as jsl  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.pipeline import tracker as jtr  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.config import (CameraConfig, SlamConfig,  # noqa: E402
                                      TrackingConfig)
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.pipeline import tracker as ttr  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

CAM_CFG = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
               width=640, height=240)
JCAM = JCameraConfig(**CAM_CFG).stereo_camera()
CAM = StereoCamera(*JCAM)
LUT = np.power(1.0 / 1.2 ** 2, np.arange(8)).astype(np.float32)
CLOSE = 200.0 * 35.0 / 450.0
N_FRAMES = 12


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))   # 0-d stays 0-d


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pose_close(Ta, Tb):
    """Translation and rotation-angle differences."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    dt = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
    W = Ta[:3, :3].T @ Tb[:3, :3]
    w = 0.5 * np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]])
    return dt, float(np.arcsin(min(np.linalg.norm(w), 1.0)))


def _port_cfg():
    return SlamConfig(camera=CameraConfig(**CAM_CFG),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80))


# ---------------------------------------------------------------------------
# the decision chain


def _decision_inputs(seed, n=512):
    """Per-frame stats around the decision's thresholds, frames since the
    last decision and [ref_m, kappa]."""
    rng = np.random.default_rng(seed)
    stats = np.zeros((n, 6), np.int32)
    stats[:, 0] = rng.integers(0, 400, n)
    stats[:, 1] = rng.integers(0, 300, n)
    stats[:, 2] = rng.integers(50, 150, n)
    stats[:, 3] = rng.integers(30, 110, n)
    since = rng.integers(0, 12, n).astype(np.int32)
    scal = np.stack([rng.uniform(0, 400, n), rng.uniform(0.2, 1.2, n)],
                    -1).astype(np.float32)
    return stats, since, scal


@pytest.mark.parametrize("seed,min_gap,max_gap", [
    (0, 3, 10), (1, 3, 5), (2, 1, 30), (3, 1 << 28, 1 << 28)])
def test_kf_decision_matches_jax(seed, min_gap, max_gap):
    """512 frames' stats through both decisions: decide, since and
    [ref_m, kappa] exact (the last case is localization mode's gate, which
    never fires)."""
    stats, since, scal = _decision_inputs(seed)
    packed = np.zeros((len(stats), 23), np.int32)
    packed[:, 16:22] = stats
    jd, js, jk = jax.vmap(lambda p, s, k: jtr._kf_decision(
        p, s, k, min_gap, max_gap))(jnp.asarray(packed), jnp.asarray(since),
                                    jnp.asarray(scal))
    td, ts, tk = ttr._kf_decision(_t(stats), _t(since), _t(scal), min_gap,
                                  max_gap)
    assert np.array_equal(_n(td), np.asarray(jd))
    assert np.array_equal(_n(ts), np.asarray(js))
    assert np.array_equal(_n(tk), np.asarray(jk))
    n_fired = int(_n(td).sum())
    assert (n_fired == 0) if min_gap > 100 else (50 < n_fired < 450)


@pytest.mark.parametrize("seed", [0, 1])
def test_prov_update_matches_jax(seed):
    """Four frames' carried tables and close unassociated masks, two with a
    fired decision: the next provisional tables exact."""
    rng = np.random.default_rng(seed)
    n = 600
    carried = np.where(rng.uniform(size=(4, n)) < 0.5, -1,
                       rng.integers(0, n, (4, n))).astype(np.int32)
    close = rng.uniform(size=(4, n)) < 0.3
    decide = np.array([0, 1, 0, 1], np.int32)
    want = jax.vmap(lambda d, c, u: jtr._prov_update(d, (c, u)))(
        jnp.asarray(decide), jnp.asarray(carried), jnp.asarray(close))
    got = ttr._prov_update(_t(decide), _t(carried), _t(close))
    assert np.array_equal(_n(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the tracking steps


def _jax_feats(f):
    return jm.FrameFeatures(**{k: jnp.asarray(v) for k, v in
                               interop.to_numpy(f).items()})


def _stereo_points(fd):
    """The frame's stereo points in its own camera frame, and which
    keypoints have one."""
    xy, depth = _n(fd.feats.xy), _n(fd.depth)
    has = (depth > 0) & _n(fd.feats.valid)
    z = np.maximum(depth, 1e-6)
    X = np.stack([(xy[:, 0] - CAM.cx) * z / CAM.fx,
                  (xy[:, 1] - CAM.cy) * z / CAM.fy, z], -1).astype(np.float32)
    X[~has] = 0
    return X, has


def _view(fd, X, has, T_wc, P=1024):
    """Local-map view: the frame's stereo points in the world frame."""
    ids = np.nonzero(has)[0]
    Xw = X[ids] @ T_wc[:3, :3].T + T_wc[:3, 3]
    C = T_wc[:3, 3]
    dist = np.linalg.norm(Xw - C, axis=-1)
    lvl = 1.2 ** _n(fd.feats.octave)[ids]
    v = dict(pos=np.zeros((P, 3), np.float32),
             desc=np.zeros((P, 8), np.uint32),
             normal=np.zeros((P, 3), np.float32),
             min_dist=np.zeros(P, np.float32),
             max_dist=np.zeros(P, np.float32), valid=np.arange(P) < len(ids))
    v["pos"][:len(ids)] = Xw
    v["desc"][:len(ids)] = _n(fd.feats.desc)[ids].view(np.uint32)
    v["normal"][:len(ids)] = (Xw - C) / dist[:, None]
    v["max_dist"][:len(ids)] = dist * lvl * 1.2
    v["min_dist"][:len(ids)] = dist * lvl / 1.2 ** 7 / 0.8
    return v


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Frames 1 and 2 of the seed-3 line corridor (built by the port), the
    last frame's world points, a local-map view of them, a provisional
    table on a third of its points, and the stored lines of frame 2 matched
    in stereo by the JAX package plus map lines from frame 1's."""
    frames, poses, world = _make_sequence(JCAM, 3, n_per_m=25.0, seed=3,
                                          with_lines=True, return_poses=True)
    cfg = OrbConfig(n_features=600)
    f1, f2 = (tframe.build_frame_pair(_t(np.stack(frames[i])), CAM, cfg)
              for i in (1, 2))
    X, has = _stereo_points(f1)
    T_wc = np.linalg.inv(poses[1])
    Xw = (X @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)
    Xw[~has] = 0
    rng = np.random.default_rng(11)
    n = len(has)
    prov = np.where(has & (rng.uniform(size=n) < 0.33),
                    rng.integers(0, n, n), -1).astype(np.int32)
    tmp = tmp_path_factory.mktemp("lines")
    _gen_stored_lines_ref_scale(JCAM, poses, world, str(tmp / "l"),
                                str(tmp / "r"))

    def stereo(fid):
        kl, kr = (jsl.StoredLineSource(tmp / d, 256, 40)._frame_np(fid)
                  for d in ("l", "r"))
        return jlm.match_stereo_lines(
            JCAM, JKeyLines(*map(jnp.asarray, kl)),
            JKeyLines(*map(jnp.asarray, kr)), md_thr=0.6, min_len=25.0)

    j1 = stereo(1)
    hs = np.nonzero(np.asarray(j1.has_stereo))[0]
    P = np.asarray(j1.X0)[hs] @ T_wc[:3, :3].T + T_wc[:3, 3]
    d = np.asarray(j1.d)[hs] @ T_wc[:3, :3].T
    M, m = 320, len(hs)
    pad = lambda a, fill=0: np.concatenate(
        [a, np.full((M - m,) + a.shape[1:], fill, a.dtype)])
    lines = (pad((P - np.sum(P * d, -1, keepdims=True) * d)
                 .astype(np.float32)), pad(d.astype(np.float32), 1),
             pad(np.asarray(j1.kl.desc)[hs]), pad(np.asarray(j1.kl.octave)[hs]),
             np.arange(M) < m)
    return dict(f1=f1, f2=f2, Xw=Xw, has=has, prov=prov, poses=poses,
                view=_view(f1, X, has, T_wc), fl=stereo(2), lines=lines)


def _step_args(sc):
    """(JAX, port) arguments last_feats .. view common to every step."""
    jview = jm.MapPointView(**{k: jnp.asarray(v) for k, v in sc["view"].items()})
    j = (_jax_feats(sc["f1"].feats), jnp.asarray(sc["Xw"]),
         jnp.asarray(sc["has"]), _jax_feats(sc["f2"].feats),
         jnp.asarray(_n(sc["f2"].depth)), jview)
    t = (sc["f1"].feats, _t(sc["Xw"]), _t(sc["has"]), sc["f2"].feats,
         sc["f2"].depth, interop.map_point_view(sc["view"]))
    return j, t


def test_track_core_with_provisional_ids_matches_jax(scene):
    """One tracking step on frame 2 against frame 1 with a provisional
    table on a third of frame 1's points, from a prediction 5 cm / 0.5
    degree off: the pose within 1e-3 m / 1e-4 rad; kp2last, the local-map
    association, the carried table, the map-inlier mask and the stats
    exact; carried identities reach the map statistics."""
    sc = scene
    rng = np.random.default_rng(7)
    xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.005, 3)])
    T_pred = (np.asarray(jtr.se3.exp(jnp.asarray(xi.astype(np.float32))))
              @ sc["poses"][2]).astype(np.float32)
    (jl, jX, jh, jc, jd, jv), (tl, tX, th, tc, td, tv) = _step_args(sc)
    N = len(sc["has"])
    packed, _, _, _, (jcarried, jclose), _, jT = jtr._track_step(
        JCAM, jnp.asarray(T_pred), jl, jX, jh, jh, jnp.asarray(sc["prov"]),
        jc, jd, jv, jnp.asarray(LUT), 8, 1.2, 7, CLOSE)
    step = ttr._track_core(CAM, _t(T_pred), tl, tX, th, th, tc, td, tv,
                           _t(LUT), 8, 1.2, 7, CLOSE,
                           last_prov=_t(sc["prov"]))
    dt, da = _pose_close(_n(step["T"]), jT)
    assert dt <= 1e-3 and da <= 1e-4, (dt, da)
    packed = np.asarray(packed)
    nw = -(-N // 32)
    assert np.array_equal(_n(step["stats"]), packed[16:22])
    assert np.array_equal(_n(step["kp2last"]), packed[22:22 + N])
    assert np.array_equal(_n(step["kp2pt_l"]), packed[22 + N:22 + 2 * N])
    assert np.array_equal(_n(step["ok"]), jtr._unpack_bits_np(
        packed[22 + 2 * N:22 + 2 * N + nw], N))
    assert np.array_equal(_n(step["carried"]), np.asarray(jcarried))
    assert np.array_equal(_n(step["close_unassoc"]), np.asarray(jclose))
    carried = _n(step["carried"])
    assert (carried >= 0).sum() > 20
    # without the table nothing is carried and the map counts drop
    plain = ttr._track_core(CAM, _t(T_pred), tl, tX, th, th, tc, td, tv,
                            _t(LUT), 8, 1.2, 7, CLOSE)
    assert (_n(plain["carried"]) == -1).all()
    assert _n(plain["stats"])[1] <= _n(step["stats"])[1]


def _chain_case(sc, fire: bool):
    """T_prev = frame 1's pose, a velocity 3 cm / 0.3 degree off the true
    motion, 5 frames since the last decision and a reference count that
    makes the decision fire (or 0 frames and no reference: no fire)."""
    rng = np.random.default_rng(3)
    xi = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.003, 3)])
    T_prev = sc["poses"][1].astype(np.float32)
    vel = (np.asarray(jtr.se3.exp(jnp.asarray(xi.astype(np.float32))))
           @ sc["poses"][2] @ np.linalg.inv(sc["poses"][1])).astype(np.float32)
    since = np.int32(5 if fire else 0)
    scal = np.float32([5000.0, 0.7] if fire else [0.0, 0.7])
    return T_prev, vel, since, scal


def _check_chain(jout, tout, N, fire, lines=False):
    jT, jvel, jsince, jscal = (np.asarray(jout[i]) for i in (5, 6, 8, 9))
    jprov, packed = np.asarray(jout[4]), np.asarray(jout[0])
    dt, da = _pose_close(_n(tout["T"]), jT)
    assert dt <= 1e-3 and da <= 1e-4, (dt, da)
    dt, da = _pose_close(_n(tout["vel"]), jvel)
    assert dt <= 1e-3 and da <= 1e-4, (dt, da)
    assert int(_n(tout["decide"])) == int(packed[22]) == int(fire)
    assert int(_n(tout["since"])) == int(jsince)
    assert np.array_equal(_n(tout["scal"]), jscal)
    assert np.array_equal(_n(tout["prov"]), jprov)
    if fire:
        assert (jprov >= 0).sum() > 20
    if lines:
        ld = _n(tout["det2ln"]).shape[0]
        assert np.array_equal(_n(tout["det2ln"]), packed[-(ld + 1):-1])
        assert int(_n(tout["n_line"])) == int(packed[-1]) >= 30


def _ring_len(N, P, extra=0):
    return 23 + 3 * N + -(-N // 32) + -(-P // 32) + extra


@pytest.mark.parametrize("fire", [True, False])
def test_chained_step_matches_jax(scene, fire):
    """One `_track_step_chained` step: the pose and the velocity within
    1e-3 m / 1e-4 rad; decide, since, [ref_m, kappa] and the next
    provisional table exact, with and without a fired decision."""
    sc = scene
    T_prev, vel, since, scal = _chain_case(sc, fire)
    (jl, jX, jh, jc, jd, jv), (tl, tX, th, tc, td, tv) = _step_args(sc)
    N = len(sc["has"])
    jout = jtr._track_step_chained(
        JCAM, jnp.asarray(T_prev), jnp.asarray(vel), jl, jX, jh, jc, jd, jv,
        jnp.asarray(LUT), jh, jnp.asarray(sc["prov"]), jnp.asarray(since),
        jnp.asarray(scal), jnp.zeros(_ring_len(N, 1024), jnp.int32),
        jnp.int32(0), 8, 1.2, 7, CLOSE, 3, 10)
    tout = ttr._track_step_chained(
        CAM, _t(T_prev), _t(vel), tl, tX, th, tc, td, tv, _t(LUT), th,
        _t(sc["prov"]), _t(since), _t(scal), 8, 1.2, 7, CLOSE, 3, 10)
    _check_chain(jout, tout, N, fire)


def test_chained_lines_step_matches_jax(scene):
    """One `_track_step_chained_lines` step against frame 1's map lines
    (stored detections of the line corridor, matched in stereo by the JAX
    package): the line-refined pose and the velocity within 1e-3 m /
    1e-4 rad; det2ln, n_line, decide, since, [ref_m, kappa] and the
    provisional table exact."""
    sc = scene
    T_prev, vel, since, scal = _chain_case(sc, True)
    (jl, jX, jh, jc, jd, jv), (tl, tX, th, tc, td, tv) = _step_args(sc)
    N = len(sc["has"])
    ld = sc["fl"].kl.p1.shape[0]
    jout = jtr._track_step_chained_lines(
        JCAM, jnp.asarray(T_prev), jnp.asarray(vel), jl, jX, jh, jc, jd, jv,
        jnp.asarray(LUT), *map(jnp.asarray, sc["lines"]), sc["fl"], jh,
        jnp.asarray(sc["prov"]), jnp.asarray(since), jnp.asarray(scal),
        jnp.zeros(_ring_len(N, 1024, ld + 1), jnp.int32), jnp.int32(0),
        8, 1.2, 7, CLOSE, 0.5, 0.6, 3, 10)
    tout = ttr._track_step_chained_lines(
        CAM, _t(T_prev), _t(vel), tl, tX, th, tc, td, tv, _t(LUT), th,
        _t(sc["prov"]), _t(since), _t(scal), 8, 1.2, 7, CLOSE, 3, 10,
        tuple(map(_t, sc["lines"])), interop.frame_lines(sc["fl"]), 0.5, 0.6)
    _check_chain(jout, tout, N, True, lines=True)


# ---------------------------------------------------------------------------
# the pipelined System


@pytest.fixture(scope="module")
def corridor():
    return _make_sequence(JCAM, N_FRAMES, n_per_m=25.0, seed=3)


def _run_pipelined(frames, **kw):
    s = System(_port_cfg(), enable_loops=False, pipeline=True, device="cpu",
               **kw)
    rets = [s.track_stereo(l, r, timestamp=i * 0.1)
            for i, (l, r) in enumerate(frames)]
    s.flush()
    return s, rets


@pytest.fixture(scope="module")
def pipelined(corridor):
    return _run_pipelined(corridor)


def test_pipelined_matches_jax_sync(corridor, pipelined):
    """The port's pipelined System against the JAX package's synchronous
    one on the 12-frame corridor: the same keyframes, camera centres within
    0.35 m, every frame OK."""
    jcfg = JSlamConfig(camera=JCameraConfig(**CAM_CFG),
                       orb=JOrbConfig(n_features=600),
                       tracking=JTrackingConfig(min_init_points=80))
    js = JSystem(jcfg, enable_loops=False)
    for i, (l, r) in enumerate(corridor):
        js.track_stereo(l, r, timestamp=i * 0.1)
    _, T_j = js.tracker.trajectory()
    s, _ = pipelined
    _, T_p = s.tracker.trajectory()
    kf_j = [m.frame_id for m in js.tracker.metrics if m.new_kf]
    kf_p = [m.frame_id for m in s.tracker.metrics if m.new_kf]
    dp = np.linalg.norm(T_p[:, :3, 3] - T_j[:, :3, 3], axis=-1)
    print(f"keyframes {kf_p}; max centre diff {dp.max():.4f} m")
    assert kf_p == kf_j, (kf_p, kf_j)
    assert len(T_p) == len(T_j) == N_FRAMES
    assert dp.max() < 0.35, dp.max()
    assert [m.state for m in s.tracker.metrics] == ["OK"] * N_FRAMES


def test_pipelined_finalizes_every_frame_once_in_order(pipelined):
    """Frame 0 initializes synchronously; later frames finalize in window
    bursts (non-None returns with increasing frame ids, at least one before
    the flush, and calls that finalize nothing); one metrics record per
    frame, in order; the staged mapping and loop queues end empty."""
    s, rets = pipelined
    assert rets[0][1] is not None and rets[0][1].frame_id == 0
    burst = [m.frame_id for _, m in rets[1:] if m is not None]
    assert len(burst) >= 1 and burst == sorted(burst)
    assert any(m is None for _, m in rets[1:])
    assert [m.frame_id for m in s.tracker.metrics] == list(range(N_FRAMES))
    tr = s.tracker
    assert not (tr._pending or tr._windows or tr.mapper.busy
                or tr._pending_loops)
    assert tr.mapper.fixed_tv_cap == 4096 and tr.mapper.adaptive_ba_cadence
