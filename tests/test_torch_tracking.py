"""CPU parity of the port's tracking step with the JAX package: projection
search (through K2's plain version), last-frame matching, pose-only LM and
the whole per-frame step.

Fixtures are made with numpy from a seed: map points in front of a known
camera, keypoints at their projections with pixel noise and descriptors a
few bit flips away, plus distractors, duplicates and outliers. Association
is integer work on identical float gates, so its indices are held exactly.
The pose LM sums in another order in the two frameworks, which can move an
accept/reject step: poses agree to 1e-3 m and 1e-4 rad and the inlier masks
on >= 99% of the observations.
"""
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import _make_sequence  # noqa: E402
from lldslam_tpu.config import CameraConfig  # noqa: E402
from lldslam_tpu.frontend import matching as jm  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.optim import pose_opt as jpo  # noqa: E402
from lldslam_tpu.pipeline import tracker as jtracker  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.frontend import matching as tm  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.optim import pose_opt as tpo  # noqa: E402
from lldslam_tpu_torch.pipeline import tracker as ttracker  # noqa: E402

torch.set_num_threads(2)

JCAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                    fps=10.0, width=640, height=240).stereo_camera()
CAM = StereoCamera(*JCAM)
LUT = np.power(1.0 / 1.2 ** 2, np.arange(8)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pose(rng, rot=0.05, trans=0.3):
    xi = np.concatenate([rng.normal(0, trans, 3), rng.normal(0, rot, 3)])
    return np.asarray(jse3.exp(jnp.asarray(xi.astype(np.float32))))


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    return u, v, u - CAM.bf / Xc[:, 2], Xc[:, 2]


def _flip(rng, desc, max_bits):
    """Flip up to max_bits random bits of each uint32 descriptor row."""
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, rng.integers(0, max_bits + 1), replace=False):
            out[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _scene(seed, P=256, N=384):
    """Map points seen by a camera at T; frame keypoints at their
    projections (noise 0.4 px, octave o in 0..2 with a scale range that
    predicts octave o), near-duplicate and random distractor keypoints."""
    rng = np.random.default_rng(seed)
    T = _pose(rng)
    Tw = np.linalg.inv(T)
    n_pt = P - 16                                    # 16 invalid view rows
    Xc = np.stack([rng.uniform(-6, 6, n_pt), rng.uniform(-2, 2, n_pt),
                   rng.uniform(4, 25, n_pt)], -1)
    X = (Xc @ Tw[:3, :3].T + Tw[:3, 3]).astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32)
    octave = rng.integers(0, 3, n_pt).astype(np.int32)
    u, v, ur, z = _project(T, X)
    centre = Tw[:3, 3]
    dist = np.linalg.norm(X - centre, axis=-1)
    normal = (X - centre) / dist[:, None]
    max_dist = (dist * 1.2 ** octave * 1.1).astype(np.float32)
    pos = np.zeros((P, 3), np.float32)
    pos[:n_pt] = X
    nrm = np.zeros((P, 3), np.float32)
    nrm[:n_pt] = normal
    mind = np.zeros(P, np.float32)
    mind[:n_pt] = dist * 0.5
    maxd = np.zeros(P, np.float32)
    maxd[:n_pt] = max_dist
    view = dict(pos=pos, desc=desc, normal=nrm, min_dist=mind, max_dist=maxd,
                valid=np.arange(P) < n_pt)

    # keypoints: 0.7 of the points seen (some twice), then distractors
    seen = rng.choice(n_pt, int(0.7 * n_pt), replace=False)
    dup = seen[:20]
    src = np.concatenate([seen, dup])
    k = len(src)
    xy = np.zeros((N, 2), np.float32)
    xy[:k, 0] = u[src] + rng.normal(0, 0.4, k)
    xy[:k, 1] = v[src] + rng.normal(0, 0.4, k)
    xy[k:, 0] = rng.uniform(0, CAM.width, N - k)
    xy[k:, 1] = rng.uniform(0, CAM.height, N - k)
    fur = np.full(N, -1.0, np.float32)
    st = rng.uniform(size=k) < 0.6
    fur[:k][st] = (ur[src] + rng.normal(0, 0.4, k))[st]
    foct = rng.integers(0, 3, N).astype(np.int32)
    foct[:k] = octave[src]
    fdesc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    fdesc[:k] = _flip(rng, desc[src], 60)
    angle = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    valid = rng.uniform(size=N) < 0.97
    feats = dict(xy=xy, ur=fur, octave=foct, angle=angle, desc=fdesc,
                 valid=valid)
    return T, view, feats, rng


def _jax_feats(f):
    return jm.FrameFeatures(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.mark.parametrize("seed,th", [(0, 1.0), (1, 0.75), (2, 2.5)])
def test_search_by_projection_exact(seed, th):
    """pt2kp, kp2pt, the projections' in-frustum mask: identical; the
    predicted (u, v, ur) to float32 rounding."""
    T, view, feats, _ = _scene(seed)
    jv = jm.MapPointView(**{k: jnp.asarray(v) for k, v in view.items()})
    want = jm.search_by_projection(JCAM, jnp.asarray(T), jv, _jax_feats(feats),
                                   th=th)
    got = tm.search_by_projection(CAM, _t(T), interop.map_point_view(view),
                                  interop.frame_features(feats), th=th)
    for name, g, w in zip(("pt2kp", "kp2pt", "in_frustum"),
                          (got[0], got[1], got[3]),
                          (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6,
                               atol=1e-3)
    assert (got[0].numpy() >= 0).sum() > 50


@pytest.mark.parametrize("seed,radius", [(3, 7.0), (4, 14.0)])
def test_match_last_frame_exact(seed, radius):
    """kp2last identical. The last frame is the scene's keypoints carrying
    their points; the current frame sees them from a pose 0.2 m / 0.01 rad
    away, rotated by 0.1 rad in the image plane (for the rotation
    histogram)."""
    T, view, feats, rng = _scene(seed)
    n_pt = int(view["valid"].sum())
    N = len(feats["xy"])
    # last frame: the scene's first n_pt keypoints observe view points
    last = {k: v.copy() for k, v in feats.items()}
    last_pos = np.zeros((N, 3), np.float32)
    has = np.zeros(N, bool)
    src = np.arange(min(n_pt, N))
    last_pos[src] = view["pos"][src]
    has[src] = True
    u, v, ur, _ = _project(T, view["pos"][:n_pt])
    last["xy"][src] = np.stack([u, v], -1)[src]
    last["desc"][src] = view["desc"][src]
    T_cur = _pose(rng, rot=0.01, trans=0.2) @ T
    cu, cv, cur_r, _ = _project(T_cur, view["pos"][:n_pt])
    cur = {k: v.copy() for k, v in feats.items()}
    cur["xy"][src] = np.stack([cu, cv], -1)[src] + rng.normal(0, 0.5, (len(src), 2))
    cur["ur"][src] = np.where(rng.uniform(size=len(src)) < 0.5, cur_r[src], -1)
    cur["octave"][src] = last["octave"][src]
    cur["desc"][src] = _flip(rng, last["desc"][src], 40)
    cur["angle"] = (last["angle"] - 0.1 + rng.normal(0, 0.02, N)).astype(np.float32)
    want = jm.match_last_frame(JCAM, jnp.asarray(T_cur), _jax_feats(last),
                               jnp.asarray(last_pos), jnp.asarray(has),
                               _jax_feats(cur), radius=radius)
    got = tm.match_last_frame(CAM, _t(T_cur), interop.frame_features(last),
                              _t(last_pos), _t(has),
                              interop.frame_features(cur), radius=radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).sum() > 50


def _pose_problem(seed, N=300):
    rng = np.random.default_rng(seed)
    T = _pose(rng)
    Tw = np.linalg.inv(T)
    Xc = np.stack([rng.uniform(-8, 8, N), rng.uniform(-3, 3, N),
                   rng.uniform(3, 40, N)], -1)
    X = (Xc @ Tw[:3, :3].T + Tw[:3, 3]).astype(np.float32)
    u, v, ur, _ = _project(T, X)
    obs = np.stack([u, v, ur], -1) + rng.normal(0, 0.5, (N, 3))
    out = rng.uniform(size=N) < 0.1
    obs[out] += rng.normal(0, 25, (out.sum(), 3))
    octave = rng.integers(0, 8, N)
    p = dict(X=X, obs=obs.astype(np.float32), inv_sigma2=LUT[octave],
             is_stereo=rng.uniform(size=N) < 0.6,
             valid=rng.uniform(size=N) < 0.95)
    T0 = _pose(rng, rot=0.01, trans=0.05) @ T
    return T0.astype(np.float32), p


def _pose_close(Ta, Tb):
    """Translation and rotation-angle differences (the angle from the skew
    part of Ra^T Rb, well conditioned near identity unlike arccos)."""
    dt = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
    W = Ta[:3, :3].T @ Tb[:3, :3]
    w = 0.5 * np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]])
    return dt, float(np.arcsin(min(np.linalg.norm(w), 1.0)))


@pytest.mark.parametrize("seed", [5, 6])
def test_optimize_pose_matches_jax(seed):
    """4 rounds x 10 LM steps from a perturbed pose: 1e-3 m, 1e-4 rad,
    inlier masks equal on >= 99%."""
    T0, p = _pose_problem(seed)
    Tj, inj, _, nj = jpo.optimize_pose(
        JCAM, jnp.asarray(T0),
        jpo.PointPoseObs(**{k: jnp.asarray(v) for k, v in p.items()}))
    Tt, intt, _, nt = tpo.optimize_pose(
        CAM, _t(T0), tpo.PointPoseObs(**{k: _t(v) for k, v in p.items()}))
    dt, da = _pose_close(Tt.numpy().astype(np.float64), np.asarray(Tj, np.float64))
    assert dt <= 1e-3 and da <= 1e-4, (dt, da)
    assert (intt.numpy() == np.asarray(inj)).mean() >= 0.99
    assert abs(int(nt) - int(nj)) <= 3


@pytest.fixture(scope="module")
def two_frames():
    """Frames 0 and 1 of the seed-3 corridor, built by the port (the frame
    build's own parity is tests/test_torch_frontend.py), and their poses."""
    frames, poses, _ = _make_sequence(JCAM, 2, n_per_m=25.0, seed=3,
                                      return_poses=True)
    cfg = OrbConfig(n_features=600)
    fds = [tframe.build_frame_pair(_t(np.stack(f)), CAM, cfg) for f in frames]
    return fds, poses


def test_track_step_matches_jax(two_frames):
    """One tracking step on frame 1, with frame 0's stereo points as the
    last frame and as the local-map view, from a prediction 5 cm / 0.5
    degree off the true pose: T2 within 1e-3 m / 1e-4 rad; kp2last, the
    local-map association and the final inlier mask equal on >= 99% of the
    keypoints; the step's counts within 1%."""
    (f0, f1), poses = two_frames
    N = f0.feats.xy.shape[0]
    xy, depth = f0.feats.xy.numpy(), f0.depth.numpy()
    has = (depth > 0) & f0.feats.valid.numpy()
    z = np.maximum(depth, 1e-6)
    X = np.stack([(xy[:, 0] - CAM.cx) * z / CAM.fx,
                  (xy[:, 1] - CAM.cy) * z / CAM.fy, z], -1).astype(np.float32)
    X[~has] = 0
    # local-map view: the stereo points of frame 0, padded to 1024 rows
    ids = np.nonzero(has)[0]
    P = 1024
    dist = np.linalg.norm(X[ids], axis=-1)
    lvl = 1.2 ** f0.feats.octave.numpy()[ids]
    view = dict(pos=np.zeros((P, 3), np.float32),
                desc=np.zeros((P, 8), np.uint32),
                normal=np.zeros((P, 3), np.float32),
                min_dist=np.zeros(P, np.float32),
                max_dist=np.zeros(P, np.float32), valid=np.arange(P) < len(ids))
    view["pos"][:len(ids)] = X[ids]
    view["desc"][:len(ids)] = f0.feats.desc.numpy()[ids].view(np.uint32)
    view["normal"][:len(ids)] = X[ids] / dist[:, None]
    view["max_dist"][:len(ids)] = dist * lvl * 1.2
    view["min_dist"][:len(ids)] = dist * lvl / 1.2 ** 7 / 0.8
    rng = np.random.default_rng(7)
    T_pred = (_pose(rng, rot=0.009, trans=0.05) @ poses[1]).astype(np.float32)
    close_depth = 200.0 * 35.0 / 450.0

    jl = interop.to_numpy(f0.feats)
    jc = interop.to_numpy(f1.feats)
    packed, _, _, _, _, _, jT = jtracker._track_step(
        JCAM, jnp.asarray(T_pred), _jax_feats(jl), jnp.asarray(X),
        jnp.asarray(has), jnp.asarray(has), jnp.full((N,), -1, jnp.int32),
        _jax_feats(jc), jnp.asarray(f1.depth.numpy()),
        jm.MapPointView(**{k: jnp.asarray(v) for k, v in view.items()}),
        jnp.asarray(LUT), 8, 1.2, 7, close_depth)
    packed = np.asarray(packed)
    j_stats = packed[16:22]
    j_kp2last = packed[22:22 + N]
    j_kp2pt = packed[22 + N:22 + 2 * N]

    step = ttracker._track_core(
        CAM, _t(T_pred), f0.feats, _t(X), _t(has), _t(has), f1.feats,
        f1.depth, interop.map_point_view(view), _t(LUT), 8, 1.2, 7,
        close_depth)
    dt, da = _pose_close(step["T"].numpy().astype(np.float64),
                         np.asarray(jT, np.float64))
    assert dt <= 1e-3 and da <= 1e-4, (dt, da)
    t_kp2last, t_kp2pt = step["kp2last"].numpy(), step["kp2pt_l"].numpy()
    print(f"stats jax {j_stats.tolist()} port {step['stats'].tolist()}")
    assert (t_kp2last == j_kp2last).mean() >= 0.99
    assert (t_kp2pt == j_kp2pt).mean() >= 0.99
    nw = -(-N // 32)
    j_map_ok = jtracker._unpack_bits_np(packed[22 + 2 * N:22 + 2 * N + nw], N)
    assert (step["ok"].numpy() == j_map_ok).mean() >= 0.99
    t_stats = step["stats"].numpy()
    assert t_stats[1] > 100                       # map inliers
    np.testing.assert_allclose(t_stats, j_stats, rtol=0.01, atol=2)
