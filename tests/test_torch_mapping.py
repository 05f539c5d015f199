"""CPU parity of the port's keyframe-rate mapping with the JAX package:
triangulation against a neighbour keyframe, fusion (through K2's plain
version) and the windowed local BA on the dense grid.

Fixtures are made with numpy from a seed: points seen by two or more
keyframes, features at their projections with pixel noise, descriptors a few
bit flips from a shared base, distractors and outliers. Matching is integer
work on identical float gates, so its indices are held exactly; the
triangulated points to 1e-4 relative, a bound that grows as the midpoint
solve's 1 / sin^2(parallax) conditioning below ~6 degrees. The BA sums its
normal equations in another order in the two frameworks, which can move an
LM accept/reject step: poses, and points with two or more kept
observations, agree to 1e-3 of each array's magnitude, and the keep mask on
>= 99.5% of the observations.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lldslam_tpu.config import CameraConfig  # noqa: E402
from lldslam_tpu.frontend import matching as jm  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.optim import ba as jba  # noqa: E402
from lldslam_tpu.pipeline import mapping_ops as jmo  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.optim import ba as tba  # noqa: E402
from lldslam_tpu_torch.pipeline import mapping_ops as tmo  # noqa: E402

torch.set_num_threads(2)

JCAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                    fps=10.0, width=640, height=240).stereo_camera()
CAM = StereoCamera(*JCAM)
LUT = np.power(1.0 / 1.2 ** 2, np.arange(8)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _exp(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    return np.stack([u, v, u - CAM.bf / Xc[:, 2]], -1), Xc[:, 2]


def _flip(rng, desc, max_bits):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, rng.integers(0, max_bits + 1), replace=False):
            out[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _points(rng, n, T, far=30.0):
    """n world points 4..far m in front of the camera at T."""
    Tw = np.linalg.inv(T)
    Xc = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2.5, 2.5, n),
                   rng.uniform(4, far, n)], -1)
    return (Xc @ Tw[:3, :3].T + Tw[:3, 3]).astype(np.float32)


def _kf_pair(seed, N=512, n_common=300):
    """Two keyframes 1 m apart; the first n_common features of each see the
    same points, in shuffled order in KF2; the rest are distractors."""
    rng = np.random.default_rng(seed)
    T1 = _exp(rng.normal(0, 0.02, 6))
    T2 = _exp([0.8, 0.05, -0.6, 0.0, 0.02, 0.0]) @ T1
    X = _points(rng, n_common, T1)
    base = rng.integers(0, 2**32, (n_common, 8), dtype=np.uint64).astype(np.uint32)
    perm = rng.permutation(n_common)
    kfs = []
    for T, order in ((T1, np.arange(n_common)), (T2, perm)):
        uvr, _ = _project(T, X[order])
        xy = rng.uniform([0, 0], [CAM.width, CAM.height], (N, 2)).astype(np.float32)
        xy[:n_common] = uvr[:, :2] + rng.normal(0, 0.3, (n_common, 2))
        desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
        desc[:n_common] = _flip(rng, base[order], 12)
        oct_ = rng.integers(0, 3, N).astype(np.int32)
        free = rng.uniform(size=N) < 0.9
        kfs.append(dict(T=T.astype(np.float32), xy=xy, desc=desc, oct=oct_,
                        free=free))
    return kfs


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_pair_matches_jax(seed):
    """Match indices exact; X within 1e-4 relative on the matched rows,
    scaled by the solve's conditioning at low parallax."""
    k1, k2 = _kf_pair(seed)
    args = lambda a, T: (T(k1["T"]), T(k2["T"]), a(k1["xy"]), a(k1["desc"]),
                         a(k1["oct"]), a(k1["free"]), a(k2["xy"]),
                         a(k2["desc"]), a(k2["oct"]), a(k2["free"]), a(LUT))
    buf = np.asarray(jmo.triangulate_pair(JCAM, *args(jnp.asarray, jnp.asarray)))
    n_j, match_j, X_j = jmo.unpack_triangulate_np(buf, len(k1["xy"]))
    conv = lambda a: _t(a.view(np.int32) if a.dtype == np.uint32 else a)
    n_t, match_t, X_t = tmo.triangulate_pair(CAM, *args(conv, _t))
    np.testing.assert_array_equal(match_t.numpy(), match_j)
    assert int(n_t) == n_j and n_j > 100
    ok = match_j >= 0
    # the midpoint solve divides by 1 - cos^2(parallax): float32 rounding in
    # the rays grows by 1 / sin^2, so the bound is 1e-4 relative for
    # parallax above ~6 degrees and grows as 1 / sin^2 below it
    X_j, X_t = X_j[ok], X_t.numpy()[ok]
    c1 = -k1["T"][:3, :3].T @ k1["T"][:3, 3]
    c2 = -k2["T"][:3, :3].T @ k2["T"][:3, 3]
    a, b = X_j - c1, X_j - c2
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    sin2 = 1.0 - cos ** 2
    rel = np.linalg.norm(X_t - X_j, axis=-1) / np.linalg.norm(X_j, axis=-1)
    print(f"X: max relative diff {rel.max():.2e}, max rel * sin^2 "
          f"{(rel * sin2).max():.2e}")
    assert (rel <= 1e-4 * np.maximum(1.0, 1e-2 / sin2)).all()


def test_triangulate_pairs_is_per_neighbour():
    """The batched form gives, per neighbour, what triangulate_pair gives,
    and the JAX batched form's match indices."""
    ka, kb = _kf_pair(0)
    kc = _kf_pair(1)[1]
    conv = lambda a: _t(a.view(np.int32) if a.dtype == np.uint32 else a)
    nb = [kb, kc]
    st = lambda key: np.stack([k[key] for k in nb])
    got = tmo.triangulate_pairs(
        CAM, _t(ka["T"]), conv(ka["xy"]), conv(ka["desc"]), conv(ka["oct"]),
        conv(ka["free"]), _t(st("T")), conv(st("xy")), conv(st("desc")),
        conv(st("oct")), conv(st("free")), _t(LUT))
    bufs = np.asarray(jmo.triangulate_pairs(
        JCAM, jnp.asarray(ka["T"]), jnp.asarray(ka["xy"]),
        jnp.asarray(ka["desc"]), jnp.asarray(ka["oct"]), jnp.asarray(ka["free"]),
        jnp.asarray(st("T")), jnp.asarray(st("xy")), jnp.asarray(st("desc")),
        jnp.asarray(st("oct")), jnp.asarray(st("free")), jnp.asarray(LUT)))
    for (n_t, match_t, X_t), k2, buf in zip(got, nb, bufs):
        one = tmo.triangulate_pair(
            CAM, _t(ka["T"]), _t(k2["T"]), conv(ka["xy"]), conv(ka["desc"]),
            conv(ka["oct"]), conv(ka["free"]), conv(k2["xy"]),
            conv(k2["desc"]), conv(k2["oct"]), conv(k2["free"]), _t(LUT))
        assert torch.equal(match_t, one[1]) and torch.equal(X_t, one[2])
        n_j, match_j, _ = jmo.unpack_triangulate_np(buf, len(ka["xy"]))
        np.testing.assert_array_equal(match_t.numpy(), match_j)
        assert int(n_t) == n_j


def _fuse_case(seed, P=256, N=512):
    rng = np.random.default_rng(seed)
    T = _exp(rng.normal(0, 0.05, 6))
    Tw = np.linalg.inv(T)
    n_pt = P - 32
    X = _points(rng, n_pt, T)
    uvr, _ = _project(T, X)
    centre = Tw[:3, 3]
    dist = np.linalg.norm(X - centre, axis=-1)
    octave = rng.integers(0, 3, n_pt).astype(np.int32)
    view = dict(pos=np.zeros((P, 3), np.float32),
                desc=rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32),
                normal=np.zeros((P, 3), np.float32),
                min_dist=np.zeros(P, np.float32),
                max_dist=np.zeros(P, np.float32), valid=np.arange(P) < n_pt)
    view["pos"][:n_pt] = X
    view["normal"][:n_pt] = (X - centre) / dist[:, None]
    view["min_dist"][:n_pt] = dist * 0.5
    view["max_dist"][:n_pt] = dist * 1.2 ** octave * 1.1
    seen = rng.choice(n_pt, int(0.8 * n_pt), replace=False)
    k = len(seen)
    feats = dict(
        xy=rng.uniform([0, 0], [CAM.width, CAM.height], (N, 2)).astype(np.float32),
        ur=np.full(N, -1.0, np.float32),
        octave=rng.integers(0, 3, N).astype(np.int32),
        angle=rng.uniform(-np.pi, np.pi, N).astype(np.float32),
        desc=rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32),
        valid=rng.uniform(size=N) < 0.95)
    feats["xy"][:k] = uvr[seen, :2] + rng.normal(0, 0.3, (k, 2))
    st = rng.uniform(size=k) < 0.5
    feats["ur"][:k][st] = (uvr[seen, 2] + rng.normal(0, 0.3, k))[st]
    feats["octave"][:k] = octave[seen]
    feats["desc"][:k] = _flip(rng, view["desc"][seen], 50)
    return T.astype(np.float32), view, feats


@pytest.mark.parametrize("seed", [2, 3])
def test_fuse_candidates_matches_jax(seed):
    """Radius-3 projection search into a keyframe: pt2kp and kp2pt exact,
    for one target and for the two-target form."""
    T, view, feats = _fuse_case(seed)
    jv = jm.MapPointView(**{k: jnp.asarray(v) for k, v in view.items()})
    jf = jm.FrameFeatures(**{k: jnp.asarray(v) for k, v in feats.items()})
    buf = np.asarray(jmo.fuse_candidates(JCAM, jnp.asarray(T), jv, jf))
    P = len(view["pos"])
    tv, tf = interop.map_point_view(view), interop.frame_features(feats)
    pt2kp, kp2pt = tmo.fuse_candidates(CAM, _t(T), tv, tf)
    np.testing.assert_array_equal(pt2kp.numpy(), buf[:P])
    np.testing.assert_array_equal(kp2pt.numpy(), buf[P:])
    assert (buf[:P] >= 0).sum() > 50
    multi = tmo.fuse_candidates_multi(CAM, _t(np.stack([T, T])), tv, [tf, tf])
    for a, b in multi:
        np.testing.assert_array_equal(a.numpy(), buf[:P])
        np.testing.assert_array_equal(b.numpy(), buf[P:])


def _ba_problem(seed, K=6, n_kf=4, P=256, n_pt=180, O=1024):
    """n_kf keyframes 0.67 m apart (the last one fixed, K - n_kf fixed
    identity padding rows), points seen by 2..n_kf of them with 0.5 px
    noise and 3% gross outliers; poses and points start perturbed."""
    rng = np.random.default_rng(seed)
    poses_true = [_exp([-0.6 * k, 0.0, -0.3 * k, 0.0, 0.01 * k, 0.0])
                  for k in range(n_kf)]
    X = _points(rng, n_pt, poses_true[-1], far=15.0)
    ks, ps, uvr = [], [], []
    for p in range(n_pt):
        for k in np.sort(rng.choice(n_kf, rng.integers(2, n_kf + 1),
                                    replace=False)):
            obs, z = _project(poses_true[k], X[p:p + 1])
            if z[0] > 0.5:
                ks.append(k)
                ps.append(p)
                uvr.append(obs[0])
    n_obs = len(ks)
    uvr = np.asarray(uvr) + rng.normal(0, 0.5, (n_obs, 3))
    bad = rng.uniform(size=n_obs) < 0.03
    uvr[bad] += rng.normal(0, 30, (bad.sum(), 3))
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(n_kf):
        d = rng.normal(0, [0.03, 0.03, 0.03, 0.003, 0.003, 0.003])
        poses[k] = (_exp(d) @ poses_true[k]) if k < n_kf - 1 else poses_true[k]
    fixed = np.ones(K, bool)
    fixed[:n_kf - 1] = False
    points = np.zeros((P, 3), np.float32)
    points[:n_pt] = X + rng.normal(0, 0.05, X.shape)
    pad = lambda a, fill, dt: np.concatenate(
        [np.asarray(a, dt), np.full((O - n_obs,) + np.shape(a)[1:], fill, dt)])
    octave = rng.integers(0, 4, n_obs)
    obs = dict(k=pad(ks, 0, np.int32), p=pad(ps, 0, np.int32),
               uvr=pad(uvr, 0.0, np.float32),
               inv_sigma2=pad(LUT[octave], 1.0, np.float32),
               is_stereo=pad(rng.uniform(size=n_obs) < 0.6, False, bool),
               valid=np.arange(O) < n_obs)
    return dict(poses=poses, points=points, pose_fixed=fixed,
                point_valid=np.arange(P) < n_pt), obs, n_obs


@pytest.mark.parametrize("seed", [4, 5])
def test_local_ba_matches_jax(seed):
    prob, obs, n_obs = _ba_problem(seed)
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()},
                       obs=jba.BAObs(**{k: jnp.asarray(v) for k, v in obs.items()}))
    tobs = {k: _t(v) for k, v in obs.items()}
    tobs["k"], tobs["p"] = tobs["k"].long(), tobs["p"].long()
    tp = tba.BAProblem(**{k: _t(v) for k, v in prob.items()},
                       obs=tba.BAObs(**tobs))
    js, jkeep = jba.local_ba(JCAM, jp)
    ts, tkeep = tba.local_ba(CAM, tp)
    keep_j, keep_t = np.asarray(jkeep)[:n_obs], tkeep.numpy()[:n_obs]
    # points left with fewer than two kept observations are unconstrained
    # (the mapper erases them); the others are compared
    n_kept = np.bincount(obs["p"][:n_obs][keep_j], minlength=len(prob["points"]))
    held = dict(poses=slice(None), points=n_kept >= 2)
    for name in ("poses", "points"):
        j = np.asarray(getattr(js, name))[held[name]]
        t = getattr(ts, name).numpy()[held[name]]
        err = np.abs(t - j).max()
        print(f"{name}: max |port - jax| {err:.2e}, magnitude "
              f"{np.abs(j).max():.2f}")
        assert err <= 1e-3 * np.abs(j).max(), name
    assert held["points"].sum() > 150
    assert (keep_j == keep_t).mean() >= 0.995
    assert keep_t.mean() > 0.9
    assert not tkeep.numpy()[n_obs:].any()
