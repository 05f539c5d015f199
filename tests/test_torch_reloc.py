"""Relocalization in the port against the JAX package: EPnP and its RANSAC
on the same inputs, the K2 relocalization call site
(`StereoTracker._project_view_match`) on a map carried across, and the
blackout scenario of tests/test_reloc.py through the port's `System`.

The scenario's JAX-side result on the CPU is recorded below instead of
re-running JAX: after 28 tracked frames of the tests/test_pipeline.py
corridor and 3 blank frames, the view of frame 4 relocalizes with a pose
error of 0.0298 m and 0.00088 rad (306 inliers). The port is held to the
bounds of tests/test_reloc.py (OK, under 0.1 m and 0.02 rad) and to that
run: its errors within 0.005 m and 0.0005 rad of the JAX errors (the
port's CPU run: 0.0294 m, 0.00081 rad, 304 inliers).
"""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.frontend import matching as jm  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.geometry.camera import StereoCamera as JStereoCamera  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.optim import pnp as jpnp  # noqa: E402
from lldslam_tpu.pipeline.tracker import StereoTracker as JTracker  # noqa: E402
from lldslam_tpu.slammap.map_store import MapStore as JMapStore  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.config import (CameraConfig, SlamConfig,  # noqa: E402
                                      TrackingConfig)
from lldslam_tpu_torch.geometry import se3  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.io.synthetic import (corridor_poses,  # noqa: E402
                                            make_loop_map, make_points_world,
                                            render_points)
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.optim import pnp  # noqa: E402
from lldslam_tpu_torch.pipeline.tracker import StereoTracker  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

JCAM = JStereoCamera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                     width=640, height=480)
CAM = StereoCamera(*JCAM)
W, H = 512, 384
WORLD = dict(fx=400.0, fy=400.0, cx=W / 2, cy=H / 2, bf=200.0, fps=10.0,
             width=W, height=H)
PORT_CFG = SlamConfig(camera=CameraConfig(**WORLD),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=100))
# the JAX package's CPU run of the blackout scenario (see the docstring)
JAX_RELOC_ERR_M, JAX_RELOC_ERR_RAD = 0.0298, 0.00088
RELOC_TOL_M, RELOC_TOL_RAD = 0.005, 0.0005


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(x):
    return x.detach().cpu().numpy()


def _scene(rng, n, T_cw):
    """tests/test_pnp.py's scene: points 6-25 m ahead and their pixels."""
    Pw = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                   rng.uniform(6, 25, n)], -1).astype(np.float32)
    Xc = (T_cw[:3, :3] @ Pw.T).T + T_cw[:3, 3]
    u = JCAM.fx * Xc[:, 0] / Xc[:, 2] + JCAM.cx
    v = JCAM.fy * Xc[:, 1] / Xc[:, 2] + JCAM.cy
    return Pw, np.stack([u, v], -1).astype(np.float32)


def _pose(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def test_epnp_matches_jax():
    """EPnP on 32 identical 6-point sets (exact pixels, points 6-25 m away):
    rotations within 1e-4 and translations within 5e-4 m of JAX, and both
    at the true pose. A float32 EPnP solve of this scene rounds the
    translation by ~1.5e-4 m in either framework (each is that far from the
    exact pose; a float64 solve of the port comes within 2e-5 m), so 1e-4 m
    would test LAPACK's rounding, not the port."""
    rng = np.random.default_rng(0)
    T_true = _pose([0.1, -0.15, 0.05, 0.3, -0.2, 0.5])
    Pw, uv = _scene(rng, 192, T_true)
    Pw, uv = Pw.reshape(32, 6, 3), uv.reshape(32, 6, 2)
    want = np.asarray(jpnp.epnp(JCAM, jnp.asarray(Pw), jnp.asarray(uv)))
    got = _n(pnp.epnp(CAM, _t(Pw), _t(uv)))
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(got, np.broadcast_to(T_true, got.shape),
                               rtol=0, atol=1e-3)


def test_ransac_pnp_matches_jax():
    """128 matches, 30% outliers. Scoring fed the 256 index sets JAX drew
    under PRNGKey(7): the same inlier mask and T_cw within 1e-3. The port's
    own draw (torch.Generator seeded 7) reaches the same inlier mask."""
    rng = np.random.default_rng(1)
    T_true = _pose([0.05, 0.2, -0.1, -0.4, 0.1, 0.8])
    n = 128
    Pw, uv = _scene(rng, n, T_true)
    out = rng.uniform(size=n) < 0.3
    uv[out] += rng.uniform(20, 80, (out.sum(), 2)).astype(np.float32)
    s2, valid = np.ones(n, np.float32), np.ones(n, bool)
    key = jax.random.PRNGKey(7)
    Tj, inl_j, n_j = jpnp.ransac_pnp(JCAM, jnp.asarray(Pw), jnp.asarray(uv),
                                     jnp.asarray(s2), jnp.asarray(valid), key)
    idx = np.asarray(jax.random.choice(key, n, shape=(256, 6), replace=True,
                                       p=jnp.asarray(valid, jnp.float32) / n))
    args = (_t(Pw), _t(uv), _t(s2), _t(valid))
    Tt, inl_t, n_t = pnp.score_pnp(CAM, *args, _t(idx))
    assert np.array_equal(_n(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 0.9 * (~out).sum()
    np.testing.assert_allclose(_n(Tt), np.asarray(Tj), rtol=0, atol=1e-3)
    g = torch.Generator().manual_seed(7)
    Tg, inl_g, _ = pnp.ransac_pnp(CAM, *args, g)
    assert np.array_equal(_n(inl_g), np.asarray(inl_j))
    np.testing.assert_allclose(_n(Tg), T_true, rtol=0, atol=2e-2)


def test_ransac_pnp_degenerate_all_invalid():
    """No valid match: no inlier, and the draw does not fail."""
    g = torch.Generator().manual_seed(7)
    _, inl, n_inl = pnp.ransac_pnp(CAM, torch.zeros(16, 3),
                                   torch.zeros(16, 2), torch.ones(16),
                                   torch.zeros(16, dtype=torch.bool), g)
    assert int(n_inl) == 0 and not bool(inl.any())


def test_reloc_project_view_match_exact():
    """The K2 relocalization call site: the local map of keyframe 2 of the
    synthetic loop map projected into keyframe 21's features at cap=8192,
    th 2.5 and 0.75, from the pose that aligns them: kp2pid exact."""
    jcc = JCameraConfig(**WORLD)
    jorb = JOrbConfig(n_features=600)
    js = JMapStore(jcc.stereo_camera(), jorb, max_kf=64, max_pt=20000)
    gt = make_loop_map(js)
    ts = interop.map_store(js, PORT_CFG.camera.stereo_camera(), PORT_CFG.orb)
    jtr = JTracker(JSlamConfig(camera=jcc, orb=jorb), store=js,
                   enable_loops=False)
    ttr = StereoTracker(PORT_CFG, store=ts, enable_loops=False,
                        device="cpu")
    feats = dict(xy=js.kf_xy[21], ur=js.kf_ur[21], octave=js.kf_oct[21],
                 angle=js.kf_angle[21], desc=js.kf_desc[21],
                 valid=js.kf_kp_valid[21])
    jfd = SimpleNamespace(feats=jm.FrameFeatures(
        **{k: jnp.asarray(v) for k, v in feats.items()}))
    tfd = SimpleNamespace(feats=interop.frame_features(feats))
    covis, _ = js.covisible_kfs(2, min_shared=15, top=10)
    pids = np.unique(js.kf_pt_ids[np.concatenate([[2], covis])])
    pids = pids[pids >= 0]
    T = (gt[21] @ np.linalg.inv(gt[2]) @ js.kf_pose[2]).astype(np.float32)
    for th in (2.5, 0.75):
        want = jtr._project_view_match(jfd, pids, T, th=th)
        got = ttr._project_view_match(tfd, pids, T, th=th)
        assert np.array_equal(got, want)
        assert (got >= 0).sum() >= 30


@pytest.fixture(scope="module")
def blackout():
    """tests/test_reloc.py's scenario through the port's System (loops on,
    the shipped vocabulary, the test's caps)."""
    pts, patches = make_points_world(np.random.default_rng(3))
    cam = PORT_CFG.camera.stereo_camera()
    gt = corridor_poses(34)
    sys = System(PORT_CFG, device="cpu")
    sys.tracker.mapper.p_cap = 2048
    sys.tracker.mapper.o_cap = 6144
    states = []
    for i in range(28):
        _, m = sys.track_stereo(*render_points(cam, gt[i], pts, patches),
                                timestamp=i * 0.1)
        states.append(m.state)
    n_kf = sys.map.n_kf
    blank = np.full((H, W), 15.0, np.float32)
    for i in range(3):
        _, m = sys.track_stereo(blank, blank, timestamp=1.0 + i * 0.1)
    lost = m.state
    _, m = sys.track_stereo(*render_points(cam, gt[4], pts, patches),
                            timestamp=2.0)
    T_est = sys.tracker.T_cw.copy()
    err = se3.log(_t(np.linalg.inv(T_est) @ gt[4])).numpy()
    return dict(sys=sys, states=states, n_kf=n_kf, lost=lost, reloc=m,
                err=err, gt=gt, pts=pts, patches=patches, cam=cam)


def test_relocalization_after_blackout(blackout):
    """Every frame OK before the blackout, more than 5 keyframes (no
    auto-reset), LOST after it, then OK on the revisited view within
    0.1 m and 0.02 rad of frame 4, and as far from it as the JAX run
    (0.0298 m, 0.00088 rad) within the stated margins."""
    b = blackout
    assert b["states"] == ["OK"] * 28
    assert b["n_kf"] > 5
    assert b["lost"] == "LOST"
    assert b["reloc"].state == "OK", "relocalization failed"
    err = b["err"]
    print(f"port reloc error {np.linalg.norm(err[:3]):.4f} m "
          f"{np.linalg.norm(err[3:]):.5f} rad (JAX {JAX_RELOC_ERR_M} m "
          f"{JAX_RELOC_ERR_RAD} rad), inliers {b['reloc'].n_inliers}")
    assert np.linalg.norm(err[:3]) < 0.1
    assert np.linalg.norm(err[3:]) < 0.02
    assert abs(np.linalg.norm(err[:3]) - JAX_RELOC_ERR_M) <= RELOC_TOL_M
    assert abs(np.linalg.norm(err[3:]) - JAX_RELOC_ERR_RAD) <= RELOC_TOL_RAD


def test_localization_mode_tracks_without_keyframes(blackout):
    """After relocalization, localization-only mode tracks the next frames
    against the frozen map: OK, and no keyframe is added; back in mapping
    mode the tracker may add keyframes again."""
    b = blackout
    sys = b["sys"]
    sys.activate_localization_mode()
    n_kf = sys.map.n_kf
    for i in range(5, 9):
        _, m = sys.track_stereo(*render_points(b["cam"], b["gt"][i], b["pts"],
                                               b["patches"]),
                                timestamp=2.0 + 0.1 * i)
        assert m.state == "OK" and not m.new_kf
    assert sys.map.n_kf == n_kf
    sys.deactivate_localization_mode()
    assert not sys.tracker.localization_only
