"""The port's RGB-D path, viewer and map checkpoints against the JAX
package, on the CPU.

The world is tests/test_rgbd_viewer_ckpt.py's: textured points at 512x384
(seed 9, 400 points) rendered as gray image and depth map, 10 frames
forward. Pose LM and local BA sum in another order in the two frameworks,
so the trajectories are held by bounds: every frame OK, the final pose
error under that test's 0.1 m, camera centres within 0.05 m of the JAX
run's.
"""
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import _make_sequence  # noqa: E402
from test_pipeline import _config, _make_world  # noqa: E402
from test_rgbd_viewer_ckpt import _render_rgbd  # noqa: E402
from lldslam_tpu.frontend import frame as jframe  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.io import checkpoint as jckpt  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu.viewer import render as jrender  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.io import synthetic  # noqa: E402
from lldslam_tpu_torch.ops import orb as torb  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402
from lldslam_tpu_torch.viewer import render  # noqa: E402

torch.set_num_threads(2)
N_FRAMES = 10


def _world():
    pts, patches = _make_world(np.random.default_rng(9), n=400)
    gt, T = [], np.eye(4, dtype=np.float32)
    for _ in range(N_FRAMES):
        gt.append(T.copy())
        xi = np.array([0.0, 0.0, -0.2, 0.0, 0.003, 0.0], np.float32)
        T = np.asarray(jse3.exp(jnp.asarray(xi)) @ jnp.asarray(T))
    return pts, patches, gt


@pytest.fixture(scope="module")
def runs():
    """The world through the JAX System and the port's (CPU)."""
    pts, patches, gt = _world()
    jcfg = _config()
    cam = jcfg.camera.stereo_camera()
    frames = [_render_rgbd(cam, g, pts, patches) for g in gt]
    jsys = JSystem(jcfg)
    tsys = System(interop.slam_config(asdict(jcfg)), device="cpu")
    for sys_ in (jsys, tsys):
        sys_.tracker.mapper.p_cap = 2048
        sys_.tracker.mapper.o_cap = 6144
    jsys.tracker.local_pt_cap = 2048
    states = {"jax": [], "port": []}
    for i, (img, depth) in enumerate(frames):
        for key, sys_ in (("jax", jsys), ("port", tsys)):
            _, m = sys_.track_rgbd(img, depth, timestamp=i * 0.1)
            states[key].append(m.state)
    return jsys, tsys, states, gt, frames


def test_render_points_rgbd_is_the_jax_tests_renderer():
    pts, patches, gt = _world()
    cam = _config().camera.stereo_camera()
    for g in (gt[0], gt[-1]):
        for want, got in zip(_render_rgbd(cam, g, pts, patches),
                             synthetic.render_points_rgbd(cam, g, pts,
                                                          patches)):
            np.testing.assert_array_equal(got, want)


def test_make_sequence_depth():
    """return_depth leaves the frames as bench._make_sequence draws them
    (the random stream is untouched) and returns the left view's ray
    depth: at frame 0 the ground pixel of the bottom row's centre lies at
    depth cam_h * fy / (v - cy)."""
    cam = _config().camera.stereo_camera()
    frames, poses, world, depths = synthetic.make_sequence(
        cam, 3, seed=3, half_w=2.0, cam_h=1.2, speed=0.05, return_poses=True,
        return_depth=True)
    want = _make_sequence(cam, 3, seed=3, half_w=2.0, cam_h=1.2, speed=0.05)
    for (jl, jr), (tl, tr) in zip(want, frames):
        for j, t in ((jl, tl), (jr, tr)):
            d = np.abs(j.astype(np.int16) - t.astype(np.int16))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4
    assert len(depths) == 3 and depths[0].shape == (cam.height, cam.width)
    d0 = depths[0]
    # every ray below the horizon hits the ground or a wall; a hit lies
    # beyond the ray caster's 0.25 m gate; rays over the walls stay inf
    assert np.isfinite(d0[int(cam.cy) + 1:]).all()
    assert (d0[np.isfinite(d0)] > 0.25).all()
    v = cam.height - 1
    u = int(cam.cx)
    np.testing.assert_allclose(d0[v, u],
                               world["cam_h"] * cam.fy / (v - cam.cy),
                               rtol=1e-5)


def test_build_frame_rgbd_matches():
    """build_frame_rgbd on the world's first frame: the same keypoints as
    the JAX build on >= 99.5% of the slots, and ur and depth exactly equal
    wherever the keypoint is; at depth_factor 0.5 as well."""
    pts, patches, gt = _world()
    jcfg = _config()
    cam = jcfg.camera.stereo_camera()
    img, depth = _render_rgbd(cam, gt[0], pts, patches)
    for factor in (1.0, 0.5):
        jf = jframe.build_frame_rgbd(jnp.asarray(img), jnp.asarray(depth), cam,
                                     jorb.OrbConfig(n_features=600),
                                     depth_factor=factor)
        tf = tframe.build_frame_rgbd(
            torch.from_numpy(img), torch.from_numpy(depth), StereoCamera(*cam),
            torb.OrbConfig(n_features=600), depth_factor=factor)
        same = ((tf.feats.xy.numpy() == np.asarray(jf.feats.xy)).all(-1)
                & (tf.feats.valid.numpy() == np.asarray(jf.feats.valid)))
        assert same.mean() >= 0.995
        np.testing.assert_array_equal(tf.feats.ur.numpy()[same],
                                      np.asarray(jf.feats.ur)[same])
        np.testing.assert_array_equal(tf.depth.numpy()[same],
                                      np.asarray(jf.depth)[same])
        assert (tf.feats.ur.numpy() >= 0).sum() > 200


def test_whole_slice_rgbd_matches_jax(runs):
    jsys, tsys, states, gt, _ = runs
    assert states["jax"] == ["OK"] * N_FRAMES
    assert states["port"] == ["OK"] * N_FRAMES
    T = np.linalg.inv(tsys.tracker.T_cw) @ gt[-1]
    err = np.linalg.norm(T[:3, 3])
    _, T_j = jsys.tracker.trajectory()
    _, T_t = tsys.tracker.trajectory()
    dc = np.linalg.norm(T_t[:, :3, 3] - T_j[:, :3, 3], axis=-1)
    pts = [int(s.map.pt_valid.sum()) for s in (jsys, tsys)]
    print(f"final position error {err:.4f} m; camera centres within "
          f"{dc.max():.4f} m of the JAX run's; points jax {pts[0]} port "
          f"{pts[1]}")
    assert err < 0.1
    assert dc.max() < 0.05


def test_render_topdown_of_the_port_map(runs, tmp_path):
    """The port's render_topdown of its map: the JAX function's image of
    the same store, exactly, and more than 100 non-background pixels; the
    PNG written when a path is given."""
    tsys = runs[1]
    _, T_wc = tsys.tracker.trajectory()
    img = render.render_topdown(tsys.map, T_wc, size=256)
    assert img.shape == (256, 256, 3)
    assert (img != render.BG).any(axis=-1).sum() > 100
    np.testing.assert_array_equal(
        img, jrender.render_topdown(tsys.map, T_wc, size=256))
    render.render_topdown(tsys.map, T_wc, path=tmp_path / "map.png", size=64)
    assert (tmp_path / "map.png").stat().st_size > 0


def test_render_frame_overlay_matches_jax(runs):
    tsys, frames = runs[1], runs[4]
    f = tsys.tracker._last_feats
    xy = f.xy.numpy()
    tracked = tsys.tracker._last_kp2pt >= 0
    p1 = np.array([[10.0, 10.0], [100.0, 50.0]])
    p2 = np.array([[200.0, 30.0], [100.0, 300.0]])
    args = (frames[-1][0], xy, tracked)
    kw = dict(lines_p1=p1, lines_p2=p2, lines_valid=np.array([True, True]))
    got = render.render_frame_overlay(*args, **kw)
    np.testing.assert_array_equal(got,
                                  jrender.render_frame_overlay(*args, **kw))
    assert (got == render.TRACKED).all(-1).sum() > 100


def _arrays(store) -> dict:
    return {k: v for k, v in vars(store).items() if isinstance(v, np.ndarray)}


def test_checkpoint_round_trip(runs, tmp_path):
    """save_map, then load_map into a fresh System: every array and counter
    equal, and the restored map answers a covisibility query as the
    original does."""
    tsys = runs[1]
    tsys.save_map(tmp_path / "map.npz")
    fresh = System(tsys.cfg, device="cpu", enable_loops=False)
    fresh.load_map(tmp_path / "map.npz")
    a, b = _arrays(tsys.map), _arrays(fresh.map)
    assert set(a) <= set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for k in ("n_kf", "n_pt", "n_ln"):
        assert getattr(fresh.map, k) == getattr(tsys.map, k)
    kf = tsys.map.n_kf - 1
    for x, y in zip(tsys.map.covisible_kfs(kf, min_shared=15),
                    fresh.map.covisible_kfs(kf, min_shared=15)):
        np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_loads_into_the_port(runs, tmp_path):
    """A map saved by the JAX package's save_map loads into the port's
    store with every array equal."""
    jsys = runs[0]
    jckpt.save_map(jsys.map, tmp_path / "jax_map.npz")
    fresh = System(runs[1].cfg, device="cpu", enable_loops=False)
    fresh.load_map(tmp_path / "jax_map.npz")
    for k, v in _arrays(jsys.map).items():
        np.testing.assert_array_equal(getattr(fresh.map, k), v, err_msg=k)
    for k in ("n_kf", "n_pt", "n_ln"):
        assert getattr(fresh.map, k) == getattr(jsys.map, k)
