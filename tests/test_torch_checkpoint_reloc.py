"""A map restored from a checkpoint can be tracked in, in the port.

`System.load_map` rebuilds the loop closer's keyframe database from the
stored keyframes and starts the tracker LOST on a non-empty map, so the next
frame relocalizes against the loaded map; in localization mode the tracker
never starts a map of its own. (The JAX package restores the store alone,
and its next frame starts a second map at the identity: the port's
divergence, ROADMAP queue 3.)

The world is the 12-frame 640x240 corridor of tests/test_torch_system.py
(seed 3, 600 features): mapped to frame 7, saved, loaded into a fresh
System in localization mode, then frame 8 must come back OK within 0.1 m of
its true pose, with the keyframe count unchanged.
"""
import numpy as np
import torch

from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
from lldslam_tpu_torch.io.synthetic import make_sequence
from lldslam_tpu_torch.ops.orb import OrbConfig
from lldslam_tpu_torch.system import System

torch.set_num_threads(2)

CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)


def _cfg():
    return SlamConfig(camera=CameraConfig(**CAM),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80))


def _centre(T_cw):
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def test_restored_map_relocalizes_in_localization_mode(tmp_path):
    frames, poses, _ = make_sequence(CameraConfig(**CAM).stereo_camera(), 12,
                                     n_per_m=25.0, seed=3, return_poses=True)
    mapper = System(_cfg(), device="cpu")
    for i in range(8):
        _, m = mapper.track_stereo(*frames[i], timestamp=i * 0.1)
        assert m.state == "OK"
    n_kf, n_pt = mapper.map.n_kf, int(mapper.map.pt_valid.sum())
    assert n_kf >= 3
    mapper.save_map(tmp_path / "map.npz")

    sys_ = System(_cfg(), device="cpu")
    sys_.load_map(tmp_path / "map.npz")
    tr = sys_.tracker
    assert tr.state.name == "LOST"
    live = set(np.nonzero(sys_.map.kf_valid[:n_kf])[0].tolist())
    assert set(tr.loop_closer.db.kf_words) == live
    sys_.activate_localization_mode()
    T_cw, m = sys_.track_stereo(*frames[8], timestamp=0.8)
    # the map frame is the first camera's
    true = poses[8] @ np.linalg.inv(poses[0])
    err = np.linalg.norm(_centre(T_cw) - _centre(true))
    print(f"frame 8: {m.state} against keyframe {m.reloc_kf}, {m.n_inliers} "
          f"inliers, centre error {err:.4f} m (true centre "
          f"{_centre(true).round(2)})")
    assert m.state == "OK" and m.reloc_kf >= 0
    assert err < 0.1, err
    assert np.linalg.norm(_centre(true)) > 5.0         # not the origin
    assert sys_.map.n_kf == n_kf
    assert int(sys_.map.pt_valid.sum()) == n_pt
    # and tracking goes on against the restored map
    T_cw, m = sys_.track_stereo(*frames[9], timestamp=0.9)
    true = poses[9] @ np.linalg.inv(poses[0])
    assert m.state == "OK"
    assert np.linalg.norm(_centre(T_cw) - _centre(true)) < 0.1
    assert sys_.map.n_kf == n_kf


def test_localization_mode_never_starts_a_map():
    """A tracker in localization mode with nothing loaded stays
    NOT_INITIALIZED on a frame that would initialize a map."""
    frames = make_sequence(CameraConfig(**CAM).stereo_camera(), 1,
                           n_per_m=25.0, seed=3)
    sys_ = System(_cfg(), enable_loops=False, device="cpu")
    sys_.activate_localization_mode()
    _, m = sys_.track_stereo(*frames[0])
    assert m.state == "NOT_INITIALIZED" and sys_.map.n_kf == 0
    sys_.deactivate_localization_mode()
    _, m = sys_.track_stereo(*frames[0])
    assert m.state == "OK" and sys_.map.n_kf == 1
