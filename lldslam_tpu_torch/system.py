"""System facade: the public API of the port.

Counterpart of lldslam_tpu/system.py, synchronous stereo only:

    sys = System(cfg, device="cuda")
    T_cw, metrics = sys.track_stereo(img_l, img_r, timestamp)
    sys.save_trajectory_kitti(path)

`enable_loops` defaults to False here (loop closing is not ported yet);
passing True, `pipeline=True`, a line-enabled config, `track_rgbd`,
`track_monocular`, `save_map` or `load_map` raises NotImplementedError.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .config import SlamConfig, load_config
from .io import trajectory as traj
from .pipeline.tracker import StereoTracker, TrackState


class System:
    def __init__(self, cfg: SlamConfig | str | Path, sequence: str | None = None,
                 enable_loops: bool = False, pipeline: bool = False,
                 device="cpu"):
        if not isinstance(cfg, SlamConfig):
            cfg = load_config(cfg, sequence=sequence)
        self.cfg = cfg
        self.device = device
        self.tracker = StereoTracker(cfg, enable_loops=enable_loops,
                                     pipeline=pipeline, device=device)

    # -- frame input ------------------------------------------------------
    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray,
                     timestamp: float = 0.0):
        """Returns (T_cw (4,4), per-frame metrics)."""
        return self.tracker.process(img_l, img_r, timestamp)

    def track_rgbd(self, img, depthmap, timestamp: float = 0.0,
                   depth_factor: float = 1.0):
        raise NotImplementedError(
            "RGB-D input is not ported to lldslam_tpu_torch yet; see ROADMAP "
            "queue 1 item 6")

    def track_monocular(self, img, timestamp: float = 0.0):
        raise NotImplementedError(
            "monocular input is not ported to lldslam_tpu_torch yet; see "
            "ROADMAP queue 1 item 6")

    def flush(self):
        """No-op: the synchronous tracker has nothing in flight."""
        return None

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    @property
    def map(self):
        return self.tracker.store

    # -- trajectory export --------------------------------------------------
    def save_trajectory_kitti(self, path: str | Path) -> None:
        _, T_wc = self.tracker.trajectory()
        traj.save_kitti(path, T_wc)

    def save_trajectory_tum(self, path: str | Path) -> None:
        ts, T_wc = self.tracker.trajectory()
        traj.save_tum(path, ts, T_wc)

    def save_keyframe_trajectory_tum(self, path: str | Path) -> None:
        s = self.map
        sel = np.nonzero(s.kf_valid[:s.n_kf])[0]
        T_cw = s.kf_pose[sel]
        Rwc = np.transpose(T_cw[:, :3, :3], (0, 2, 1))
        twc = -np.einsum("kij,kj->ki", Rwc, T_cw[:, :3, 3])
        T_wc = np.tile(np.eye(4, dtype=np.float32), (len(sel), 1, 1))
        T_wc[:, :3, :3] = Rwc
        T_wc[:, :3, 3] = twc
        traj.save_tum(path, s.kf_timestamp[sel], T_wc)

    # -- map persistence and lifecycle ------------------------------------
    def save_map(self, path) -> None:
        raise NotImplementedError(
            "map checkpoints are not ported to lldslam_tpu_torch yet; see "
            "ROADMAP queue 1 item 8")

    def load_map(self, path) -> None:
        raise NotImplementedError(
            "map checkpoints are not ported to lldslam_tpu_torch yet; see "
            "ROADMAP queue 1 item 8")

    def shutdown(self) -> None:
        """Nothing to stop: the synchronous path starts no threads."""
        return None
