"""The JAX package's own pipelined runs on the CPU: the reference numbers
chip_smoke.py holds the port's pipelined phases to.

Runs lldslam_tpu's System on the CPU on the JAX bench's headline schedule
(bench.py:267-305: 6 frames through track_stereo, the rest staged with
stage_pair and passed as pair_dev, then flush), loops on, at the KITTI-size
config of the bench headline:

    python tools/jax_cpu_pipelined_reference.py main    # 30 seed-3 frames
    python tools/jax_cpu_pipelined_reference.py lines   # 30 seed-2 frames,
                                                        # stored lines
    python tools/jax_cpu_pipelined_reference.py native_lines  # the same
                                        # frames, the native line detector

`main` and `native_lines` also run the synchronous System on the same
frames. Prints one JSON line: keyframes, ATE against the generator's poses,
states, point inliers per frame, and for the line worlds the line matches
per frame and the valid map lines. The JAX package
absorbs its staged work when a fetch has landed, so its pipelined numbers
may move with the host's speed. Takes several minutes and a few GB.
"""
import json
from pathlib import Path
import sys
import tempfile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from bench import _gen_stored_lines_ref_scale, _make_sequence  # noqa: E402
from lldslam_tpu.config import (CameraConfig, LineConfig,  # noqa: E402
                                SlamConfig, TrackingConfig)
from lldslam_tpu.io.stored_lines import stage_stored_pair  # noqa: E402
from lldslam_tpu.io.trajectory import ate_rmse  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu.system import System  # noqa: E402

N_FRAMES, N_WARM = 30, 6


def pipelined(cfg, frames, lines: bool):
    s = System(cfg, pipeline=True)
    for i in range(N_WARM):
        s.track_stereo(*frames[i], timestamp=i * 0.1)
    src = s.tracker._line_source if lines else None
    for j in range(N_WARM, N_FRAMES):
        lv = stage_stored_pair(src[0], src[1], j) if lines else None
        s.track_stereo(None, None, timestamp=j * 0.1,
                       pair_dev=s.tracker.stage_pair(*frames[j]),
                       lines_dev=lv)
    s.flush()
    return s


def main(which: str) -> dict:
    cam_cfg = CameraConfig(fx=718.856, fy=718.856, cx=607.1928,
                           cy=185.2157, bf=386.1448, fps=10.0, width=1241,
                           height=376)
    cam = cam_cfg.stereo_camera()
    seed = 3 if which == "main" else 2
    frames, poses, world = _make_sequence(cam, N_FRAMES, seed=seed,
                                          with_lines=which != "main",
                                          return_poses=True)
    gt = np.stack([np.linalg.inv(p) for p in poses])
    line = LineConfig()
    if which == "lines":
        tmp = tempfile.mkdtemp()
        _gen_stored_lines_ref_scale(cam, poses, world, f"{tmp}/left",
                                    f"{tmp}/right")
        line = LineConfig(ld_type="LBDFloat", md_thr=0.6,
                          detections_path=f"{tmp}/left",
                          descriptors_path=f"{tmp}/right")
    elif which == "native_lines":
        line = LineConfig(ld_type="LBDFloat", md_thr=0.6)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=2000),
                     line=line, tracking=TrackingConfig(min_init_points=100))
    out = {}
    s = pipelined(cfg, frames, which == "lines")
    _, T_p = s.tracker.trajectory()
    ms = s.tracker.metrics
    out.update(kfs=[m.frame_id for m in ms if m.new_kf],
               ate=float(ate_rmse(T_p, gt)), states=[m.state for m in ms],
               inliers=[m.n_inliers for m in ms])
    if which != "main":
        out.update(line_matches=[m.n_line_matches for m in ms],
                   n_lines=int(s.map.ln_valid.sum()))
    if which != "lines":
        sync = System(cfg)
        for i, f in enumerate(frames):
            sync.track_stereo(*f, timestamp=i * 0.1)
        _, T_s = sync.tracker.trajectory()
        sm = sync.tracker.metrics
        if which == "native_lines":
            out.update(sync_line_matches=[m.n_line_matches for m in sm],
                       sync_n_lines=int(sync.map.ln_valid.sum()))
        out.update(sync_kfs=[m.frame_id for m in sm if m.new_kf],
                   sync_ate=float(ate_rmse(T_s, gt)),
                   max_centre_diff=float(np.linalg.norm(
                       T_p[:, :3, 3] - T_s[:, :3, 3], axis=-1).max()))
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else "main")))
