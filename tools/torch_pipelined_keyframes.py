"""The port's pipelined runs of chip_smoke.py's two pipelined worlds on a
device the caller names: the keyframe lists chip_smoke.py holds the card's
pipelined phases to (PIPE_KF_CPU, PIPE_LINES_KF_CPU).

    python tools/torch_pipelined_keyframes.py cpu     # the reference lists
    python tools/torch_pipelined_keyframes.py cuda

Runs lldslam_tpu_torch's System(cfg, pipeline=True) on the JAX bench's
headline schedule (bench.py:267-305: warmup, 6 frames through track_stereo,
the rest staged by stage_stereo and passed as pair_dev, then flush), loops
on, at chip_smoke.py's KITTI-size config: the main world (30 seed-3 frames)
and the lines world (30 seed-2 frames, stored detections). Prints one JSON
line per world: keyframes, states, ATE against the generator's poses, and
for the lines world the line matches per frame. KITTI size: on the CPU it
takes minutes and a few GB.
"""
import dataclasses
import json
from pathlib import Path
import sys
import tempfile
import time

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from chip_smoke import (PIPE_WARM, kitti_config, lines_sequence,  # noqa: E402
                        main_sequence)
from lldslam_tpu_torch.config import LineConfig  # noqa: E402
from lldslam_tpu_torch.io.stored_lines import stage_stored_pair  # noqa: E402
from lldslam_tpu_torch.io.synthetic import gen_stored_lines  # noqa: E402
from lldslam_tpu_torch.io.trajectory import ate_rmse  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402


def pipelined(cfg, frames, device, lines: bool) -> System:
    s = System(cfg, pipeline=True, device=device)
    s.warmup()
    for i in range(PIPE_WARM):
        s.track_stereo(*frames[i], timestamp=0.1 * i)
    src = s.tracker._line_source if lines else None
    for i in range(PIPE_WARM, len(frames)):
        lv = (stage_stored_pair(src[0], src[1], i, device=device)
              if lines else None)
        s.track_stereo(None, None, timestamp=0.1 * i,
                       pair_dev=s.stage_stereo(*frames[i]), lines_dev=lv)
    s.flush()
    return s


def run(world: str, device: str) -> dict:
    t0 = time.perf_counter()
    cfg = kitti_config()
    if world == "main":
        frames, poses = main_sequence()
    else:
        frames, poses, shape = lines_sequence()
        tmp = tempfile.mkdtemp(prefix="pipelined_lines_")
        gen_stored_lines(cfg.camera.stereo_camera(), poses, shape,
                         f"{tmp}/left", f"{tmp}/right")
        cfg = dataclasses.replace(cfg, line=LineConfig(
            ld_type="LBDFloat", md_thr=0.6, detections_path=f"{tmp}/left",
            descriptors_path=f"{tmp}/right"))
    s = pipelined(cfg, frames, device, world == "lines")
    m = s.tracker.metrics
    _, T_wc = s.tracker.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    out = dict(world=world, device=device,
               keyframes=[x.frame_id for x in m if x.new_kf],
               states=[x.state for x in m], ate=ate_rmse(T_wc, gt),
               seconds=time.perf_counter() - t0)
    if world == "lines":
        out["line_matches"] = [x.n_line_matches for x in m]
    return out


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    for w in ("main", "lines"):
        print(json.dumps(run(w, dev)), flush=True)
