"""The port's pipelined runs of chip_smoke.py's pipelined worlds on a
device the caller names: the keyframe lists chip_smoke.py holds the card's
pipelined phases to (PIPE_KF_CPU, PIPE_LINES_KF_CPU, PIPE_NATIVE_KF_CPU).

    python tools/torch_pipelined_keyframes.py cpu     # the reference lists
    python tools/torch_pipelined_keyframes.py cuda
    python tools/torch_pipelined_keyframes.py DEVICE [--inflight N] WORLD...

WORLD is main, lines or native_lines (default: main and lines); --inflight
sets the tracker's max_inflight_windows (default 3, the JAX package's).

Runs lldslam_tpu_torch's System(cfg, pipeline=True) on the JAX bench's
headline schedule (bench.py:267-305: warmup, 6 frames through track_stereo,
the rest staged by stage_stereo and passed as pair_dev, then flush), loops
on, at chip_smoke.py's KITTI-size config: the main world (30 seed-3 frames),
the lines world (30 seed-2 frames, stored detections) and the lines world
on the native line detector (no detections path). Prints one JSON line per
world: keyframes, states, ATE against the generator's poses, and for the
line worlds the line matches per frame and the valid map lines. KITTI
size: on the CPU it takes minutes and a few GB.
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


def pipelined(cfg, frames, device, lines: bool, inflight: int = 3) -> System:
    s = System(cfg, pipeline=True, device=device)
    s.tracker.max_inflight_windows = inflight
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


def run(world: str, device: str, inflight: int = 3) -> dict:
    t0 = time.perf_counter()
    cfg = kitti_config()
    if world == "main":
        frames, poses = main_sequence()
    elif world == "native_lines":
        frames, poses, _ = lines_sequence()
        cfg = dataclasses.replace(cfg, line=LineConfig(ld_type="LBDFloat",
                                                       md_thr=0.6))
    else:
        frames, poses, shape = lines_sequence()
        tmp = tempfile.mkdtemp(prefix="pipelined_lines_")
        gen_stored_lines(cfg.camera.stereo_camera(), poses, shape,
                         f"{tmp}/left", f"{tmp}/right")
        cfg = dataclasses.replace(cfg, line=LineConfig(
            ld_type="LBDFloat", md_thr=0.6, detections_path=f"{tmp}/left",
            descriptors_path=f"{tmp}/right"))
    s = pipelined(cfg, frames, device, world == "lines", inflight)
    m = s.tracker.metrics
    _, T_wc = s.tracker.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    out = dict(world=world, device=device, inflight=inflight,
               keyframes=[x.frame_id for x in m if x.new_kf],
               states=[x.state for x in m], ate=ate_rmse(T_wc, gt),
               seconds=time.perf_counter() - t0)
    if world != "main":
        out["line_matches"] = [x.n_line_matches for x in m]
        out["map_lines"] = int(s.map.ln_valid.sum())
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("device", nargs="?", default="cpu")
    ap.add_argument("worlds", nargs="*", default=["main", "lines"])
    ap.add_argument("--inflight", type=int, default=3)
    a = ap.parse_intermixed_args()
    for w in a.worlds:
        print(json.dumps(run(w, a.device, a.inflight)), flush=True)
