"""Time the PyTorch port's main path on the card: the 30 seed-3 KITTI-size
synthetic stereo frames through lldslam_tpu_torch.system.System with its
defaults (loops on, the shipped vocabulary), each frame synchronised.

    python tools/torch_main_path_ms.py [ROOT ...]

Each ROOT is a checkout of this repository (default: the one holding this
file); the runs go in the order given, each in a fresh process, so that two
versions can be compared on one card in turns (A B B A). Prints one JSON line
per run: the checkout, the card's name and power limit (nvidia-smi), ms per
frame (median and p90 of frames 1-29), keyframes and ATE.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, ROOT)
from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
from lldslam_tpu_torch.io.synthetic import make_sequence
from lldslam_tpu_torch.io.trajectory import ate_rmse
from lldslam_tpu_torch.ops.orb import OrbConfig
from lldslam_tpu_torch.system import System
assert torch.cuda.is_available(), "needs an NVIDIA GPU"
cfg = SlamConfig(camera=CameraConfig(fx=718.856, fy=718.856, cx=607.1928,
                                     cy=185.2157, bf=386.1448, fps=10.0,
                                     width=1241, height=376),
                 orb=OrbConfig(n_features=2000),
                 tracking=TrackingConfig(min_init_points=100))
frames, poses, _ = make_sequence(cfg.camera.stereo_camera(), 30, seed=3,
                                 return_poses=True)
sys_ = System(cfg, device="cuda")
sys_.warmup()
ms, kfs = [], []
for i, (l, r) in enumerate(frames):
    t = time.perf_counter()
    _, m = sys_.track_stereo(l, r, timestamp=0.1 * i)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t))
    if m.new_kf:
        kfs.append(i)
_, T = sys_.tracker.trajectory()
ate = ate_rmse(T, np.stack([np.linalg.inv(p) for p in poses]))
print(json.dumps(dict(root=ROOT, ms_median=statistics.median(ms[1:]),
                      ms_p90=float(np.percentile(ms[1:], 90)),
                      first_frame_ms=ms[0], keyframes=kfs, ate=ate)))
"""


def main() -> int:
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for root in roots:
        root = str(Path(root).resolve())
        out = subprocess.run(
            [sys.executable, "-c", f"ROOT = {root!r}\n" + RUN], cwd=root,
            capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["card"] = smi
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
