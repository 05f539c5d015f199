"""The stereo_kitti / stereo_euroc command lines.

Counterpart of lldslam_tpu/cli.py: load a sequence, feed its frames through
the port's System, report the median and mean tracking time, and write the
trajectory (and, with --metrics, one JSON line of TrackMetrics per frame).

    python -m lldslam_tpu_torch.cli kitti <settings.yaml> <sequence_dir>
    python -m lldslam_tpu_torch.cli euroc <settings.yaml> <sequence_dir> <times>

The System runs on the card unless `--device cpu` is given. KITTI frames
decode through the native threaded prefetcher (io/datasets.prefetch), EuRoC
frames through the native decoder as they are asked for; EuRoC settings
with rectification blocks (LEFT.K ...) undistort and rectify every pair on
that device first (ops/rectify.py); `--save-map` writes the map checkpoint
(io/checkpoint.py).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run_sequence(system, seq, realtime: bool = False, limit: int | None = None,
                 log=print):
    times = []
    n = len(seq) if limit is None else min(limit, len(seq))
    for i in range(n):
        img_l, img_r, ts = seq.frame(i)
        t0 = time.perf_counter()
        _, m = system.track_stereo(img_l, img_r, ts)
        dt = time.perf_counter() - t0
        times.append(dt)
        if i % 50 == 0:
            log(f"frame {i}/{n}: {m.state} inliers={m.n_inliers} "
                f"kfs={m.n_kfs} pts={m.n_points} lines={m.n_lines} "
                f"{dt * 1e3:.0f}ms")
        if realtime and i + 1 < n:
            wait = float(seq.timestamps[i + 1] - ts) - dt
            if wait > 0:
                time.sleep(wait)
    log(f"median tracking time: {np.median(times):.4f}s")
    log(f"mean tracking time:   {np.mean(times):.4f}s")
    return times


class RectifiedSequence:
    """A stereo sequence whose pairs go through a StereoRectifier; frames
    come back as uint8 numpy images."""

    def __init__(self, inner, rectifier):
        self.inner = inner
        self.rectifier = rectifier
        self.timestamps = inner.timestamps

    def __len__(self) -> int:
        return len(self.inner)

    def frame(self, i: int):
        il, ir, ts = self.inner.frame(i)
        jl, jr = self.rectifier(il, ir)
        return (jl.cpu().numpy().astype(np.uint8),
                jr.cpu().numpy().astype(np.uint8), ts)


def main(argv=None):
    from .config import parse_opencv_yaml
    from .io import datasets
    from .system import System

    p = argparse.ArgumentParser(prog="lldslam_tpu_torch")
    p.add_argument("dataset", choices=["kitti", "euroc"])
    p.add_argument("settings", help="reference-format YAML settings file")
    p.add_argument("sequence", help="sequence directory")
    p.add_argument("times", nargs="?", help="EuRoC timestamp file")
    p.add_argument("--out", default="CameraTrajectory.txt")
    p.add_argument("--format", choices=["kitti", "tum"], default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--realtime", action="store_true")
    p.add_argument("--save-map", default=None)
    p.add_argument("--metrics", default=None, help="JSONL per-frame metrics")
    p.add_argument("--device", default="cuda",
                   help="torch device of the System (default: the card)")
    args = p.parse_args(argv)

    if args.dataset == "kitti":
        seq = datasets.prefetch(datasets.load_kitti(args.sequence))
        fmt = args.format or "kitti"
        seq_name = args.sequence.rstrip("/").split("/")[-1]
    else:
        if not args.times:
            p.error("euroc requires a timestamp file")
        seq = datasets.load_euroc(args.sequence, args.times)
        fmt = args.format or "tum"
        seq_name = None
        d = parse_opencv_yaml(args.settings)
        if "LEFT.K" in d:
            from .ops.rectify import StereoRectifier
            seq = RectifiedSequence(seq,
                                    StereoRectifier(d, device=args.device))

    system = System(args.settings, sequence=seq_name, device=args.device)
    try:
        run_sequence(system, seq, realtime=args.realtime, limit=args.limit)
    finally:
        if isinstance(seq, datasets.PrefetchedStereoSequence):
            seq.close()
    if fmt == "kitti":
        system.save_trajectory_kitti(args.out)
    else:
        system.save_trajectory_tum(args.out)
    print(f"trajectory saved to {args.out}")
    if args.save_map:
        system.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    if args.metrics:
        with open(args.metrics, "w") as f:
            for m in system.tracker.metrics:
                f.write(json.dumps(vars(m)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
