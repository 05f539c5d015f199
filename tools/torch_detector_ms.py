"""Device ms of the native line detector on a KITTI view, in several
checkouts, in turns.

Usage (from the repository root; one card):

    python tools/torch_detector_ms.py [--rounds N] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (`.` for this
one, or an unpacked `git archive` of another commit); they run in the order
given, each in its own process, so list them in turns (parent, change,
change, parent). A process takes the left view of frame 0 of chip_smoke.py's
lines world (1241x376, seed 2) and times that checkout's
`frontend.line_extract.detect_lines` on it (256 peak slots, the tracker's
minimum length) with its chip_smoke.py's `cuda_ms` (CUDA events around a
call, median of 12 after 3 warm calls), N rounds; it also counts the host
syncs of one call (sync debug mode "warn"), those of one stereo frame build
of that frame (`frontend.frame.build_frame_pair`, the KITTI config of
chip_smoke.py, the first step of every tracked frame), and tests whether a
detector call makes
the host wait for the device at all (a spin kernel holds the stream for
200 ms while the host calls the detector: the call returns before the spin
ends unless it waited; sync debug mode does not see every synchronising
operation). It prints one JSON line per checkout: every round's ms, their
median, the host syncs, the host's ms in the call behind the spin and the
spin's ms, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def child(root: str, rounds: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from lldslam_tpu_torch.config import LineConfig
    from lldslam_tpu_torch.frontend import line_extract as le

    from lldslam_tpu_torch.frontend import frame

    dev = torch.device("cuda", 0)
    left, right = cs.lines_sequence()[0][0]
    img = left
    x = torch.from_numpy(img).to(dev)
    pair = torch.from_numpy(np.stack([left, right])).to(dev)
    kitti = cs.kitti_config()
    build = lambda: frame.build_frame_pair(pair, kitti.camera.stereo_camera(),
                                           kitti.orb)
    build()
    build_syncs = cs.host_syncs(build)
    cfg = le.LineDetConfig(max_lines=256,
                           min_len=LineConfig().min_line_len)
    ms = [cs.cuda_ms(lambda: le.detect_lines(x, cfg), reps=12)
          for _ in range(rounds)]
    syncs = cs.host_syncs(lambda: le.detect_lines(x, cfg))
    a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 20_000_000 / a.elapsed_time(b)
    a.record()
    torch.cuda._sleep(int(200 * cycles_per_ms))
    b.record()
    t = time.perf_counter()
    le.detect_lines(x, cfg)
    behind_ms = 1e3 * (time.perf_counter() - t)
    b.synchronize()
    spin_ms = a.elapsed_time(b)
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30).stdout.strip()
    return dict(root=root, ms=ms, median_ms=statistics.median(ms),
                host_syncs=syncs, build_host_syncs=build_syncs,
                host_ms_behind_spin=behind_ms,
                spin_ms=spin_ms, waits=behind_ms >= 0.9 * spin_ms, card=card,
                package=str(Path(le.__file__).resolve()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*")
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(child(a.child, a.rounds)), flush=True)
        return 0
    rc = 0
    for root in a.roots:
        root = str(Path(root).resolve())
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--child", root,
                            "--rounds", str(a.rounds)], capture_output=True,
                           text=True, timeout=600, cwd=root)
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            print(json.dumps(dict(root=root, error=p.stderr[-2000:])),
                  flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
