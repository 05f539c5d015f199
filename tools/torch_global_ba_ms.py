"""Host ms of the loop-event global BA in several checkouts, in turns.

Usage (from the repository root; one card):

    python tools/torch_global_ba_ms.py [--reps N] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (`.` for this
one, or an unpacked `git archive` of another commit); they run in the
order given, each in its own process, so list them in turns (parent,
change, change, parent). A process builds the ring map of chip_smoke.py's
loop phase and the loop-lines correction's inputs (phase_loop_lines) with
that checkout's own chip_smoke.py and package, then times, N times each in
turns, LoopCloser.global_ba (the single route) on copies of the ring map
and of the loop-lines map (make_loop_map + add_loop_lines: the joint
point+line problem) and the loop-lines correction (`_correct(21, 2, S)`),
host ms around each call with the card synchronised (for the two global
BAs also the process's CPU ms, which leave out the time the host's other
work takes the core from it). In a checkout whose
solvers sum through `ops/segment_sum.segment_sum_`, each round also runs
the three once more with `segment_sum_` swapped for the atomic
`out.index_add_(0, layout.index, src)` in the solvers' modules (arm
"atomic"; the sums' order is then the card's, and the rest of the code is
the same), in turns with the fixed-order arm, in the same process. It
prints one JSON line per checkout: the medians per arm, every reading, and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(root: str, reps: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke as cs
    from lldslam_tpu_torch.io.synthetic import add_loop_lines, make_loop_map
    from lldslam_tpu_torch.loop.closing import LoopCloser
    from lldslam_tpu_torch.slammap.map_store import MapStore

    dev = torch.device("cuda", 0)
    ring = cs.phase_loop(dev)
    inputs = cs.phase_loop_lines(dev)["inputs"]
    cfg = cs.patch_world_config()
    lines = MapStore(cfg.camera.stereo_camera(), cfg.orb, max_kf=64,
                     max_pt=20000)
    add_loop_lines(lines, make_loop_map(lines))

    cpu_ms = {}

    def gba(store, voc, cfg, key):
        lc = LoopCloser(copy.deepcopy(store), voc, cfg, device=dev)
        torch.cuda.synchronize()
        t, c = time.perf_counter(), time.process_time()
        lc.global_ba(force_dist=False)
        torch.cuda.synchronize()
        cpu_ms.setdefault(key, []).append(1e3 * (time.process_time() - c))
        return 1e3 * (time.perf_counter() - t)

    runs = dict(
        ring_gba=lambda: gba(ring["store"], ring["voc"], ring["cfg"],
                             (arm_now[0], "ring_gba")),
        loop_lines_gba=lambda: gba(lines, ring["voc"], cfg,
                                   (arm_now[0], "loop_lines_gba")),
        loop_lines_correct=lambda: cs.loop_lines_correct(
            dev, inputs, "single")[1])
    arms = {"as checked out": None}
    try:
        from lldslam_tpu_torch.ops import segment_sum
    except ImportError:     # a checkout from before the segment sum
        segment_sum = None
    if segment_sum is not None:
        from lldslam_tpu_torch.optim import ba, lines_ba, pose_graph
        arms["atomic"] = lambda out, lay, src: out.index_add_(
            0, lay.index, src)
    ms = {arm: {k: [] for k in runs} for arm in arms}
    arm_now = [None]
    for _ in range(reps):
        for arm, patch in arms.items():
            arm_now[0] = arm
            if segment_sum is not None:
                for mod in (ba, lines_ba, pose_graph):
                    mod.segment_sum_ = patch or segment_sum.segment_sum_
            for k, fn in runs.items():
                ms[arm][k].append(fn())
    if segment_sum is not None:
        for mod in (ba, lines_ba, pose_graph):
            mod.segment_sum_ = segment_sum.segment_sum_
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cpu = {arm: {k: v for (a, k), v in cpu_ms.items() if a == arm}
           for arm in arms}
    return dict(checkout=root, card=smi, reps=reps,
                median={arm: {k: statistics.median(v) for k, v in m.items()}
                        for arm, m in ms.items()},
                cpu_median={arm: {k: statistics.median(v)
                                  for k, v in m.items()}
                            for arm, m in cpu.items()}, ms=ms, cpu_ms=cpu)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("checkouts", nargs="+")
    a = ap.parse_args()
    if a.child:
        print("RESULT " + json.dumps(child(a.checkouts[0], a.reps)),
              flush=True)
        return 0
    for root in a.checkouts:
        root = str(Path(root).resolve())
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--reps", str(a.reps), root],
            capture_output=True, text=True, cwd=root)
        res = [line[7:] for line in out.stdout.splitlines()
               if line.startswith("RESULT ")]
        if out.returncode != 0 or not res:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        print(res[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
