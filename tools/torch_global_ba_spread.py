"""How far two runs of the same global BA on the card end apart.

Usage (from the repository root; one card):

    python tools/torch_global_ba_spread.py

Builds the ring map of chip_smoke.py's loop phase (88 frames through
System, one loop event) and the loop-lines correction's inputs
(chip_smoke.phase_loop_lines), then runs LoopCloser.global_ba on copies of
the ring map, two runs each of the single route and the distributed route
(the one-rank NCCL group), and the loop-lines correction (`_correct(21, 2,
S)`) two runs of each route. Prints every pair's difference (keyframe
centres, rotations, points, map lines; 0 everywhere when the solvers
repeat, as their fixed-order segment sums make them) and the host ms of
each run.
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def ring_gba(ring, dev, route):
    from lldslam_tpu_torch.loop.closing import LoopCloser
    st = copy.deepcopy(ring["store"])
    lc = LoopCloser(st, ring["voc"], ring["cfg"], device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lc.global_ba(force_dist=route == "dist")
    torch.cuda.synchronize()
    return st, 1e3 * (time.perf_counter() - t)


def pairs(label, runs):
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            (ri, a, _), (rj, b, _) = runs[i], runs[j]
            cs.log(f"{label}: {ri} run {i} against {rj} run {j}: "
                   f"{cs._diff_text(cs.store_diff(a, b))}")
    cs.log(f"{label}: ms " + ", ".join(f"{r} {m:.1f}" for r, _, m in runs))


def main() -> int:
    from lldslam_tpu_torch.parallel import dist_schur

    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    ring = cs.phase_loop(dev)
    inputs = cs.phase_loop_lines(dev)["inputs"]
    dist_schur.make_mesh(device=dev)
    routes = ("single", "dist", "single", "dist")
    pairs("ring map global BA",
          [(r, *ring_gba(ring, dev, r)) for r in routes])
    pairs("loop-lines correction",
          [(r, *cs.loop_lines_correct(dev, inputs, r)[:2]) for r in routes])
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
