"""A fresh process's first loop-event Sim3 step after `System.warmup`, in
its two stages.

Usage (from the repository root, one card):

    python tools/torch_sim3_first_call.py [--ransac-only] [--rounds N]

The process creates the CUDA context and the inputs of
tools/torch_cold_start.py (the seeded 24-keyframe loop map), calls
`System.warmup()` on chip_smoke.py's pipelined native-line System, then
times N calls (default 4) of `LoopCloser._compute_sim3(21, 2)`, each on a
fresh closer: the whole call and its stages from `LoopCloser.stage_times`
("sim3": the keyframe descriptor match, Sim3 RANSAC and refinement;
"guided": the guided match). With --ransac-only the warm-up's dummy
descriptor match is skipped (the warm-up of RANSAC and refinement alone).
Prints one JSON line: the variant and per call [ms, sim3 ms, guided ms],
host ms with the card synchronised.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_cold_start as tcs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ransac-only", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from lldslam_tpu_torch.config import LineConfig
    from lldslam_tpu_torch.ops import hamming
    from lldslam_tpu_torch.system import System
    dev = torch.device("cuda")
    tcs._timed(dev, lambda: torch.zeros(1, device=dev) + 1)
    paths = tcs.Paths(dev)
    sys_ = System(dataclasses.replace(cs.kitti_config(), line=LineConfig(
        ld_type="LBDFloat", md_thr=0.6)), pipeline=True, device=dev)
    match = hamming.match_descriptors
    if a.ransac_only:
        hamming.match_descriptors = lambda *args, **kw: None
    try:
        sys_.warmup()
    finally:
        hamming.match_descriptors = match
    torch.cuda.synchronize()
    calls = []
    for _ in range(a.rounds):
        lc = paths._closer(paths.points_map, paths.cfg)
        ms, res = tcs._timed(dev, lambda: lc._compute_sim3(21, 2))
        if res is None:
            raise AssertionError("no Sim3 between keyframes 21 and 2")
        calls.append([ms] + [1e3 * lc.stage_times.get(k, 0.0)
                             for k in ("sim3", "guided")])
    print(json.dumps(dict(variant="ransac_only" if a.ransac_only
                          else "warmup", card=tcs._card(), calls=calls)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
