#!/usr/bin/env python3
"""Faults planted under a run of a cell: the timed path broken where its
answer is produced, so that `correct` has to come out false.

    python3 gpubench/faults.py --fault <name> --workload <cell> --seed <n> \\
        --seconds <s>

Each fault replaces one function of the port (before the harness attaches
its probes, so the check sees what the broken path produced), then runs
the cell as `run.py` does. The benchmark's own runs never plant one; the
tests in `tests/test_gpubench_run.py` run each at a small size on the CPU,
and on the card this script reads what each fault does to the numbers.
"""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

FAULTS = {
    # an answer altered where it is produced: one BRIEF bit of K1a
    "k1a_bit": """
from lldslam_tpu_torch.ops import orb_describe
_f = orb_describe.describe
def describe(*a, **k):
    angle, desc = _f(*a, **k)
    desc = desc.clone(); desc[..., 0, 0] ^= 1
    return angle, desc
orb_describe.describe = describe
""",
    # a step that returns its state unchanged: the point pose never moves
    "pose_unchanged": """
from lldslam_tpu_torch.pipeline import tracker
_f = tracker._track_step_chained
def step(cam, T_prev, vel_prev, *a, **k):
    out = _f(cam, T_prev, vel_prev, *a, **k)
    out["T"] = T_prev
    return out
tracker._track_step_chained = step
""",
    # the line step returns its pose unchanged: the point step's pose is
    # handed back
    "line_step_unchanged": """
from lldslam_tpu_torch.pipeline import tracker
_f = tracker._line_step
def line_step(cam, T, *a, **k):
    _, det2ln, n_line = _f(cam, T, *a, **k)
    return T, det2ln, n_line
tracker._line_step = line_step
""",
    # the local BA returns the window's map unchanged (points only and
    # joint with lines)
    "ba_unchanged": """
from lldslam_tpu_torch.pipeline import mapper_fast
_ba, _joint = mapper_fast.ba_view_cached, mapper_fast.joint_ba_view_cached
def ba(cam, cache, slots, poses, fixed, points, *a, **k):
    _, _, keep, view = _ba(cam, cache, slots, poses, fixed, points, *a, **k)
    return poses, points, keep, view
def joint(cam, cache, slots, poses, fixed, points, *a, **k):
    _, _, _, _, keep, keep_l, view = _joint(cam, cache, slots, poses, fixed,
                                            points, *a, **k)
    x0, d = a[8], a[9]
    return poses, points, x0, d, keep, keep_l, view
mapper_fast.ba_view_cached, mapper_fast.joint_ba_view_cached = ba, joint
""",
    # a stereo line match altered where it is produced
    "line_swapped": """
from lldslam_tpu_torch.frontend import line_match
_f = line_match.match_stereo_lines
def match(*a, **k):
    out = _f(*a, **k)
    r = out.r_idx.clone()
    sel = (r >= 0).nonzero()[:, 0]
    r[sel] = r[sel.roll(1)]
    return out._replace(r_idx=r)
line_match.match_stereo_lines = match
""",
}


def plant(name: str) -> None:
    exec(FAULTS[name], {})


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    plant(name)
    import run
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
