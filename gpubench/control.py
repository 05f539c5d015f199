#!/usr/bin/env python3
"""The control of a cell's check: the reference, computed in bfloat16 (the
next precision below the configuration's float32), put in the program's
place. It has to come out as not correct.

    python3 gpubench/control.py --workload <cell> --seed <n> --seconds <s>

One run of the cell as `run.py` makes it (the program drives the window,
its calls are kept as usual), after which the judged side is the
reference in bfloat16: the pyramid, the blur, K1a's angle and descriptors
and K1b's SAD refinement recomputed from the raw frames in bfloat16, K2g's
gates in bfloat16, and the generator's chain of camera centres accumulated
in bfloat16 for the trajectory. Its last line is the run's JSON, whose
`checks` hold the control's readings beside the limits. The benchmark's
own runs never run it.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main(argv=None) -> int:
    import torch
    return run.main(argv, dict(control=torch.bfloat16))


if __name__ == "__main__":
    sys.exit(main())
