"""The line step's pose LM kernel launches against their roofline, %: the
least time of the traced launches' work (benchlib/pose_lm_work.py, the
larger of its bytes over 3.35 TB/s and its float32 operations over 67
TFLOP/s) over the device time of the work launched inside the program's
`op:track.line_lm` ranges. A launch's rows are the program's counters
(`line_lm_rows`, `line_lm_lines`): capacity rows from the tensors' shapes,
the same on every launch of a cell, so the window's rows a launch are each
traced launch's; the traced launches are its frames times the window's
launches a frame (`line_lm_kernel`). Nothing where the program keeps no
such counters, or the traced window has no such range or is incomplete."""
from benchlib import pose_lm_work

KEY = "track.line_lm"


def read(run):
    ms = [m for m in run["window"]["metrics"] if hasattr(m, "counts")]
    launches, rows, lines = (sum(m.counts.get(key, 0) for m in ms) for key
                             in ("line_lm_kernel", "line_lm_rows",
                                 "line_lm_lines"))
    traced = run["traced"]
    if not launches or not lines or not traced or traced.get("incomplete"):
        return None
    dev_s = traced.get("op_device_s", {}).get(KEY, 0.0)
    if dev_s <= 0 or not traced.get("frames"):
        return None
    points = (rows - 2 * lines) / launches
    work = pose_lm_work.launch(points, lines / launches)
    n = traced["frames"] * launches / len(ms)
    return 100.0 * n * run["work"].bound_s(*work) / dev_s
