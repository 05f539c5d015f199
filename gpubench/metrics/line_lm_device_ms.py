"""Device ms a traced frame of the work launched inside the line step's
joint point+line pose LM (the profiler's device time tied to the program's
`op:track.line_lm` ranges: the pose LM kernel and the gathers of its line
rows); nothing when the traced window is incomplete or the program opens
no such range."""

NAMES = ("track.line_lm",)


def read(run):
    t = run["traced"]
    if not t or t.get("incomplete") or not t["frames"]:
        return None
    found = [t["op_device_s"][k] for k in NAMES if k in t["op_device_s"]]
    if not found:
        return None
    return 1e3 * sum(found) / t["frames"]
