"""Device ms a traced frame of the work launched inside the chained step's
pose LMs (the profiler's device time tied to the program's
`op:track.pose_lm` ranges); nothing when the traced window is incomplete or
the program opens no such range."""

NAMES = ("track.pose_lm",)


def read(run):
    t = run["traced"]
    if not t or t.get("incomplete") or not t["frames"]:
        return None
    found = [t["op_device_s"][k] for k in NAMES if k in t["op_device_s"]]
    if not found:
        return None
    return 1e3 * sum(found) / t["frames"]
