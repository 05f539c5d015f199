"""Device ms a traced frame of the keyframe work: the profiler's device
time tied to the program's `op:kf.*` and `op:mapper.*` ranges (keyframe
creation, the staged mapper's dispatch and stages). Nothing when the
traced window is incomplete or the program opens no such range."""

PREFIXES = ("kf.", "mapper.")


def read(run):
    t = run["traced"]
    if not t or t.get("incomplete") or not t["frames"]:
        return None
    found = [v for k, v in t["op_device_s"].items() if k.startswith(PREFIXES)]
    if not found:
        return None
    return 1e3 * sum(found) / t["frames"]
