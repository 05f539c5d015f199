"""Device ms a traced frame of the work launched inside the chained step's
searches, the program's `op:track.motion_match` and `op:track.map_search`
ranges: their own work, K2g's stays under the benchmark's `op:k2g`. Nothing
when the traced window is incomplete or the program opens no such range."""

NAMES = ("track.motion_match", "track.map_search")


def read(run):
    t = run["traced"]
    if not t or t.get("incomplete") or not t["frames"]:
        return None
    found = [t["op_device_s"][k] for k in NAMES if k in t["op_device_s"]]
    if not found:
        return None
    return 1e3 * sum(found) / t["frames"]
