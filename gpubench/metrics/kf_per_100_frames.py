"""Keyframes made in the window per 100 frames handed over (the program's
keyframe decision, a count)."""


def read(run):
    w = run["window"]
    handed = w["calls"] * w["per_call"]
    if not handed:
        return None
    return 100.0 * len(w["kf"]) / handed
