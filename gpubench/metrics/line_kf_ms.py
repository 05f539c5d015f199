"""Host ms of a keyframe's line stages (`StereoTracker.line_kf_times`:
snapshot, creation, retriangulation, culling, descriptors), summed, a
keyframe made in the window; nothing without lines."""


def read(run):
    lk = dict(run["window"]["line_kf"])
    n = lk.pop("n", 0)
    if not n:
        return None
    return 1e3 * sum(lk.values()) / n
