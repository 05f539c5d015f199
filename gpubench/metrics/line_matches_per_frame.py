"""Line inliers of the joint pose step a frame (`TrackMetrics.n_line_matches`),
the mean over the window's finalized frames; nothing without lines."""


def read(run):
    ms = run["window"]["metrics"]
    if not ms or not any(m.n_line_matches for m in ms):
        return None
    return sum(m.n_line_matches for m in ms) / len(ms)
