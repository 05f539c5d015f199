"""The tracking step's host dispatch (ms) a frame: the program's own
`TrackMetrics.t_dispatch`, the mean over the window's finalized frames (a
batched step's share where a schedule batches sequences)."""


def read(run):
    ms = run["window"]["metrics"]
    if not ms:
        return None
    return 1e3 * sum(m.t_dispatch for m in ms) / len(ms)
