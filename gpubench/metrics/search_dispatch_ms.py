"""Host ms a frame of the chained step's searches: both motion-model
matches and the local-map projection search (the program's
`track.motion_match` and `track.map_search` spans, summed a frame), the
mean over the window's finalized frames; nothing where the program
records no spans."""

NAMES = ("track.motion_match", "track.map_search")


def read(run):
    ms = [m for m in run["window"]["metrics"] if getattr(m, "spans", None)]
    if not ms:
        return None
    ns = sum(b - a for m in ms for name, a, b, _ in m.spans if name in NAMES)
    return ns / 1e6 / len(ms)
