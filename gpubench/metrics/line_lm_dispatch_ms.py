"""Host ms a frame of the line step's joint point+line pose LM (the
program's `track.line_lm` spans, summed a frame), the mean over the
window's finalized frames; nothing where the program records no such
span."""

NAMES = ("track.line_lm",)


def read(run):
    ms = [m for m in run["window"]["metrics"] if getattr(m, "spans", None)]
    found = [b - a for m in ms for name, a, b, _ in m.spans if name in NAMES]
    if not found:
        return None
    return sum(found) / 1e6 / len(ms)
