"""Host ms a frame handed over that no span of the program explains: the
window's seconds less what the top-level spans (those whose parent is the
frame's root) cover, over the frames handed over. A frame's `build` and
`dispatch` run in the call that hands it over, its `copy.wait` and
`finalize` in the call that finalizes it, and the window hands over more
frames than it finalizes while the pipeline fills; so the covered time is
the frames handed over times the mean build and dispatch, plus the frames
finalized times the mean of the other top-level spans, both means over the
window's finalized frames. Nothing where the program records no spans."""

HANDOVER = ("build", "dispatch")


def read(run):
    w = run["window"]
    ms = [m for m in w["metrics"] if getattr(m, "spans", None)]
    handed = w["calls"] * w["per_call"]
    if not ms or not handed:
        return None
    top = [(name, b - a) for m in ms for name, a, b, p in m.spans if p == 0]
    ho = sum(ns for name, ns in top if name in HANDOVER) / len(ms)
    fin = sum(ns for name, ns in top if name not in HANDOVER) / len(ms)
    covered = handed * ho + w["frames"] * fin
    return (1e9 * w["window_s"] - covered) / handed / 1e6
