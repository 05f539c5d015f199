"""Host ms a frame of the staged keyframe work each finalized frame steps
(the program's `kf.stage` span: the mapper's staged stage and BA absorbed,
the post-BA view adopted, the loop queue's head), the mean over the
window's finalized frames; nothing where the program records no spans."""

NAMES = ("kf.stage",)


def read(run):
    ms = [m for m in run["window"]["metrics"] if getattr(m, "spans", None)]
    if not ms:
        return None
    ns = sum(b - a for m in ms for name, a, b, _ in m.spans if name in NAMES)
    return ns / 1e6 / len(ms)
