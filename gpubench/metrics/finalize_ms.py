"""Host ms a frame of the pipelined frame's host half outside its staged
keyframe work: the program's `finalize` span less its child spans (the
keyframe stage, keyframe creation, a synchronous re-track), the mean over
the window's finalized frames; nothing where the program records no
spans."""


def read(run):
    ms = [m for m in run["window"]["metrics"] if getattr(m, "spans", None)]
    if not ms:
        return None
    ns = 0
    for m in ms:
        for i, (name, a, b, _) in enumerate(m.spans):
            if name == "finalize":
                ns += (b - a) - sum(d - c for _, c, d, p in m.spans if p == i)
    return ns / 1e6 / len(ms)
