"""Times a frame the host waited on the card (the program's `host_waits`
counter: event waits on window and stage copies, device values read on the
host, blocking uploads), summed over the window's finalized frames, over
those frames; nothing where the program keeps no counters."""


def read(run):
    ms = [m for m in run["window"]["metrics"] if hasattr(m, "counts")]
    if not ms:
        return None
    return sum(m.counts.get("host_waits", 0) for m in ms) / len(ms)
