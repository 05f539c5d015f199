"""Host ms of loop closing a keyframe made in the window: the benchmark's
host-clock span of `LoopCloser.finish_keyframe` / `process_keyframe` (BoW
query and detection; no loop event happens in a corridor) over the
window, per keyframe. On the pipelined route the program's own
`kf_timings[...]["loop"]` reads 0: the loop step is staged."""


def read(run):
    w = run["window"]
    if not w["kf"] or "loop closing" not in w.get("spans", {}):
        return None
    return 1e3 * w["spans"]["loop closing"] / len(w["kf"])
