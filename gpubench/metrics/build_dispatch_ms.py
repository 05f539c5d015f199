"""Host ms a frame handed over spent dispatching the frame build
(`frontend.frame.build_frame_batch`: pyramid, FAST, K1a, stereo match,
K1b): the benchmark's host-clock span of the frame build layer. It is
dispatch, not device time: the pipelined route does not wait for the card."""


def read(run):
    w = run["window"]
    handed = w["calls"] * w["per_call"]
    if not handed or "frame build" not in w.get("spans", {}):
        return None
    return 1e3 * w["spans"]["frame build"] / handed
