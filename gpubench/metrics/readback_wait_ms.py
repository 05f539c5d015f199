"""Host ms a frame handed over spent waiting in `ops.transfer.HostCopy.result`
(a window's copy to the host): the benchmark's host-clock span of the
window transfer layer over the window."""


def read(run):
    w = run["window"]
    handed = w["calls"] * w["per_call"]
    if not handed or "window transfer" not in w.get("spans", {}):
        return None
    return 1e3 * w["spans"]["window transfer"] / handed
