"""A traced window: one torch.profiler session over a few calls of the
cell's entry, reduced to the device's busy time, the device time of the
work launched inside each kernel op's range, launches, and the breakdown.

The reduction reads the profiler's raw (kineto) events. A device operation
is tied to the host call that launched it by their shared correlation id
(CUDA runtime or driver call -> kernel, copy or fill), so a kernel launched
from a library the profiler knows nothing of (the port's ctypes launches)
is attributed to the op range its launch lies in.

The H100's profiler has been seen to drop device records, a different
number in each session. A window is complete when it kept a device record
for at least 99% of the kernel launches its host records show (the test
of `chip_smoke.py::profile_window`); an incomplete window is discarded and
another taken, up to `tries` sessions.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
RANGE_PREFIXES = ("layer:", "op:")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def session(step, n_calls: int, device):
    """Profiles n_calls of step(); returns (kineto events, host window
    seconds)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(n_calls):
            step()
        _sync(device)
        wall = time.perf_counter() - t
    return list(prof.profiler.kineto_results.events()), wall


def _intervals(ranges):
    """(cuts, labels): the innermost range's name between consecutive
    cuts; an inner range cuts its outer one."""
    cuts = sorted({t for a, b, _ in ranges for t in (a, b)})
    label = [None] * max(len(cuts) - 1, 0)
    for a, b, nm in sorted(ranges, key=lambda r: r[0] - r[1]):  # outer first
        for k in range(bisect.bisect_left(cuts, a),
                       bisect.bisect_left(cuts, b)):
            label[k] = nm
    return cuts, label


def _label_at(cuts, label, t):
    k = bisect.bisect_right(cuts, t) - 1
    return label[k] if 0 <= k < len(label) else None


def reduce(events, wall_s: float) -> dict:
    """Busy seconds (the union of device intervals), kept share, launches,
    device seconds of the work launched inside each op range, top device
    operations, idle gaps summed by the innermost host range around them."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith(RANGE_PREFIXES):
                dev.append(e)
        elif e.device_type() == DeviceType.CPU:
            cpu.append(e)
    kernels = sum(not e.name().startswith(("Memcpy", "Memset")) for e in dev)
    launched = sum(e.name() in LAUNCH_CALLS for e in cpu)
    spans = sorted((e.start_ns(), e.end_ns()) for e in dev)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ns = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name()] += e.duration_ns()
    ranges = [(e.start_ns(), e.end_ns(), e.name()) for e in cpu
              if e.name().startswith(RANGE_PREFIXES)]
    layers = _intervals(ranges)
    ops = _intervals([r for r in ranges if r[2].startswith("op:")])
    # host runtime and driver calls (cuda*, cu*) by correlation id
    launch_at = {e.correlation_id(): e.start_ns() for e in cpu
                 if e.name().startswith("cu") and e.correlation_id() > 0}
    op_ns, tied = defaultdict(float), 0
    for e in dev:
        t = launch_at.get(e.correlation_id())
        if t is None:
            continue
        tied += 1
        nm = _label_at(*ops, t)
        if nm is not None:
            op_ns[nm[3:]] += e.duration_ns()
    # idle gaps between device intervals, named by the innermost host range
    # (layer or op) around the gap's middle; the host leads the device, so
    # that is what the host was doing while the device waited
    idle = defaultdict(float)
    for i in range(len(merged) - 1):
        a, b = merged[i][1], merged[i + 1][0]
        idle[_label_at(*layers, (a + b) // 2) or "outside the layers"] += b - a
    top = lambda d: [[k, v / 1e9] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(kept=kernels / launched if launched else 0.0,
                launches=launched, kernels=kernels, busy_s=busy_ns / 1e9,
                window_s=wall_s, tied=tied / len(dev) if dev else 0.0,
                op_device_s={k: v / 1e9 for k, v in op_ns.items()},
                device_ops=top(by_name), idle_gaps=top(idle))


def traced_window(step, n_calls: int, reset, device, tries: int = 3) -> dict:
    """The first complete session of n_calls, or the last one tried;
    reset() runs before each session."""
    # a first session after a long unprofiled stretch may miss device
    # operations: a short one first, discarded
    session(lambda: torch.ones(1, device=device).add_(1), 1, device)
    for k in range(tries):
        reset()
        out = reduce(*session(step, n_calls, device))
        print(f"gpubench: traced window {k + 1}: {out['kernels']} kernel "
              f"records for {out['launches']} launches, "
              f"{100 * out['tied']:.2f}% of device records tied to their "
              f"launch", file=sys.stderr)
        if out["kept"] >= 0.99:
            return out
    out["incomplete"] = True
    return out
