"""Spans and counters of the port's frame path: one record a frame.

A frame's record is its `TrackMetrics` (pipeline/tracker.py): `spans`, a
list of `(name, start_ns, end_ns, parent)` where parent is the index of the
enclosing span in that list (-1 for the root), and `counts`, named integer
counters. The root span, `frame`, runs from the frame's hand-over to
`StereoTracker.process` to the end of the call that finalizes its pose; a
pipelined frame's record is made current once for its build and dispatch
and again, in a later call, for its finalize:

    with tracing.frame(m):                  # m current; its root opens
        with tracing.span("build") as sp:
            ...
        m.t_build = sp.seconds
    ...
    with tracing.frame(m):                  # a later call
        with tracing.span("finalize"):
            ...
        tracing.end_frame(m)                # the pose is final

Spans nest through a stack; `count(name)` adds to the current record.
With no current record (warm-up, a function called alone) nothing is
recorded, except that a span given a dict `acc` always adds its seconds to
`acc[key]` (the mapper's and loop closer's `stage_times`). Where one step
serves several frames (the multi-sequence driver) its spans go on the
first member's record only, so a frame's top-level spans can be summed.

Stamps are `time.perf_counter_ns()`. `to_profiler_ns` maps a stamp onto the
clock of torch.profiler's host events (the Unix epoch) through one anchor
pair taken at import. While a profiler session is active, and only then,
each span also opens `torch.profiler.record_function("op:" + name)`, so
the device work launched inside a span is tied to it in the profiler's
trace; with no session no range is entered (a range costs microseconds
even with no profiler, the check a few tens of nanoseconds).

Counters: `host_waits`, each place on the pipelined route where the host
waits on the card (an event wait, a device value read on the host, a
blocking upload from pageable memory), counted where the wait is, on the
CPU as on the card; `event_waits`, those of them that wait on a CUDA event
(`ops.transfer.HostCopy.result`), which CUDA's sync debug mode does not
report.
"""
from __future__ import annotations

import time

import torch
import torch.autograd.profiler as _profiler

ROOT = "frame"

_now = time.perf_counter_ns
# one anchor pair: perf_counter_ns -> the Unix-epoch clock of the
# profiler's host events
_ANCHOR_PERF, _ANCHOR_UNIX = time.perf_counter_ns(), time.time_ns()

_cur = None        # the current record (a TrackMetrics), or None
_stack: list = []  # indices of its open spans, innermost last


def to_profiler_ns(t: int) -> int:
    """A perf_counter_ns stamp on the profiler's host clock."""
    return t - _ANCHOR_PERF + _ANCHOR_UNIX


def start(m) -> None:
    """Open m's root span (its hand-over) unless it has one."""
    if not m.spans:
        m.spans.append((ROOT, _now(), 0, -1))


def end_frame(m) -> None:
    """Close m's root span: the frame's pose is final."""
    if m.spans:
        name, t0, _, parent = m.spans[0]
        m.spans[0] = (name, t0, _now(), parent)


def current():
    """The current record, or None."""
    return _cur


class frame:
    """Context: `m` is the current record (its root opened by `start`),
    spans open under its root; the previous record is current again on
    exit."""

    __slots__ = ("m", "saved")

    def __init__(self, m):
        self.m = m

    def __enter__(self):
        global _cur, _stack
        self.saved = (_cur, _stack)
        start(self.m)
        _cur, _stack = self.m, [0]
        return self.m

    def __exit__(self, *exc):
        global _cur, _stack
        _cur, _stack = self.saved
        return False


class span:
    """Context: a span `name` in the current record, nested in the open
    one; `seconds` after exit. With `acc` (a dict) its seconds are added to
    acc[key] (key defaults to name) whether or not a record is current."""

    __slots__ = ("name", "acc", "key", "rec", "stack", "i", "rf", "t0", "t1")

    def __init__(self, name: str, acc: dict | None = None,
                 key: str | None = None):
        self.name, self.acc, self.key = name, acc, key

    def __enter__(self):
        self.rec, self.stack = _cur, _stack
        # stamped ahead of the range: a session's first range takes
        # hundreds of microseconds to enter, after its own start stamp
        self.t0 = t = _now()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function("op:" + self.name)
            self.rf.__enter__()
        if _cur is not None:
            self.i = len(_cur.spans)
            _cur.spans.append((self.name, t, 0, _stack[-1]))
            _stack.append(self.i)
        return self

    def __exit__(self, *exc):
        self.t1 = t = _now()
        if self.rec is not None:
            _, t0, _, parent = self.rec.spans[self.i]
            self.rec.spans[self.i] = (self.name, t0, t, parent)
            self.stack.pop()
        if self.acc is not None:
            key = self.key or self.name
            self.acc[key] = self.acc.get(key, 0.0) + (t - self.t0) * 1e-9
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add n to the current record's counter `name`."""
    if _cur is not None:
        _cur.counts[name] = _cur.counts.get(name, 0) + n
