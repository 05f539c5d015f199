"""One camera through `System(cfg, pipeline=True)`, closed loop.

Each call stages the frame `stage_ahead` frames ahead (`System.stage_stereo`,
and its stored detections with `io.stored_lines.stage_stored_pair`), then
hands the oldest staged frame to `System.track_stereo`. A traffic mix that
names `"schedule": "stream"` sets `stage_ahead`.

A call's `step()` hands over the next frame and returns the frames whose
poses came back in that call, each as (sequence, frame, seconds since its
hand-over, or None for a warm frame). Warm frames go through the same
entry, with host images.
"""
from __future__ import annotations

import time
from collections import deque

from lldslam_tpu_torch.io.stored_lines import stage_stored_pair
from lldslam_tpu_torch.system import System


class OutOfFrames(RuntimeError):
    pass


class Schedule:
    def __init__(self, cfg, world: dict, conf: dict, traffic: dict,
                 captures, device, warmup: bool = True):
        self.frames = world["frames"][0]
        self.captures = captures
        self.sys = System(cfg, enable_loops=conf["loops"], pipeline=True,
                          device=device)
        self.tracker = self.sys.tracker
        if warmup:
            self.sys.warmup()
        self.ahead = traffic["stage_ahead"]
        self.next = 0
        self.queue: deque = deque()
        self.handed: dict[int, float] = {}
        self.n_seen = 0
        self.lines_read_s = 0.0   # host seconds reading stored detections

    def _host(self, i):
        f = self.frames[i]
        return f[0].numpy(), f[1].numpy()

    def _stage(self, i):
        if i >= self.frames.shape[0]:
            return
        src = self.tracker._line_source
        t = time.perf_counter()
        lines = None if src is None else stage_stored_pair(
            src[0], src[1], i, device=self.tracker.device)
        self.lines_read_s += time.perf_counter() - t
        self.queue.append((i, self.sys.stage_stereo(*self._host(i)), lines))

    def warm(self, n: int):
        """n frames through `track_stereo` with host images (the first
        frames initialize the map), then the staging queue filled."""
        for i in range(n):
            self.sys.track_stereo(*self._host(i), timestamp=0.1 * i)
        self.next = n
        self.n_seen = len(self.tracker.metrics)
        for i in range(n, n + self.ahead):
            self._stage(i)

    def step(self) -> list[tuple[int, int, float]]:
        if not self.queue:
            raise OutOfFrames(f"stream: all {self.frames.shape[0]} frames "
                              "rendered at set-up were used")
        self._stage(self.next + self.ahead)
        i, pair, lines = self.queue.popleft()
        self.captures.current = [(0, i)]
        t = time.perf_counter()
        self.handed[i] = t
        self.sys.track_stereo(None, None, timestamp=0.1 * i, pair_dev=pair,
                              lines_dev=lines)
        done = time.perf_counter()
        self.next += 1
        ms = self.tracker.metrics[self.n_seen:]
        self.n_seen = len(self.tracker.metrics)
        return [(0, m.frame_id, done - self.handed[m.frame_id]
                 if m.frame_id in self.handed else None) for m in ms]

    def flush(self):
        self.sys.flush()

    @property
    def trackers(self):
        return [self.tracker]

    def per_call(self) -> int:
        return 1

    def staged(self) -> int:
        """Frames a sequence needs beyond the window's: the staging queue."""
        return self.ahead
