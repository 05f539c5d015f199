"""Batched multi-sequence tracking: S stereo sequences on one card, each
frame's build and tracking step shared.

Counterpart of lldslam_tpu/parallel/multi_seq.py (`MultiSequenceDriver`,
`batched_build_frame`, `batched_track_step`), synchronous. The JAX driver
vmaps the frame build and the fused tracking step over a sequence axis; here
the same functions take the axis directly (`frontend.frame.build_frame_batch`,
`pipeline.tracker._track_core`), so each torch op of the build and of the
step runs once per frame for all S sequences, and each of the three CUDA
kernels launches once: K1a and K1b in the build, K2g at the tracking site.
`MultiSequenceDriver` owns S `StereoTracker`s (each with its own `MapStore`,
`LocalMapper` and, when loops are on, `LoopCloser`); per frame it

1. uploads the S stereo pairs as one (S, 2, H, W) uint8 tensor,
2. builds the S frames and predicts each sequence's pose as its solo
   tracker would (`StereoTracker._predict_pose`: the velocity model, or the
   reference keyframe anchor when there is no velocity; the JAX driver
   always takes velocity @ T_cw),
3. runs one batched tracking step and reads every sequence's results back
   in one copy (`StereoTracker._step_batch`), and
4. finalizes each sequence through its own tracker
   (`StereoTracker._track_finalize`): the weak-motion fallback, keyframes,
   local mapping and loop closing stay per sequence.

A sequence whose tracker is not `OK` (initialization, relocalization), or
that runs lines, takes its own solo `process` for that frame; a `None` pair
skips a finished sequence. Every tracker pins its local-map view capacity
(`LocalMapper.fixed_tv_cap`) so that the S views share one shape.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SlamConfig
from ..frontend.frame import build_frame_batch
from ..pipeline.tracker import StereoTracker, TrackMetrics, TrackState


class MultiSequenceDriver:
    """S stereo trackers stepped in lock-step, one batched frame build and
    one batched tracking step per frame."""

    def __init__(self, cfg: SlamConfig, n_seq: int, enable_loops: bool = False,
                 view_cap: int = 2048, device="cuda"):
        self.cfg = cfg
        self.n_seq = n_seq
        self.device = torch.device(device)
        self.cam = cfg.camera.stereo_camera()
        self.trackers = []
        for _ in range(n_seq):
            tr = StereoTracker(cfg, enable_loops=enable_loops, device=device)
            tr.mapper.fixed_tv_cap = view_cap
            self.trackers.append(tr)

    def _batchable(self) -> list[int]:
        return [i for i, tr in enumerate(self.trackers)
                if tr.state == TrackState.OK and not tr.enable_lines]

    def process(self, pairs: list, timestamps: list[float]) -> list:
        """Track one frame of every sequence. pairs: S (left, right) image
        pairs (None skips a finished sequence). Returns, per sequence,
        (T_cw (4, 4), TrackMetrics), or None for a skipped one."""
        S = self.n_seq
        live = [i for i in range(S) if pairs[i] is not None]
        batch = [i for i in self._batchable() if i in live]
        solo = [i for i in live if i not in batch]
        results: list = [None] * S
        if batch:
            t0 = time.perf_counter()
            stack = np.stack([np.stack(pairs[i]) for i in batch])
            if stack.dtype != np.uint8 and stack.max(initial=0.0) <= 255.0:
                stack = stack.astype(np.uint8)
            fdb = build_frame_batch(torch.from_numpy(stack).to(self.device),
                                    self.cam, self.cfg.orb)
            t1 = time.perf_counter()
            trs = [self.trackers[i] for i in batch]
            fds, ms = [], []
            for b, tr in enumerate(trs):
                tr.frame_id += 1
                ms.append(TrackMetrics(frame_id=tr.frame_id,
                                       t_build=(t1 - t0) / len(batch)))
                fds.append(fdb.seq(b))
            T_preds = [tr._predict_pose(fd) for tr, fd in zip(trs, fds)]
            t2 = time.perf_counter()
            outs = StereoTracker._step_batch(trs, fdb.feats, fdb.depth,
                                             T_preds)
            t_disp = (time.perf_counter() - t2) / len(batch)
            for i, tr, fd, m, (host, step) in zip(batch, trs, fds, ms, outs):
                m.t_dispatch = t_disp
                t3 = time.perf_counter()
                tr._track_finalize(fd, host, step, timestamps[i], m,
                                   tr.frame_id)
                m.t_step = time.perf_counter() - t3 - m.t_kf
                tr._finish_metrics(m)
                results[i] = (tr.T_cw.copy(), m)
        for i in solo:
            results[i] = self.trackers[i].process(pairs[i][0], pairs[i][1],
                                                  timestamps[i])
        return results

    def trajectories(self) -> list:
        """Per sequence, (timestamps, T_wc stack)."""
        return [tr.trajectory() for tr in self.trackers]


class PipelinedMultiSequenceDriver:
    """Not ported: the pipelined driver comes with the pipelined tracker."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the pipelined multi-sequence driver is not ported to "
            "lldslam_tpu_torch yet; see ROADMAP queue 1 item 7b")
