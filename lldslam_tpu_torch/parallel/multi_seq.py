"""Batched multi-sequence tracking: S stereo sequences on one card, each
frame's build and tracking step shared.

Counterpart of lldslam_tpu/parallel/multi_seq.py (`MultiSequenceDriver`,
`batched_build_frame`, `batched_track_step`, and the pipelined
`PipelinedMultiSequenceDriver`, `batched_chained_step`). The JAX driver
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

`PipelinedMultiSequenceDriver` batches the pipelined tracker's schedule:
the members' device chain state (pose, velocity, last frame, provisional
ids, decision counters) is stacked, each frame runs one batched build and
one batched `_track_step_chained` (K1a, K1b and K2g at the tracking site
once each), and every `readback_window` frames one non-blocking copy moves
the window's results to the host; the window before it is then finalized,
sequence by sequence, through each tracker's `_finalize_rec` (keyframes,
staged mapping, provisional ids). A sequence that leaves state OK (or
ends) changes the membership: the batch is flushed, the members that stay
take back the last dispatched chain state, and the rest continue on their
own pipelined trackers until they are healthy again (a member that
continues alone reseeds its own chain: the JAX driver leaves it the one it
had before the batch). As in the tracker, no step of the schedule depends
on timing (the JAX driver finalizes a window whenever its fetch has
landed).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..config import SlamConfig
from ..frontend import matching
from ..frontend.frame import build_frame_batch
from ..ops.transfer import HostCopy
from ..pipeline import tracker as trk
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
            trs = [self.trackers[i] for i in batch]
            ms = []
            for tr in trs:
                tr.frame_id += 1
                ms.append(TrackMetrics(frame_id=tr.frame_id))
                tracing.start(ms[-1])
            # the batched build and step on the first member's record
            with tracing.frame(ms[0]):
                with tracing.span("build") as sb:
                    stack = _pair_stack([pairs[i] for i in batch])
                    fdb = build_frame_batch(
                        torch.from_numpy(stack).to(self.device), self.cam,
                        self.cfg.orb)
                fds = [fdb.seq(b) for b in range(len(trs))]
                T_preds = [tr._predict_pose(fd) for tr, fd in zip(trs, fds)]
                with tracing.span("dispatch") as sd:
                    outs = StereoTracker._step_batch(trs, fdb.feats,
                                                     fdb.depth, T_preds)
            for i, tr, fd, m, (host, step) in zip(batch, trs, fds, ms, outs):
                m.t_build = sb.seconds / len(batch)
                m.t_dispatch = sd.seconds / len(batch)
                with tracing.frame(m):
                    with tracing.span("finalize"):
                        tr._track_finalize(fd, host, step, timestamps[i], m,
                                           tr.frame_id)
                        tr._finish_metrics(m)
                    tracing.end_frame(m)
                results[i] = (tr.T_cw.copy(), m)
        for i in solo:
            results[i] = self.trackers[i].process(pairs[i][0], pairs[i][1],
                                                  timestamps[i])
        return results

    def trajectories(self) -> list:
        """Per sequence, (timestamps, T_wc stack)."""
        return [tr.trajectory() for tr in self.trackers]


def _stack_tuples(rows):
    """Stack a list of NamedTuples of tensors field by field."""
    return type(rows[0])(*map(torch.stack, zip(*rows)))


def _put(a: torch.Tensor, i: int, r: torch.Tensor) -> torch.Tensor:
    """A copy of `a` with row i replaced (never in place: queued steps may
    still read the old tensor)."""
    a = a.clone()
    a[i] = r
    return a


def _pair_stack(pairs: list) -> np.ndarray:
    """(S, 2, H, W) of S (left, right) pairs, uint8 when the values fit."""
    stack = np.stack([np.stack(p) for p in pairs])
    if stack.dtype != np.uint8 and stack.max(initial=0.0) <= 255.0:
        stack = stack.astype(np.uint8)
    return stack


class PipelinedMultiSequenceDriver(MultiSequenceDriver):
    """The pipelined tracker's schedule for S sequences at once (module
    docstring)."""

    def __init__(self, cfg: SlamConfig, n_seq: int, enable_loops: bool = False,
                 view_cap: int = 2048, readback_window: int = 4,
                 device="cuda"):
        self.cfg = cfg
        self.n_seq = n_seq
        self.device = torch.device(device)
        self.cam = cfg.camera.stereo_camera()
        self.W = max(1, readback_window)
        self.trackers = []
        for _ in range(n_seq):
            tr = StereoTracker(cfg, enable_loops=enable_loops, pipeline=True,
                               device=device)
            tr.mapper.fixed_tv_cap = view_cap
            self.trackers.append(tr)
        self._members: list[int] = []
        self._stk = None            # stacked chain state
        self._pending: list[dict] = []
        self._inflight = None       # (records, HostCopy) of the last window
        self.n_rebuilds = 0

    # -- batch membership ------------------------------------------------

    def _batchable(self, live: list[int]) -> list[int]:
        return [i for i in live if self.trackers[i].state == TrackState.OK
                and not self.trackers[i].enable_lines
                and not self.trackers[i]._resync]

    def _flush_batch(self, keep=()):
        """Finalize every batched frame in flight. Members in `keep` stay
        batch-eligible and take back the last dispatched chain state (their
        own last-frame fields are written only on the weak and resync
        paths), unless a weak frame already resynced them; the others
        reseed their own chains."""
        self._absorb()
        if self._pending:
            recs, self._pending = self._pending, []
            self._finalize_window(recs, HostCopy([r["host"] for r in recs]))
        stk = self._stk
        if stk is not None:
            for b, i in enumerate(self._members):
                tr = self.trackers[i]
                if i in keep and not tr._resync:
                    tr._last_feats = matching.FrameFeatures(
                        *(a[b] for a in stk["last_feats"]))
                    for k in ("ptpos", "haspt", "ismap", "prov"):
                        setattr(tr, "_last_" + k, stk["last_" + k][b])
                elif i not in keep:
                    tr._resync = True
        self._stk = None
        self._members = []
        self.n_rebuilds += 1

    def _build_stack(self, members: list[int]):
        trs = [self.trackers[i] for i in members]
        for tr in trs:
            tr.flush()
            # the stack carries the chain from here: a member that later
            # runs alone reseeds its own from its finalized state
            tr._chain = None
        t = trs[0]._t
        self._stk = dict(
            T=t(np.stack([tr.T_cw for tr in trs])),
            vel=t(np.stack([tr.velocity for tr in trs])),
            since=t(np.array([max(0, tr.frame_id - tr.last_kf_frame)
                              for tr in trs], np.int32)),
            scal=t(np.stack([np.float32([tr._ref_matches, tr._kappa])
                             for tr in trs])),
            last_feats=_stack_tuples([tr._last_feats for tr in trs]),
            last_ptpos=torch.stack([tr._last_ptpos for tr in trs]),
            last_haspt=torch.stack([tr._last_haspt for tr in trs]),
            last_ismap=torch.stack([tr._last_ismap for tr in trs]),
            last_prov=torch.stack([tr._last_prov for tr in trs]),
            view=_stack_tuples([tr._view for tr in trs]))
        self._view_ids = [id(tr._view) for tr in trs]
        self._members = list(members)

    # -- per frame -------------------------------------------------------

    def process(self, pairs: list, timestamps: list[float],
                pair_devs: list | None = None) -> list:
        """Track one frame of every sequence. pairs: S (left, right) image
        pairs, or pair_devs: S pairs staged on the device (None skips an
        ended sequence). Returns per sequence (T_cw, metrics) of the last
        frame it finalized in this call, (None, None) for a batched frame
        (finalized a window later), None for a skipped one."""
        S = self.n_seq
        given = pair_devs if pair_devs is not None else pairs
        live = [i for i in range(S) if given[i] is not None]
        batchable = self._batchable(live)
        if batchable != self._members:
            self._flush_batch(keep=set(batchable))
            batchable = self._batchable(live)   # a finalize may demote
            if len(batchable) >= 2:
                self._build_stack(batchable)
        results: list = [None] * S
        if self._members:
            self._step(pairs, timestamps, pair_devs, results)
        for i in live:
            if i not in self._members:
                tr = self.trackers[i]
                if pair_devs is not None:
                    results[i] = tr.process(None, None, timestamps[i],
                                            pair_dev=pair_devs[i])
                else:
                    results[i] = tr.process(*pairs[i], timestamps[i])
        return results

    def _step(self, pairs, timestamps, pair_devs, results):
        members, stk = self._members, self._stk
        trs = [self.trackers[i] for i in members]
        # each member's frame is handed over here; the batched build and
        # step are recorded on the first member's record
        ms = [TrackMetrics(frame_id=tr.frame_id + 1) for tr in trs]
        for m in ms:
            tracing.start(m)
        with tracing.frame(ms[0]):
            with tracing.span("build") as sb:
                if pair_devs is not None:
                    stack = torch.stack([pair_devs[i] for i in members])
                else:
                    stack = trs[0]._t(_pair_stack([pairs[i]
                                                   for i in members]))
                fdb = build_frame_batch(stack, self.cam, self.cfg.orb)
            with tracing.span("dispatch") as sd:
                out = self._dispatch(trs, stk, fdb)
                host = {k: out[k] for k in trk._HOST_KEYS}
                host.update(trk._snapshot_fields(fdb))
        for m in ms:
            m.t_build = sb.seconds / len(ms)
            m.t_dispatch = sd.seconds / len(ms)
        prev = {k: stk[k] for k in ("last_feats", "last_ptpos", "last_haspt",
                                    "last_ismap", "last_prov")}
        for k in ("T", "vel", "since", "scal"):
            stk[k] = out[k]
        stk["last_feats"] = fdb.feats
        for k in ("ptpos", "haspt", "ismap", "prov"):
            stk["last_" + k] = out[k]
        rec = dict(members=list(members), fdb=fdb, prev=prev, host=host,
                   ts=[timestamps[i] for i in members],
                   view_pids=[tr._view_pid for tr in trs], ms=ms)
        for tr in trs:
            tr.frame_id += 1
        self._pending.append(rec)
        for i in members:
            results[i] = (None, None)
        if len(self._pending) >= self.W:
            recs, self._pending = self._pending, []
            self._absorb()
            self._inflight = (recs, HostCopy([r["host"] for r in recs]))

    def _dispatch(self, trs: list, stk: dict, fdb) -> dict:
        """The members' post-BA views and reference counts taken into the
        stack, then the batched chained step."""
        # per-tracker updates since the last frame: post-BA views and the
        # last keyframe's reference count
        for b, tr in enumerate(trs):
            tr._adopt_view()
            if id(tr._view) != self._view_ids[b]:
                stk["view"] = type(tr._view)(*(
                    _put(a, b, r) for a, r in zip(stk["view"], tr._view)))
                self._view_ids[b] = id(tr._view)
            if tr._refm_host is not None:
                stk["scal"] = _put(stk["scal"], b, tr._adopted_scal(
                    stk["since"][b], stk["scal"][b], tr.frame_id + 1))
        cfgT, tr0 = self.cfg.tracking, trs[0]
        return trk._track_step_chained(
            self.cam, stk["T"], stk["vel"], stk["last_feats"],
            stk["last_ptpos"], stk["last_haspt"], fdb.feats, fdb.depth,
            stk["view"], tr0._inv_sigma2_lut, stk["last_ismap"],
            stk["last_prov"], stk["since"], stk["scal"], tr0.orb.n_levels,
            tr0.orb.scale, cfgT.min_motion_matches,
            float(self.cfg.close_depth),
            max(cfgT.min_frames_between_kf, 3), cfgT.max_frames_between_kf)

    # -- window finalize -------------------------------------------------

    def _absorb(self):
        if self._inflight is not None:
            recs, copy = self._inflight
            self._inflight = None
            self._finalize_window(recs, copy)

    def _finalize_window(self, recs: list[dict], copy: HostCopy):
        """Each frame of the window, each sequence in turn, through its
        tracker's `_finalize_rec`; the frame and rollback slices of the
        batch are taken only where a path reads them."""
        hosts = trk._copy_wait(copy, [m for r in recs for m in r["ms"]])
        for rec, h in zip(recs, hosts):
            for b, i in enumerate(rec["members"]):
                m = rec["ms"][b]
                srec = dict(
                    fd=lambda b=b, fdb=rec["fdb"]: fdb.seq(b),
                    prev=lambda b=b, p=rec["prev"]: (
                        matching.FrameFeatures(
                            *(a[b] for a in p["last_feats"])),
                        p["last_ptpos"][b], p["last_haspt"][b],
                        p["last_ismap"][b], p["last_prov"][b]),
                    host={k: v[b] for k, v in h.items()}, m=m,
                    ts=rec["ts"][b], fid=m.frame_id,
                    view_pid=rec["view_pids"][b])
                self.trackers[i]._finalize_rec(srec)

    def flush(self):
        """Finalize every frame in flight, batched and solo."""
        self._flush_batch()
        for tr in self.trackers:
            tr.flush()
