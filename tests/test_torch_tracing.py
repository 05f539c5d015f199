"""The port's spans and counters (lldslam_tpu_torch/tracing.py).

The CPU tests run the 640x240 corridor of tests/test_torch_system.py (600
ORB features, 12 frames of seed 3, loops on with the shipped vocabulary)
through the pipelined System once, with `torch.profiler.record_function`
made to raise everywhere but in two calls traced by a CPU profiler session.
They check that every finalized frame's spans form a tree under its root
(hand-over to finalized pose), that the `t_*` fields equal their spans, that
the staged loop step's seconds land in its keyframe's `kf_timings` entry,
that host waits are counted where the host half waits, and that the
profiler's `op:` ranges carry the spans' names at the spans' times. The
pipelined multi-sequence driver's batched frames get `t_build` and `t_get`
from the same spans.

The card tests (marker `cuda`, skipped without a card) hold the
`host_waits` counter to CUDA's sync debug mode: over 30 pipelined frames
and over a loop event, every wait the mode warns of is counted, and the
counted event waits (which the mode does not see) make up the rest. The
frames are KITTI-size (the stream's camera; tracking stays OK) and the
640x240 corridor with points and with native lines, which loses its track
after frame 20 (the world, not the port: the parent tree loses it there
too) and so takes relocalization and the reset. They import no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_tracing.py
"""
import time
import warnings
from collections import Counter

import pytest
import torch

from lldslam_tpu_torch import tracing
from lldslam_tpu_torch.config import (CameraConfig, LineConfig, SlamConfig,
                                      TrackingConfig)
from lldslam_tpu_torch.io.synthetic import make_sequence
from lldslam_tpu_torch.ops.orb import OrbConfig
from lldslam_tpu_torch.ops.transfer import HostCopy
from lldslam_tpu_torch.pipeline.tracker import TrackMetrics
from lldslam_tpu_torch.system import System

N_FRAMES = 12
PROFILED = (8, 9)          # the calls traced by the CPU profiler session
CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)


def _cfg(lines: bool = False):
    return SlamConfig(camera=CameraConfig(**CAM),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80),
                      **(dict(line=LineConfig(ld_type="LBDFloat", md_thr=0.6))
                         if lines else {}))


def _kitti_cfg():
    """The KITTI 00-02 camera at 2000 features, as the stream cell runs."""
    return SlamConfig(camera=CameraConfig(fx=718.856, fy=718.856,
                                          cx=607.1928, cy=185.2157,
                                          bf=386.1448, fps=10.0, width=1241,
                                          height=376),
                      orb=OrbConfig(n_features=2000),
                      tracking=TrackingConfig(min_init_points=100))


def _raise(*a, **k):
    raise AssertionError("a profiler range was entered with no profiler")


@pytest.fixture(scope="module")
def run():
    """The pipelined corridor: record_function raises but in the profiled
    calls; returns the tracker, the profiler's events and the session's
    perf_counter_ns bounds."""
    from torch.profiler import ProfilerActivity, profile
    torch.set_num_threads(2)
    frames = make_sequence(_cfg().camera.stereo_camera(), N_FRAMES,
                           n_per_m=25.0, seed=3)
    s = System(_cfg(), pipeline=True, device="cpu")
    rf = torch.profiler.record_function
    unprofiled = 0
    with pytest.MonkeyPatch.context() as mp:
        for i, (l, r) in enumerate(frames):
            if i in PROFILED:
                mp.setattr(torch.profiler, "record_function", rf)
                if i == PROFILED[0]:
                    prof = profile(activities=[ProfilerActivity.CPU])
                    prof.__enter__()
                    t0 = time.perf_counter_ns()
                s.track_stereo(l, r, timestamp=0.1 * i)
                if i == PROFILED[-1]:
                    t1 = time.perf_counter_ns()
                    prof.__exit__(None, None, None)
            else:
                mp.setattr(torch.profiler, "record_function", _raise)
                s.track_stereo(l, r, timestamp=0.1 * i)
                unprofiled += 1
        s.flush()
    events = list(prof.profiler.kineto_results.events())
    return dict(tr=s.tracker, events=events, bounds=(t0, t1),
                unprofiled=unprofiled)


def _dur(sp) -> float:
    return (sp[2] - sp[1]) * 1e-9


def _named(m, name):
    return [sp for sp in m.spans if sp[0] == name]


def _check_tree(m, last_top: str | None):
    """m's spans: a closed `frame` root first, every other span closed
    inside its parent (an earlier span); the root ends after its last
    top-level span, which is `last_top` when given."""
    assert m.spans and m.spans[0][0] == tracing.ROOT, m.spans[:1]
    assert m.spans[0][3] == -1 and m.spans[0][2] >= m.spans[0][1] > 0
    for i, (name, a, b, p) in enumerate(m.spans[1:], start=1):
        assert 0 <= p < i, (name, p)
        _, pa, pb, _ = m.spans[p]
        assert pa <= a <= b <= pb, (name, m.spans[p][0])
    top = [sp for sp in m.spans if sp[3] == 0]
    assert top and max(sp[2] for sp in top) <= m.spans[0][2]
    if last_top is not None:
        assert max(top, key=lambda sp: sp[2])[0] == last_top


def test_every_finalized_frame_is_a_tree_under_its_root(run):
    tr = run["tr"]
    assert [m.frame_id for m in tr.metrics] == list(range(N_FRAMES))
    assert [m.state for m in tr.metrics] == ["OK"] * N_FRAMES
    for m in tr.metrics:
        # frame 0 initializes synchronously; every later frame takes the
        # chained step and is finalized in a later call
        pipelined = m.frame_id > 0
        _check_tree(m, "finalize" if pipelined else "track.sync")
        names = {sp[0] for sp in m.spans}
        assert {"build", "track.sync"} <= names or pipelined
        if pipelined:
            assert {"build", "dispatch", "finalize", "track.pose_lm",
                    "track.motion_match", "track.map_search", "track.tail",
                    "kf.stage"} <= names
            (d,) = _named(m, "dispatch")
            (f,) = _named(m, "finalize")
            assert d[2] <= f[1]        # dispatched before it is finalized
            assert len(_named(m, "track.pose_lm")) == 2
    assert tracing.current() is None


def test_the_timings_equal_their_spans(run):
    tr = run["tr"]
    for m in tr.metrics:
        (b,) = _named(m, "build")
        assert m.t_build == _dur(b)
        if m.frame_id > 0:
            (d,) = _named(m, "dispatch")
            assert m.t_dispatch == _dur(d)
        kf = _named(m, "kf.create")
        assert m.new_kf == bool(kf) or m.frame_id == 0
        assert m.t_kf == (_dur(kf[0]) if kf else 0.0)
    # windows: a frame holding a `copy.wait` span opens one; every frame of
    # a window has its share of that wait as t_get
    windows = []
    for m in tr.metrics[1:]:
        if _named(m, "copy.wait"):
            windows.append([m])
        else:
            windows[-1].append(m)
    assert len(windows) >= 3
    for w in windows:
        (c,) = _named(w[0], "copy.wait")
        assert all(m.t_get == _dur(c) / len(w) > 0 for m in w)


def test_the_staged_loop_step_lands_in_its_keyframe(run):
    tr = run["tr"]
    s = tr.store
    kfs = [m.frame_id for m in tr.metrics if m.new_kf and m.frame_id > 0]
    assert [k["fid"] for k in tr.kf_timings] == kfs and len(kfs) >= 2
    for k in tr.kf_timings:
        assert set(k) == {"kf", "fid", "mapper", "loop"}
        assert s.kf_frame_id[k["kf"]] == k["fid"]
        assert k["mapper"] > 0 and k["loop"] > 0
    # the loop step's spans sit under the staged keyframe work
    loops = [(m, sp) for m in tr.metrics for sp in _named(m, "loop.query")]
    assert len(loops) == len(kfs)
    for m, sp in loops:
        assert m.spans[sp[3]][0] == "kf.stage"


def test_host_waits_are_counted_in_the_host_half(run):
    tr = run["tr"]
    for m in tr.metrics[1:]:
        waits = m.counts.get("host_waits", 0)
        events = m.counts.get("event_waits", 0)
        # the window's copy and a keyframe stage's results are event waits
        assert events == (len(_named(m, "copy.wait"))
                          + len(_named(m, "mapper.triangulate")))
        # a keyframe's stage uploads its map points from pageable memory
        if _named(m, "kf.create"):
            assert waits - events >= 6
        else:
            assert waits == events
    assert sum(m.counts.get("host_waits", 0) for m in tr.metrics) > 0


def test_the_profiler_ranges_carry_the_spans(run):
    """Each span opened in the profiled calls has an `op:` range of its
    name, and its start on the profiler's clock lies within 1 ms of the
    range's."""
    t0, t1 = run["bounds"]
    ranges = {}
    for e in run["events"]:
        if e.name().startswith("op:"):
            ranges.setdefault(e.name()[3:], []).append(e.start_ns())
    spans = {}
    for m in run["tr"].metrics:
        for name, a, b, p in m.spans[1:]:
            if t0 <= a and b <= t1:
                spans.setdefault(name, []).append(a)
    assert {"build", "dispatch", "track.pose_lm", "finalize"} <= set(spans)
    assert set(spans) == set(ranges)
    worst = 0
    for name, starts in spans.items():
        got = sorted(ranges[name])
        assert len(got) == len(starts), name
        for a, r in zip(sorted(starts), got):
            worst = max(worst, abs(tracing.to_profiler_ns(a) - r))
    print(f"largest span-to-range offset {worst / 1e3:.1f} us")
    assert worst < 1_000_000


def test_without_a_profiler_no_range_is_entered(run, monkeypatch):
    """The run's unprofiled calls went through with record_function made
    to raise; so does a span of a record here."""
    assert run["unprofiled"] == N_FRAMES - len(PROFILED)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    m = TrackMetrics()
    with tracing.frame(m), tracing.span("x"), tracing.span("y"):
        pass
    assert [sp[0] for sp in m.spans] == ["frame", "x", "y"]


def test_spans_nest_and_the_record_is_restored():
    outer, inner = TrackMetrics(frame_id=1), TrackMetrics(frame_id=2)
    acc = {}
    with tracing.frame(outer):
        with tracing.span("a") as sa:
            with tracing.frame(inner), tracing.span("b", acc, "k"):
                tracing.count("host_waits", 2)
            tracing.count("host_waits")
        with tracing.span("c"):
            pass
        assert tracing.current() is outer
    assert tracing.current() is None
    assert [(sp[0], sp[3]) for sp in outer.spans] == [
        ("frame", -1), ("a", 0), ("c", 0)]
    assert [(sp[0], sp[3]) for sp in inner.spans] == [("frame", -1),
                                                      ("b", 0)]
    assert outer.counts == {"host_waits": 1}
    assert inner.counts == {"host_waits": 2}
    assert acc["k"] == _dur(inner.spans[1]) > 0
    assert sa.seconds == _dur(outer.spans[1])
    # the roots stay open until their frames end
    assert outer.spans[0][2] == 0
    tracing.end_frame(outer)
    assert outer.spans[0][2] >= outer.spans[2][2]


def test_without_a_record_only_the_sums_are_kept():
    acc = {}
    with tracing.span("a", acc):
        tracing.count("host_waits")
    with tracing.span("a", acc):
        pass
    assert tracing.current() is None and acc["a"] > 0
    copy = HostCopy({"x": torch.arange(3)})
    m = TrackMetrics()
    with tracing.frame(m):
        copy.result()
        copy.result()                  # read once, waited for once
    assert m.counts == {"host_waits": 1, "event_waits": 1}


def test_the_profiler_clock_anchor():
    a = time.perf_counter_ns()
    u = time.time_ns()
    assert abs(tracing.to_profiler_ns(a) - u) < 50_000_000


def test_batched_frames_get_their_build_and_wait_shares():
    """Two corridors through the pipelined multi-sequence driver: a batched
    frame's build and dispatch spans sit on its first member's record, each
    member has its share of them, and every frame of a copied window its
    share of the wait."""
    from lldslam_tpu_torch.parallel.multi_seq import (
        PipelinedMultiSequenceDriver)
    torch.set_num_threads(2)
    cam = _cfg().camera.stereo_camera()
    seqs = [make_sequence(cam, 8, n_per_m=25.0, seed=sd) for sd in (3, 4)]
    drv = PipelinedMultiSequenceDriver(_cfg(), 2, readback_window=2,
                                       device="cpu")
    for i in range(8):
        drv.process([seqs[0][i], seqs[1][i]], [0.1 * i, 0.1 * i])
    drv.flush()
    # a batched frame: the second member's record holds no build of its own
    pairs = [(a, b) for a, b in zip(*(tr.metrics for tr in drv.trackers))
             if b.t_dispatch > 0 and not _named(b, "build")]
    assert len(pairs) >= 4
    waits = 0.0
    for first, second in pairs:
        assert first.frame_id == second.frame_id
        for m in (first, second):
            _check_tree(m, "finalize")
            assert m.t_build > 0 and m.t_get > 0
        (b,) = _named(first, "build")
        (d,) = _named(first, "dispatch")
        assert first.t_build == second.t_build == _dur(b) / 2
        assert first.t_dispatch == second.t_dispatch == _dur(d) / 2
        assert not _named(second, "build") and not _named(second, "dispatch")
        waits += sum(_dur(c) for c in _named(first, "copy.wait"))
    assert waits == pytest.approx(sum(a.t_get + b.t_get for a, b in pairs),
                                  rel=1e-9)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA's sync debug mode runs only "
                    "on the card")
    return torch.device("cuda", 0)


def _records(tr) -> list:
    """Every frame record of a pipelined tracker, finalized or in flight."""
    return (tr.metrics + [r["m"] for r in tr._pending]
            + [r["m"] for recs, _ in tr._windows for r in recs])


def _counted(records) -> tuple[int, int]:
    return (sum(m.counts.get("host_waits", 0) for m in records),
            sum(m.counts.get("event_waits", 0) for m in records))


# what CUDA's sync debug mode says of each synchronizing operation
SYNC_WARNING = "called a synchronizing CUDA operation"


def _sync_warnings(fn) -> Counter:
    """fn() under sync debug mode "warn": the synchronizing operations it
    made, counted by the line that made them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return Counter(f"{w.filename}:{w.lineno}" for w in got
                   if SYNC_WARNING in str(w.message))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kitti_points", "points", "native_lines"])
def test_host_waits_match_sync_debug_mode(card, case):
    """30 pipelined frames of the corridor after 4 that initialize the
    map, staged ahead on the card: the host waits counted in the
    track_stereo calls are the waits sync debug mode warns of plus the
    counted event waits."""
    lines = case == "native_lines"
    cfg = _kitti_cfg() if case == "kitti_points" else _cfg(lines)
    frames = make_sequence(cfg.camera.stereo_camera(), 34,
                           **({} if case == "kitti_points" else
                              dict(n_per_m=25.0)),
                           seed=3, with_lines=lines)
    s = System(cfg, pipeline=True, device=card)
    for i in range(4):
        s.track_stereo(*frames[i], timestamp=0.1 * i)
    staged = [s.stage_stereo(*f) for f in frames[4:]]
    tr = s.tracker
    waits0, events0 = _counted(_records(tr))

    def calls():
        for i, pair in enumerate(staged):
            s.track_stereo(None, None, timestamp=0.1 * (i + 4),
                           pair_dev=pair)
    sites = _sync_warnings(calls)
    waits, events = _counted(_records(tr))
    waits, events = waits - waits0, events - events0
    n_kf = sum(m.new_kf for m in tr.metrics[4:])
    print(f"{case}: {waits} host waits in 30 frames ({events} event waits), "
          f"{n_kf} keyframes; warned {dict(sites)}")
    assert n_kf >= 3 and events >= 10
    if case == "kitti_points":
        assert [m.state for m in tr.metrics] == ["OK"] * len(tr.metrics)
    assert waits - events == sum(sites.values()), sites


@pytest.mark.cuda
def test_host_waits_of_a_loop_event_match_sync_debug_mode(card):
    """The synthetic loop map's event on the card (Sim3 verification of
    keyframe 21 against keyframe 2, guided matching, pose graph, remap,
    fusion, global BA) in one record."""
    from lldslam_tpu_torch.io.synthetic import make_loop_map
    from lldslam_tpu_torch.loop.closing import LoopCloser
    from lldslam_tpu_torch.slammap.map_store import MapStore
    from lldslam_tpu_torch.system import _default_vocabulary
    cfg = SlamConfig(camera=CameraConfig(fx=400.0, fy=400.0, cx=256.0,
                                         cy=192.0, bf=200.0, width=512,
                                         height=384),
                     orb=OrbConfig(n_features=600))
    store = MapStore(cfg.camera.stereo_camera(), cfg.orb, max_kf=64,
                     max_pt=20000)
    make_loop_map(store)
    lc = LoopCloser(store, _default_vocabulary(), cfg, device=card)
    m = TrackMetrics()
    out = []

    def event():
        with tracing.frame(m):
            out.append(lc._event(21, 2))
    sites = _sync_warnings(event)
    waits, events = _counted([m])
    print(f"loop event: {waits} host waits ({events} event waits); warned "
          f"{dict(sites)}")
    assert out == [True]
    assert waits - events == sum(sites.values()) > 0, sites
