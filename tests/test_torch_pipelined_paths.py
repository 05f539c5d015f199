"""The port's pipelined paths beyond plain tracking, on the CPU: two runs
bit-equal, recovery from a blackout and from a reset right after
initialization, the pipelined
line path (chained line step, staged line retriangulation) against the
synchronous one, and the staged loop step (BoW words from the device,
`finish_keyframe`) against the loop closer's `process_keyframe`.

Frames come from io.synthetic (the port's copy of bench.py's generator) at
the 640x240 / 600-feature camera of tests/test_torch_system.py. The
pipelined runs are held as the JAX package holds its own
(tests/test_pipelined.py, tests/test_lines_e2e.py): every frame finalized
once and in order, tracking recovered, and with lines the camera centres
within 0.25 m of the synchronous run, map lines created and lines
matched.
"""
from pathlib import Path
import sys

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lldslam_tpu_torch.config import (CameraConfig, LineConfig,  # noqa: E402
                                      SlamConfig, TrackingConfig)
from lldslam_tpu_torch.io import synthetic  # noqa: E402
from lldslam_tpu_torch.loop.closing import LoopCloser  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.slammap.map_store import MapStore  # noqa: E402
from lldslam_tpu_torch.system import System, _default_vocabulary  # noqa: E402

torch.set_num_threads(2)

CAM_CFG = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
               width=640, height=240)
RING = dict(fx=400.0, fy=400.0, cx=256.0, cy=192.0, bf=200.0, fps=10.0,
            width=512, height=384)


def _cfg(line=None, cam=CAM_CFG):
    return SlamConfig(camera=CameraConfig(**cam),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80),
                      **({} if line is None else dict(line=line)))


@pytest.fixture(scope="module")
def corridor():
    return synthetic.make_sequence(_cfg().camera.stereo_camera(), 12,
                                   n_per_m=25.0, seed=3)


def _pipelined(frames):
    s = System(_cfg(), enable_loops=False, pipeline=True, device="cpu")
    for i, (l, r) in enumerate(frames):
        T, _ = s.track_stereo(l, r, timestamp=i * 0.1)
        assert np.isfinite(T).all()
    s.flush()
    return s


def test_pipelined_runs_are_bit_equal(corridor):
    """Two pipelined runs of the same frames: every pose, keyframe and map
    point bit-equal (the schedule depends on nothing but the frames)."""
    a, b = _pipelined(corridor), _pipelined(corridor)
    assert np.array_equal(a.tracker.trajectory()[1], b.tracker.trajectory()[1])
    n, k = a.map.n_pt, a.map.n_kf
    assert (b.map.n_pt, b.map.n_kf) == (n, k) and k >= 4
    assert np.array_equal(a.map.pt_pos[:n], b.map.pt_pos[:n])
    assert np.array_equal(a.map.kf_pose[:k], b.map.kf_pose[:k])


@pytest.mark.parametrize("case", ["blackout", "reset_after_init"])
def test_pipelined_recovers(corridor, case):
    """tests/test_pipelined.py's two failure schedules through the port: a
    black frame mid-sequence drops to LOST on the resync path and tracking
    recovers; black frames right after initialization trigger the full
    reset while frames are in flight, the next good frame reinitializes a
    fresh map, and every frame is finalized once, in order."""
    blk = np.zeros_like(corridor[0][0])
    seq = (corridor[:8] + [(blk, blk)] + corridor[8:]
           if case == "blackout"
           else corridor[:2] + [(blk, blk)] * 3 + corridor[2:8])
    s = _pipelined(seq)
    ms = s.tracker.metrics
    assert [m.frame_id for m in ms] == list(range(len(seq)))
    states = [m.state for m in ms]
    assert states[-1] == "OK"
    if case == "blackout":
        assert states[8] == "LOST"
    else:
        assert "LOST" in states[:6]
        assert s.map.n_kf >= 1 and s.map.kf_frame_id[0] >= 2


def test_pipelined_lines_match_sync(tmp_path):
    """The stored-line corridor (12 seed-3 frames, ldType LBDFloat, mdThr
    0.6) synchronous and pipelined, the pipelined frames staged with
    stage_stereo and passed as pair_dev: camera centres within 0.25 m, the
    same keyframes, every frame OK, map lines made, >= 5 line matches, and
    the staged line solves all written back by the flush."""
    cam = _cfg().camera.stereo_camera()
    frames, poses, world = synthetic.make_sequence(
        cam, 12, seed=3, with_lines=True, return_poses=True)
    synthetic.gen_stored_lines(cam, poses, world, tmp_path / "l",
                               tmp_path / "r")
    cfg = _cfg(LineConfig(ld_type="LBDFloat", md_thr=0.6,
                          detections_path=str(tmp_path / "l"),
                          descriptors_path=str(tmp_path / "r")))
    sync = System(cfg, enable_loops=False, device="cpu")
    for i, (l, r) in enumerate(frames):
        sync.track_stereo(l, r, timestamp=i * 0.1)
    pipe = System(cfg, enable_loops=False, pipeline=True, device="cpu")
    staged = [pipe.stage_stereo(l, r) for l, r in frames]
    for i, h in enumerate(staged):
        pipe.track_stereo(None, None, timestamp=i * 0.1, pair_dev=h)
    pipe.flush()
    _, T_s = sync.tracker.trajectory()
    _, T_p = pipe.tracker.trajectory()
    dp = np.linalg.norm(T_p[:, :3, 3] - T_s[:, :3, 3], axis=-1)
    ms = pipe.tracker.metrics
    n_line = [m.n_line_matches for m in ms]
    kf = lambda s: [m.frame_id for m in s.tracker.metrics if m.new_kf]
    print(f"max centre diff {dp.max():.4f} m; line matches {n_line}; "
          f"map lines {pipe.map.n_ln}")
    assert len(T_p) == 12 and dp.max() < 0.25, dp.max()
    assert kf(pipe) == kf(sync)
    assert [m.state for m in ms] == ["OK"] * 12
    assert pipe.map.n_ln > 0 and sum(n_line) >= 5
    assert pipe.map.staged_retriangulation and not pipe.map._pending_retri


def test_staged_retriangulation_lags_then_matches():
    """MapStore.retriangulate_lines staged, as the JAX package stages it: a
    solve queued at one keyframe is written back at the second keyframe
    after it (absorb with keep=1 first), and then equals the synchronous
    path's immediate write-back; the flush writes back the rest."""
    stores = [MapStore(CameraConfig(**RING).stereo_camera(),
                       OrbConfig(n_features=600), max_kf=64, max_pt=20000)
              for _ in range(2)]
    for st in stores:
        synthetic.add_loop_lines(st, synthetic.make_loop_map(st))
    now, staged = stores
    staged.staged_retriangulation = True
    n = now.n_ln
    x0 = staged.ln_x0[:n].copy()
    now.retriangulate_lines(device="cpu")
    for k in range(2):
        staged.retriangulate_lines(device="cpu")
        assert np.array_equal(staged.ln_x0[:n], x0)
        assert len(staged._pending_retri) == k + 1
    staged.retriangulate_lines(device="cpu")
    assert len(staged._pending_retri) == 2
    moved = np.linalg.norm(staged.ln_x0[:n] - x0, axis=-1) > 1e-6
    assert moved.sum() > 10
    assert np.array_equal(staged.ln_x0[:n], now.ln_x0[:n])
    assert np.array_equal(staged.ln_dir[:n], now.ln_dir[:n])
    staged.absorb_retriangulate()
    assert not staged._pending_retri


def test_staged_loop_step_matches_process_keyframe():
    """The drifting 24-keyframe circle of io.synthetic.make_loop_map
    through two loop closers with the shipped vocabulary: one by
    process_keyframe, one by finish_keyframe on the words of dispatch_bow
    (the staged path's descent on the device descriptors). The same return
    value at every keyframe, the loop found, the same corrected poses and
    the same database."""
    voc = _default_vocabulary()
    cfg = _cfg(cam=RING)
    closers = []
    for _ in range(2):
        st = MapStore(cfg.camera.stereo_camera(), cfg.orb, max_kf=64,
                      max_pt=20000)
        synthetic.make_loop_map(st)
        closers.append(LoopCloser(st, voc, cfg, device="cpu"))
    a, b = closers
    got = []
    for k in range(a.store.n_kf):
        words = b.dispatch_bow(torch.from_numpy(
            b.store.kf_desc[k].view(np.int32)),
            torch.from_numpy(b.store.kf_kp_valid[k]))
        assert words.dtype == torch.int32
        assert np.array_equal(words.numpy(), b.voc.transform_words(
            b.store.kf_desc[k], b.store.kf_kp_valid[k]))
        got.append((a.process_keyframe(k), b.finish_keyframe(k, words.numpy())))
    assert [x for x, _ in got] == [y for _, y in got]
    assert any(x for x, _ in got) and len(a.events) == len(b.events) >= 1
    assert [(e.query_kf, e.matched_kf) for e in a.events] == \
        [(e.query_kf, e.matched_kf) for e in b.events]
    K = a.store.n_kf
    assert np.array_equal(a.store.kf_pose[:K], b.store.kf_pose[:K])
    assert a.db.kf_words.keys() == b.db.kf_words.keys()
    assert b.stage_times["n_words_staged"] == K
