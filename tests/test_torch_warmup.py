"""The port's warm-ups of the rare paths, on the CPU.

`loop.closing.warmup_loop_programs` (Sim3 RANSAC and refinement on dummy
inputs at the JAX package's shape),
`LoopCloser.warmup`, `LocalMapper.warmup` (keyframe stage, local BA or the
joint point+line BA, a BoW descent) and `System.warmup` run eagerly on
dummy inputs and leave no trace: the map store, the keyframe cache, the
mapper's and loop closer's state and every random generator (torch's and
numpy's global ones, the tracker's relocalization generator, the loop
closer's RANSAC generator) are as they were, and a warmed System tracks the
12-frame corridor of tests/test_torch_system.py to poses bit-equal to those
of a System that did not warm up.
"""
from pathlib import Path
import copy
import sys

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lldslam_tpu_torch.config import (CameraConfig, LineConfig,  # noqa: E402
                                      SlamConfig, TrackingConfig)
from lldslam_tpu_torch.io import synthetic  # noqa: E402
from lldslam_tpu_torch.loop import closing  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.slammap.map_store import MapStore  # noqa: E402
from lldslam_tpu_torch.system import System, _default_vocabulary  # noqa: E402

torch.set_num_threads(2)

CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)
RING = dict(fx=400.0, fy=400.0, cx=256.0, cy=192.0, bf=200.0, fps=10.0,
            width=512, height=384)


def _cfg(line=None, cam=CAM):
    return SlamConfig(camera=CameraConfig(**cam),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80),
                      **({} if line is None else dict(line=line)))


def _state(obj) -> dict:
    """A deep copy of an object's attributes: numpy arrays, tensors,
    containers and scalars (callables and nested objects by identity)."""
    out = {}
    for k, v in vars(obj).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.clone()
        elif isinstance(v, (np.ndarray, dict, list, tuple, set, int, float,
                            bool, str, type(None))):
            out[k] = copy.deepcopy(v)
        else:
            out[k] = id(v)
    return out


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _assert_untouched(before: dict, obj, label: str):
    after = _state(obj)
    moved = [k for k in before if not _same(before[k], after.get(k))]
    assert not moved and before.keys() == after.keys(), (label, moved)


def _generators():
    return (torch.random.get_rng_state(), np.random.get_state()[1].copy())


def _loop_store():
    store = MapStore(CameraConfig(**RING).stereo_camera(),
                     OrbConfig(n_features=600), max_kf=64, max_pt=20000)
    synthetic.make_loop_map(store)
    return store


def test_warmup_loop_programs_leaves_no_trace():
    """Sim3 RANSAC and refinement on dummy inputs, on the CPU: the global
    generators do not move; a second call runs too."""
    cam = CameraConfig(**CAM).stereo_camera()
    g0 = _generators()
    closing.warmup_loop_programs(cam, "cpu")
    closing.warmup_loop_programs(cam, torch.device("cpu"))
    g1 = _generators()
    assert torch.equal(g0[0], g1[0]) and np.array_equal(g0[1], g1[1])


def test_loop_closer_warmup_leaves_no_trace():
    """LoopCloser.warmup on the drifting loop map: the store, the closer's
    database and state, and its RANSAC generator are as they were, and the
    loop correction afterwards finds the same Sim3 as an unwarmed closer."""
    voc = _default_vocabulary()
    cfg = _cfg(cam=RING)
    stores = [_loop_store() for _ in range(2)]
    warm, cold = (closing.LoopCloser(st, voc, cfg, device="cpu")
                  for st in stores)
    st_before, lc_before = _state(warm.store), _state(warm)
    gen_before = warm._gen.get_state()
    warm.warmup()
    _assert_untouched(st_before, warm.store, "store")
    _assert_untouched(lc_before, warm, "loop closer")
    assert torch.equal(gen_before, warm._gen.get_state())
    a, b = warm._compute_sim3(21, 2), cold._compute_sim3(21, 2)
    assert a is not None and b is not None
    assert all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a[0], b[0])) and a[1] == b[1]


@pytest.mark.parametrize("lines", [False, True], ids=["points", "lines"])
def test_local_mapper_warmup_leaves_no_trace(lines):
    """LocalMapper.warmup (with the vocabulary's BoW descent; with lines
    on, the joint point+line BA) on a System's mapper after the corridor's
    first frames: the store, the keyframe cache and the mapper's state are
    as they were."""
    line = LineConfig(ld_type="LBDFloat", md_thr=0.6) if lines else None
    s = System(_cfg(line), enable_loops=False, device="cpu")
    frames = synthetic.make_sequence(s.cfg.camera.stereo_camera(), 4,
                                     n_per_m=25.0, seed=3, with_lines=lines)
    for i, (l, r) in enumerate(frames):
        s.track_stereo(l, r, timestamp=0.1 * i)
    mp = s.tracker.mapper
    assert mp.enable_lines == lines and s.map.n_kf >= 1
    before = dict(store=_state(s.map), mapper=_state(mp),
                  cache=_state(mp.cache))
    cache = [a.clone() for a in mp.cache.arrays]
    g0 = _generators()
    mp.warmup(voc=_default_vocabulary())
    _assert_untouched(before["store"], s.map, "store")
    _assert_untouched(before["mapper"], mp, "mapper")
    _assert_untouched(before["cache"], mp.cache, "cache")
    assert all(torch.equal(a, b) for a, b in zip(cache, mp.cache.arrays))
    g1 = _generators()
    assert torch.equal(g0[0], g1[0]) and np.array_equal(g0[1], g1[1])


def test_warmed_system_tracks_bit_equal():
    """System.warmup (loops on, the shipped vocabulary) before the first
    frame: the map store, the tracker's relocalization generator, the loop
    closer's generator and the global generators stay as they were, and
    the 12-frame corridor tracks to poses, keyframes and map points
    bit-equal to those of a System that did not warm up."""
    frames = synthetic.make_sequence(CameraConfig(**CAM).stereo_camera(), 12,
                                     n_per_m=25.0, seed=3)
    warm, cold = System(_cfg(), device="cpu"), System(_cfg(), device="cpu")
    tr = warm.tracker
    before = _state(warm.map)
    gens = (tr._reloc_gen.get_state(), tr.loop_closer._gen.get_state(),
            *_generators())
    warm.warmup()
    _assert_untouched(before, warm.map, "store")
    after = (tr._reloc_gen.get_state(), tr.loop_closer._gen.get_state(),
             *_generators())
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor)
               else np.array_equal(a, b) for a, b in zip(gens, after))
    for s in (warm, cold):
        for i, (l, r) in enumerate(frames):
            s.track_stereo(l, r, timestamp=0.1 * i)
    (_, Tw), (_, Tc) = warm.tracker.trajectory(), cold.tracker.trajectory()
    assert len(Tw) == 12 and np.array_equal(Tw, Tc)
    kf = lambda s: [m.frame_id for m in s.tracker.metrics if m.new_kf]
    assert kf(warm) == kf(cold) and len(kf(warm)) >= 3
    n = warm.map.n_pt
    assert cold.map.n_pt == n
    assert np.array_equal(warm.map.pt_pos[:n], cold.map.pt_pos[:n])


def test_warmup_mono_programs_leaves_no_trace():
    """The monocular bootstrap's match and H/F initializer on dummy inputs,
    on the CPU: the global generators do not move; a second call runs
    too."""
    from lldslam_tpu_torch.pipeline.tracker import warmup_mono_programs
    cam = CameraConfig(**CAM).stereo_camera()
    g0 = _generators()
    warmup_mono_programs(cam, 600, "cpu")
    warmup_mono_programs(cam, 600, torch.device("cpu"))
    g1 = _generators()
    assert torch.equal(g0[0], g1[0]) and np.array_equal(g0[1], g1[1])


def test_warmed_system_bootstraps_mono_bit_equal():
    """System.warmup before a monocular bootstrap: the tracker's
    relocalization generator (the bootstrap's hypothesis draw) stays as it
    was, and the corridor's left views bootstrap and track to poses and map
    points bit-equal to those of a System that did not warm up."""
    frames = synthetic.make_sequence(CameraConfig(**CAM).stereo_camera(), 5,
                                     n_per_m=25.0, seed=3)
    warm, cold = (System(_cfg(), enable_loops=False, device="cpu")
                  for _ in range(2))
    gen = warm.tracker._reloc_gen.get_state()
    warm.warmup()
    assert torch.equal(gen, warm.tracker._reloc_gen.get_state())
    states = []
    for s in (warm, cold):
        states.append([s.track_monocular(l, timestamp=0.1 * i)[1].state
                       for i, (l, _) in enumerate(frames)])
    assert states[0] == states[1] and "OK" in states[0], states
    (_, Tw), (_, Tc) = warm.tracker.trajectory(), cold.tracker.trajectory()
    assert len(Tw) >= 2 and np.array_equal(Tw, Tc)
    n = warm.map.n_pt
    assert n > 0 and cold.map.n_pt == n
    assert np.array_equal(warm.map.pt_pos[:n], cold.map.pt_pos[:n])
