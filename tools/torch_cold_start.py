"""First-call and warm times of the port's rare paths in a fresh process.

Usage (from the repository root; one card, or --device cpu to rehearse):

    python tools/torch_cold_start.py [--warmup] [--reps N] [--device D]

The process creates the CUDA context and its inputs, then (with
--warmup) calls `System.warmup()` on the System that chip_smoke.py's
pipelined_native_lines phase runs (KITTI camera, 2000 features, native
lines, loops on, the shipped vocabulary) and times it. Then it runs each
rare path once, in this order, and then N more rounds of all of them:

- local_ba: the windowed local BA of keyframe 23 of the seeded loop map
  (io.synthetic.make_loop_map, 24 keyframes, 512x384), LocalMapper's dense
  grid (`ba_view_cached`), read back;
- joint_local_ba: the same window with the loop map's 240 map lines
  (add_loop_lines): `joint_ba_view_cached`;
- sim3: `LoopCloser._compute_sim3(21, 2)` on the loop map: descriptor
  match, Sim3 RANSAC and refinement, guided matching through K2g;
- global_ba: `LoopCloser.global_ba()` on the loop map (points only);
- pose_graph and loop_lines_correct: the loop correction with map lines
  (`_correct(21, 2, S)`, S from a CPU `_compute_sim3`), whose first step,
  `optimize_pose_graph`, is timed inside it;
- reloc_frame: 28 frames of the corridor of tests/test_reloc.py (512x384,
  600 features, loops on), three blank frames, then a view of frame 4:
  the frame that relocalizes (each round blanks again and relocalizes);
- mono_bootstrap: the first two seed-3 KITTI-size left views through
  track_monocular; the frame that initializes (each round resets first).

Every time is host ms around the call with the card synchronised before
and after. Each round works on fresh copies of the maps, so every call
does the same work. The last line of the output is one JSON object: the
card's name and power limit, the warm-up's seconds, and per path every
reading (the first is the fresh process's first call), the first and the
median of the others.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

RELOC_FRAMES = 28
ORDER = ("local_ba", "joint_local_ba", "sim3", "global_ba", "pose_graph",
         "loop_lines_correct", "reloc_frame", "mono_bootstrap")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t), out


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class Paths:
    """The inputs of every rare path, built once; each path's method times
    one call on fresh copies."""

    def __init__(self, dev):
        import dataclasses
        from lldslam_tpu_torch.config import LineConfig
        from lldslam_tpu_torch.io.synthetic import (add_loop_lines,
                                                    corridor_poses,
                                                    make_loop_map,
                                                    make_points_world,
                                                    make_sequence,
                                                    render_points)
        from lldslam_tpu_torch.loop.closing import LoopCloser
        from lldslam_tpu_torch.slammap.map_store import MapStore
        from lldslam_tpu_torch.system import _default_vocabulary

        self.dev = dev
        self.voc = _default_vocabulary()
        self.cfg = cs.patch_world_config()
        self.cfg_lines = dataclasses.replace(self.cfg, line=LineConfig(
            ld_type="LBDFloat", md_thr=0.6))
        cam = self.cfg.camera.stereo_camera()
        self.points_map = MapStore(cam, self.cfg.orb, max_kf=64,
                                   max_pt=20000)
        make_loop_map(self.points_map)
        self.lines_map = MapStore(cam, self.cfg.orb, max_kf=64, max_pt=20000)
        add_loop_lines(self.lines_map, make_loop_map(self.lines_map))
        cpu = LoopCloser(copy.deepcopy(self.lines_map), self.voc,
                         self.cfg_lines, device="cpu")
        res = cpu._compute_sim3(21, 2)
        if res is None:
            raise AssertionError("no Sim3 between keyframes 21 and 2")
        self.S, self.guided = res[0], cpu._loop_guided
        pts, patches = make_points_world(np.random.default_rng(3))
        gt = corridor_poses(34)
        self.reloc_frames = [render_points(cam, gt[i], pts, patches)
                             for i in range(RELOC_FRAMES)]
        self.revisit = render_points(cam, gt[4], pts, patches)
        self.blank = np.full((cam.height, cam.width), 15.0, np.float32)
        self.mono_frames = [l for l, _ in make_sequence(
            cs.kitti_config().camera.stereo_camera(), 2, seed=3)]
        self._reloc_sys = None
        self._mono_sys = None
        self.states: dict[str, list] = {k: [] for k in ORDER}

    # -- the paths ------------------------------------------------------

    def _mapper(self, store, cfg):
        from lldslam_tpu_torch.pipeline.local_mapping import LocalMapper
        mp = LocalMapper(copy.deepcopy(store), cfg, device=self.dev)
        prep = mp._prepare_ba(23)
        if prep is None:
            raise AssertionError("the loop map's keyframe 23 has no BA")
        return mp, prep

    def _local(self, store, cfg, key):
        from lldslam_tpu_torch.ops.transfer import HostCopy
        mp, prep = self._mapper(store, cfg)
        ms, out = _timed(self.dev,
                         lambda: HostCopy(mp._launch_ba(prep)).result())
        self.states[key].append(bool(np.isfinite(out["poses"]).all()))
        return ms

    def local_ba(self):
        return self._local(self.points_map, self.cfg, "local_ba")

    def joint_local_ba(self):
        return self._local(self.lines_map, self.cfg_lines, "joint_local_ba")

    def _closer(self, store, cfg):
        from lldslam_tpu_torch.loop.closing import LoopCloser
        return LoopCloser(copy.deepcopy(store), self.voc, cfg,
                          device=self.dev)

    def sim3(self):
        lc = self._closer(self.points_map, self.cfg)
        ms, res = _timed(self.dev, lambda: lc._compute_sim3(21, 2))
        self.states["sim3"].append(res is not None)
        return ms

    def global_ba(self):
        lc = self._closer(self.points_map, self.cfg)
        ms, _ = _timed(self.dev, lc.global_ba)
        self.states["global_ba"].append(
            bool(np.isfinite(lc.store.kf_pose[:lc.store.n_kf]).all()))
        return ms

    def loop_lines_correct(self):
        """(pose graph ms, whole correction ms)."""
        from lldslam_tpu_torch.optim import pose_graph
        lc = self._closer(self.lines_map, self.cfg_lines)
        lc._loop_guided = copy.deepcopy(self.guided)
        pg_ms, solve = [], pose_graph.optimize_pose_graph

        def timed_pg(*a, **k):
            ms, out = _timed(self.dev, lambda: solve(*a, **k))
            pg_ms.append(ms)
            return out

        pose_graph.optimize_pose_graph = timed_pg
        try:
            ms, _ = _timed(self.dev, lambda: lc._correct(21, 2, self.S))
        finally:
            pose_graph.optimize_pose_graph = solve
        s = lc.store
        ok = bool(np.isfinite(s.kf_pose[:s.n_kf]).all()
                  and np.isfinite(s.ln_x0[:s.n_ln]).all())
        self.states["pose_graph"].append(len(pg_ms) == 1)
        self.states["loop_lines_correct"].append(ok)
        return pg_ms[0], ms

    def reloc_frame(self):
        from lldslam_tpu_torch.system import System
        if self._reloc_sys is None:
            s = System(self.cfg, device=self.dev)
            s.tracker.mapper.p_cap = 2048
            s.tracker.mapper.o_cap = 6144
            for i, (l, r) in enumerate(self.reloc_frames):
                s.track_stereo(l, r, timestamp=0.1 * i)
            self._reloc_sys, self._t = s, 0.1 * RELOC_FRAMES
        s = self._reloc_sys
        for _ in range(3):
            s.track_stereo(self.blank, self.blank, timestamp=self._t)
            self._t += 0.1
        lost = s.state.name
        ms, (_, m) = _timed(self.dev, lambda: s.track_stereo(
            *self.revisit, timestamp=self._t))
        self._t += 0.1
        self.states["reloc_frame"].append(
            lost == "LOST" and m.state == "OK" and m.reloc_kf >= 0)
        return ms

    def mono_bootstrap(self):
        from lldslam_tpu_torch.system import System
        if self._mono_sys is None:
            self._mono_sys = System(cs.kitti_config(), device=self.dev)
        s = self._mono_sys
        s.reset()
        s.track_monocular(self.mono_frames[0], timestamp=0.0)
        ms, (_, m) = _timed(self.dev, lambda: s.track_monocular(
            self.mono_frames[1], timestamp=0.1))
        self.states["mono_bootstrap"].append(m.state == "OK")
        return ms


def run(dev, warmup: bool, reps: int) -> dict:
    from lldslam_tpu_torch.system import System
    _timed(dev, lambda: torch.zeros(1, device=dev) + 1)   # the context
    t = time.perf_counter()
    paths = Paths(dev)
    setup_s = time.perf_counter() - t
    warm_s = None
    if warmup:
        import dataclasses
        from lldslam_tpu_torch.config import LineConfig
        sys_ = System(dataclasses.replace(cs.kitti_config(), line=LineConfig(
            ld_type="LBDFloat", md_thr=0.6)), pipeline=True, device=dev)
        t = time.perf_counter()
        sys_.warmup()
        _sync(dev)
        warm_s = time.perf_counter() - t
    ms = {k: [] for k in ORDER}
    for _ in range(1 + reps):
        for name in ORDER:
            if name == "pose_graph":
                continue
            if name == "loop_lines_correct":
                pg, whole = paths.loop_lines_correct()
                ms["pose_graph"].append(pg)
                ms[name].append(whole)
            else:
                ms[name].append(getattr(paths, name)())
    out = dict(device=str(dev), card=_card() if dev.type == "cuda" else None,
               warmup=warmup, warmup_s=warm_s, setup_s=setup_s, order=ORDER,
               paths={k: dict(ms=v, first=v[0],
                              warm_median=statistics.median(v[1:])
                              if len(v) > 1 else None,
                              ok=paths.states[k])
                      for k, v in ms.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", action="store_true")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = run(dev, a.warmup, a.reps)
    print(json.dumps(out), flush=True)
    bad = [k for k, v in out["paths"].items() if not all(v["ok"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
