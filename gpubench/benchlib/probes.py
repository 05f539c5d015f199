"""What the benchmark attaches to the program, from its own files.

Nothing in the program is edited: the benchmark replaces module and class
attributes with wrappers at set-up.

- `Captures` wraps the three kernel ops (K1a `ops.orb_describe.describe`,
  K1b `ops.stereo_sad.sad_refine`, K2g `ops.match_best2.gated_best2`), the
  tracking step's core (`pipeline.tracker._track_core`, for its point pose
  LM), the chained step with lines (`_track_step_chained_lines`, for its
  joint point+line pose LM), the windowed local BA
  (`pipeline.mapper_fast.ba_view_cached` and `joint_ba_view_cached`), the
  pose a pipelined frame's host half hands back
  (`StereoTracker._finalize_rec`) and the stereo line matcher. While
  armed, it keeps copies of the inputs and outputs of a sample of the
  window's calls of each (`checked` calls of a kind, drawn from the seed over
  the whole window: a reservoir sample, so every call of the window is as
  likely to be checked), with the frames they belong to, for the check;
  in a traced window it keeps every kernel call's, for the rooflines. A
  kept input is a copy made on the device: the window makes no host sync
  for it.
- `Layers` wraps each layer's entry functions, listed in one file a layer
  under `layers/` (`{"name": ..., "entries": ["module:attribute", ...]}`),
  in a `torch.profiler.record_function` range named after the layer, and
  sums their host seconds (only in a `--trace 1` run).
"""
from __future__ import annotations

import functools
import importlib
import inspect
import json
import time
from pathlib import Path

import numpy as np
import torch

KERNELS = {
    "k1a": ("lldslam_tpu_torch.ops.orb_describe", "describe"),
    "k1b": ("lldslam_tpu_torch.ops.stereo_sad", "sad_refine"),
    "k2g": ("lldslam_tpu_torch.ops.match_best2", "gated_best2"),
}
# the tracking step's point pose LM: its observations and its pose
TRACK_CORE = ("lldslam_tpu_torch.pipeline.tracker", "_track_core")
# the chained step with lines: the joint point+line pose LM's inputs
TRACK_LINES = ("lldslam_tpu_torch.pipeline.tracker",
               "_track_step_chained_lines")
# the windowed local BA, points only and joint with lines
BA = {"ba": ("lldslam_tpu_torch.pipeline.mapper_fast", "ba_view_cached"),
      "joint_ba": ("lldslam_tpu_torch.pipeline.mapper_fast",
                   "joint_ba_view_cached")}
# the host half of a pipelined frame: the pose it hands back
FINALIZE = "lldslam_tpu_torch.pipeline.tracker:StereoTracker._finalize_rec"
LINE_MATCH = ("lldslam_tpu_torch.frontend.line_match", "match_stereo_lines")
CHECKED = (*KERNELS, "pose", "line_pose", "ba")


def _keep_pose(args, out):
    """What the pose check reads of a `_track_core` call: the frame's
    keypoints (xy, right u, octave), and the step's pose, inlier positions
    and inlier mask."""
    cur = args[6]
    return dict(xy=cur.xy, ur=cur.ur, octave=cur.octave,
                T=out["T"], X=out["ptpos"], inlier=out["final"])


def _keep_line_pose(args, out):
    """What the line pose check reads of a `_track_step_chained_lines`
    call: the predicted pose (vel_prev @ T_prev), the frame's keypoints,
    the point step's inlier positions and mask, the frame's lines (left
    endpoints, octave, matched right endpoints) and the map lines of its
    line inliers (`det2ln`), and the pose it hands on."""
    T_prev, vel_prev, cur, view, fl = args[1], args[2], args[6], args[20], \
        args[21]
    idx = out["det2ln"].clamp(min=0).long()
    return dict(T_pred=vel_prev @ T_prev, xy=cur.xy, ur=cur.ur,
                octave=cur.octave, X=out["ptpos"], inlier=out["final"],
                p1=fl.kl.p1, p2=fl.kl.p2, loct=fl.kl.octave, p1r=fl.p1_r,
                p2r=fl.p2_r, has_r=fl.has_stereo, ln_in=out["det2ln"] >= 0,
                X0=view[0][idx], d=view[1][idx], T=out["T"])


def _keep_ba(args, kw, out):
    """What the BA check reads of a `ba_view_cached` or
    `joint_ba_view_cached` call: the window's keyframe features (xy, right
    u, octave of the cache slots it reads), poses, fixed mask, points,
    observations, and the map lines with their observations; and what it
    solved, with the observations it kept as inliers."""
    (_, cache, slots, poses, fixed, points, pvalid, obs_k, obs_fe, obs_p,
     n_obs) = args[:11]
    keep = dict(xy=cache.xy[slots], ur=cache.ur[slots],
                octave=cache.octave[slots], poses=poses, fixed=fixed,
                points=points, pvalid=pvalid, obs_k=obs_k, obs_fe=obs_fe,
                obs_p=obs_p, n_obs=int(n_obs), out_poses=out[0],
                out_points=out[1], out_keep=out[2])
    if len(args) > 14:
        ln_x0, ln_dir, ln_valid, lobs = args[14:18]
        keep.update(ln_x0=ln_x0, ln_dir=ln_dir, ln_valid=ln_valid,
                    lobs=dict(lobs._asdict()),
                    gamma=float(kw.get("gamma", args[18] if len(args) > 18
                                       else 0.5)),
                    out_X0=out[2], out_d=out[3], out_keep=out[4],
                    out_keep_l=out[5])
    return keep


def _resolve(target: str):
    """'pkg.module:Class.attr' or 'pkg.module:func' -> (owner, name)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


def _replace(owner, name, make):
    """owner.name = make(original), keeping a staticmethod static."""
    raw = owner.__dict__.get(name) if inspect.isclass(owner) else None
    if isinstance(raw, staticmethod):
        setattr(owner, name, staticmethod(make(raw.__func__)))
    else:
        setattr(owner, name, make(getattr(owner, name)))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x) if not hasattr(x, "_fields") \
            else type(x)(*(_clone(v) for v in x))
    return x


class Captures:
    """Calls kept for the check and the rooflines."""

    def __init__(self, checked: int | dict, seed: int):
        # calls of each kind kept for the check: a number for every kind,
        # or a number a kind with a "default"
        if not isinstance(checked, dict):
            checked = {"default": checked}
        self.k = {key: checked.get(key, checked["default"])
                  for key in CHECKED}
        self.rng = np.random.default_rng(seed)
        self.armed = False            # inside the measured window
        self.tracing = False          # inside a traced window
        self.current = None           # frames handed over: [(seq, frame)]
        self.calls = {k: 0 for k in CHECKED}
        self.kept = {k: [] for k in CHECKED}
        self.traced = {k: [] for k in KERNELS}
        self.lines = []               # (frames, r_idx) of every window call
        self.finals = {}              # (id(tracker), frame) -> T_cw back
        for key, target in KERNELS.items():
            owner, name = _resolve(":".join(target))
            _replace(owner, name, functools.partial(self._wrap, key))
        owner, name = _resolve(":".join(TRACK_CORE))
        _replace(owner, name, functools.partial(
            self._wrap_step, "pose", _keep_pose))
        owner, name = _resolve(":".join(TRACK_LINES))
        _replace(owner, name, functools.partial(
            self._wrap_step, "line_pose", _keep_line_pose))
        for target in BA.values():
            owner, name = _resolve(":".join(target))
            _replace(owner, name, self._wrap_ba)
        owner, name = _resolve(":".join(LINE_MATCH))
        _replace(owner, name, self._wrap_lines)
        owner, name = _resolve(FINALIZE)
        _replace(owner, name, self._wrap_finalize)

    def _slot(self, key) -> int | None:
        """Where the next call of `key` goes in its sample (reservoir
        sampling over the window's calls), or None when it is not kept."""
        n = self.calls[key]
        self.calls[key] = n + 1
        if n < self.k[key]:
            self.kept[key].append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k[key] else None

    def _wrap(self, key, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not (self.armed or self.tracing):
                return fn(*args, **kw)
            if self.tracing:
                with torch.profiler.record_function(f"op:{key}"):
                    out = fn(*args, **kw)
                self.traced[key].append((args, out))
                return out
            out = fn(*args, **kw)
            j = self._slot(key)
            if j is not None:
                self.kept[key][j] = dict(
                    call=self.calls[key] - 1, frames=self.current,
                    args=_clone(args), out=_clone(out))
            return out
        return call

    def _wrap_step(self, key, keep, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            out = fn(*args, **kw)
            if self.armed:
                j = self._slot(key)
                if j is not None:
                    self.kept[key][j] = dict(
                        call=self.calls[key] - 1, frames=self.current,
                        **_clone(keep(args, out)))
            return out
        return call

    def _wrap_ba(self, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            out = fn(*args, **kw)
            if self.armed:
                j = self._slot("ba")
                if j is not None:
                    self.kept["ba"][j] = dict(
                        call=self.calls["ba"] - 1,
                        **_clone(_keep_ba(args, kw, out)))
            return out
        return call

    def _wrap_finalize(self, fn):
        @functools.wraps(fn)
        def call(tracker, rec, *args, **kw):
            out = fn(tracker, rec, *args, **kw)
            # every frame's, the flush's too: a checked frame's pose may
            # come back after the window
            self.finals[(id(tracker), rec["fid"])] = tracker.T_cw.copy()
            return out
        return call

    def _wrap_lines(self, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            out = fn(*args, **kw)
            if self.armed:
                self.lines.append((self.current, out.r_idx.detach().clone()))
            return out
        return call


class Layers:
    """Host-clock spans and profiler ranges around each layer's entries."""

    def __init__(self, layers_dir: Path):
        self.seconds: dict[str, float] = {}
        self.armed = False
        for path in sorted(Path(layers_dir).glob("*.json")):
            layer = json.loads(path.read_text())
            for target in layer["entries"]:
                owner, name = _resolve(target)
                _replace(owner, name,
                         functools.partial(self._wrap, layer["name"]))

    def _wrap(self, layer, fn):
        label = f"layer:{layer}"

        @functools.wraps(fn)
        def call(*args, **kw):
            if not self.armed:
                return fn(*args, **kw)
            t = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kw)
            self.seconds[layer] = self.seconds.get(layer, 0.0) + (
                time.perf_counter() - t)
            return out
        return call
