"""System facade: the public API of the port.

Counterpart of lldslam_tpu/system.py: stereo (points and lines), monocular
and RGB-D input, synchronous or pipelined, trajectory export and map
checkpoints:

    sys = System(cfg, device="cuda")          # pipeline=True: pipelined
    T_cw, metrics = sys.track_stereo(img_l, img_r, timestamp)
    # or sys.track_stereo(None, None, ts, pair_dev=sys.stage_stereo(l, r))
    # or sys.track_monocular(img, timestamp)
    # or sys.track_rgbd(img, depthmap, timestamp, depth_factor)
    sys.flush()                               # pipelined: the last frames
    sys.save_trajectory_kitti(path)
    sys.save_map(path)

Loop closing and relocalization are on by default, with this package's copy
of the shipped vocabulary (`loop/vocab_synth.npz`, the same file as the JAX
package's); when that file is absent a vocabulary is trained from the first
keyframe. Lines run when the config enables them (`ldType: LBDFloat`): from
stored detections where it gives `lineDetectionsPath`, else from the native
detector on the device.

With `pipeline=True` stereo frames take the pipelined tracker
(pipeline/tracker.py): `track_stereo` returns the last frame finalized in
that call, or (current pose estimate, None) when none was, and `flush()`
finalizes the frames still in flight at the end of a sequence.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from .config import SlamConfig, load_config
from .io import checkpoint
from .io import trajectory as traj
from .loop.bow import Vocabulary
from .pipeline.tracker import StereoTracker, TrackState

# the shipped vocabulary (99106 words)
DEFAULT_VOCABULARY = Path(__file__).resolve().parent / "loop" / "vocab_synth.npz"


@functools.lru_cache(maxsize=1)
def _default_vocabulary() -> Vocabulary | None:
    """The shipped vocabulary (host arrays, read once per process), or None
    when the file is absent."""
    if not DEFAULT_VOCABULARY.exists():
        return None
    return Vocabulary.load_npz(DEFAULT_VOCABULARY)


class System:
    def __init__(self, cfg: SlamConfig | str | Path, sequence: str | None = None,
                 vocabulary=None, enable_loops: bool = True,
                 pipeline: bool = False, device="cuda"):
        """vocabulary: a `Vocabulary`, a path to an `.npz` vocabulary or an
        ORBvoc.txt-format file, or None (the shipped vocabulary, else one
        trained from the first keyframe). `device`: the card by default;
        pass "cpu" to run the plain PyTorch versions on the CPU (without a
        card the default raises at the first allocation)."""
        if not isinstance(cfg, SlamConfig):
            cfg = load_config(cfg, sequence=sequence)
        self.cfg = cfg
        self.device = device
        self.pipeline = pipeline
        if isinstance(vocabulary, (str, Path)):
            p = Path(vocabulary)
            vocabulary = (Vocabulary.load_npz(p) if p.suffix == ".npz"
                          else Vocabulary.load_text(p))
        elif vocabulary is None and enable_loops:
            vocabulary = _default_vocabulary()
        if vocabulary is not None:
            vocabulary = vocabulary.to(device)
        self.tracker = StereoTracker(cfg, vocabulary=vocabulary,
                                     enable_loops=enable_loops,
                                     pipeline=pipeline, device=device)

    def warmup(self) -> None:
        """Pay a process's one-off first-call costs of the rare paths now
        rather than inside the first keyframe or loop event, in the JAX
        package's order: the loop event's Sim3 RANSAC and refinement
        (`LoopCloser.warmup`, or with loops off
        `loop.closing.warmup_loop_programs`), then the mapper's keyframe
        stage, local BA (joint with lines) and, with loops on, a BoW
        descent (`LocalMapper.warmup`), then the monocular bootstrap's match
        and H/F initializer at the tracker's keypoint count
        (`pipeline.tracker.warmup_mono_programs`); also
        `torch.func`'s first forward-mode pass (about 2 s), and on the card
        the CUDA kernels' build and the solver libraries the relocalization
        path calls (batched eigh, SVD, solve, inverse).
        Nothing is compiled ahead: the port runs eagerly. The map, the
        tracker's state and every generator stay as they were."""
        from .loop.closing import warmup_loop_programs
        from .pipeline.tracker import warmup_mono_programs
        tr = self.tracker
        dev = tr.device
        eye = torch.eye(4, device=dev).expand(2, 4, 4)
        torch.func.jvp(lambda x: x * 2, (eye,), (eye,))
        if dev.type == "cuda":
            from .ops import cuda_build
            cuda_build.library()
            torch.linalg.eigh(eye)
            torch.linalg.svd(eye)
            torch.linalg.solve_ex(eye, eye)
            torch.linalg.inv_ex(eye)
        lc = tr.loop_closer
        if lc is not None:
            lc.warmup()
        else:
            warmup_loop_programs(tr.cam, dev)
        tr.mapper.warmup(voc=None if lc is None else lc.voc)
        warmup_mono_programs(tr.cam, tr.store.n_kp, dev)

    # -- frame input ------------------------------------------------------
    def track_stereo(self, img_l: np.ndarray | None,
                     img_r: np.ndarray | None, timestamp: float = 0.0,
                     pair_dev: torch.Tensor | None = None, lines_dev=None):
        """Returns (T_cw (4,4), per-frame metrics). pair_dev: the pair
        staged by `stage_stereo` (the images may then be None); lines_dev:
        the frame's stored detections staged by
        io.stored_lines.stage_stored_pair."""
        return self.tracker.process(img_l, img_r, timestamp,
                                    pair_dev=pair_dev, lines_dev=lines_dev)

    def stage_stereo(self, img_l: np.ndarray,
                     img_r: np.ndarray) -> torch.Tensor:
        """One stereo pair on the device (one upload), for
        `track_stereo(..., pair_dev=)`."""
        return self.tracker.stage_pair(img_l, img_r)

    def track_rgbd(self, img: np.ndarray, depthmap: np.ndarray,
                   timestamp: float = 0.0, depth_factor: float = 1.0):
        """RGB-D input: the depth map (times depth_factor, metres) gives
        each keypoint a virtual stereo coordinate. Returns (T_cw, metrics)."""
        return self.tracker.process_rgbd(img, depthmap, timestamp,
                                         depth_factor)

    def track_monocular(self, img: np.ndarray, timestamp: float = 0.0):
        """Monocular input: H/F bootstrap, then a map of free scale.
        Returns (T_cw, metrics)."""
        return self.tracker.process_mono(img, timestamp)

    def flush(self):
        """Finalize the pipelined frames in flight and absorb the staged
        keyframe work; returns the last finalized (T_cw, metrics), or None
        (always None for the synchronous tracker)."""
        return self.tracker.flush()

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    @property
    def map(self):
        return self.tracker.store

    # -- trajectory export --------------------------------------------------
    def save_trajectory_kitti(self, path: str | Path) -> None:
        _, T_wc = self.tracker.trajectory()
        traj.save_kitti(path, T_wc)

    def save_trajectory_tum(self, path: str | Path) -> None:
        ts, T_wc = self.tracker.trajectory()
        traj.save_tum(path, ts, T_wc)

    def save_keyframe_trajectory_tum(self, path: str | Path) -> None:
        s = self.map
        sel = np.nonzero(s.kf_valid[:s.n_kf])[0]
        T_cw = s.kf_pose[sel]
        Rwc = np.transpose(T_cw[:, :3, :3], (0, 2, 1))
        twc = -np.einsum("kij,kj->ki", Rwc, T_cw[:, :3, 3])
        T_wc = np.tile(np.eye(4, dtype=np.float32), (len(sel), 1, 1))
        T_wc[:, :3, :3] = Rwc
        T_wc[:, :3, 3] = twc
        traj.save_tum(path, s.kf_timestamp[sel], T_wc)

    # -- mode switches and lifecycle --------------------------------------
    def activate_localization_mode(self) -> None:
        """Track against the frozen map: no keyframes, no map growth. The
        pipelined frames in flight were dispatched with the mapping mode's
        keyframe decision: they are finalized first and the chain reseeds."""
        self._drain()
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self._drain()
        self.tracker.localization_only = False

    def _drain(self):
        if self.pipeline:
            self.tracker.flush()
            self.tracker._resync = True

    def reset(self) -> None:
        """Full reset: clear map and trajectory, reinitialize."""
        self.tracker = StereoTracker(
            self.cfg, vocabulary=self.tracker.vocabulary,
            enable_loops=self.tracker.enable_loops, pipeline=self.pipeline,
            device=self.device)

    # -- map persistence --------------------------------------------------
    def save_map(self, path) -> None:
        """Every array of the map store and its counters, one .npz."""
        checkpoint.save_map(self.map, path)

    def load_map(self, path) -> None:
        """Restore a map saved by `save_map` (or by the JAX package) into
        this System's store, and make it trackable: the loop closer's
        keyframe database is rebuilt from the stored keyframes and, on a
        non-empty map, the tracker starts LOST, so the next frame
        relocalizes against the map (`StereoTracker.restore_map`; the JAX
        package restores the store alone)."""
        checkpoint.load_map(self.map, path)
        self.tracker.restore_map()

    def shutdown(self) -> None:
        """Finalize what is in flight; the port starts no threads."""
        self.tracker.flush()
