"""Deterministic per-frame stereo tracking, synchronous path, points only.

Counterpart of lldslam_tpu/pipeline/tracker.py (`StereoTracker` with
`pipeline=False`). Every frame runs

    build_frame_pair -> motion-model match (radius 7, else 14) -> pose LM
    -> local-map projection search (K2) -> pose LM -> keyframe decision
    -> (on a keyframe) point creation + LocalMapper.process_keyframe

with the reference semantics the JAX package keeps: stereo initialization
above `min_init_points` depth'd keypoints, TrackReferenceKeyFrame fallback
when the motion model is weak, temporal seeding of close unassociated
features into the next frame's motion model, NeedNewKeyFrame with a minimum
gap of 3 frames, and trajectory bookkeeping relative to reference keyframes.
With loop closing off (the only mode ported) a LOST tracker stays LOST, as
in the JAX package.

Not ported yet (each raises NotImplementedError, see ROADMAP queue 1): loop
closing and relocalization, the pipelined tracker (and with it the
provisional point identities and the on-device keyframe decision), lines,
monocular and RGB-D input.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SlamConfig
from ..frontend import matching
from ..frontend.frame import FrameData, build_frame_pair
from ..geometry.camera import backproject
from ..io import trajectory as traj
from ..ops import hamming
from ..optim import pose_opt
from ..slammap.map_store import MapStore
from . import local_mapping, mapper_fast
from .kf_cache import KfCache


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def _gather_pose_obs(cam, pt_pos: torch.Tensor, kp2pt: torch.Tensor,
                     feats: matching.FrameFeatures,
                     inv_sigma2_lut: torch.Tensor) -> pose_opt.PointPoseObs:
    """Per-keypoint observation table for pose-only optimization."""
    return pose_opt.PointPoseObs(
        X=pt_pos[torch.clamp(kp2pt, min=0).long()],
        obs=torch.cat([feats.xy, feats.ur[:, None]], dim=-1),
        inv_sigma2=inv_sigma2_lut[feats.octave.long()],
        is_stereo=feats.ur >= 0,
        valid=(kp2pt >= 0) & feats.valid)


def _track_core(cam, T_pred: torch.Tensor, last_feats: matching.FrameFeatures,
                last_ptpos: torch.Tensor, last_haspt: torch.Tensor,
                last_ismap: torch.Tensor, cur: matching.FrameFeatures,
                depth: torch.Tensor, view: matching.MapPointView,
                inv_sigma2_lut: torch.Tensor, n_levels: int, scale: float,
                min_mm: int, close_depth: float) -> dict:
    """The per-frame tracking math: motion-model association (narrow, else
    wide) -> pose LM -> local-map projection search -> pose LM -> stats, and
    the next frame's motion-model state (associated features keep their
    landmark position; close unassociated ones seed from stereo depth).
    Returns a dict of device tensors."""
    obs = torch.cat([cur.xy, cur.ur[:, None]], dim=-1)
    lut = inv_sigma2_lut[cur.octave.long()]
    is_stereo = cur.ur >= 0

    # --- motion-model association ---
    kp2last_a = matching.match_last_frame(
        cam, T_pred, last_feats, last_ptpos, last_haspt, cur,
        n_levels=n_levels, scale=scale, radius=7.0)
    kp2last_b = matching.match_last_frame(
        cam, T_pred, last_feats, last_ptpos, last_haspt, cur,
        n_levels=n_levels, scale=scale, radius=14.0)
    kp2last = torch.where((kp2last_a >= 0).sum() >= 20, kp2last_a, kp2last_b)
    n_mm = (kp2last >= 0).sum()
    has_mm = n_mm >= min_mm
    li = torch.clamp(kp2last, min=0).long()
    pobs1 = pose_opt.PointPoseObs(X=last_ptpos[li], obs=obs, inv_sigma2=lut,
                                  is_stereo=is_stereo,
                                  valid=(kp2last >= 0) & cur.valid)
    T1, pt_in1, _ = pose_opt.optimize_pose(cam, T_pred, pobs1)
    T1 = torch.where(has_mm, T1, T_pred)
    kp2last = torch.where(pt_in1 & has_mm, kp2last, -1)
    li = torch.clamp(kp2last, min=0).long()

    # --- local-map association + final pose ---
    _, kp2pt_l, _, in_frustum = matching.search_by_projection(
        cam, T1, view, cur, n_levels=n_levels, scale=scale, th=1.0)
    use_l = kp2pt_l >= 0
    X2 = torch.where(use_l[:, None],
                     view.pos[torch.clamp(kp2pt_l, min=0).long()],
                     last_ptpos[li])
    valid2 = (use_l | (kp2last >= 0)) & cur.valid
    pobs2 = pose_opt.PointPoseObs(X=X2, obs=obs, inv_sigma2=lut,
                                  is_stereo=is_stereo, valid=valid2)
    T2, pt_in2, _ = pose_opt.optimize_pose(cam, T1, pobs2)

    final_ok = valid2 & pt_in2
    # map-only association: a local-view hit is a map point; a last-frame
    # hit inherits the flag (temporal seeds are not map points)
    ismap2 = use_l | ((kp2last >= 0) & last_ismap[li])
    map_ok = final_ok & ismap2
    close = (depth > 0) & (depth < close_depth) & cur.valid
    stats = torch.stack([n_mm, map_ok.sum(), (close & map_ok).sum(),
                         (close & ~map_ok).sum(), cur.valid.sum(),
                         ((cur.ur >= 0) & cur.valid).sum()])
    # next-frame chain state with temporal seeding
    T_wc = torch.linalg.inv(T2)
    Xc = backproject(cam, cur.xy, torch.clamp(depth, min=1e-6))
    Xw_depth = Xc @ T_wc[:3, :3].T + T_wc[:3, 3]
    return dict(
        T=T2, stats=stats, kp2last=kp2last, kp2pt_l=kp2pt_l, ok=map_ok,
        in_frustum=in_frustum,
        ptpos=torch.where(final_ok[:, None], X2, Xw_depth),
        haspt=final_ok | close, ismap=map_ok)


@dataclass
class FrameLog:
    """Per-frame trajectory bookkeeping entry."""

    timestamp: float
    T_cr: np.ndarray      # pose relative to reference KF
    ref_kf: int
    lost: bool


@dataclass
class TrackMetrics:
    """Per-frame telemetry; t_* are wall-clock seconds."""

    frame_id: int = 0
    state: str = ""
    n_kp: int = 0
    n_stereo: int = 0
    n_motion_matches: int = 0
    n_inliers: int = 0
    new_kf: bool = False
    n_points: int = 0
    n_kfs: int = 0
    t_build: float = 0.0
    t_step: float = 0.0
    t_kf: float = 0.0


class StereoTracker:
    def __init__(self, cfg: SlamConfig, store: MapStore | None = None,
                 enable_loops: bool = False, pipeline: bool = False,
                 device="cpu"):
        if enable_loops:
            raise NotImplementedError(
                "loop closing and relocalization are not ported to "
                "lldslam_tpu_torch yet; see ROADMAP queue 1 items 2-3")
        if pipeline:
            raise NotImplementedError(
                "the pipelined tracker is not ported to lldslam_tpu_torch "
                "yet; see ROADMAP queue 1 item 4")
        if cfg.line.enabled:
            raise NotImplementedError(
                "line features are not ported to lldslam_tpu_torch yet; see "
                "ROADMAP queue 1 item 5")
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = cfg.camera.stereo_camera()
        self.orb = cfg.orb
        self.store = store or MapStore(self.cam, self.orb)
        self.state = TrackState.NOT_INITIALIZED
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = -1
        self.last_kf_frame = -1
        self.frame_id = -1
        self._ref_matches = 0
        self.logs: list[FrameLog] = []
        self.metrics: list[TrackMetrics] = []
        # last-frame state for the motion model (device tensors)
        self._last_feats = None
        self._last_ptpos = None    # (N, 3) world position per keypoint
        self._last_haspt = None    # (N,) bool
        self._last_ismap = None    # (N,) bool: position is a real MapPoint
        self._last_kp2pt = None    # (N,) np global point id
        self._inv_sigma2_lut = torch.from_numpy(np.power(
            1.0 / self.orb.scale ** 2, np.arange(self.orb.n_levels))
            .astype(np.float32)).to(self.device)
        self._has_velocity = False
        self._view = None
        self._view_pid = None
        self.kf_cache = KfCache(n_slots=32, n_kp=self.store.n_kp,
                                device=self.device)
        self.mapper = local_mapping.LocalMapper(
            self.store, cfg, cache=self.kf_cache, device=self.device)

    # ------------------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                timestamp: float = 0.0):
        """Track one stereo pair; returns (T_cw (4,4) np, TrackMetrics)."""
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        t0 = time.perf_counter()
        if img_l.dtype != np.uint8 and img_l.max(initial=0.0) <= 255.0:
            img_l, img_r = img_l.astype(np.uint8), img_r.astype(np.uint8)
        fd = build_frame_pair(self._t(np.stack([img_l, img_r])), self.cam,
                              self.orb)
        m.t_build = time.perf_counter() - t0
        return self._process_fd(fd, timestamp, m)

    def _process_fd(self, fd: FrameData, timestamp: float, m: TrackMetrics):
        t0 = time.perf_counter()
        if self.state == TrackState.NOT_INITIALIZED:
            self._initialize(fd, timestamp, m)
        else:
            self._track(fd, timestamp, m)
        m.t_step = time.perf_counter() - t0 - m.t_kf
        if not m.state:  # a reset path may have recorded LOST already
            m.state = self.state.name
        m.n_points = int(self.store.pt_valid.sum())
        m.n_kfs = self.store.n_kf
        self.metrics.append(m)
        return self.T_cw.copy(), m

    # ------------------------------------------------------------------

    def _snapshot_np(self, fd: FrameData):
        """Host copy of the frame's features and depth."""
        f = fd.feats
        feats = dict(xy=f.xy.cpu().numpy(), ur=f.ur.cpu().numpy(),
                     octave=f.octave.cpu().numpy(),
                     angle=f.angle.cpu().numpy(),
                     desc=f.desc.cpu().numpy().view(np.uint32),
                     valid=f.valid.cpu().numpy())
        return feats, fd.depth.cpu().numpy()

    def _initialize(self, fd: FrameData, timestamp: float, m: TrackMetrics):
        """StereoInitialization: every stereo-depth'd keypoint becomes a map
        point, the frame becomes KF 0 at identity."""
        fid = self.frame_id
        feats, depth = self._snapshot_np(fd)
        if int(((depth > 0) & feats["valid"]).sum()) \
                <= self.cfg.tracking.min_init_points:
            return
        T0 = np.eye(4, dtype=np.float32)
        kf = self.store.add_keyframe(
            T0, feats, depth, np.full(self.store.n_kp, -1, np.int32), fid,
            timestamp)
        good = np.nonzero((depth > 0) & feats["valid"])[0]
        uv = feats["xy"][good]
        z = depth[good]
        cam = self.cam
        Xw = np.stack([(uv[:, 0] - cam.cx) * z / cam.fx,
                       (uv[:, 1] - cam.cy) * z / cam.fy, z], -1).astype(np.float32)
        ids = self.store.create_points(kf, good, Xw)
        self.T_cw = T0
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = kf
        self.last_kf_frame = fid
        self.mapper.cache_frame(kf, fd.feats)
        self.state = TrackState.OK
        self._has_velocity = False
        kp2pt = np.full(self.store.n_kp, -1, np.int32)
        kp2pt[good] = ids
        self._refresh_local_view()
        self._refresh_ref_matches()
        self._remember_frame(fd, kp2pt)
        self._log_frame(timestamp)
        m.new_kf = True
        m.n_inliers = len(ids)

    def _remember_frame(self, fd: FrameData, kp2pt: np.ndarray,
                        step: dict | None = None):
        """Stash what the next frame's motion model needs: the device state
        of the step, or (at keyframes and initialization) positions rebuilt
        from the store."""
        self._last_feats = fd.feats
        self._last_kp2pt = kp2pt
        if step is not None:
            self._last_ptpos = step["ptpos"]
            self._last_haspt = step["haspt"]
            self._last_ismap = step["ismap"]
        else:
            haspt = kp2pt >= 0
            pos = np.zeros((self.store.n_kp, 3), np.float32)
            pos[haspt] = self.store.pt_pos[kp2pt[haspt]]
            self._last_ptpos = self._t(pos)
            self._last_haspt = self._t(haspt)
            self._last_ismap = self._last_haspt

    def _log_frame(self, timestamp: float, lost: bool = False):
        T_rw = self.store.kf_pose[self.ref_kf]
        T_cr = self.T_cw @ np.linalg.inv(T_rw)
        self.logs.append(FrameLog(timestamp, T_cr.astype(np.float32),
                                  self.ref_kf, lost))

    def _refresh_ref_matches(self):
        """Reference-KF tracked-point count for the keyframe decision:
        features whose point has >= 3 observations (2 while the map is
        tiny)."""
        s = self.store
        min_obs = 3 if s.n_kf > 2 else 2
        ids = s.kf_pt_ids[self.ref_kf]
        ids = ids[ids >= 0]
        ids = ids[s.pt_valid[ids]]
        if len(ids) == 0:
            self._ref_matches = 0
            return
        s.refresh_obs_counts()
        self._ref_matches = int((s.pt_nobs[ids] >= min_obs).sum())

    def _refresh_local_view(self):
        """Rebuild the padded MapPointView over the local map (points of the
        reference keyframe's covisibility neighbourhood)."""
        ids = self.mapper._select_view_pids(self.ref_kf)
        cap = local_mapping.view_capacity(len(ids))
        ids = ids[-cap:]   # ascending covisibility weight: keep strongest
        self._view_pid = np.concatenate(
            [ids, np.full(cap - len(ids), -1, ids.dtype)])
        self._view = mapper_fast.view_from_store(self.store, ids, cap,
                                                 self.device)

    def _ref_anchor_pose(self, fd: FrameData) -> np.ndarray | None:
        """TrackReferenceKeyFrame pose: descriptor match against the
        reference KF, then robust pose optimization from the current pose.
        None when fewer than 10 associations."""
        kp2pt_ref = self._match_ref_kf(fd)
        if (kp2pt_ref >= 0).sum() < 10:
            return None
        # gather on the host: per-keypoint rows of the store's positions
        X = self.store.pt_pos[np.maximum(kp2pt_ref, 0)]
        rows = np.where(kp2pt_ref >= 0, np.arange(len(X)), -1)
        pobs = _gather_pose_obs(self.cam, self._t(X), self._t(rows),
                                fd.feats, self._inv_sigma2_lut)
        T_fb, _, _ = pose_opt.optimize_pose(self.cam, self._t(self.T_cw), pobs)
        T_fb = T_fb.cpu().numpy()
        return T_fb if np.isfinite(T_fb).all() else None

    def _match_ref_kf(self, fd: FrameData) -> np.ndarray:
        """TrackReferenceKeyFrame association: ratio-0.7 mutual descriptor
        match of the frame against the reference KF's features that carry
        map points, rotation-consistency filtered. Returns kp2pt (N,)."""
        s = self.store
        ref_valid = s.kf_kp_valid[self.ref_kf] & (s.kf_pt_ids[self.ref_kf] >= 0)
        idx, ok, _ = hamming.match_descriptors(
            fd.feats.desc, fd.feats.valid,
            self._t(s.kf_desc[self.ref_kf].view(np.int32)), self._t(ref_valid),
            max_dist=hamming.TH_LOW, ratio=0.7)
        ok = hamming.rotation_consistency_mask(
            fd.feats.angle, self._t(s.kf_angle[self.ref_kf]), idx, ok)
        idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
        kp2pt = np.full(s.n_kp, -1, np.int32)
        kp2pt[ok] = s.kf_pt_ids[self.ref_kf, idx[ok]]
        return kp2pt

    def _run_step(self, fd: FrameData, T_pred: np.ndarray):
        """One `_track_core` from T_pred; returns (host results, step)."""
        step = _track_core(
            self.cam, self._t(T_pred.astype(np.float32)), self._last_feats,
            self._last_ptpos, self._last_haspt, self._last_ismap, fd.feats,
            fd.depth, self._view, self._inv_sigma2_lut, self.orb.n_levels,
            self.orb.scale, self.cfg.tracking.min_motion_matches,
            float(self.cfg.close_depth))
        host = {k: step[k].cpu().numpy()
                for k in ("T", "stats", "kp2last", "kp2pt_l", "ok",
                          "in_frustum")}
        host["stats"] = [int(x) for x in host["stats"]]
        return host, step

    def _reset_full(self):
        """Auto-reset when tracking is lost right after initialization:
        clear the map and trajectory bookkeeping, reinitialize."""
        self.store = MapStore(self.cam, self.orb)
        self.kf_cache.clear()
        self.mapper = local_mapping.LocalMapper(
            self.store, self.cfg, cache=self.kf_cache, device=self.device)
        self.state = TrackState.NOT_INITIALIZED
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = -1
        self.last_kf_frame = -1
        self.logs.clear()
        self._view = None
        self._view_pid = None

    def _track(self, fd: FrameData, timestamp: float, m: TrackMetrics):
        fid = self.frame_id
        # relocalization needs loop closing's vocabulary: with loops off a
        # LOST tracker stays LOST (as in the JAX package)
        if not self._has_velocity and self.ref_kf >= 0 \
                and self.state == TrackState.OK:
            # no motion model: anchor on the reference KF
            T_anchor = self._ref_anchor_pose(fd)
            T_pred = (T_anchor if T_anchor is not None
                      else (self.velocity @ self.T_cw)).astype(np.float32)
        else:
            T_pred = (self.velocity @ self.T_cw).astype(np.float32)
        host, step = self._run_step(fd, T_pred)
        self._track_finalize(fd, host, step, timestamp, m, fid)

    def _track_finalize(self, fd: FrameData, host: dict, step: dict,
                        timestamp: float, m: TrackMetrics, fid: int):
        """Host half of the track step: fallback, associations, keyframe
        decision."""
        n_mm, n_in, tracked_close, untracked_close, n_kp, n_st = host["stats"]
        m.n_motion_matches, m.n_kp, m.n_stereo = n_mm, n_kp, n_st
        if (n_in < self.cfg.tracking.min_track_inliers or n_mm < 20) \
                and self.ref_kf >= 0:
            # weak motion model: re-anchor on the reference KF and redo the
            # step; keep the better of the two associations
            T_fb = self._ref_anchor_pose(fd)
            if T_fb is not None:
                host2, step2 = self._run_step(fd, T_fb)
                if host2["stats"][1] > n_in:
                    host, step = host2, step2
                    n_mm, n_in, tracked_close, untracked_close = \
                        host["stats"][:4]
        m.n_inliers = n_in

        # global point id per keypoint: local-map association wins, else the
        # carried-over last-frame association; masked by the final inliers
        pid = self._view_pid
        kp2last, kp2pt_l = host["kp2last"], host["kp2pt_l"]
        kp2pt = np.where(
            kp2pt_l >= 0, pid[np.maximum(kp2pt_l, 0)],
            np.where(kp2last >= 0, self._last_kp2pt[np.maximum(kp2last, 0)],
                     -1)).astype(np.int32)
        kp2pt[~host["ok"]] = -1
        # visibility stats (SearchLocalPoints IncreaseVisible)
        np.add.at(self.store.pt_visible, pid[host["in_frustum"] & (pid >= 0)], 1)
        np.add.at(self.store.pt_found, kp2pt[kp2pt >= 0], 1)

        if n_in < self.cfg.tracking.min_track_inliers:
            if self.store.n_kf <= 5:
                # lost right after initialization: full reset
                m.state = TrackState.LOST.name
                self._reset_full()
                return
            self.state = TrackState.LOST
            self._has_velocity = False
            self._log_frame(timestamp, lost=True)
            return

        T_np = host["T"]
        self.state = TrackState.OK
        self.velocity = (T_np @ np.linalg.inv(self.T_cw)).astype(np.float32)
        self._has_velocity = True
        self.T_cw = T_np.astype(np.float32)

        new_kf = self._need_new_kf(n_in, tracked_close, untracked_close, fid)
        if new_kf:
            t0 = time.perf_counter()
            self._create_kf(fd, kp2pt, timestamp, fid)
            m.t_kf = time.perf_counter() - t0
            m.new_kf = True
        self._remember_frame(fd, kp2pt, None if new_kf else step)
        self._log_frame(timestamp)

    # ------------------------------------------------------------------

    def _need_new_kf(self, n_in: int, tracked_close: int,
                     untracked_close: int, fid: int) -> bool:
        """NeedNewKeyFrame, deterministic-schedule reduction: the 75%
        reference ratio, the close-point deficit or the max gap, at least 3
        frames after the last keyframe."""
        if n_in <= 15:
            return False
        if fid - self.last_kf_frame < max(
                self.cfg.tracking.min_frames_between_kf, 3):
            return False
        need_close = tracked_close < 100 and untracked_close > 70
        too_old = fid - self.last_kf_frame >= \
            self.cfg.tracking.max_frames_between_kf
        weak = n_in < 0.75 * self._ref_matches
        return weak or need_close or too_old

    def _create_kf(self, fd: FrameData, kp2pt: np.ndarray, timestamp: float,
                   fid: int):
        """CreateNewKeyFrame: insert the KF, create close-depth points (all
        under ThDepth, or the 100 nearest), then run the local-mapping
        step."""
        s = self.store
        feats, depth = self._snapshot_np(fd)
        kf = s.add_keyframe(self.T_cw, feats, depth, kp2pt, fid, timestamp)
        cand = np.nonzero((depth > 0) & feats["valid"] & (kp2pt < 0))[0]
        order = cand[np.argsort(depth[cand])]
        take = depth[order] < self.cfg.close_depth
        take[:min(100, len(take))] = True
        sel = order[take]
        if len(sel):
            cam = self.cam
            uv = feats["xy"][sel]
            zz = depth[sel]
            T_wc = np.linalg.inv(self.T_cw)
            Xc = np.stack([(uv[:, 0] - cam.cx) * zz / cam.fx,
                           (uv[:, 1] - cam.cy) * zz / cam.fy, zz], -1)
            Xw = (T_wc[:3, :3] @ Xc.T).T + T_wc[:3, 3]
            kp2pt[sel] = s.create_points(kf, sel, Xw.astype(np.float32))
        s.set_parent_from_covisibility(kf)
        self.ref_kf = kf
        self.last_kf_frame = fid
        self.mapper.cache_frame(kf, fd.feats)
        view_out = self.mapper.process_keyframe(kf)
        # refresh the current pose from the BA-corrected KF pose
        self.T_cw = s.kf_pose[kf].copy()
        if view_out is not None:
            self._view, self._view_pid = view_out   # post-BA view
        else:
            self._refresh_local_view()
        self._refresh_ref_matches()

    def trajectory(self):
        """(timestamps, T_wc stack) replayed through reference keyframes."""
        rel = np.stack([l.T_cr for l in self.logs])
        refs = np.array([l.ref_kf for l in self.logs])
        ts = np.array([l.timestamp for l in self.logs])
        return ts, traj.replay_trajectory(rel, refs, self.store.kf_pose)
