"""The SLAM map as a struct-of-arrays store with fixed capacities.

Counterpart of lldslam_tpu/slammap/map_store.py: host-side numpy, copied
from the JAX package, except that line retriangulation (its multi-view
solve on the device given) writes back at once unless
`staged_retriangulation` is set, as the pipelined tracker does; the JAX
package always stages it. Descriptors stay uint32 here; the tracker and
mapper move them to the device as int32 views.

Replaces the pointer-graph data model of the reference (`Map`, `KeyFrame`,
`MapPoint` — src/Map.cc, src/KeyFrame.cc, src/MapPoint.cc) with flat arrays:

- keyframes: pose + full feature snapshot `kf_*[K, N_KP, ...]`,
- map points: position/descriptor/normal/scale-range/stats `pt_*[P, ...]`,
- observations: a single source of truth `kf_pt_ids[K, N_KP]` (point id per
  keyframe feature slot, -1 for none) — the transpose of the reference's
  per-point `mObservations` maps and per-KF `mvpMapPoints` vectors at once.

Covisibility (KeyFrame::UpdateConnections, KeyFrame.cc:312-402) becomes a
shared-point count over `kf_pt_ids`; per-point distinctive descriptors
(MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:242-307), viewing
normals and scale-invariance ranges (UpdateNormalAndDepth, MapPoint.cc:330-383)
are batched recomputations over the observation arrays.

Bookkeeping runs host-side in numpy at keyframe rate (not per frame); all
per-frame compute takes device views of these arrays.

Threading note: the reference guards this store with `Map::mMutexMapUpdate` +
per-object mutexes (SURVEY.md §5.2). The rebuild's schedule is deterministic
(track -> map update -> BA in order), so no locks exist by construction.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..geometry.camera import StereoCamera
from ..ops.orb import OrbConfig


class MapStore:
    def __init__(
        self,
        cam: StereoCamera,
        cfg: OrbConfig,
        max_kf: int = 512,
        max_pt: int = 120_000,
        max_ln: int = 8192,
        # per-frame line-detection capacity: the reference's stored-LBD
        # benchmark workload carries hundreds of lines per frame
        # (KITTI04-12_LBD.yaml:73-77; TwoFrameLineMatcher.cc:26-123 is an
        # O(L^2) matcher sized for that), so the capacity must hold the
        # KITTI regime, not a toy detector's output
        n_ln_det: int = 256,
        ln_desc_dim: int = 40,
    ):
        self.cam = cam
        self.cfg = cfg
        self.max_kf = max_kf
        self.max_pt = max_pt
        self.max_ln = max_ln
        self.n_ln_det = n_ln_det
        n = cfg.max_kp
        self.n_kp = n
        # line solves queued for write-back: (line ids, HostCopy)
        self.staged_retriangulation = False
        self._pending_retri: deque = deque()

        # keyframes
        self.kf_pose = np.zeros((max_kf, 4, 4), np.float32)  # T_cw
        # spanning tree (KeyFrame::ChangeParent / UpdateConnections first
        # link, KeyFrame.cc:394-404): parent KF id, -1 for the root. The
        # essential graph optimizes over these + persisted loop edges
        # (Optimizer.cc:1391-1654).
        self.kf_parent = np.full(max_kf, -1, np.int32)
        self.loop_edges: list[tuple[int, int]] = []
        self.kf_valid = np.zeros(max_kf, bool)
        self.kf_frame_id = np.full(max_kf, -1, np.int64)
        self.kf_timestamp = np.zeros(max_kf, np.float64)
        self.kf_xy = np.zeros((max_kf, n, 2), np.float32)
        self.kf_ur = np.full((max_kf, n), -1.0, np.float32)
        self.kf_depth = np.full((max_kf, n), -1.0, np.float32)
        self.kf_oct = np.zeros((max_kf, n), np.int32)
        self.kf_angle = np.zeros((max_kf, n), np.float32)
        self.kf_desc = np.zeros((max_kf, n, 8), np.uint32)
        self.kf_kp_valid = np.zeros((max_kf, n), bool)
        self.kf_pt_ids = np.full((max_kf, n), -1, np.int32)  # observations
        self.n_kf = 0

        # map points
        self.pt_pos = np.zeros((max_pt, 3), np.float32)
        self.pt_desc = np.zeros((max_pt, 8), np.uint32)
        self.pt_normal = np.zeros((max_pt, 3), np.float32)
        self.pt_min_dist = np.zeros(max_pt, np.float32)
        self.pt_max_dist = np.zeros(max_pt, np.float32)
        self.pt_valid = np.zeros(max_pt, bool)
        self.pt_first_kf = np.full(max_pt, -1, np.int32)
        self.pt_visible = np.zeros(max_pt, np.int32)
        self.pt_found = np.zeros(max_pt, np.int32)
        # cached observation counts (stereo x2), refreshed at keyframe rate
        # via refresh_obs_counts(); per-query n_obs() scans the whole
        # observation table and dominated the per-KF host profile
        self.pt_nobs = np.zeros(max_pt, np.int32)
        self.n_pt = 0

        # map lines (MapLine, reference src/MapLine.cc: minimal X0-perp-dir
        # form MapLine.h:120-121) + per-KF line detection snapshots
        ld = n_ln_det
        self.ln_x0 = np.zeros((max_ln, 3), np.float32)
        self.ln_dir = np.zeros((max_ln, 3), np.float32)
        self.ln_desc = np.zeros((max_ln, ln_desc_dim), np.float32)
        self.ln_oct = np.zeros(max_ln, np.int32)
        self.ln_valid = np.zeros(max_ln, bool)
        self.ln_first_kf = np.full(max_ln, -1, np.int32)
        self.ln_nobs = np.zeros(max_ln, np.int32)
        self.n_ln = 0
        self.kf_ln_p1 = np.zeros((max_kf, ld, 2), np.float32)
        self.kf_ln_p2 = np.zeros((max_kf, ld, 2), np.float32)
        self.kf_ln_p1r = np.zeros((max_kf, ld, 2), np.float32)
        self.kf_ln_p2r = np.zeros((max_kf, ld, 2), np.float32)
        self.kf_ln_has_r = np.zeros((max_kf, ld), bool)
        self.kf_ln_oct = np.zeros((max_kf, ld), np.int32)
        self.kf_ln_desc = np.zeros((max_kf, ld, ln_desc_dim), np.float32)
        self.kf_ln_valid = np.zeros((max_kf, ld), bool)
        self.kf_ln_ids = np.full((max_kf, ld), -1, np.int32)  # line obs table

        # lazily-rebuilt CSR observation index (point -> observing KF rows):
        # one vectorized pass over the obs table per rebuild, making
        # covisible_kfs/observations_of O(deg) gathers instead of O(K*N)
        # np.isin scans (the reference keeps the same structure as
        # MapPoint::mObservations maps, KeyFrame.cc:312-402 walks them)
        self._obs_dirty = True
        self._obs_pt: np.ndarray | None = None   # sorted point id per obs row
        self._obs_kf: np.ndarray | None = None   # observing KF per obs row
        self._obs_fe: np.ndarray | None = None   # feature slot per obs row
        self._obs_start: np.ndarray | None = None  # (max_pt + 1,) CSR offsets

        # growth ceilings: capacities double on demand up to these hard
        # limits (the reference's std::set maps grow unbounded, src/Map.cc;
        # here growth is geometric reallocation with a logged event)
        self.hard_max_kf = 4096
        self.hard_max_pt = 1_000_000
        self.hard_max_ln = 65_536
        self.cap_events: list[str] = []

    # ------------------------------------------------------------------
    # capacity growth (graceful, geometric; replaces the round-2 asserts)
    # ------------------------------------------------------------------

    _KF_FAMILY = (
        ("kf_pose", 0.0), ("kf_parent", -1), ("kf_valid", False),
        ("kf_frame_id", -1), ("kf_timestamp", 0.0), ("kf_xy", 0.0),
        ("kf_ur", -1.0), ("kf_depth", -1.0), ("kf_oct", 0), ("kf_angle", 0.0),
        ("kf_desc", 0), ("kf_kp_valid", False), ("kf_pt_ids", -1),
        ("kf_ln_p1", 0.0), ("kf_ln_p2", 0.0), ("kf_ln_p1r", 0.0),
        ("kf_ln_p2r", 0.0), ("kf_ln_has_r", False), ("kf_ln_oct", 0),
        ("kf_ln_desc", 0.0), ("kf_ln_valid", False), ("kf_ln_ids", -1),
    )
    _PT_FAMILY = (
        ("pt_pos", 0.0), ("pt_desc", 0), ("pt_normal", 0.0),
        ("pt_min_dist", 0.0), ("pt_max_dist", 0.0), ("pt_valid", False),
        ("pt_first_kf", -1), ("pt_visible", 0), ("pt_found", 0),
        ("pt_nobs", 0),
    )
    _LN_FAMILY = (
        ("ln_x0", 0.0), ("ln_dir", 0.0), ("ln_desc", 0.0), ("ln_oct", 0),
        ("ln_valid", False), ("ln_first_kf", -1), ("ln_nobs", 0),
    )

    def _grow_family(self, family, old_cap: int, new_cap: int):
        for name, fill in family:
            a = getattr(self, name)
            pad = np.full((new_cap - old_cap,) + a.shape[1:], fill, a.dtype)
            setattr(self, name, np.concatenate([a, pad]))

    def _grow_kf(self) -> bool:
        new = min(self.max_kf * 2, self.hard_max_kf)
        if new <= self.max_kf:
            return False
        self.cap_events.append(f"grow_kf {self.max_kf}->{new}")
        self._grow_family(self._KF_FAMILY, self.max_kf, new)
        self.max_kf = new
        return True

    def _grow_pt(self) -> bool:
        new = min(self.max_pt * 2, self.hard_max_pt)
        if new <= self.max_pt:
            return False
        self.cap_events.append(f"grow_pt {self.max_pt}->{new}")
        self._grow_family(self._PT_FAMILY, self.max_pt, new)
        self.max_pt = new
        self._obs_dirty = True  # CSR offsets are sized max_pt + 1
        return True

    def _grow_ln(self) -> bool:
        new = min(self.max_ln * 2, self.hard_max_ln)
        if new <= self.max_ln:
            return False
        self.cap_events.append(f"grow_ln {self.max_ln}->{new}")
        self._grow_family(self._LN_FAMILY, self.max_ln, new)
        self.max_ln = new
        return True

    def room_for_points(self, n: int) -> int:
        """How many of n requested points may be created, growing capacity
        as needed; < n only at the hard ceiling (event logged)."""
        while self.n_pt + n > self.max_pt and self._grow_pt():
            pass
        room = max(0, self.max_pt - self.n_pt)
        if room < n:
            self.cap_events.append(f"pt_ceiling drop {n - room}")
        return min(n, room)

    def room_for_lines(self, n: int) -> int:
        while self.n_ln + n > self.max_ln and self._grow_ln():
            pass
        room = max(0, self.max_ln - self.n_ln)
        if room < n:
            self.cap_events.append(f"ln_ceiling drop {n - room}")
        return min(n, room)

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------

    def add_keyframe(self, T_cw, feats_np, depth_np, pt_ids, frame_id, timestamp=0.0) -> int:
        """feats_np: dict of numpy arrays (xy, ur, octave, angle, desc, valid).
        pt_ids: (N,) int32 current point association per feature (-1 none)."""
        if self.n_kf >= self.max_kf and not self._grow_kf():
            raise RuntimeError(
                f"keyframe hard ceiling {self.hard_max_kf} reached")
        k = self.n_kf
        self.kf_pose[k] = T_cw
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.kf_xy[k] = feats_np["xy"]
        self.kf_ur[k] = feats_np["ur"]
        self.kf_depth[k] = depth_np
        self.kf_oct[k] = feats_np["octave"]
        self.kf_angle[k] = feats_np["angle"]
        self.kf_desc[k] = feats_np["desc"]
        self.kf_kp_valid[k] = feats_np["valid"]
        self.kf_pt_ids[k] = pt_ids
        self.n_kf += 1
        self._obs_dirty = True
        return k

    def add_keyframe_lines(self, kf_id: int, lines_np: dict, ln_ids: np.ndarray):
        """Attach a frame-line snapshot to a keyframe. lines_np keys:
        p1, p2, p1r, p2r, has_r, octave, desc, valid; ln_ids (LD,) map-line
        association per detection (-1 none)."""
        self.kf_ln_p1[kf_id] = lines_np["p1"]
        self.kf_ln_p2[kf_id] = lines_np["p2"]
        self.kf_ln_p1r[kf_id] = lines_np["p1r"]
        self.kf_ln_p2r[kf_id] = lines_np["p2r"]
        self.kf_ln_has_r[kf_id] = lines_np["has_r"]
        self.kf_ln_oct[kf_id] = lines_np["octave"]
        self.kf_ln_desc[kf_id] = lines_np["desc"]
        self.kf_ln_valid[kf_id] = lines_np["valid"]
        self.kf_ln_ids[kf_id] = ln_ids
        # stereo observations count x2 (MapLine::AddObservation,
        # MapLine.cc:70-75)
        obs = ln_ids >= 0
        w = np.where(lines_np["has_r"] & obs, 2, np.where(obs, 1, 0))
        np.add.at(self.ln_nobs, ln_ids[obs], w[obs])

    def create_lines(self, kf_id: int, det_idx: np.ndarray, X0: np.ndarray,
                     d: np.ndarray) -> np.ndarray:
        """Allocate map lines observed by (kf_id, det_idx); X0/d world frame,
        minimal form (sole creation site parallels Tracking.cc:1597)."""
        m = len(det_idx)
        if m > self.room_for_lines(m):
            m = self.room_for_lines(m)
            det_idx, X0, d = det_idx[:m], X0[:m], d[:m]
        ids = np.arange(self.n_ln, self.n_ln + m, dtype=np.int32)
        self.ln_x0[ids] = X0
        self.ln_dir[ids] = d
        self.ln_desc[ids] = self.kf_ln_desc[kf_id, det_idx]
        self.ln_oct[ids] = self.kf_ln_oct[kf_id, det_idx]
        self.ln_valid[ids] = True
        self.ln_first_kf[ids] = kf_id
        self.kf_ln_ids[kf_id, det_idx] = ids
        w = np.where(self.kf_ln_has_r[kf_id, det_idx], 2, 1)
        np.add.at(self.ln_nobs, ids, w)
        self.n_ln += m
        return ids

    def remove_lines(self, ln_ids: np.ndarray):
        ln_ids = np.asarray(ln_ids)
        if len(ln_ids) == 0:
            return
        self.ln_valid[ln_ids] = False
        K = self.n_kf
        ids = self.kf_ln_ids[:K]
        mask = np.isin(ids, ln_ids) & (ids >= 0)
        ids[mask] = -1

    def cull_lines(self):
        """Lines die when their (stereo-weighted) observation count drops to
        <= 4 after multiple keyframes (MapLine::EraseObservation nObs gate,
        MapLine.cc:97; the reference has no separate line culling pass,
        SURVEY.md D7)."""
        K = self.n_kf
        ids = self.kf_ln_ids[:K]
        sel = ids >= 0
        w = np.where(self.kf_ln_has_r[:K], 2, 1).astype(np.int32)
        counts = np.zeros(self.max_ln, np.int32)
        np.add.at(counts, ids[sel], w[sel])
        self.ln_nobs = counts
        stale = self.ln_valid & (self.ln_first_kf <= K - 3) & (counts <= 4)
        self.remove_lines(np.nonzero(stale)[0])

    def retriangulate_lines(self, max_lines: int = 256, max_obs: int = 8,
                            device="cuda"):
        """Multi-view line refinement: every valid map line with >= 2
        keyframe observations (only those the newest keyframe observes,
        when there are any; the last `max_lines`) is re-triangulated on
        `device` from all its observation planes (left and right camera per
        stereo observation, at most `max_obs`), and written back where the
        solve is finite and the line still valid, the direction keeping the
        sign of the stored one. With `staged_retriangulation` (the
        pipelined tracker) the solve is queued and written back two
        keyframes later, as the JAX package's staged path does
        (`absorb_retriangulate(keep=1)` first); otherwise at once."""
        import torch
        from .. import tracing
        from ..geometry import lines as gl
        from ..ops.transfer import HostCopy

        if self.staged_retriangulation:
            self.absorb_retriangulate(keep=1)

        K = self.n_kf
        kf_idx, det_idx = np.nonzero(self.kf_ln_ids[:K] >= 0)
        if len(kf_idx) == 0:
            return
        lids = self.kf_ln_ids[kf_idx, det_idx]
        uniq, counts = np.unique(lids, return_counts=True)
        cand = uniq[(counts >= 2) & self.ln_valid[uniq]]
        if len(cand) == 0:
            return
        newest = self.kf_ln_ids[K - 1]
        fresh = np.intersect1d(cand, newest[newest >= 0])
        if len(fresh):
            cand = fresh
        cand = cand[-max_lines:]

        def plane(p1, p2, T_cw):
            """Plane normals and camera centres (plane_normal_from_obs)."""
            h1 = np.concatenate([p1, np.ones_like(p1[:, :1])], -1)
            h2 = np.concatenate([p2, np.ones_like(p2[:, :1])], -1)
            l = np.cross(h1, h2)
            cam = self.cam
            n_c = np.stack([cam.fx * l[:, 0], cam.fy * l[:, 1],
                            cam.cx * l[:, 0] + cam.cy * l[:, 1] + l[:, 2]], -1)
            R = T_cw[:, :3, :3]
            return (np.einsum("nji,nj->ni", R, n_c),
                    -np.einsum("nji,nj->ni", R, T_cw[:, :3, 3]))

        T_l = self.kf_pose[kf_idx]
        nL, cL = plane(self.kf_ln_p1[kf_idx, det_idx],
                       self.kf_ln_p2[kf_idx, det_idx], T_l)
        T_r = T_l.copy()
        T_r[:, 0, 3] -= self.cam.baseline      # T_rw = T_rl @ T_lw
        nR, cR = plane(self.kf_ln_p1r[kf_idx, det_idx],
                       self.kf_ln_p2r[kf_idx, det_idx], T_r)
        has_r = self.kf_ln_has_r[kf_idx, det_idx]

        # group the planes per candidate line (stable sort by slot; the
        # rank within the group is the plane column), padded to max_obs
        pos = np.full(self.max_ln, -1, np.int32)
        pos[cand] = np.arange(len(cand), dtype=np.int32)
        pi = pos[lids]
        selL = pi >= 0
        selR = selL & has_r
        rows_pi = np.concatenate([pi[selL], pi[selR]])
        rows_n = np.concatenate([nL[selL], nR[selR]]).astype(np.float32)
        rows_c = np.concatenate([cL[selL], cR[selR]]).astype(np.float32)
        order = np.argsort(rows_pi, kind="stable")
        rows_pi, rows_n, rows_c = rows_pi[order], rows_n[order], rows_c[order]
        col = np.arange(len(rows_pi)) - np.searchsorted(rows_pi, rows_pi)
        keep = col < max_obs
        n = len(cand)
        normals = np.zeros((n, max_obs, 3), np.float32)
        centers = np.zeros((n, max_obs, 3), np.float32)
        mask = np.zeros((n, max_obs), bool)
        normals[rows_pi[keep], col[keep]] = rows_n[keep]
        centers[rows_pi[keep], col[keep]] = rows_c[keep]
        mask[rows_pi[keep], col[keep]] = True
        def t(a):
            tracing.count("host_waits")    # a blocking upload from pageable
            return torch.from_numpy(a).to(device)
        X0, d, ok = gl.triangulate_multi_view(t(normals), t(centers), t(mask))
        solve = HostCopy(dict(X0=X0, d=d, ok=ok))
        self._pending_retri.append((cand, solve))
        if not self.staged_retriangulation:
            self.absorb_retriangulate()

    def absorb_retriangulate(self, keep: int = 0):
        """Write back the queued line solves but the newest `keep`."""
        while len(self._pending_retri) > keep:
            cand, solve = self._pending_retri.popleft()
            r = solve.result()
            good = (r["ok"] & np.isfinite(r["X0"]).all(-1)
                    & np.isfinite(r["d"]).all(-1) & self.ln_valid[cand])
            d = r["d"]
            d[np.sum(d * self.ln_dir[cand], -1) < 0] *= -1
            self.ln_x0[cand[good]] = r["X0"][good]
            self.ln_dir[cand[good]] = d[good]

    def create_points(self, kf_id: int, feat_idx: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """Allocate new map points observed by (kf_id, feat_idx). Returns ids."""
        m = len(feat_idx)
        if m > self.room_for_points(m):
            m = self.room_for_points(m)
            feat_idx, positions = feat_idx[:m], positions[:m]
        ids = np.arange(self.n_pt, self.n_pt + m, dtype=np.int32)
        self.pt_pos[ids] = positions
        self.pt_desc[ids] = self.kf_desc[kf_id, feat_idx]
        self.pt_valid[ids] = True
        self.pt_first_kf[ids] = kf_id
        self.pt_visible[ids] = 1
        self.pt_found[ids] = 1
        self.kf_pt_ids[kf_id, feat_idx] = ids
        self.n_pt += m
        self._obs_dirty = True
        # fresh points have exactly ONE observation (this kf/feat), so the
        # geometry init needs no obs-index pass — _update_point_geometry
        # here forced a full CSR rebuild per call (~13 ms x ~3 calls/KF,
        # the top host cost in the round-5 profile) for the same result
        T = self.kf_pose[kf_id]
        center = -T[:3, :3].T @ T[:3, 3]
        rays = positions - center
        d0 = np.linalg.norm(rays, axis=-1)
        self.pt_normal[ids] = (rays
                               / np.maximum(d0, 1e-9)[:, None]).astype(
                                   np.float32)
        sf = np.asarray(self.cfg.scale_factors(), np.float32)
        max_d = d0 * sf[self.kf_oct[kf_id, feat_idx]]
        self.pt_max_dist[ids] = 1.2 * max_d
        self.pt_min_dist[ids] = 0.8 * max_d / sf[-1]
        return ids

    # ------------------------------------------------------------------
    # observation-derived updates
    # ------------------------------------------------------------------

    def mark_obs_dirty(self):
        """Callers that write `kf_pt_ids` directly must invalidate the index."""
        self._obs_dirty = True

    def _rebuild_obs_index(self):
        import time as _time
        _t0 = _time.perf_counter()
        K = self.n_kf
        ids = self.kf_pt_ids[:K]
        kfi, fei = np.nonzero(ids >= 0)
        p = ids[kfi, fei]
        order = np.argsort(p, kind="stable")
        self._obs_pt = p[order]
        self._obs_kf = kfi[order].astype(np.int32)
        self._obs_fe = fei[order].astype(np.int32)
        # CSR offsets over LIVE ids only: a searchsorted over the full
        # max_pt capacity (1M after growth) cost ~30 ms per rebuild, at
        # keyframe rate — point ids are assigned sequentially so n_pt+1
        # offsets index every query _obs_rows_for can receive
        self._obs_hi = self.n_pt
        self._obs_start = np.searchsorted(
            self._obs_pt, np.arange(self._obs_hi + 1)).astype(np.int64)
        self._obs_dirty = False
        self.obs_rebuild_s = getattr(self, "obs_rebuild_s", 0.0) \
            + (_time.perf_counter() - _t0)
        self.obs_rebuild_n = getattr(self, "obs_rebuild_n", 0) + 1

    def _obs_rows_for(self, pt_ids: np.ndarray) -> np.ndarray:
        """CSR row indices of all observations of the given point ids."""
        if self._obs_dirty or (len(pt_ids)
                               and int(pt_ids.max()) >= self._obs_hi):
            self._rebuild_obs_index()
        starts = self._obs_start[pt_ids]
        cnt = self._obs_start[pt_ids + 1] - starts
        total = int(cnt.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        offs = np.cumsum(cnt) - cnt
        return np.repeat(starts - offs, cnt) + np.arange(total)

    def observations_of(self, pt_ids: np.ndarray):
        """(kf_idx, feat_idx) arrays of all observations of the given points
        among valid keyframes. Also returns the matching pt id per row."""
        rows = self._obs_rows_for(np.asarray(pt_ids))
        return self._obs_kf[rows], self._obs_fe[rows], self._obs_pt[rows]

    def n_obs(self, pt_ids: np.ndarray) -> np.ndarray:
        """Observation count per point; stereo observations count +2, mono +1
        (MapPoint::AddObservation, MapPoint.cc:96-115)."""
        pt_ids = np.asarray(pt_ids)
        kf_idx, feat_idx, obs_pt = self.observations_of(pt_ids)
        w = np.where(self.kf_ur[kf_idx, feat_idx] >= 0, 2, 1).astype(np.int32)
        uniq, inv = np.unique(pt_ids, return_inverse=True)
        pos = np.searchsorted(uniq, obs_pt)
        counts_u = np.zeros(len(uniq), np.int32)
        np.add.at(counts_u, pos, w)
        return counts_u[inv].reshape(pt_ids.shape)

    def refresh_obs_counts(self):
        """One vectorized pass over the observation table -> pt_nobs."""
        K = self.n_kf
        ids = self.kf_pt_ids[:K]
        sel = ids >= 0
        w = np.where(self.kf_ur[:K] >= 0, 2, 1).astype(np.int32)
        # bincount is ~10x np.add.at here (np.add.at's unbuffered gather-
        # scatter dominated the per-KF host profile at K≳10)
        counts = np.bincount(ids[sel], weights=w[sel],
                             minlength=self.max_pt)
        self.pt_nobs = counts.astype(np.int32)

    def _update_point_geometry(self, pt_ids: np.ndarray, max_obs: int = 12):
        """Recompute distinctive descriptor, viewing normal, scale range
        (MapPoint.cc:242-307, 330-383) for the given points.

        Fully vectorized (a per-point Python loop here dominated the per-
        keyframe host profile): observations are grouped by sorting, the
        descriptor median uses the first `max_obs` observations per point.
        """
        if len(pt_ids) == 0:
            return
        kf_idx, feat_idx, obs_pt = self.observations_of(pt_ids)
        if len(obs_pt) == 0:
            return
        order = np.argsort(obs_pt, kind="stable")
        kf_idx, feat_idx, obs_pt = kf_idx[order], feat_idx[order], obs_pt[order]
        uniq, starts, counts = np.unique(
            obs_pt, return_index=True, return_counts=True)
        K = self.n_kf
        Rt = np.transpose(self.kf_pose[:K, :3, :3], (0, 2, 1))
        centers = -np.einsum("kij,kj->ki", Rt, self.kf_pose[:K, :3, 3])

        # normals: mean unit ray over each point's observing KFs
        rays = self.pt_pos[obs_pt] - centers[kf_idx]
        rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-9)
        pos = np.searchsorted(uniq, obs_pt)
        sums = np.zeros((len(uniq), 3), np.float64)
        np.add.at(sums, pos, rays)
        nrm = sums / np.maximum(np.linalg.norm(sums, axis=-1, keepdims=True), 1e-9)
        self.pt_normal[uniq] = nrm.astype(np.float32)

        # scale range from the first (reference) observation
        scale_factors = np.asarray(self.cfg.scale_factors(), np.float32)
        k0, f0 = kf_idx[starts], feat_idx[starts]
        d0 = np.linalg.norm(self.pt_pos[uniq] - centers[k0], axis=-1)
        max_d = d0 * scale_factors[self.kf_oct[k0, f0]]
        min_d = max_d / scale_factors[-1]
        # +-20% slack folded into the stored gates (MapPoint.cc:376-383)
        self.pt_max_dist[uniq] = 1.2 * max_d
        self.pt_min_dist[uniq] = 0.8 * min_d

        # distinctive descriptor: min-median pairwise Hamming over (capped)
        # observations, batched via a padded (n, M, 8) gather
        M = int(min(max_obs, counts.max()))
        take = np.minimum(np.arange(M)[None, :], counts[:, None] - 1)
        gi = starts[:, None] + take
        descs = self.kf_desc[kf_idx[gi], feat_idx[gi]]       # (n, M, 8)
        mask = np.arange(M)[None, :] < counts[:, None]       # (n, M)
        x = descs[:, :, None, :] ^ descs[:, None, :, :]      # (n, M, M, 8)
        dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.float32)
        dist = np.where(mask[:, None, :], dist, np.nan)
        med = np.nanmedian(dist, axis=2)                     # (n, M)
        med = np.where(mask, med, np.inf)
        best = np.argmin(med, axis=1)
        self.pt_desc[uniq] = descs[np.arange(len(uniq)), best]

    def set_parent_from_covisibility(self, kf_id: int):
        """Spanning-tree link: parent = the most-covisible earlier keyframe
        (KeyFrame::UpdateConnections first-connection path,
        KeyFrame.cc:394-404)."""
        covis, counts = self.covisible_kfs(kf_id, min_shared=1)
        earlier = covis[covis < kf_id]
        if len(earlier):
            self.kf_parent[kf_id] = int(earlier[0])
        elif kf_id > 0:
            self.kf_parent[kf_id] = kf_id - 1

    def reparent_children(self, culled_kf: int):
        """On KF culling, children adopt the culled KF's parent (simplified
        from the reference's candidate search over covisible parents,
        KeyFrame.cc:503-558 — divergence documented: grandparent adoption
        keeps the tree connected with the same root)."""
        parent = self.kf_parent[culled_kf]
        kids = np.nonzero(self.kf_parent[: self.n_kf] == culled_kf)[0]
        self.kf_parent[kids] = parent

    def update_line_descriptors(self, ln_ids: np.ndarray | None = None,
                                max_obs: int = 8):
        """Distinctive line descriptor: the observation whose median L2
        distance to the others is minimal (MapLine::
        ComputeDistinctiveDescriptors, MapLine.cc:133-201), batched."""
        K = self.n_kf
        kf_idx, det_idx = np.nonzero(self.kf_ln_ids[:K] >= 0)
        if len(kf_idx) == 0:
            return
        lids = self.kf_ln_ids[kf_idx, det_idx]
        if ln_ids is not None:
            keep = np.isin(lids, ln_ids)
            kf_idx, det_idx, lids = kf_idx[keep], det_idx[keep], lids[keep]
            if len(lids) == 0:
                return
        order = np.argsort(lids, kind="stable")
        kf_idx, det_idx, lids = kf_idx[order], det_idx[order], lids[order]
        uniq, starts, counts = np.unique(lids, return_index=True,
                                         return_counts=True)
        M = int(min(max_obs, counts.max()))
        take = np.minimum(np.arange(M)[None, :], counts[:, None] - 1)
        gi = starts[:, None] + take
        descs = self.kf_ln_desc[kf_idx[gi], det_idx[gi]]   # (n, M, D)
        mask = np.arange(M)[None, :] < counts[:, None]
        d = np.linalg.norm(descs[:, :, None, :] - descs[:, None, :, :],
                           axis=-1)
        d = np.where(mask[:, None, :], d, np.nan)
        med = np.nanmedian(d, axis=2)
        med = np.where(mask, med, np.inf)
        best = np.argmin(med, axis=1)
        self.ln_desc[uniq] = descs[np.arange(len(uniq)), best]

    def covisible_kfs(self, kf_id: int, min_shared: int = 15, top: int | None = None):
        """Keyframes sharing >= min_shared map points with kf_id, sorted by
        count descending (KeyFrame::UpdateConnections semantics w/ th=15,
        KeyFrame.cc:353)."""
        import time as _time
        _t0 = _time.perf_counter()
        try:
            return self._covisible_kfs(kf_id, min_shared, top)
        finally:
            self.covis_s = getattr(self, "covis_s", 0.0) \
                + (_time.perf_counter() - _t0)
            self.covis_n = getattr(self, "covis_n", 0) + 1

    def _covisible_kfs(self, kf_id: int, min_shared: int = 15,
                       top: int | None = None):
        K = self.n_kf
        mine = self.kf_pt_ids[kf_id]
        mine_set = np.unique(mine[mine >= 0])
        if len(mine_set) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        rows = self._obs_rows_for(mine_set)
        shared = np.bincount(self._obs_kf[rows], minlength=K)[:K].astype(np.int32)
        shared[kf_id] = 0
        shared[~self.kf_valid[:K]] = 0
        order = np.argsort(-shared)
        sel = order[shared[order] >= min_shared]
        if len(sel) == 0 and shared.max() > 0:
            sel = order[:1]  # keep the best one (reference keeps max peer)
        if top is not None:
            sel = sel[:top]
        return sel.astype(np.int32), shared[sel]

    def cull_points(self, pt_ids: np.ndarray, current_kf: int):
        """MapPointCulling (LocalMapping.cc:171-206): cull recently created
        points with found/visible < 0.25, or too few observations 2 KFs after
        creation."""
        pt_ids = np.asarray(pt_ids)
        pt_ids = pt_ids[self.pt_valid[pt_ids]]
        if len(pt_ids) == 0:
            return pt_ids
        nobs = self.pt_nobs[pt_ids]
        ratio = self.pt_found[pt_ids] / np.maximum(self.pt_visible[pt_ids], 1)
        age = current_kf - self.pt_first_kf[pt_ids]
        bad = (ratio < 0.25) | ((age >= 2) & (nobs <= 3))
        culled = pt_ids[bad]
        self.remove_points(culled)
        return culled.astype(np.int32)

    def remove_points(self, pt_ids: np.ndarray):
        """Batch removal: one pass over the observation table."""
        pt_ids = np.asarray(pt_ids)
        if len(pt_ids) == 0:
            return
        self.pt_valid[pt_ids] = False
        rows = self._obs_rows_for(pt_ids)
        self.kf_pt_ids[self._obs_kf[rows], self._obs_fe[rows]] = -1
        self._obs_dirty = True

    def remove_point(self, p: int):
        self.remove_points(np.array([p]))

    # ------------------------------------------------------------------
    # views for device compute
    # ------------------------------------------------------------------

    def camera_center(self, kf_id: int) -> np.ndarray:
        T = self.kf_pose[kf_id]
        return -T[:3, :3].T @ T[:3, 3]

    def local_window(self, kf_id: int, max_kf: int = 16):
        """Covisibility window for local BA: (local_kfs, fixed_kfs).
        Local = kf_id + top covisible; fixed = other KFs observing local
        points (Optimizer.cc:988-1018). Gauge: fixed set, or oldest local."""
        covis, _ = self.covisible_kfs(kf_id, min_shared=15, top=max_kf - 1)
        local = np.concatenate([[kf_id], covis]).astype(np.int32)
        local_pts = np.unique(self.kf_pt_ids[local])
        local_pts = local_pts[local_pts >= 0]
        kf_idx, _, _ = self.observations_of(local_pts)
        all_kfs = np.unique(kf_idx)
        fixed = np.setdiff1d(all_kfs, local).astype(np.int32)
        return local, fixed, local_pts
