"""Deterministic local mapping: the keyframe-rate map update + local BA.

Counterpart of lldslam_tpu/pipeline/local_mapping.py, synchronous path and
points only. `process_keyframe` runs, in the reference LocalMapping order:

    recent-point culling -> epipolar triangulation + duplicate fusion
    (one device stage, `mapper_fast.kf_stage_cached`) -> host writeback
    -> windowed local BA with on-device tracking-view assembly
    (`mapper_fast.ba_view_cached`) -> outlier observation erasure
    -> keyframe culling.

The JAX package's dispatch/absorb pairs, IO thread pools, packed buffers and
adaptive BA cadence serve its pipelined tracker over a slow host link; here
the stages are direct calls on tensors. As there, fusion projects the
keyframe's pre-triangulation points, and the BA window is padded to fixed
capacities (k_local + k_fixed keyframes, a point bucket, an observation
bucket) so every keyframe's BA has one of a few shapes.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..config import SlamConfig
from ..frontend import matching
from ..slammap.map_store import MapStore
from . import mapper_fast
from .kf_cache import KfCache

TRI_NEIGHBOURS = 3     # covisible keyframes triangulated against (B1 - 1)
FUSE_NEIGHBOURS = 2    # covisible keyframes fused into (B2)
FUSE_VIEW_CAP = 2048   # points of the new keyframe projected for fusion


def view_capacity(n_points: int) -> int:
    """Padded size of the tracker's local-map view: 2048 rows, or 4096 once
    the neighbourhood outgrows 2048 (two shapes for K2 and the gates)."""
    return 2048 if n_points <= 2048 else 4096


class LocalMapper:
    def __init__(self, store: MapStore, cfg: SlamConfig, k_local: int = 16,
                 k_fixed: int = 8, p_cap: int = 8192, o_cap: int = 24576,
                 cache: KfCache | None = None, device="cpu"):
        self.store = store
        self.cfg = cfg
        self.cam = store.cam
        self.device = torch.device(device)
        self.k_local = k_local
        self.k_fixed = k_fixed
        self.k_cap = k_local + k_fixed
        self.p_cap = p_cap
        self.o_cap = o_cap
        # point-capacity buckets, grown monotonically as the map grows
        self.p_buckets = [b for b in (1024, 2048, 4096, 8192) if b <= p_cap]
        if not self.p_buckets or self.p_buckets[-1] != p_cap:
            self.p_buckets.append(p_cap)
        self._p_bucket = self.p_buckets[0]
        self._recent: deque = deque(maxlen=3)  # (kf_id, created point ids)
        self._inv_sigma2 = np.power(
            1.0 / store.cfg.scale ** 2, np.arange(store.cfg.n_levels)
        ).astype(np.float32)
        self._lut_dev = torch.from_numpy(self._inv_sigma2).to(self.device)
        self.stage_times: dict[str, float] = {}
        self.cache = cache or KfCache(n_slots=32, n_kp=store.n_kp,
                                      device=self.device)

    # ------------------------------------------------------------------

    def _time(self, key: str, t0: float) -> float:
        now = time.perf_counter()
        self.stage_times[key] = self.stage_times.get(key, 0.0) + (now - t0)
        return now

    def cache_frame(self, kf_id: int, feats) -> int:
        """Register a new keyframe's device feature tensors in the cache."""
        return self.cache.put(kf_id, feats)

    def ensure_cached(self, kf_ids) -> np.ndarray:
        """Slots for the given keyframes, uploading evicted ones from the
        host store (only old keyframes re-entering a window)."""
        s = self.store
        slots = self.cache.slots_of(kf_ids)
        for i, kf in enumerate(kf_ids):
            if slots[i] < 0:
                kf = int(kf)
                self.stage_times["n_cache_miss"] = self.stage_times.get(
                    "n_cache_miss", 0) + 1
                t = lambda a: torch.from_numpy(np.ascontiguousarray(a)) \
                    .to(self.device)
                feats = matching.FrameFeatures(
                    xy=t(s.kf_xy[kf]), ur=t(s.kf_ur[kf]),
                    octave=t(s.kf_oct[kf].astype(np.int32)),
                    angle=t(s.kf_angle[kf]),
                    desc=t(s.kf_desc[kf].view(np.int32)),
                    valid=t(s.kf_kp_valid[kf]))
                slots[i] = self.cache.put(kf, feats)
        return slots

    def note_created(self, kf_id: int, pt_ids: np.ndarray):
        self._recent.append((kf_id, np.asarray(pt_ids)))

    def process_keyframe(self, kf_id: int):
        """The LocalMapping::Run loop body, synchronous. Returns the post-BA
        (MapPointView, view point ids) for the tracker, or None when BA was
        skipped."""
        self._kf_stage(kf_id)
        prep = self._prepare_ba(kf_id)
        if prep is None:
            return None
        return self._run_ba(kf_id, prep)

    # ------------------------------------------------------------------

    def _kf_stage(self, kf_id: int):
        """Culling, triangulation + fusion on the device, host writeback."""
        t0 = time.perf_counter()
        s = self.store
        dev = self.device
        s.refresh_obs_counts()
        # newly created points of this KF enter the culling probation window
        row = s.kf_pt_ids[kf_id]
        new_ids = row[(row >= 0) & (s.pt_first_kf[row.clip(0)] == kf_id)]
        self.note_created(kf_id, new_ids)
        recent = [ids for _, ids in self._recent if len(ids)]
        if recent:
            s.cull_points(np.concatenate(recent), current_kf=kf_id)
        covis, _ = s.covisible_kfs(kf_id, min_shared=15, top=10)
        nbs_tri = [int(nb) for nb in covis[:TRI_NEIGHBOURS]]
        nbs_fuse = [int(nb) for nb in covis[:FUSE_NEIGHBOURS]]
        slots = [int(x) for x in self.ensure_cached([kf_id] + nbs_tri + nbs_fuse)]
        # fuse view: this KF's current points
        my = row[row >= 0]
        pids = np.unique(my)
        pids = pids[s.pt_valid[pids]][-FUSE_VIEW_CAP:]
        free_tri = np.stack([s.kf_kp_valid[k] & (s.kf_pt_ids[k] < 0)
                             for k in [kf_id] + nbs_tri])
        valid_fuse = np.stack([s.kf_kp_valid[k] for k in nbs_fuse]) \
            if nbs_fuse else np.zeros((0, s.n_kp), bool)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        view = mapper_fast.view_from_store(s, pids, FUSE_VIEW_CAP, dev)
        tri, fuse = mapper_fast.kf_stage_cached(
            self.cam, self.cache.arrays, slots[:1 + len(nbs_tri)],
            t(s.kf_pose[[kf_id] + nbs_tri]), t(free_tri),
            slots[1 + len(nbs_tri):], t(s.kf_pose[nbs_fuse]), t(valid_fuse),
            view, self._lut_dev, s.cfg.n_levels, s.cfg.scale)
        t1 = self._time("dispatch_kf", t0)

        created: list[int] = []
        claimed = np.zeros(s.n_kp, bool)
        for (_, match, X), nb in zip(tri, nbs_tri):
            match, X = match.cpu().numpy(), X.cpu().numpy()
            sel = np.nonzero((match >= 0) & ~claimed)[0]
            if len(sel) == 0:
                continue
            sel = sel[: s.room_for_points(len(sel))]
            if len(sel) == 0:
                break
            ids = s.create_points(kf_id, sel, X[sel])
            s.kf_pt_ids[nb, match[sel]] = ids  # second observation
            s.mark_obs_dirty()
            claimed[sel] = True
            created.extend(ids.tolist())
        if created:
            self.note_created(kf_id, np.asarray(created, np.int32))
            s.refresh_obs_counts()
        t2 = self._time("triangulate", t1)
        pid_arr = np.concatenate(
            [pids, np.full(FUSE_VIEW_CAP - len(pids), -1, np.int64)])
        self._fuse_writeback([kp2pt.cpu().numpy() for _, kp2pt in fuse],
                             pid_arr, nbs_fuse)
        self._time("fuse", t2)
        self.stage_times["n"] = self.stage_times.get("n", 0) + 1

    def _fuse_writeback(self, fuse_kp2pt, pid_arr, nbs_fuse):
        """Fusion writeback (ORBmatcher::Fuse semantics), vectorized per
        neighbour: fill unassociated features, merge duplicates (the
        most-observed point survives)."""
        s = self.store
        merges: list[tuple[int, int]] = []
        for kp2pt, nb in zip(fuse_kp2pt, nbs_fuse):
            hit = np.nonzero(kp2pt >= 0)[0]
            if len(hit) == 0:
                continue
            p = pid_arr[kp2pt[hit]].astype(np.int64)
            good = (p >= 0) & s.pt_valid[np.maximum(p, 0)]
            hit, p = hit[good], p[good]
            row = s.kf_pt_ids[nb]
            q = row[hit]
            # never give one KF two features on the same point
            new_m = q < 0
            if new_m.any():
                cand_hit, cand_p = hit[new_m], p[new_m]
                ok = ~np.isin(cand_p, row[row >= 0])
                first = np.zeros(len(cand_p), bool)
                first[np.unique(cand_p, return_index=True)[1]] = True
                ok &= first
                if ok.any():
                    row[cand_hit[ok]] = cand_p[ok]
                    s.mark_obs_dirty()
            mer = (q >= 0) & (q != p) & s.pt_valid[np.maximum(q, 0)]
            for pp, qq in zip(p[mer], q[mer]):
                keep, drop = ((int(pp), int(qq))
                              if s.pt_nobs[pp] >= s.pt_nobs[qq]
                              else (int(qq), int(pp)))
                merges.append((keep, drop))
        merged = False
        if merges:
            target: dict[int, int] = {}
            for keep, drop in merges:
                while keep in target:
                    keep = target[keep]
                if keep != drop and drop not in target:
                    target[drop] = keep
            if target:
                def _resolve(x: int) -> int:
                    while x in target:
                        x = target[x]
                    return x
                drops = np.fromiter(target.keys(), np.int64, len(target))
                keeps = np.fromiter((_resolve(v) for v in target.values()),
                                    np.int64, len(target))
                order = np.argsort(drops)
                drops, keeps = drops[order], keeps[order]
                s.pt_valid[drops] = False
                ids = s.kf_pt_ids[:s.n_kf]
                m = np.isin(ids, drops)
                ids[m] = keeps[np.searchsorted(drops, ids[m])]
                s.mark_obs_dirty()
                merged = True
        if merged:
            # a merge can leave a KF observing `keep` on two features; keep
            # the first slot per (KF, point)
            ids = s.kf_pt_ids[:s.n_kf]
            big = np.iinfo(np.int32).max
            srt = np.sort(np.where(ids >= 0, ids, big), axis=1)
            has_dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != big)
            for k in np.nonzero(has_dup.any(axis=1))[0]:
                row = ids[k]
                seen: set[int] = set()
                for i in np.nonzero(row >= 0)[0]:
                    v = int(row[i])
                    if v in seen:
                        row[i] = -1
                    else:
                        seen.add(v)
            s.mark_obs_dirty()
        s.refresh_obs_counts()

    # ------------------------------------------------------------------

    def _o_bkt(self, p_bkt: int) -> int:
        return max(self.o_cap // self.p_cap, 1) * p_bkt

    def _prepare_ba(self, kf_id: int):
        """Eligibility check + padded problem tensors for this keyframe's
        windowed BA; None (after keyframe culling) when BA is skipped."""
        t0 = time.perf_counter()
        s = self.store
        if s.n_kf < 2:
            self.cull_keyframes(kf_id)
            return None
        meta = self._build_problem_np(kf_id)
        if meta is None:
            self.cull_keyframes(kf_id)
            return None
        # tracking view selection (UpdateLocalPoints)
        view_pids = self._select_view_pids(kf_id)
        tv_cap = view_capacity(len(view_pids))
        if len(view_pids) > tv_cap:
            self.stage_times["view_dropped"] = self.stage_times.get(
                "view_dropped", 0) + (len(view_pids) - tv_cap)
            view_pids = view_pids[-tv_cap:]  # ascending weight: keep strongest
        pt_lut = np.full(s.max_pt, -1, np.int32)
        pt_lut[meta["pts"]] = np.arange(len(meta["pts"]), dtype=np.int32)
        window, n_free, pts = meta["window"], meta["n_free"], meta["pts"]
        slots = self.ensure_cached(window)
        K, P, O = self.k_cap, meta["p_bkt"], self._o_bkt(meta["p_bkt"])
        slots_pad = np.zeros(K, np.int64)
        slots_pad[:len(slots)] = slots
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        poses[:len(window)] = s.kf_pose[window]
        fixed = np.ones(K, bool)
        fixed[:n_free] = False
        points = np.zeros((P, 3), np.float32)
        points[:len(pts)] = s.pt_pos[pts]
        pvalid = np.zeros(P, bool)
        pvalid[:len(pts)] = s.pt_valid[pts]
        n_obs = meta["n_obs"]
        obs = np.zeros((3, O), np.int64)
        obs[:, :n_obs] = (meta["okf"], meta["ofe"], meta["p_idx"])
        tv_pidx = np.full(tv_cap, -1, np.int64)
        tv_pidx[:len(view_pids)] = pt_lut[view_pids]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        prep = dict(
            meta=meta, slots=t(slots_pad), poses=t(poses), fixed=t(fixed),
            points=t(points), pvalid=t(pvalid), obs=t(obs), n_obs=n_obs,
            tv_pidx=t(tv_pidx),
            tv=mapper_fast.view_from_store(s, view_pids, tv_cap, self.device),
            vp=np.concatenate([view_pids,
                               np.full(tv_cap - len(view_pids), -1, np.int64)]))
        self._time("dba_build", t0)
        return prep

    def _run_ba(self, kf_id: int, prep: dict):
        """Windowed BA on the device, then writeback + outlier erasure +
        keyframe culling. Returns (post-BA view, view point ids)."""
        t0 = time.perf_counter()
        obs = prep["obs"]
        poses, points, keep, view = mapper_fast.ba_view_cached(
            self.cam, self.cache.arrays, prep["slots"], prep["poses"],
            prep["fixed"], prep["points"], prep["pvalid"], obs[0], obs[1],
            obs[2], prep["n_obs"], self._lut_dev, prep["tv_pidx"], prep["tv"])
        self._writeback_ba(kf_id, prep["meta"], poses.cpu().numpy(),
                           points.cpu().numpy(), keep.cpu().numpy())
        self._time("ba", t0)
        return view, prep["vp"]

    def _writeback_ba(self, kf_id: int, meta: dict, poses, points, keep):
        """BA writeback + outlier erasure + keyframe culling."""
        s = self.store
        window, n_free, pts = meta["window"], meta["n_free"], meta["pts"]
        s.kf_pose[window[:n_free]] = poses[:n_free]
        s.pt_pos[pts] = points[: len(pts)]
        O = meta["n_obs"]
        bad = ~keep[:O]
        if bad.any():
            s.kf_pt_ids[meta["kf_abs"][bad], meta["ofe"][bad]] = -1
            s.mark_obs_dirty()
            # points that lost every observation die
            dead_cand = np.unique(pts[np.unique(meta["p_idx"][:O][bad])])
            if len(dead_cand):
                s.refresh_obs_counts()
                s.remove_points(dead_cand[s.pt_nobs[dead_cand] == 0])
        self.cull_keyframes(kf_id)

    def _select_view_pids(self, kf_id: int) -> np.ndarray:
        """Local-map point ids for the tracker's view (points of the
        reference KF's covisibility neighbourhood), sorted by ascending
        covisibility weight so a tail truncation keeps the strongest."""
        s = self.store
        covis, _ = s.covisible_kfs(kf_id, min_shared=15, top=19)
        local_kfs = np.concatenate([[kf_id], covis]).astype(np.int32)
        raw = s.kf_pt_ids[local_kfs]
        raw = raw[raw >= 0]
        counts = np.bincount(raw, minlength=s.max_pt)
        ids = np.unique(raw)
        ids = ids[s.pt_valid[ids]]
        order = np.argsort(counts[ids], kind="stable")
        return ids[order]

    # ------------------------------------------------------------------

    def cull_keyframes(self, kf_id: int):
        """Redundant-KF culling: a covisible KF dies when >= 90% of its
        tracked points are seen by at least 3 other keyframes; culled KFs
        keep their pose but stop contributing observations."""
        s = self.store
        covis, _ = s.covisible_kfs(kf_id, min_shared=15)
        if len(covis) == 0:
            return
        ids = s.kf_pt_ids[:s.n_kf]
        sel = ids >= 0
        obs_kf = np.bincount(ids[sel], minlength=s.max_pt).astype(np.int32)
        for k in covis:
            k = int(k)
            if k == 0 or k == kf_id or not s.kf_valid[k]:
                continue
            pts = s.kf_pt_ids[k]
            pts = pts[pts >= 0]
            if len(pts) == 0:
                continue
            if (obs_kf[pts] >= 4).mean() >= 0.9:  # 3 others + itself
                obs_kf[pts] -= 1
                s.kf_pt_ids[k] = -1
                s.kf_ln_ids[k] = -1
                s.kf_valid[k] = False
                s.reparent_children(k)
                s.mark_obs_dirty()
        s.refresh_obs_counts()

    # ------------------------------------------------------------------

    def _window_and_obs(self, kf_id: int):
        """Window keyframes (free + fixed anchors) and the observation table
        (numpy), with the point/observation buckets."""
        s = self.store
        local, fixed, local_pts = s.local_window(kf_id, max_kf=self.k_local)
        if len(fixed) > self.k_fixed:
            # keep the fixed KFs anchoring the most window observations
            counts = (np.isin(s.kf_pt_ids[fixed], local_pts)
                      & (s.kf_pt_ids[fixed] >= 0)).sum(axis=1)
            fixed = fixed[np.argsort(-counts)[: self.k_fixed]]
        if len(fixed) == 0 and len(local) > 1:
            # gauge: freeze the oldest local KF
            fixed = local[-1:]
            local = local[:-1]
        window = np.concatenate([local, fixed]).astype(np.int32)
        n_free = len(local)
        obs_ratio = max(self.o_cap // self.p_cap, 1)
        if len(local_pts) > self.p_buckets[-1]:
            self.stage_times["ba_pts_dropped"] = self.stage_times.get(
                "ba_pts_dropped", 0) + (len(local_pts) - self.p_buckets[-1])
            local_pts = local_pts[-self.p_buckets[-1]:]
        pts = local_pts.astype(np.int32)
        # every (window KF, feature) slot pointing into pts; fixed anchors
        # first so a tail truncation never drops them
        pt_lut = np.full(s.max_pt, -1, np.int32)
        pt_lut[pts] = np.arange(len(pts), dtype=np.int32)
        okf, ofe = [], []
        order = list(range(n_free, len(window))) + list(range(n_free))
        for wi in order:
            ids_k = s.kf_pt_ids[window[wi]]
            sel = np.nonzero(pt_lut[ids_k.clip(0)] >= 0)[0]
            sel = sel[ids_k[sel] >= 0]
            # one observation per (KF, point)
            _, first = np.unique(pt_lut[ids_k[sel]], return_index=True)
            sel = sel[np.sort(first)]
            okf.append(np.full(len(sel), wi, np.int32))
            ofe.append(sel.astype(np.int32))
        okf = np.concatenate(okf)
        ofe = np.concatenate(ofe)
        while self._p_bucket < self.p_buckets[-1] and (
                len(pts) > self._p_bucket
                or len(okf) > obs_ratio * self._p_bucket):
            self._p_bucket = self.p_buckets[
                self.p_buckets.index(self._p_bucket) + 1]
        p_bkt = self._p_bucket
        o_bkt = obs_ratio * p_bkt
        if len(pts) > p_bkt:
            pts = pts[-p_bkt:]
            pt_lut[:] = -1
            pt_lut[pts] = np.arange(len(pts), dtype=np.int32)
            keep = pt_lut[s.kf_pt_ids[window[okf], ofe]] >= 0
            okf, ofe = okf[keep], ofe[keep]
        if len(okf) > o_bkt:
            self.stage_times["ba_obs_dropped"] = self.stage_times.get(
                "ba_obs_dropped", 0) + (len(okf) - o_bkt)
            okf, ofe = okf[:o_bkt], ofe[:o_bkt]
        kf_abs = window[okf]
        p_idx = pt_lut[s.kf_pt_ids[kf_abs, ofe]]
        return dict(window=window, n_free=n_free, pts=pts, p_bkt=p_bkt,
                    okf=okf, ofe=ofe, kf_abs=kf_abs, p_idx=p_idx,
                    n_obs=len(okf))

    def _build_problem_np(self, kf_id: int):
        meta = self._window_and_obs(kf_id)
        if meta["n_obs"] < 30 or len(meta["pts"]) == 0:
            return None
        return meta
