"""Deterministic local mapping: the keyframe-rate map update + local BA.

Counterpart of lldslam_tpu/pipeline/local_mapping.py. `process_keyframe`
(the synchronous tracker) runs, in the reference LocalMapping order:

    recent-point culling -> epipolar triangulation + duplicate fusion
    (one device stage, `mapper_fast.kf_stage_cached`) -> host writeback
    -> windowed local BA with on-device tracking-view assembly
    (`mapper_fast.ba_view_cached`; with lines on, the joint point+line BA
    `mapper_fast.joint_ba_view_cached` over the window's map lines, at most
    `l_cap` lines and `lo_cap` line observations, the overflow counted in
    `stage_times["ln_obs_dropped"]`) -> outlier observation erasure (line
    observations too) -> keyframe culling (a culled keyframe's line
    observations go with its point observations).

The pipelined tracker uses the staged API instead, one step per finalized
frame: `dispatch_kf_stage(kf, voc, fuse_ba=True)` queues the keyframe's
triangulation + fusion, its BoW words (the loop closer's vocabulary
descended on the cached device descriptors) and its windowed BA built from
the store as it is at keyframe creation (this keyframe's triangulations
join the next window), with the results' host copy behind one event
(ops/transfer.HostCopy); `step_pending` absorbs a stage at the first
finalized frame after its dispatch (writeback, `absorbed_words`), a
standalone `dispatch_ba` at the second; `flush` absorbs everything. The
post-BA view is `pending_view` (the JAX package's `pending_view_fut`, here
a plain attribute: its tensors are ordered after the BA on the device).
A BA is skipped while another is in flight, and, with
`adaptive_ba_cadence` (pipelined mode), unless 6 frames separate it from
the last one once the map has more than 4 keyframes. The JAX package
absorbs a stage when its fetch has landed; here the absorb points are
fixed, so the schedule does not depend on timing. Its IO thread pools and
flat int32 buffers have no counterpart: the stages take and return tensors.

As in the JAX package, fusion projects the keyframe's pre-triangulation
points, and the BA window is padded to fixed capacities (k_local + k_fixed
keyframes, a point bucket, an observation bucket) so every keyframe's BA
has one of a few shapes.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .. import tracing
from ..config import SlamConfig
from ..frontend import matching
from ..ops.transfer import HostCopy, upload
from ..optim import lines_ba
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
                 cache: KfCache | None = None, device="cuda"):
        self.store = store
        self.cfg = cfg
        self.cam = store.cam
        self.device = torch.device(device)
        self.k_local = k_local
        self.k_fixed = k_fixed
        self.k_cap = k_local + k_fixed
        self.p_cap = p_cap
        self.o_cap = o_cap
        # joint BA window: at most 512 lines and 2048 line observations
        self.l_cap = 512
        self.lo_cap = 2048
        self.enable_lines = cfg.line.enabled
        # point-capacity buckets, grown monotonically as the map grows
        self.p_buckets = [b for b in (1024, 2048, 4096, 8192) if b <= p_cap]
        if not self.p_buckets or self.p_buckets[-1] != p_cap:
            self.p_buckets.append(p_cap)
        self._p_bucket = self.p_buckets[0]
        self._recent: deque = deque(maxlen=3)  # (kf_id, created point ids)
        self._inv_sigma2 = np.power(
            1.0 / store.cfg.scale ** 2, np.arange(store.cfg.n_levels)
        ).astype(np.float32)
        tracing.count("host_waits")     # a blocking upload from pageable
        self._lut_dev = torch.from_numpy(self._inv_sigma2).to(self.device)
        # called with each culled keyframe id (the tracker points it at the
        # loop closer's KeyFrameDatabase.erase)
        self.on_kf_culled = None
        self.stage_times: dict[str, float] = {}
        self.cache = cache or KfCache(n_slots=32, n_kp=store.n_kp,
                                      device=self.device)
        # when set, the tracking view always pads to this capacity (the
        # multi-sequence driver needs one view shape across sequences)
        self.fixed_tv_cap: int | None = None
        # staged work (pipelined tracker): queued keyframe stages, a
        # standalone BA and its age in finalized frames, the post-BA view
        # and the absorbed stage's BoW words (kf_id, words)
        self._pending_kfq: deque = deque()
        self._pending_ba: dict | None = None
        self._ba_age = 0
        self.pending_view = None
        self.absorbed_words: tuple | None = None
        self.adaptive_ba_cadence = False
        self._last_ba_frame = -(1 << 30)

    # ------------------------------------------------------------------

    def _span(self, key: str) -> tracing.span:
        """A span `mapper.<key>` whose seconds add to stage_times[key]."""
        return tracing.span("mapper." + key, self.stage_times, key)

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
                t = lambda a: upload(a, self.device)
                feats = matching.FrameFeatures(
                    xy=t(s.kf_xy[kf]), ur=t(s.kf_ur[kf]),
                    octave=t(s.kf_oct[kf].astype(np.int32)),
                    angle=t(s.kf_angle[kf]),
                    desc=t(s.kf_desc[kf].view(np.int32)),
                    valid=t(s.kf_kp_valid[kf]))
                slots[i] = self.cache.put(kf, feats)
        return slots

    def warmup(self, voc=None):
        """Run the keyframe-rate device work once on dummy inputs, at the
        mapper's shapes: the keyframe stage (triangulation against one
        neighbour, fusion into one), the windowed BA (k_cap keyframes, the
        first point bucket and its observation bucket, the tracking view's
        capacity) or, with lines on, the joint point+line BA with l_cap
        lines and lo_cap line observations instead (the JAX package's
        `_warmup_lines`), and with `voc` one BoW descent. It keeps a
        process's first-call costs (CUDA modules, solver handles, the
        allocator's first blocks) out of the first keyframe. The dummy
        inputs read cache slot 0; the store, the cache, the mapper's state
        and every generator stay as they were. Waits for the card at the
        end."""
        s, dev, c = self.store, self.device, self.cache.arrays
        N = s.n_kp
        t = lambda a: upload(a, dev)
        eye = lambda n: t(np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)))
        ones = lambda *shape: t(np.ones(shape, bool))
        no_pids = np.zeros(0, np.int64)
        mapper_fast.kf_stage_cached(
            self.cam, c, [0, 0], eye(2), ones(2, N), [0], eye(1), ones(1, N),
            mapper_fast.view_from_store(s, no_pids, FUSE_VIEW_CAP, dev),
            self._lut_dev, s.cfg.n_levels, s.cfg.scale)
        if voc is not None:
            voc.device_words(c.desc[0], c.valid[0])
        K, P = self.k_cap, self.p_buckets[0]
        O = self._o_bkt(P)
        tv_cap = self.fixed_tv_cap or view_capacity(0)
        fixed = np.zeros(K, bool)
        fixed[self.k_local:] = True
        obs = np.stack([np.arange(O) % K, np.arange(O) % N, np.arange(O) % P])
        points = np.zeros((P, 3), np.float32)
        points[:, 2] = 10.0
        args = (self.cam, c, t(np.zeros(K, np.int64)), eye(K), t(fixed),
                t(points), ones(P), *t(obs), O // 2, self._lut_dev,
                t(np.full(tv_cap, -1, np.int64)),
                mapper_fast.view_from_store(s, no_pids, tv_cap, dev))
        if self.enable_lines:
            LC, LO = self.l_cap, self.lo_cap
            xy = t(np.zeros((LO, 2), np.float32))
            lobs = lines_ba.LineBAObs(
                k=t(np.arange(LO) % K), l=t(np.arange(LO) % LC), x1l=xy,
                x2l=xy, x1r=xy, x2r=xy, octave=t(np.zeros(LO, np.int32)),
                has_r=ones(LO), valid=t(np.arange(LO) < LO // 2))
            mapper_fast.joint_ba_view_cached(
                *args, t(np.zeros((LC, 3), np.float32)),
                t(np.tile(np.float32([1, 0, 0]), (LC, 1))), ones(LC), lobs,
                gamma=float(self.cfg.line.gamma))
        else:
            mapper_fast.ba_view_cached(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def note_created(self, kf_id: int, pt_ids: np.ndarray):
        self._recent.append((kf_id, np.asarray(pt_ids)))

    def process_keyframe(self, kf_id: int):
        """The LocalMapping::Run loop body, synchronous. Returns the post-BA
        (MapPointView, view point ids) for the tracker, or None when BA was
        skipped."""
        self.flush()
        stage, out = self._launch_stage(kf_id)
        self._stage_writeback(stage, HostCopy(out).result())
        prep = self._prepare_ba(kf_id)
        if prep is None:
            return None
        return self._run_ba(kf_id, prep)

    # ------------------------------------------------------------------
    # staged API (pipelined tracker)

    @property
    def busy(self) -> bool:
        return bool(self._pending_kfq) or self._pending_ba is not None

    def step_pending(self):
        """One step per finalized frame: absorb the oldest keyframe stage
        (then, when its BA was not fused, dispatch that BA); else age the
        standalone BA and absorb it at age 2."""
        if self._pending_kfq:
            self._absorb_head()
        elif self._pending_ba is not None:
            self._ba_age += 1
            if self._ba_age >= 2:
                self.absorb_ba()

    def flush(self):
        """Absorb all staged work now."""
        while self._pending_kfq:
            self._absorb_head()
        if self._pending_ba is not None:
            self.absorb_ba()

    def _absorb_head(self):
        kf_id = self._pending_kfq[0]["kf_id"]
        if not self.absorb_kf_stage()["fused"]:
            self.dispatch_ba(kf_id)

    def dispatch_kf_stage(self, kf_id: int, voc=None, fuse_ba: bool = False):
        """Queue the keyframe's stage on the device: culling and the stage
        inputs on the host, triangulation + fusion, the BoW words of its
        cached descriptors when `voc` (a Vocabulary) is given, and with
        `fuse_ba` its windowed BA (problem built now, before this stage's
        writeback) whose post-BA view becomes `pending_view`. A third
        queued stage forces the oldest's absorb."""
        with self._span("dispatch_kf_staged"):
            while len(self._pending_kfq) >= 2:
                self._absorb_head()
            stage, out = self._launch_stage(kf_id)
            if voc is not None:
                c = self.cache.arrays
                s0 = stage["slots"][0]
                out["words"] = voc.device_words(c.desc[s0], c.valid[s0])
            prep = self._prepare_ba(kf_id) if fuse_ba else None
            if prep is not None:
                ba_out = self._launch_ba(prep)
                self.pending_view = (ba_out.pop("view"), prep["vp"])
                out["ba"] = ba_out
            stage.update(fused=fuse_ba, ba=prep, host=HostCopy(out))
            self._pending_kfq.append(stage)

    def absorb_kf_stage(self) -> dict:
        """Write back the oldest queued stage (triangulated points, fusion,
        and its fused BA); its words go to `absorbed_words`."""
        stage = self._pending_kfq.popleft()
        out = stage["host"].result()
        self.absorbed_words = ((stage["kf_id"], out["words"])
                               if "words" in out else None)
        self._stage_writeback(stage, out)
        if stage["ba"] is not None:
            self._ba_writeback(stage["kf_id"], stage["ba"], out["ba"])
        return stage

    def dispatch_ba(self, kf_id: int):
        """Queue this keyframe's windowed BA alone (when eligible); its
        post-BA view becomes `pending_view`, its writeback waits for
        `absorb_ba`. Returns (view, view point ids) or None."""
        prep = self._prepare_ba(kf_id)
        if prep is None:
            return None
        out = self._launch_ba(prep)
        self.pending_view = (out.pop("view"), prep["vp"])
        self._pending_ba = dict(kf_id=kf_id, prep=prep, host=HostCopy(out))
        self._ba_age = 0
        return self.pending_view

    def absorb_ba(self):
        """Write back the standalone BA."""
        rec, self._pending_ba = self._pending_ba, None
        self._ba_writeback(rec["kf_id"], rec["prep"], rec["host"].result())

    def _ba_inflight(self) -> bool:
        """A BA dispatched and not yet written back: the standalone one
        before its absorb age, or one fused into a queued stage."""
        if self._pending_ba is not None and self._ba_age < 2:
            return True
        return any(st["ba"] is not None for st in self._pending_kfq)

    # ------------------------------------------------------------------

    def _launch_stage(self, kf_id: int):
        """Culling and the stage inputs on the host, then triangulation +
        fusion queued on the device. Returns (the stage's host record,
        its device outputs)."""
        with self._span("dispatch_kf"):
            s = self.store
            dev = self.device
            s.refresh_obs_counts()
            # newly created points of this KF enter the culling probation
            # window
            row = s.kf_pt_ids[kf_id]
            new_ids = row[(row >= 0) & (s.pt_first_kf[row.clip(0)] == kf_id)]
            self.note_created(kf_id, new_ids)
            recent = [ids for _, ids in self._recent if len(ids)]
            if recent:
                s.cull_points(np.concatenate(recent), current_kf=kf_id)
            covis, _ = s.covisible_kfs(kf_id, min_shared=15, top=10)
            nbs_tri = [int(nb) for nb in covis[:TRI_NEIGHBOURS]]
            nbs_fuse = [int(nb) for nb in covis[:FUSE_NEIGHBOURS]]
            slots = [int(x) for x in
                     self.ensure_cached([kf_id] + nbs_tri + nbs_fuse)]
            # fuse view: this KF's current points
            my = row[row >= 0]
            pids = np.unique(my)
            pids = pids[s.pt_valid[pids]][-FUSE_VIEW_CAP:]
            free_tri = np.stack([s.kf_kp_valid[k] & (s.kf_pt_ids[k] < 0)
                                 for k in [kf_id] + nbs_tri])
            valid_fuse = np.stack([s.kf_kp_valid[k] for k in nbs_fuse]) \
                if nbs_fuse else np.zeros((0, s.n_kp), bool)
            t = lambda a: upload(a, dev)
            view = mapper_fast.view_from_store(s, pids, FUSE_VIEW_CAP, dev)
            tri, fuse = mapper_fast.kf_stage_cached(
                self.cam, self.cache.arrays, slots[:1 + len(nbs_tri)],
                t(s.kf_pose[[kf_id] + nbs_tri]), t(free_tri),
                slots[1 + len(nbs_tri):], t(s.kf_pose[nbs_fuse]),
                t(valid_fuse), view, self._lut_dev, s.cfg.n_levels,
                s.cfg.scale)
        stage = dict(kf_id=kf_id, slots=slots, nbs_tri=nbs_tri,
                     nbs_fuse=nbs_fuse,
                     pid_arr=np.concatenate(
                         [pids, np.full(FUSE_VIEW_CAP - len(pids), -1,
                                        np.int64)]))
        out = dict(tri=[dict(match=m, X=X) for _, m, X in tri],
                   fuse=[kp2pt for _, kp2pt in fuse])
        return stage, out

    def _stage_writeback(self, stage: dict, out: dict):
        """Host writeback of a stage's results (numpy): new points from the
        triangulated matches, then fusion."""
        s = self.store
        kf_id = stage["kf_id"]
        with self._span("triangulate"):
            created: list[int] = []
            claimed = np.zeros(s.n_kp, bool)
            for tri, nb in zip(out["tri"], stage["nbs_tri"]):
                match, X = tri["match"], tri["X"]
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
        with self._span("fuse"):
            self._fuse_writeback(out["fuse"], stage["pid_arr"],
                                 stage["nbs_fuse"])
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
        windowed BA; None (after keyframe culling) when BA is skipped:
        another BA in flight (the reference interrupts a running local BA
        when a keyframe arrives), a map of one keyframe, or the adaptive
        cadence."""
        s = self.store
        if self._ba_inflight():
            self.stage_times["ba_skip_dropped"] = self.stage_times.get(
                "ba_skip_dropped", 0) + 1
            self.cull_keyframes(kf_id)
            return None
        if self._pending_ba is not None:
            self.absorb_ba()
        if s.n_kf < 2:
            self.cull_keyframes(kf_id)
            return None
        fid = int(s.kf_frame_id[kf_id])
        if self.adaptive_ba_cadence and s.n_kf > 4 \
                and fid - self._last_ba_frame < 6:
            self.stage_times["ba_cadence_skipped"] = self.stage_times.get(
                "ba_cadence_skipped", 0) + 1
            self.cull_keyframes(kf_id)
            return None
        with self._span("dba_build"):
            return self._build_ba(kf_id, fid)

    def _build_ba(self, kf_id: int, fid: int):
        """The padded problem tensors of this keyframe's windowed BA; None
        (after keyframe culling) when its window holds no problem."""
        s = self.store
        self._last_ba_frame = fid
        meta = self._build_problem_np(kf_id)
        if meta is None:
            self.cull_keyframes(kf_id)
            return None
        # tracking view selection (UpdateLocalPoints)
        view_pids = self._select_view_pids(kf_id)
        tv_cap = self.fixed_tv_cap or view_capacity(len(view_pids))
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
        t = lambda a: upload(a, self.device)
        prep = dict(
            meta=meta, slots=t(slots_pad), poses=t(poses), fixed=t(fixed),
            points=t(points), pvalid=t(pvalid), obs=t(obs), n_obs=n_obs,
            tv_pidx=t(tv_pidx),
            tv=mapper_fast.view_from_store(s, view_pids, tv_cap, self.device),
            vp=np.concatenate([view_pids,
                               np.full(tv_cap - len(view_pids), -1, np.int64)]))
        if self.enable_lines:
            prep["lmeta"] = lmeta = self._line_obs_np(window)
            prep["lines"] = self._line_tensors(window, lmeta)
        return prep

    def _line_tensors(self, window: np.ndarray, lmeta: dict):
        """Device tensors of the line half of the window: (x0, dir, valid)
        padded to l_cap rows, and the LineBAObs padded to lo_cap rows."""
        s = self.store
        LC, LO = self.l_cap, self.lo_cap
        lids, O = lmeta["lids"], lmeta["n_lobs"]
        x0 = np.zeros((LC, 3), np.float32)
        dr = np.tile(np.array([1, 0, 0], np.float32), (LC, 1))
        x0[:len(lids)] = s.ln_x0[lids]
        dr[:len(lids)] = s.ln_dir[lids]
        k, l = np.zeros(LO, np.int64), np.zeros(LO, np.int64)
        k[:O], l[:O] = lmeta["wk"], lmeta["l_idx"]
        kf, det = window[lmeta["wk"]], lmeta["wd"]
        xs = np.zeros((4, LO, 2), np.float32)
        for i, a in enumerate((s.kf_ln_p1, s.kf_ln_p2, s.kf_ln_p1r,
                               s.kf_ln_p2r)):
            xs[i, :O] = a[kf, det]
        oct_ = np.zeros(LO, np.int32)
        oct_[:O] = s.kf_ln_oct[kf, det]
        hasr = np.zeros(LO, bool)
        hasr[:O] = s.kf_ln_has_r[kf, det]
        t = lambda a: upload(a, self.device)
        xs = t(xs)
        lobs = lines_ba.LineBAObs(
            k=t(k), l=t(l), x1l=xs[0], x2l=xs[1], x1r=xs[2], x2r=xs[3],
            octave=t(oct_), has_r=t(hasr), valid=t(np.arange(LO) < O))
        return t(x0), t(dr), t(np.arange(LC) < len(lids)), lobs

    def _line_obs_np(self, window: np.ndarray) -> dict:
        """Line half of the BA window: the valid lines the window keyframes
        observe (the last l_cap), one observation per (keyframe, line), at
        most lo_cap of them."""
        s = self.store
        lids = np.unique(s.kf_ln_ids[window])
        lids = lids[lids >= 0]
        lids = lids[s.ln_valid[lids]][-self.l_cap:]
        ln_lut = np.full(s.max_ln, -1, np.int32)
        ln_lut[lids] = np.arange(len(lids), dtype=np.int32)
        ids = s.kf_ln_ids[window]
        wk, wd = np.nonzero((ids >= 0) & (ln_lut[ids.clip(0)] >= 0))
        _, first = np.unique(
            wk.astype(np.int64) * s.max_ln + s.kf_ln_ids[window[wk], wd],
            return_index=True)
        wk, wd = wk[np.sort(first)], wd[np.sort(first)]
        l_idx = ln_lut[s.kf_ln_ids[window[wk], wd]]
        O = min(len(wk), self.lo_cap)
        if len(wk) > O:
            self.stage_times["ln_obs_dropped"] = self.stage_times.get(
                "ln_obs_dropped", 0) + (len(wk) - O)
        return dict(lids=lids, wk=wk[:O], wd=wd[:O], l_idx=l_idx[:O],
                    n_lobs=O)

    def _run_ba(self, kf_id: int, prep: dict):
        """Windowed BA on the device, then writeback + outlier erasure +
        keyframe culling. Returns (post-BA view, view point ids)."""
        with self._span("ba"):
            out = self._launch_ba(prep)
            view = out.pop("view")
            self._ba_writeback(kf_id, prep, HostCopy(out).result())
        return view, prep["vp"]

    def _launch_ba(self, prep: dict) -> dict:
        """The windowed BA (joint with lines when the problem has them)
        queued on the device: poses, points, keep (and X0, d, keep_l) and
        the post-BA view."""
        obs = prep["obs"]
        args = (self.cam, self.cache.arrays, prep["slots"], prep["poses"],
                prep["fixed"], prep["points"], prep["pvalid"], obs[0], obs[1],
                obs[2], prep["n_obs"], self._lut_dev, prep["tv_pidx"],
                prep["tv"])
        if "lines" in prep:
            poses, points, X0, d, keep, keep_l, view = \
                mapper_fast.joint_ba_view_cached(
                    *args, *prep["lines"], gamma=float(self.cfg.line.gamma))
            return dict(poses=poses, points=points, keep=keep, X0=X0, d=d,
                        keep_l=keep_l, view=view)
        poses, points, keep, view = mapper_fast.ba_view_cached(*args)
        return dict(poses=poses, points=points, keep=keep, view=view)

    def _ba_writeback(self, kf_id: int, prep: dict, out: dict):
        """A BA's host results (numpy) into the store: lines first."""
        if "lines" in prep:
            self._writeback_lines(prep["meta"]["window"], prep["lmeta"],
                                  out["X0"], out["d"], out["keep_l"])
        self._writeback_ba(kf_id, prep["meta"], out["poses"], out["points"],
                           out["keep"])

    def _writeback_lines(self, window, lmeta: dict, X0, d, keep_l):
        """Solved line geometry where finite; outlier line observations
        detach from their keyframes."""
        s = self.store
        lids = lmeta["lids"]
        X0, d = X0[:len(lids)], d[:len(lids)]
        fin = np.isfinite(X0).all(-1) & np.isfinite(d).all(-1)
        s.ln_x0[lids[fin]] = X0[fin]
        s.ln_dir[lids[fin]] = d[fin]
        bad = ~keep_l[:lmeta["n_lobs"]]
        if bad.any():
            s.kf_ln_ids[window[lmeta["wk"][bad]], lmeta["wd"][bad]] = -1

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
        keep their pose but stop contributing observations, and
        `on_kf_culled` hears of each."""
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
                if self.on_kf_culled is not None:
                    self.on_kf_culled(k)
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
