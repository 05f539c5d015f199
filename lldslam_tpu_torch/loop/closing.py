"""Loop closing: detection, Sim(3) verification and map-wide correction.

Counterpart of lldslam_tpu/loop/closing.py, a deterministic per-keyframe
step the tracker calls after local mapping:

1. detection: the BoW vector of the keyframe (`Vocabulary.bow_vector`, the
   tree descent on the device), database candidates above the lowest score
   of the covisible keyframes, and 3-consecutive covisibility consistency;
2. Sim(3) verification: descriptor match between the two keyframes'
   point-carrying features (>= 20), RANSAC (>= 20 inliers) and GN
   refinement (>= 20), then guided matching of the loop side's local map
   points into the current keyframe through K2 at 8192 rows, accepted at
   >= 40 matched features;
3. correction: essential-graph optimization (spanning tree, past loop
   edges, covisibility >= 100, the new loop edge), point and map-line
   remap through each landmark's anchor keyframe, loop fusion into the
   corrected group (K2 again, per group keyframe), then global BA on the
   matrix-free CG path (10 iterations, 64 CG steps): points only, or the
   joint point+line problem (`lines_ba.joint_ba_solve_cg`) when the map
   holds lines with >= 4 (stereo-weighted) observations.

The pipelined tracker runs the step in two halves: the keyframe's word ids
computed on the device (`dispatch_bow`, or the mapper's keyframe stage) and,
once they are read back, `finish_keyframe` (detection, verification,
correction), which gives what `process_keyframe` gives.

Scale stays fixed (stereo). Host numpy bookkeeping is ported line for line;
the solvers run on the loop closer's device (the card by default). The
RANSAC draw uses a `torch.Generator` seeded 0 on that device. Global BA
solves on one device, or landmark-sharded over the ranks of the default
process group when it has more than one (parallel/dist_schur.py; the JAX
package takes that route when it sees more than one device). Every rank
then runs the same correction on its own copy of the same map.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..config import SlamConfig
from ..frontend import matching
from ..ops import hamming
from ..geometry import lines as glines
from ..optim import ba, lines_ba, pose_graph, sim3_solver
from ..pipeline.mapper_fast import view_from_store
from ..slammap.map_store import MapStore
from .bow import Vocabulary
from .database import KeyFrameDatabase

SIM3_CAP = 512        # matches fed to the Sim3 RANSAC
PROJECT_CAP = 8192    # map points per guided projection search (K2 rows)
COVIS_CONSISTENCY = 3  # consecutive consistent detections before a loop
GBA_OBS_CAP = 1 << 18  # global-BA observations, subsampled evenly above
EVENT_STAGES = ("sim3", "guided", "pose_graph", "fusion", "global_ba")


@dataclass
class LoopEvent:
    query_kf: int
    matched_kf: int
    n_inliers: int
    stage_ms: dict = field(default_factory=dict)   # host ms per stage


def project_match(store: MapStore, feats: matching.FrameFeatures,
                  pids: np.ndarray, T_cw: np.ndarray, th: float,
                  site: str) -> np.ndarray:
    """Project the given map points (the last PROJECT_CAP) into a frame's
    features and match them (SearchByProjection through K2, the view padded
    to PROJECT_CAP rows). Returns kp2pid (N,) global point ids per feature
    (-1 none)."""
    dev = feats.xy.device
    pids = pids[-PROJECT_CAP:]
    view = view_from_store(store, pids, PROJECT_CAP, dev)
    # two host waits: the pose's blocking upload, the matches' read-back
    tracing.count("host_waits", 2)
    T = torch.from_numpy(np.ascontiguousarray(T_cw, np.float32)).to(dev)
    _, kp2pt, _, _ = matching.search_by_projection(
        store.cam, T, view, feats, n_levels=store.cfg.n_levels,
        scale=store.cfg.scale, th=th, site=site)
    kp2pt = kp2pt.cpu().numpy()
    pid_arr = np.concatenate([pids, np.full(PROJECT_CAP - len(pids), -1,
                                            pids.dtype)])
    return np.where(kp2pt >= 0, pid_arr[np.maximum(kp2pt, 0)],
                    -1).astype(np.int32)


class LoopCloser:
    def __init__(self, store: MapStore, voc: Vocabulary, cfg: SlamConfig,
                 device="cuda"):
        self.store = store
        self.device = torch.device(device)
        self.voc = voc.to(self.device)
        self.cfg = cfg
        self.db = KeyFrameDatabase(self.voc)
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf = -10**9
        self.events: list[LoopEvent] = []
        self._inv_sigma2 = np.power(
            1.0 / store.cfg.scale ** 2, np.arange(store.cfg.n_levels)
        ).astype(np.float32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self._loop_guided = (None, None)
        self.stage_times: dict[str, float] = {}

    # ------------------------------------------------------------------

    def warmup(self):
        """Sim3 RANSAC and refinement once on dummy inputs
        (`warmup_loop_programs`); the map, the database and the RANSAC
        generator stay as they were."""
        warmup_loop_programs(self.store.cam, self.device)

    def _t(self, a) -> torch.Tensor:
        tracing.count("host_waits")     # a blocking upload from pageable
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _span(self, key: str, name: str | None = None) -> tracing.span:
        """A span `loop.<key>` (or `name`) whose seconds add to
        stage_times[key]."""
        return tracing.span(name or "loop." + key, self.stage_times, key)

    def _kf_feats(self, kf: int) -> matching.FrameFeatures:
        s = self.store
        return matching.FrameFeatures(
            xy=self._t(s.kf_xy[kf]), ur=self._t(s.kf_ur[kf]),
            octave=self._t(s.kf_oct[kf].astype(np.int32)),
            angle=self._t(s.kf_angle[kf]),
            desc=self._t(s.kf_desc[kf].view(np.int32)),
            valid=self._t(s.kf_kp_valid[kf]))

    def dispatch_bow(self, desc: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
        """The staged first half of `process_keyframe`: the keyframe's word
        ids from its device descriptors, left on the device (int32, -1
        where not valid). Absorb with `finish_keyframe`."""
        return self.voc.device_words(desc, valid)

    def finish_keyframe(self, kf_id: int, words: np.ndarray) -> bool:
        """The staged second half of `process_keyframe`, from word ids read
        back from `dispatch_bow` (or from the mapper's keyframe stage):
        detection, and Sim(3) verification and correction when a loop
        fires. Returns True when the map was corrected."""
        self.stage_times["n_words_staged"] = self.stage_times.get(
            "n_words_staged", 0) + 1
        return self._finish(kf_id, *self.voc.vector_from_words(
            np.asarray(words)))

    def process_keyframe(self, kf_id: int) -> bool:
        """Run the loop pipeline for a new keyframe. Returns True when a loop
        was detected and the map corrected."""
        s = self.store
        with self._span("bow"):
            ids, vals = self.voc.bow_vector(s.kf_desc[kf_id],
                                            s.kf_kp_valid[kf_id])
        return self._finish(kf_id, ids, vals)

    def _finish(self, kf_id: int, ids, vals) -> bool:
        with self._span("detect"):
            candidate = self._detect(kf_id, ids, vals)
        corrected = False
        if candidate is not None:
            # a loop event: the Sim3 verification, and the correction when
            # it holds
            with self._span("sim3+correct", "loop.event"):
                corrected = self._event(kf_id, candidate)
        self.db.add(kf_id, ids, vals)
        self.stage_times["n"] = self.stage_times.get("n", 0) + 1
        return corrected

    def _event(self, kf_id: int, candidate: int) -> bool:
        before = {k: self.stage_times.get(k, 0.0) for k in EVENT_STAGES}
        res = self._compute_sim3(kf_id, candidate)
        if res is None:
            return False
        S_cm, n_inl = res
        self._correct(kf_id, candidate, S_cm)
        self.events.append(LoopEvent(kf_id, candidate, n_inl, {
            k: 1e3 * (self.stage_times[k] - before[k])
            for k in EVENT_STAGES}))
        self.last_loop_kf = kf_id
        self.consistent_groups = []
        return True

    # ------------------------------------------------------------------

    def _detect(self, kf_id: int, ids, vals) -> int | None:
        s = self.store
        if kf_id < self.last_loop_kf + 10 or s.n_kf < 12:
            return None
        covis, _ = s.covisible_kfs(kf_id, min_shared=15)
        connected = set(int(c) for c in covis)
        if not connected:
            return None
        min_score = min(
            (self.db.score_vs(ids, vals, c) for c in connected
             if c in self.db.kf_words), default=1.0)

        def groups_fn(kf: int):
            return [int(x) for x in s.covisible_kfs(int(kf), min_shared=15)[0]]

        cands = self.db.detect_loop_candidates_vec(
            ids, vals, max(min_score, 1e-3), connected | {kf_id}, groups_fn)
        self.stage_times["n_candidates"] = self.stage_times.get(
            "n_candidates", 0) + len(cands)
        if not cands:
            self.consistent_groups = []
            return None
        # covisibility consistency over consecutive keyframes
        enough: list[int] = []
        new_groups: list[tuple[set, int]] = []
        for cand in cands:
            group = set(groups_fn(cand)) | {cand}
            matched = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    if count + 1 >= COVIS_CONSISTENCY:
                        enough.append(cand)
                    matched = True
                    break
            if not matched:
                new_groups.append((group, 0))
        self.consistent_groups = new_groups
        return enough[0] if enough else None

    # ------------------------------------------------------------------

    def _compute_sim3(self, kf_c: int, kf_m: int):
        """Descriptor match + Sim3 RANSAC + refinement + guided matching.
        Returns ((R, t, s) S_cm aligning m's camera frame into c's, refined
        inliers) or None."""
        s = self.store
        cam = s.cam
        with self._span("sim3"):
            has_c = s.kf_kp_valid[kf_c] & (s.kf_pt_ids[kf_c] >= 0)
            has_m = s.kf_kp_valid[kf_m] & (s.kf_pt_ids[kf_m] >= 0)
            idx, ok, _ = hamming.match_descriptors(
                self._t(s.kf_desc[kf_c].view(np.int32)), self._t(has_c),
                self._t(s.kf_desc[kf_m].view(np.int32)), self._t(has_m),
                max_dist=hamming.TH_LOW, ratio=0.75)
            tracing.count("host_waits", 2)
            idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
            sel_c = np.nonzero(ok)[0]
            if len(sel_c) < 20:
                return None
            n = min(len(sel_c), SIM3_CAP)
            sel_c = sel_c[:n]
            sel_m = idx[sel_c]
            pc = s.pt_pos[s.kf_pt_ids[kf_c, sel_c]]
            pm = s.pt_pos[s.kf_pt_ids[kf_m, sel_m]]
            Tc, Tm = s.kf_pose[kf_c], s.kf_pose[kf_m]
            X1 = self._t(((Tc[:3, :3] @ pc.T).T + Tc[:3, 3]).astype(
                np.float32))
            X2 = self._t(((Tm[:3, :3] @ pm.T).T + Tm[:3, 3]).astype(
                np.float32))
            uv1 = self._t(s.kf_xy[kf_c, sel_c])
            uv2 = self._t(s.kf_xy[kf_m, sel_m])
            s2_1 = self._t((1.0 / self._inv_sigma2)[s.kf_oct[kf_c, sel_c]])
            s2_2 = self._t((1.0 / self._inv_sigma2)[s.kf_oct[kf_m, sel_m]])
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
            S, inl, n_inl = sim3_solver.ransac_sim3(
                cam, cam, X1, X2, uv1, uv2, s2_1, s2_2, valid, self._gen)
            (R, t, sc), inl2, n_ref = sim3_solver.refine_sim3(
                cam, cam, S, X1, X2, uv1, uv2, 1.0 / s2_1, 1.0 / s2_2, inl)
            tracing.count("host_waits", 2)
            n_inl, n_ref = int(n_inl), int(n_ref)
        # both gates (RANSAC, then the OptimizeSim3 refinement) at >= 20
        if n_inl < 20 or n_ref < 20:
            return None
        with self._span("guided"):
            tracing.count("host_waits", 4)
            R, t = R.cpu().numpy(), t.cpu().numpy()
            sc = float(sc)
            inl2 = inl2.cpu().numpy()

            # guided matching with the corrected pose: project the loop
            # side's local map points into the current keyframe, demand
            # >= 40 matched features in all
            Tm = s.kf_pose[kf_m]
            T_corr = np.eye(4, dtype=np.float32)
            T_corr[:3, :3] = R @ Tm[:3, :3]
            T_corr[:3, 3] = sc * (R @ Tm[:3, 3]) + t
            loop_pids = self._loop_points(kf_m)
            kp2lp = self._project_match(kf_c, loop_pids, T_corr, th=2.5)
            matched = set(np.nonzero(kp2lp >= 0)[0].tolist())
            matched |= set(int(x) for x in sel_c[inl2])
        if len(matched) < 40:
            return None
        self._loop_guided = (kp2lp, loop_pids)
        return (R, t, sc), n_ref

    # ------------------------------------------------------------------

    def _loop_points(self, kf_m: int, top: int = 10) -> np.ndarray:
        """Loop-side local map points: kf_m's and its covisible KFs'."""
        s = self.store
        covis, _ = s.covisible_kfs(kf_m, min_shared=15, top=top)
        kfs = np.concatenate([[kf_m], covis]).astype(np.int32)
        pids = np.unique(s.kf_pt_ids[kfs])
        pids = pids[pids >= 0]
        return pids[s.pt_valid[pids]]

    def _project_match(self, kf_c: int, pids: np.ndarray, T_cw: np.ndarray,
                       th: float = 2.5) -> np.ndarray:
        """Project the given map points into keyframe kf_c's features and
        match (K2 at PROJECT_CAP rows). Returns kp2pid (N,)."""
        return project_match(self.store, self._kf_feats(kf_c), pids, T_cw,
                             th, "loop")

    # ------------------------------------------------------------------

    def _correct(self, kf_c: int, kf_m: int, S_cm):
        """Essential-graph optimization + point remap + loop fusion +
        global BA."""
        with self._span("pose_graph"):
            poses_old, R_new, t_new, s_new = self._pose_graph(kf_c, kf_m,
                                                              S_cm)
        with self._span("fusion"):
            self._remap_and_fuse(kf_c, poses_old, R_new, t_new, s_new)
        with self._span("global_ba"):
            self.global_ba()
        self.stage_times["n_events"] = self.stage_times.get("n_events", 0) + 1

    def _pose_graph(self, kf_c: int, kf_m: int, S_cm):
        """The essential graph optimized with the loop edge: the keyframes'
        old poses (K, 4, 4) and the solved Sim(3) R, t, s (host arrays)."""
        s = self.store
        K = s.n_kf
        R_cm, t_cm, s_cm = S_cm
        poses_old = s.kf_pose[:K].copy()

        # corrected current pose: S_cw = S_cm * S_mw
        Tm = poses_old[kf_m]
        R0 = poses_old[:, :3, :3].copy()
        t0 = poses_old[:, :3, 3].copy()
        s0 = np.ones(K, np.float32)
        R0[kf_c] = R_cm @ Tm[:3, :3]
        t0[kf_c] = s_cm * (R_cm @ Tm[:3, 3]) + t_cm

        # edges, measured on the pre-correction relative poses
        e_i, e_j, mR, mt, ms = [], [], [], [], []

        def add_edge(i, j, Ti, Tj):
            M = Ti @ np.linalg.inv(Tj)
            e_i.append(i)
            e_j.append(j)
            mR.append(M[:3, :3].copy())
            mt.append(M[:3, 3].copy())
            ms.append(1.0)

        # spanning-tree backbone
        tree_pairs = set()
        for k in range(1, K):
            p = int(s.kf_parent[k]) if s.kf_parent[k] >= 0 else k - 1
            add_edge(k, p, poses_old[k], poses_old[p])
            tree_pairs.add((min(k, p), max(k, p)))
        # every past loop edge persists
        for i, j in s.loop_edges:
            if (min(i, j), max(i, j)) not in tree_pairs:
                add_edge(i, j, poses_old[i], poses_old[j])
                tree_pairs.add((min(i, j), max(i, j)))
        # strong covisibility (weight >= 100)
        for k in range(K):
            covis, _ = s.covisible_kfs(k, min_shared=100)
            for c in covis:
                c = int(c)
                if c < k and (c, k) not in tree_pairs:
                    add_edge(k, c, poses_old[k], poses_old[c])
                    tree_pairs.add((c, k))
        # the new loop edge c <- m with measurement S_cm
        e_i.append(kf_c)
        e_j.append(kf_m)
        mR.append(R_cm)
        mt.append(t_cm)
        ms.append(s_cm)
        s.loop_edges.append((kf_c, kf_m))

        fixed = np.zeros(K, bool)
        fixed[kf_m] = True   # gauge: the loop keyframe
        f32 = lambda a: self._t(np.asarray(a, np.float32))
        g = pose_graph.PoseGraph(
            R=f32(R0), t=f32(t0), s=f32(s0), fixed=self._t(fixed),
            e_i=self._t(np.asarray(e_i, np.int64)),
            e_j=self._t(np.asarray(e_j, np.int64)),
            m_R=f32(np.stack(mR)), m_t=f32(np.stack(mt)), m_s=f32(ms),
            e_valid=torch.ones(len(e_i), dtype=torch.bool,
                               device=self.device))
        g_opt = pose_graph.optimize_pose_graph(g, iters=15, cg_iters=48)
        tracing.count("host_waits", 3)
        return (poses_old, g_opt.R.cpu().numpy(), g_opt.t.cpu().numpy(),
                g_opt.s.cpu().numpy())

    def _remap_and_fuse(self, kf_c: int, poses_old, R_new, t_new, s_new):
        """The poses, points and map lines moved by the solved graph, then
        loop fusion."""
        s = self.store
        K = len(poses_old)
        # Sim3 -> SE3 write-back (t / s)
        T_new = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        T_new[:, :3, :3] = R_new
        T_new[:, :3, 3] = t_new / s_new[:, None]

        # remap points through their anchor KF: P' = S_new^-1 (T_old P)
        pids = np.nonzero(s.pt_valid[: s.n_pt])[0]
        anchors = np.clip(s.pt_first_kf[pids], 0, K - 1)
        P = s.pt_pos[pids]
        To = poses_old[anchors]
        Xa = np.einsum("nij,nj->ni", To[:, :3, :3], P) + To[:, :3, 3]
        Xw = np.einsum("nji,nj->ni", R_new[anchors],
                       (Xa - t_new[anchors]) / s_new[anchors][:, None])
        s.pt_pos[pids] = Xw.astype(np.float32)
        self._remap_lines(poses_old, R_new, t_new, s_new)
        s.kf_pose[:K] = T_new

        # loop fusion: the guided matches bind into the current KF, then the
        # loop points are projected into every corrected-group KF
        kp2lp, loop_pids = self._loop_guided
        covis, _ = s.covisible_kfs(kf_c, min_shared=15, top=10)
        group = np.concatenate([[kf_c], covis]).astype(np.int32)
        if kp2lp is not None:
            self._fuse_into_kf(kf_c, kp2lp)
            for kf in group[1:]:
                k2 = self._project_match(int(kf), loop_pids,
                                         s.kf_pose[int(kf)], th=2.0)
                self._fuse_into_kf(int(kf), k2)
            s.refresh_obs_counts()
            s._update_point_geometry(loop_pids)
            self._loop_guided = (None, None)

    def _remap_lines(self, poses_old, R_new, t_new, s_new):
        """Map lines through their anchor keyframe like the points:
        X0' = S_new^-1 (T_old X0), d' = R_new^T (R_old d), then the
        X0-perpendicular-to-d form restored."""
        s = self.store
        lids = np.nonzero(s.ln_valid[: s.n_ln])[0]
        if len(lids) == 0:
            return
        a = np.clip(s.ln_first_kf[lids], 0, len(poses_old) - 1)
        To = poses_old[a]
        X0a = np.einsum("nij,nj->ni", To[:, :3, :3], s.ln_x0[lids]) \
            + To[:, :3, 3]
        da = np.einsum("nij,nj->ni", To[:, :3, :3], s.ln_dir[lids])
        X0w = np.einsum("nji,nj->ni", R_new[a],
                        (X0a - t_new[a]) / s_new[a][:, None])
        dw = np.einsum("nji,nj->ni", R_new[a], da)
        dw /= np.maximum(np.linalg.norm(dw, axis=-1, keepdims=True), 1e-9)
        X0w = X0w - np.sum(X0w * dw, axis=-1, keepdims=True) * dw
        s.ln_x0[lids] = X0w.astype(np.float32)
        s.ln_dir[lids] = dw.astype(np.float32)

    def _fuse_into_kf(self, kf: int, kp2pid: np.ndarray):
        """Bind matched loop points into one keyframe: a hit on a feature
        holding another point replaces that point with the loop point
        everywhere; a hit on a free feature adds an observation."""
        s = self.store
        K = s.n_kf
        row = s.kf_pt_ids[kf]
        present = set(int(x) for x in row[row >= 0])
        merged = False
        for f in np.nonzero(kp2pid >= 0)[0]:
            lp = int(kp2pid[f])
            if not s.pt_valid[lp]:
                continue
            q = int(row[f])
            if q == lp:
                continue
            if q < 0:
                if lp in present:
                    continue
                row[f] = lp
                present.add(lp)
                s.mark_obs_dirty()
            else:
                m = s.kf_pt_ids[:K] == q
                s.kf_pt_ids[:K][m] = lp
                s.pt_valid[q] = False
                present.discard(q)
                present.add(lp)
                merged = True
                s.mark_obs_dirty()
        if merged:
            # one observation per (KF, point) after the global replacement
            ids = s.kf_pt_ids[:K]
            for k in range(K):
                r = ids[k]
                vals = r[r >= 0]
                if len(vals) != len(np.unique(vals)):
                    seen: set[int] = set()
                    for i in np.nonzero(r >= 0)[0]:
                        v = int(r[i])
                        if v in seen:
                            r[i] = -1
                        else:
                            seen.add(v)
            s.mark_obs_dirty()

    # ------------------------------------------------------------------

    def global_ba(self, force_dist: bool | None = None):
        """Full-map BA on the matrix-free CG path (10 LM iterations of 64 CG
        steps): every valid point, one observation per (KF, point),
        subsampled evenly above GBA_OBS_CAP, KF 0 fixed; with every
        observation of the lines that have >= 4 (stereo-weighted)
        observations as a second landmark class when there are any.

        When the default process group has more than one rank, the same
        problem is solved landmark-sharded over it (`parallel.dist_schur`;
        every rank calls this on its copy of the same map and ends with the
        same poses, points and lines); otherwise on this closer's device.
        `force_dist` overrides that choice (True on one process makes a
        one-rank group, `dist_schur.make_mesh`)."""
        s = self.store
        K = s.n_kf
        pids = np.nonzero(s.pt_valid[: s.n_pt])[0]
        if K < 2 or len(pids) == 0:
            return
        pt_lut = np.full(s.max_pt, -1, np.int32)
        pt_lut[pids] = np.arange(len(pids), dtype=np.int32)
        kf_idx, feat_idx = np.nonzero(s.kf_pt_ids[:K] >= 0)
        p_idx = pt_lut[s.kf_pt_ids[kf_idx, feat_idx]]
        keep = p_idx >= 0
        kf_idx, feat_idx, p_idx = kf_idx[keep], feat_idx[keep], p_idx[keep]
        # one observation per (KF, point): duplicates (possible after fuse
        # merges) would double-count residuals
        _, first = np.unique(
            kf_idx.astype(np.int64) * s.max_pt + p_idx, return_index=True)
        first = np.sort(first)
        kf_idx, feat_idx, p_idx = kf_idx[first], feat_idx[first], p_idx[first]
        if len(kf_idx) > GBA_OBS_CAP:
            self.stage_times["gba_obs_dropped"] = self.stage_times.get(
                "gba_obs_dropped", 0) + (len(kf_idx) - GBA_OBS_CAP)
            sel = np.linspace(0, len(kf_idx) - 1, GBA_OBS_CAP).astype(int)
            kf_idx, feat_idx, p_idx = kf_idx[sel], feat_idx[sel], p_idx[sel]
        ur = s.kf_ur[kf_idx, feat_idx]
        uvr = np.concatenate([s.kf_xy[kf_idx, feat_idx], ur[:, None]], -1)
        fixed = np.zeros(K, bool)
        fixed[0] = True
        ones = lambda n: torch.ones(n, dtype=torch.bool, device=self.device)
        problem = ba.BAProblem(
            poses=self._t(s.kf_pose[:K]), points=self._t(s.pt_pos[pids]),
            pose_fixed=self._t(fixed), point_valid=ones(len(pids)),
            obs=ba.BAObs(
                k=self._t(kf_idx.astype(np.int64)),
                p=self._t(p_idx.astype(np.int64)),
                uvr=self._t(uvr.astype(np.float32)),
                inv_sigma2=self._t(self._inv_sigma2[s.kf_oct[kf_idx, feat_idx]]),
                is_stereo=self._t(ur >= 0), valid=ones(len(kf_idx))))
        lp = self._gather_line_problem()
        if force_dist is None:
            force_dist = dist.is_initialized() and dist.get_world_size() > 1
        if force_dist:
            self._global_ba_dist(problem, pids, lp)
            return
        if lp is None:
            solved, _ = ba.ba_solve(s.cam, problem, iters=10, cg_iters=64)
        else:
            lids, q, alpha, lobs = lp
            joint, _, _ = lines_ba.joint_ba_solve_cg(
                s.cam, lines_ba.JointProblem(
                    base=problem, q=q, alpha=alpha,
                    line_valid=ones(len(lids)), lobs=lobs),
                iters=10, cg_iters=64, gamma=float(self.cfg.line.gamma))
            solved = joint.base
            self._write_back_lines(lids, joint.q, joint.alpha)
        tracing.count("host_waits", 2)
        s.kf_pose[:K] = solved.poses.cpu().numpy()
        s.pt_pos[pids] = solved.points.cpu().numpy()

    def _global_ba_dist(self, problem: ba.BAProblem, pids: np.ndarray, lp):
        """`global_ba`'s problem laid out over the group's ranks, solved
        with `dist_schur`, assembled on every rank and written back."""
        from ..parallel import dist_schur as ds
        s = self.store
        K = s.n_kf
        group = ds.make_mesh(device=self.device)
        n = dist.get_world_size(group)
        if lp is None:
            dp, _ = ds.make_dist_problem(problem, n)
            poses, points, _ = ds.dist_ba_solve(
                s.cam, ds.place(dp, group, self.device), group, iters=10,
                cg_iters=64)
            (points,) = ds.assemble(group, points)
        else:
            lids, q, alpha, lobs = lp
            djp, _, _ = ds.make_dist_joint_problem(lines_ba.JointProblem(
                base=problem, q=q, alpha=alpha, line_valid=torch.ones(
                    len(lids), dtype=torch.bool, device=self.device),
                lobs=lobs), n)
            poses, points, q, alpha, _ = ds.dist_joint_ba_solve(
                s.cam, ds.place_joint(djp, group, self.device), group,
                iters=10, cg_iters=64, gamma=float(self.cfg.line.gamma))
            points, q, alpha = ds.assemble(group, points, q, alpha)
            self._write_back_lines(lids, q[:len(lids)], alpha[:len(lids)])
        tracing.count("host_waits", 2)
        s.kf_pose[:K] = poses.cpu().numpy()
        s.pt_pos[pids] = points[:len(pids)].cpu().numpy()

    def _gather_line_problem(self, min_obs: int = 4):
        """The line half of the global problem: the valid lines with
        >= min_obs observations and every keyframe observation of them.
        Returns (lids, q, alpha, LineBAObs) or None when there is none."""
        s = self.store
        K = s.n_kf
        lids = np.nonzero(s.ln_valid[: s.n_ln]
                          & (s.ln_nobs[: s.n_ln] >= min_obs))[0]
        if len(lids) == 0:
            return None
        kf_idx, det_idx = np.nonzero(s.kf_ln_ids[:K] >= 0)
        obs_l = s.kf_ln_ids[kf_idx, det_idx]
        keep = np.isin(obs_l, lids)
        kf_idx, det_idx, obs_l = kf_idx[keep], det_idx[keep], obs_l[keep]
        if len(kf_idx) == 0:
            return None
        ln_lut = np.full(s.max_ln, -1, np.int64)
        ln_lut[lids] = np.arange(len(lids))
        t = self._t
        lobs = lines_ba.LineBAObs(
            k=t(kf_idx.astype(np.int64)), l=t(ln_lut[obs_l]),
            x1l=t(s.kf_ln_p1[kf_idx, det_idx]),
            x2l=t(s.kf_ln_p2[kf_idx, det_idx]),
            x1r=t(s.kf_ln_p1r[kf_idx, det_idx]),
            x2r=t(s.kf_ln_p2r[kf_idx, det_idx]),
            octave=t(s.kf_ln_oct[kf_idx, det_idx]),
            has_r=t(s.kf_ln_has_r[kf_idx, det_idx]),
            valid=torch.ones(len(kf_idx), dtype=torch.bool,
                             device=self.device))
        q, alpha = glines.minimal_from_x0dir(t(s.ln_x0[lids]),
                                             t(s.ln_dir[lids]))
        return lids, q, alpha, lobs

    def _write_back_lines(self, lids: np.ndarray, q, alpha):
        """Solved minimal line states back into the store, where finite."""
        s = self.store
        tracing.count("host_waits", 2)
        X0, d = (x.cpu().numpy() for x in glines.x0dir_from_minimal(q, alpha))
        fin = np.isfinite(X0).all(-1) & np.isfinite(d).all(-1)
        s.ln_x0[lids[fin]] = X0[fin]
        s.ln_dir[lids[fin]] = d[fin]

    def _global_line_refine(self):
        """Fixed-pose refinement of the lines that have >= 4 observations
        (`lines_ba.refine_lines_fixed_poses`), written back where finite.
        No default path calls it: global BA solves lines jointly with poses
        and points. Kept as a standalone utility, as in the JAX package."""
        lp = self._gather_line_problem()
        if lp is None:
            return
        s = self.store
        K = s.n_kf
        lids, q, alpha, lobs = lp
        none = torch.zeros(0, dtype=torch.bool, device=self.device)
        base = ba.BAProblem(
            poses=self._t(s.kf_pose[:K]),
            points=torch.zeros((0, 3), device=self.device),
            pose_fixed=torch.ones(K, dtype=torch.bool, device=self.device),
            point_valid=none,
            obs=ba.BAObs(k=none.long(), p=none.long(),
                         uvr=torch.zeros((0, 3), device=self.device),
                         inv_sigma2=torch.zeros(0, device=self.device),
                         is_stereo=none, valid=none))
        q2, a2 = lines_ba.refine_lines_fixed_poses(
            s.cam, lines_ba.JointProblem(
                base=base, q=q, alpha=alpha,
                line_valid=torch.ones(len(lids), dtype=torch.bool,
                                      device=self.device), lobs=lobs),
            gamma=float(self.cfg.line.gamma))
        self._write_back_lines(lids, q2, a2)


def warmup_loop_programs(cam, device="cuda") -> None:
    """Run the loop event's Sim3 step once on dummy inputs: the keyframe
    descriptor match (2048 rows a side), then Sim3 RANSAC and refinement at
    the JAX package's first-bucket shape (512 matches, 64 valid). The port
    compiles nothing ahead: what a process pays at the first call of a path
    is the loading of the CUDA modules of the kernels it launches, solver
    handles and the caching allocator's first blocks; in a fresh process
    the first Sim3 took 2.1-3.2x a warm one (tools/torch_cold_start.py on
    an H100), and after a warm-up of RANSAC and refinement alone 277-278
    ms against 175-214 ms with the descriptor match warmed too
    (tools/torch_sim3_first_call.py), a match the JAX function leaves to
    its tracking programs. The JAX function also runs the pose graph and
    global BA once; in the port, after `System.warmup`, their first calls
    read 0.89-1.35x a warm one whether the warm-up ran them or not, so they
    are left out. The RANSAC draw takes a generator of its own; no map,
    database or shared generator is read or written. Waits for the card at
    the end."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    desc = t(rng.integers(-2**31, 2**31, (2, 2048, 8), dtype=np.int32))
    has = torch.ones(2048, dtype=torch.bool, device=dev)
    hamming.match_descriptors(desc[0], has, desc[1], has,
                              max_dist=hamming.TH_LOW, ratio=0.75)
    cap = 512
    X = t(rng.uniform(1.0, 5.0, (cap, 3)).astype(np.float32))
    uv = t(rng.uniform(50, 200, (cap, 2)).astype(np.float32))
    s2 = torch.ones(cap, dtype=torch.float32, device=dev)
    vmask = t(np.arange(cap) < 64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    S, inl, _ = sim3_solver.ransac_sim3(cam, cam, X, X, uv, uv, s2, s2,
                                        vmask, gen)
    sim3_solver.refine_sim3(cam, cam, S, X, X, uv, uv, s2, s2, inl & vmask)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
