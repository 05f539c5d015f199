"""Deterministic per-frame tracking: stereo with points and lines,
monocular and RGB-D, synchronous or pipelined.

Counterpart of lldslam_tpu/pipeline/tracker.py (`StereoTracker`). Every
synchronous stereo frame runs

    build_frame_pair (+ with lines: both views' stored detections, stereo
    line match and triangulation) -> (LOST: relocalization) -> motion-model
    match (radius 7, else 14) -> pose LM -> local-map projection search
    (K2) -> pose LM -> (with lines: association with the local map lines,
    joint point+line pose LM) -> keyframe decision -> (on a keyframe) point
    creation, line observations, new map lines, retriangulation, culling
    and descriptor update + LocalMapper.process_keyframe
    + LoopCloser.process_keyframe

with the reference semantics the JAX package keeps: stereo initialization
above `min_init_points` depth'd keypoints, TrackReferenceKeyFrame fallback
when the motion model is weak, temporal seeding of close unassociated
features into the next frame's motion model, NeedNewKeyFrame with a minimum
gap of 3 frames, and trajectory bookkeeping relative to reference keyframes.

Pipelined mode (`pipeline=True`, stereo frames in state OK): frame i+1 is
dispatched before frame i's results reach the host. The chained step
(`_track_step_chained`, with lines `_track_step_chained_lines`) predicts
the pose (velocity @ last pose), updates the velocity, takes the keyframe
decision (`_kf_decision`) and carries provisional point identities
(`_prov_update`) on the device. Each frame's host-bound results stay device
tensors in its record; every `readback_window` frames one non-blocking copy
moves the window's results (and each frame's feature snapshot) into pinned
host memory behind one CUDA event (ops/transfer.HostCopy), and at most
`max_inflight_windows` windows stay unread (1 and 2 frames a window while
the map is young). `_finalize_rec` then does the host half of each frame in
order: associations, visibility counts, provisional ids resolved to the
points the last keyframe created, and the reaction to the device's
decision, with keyframe work staged one step per finalized frame
(LocalMapper.dispatch_kf_stage / step_pending, the loop queue). A weak frame
rolls the chain back and re-tracks synchronously; a chain poisoned by a
loop correction, relocalization or reset resyncs from the host. The
schedule reads no clock and no event state: windows are read, stages
absorbed and reference counts adopted at fixed places in it, so two runs
give the same keyframes and poses (the JAX package absorbs whatever fetch
has landed). Monocular, localization-only and non-OK frames stay
synchronous.

Loop closing is on by default, as in the JAX package: with no vocabulary
given, one is trained from the first keyframe's descriptors. A LOST tracker
relocalizes through the loop closer's vocabulary and keyframe database
(BoW candidates -> descriptor match -> EPnP RANSAC -> pose LM -> projection
rounds through K2 at 8192 rows). `localization_only` suppresses keyframes
and the auto-reset.

Lines (`ldType: LBDFloat`) come from stored detections where the config
gives `lineDetectionsPath`, and otherwise from the native detector
(frontend/line_extract.py) run on both views of the frame on the device.

A map restored by `System.load_map` goes through `restore_map`: the loop
closer's keyframe database is rebuilt from the stored keyframes and the
tracker starts LOST, so the next frame relocalizes against the map; in
localization mode the tracker never initializes a map of its own.

The per-frame tracking math (`_track_core`, and the chained step around it)
takes a leading sequence axis: `_step_batch` runs it once for several
trackers (the multi-sequence driver, parallel/multi_seq.py) and reads every
result back in one copy, and the pipelined driver runs the chained step on
its members' stacked chain state; a single tracker is the S = 1 case.

RGB-D frames (`process_rgbd`) carry a virtual right coordinate from the
depth map and take the stereo path above. Monocular frames
(`process_mono`) have no depth: the first frame with more than 100
keypoints is held as the reference, and each later one is matched to it
(`matching.search_for_initialization`) and given to the H/F initializer
(optim/initializer.py) until it reconstructs; the two frames become
keyframes 0 and 1 at median scene depth 1, and tracking continues on the
path above with `ur = -1` on every keypoint, new points coming from the
local mapper's two-view triangulation. Lines are stereo-seeded and stay off
for both.
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..config import SlamConfig
from ..frontend import line_extract, line_match, matching
from ..frontend.frame import (FrameData, build_frame_mono,
                              build_frame_pair, build_frame_rgbd)
from ..frontend.line_extract import LineDetConfig
from ..geometry.camera import backproject
from ..io import trajectory as traj
from ..io.stored_lines import StoredLineSource, stage_stored_pair
from ..ops import hamming
from ..loop.bow import Vocabulary
from ..loop.closing import LoopCloser, project_match
from ..ops.transfer import HostCopy, upload
from ..optim import initializer, pnp, pose_opt
from ..slammap.map_store import MapStore
from . import local_mapping, mapper_fast
from .kf_cache import KfCache

# the line step's joint point+line pose LM: rounds x iterations
LINE_LM_ROUNDS, LINE_LM_ITERS = 2, 6


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


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :] (or x[..., idx] for a per-keypoint vector) along the
    keypoint axis, per entry of the leading axes."""
    idx = idx.long()
    if x.dim() == idx.dim():
        return torch.take_along_dim(x, idx, dim=-1)
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _track_core(cam, T_pred: torch.Tensor, last_feats: matching.FrameFeatures,
                last_ptpos: torch.Tensor, last_haspt: torch.Tensor,
                last_ismap: torch.Tensor, cur: matching.FrameFeatures,
                depth: torch.Tensor, view: matching.MapPointView,
                inv_sigma2_lut: torch.Tensor, n_levels: int, scale: float,
                min_mm: int, close_depth: float,
                last_prov: torch.Tensor | None = None) -> dict:
    """The per-frame tracking math: motion-model association (narrow, else
    wide) -> pose LM -> local-map projection search -> pose LM -> stats, and
    the next frame's motion-model state (associated features keep their
    landmark position; close unassociated ones seed from stereo depth).
    Returns a dict of device tensors. Every argument may carry a leading
    sequence axis S (T_pred (S, 4, 4), features (S, N, ...), view
    (S, P, ...)): S frames tracked at once, each against its own last frame
    and local map (counterpart of lldslam_tpu/parallel/multi_seq.py
    `batched_track_step`); the results carry it too.

    Provisional identity (`last_prov` (N,) int32, -1 none): the feature
    index, in the last keyframe, of the point the pipelined path expects a
    last-frame feature to become (see `_prov_update`). It is carried
    through the last-frame match (`carried`), and a carried feature counts
    as a map point in the keyframe statistics; the host resolves it to the
    created point id. None (or all -1) carries nothing and leaves every
    result as without it. `close_unassoc` marks the close features without
    an association: the points a keyframe at this frame would create."""
    # --- motion-model association ---
    with tracing.span("track.motion_match"):
        obs = torch.cat([cur.xy, cur.ur[..., None]], dim=-1)
        lut = inv_sigma2_lut[cur.octave.long()]
        is_stereo = cur.ur >= 0
        kp2last_a = matching.match_last_frame(
            cam, T_pred, last_feats, last_ptpos, last_haspt, cur,
            n_levels=n_levels, scale=scale, radius=7.0)
        kp2last_b = matching.match_last_frame(
            cam, T_pred, last_feats, last_ptpos, last_haspt, cur,
            n_levels=n_levels, scale=scale, radius=14.0)
        kp2last = torch.where((kp2last_a >= 0).sum(-1, keepdim=True) >= 20,
                              kp2last_a, kp2last_b)
        n_mm = (kp2last >= 0).sum(-1)
        has_mm = n_mm >= min_mm
        li = torch.clamp(kp2last, min=0)
        pobs1 = pose_opt.PointPoseObs(X=_rows(last_ptpos, li), obs=obs,
                                      inv_sigma2=lut, is_stereo=is_stereo,
                                      valid=(kp2last >= 0) & cur.valid)
    with tracing.span("track.pose_lm"):
        T1, pt_in1, _, _ = pose_opt.optimize_pose(cam, T_pred, pobs1,
                                                   site="track")
        T1 = torch.where(has_mm[..., None, None], T1, T_pred)
        kp2last = torch.where(pt_in1 & has_mm[..., None], kp2last, -1)
        li = torch.clamp(kp2last, min=0)

    # --- local-map association + final pose ---
    with tracing.span("track.map_search"):
        _, kp2pt_l, _, in_frustum = matching.search_by_projection(
            cam, T1, view, cur, n_levels=n_levels, scale=scale, th=1.0)
        use_l = kp2pt_l >= 0
        X2 = torch.where(use_l[..., None],
                         _rows(view.pos, torch.clamp(kp2pt_l, min=0)),
                         _rows(last_ptpos, li))
        valid2 = (use_l | (kp2last >= 0)) & cur.valid
        pobs2 = pose_opt.PointPoseObs(X=X2, obs=obs, inv_sigma2=lut,
                                      is_stereo=is_stereo, valid=valid2)
    with tracing.span("track.pose_lm"):
        T2, pt_in2, _, _ = pose_opt.optimize_pose(cam, T1, pobs2,
                                                   site="track")

    with tracing.span("track.tail"):
        final_ok = valid2 & pt_in2
        # map-only association: a local-view hit is a map point; a
        # last-frame hit inherits the flag (temporal seeds are not map
        # points), and so does a carried provisional identity
        ismap2 = use_l | ((kp2last >= 0) & _rows(last_ismap, li))
        if last_prov is None:
            carried = torch.full_like(kp2last, -1)
        else:
            carried = torch.where((kp2last >= 0) & final_ok,
                                  _rows(last_prov, li), -1)
            ismap2 = ismap2 | (carried >= 0)
        map_ok = final_ok & ismap2
        close = (depth > 0) & (depth < close_depth) & cur.valid
        stats = torch.stack([n_mm, map_ok.sum(-1), (close & map_ok).sum(-1),
                             (close & ~map_ok).sum(-1), cur.valid.sum(-1),
                             ((cur.ur >= 0) & cur.valid).sum(-1)], dim=-1)
        # next-frame chain state with temporal seeding (inv_ex: no host
        # check)
        T_wc = torch.linalg.inv_ex(T2)[0]
        Xc = backproject(cam, cur.xy, torch.clamp(depth, min=1e-6))
        Xw_depth = Xc @ T_wc[..., :3, :3].transpose(-1, -2) \
            + T_wc[..., None, :3, 3]
        ptpos = torch.where(final_ok[..., None], X2, Xw_depth)
    return dict(
        T=T2, stats=stats, kp2last=kp2last, kp2pt_l=kp2pt_l, ok=map_ok,
        in_frustum=in_frustum, final=final_ok, carried=carried,
        close_unassoc=close & ~final_ok, ptpos=ptpos, haspt=final_ok | close,
        ismap=map_ok)


def _kf_decision(stats: torch.Tensor, since_kf: torch.Tensor,
                 kf_scal: torch.Tensor, min_gap: int, max_gap: int):
    """NeedNewKeyFrame on the device, from a step's stats (n_mm, n_in,
    tracked_close, untracked_close, ...), so the pipelined host reacts to a
    decision taken at frame rate. since_kf: frames since the last fired
    decision (int32); kf_scal (2,) float32 [ref_m, kappa]: the reference
    keyframe's tracked-point count, refreshed at a decision to
    kappa * n_in (kappa: the host's last measured ref_matches / n_in).
    Returns (decide int32, since', kf_scal'); leading axes pass through."""
    n_in = stats[..., 1]
    tracked_close, untracked_close = stats[..., 2], stats[..., 3]
    ref_m, kappa = kf_scal[..., 0], kf_scal[..., 1]
    gap = since_kf + 1
    weak = n_in.to(torch.float32) < 0.75 * ref_m
    need_close = (tracked_close < 100) & (untracked_close > 70)
    decide = (n_in > 15) & (gap >= min_gap) \
        & (weak | need_close | (gap >= max_gap))
    since2 = torch.where(decide, torch.zeros_like(gap), gap)
    refm2 = torch.where(decide, kappa * n_in.to(torch.float32), ref_m)
    return decide.to(torch.int32), since2, torch.stack([refm2, kappa], -1)


def _prov_update(decide: torch.Tensor, carried: torch.Tensor,
                 close_unassoc: torch.Tensor) -> torch.Tensor:
    """The next frame's provisional identities: where the decision fired,
    the frame's close unassociated features (the points the keyframe will
    create) by their own feature index; elsewhere the carried table."""
    n = carried.shape[-1]
    fresh = torch.where(close_unassoc, torch.arange(
        n, dtype=torch.int32, device=carried.device), -1)
    return torch.where(decide[..., None] > 0, fresh, carried)


def _track_step_chained(cam, T_prev: torch.Tensor, vel_prev: torch.Tensor,
                        last_feats: matching.FrameFeatures,
                        last_ptpos: torch.Tensor, last_haspt: torch.Tensor,
                        cur: matching.FrameFeatures, depth: torch.Tensor,
                        view: matching.MapPointView,
                        inv_sigma2_lut: torch.Tensor,
                        last_ismap: torch.Tensor, last_prov: torch.Tensor,
                        since_kf: torch.Tensor, kf_scal: torch.Tensor,
                        n_levels: int, scale: float, min_mm: int,
                        close_depth: float, min_gap: int,
                        max_gap: int) -> dict:
    """The pipelined step: T_pred = vel_prev @ T_prev, `_track_core`, the
    keyframe decision and the provisional-identity update, and the velocity
    vel = T @ T_prev^-1, all on the device with no host sync, so the next
    frame can be dispatched before this one's results are read. Returns
    `_track_core`'s dict plus decide, since, scal (the decision chain),
    prov (next last_prov) and vel."""
    step = _track_core(cam, vel_prev @ T_prev, last_feats, last_ptpos,
                       last_haspt, last_ismap, cur, depth, view,
                       inv_sigma2_lut, n_levels, scale, min_mm, close_depth,
                       last_prov=last_prov)
    return _chain_tail(step, step["T"], T_prev, since_kf, kf_scal, min_gap,
                       max_gap)


def _chain_tail(step: dict, T: torch.Tensor, T_prev: torch.Tensor,
                since_kf, kf_scal, min_gap: int, max_gap: int) -> dict:
    with tracing.span("track.tail"):
        decide, since2, scal2 = _kf_decision(step["stats"], since_kf,
                                             kf_scal, min_gap, max_gap)
        return dict(step, T=T, decide=decide, since=since2, scal=scal2,
                    prov=_prov_update(decide, step["carried"],
                                      step["close_unassoc"]),
                    vel=T @ torch.linalg.inv_ex(T_prev)[0])


def _track_step_chained_lines(cam, T_prev, vel_prev, last_feats, last_ptpos,
                              last_haspt, cur, depth, view, inv_sigma2_lut,
                              last_ismap, last_prov, since_kf, kf_scal,
                              n_levels, scale, min_mm, close_depth, min_gap,
                              max_gap, line_view, fl: line_match.FrameLines,
                              gamma: float, md_thr: float) -> dict:
    """`_track_step_chained` with the line step chained in (one frame, no
    sequence axis): association with the local map lines `line_view` and
    the joint point+line pose LM from the point step's pose, on its
    association inliers. T is the line-refined pose (the velocity follows
    it); det2ln (view index per line inlier) and n_line join the dict."""
    step = _track_core(cam, vel_prev @ T_prev, last_feats, last_ptpos,
                       last_haspt, last_ismap, cur, depth, view,
                       inv_sigma2_lut, n_levels, scale, min_mm, close_depth,
                       last_prov=last_prov)
    with tracing.span("track.line_step"):
        T3, det2ln, n_line = _line_step(
            cam, step["T"], line_view, fl,
            _line_point_obs(cur, step, inv_sigma2_lut), gamma, md_thr)
    out = _chain_tail(step, T3, T_prev, since_kf, kf_scal, min_gap, max_gap)
    out.update(det2ln=det2ln, n_line=n_line)
    return out


def _line_point_obs(cur: matching.FrameFeatures, step: dict,
                    inv_sigma2_lut: torch.Tensor) -> pose_opt.PointPoseObs:
    """The point observations of the joint point+line pose LM: the step's
    association inliers only (freshly depth-seeded rows have zero residual
    at the step's pose and would anchor the refinement there)."""
    return pose_opt.PointPoseObs(
        X=step["ptpos"], obs=torch.cat([cur.xy, cur.ur[..., None]], dim=-1),
        inv_sigma2=inv_sigma2_lut[cur.octave.long()],
        is_stereo=cur.ur >= 0, valid=step["final"])


def _read_back(step: dict) -> list[dict]:
    """The host half of a batched step's results, per sequence, in one
    device-to-host copy: T (4, 4) float32, stats (6 ints), kp2last,
    kp2pt_l and carried int32, ok and in_frustum bool."""
    S = step["T"].shape[0]
    i32 = lambda k: step[k].reshape(S, -1).to(torch.int32)
    parts = [step["T"].reshape(S, 16).contiguous().view(torch.int32)] + [
        i32(k) for k in ("stats", "kp2last", "kp2pt_l", "ok", "in_frustum",
                         "carried")]
    cuts = np.cumsum([p.shape[1] for p in parts])[:-1]
    tracing.count("host_waits")
    packed = torch.cat(parts, dim=1).cpu().numpy()
    out = []
    for row in packed:
        T, stats, kp2last, kp2pt_l, ok, in_frustum, carried = \
            np.split(row, cuts)
        out.append(dict(T=T.view(np.float32).reshape(4, 4).copy(),
                        stats=[int(x) for x in stats], kp2last=kp2last,
                        kp2pt_l=kp2pt_l, ok=ok.astype(bool),
                        in_frustum=in_frustum.astype(bool), carried=carried))
    return out


def _copy_wait(copy: HostCopy, ms: list) -> list:
    """A window's host copy, waited for in a `copy.wait` span on the
    window's first frame's record; every frame of the window (`ms`, their
    records) gets its share of the wait as `t_get`."""
    with tracing.frame(ms[0]), tracing.span("copy.wait") as sp:
        hosts = copy.result()
    for m in ms:
        m.t_get = sp.seconds / len(ms)
    return hosts


def _line_step(cam, T: torch.Tensor, view, fl: line_match.FrameLines,
               pobs: pose_opt.PointPoseObs, gamma: float, md_thr: float):
    """Association of the frame's lines with the local map lines `view`
    (x0, dir, desc, octave, valid), then the joint point+line pose LM from
    T (LINE_LM_ROUNDS x LINE_LM_ITERS; one kernel launch on the card).
    Returns (T (4, 4), det2ln (L,) view index
    of each line inlier, -1 elsewhere, n_line (0-d))."""
    x0, dr, desc, oct_, valid = view
    with tracing.span("track.line_assoc"):
        _, det2ln = line_match.associate_lines(cam, T, x0, dr, desc, oct_,
                                               valid, fl, md_thr=md_thr)
    with tracing.span("track.line_lm"):
        idx = torch.clamp(det2ln, min=0).long()
        lobs = pose_opt.LinePoseObs(
            X0=x0[idx], d=dr[idx], x1_l=fl.kl.p1, x2_l=fl.kl.p2,
            x1_r=fl.p1_r, x2_r=fl.p2_r, octave=fl.kl.octave,
            has_right=fl.has_stereo, valid=(det2ln >= 0) & fl.kl.valid)
        T3, _, ln_in, _ = pose_opt.optimize_pose(
            cam, T, pobs, lobs, gamma=gamma, rounds=LINE_LM_ROUNDS,
            iters=LINE_LM_ITERS, site="line")
    det2ln = torch.where(ln_in, det2ln, -1)
    return T3, det2ln, (det2ln >= 0).sum()


def _line_fields(fl: line_match.FrameLines) -> dict:
    """The frame lines a keyframe keeps (MapStore.add_keyframe_lines keys,
    plus the stereo-triangulated X0 and d in the camera frame)."""
    return dict(p1=fl.kl.p1, p2=fl.kl.p2, p1r=fl.p1_r, p2r=fl.p2_r,
                has_r=fl.has_stereo, octave=fl.kl.octave, desc=fl.kl.desc,
                valid=fl.kl.valid, X0=fl.X0, d=fl.d)


def _snapshot_fields(fd: FrameData) -> dict:
    """The frame's features and depth as a keyframe stores them."""
    f = fd.feats
    return dict(xy=f.xy, ur=f.ur, octave=f.octave, angle=f.angle,
                desc=f.desc, valid=f.valid, depth=fd.depth)


def _snapshot_host(h: dict):
    """(features dict, depth) from the host copy of `_snapshot_fields`."""
    feats = {k: h[k] for k in ("xy", "ur", "octave", "angle", "valid")}
    feats["desc"] = h["desc"].view(np.uint32)
    return feats, h["depth"]


def warmup_mono_programs(cam, n_kp: int, device="cuda") -> None:
    """Run the monocular bootstrap's device work once on dummy inputs at
    `n_kp` keypoints a frame: the windowed initialization match, then the
    H/F initializer's two RANSACs and both reconstructions (the bootstrap
    runs one of them). Its SVDs are batched over 256 hypotheses, n_kp
    points and their pose candidates, shapes whose solver routines a warm-up
    at other shapes does not reach. The hypothesis draw takes a generator
    of its own; no map, tracker state or shared generator is read or
    written. Waits for the card at the end."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    t = lambda a: upload(a, dev)
    X = rng.uniform((-2.0, -1.5, 4.0), (2.0, 1.5, 8.0), (n_kp, 3))
    px = lambda P: np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx,
                             cam.fy * P[:, 1] / P[:, 2] + cam.cy], -1)
    x1 = t(px(X).astype(np.float32))
    x2 = t(px(X - (0.2, 0.0, 0.0)).astype(np.float32))
    valid = t(np.ones(n_kp, bool))
    zero = t(np.zeros(n_kp, np.float32))
    desc = t(rng.integers(-2**31, 2**31, (2, n_kp, 8), dtype=np.int32))
    feats = [matching.FrameFeatures(xy=x, ur=zero - 1.0,
                                    octave=zero.to(torch.int32), angle=zero,
                                    desc=d, valid=valid)
             for x, d in ((x1, desc[0]), (x2, desc[1]))]
    matching.search_for_initialization(*feats)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    H, _, inh, F, _, inf_ = initializer.ransac_models(
        x1, x2, valid, *initializer.draw_hypotheses(valid, gen))
    initializer.reconstruct_h(cam, H, x1, x2, inh)
    initializer.reconstruct_f(cam, F, x1, x2, inf_)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the host-bound results of a pipelined step
_HOST_KEYS = ("T", "stats", "decide", "kp2last", "kp2pt_l", "ok",
              "in_frustum", "carried")


@dataclass
class FrameLog:
    """Per-frame trajectory bookkeeping entry."""

    timestamp: float
    T_cr: np.ndarray      # pose relative to reference KF
    ref_kf: int
    lost: bool


@dataclass
class TrackMetrics:
    """Per-frame telemetry: the frame's record of spans and counters
    (lldslam_tpu_torch/tracing.py); t_* are wall-clock seconds, each read
    from its span."""

    frame_id: int = 0
    state: str = ""
    n_kp: int = 0
    n_stereo: int = 0
    n_motion_matches: int = 0
    n_inliers: int = 0
    new_kf: bool = False
    reloc_kf: int = -1      # keyframe relocalized against on this frame
    n_points: int = 0
    n_kfs: int = 0
    n_line_matches: int = 0   # line inliers of the joint pose LM
    n_lines: int = 0          # valid map lines
    t_build: float = 0.0      # `build` (a batched build's share)
    t_kf: float = 0.0         # `kf.create`
    t_dispatch: float = 0.0   # `dispatch` (a batched step's share)
    t_get: float = 0.0        # `copy.wait`: its share of the window's wait
    # (name, start_ns, end_ns, parent index), the root `frame` first
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)


class StereoTracker:
    def __init__(self, cfg: SlamConfig, store: MapStore | None = None,
                 enable_loops: bool = True,
                 vocabulary: Vocabulary | None = None,
                 pipeline: bool = False, pipeline_depth: int = 2,
                 readback_window: int = 3, device="cuda"):
        """pipeline: the pipelined schedule (module docstring);
        readback_window: frames per host copy. pipeline_depth is accepted
        for the JAX package's signature; no schedule reads it."""
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
        # one a keyframe: its id (kf) and frame id (fid), and the host
        # seconds of its mapper step (`kf.mapper`) and loop step
        # (`loop.query`, staged on the pipelined route)
        self.kf_timings: list[dict] = []
        self.localization_only = False
        self._reloc_gen = torch.Generator(device=self.device)
        self._reloc_gen.manual_seed(7)
        # last-frame state for the motion model (device tensors)
        self._last_feats = None
        self._last_ptpos = None    # (N, 3) world position per keypoint
        self._last_haspt = None    # (N,) bool
        self._last_ismap = None    # (N,) bool: position is a real MapPoint
        self._last_prov = None     # (N,) int32 provisional identity
        self._last_kp2pt = None    # (N,) np global point id
        # feature -> created point id of the last keyframe: resolves the
        # provisional identities carried by later frames
        self._prov_kf_pid = None
        self._inv_sigma2_lut = torch.from_numpy(np.power(
            1.0 / self.orb.scale ** 2, np.arange(self.orb.n_levels))
            .astype(np.float32)).to(self.device)
        self._has_velocity = False
        self._view = None
        self._view_pid = None
        self._reloc_kp2pt = None   # kp -> point id of the last relocalization
        # monocular bootstrap: set by process_mono; the held reference frame
        self._mono = False
        self._init_ref = None
        # line pipeline: stored detections (<detections_path>/{left,right},
        # or detections_path and descriptors_path as the two views), the
        # configured mdThr applying directly on their descriptor scale; or,
        # without a detections path, the native detector on both views
        self.enable_lines = cfg.line.enabled
        self.line_view_cap = 512
        self.line_kf_times: dict[str, float] = {}
        self._cur_fl = None
        self._cur_det2ln = None
        self._line_source = None
        if self.enable_lines:
            self.line_cfg = LineDetConfig(max_lines=self.store.n_ln_det,
                                          min_len=cfg.line.min_line_len)
            if (cfg.line.ld_type.lower() == "lbdfloat"
                    and cfg.line.detections_path):
                base = Path(cfg.line.detections_path)
                if (base / "left").is_dir():
                    left, right = base / "left", base / "right"
                else:
                    left = base
                    right = Path(cfg.line.descriptors_path or base)
                dim = self.store.ln_desc.shape[1]
                self._line_source = (
                    StoredLineSource(left, cap=self.store.n_ln_det,
                                     desc_dim=dim),
                    StoredLineSource(right, cap=self.store.n_ln_det,
                                     desc_dim=dim))
                self._md_gate = float(cfg.line.md_thr)
            else:
                # native descriptors are L2-normalized: mdThr maps onto their
                # gate in proportion to its LBDMOD default (2.0)
                self._md_gate = float(
                    self.line_cfg.desc_thr * cfg.line.md_thr / 2.0)
            self._refresh_line_view()
        self.kf_cache = KfCache(n_slots=32, n_kp=self.store.n_kp,
                                device=self.device)
        self.mapper = local_mapping.LocalMapper(
            self.store, cfg, cache=self.kf_cache, device=self.device)
        # pipelined mode (module docstring)
        self.pipeline = pipeline
        self.readback_window = max(1, readback_window)
        # copied windows left unread before the oldest is finalized
        self.max_inflight_windows = 3
        self._pending: list[dict] = []     # dispatched, not yet copied
        self._windows: deque = deque()     # (records, HostCopy), oldest first
        self._chain = None                 # device T, vel, since, scal
        self._resync = True
        self._refm_host = None             # ([ref_m, kappa], keyframe fid)
        # measured ref_matches / n_in at the last keyframe: calibrates the
        # device decision's reference count
        self._kappa = 0.7
        self._pending_loops: deque = deque()   # [kf_id, staged words|None]
        if pipeline:
            self._pipeline_mapper()
        # loop closing: the vocabulary given, or one trained from the first
        # keyframe's descriptors at initialization
        self.enable_loops = enable_loops
        self.vocabulary = vocabulary
        self.loop_closer = None
        if enable_loops and vocabulary is not None:
            self._make_loop_closer()

    def _pipeline_mapper(self):
        """Pipelined wiring of a (new) mapper and store: the tracking view
        pinned at 4096 rows unless pinned already, the load-adaptive BA
        cadence, staged line retriangulation."""
        if self.mapper.fixed_tv_cap is None:
            self.mapper.fixed_tv_cap = 4096
        self.mapper.adaptive_ba_cadence = True
        self.store.staged_retriangulation = True

    def _make_loop_closer(self):
        self.loop_closer = LoopCloser(self.store, self.vocabulary, self.cfg,
                                      device=self.device)
        self.mapper.on_kf_culled = self.loop_closer.db.erase

    # ------------------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def _image(self, img: np.ndarray) -> torch.Tensor:
        """A frame on the device, as uint8 when its values fit."""
        if img.dtype != np.uint8 and img.max(initial=0.0) <= 255.0:
            img = img.astype(np.uint8)
        return self._t(img)

    def stage_pair(self, img_l: np.ndarray, img_r: np.ndarray) -> torch.Tensor:
        """A stereo pair on the device as one (2, H, W) upload (uint8 when
        its values fit), for `process(..., pair_dev=)`: staging frames
        ahead takes the upload out of the tracking loop."""
        if img_l.dtype != np.uint8 and img_l.max(initial=0.0) <= 255.0:
            img_l, img_r = img_l.astype(np.uint8), img_r.astype(np.uint8)
        return self._t(np.stack([img_l, img_r]))

    def process(self, img_l: np.ndarray | None, img_r: np.ndarray | None,
                timestamp: float = 0.0, pair_dev: torch.Tensor | None = None,
                lines_dev=None):
        """Track one stereo pair; returns (T_cw (4,4) np, TrackMetrics).
        pair_dev: the pair staged by `stage_pair` (then the images may be
        None); lines_dev: the frame's (left, right) KeyLines staged by
        io.stored_lines.stage_stored_pair, in place of the stored source.
        In pipelined mode the result is that of the last frame finalized
        in this call, or (current pose, None) when none was."""
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        with tracing.frame(m):
            with tracing.span("build") as sp:
                pair = pair_dev if pair_dev is not None \
                    else self.stage_pair(img_l, img_r)
                fd = build_frame_pair(pair, self.cam, self.orb)
                if self.enable_lines:
                    self._cur_fl = self._frame_lines(pair, lines_dev)
            m.t_build = sp.seconds
            return self._process_fd(fd, timestamp, m)

    def _frame_lines(self, pair: torch.Tensor, lines_dev):
        """The frame's stereo-matched lines: the staged or stored
        detections, or the native detector's on both views."""
        if lines_dev is not None:
            kl, kr = lines_dev
        elif self._line_source is not None:
            kl, kr = stage_stored_pair(*self._line_source, self.frame_id,
                                       device=self.device)
        else:
            with tracing.span("lines.detect"):
                kl = line_extract.detect_lines(pair[0], self.line_cfg)
                kr = line_extract.detect_lines(pair[1], self.line_cfg)
        with tracing.span("lines.stereo_match"):
            return line_match.match_stereo_lines(
                self.cam, kl, kr, md_thr=self._md_gate,
                min_len=self.cfg.line.min_line_len)

    def process_rgbd(self, img: np.ndarray, depthmap: np.ndarray,
                     timestamp: float = 0.0, depth_factor: float = 1.0):
        """Track one RGB-D frame: gray image and registered depth map (its
        values times depth_factor are metres, 0 for no reading)."""
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        with tracing.frame(m):
            with tracing.span("build") as sp:
                self._cur_fl = None   # lines are stereo-seeded
                fd = build_frame_rgbd(
                    self._image(img), self._t(np.asarray(depthmap,
                                                         np.float32)),
                    self.cam, self.orb, depth_factor=depth_factor)
            m.t_build = sp.seconds
            return self._process_fd(fd, timestamp, m)

    def process_mono(self, img: np.ndarray, timestamp: float = 0.0):
        """Track one monocular frame: the H/F bootstrap until it succeeds,
        then the standard path with monocular observations."""
        self._mono = True
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        with tracing.frame(m):
            with tracing.span("build") as sp:
                self._cur_fl = None
                fd = build_frame_mono(self._image(img), self.orb)
            m.t_build = sp.seconds
            return self._process_fd(fd, timestamp, m)

    def _process_fd(self, fd: FrameData, timestamp: float, m: TrackMetrics):
        if self.pipeline and self.state == TrackState.OK and not self._mono \
                and not self.localization_only:
            return self._process_pipelined(fd, timestamp, m)
        self.flush()
        with tracing.span("track.sync"):
            if self.state == TrackState.NOT_INITIALIZED:
                # localization mode tracks against a map, never starts one
                if not self.localization_only:
                    self._initialize(fd, timestamp, m)
            else:
                self._track(fd, timestamp, m)
        self._resync = True   # the device chain reseeds at its next dispatch
        self._finish_metrics(m)
        tracing.end_frame(m)
        return self.T_cw.copy(), m

    def _finish_metrics(self, m: TrackMetrics):
        if not m.state:  # a reset path may have recorded LOST already
            m.state = self.state.name
        m.n_points = int(self.store.pt_valid.sum())
        m.n_kfs = self.store.n_kf
        m.n_lines = int(self.store.ln_valid.sum())
        self.metrics.append(m)

    # ------------------------------------------------------------------
    # pipelined mode (module docstring). Records hold device tensors; the
    # only host reads are the windows' HostCopy results and the staged
    # mapping work's, each at a fixed place in the schedule.

    def _process_pipelined(self, fd: FrameData, timestamp: float,
                           m: TrackMetrics):
        ret = None
        cur_fl = self._cur_fl    # finalizing older records overwrites it
        if self._resync and (self._pending or self._windows):
            ret = self.flush()   # poisoned chain: settle the host first
        if self._resync or self._chain is None:
            self._chain = dict(
                T=self._t(self.T_cw), vel=self._t(self.velocity),
                since=self._t(np.int32(max(0, self.frame_id - 1
                                          - self.last_kf_frame))),
                scal=self._t(np.float32([self._ref_matches, self._kappa])))
            self._refm_host = None
            self._resync = False
        if self._refm_host is not None:
            self._chain["scal"] = self._adopted_scal(
                self._chain["since"], self._chain["scal"], self.frame_id)
        self._cur_fl = cur_fl
        with_lines = self.enable_lines and cur_fl is not None
        # minimum gap 3: the staged mapper is busy for about 3 finalized
        # frames after a keyframe (the reference waits for an idle mapper)
        min_gap = max(self.cfg.tracking.min_frames_between_kf, 3)
        max_gap = self.cfg.tracking.max_frames_between_kf
        if self.localization_only:
            # no keyframes: keep the device decision from ever firing
            min_gap = max_gap = 1 << 28
        c = self._chain
        prev = (self._last_feats, self._last_ptpos, self._last_haspt,
                self._last_ismap, self._last_prov)
        args = (self.cam, c["T"], c["vel"], self._last_feats,
                self._last_ptpos, self._last_haspt, fd.feats, fd.depth,
                self._view, self._inv_sigma2_lut, self._last_ismap,
                self._last_prov, c["since"], c["scal"], self.orb.n_levels,
                self.orb.scale, self.cfg.tracking.min_motion_matches,
                float(self.cfg.close_depth), min_gap, max_gap)
        with tracing.span("dispatch") as sp:
            if with_lines:
                out = _track_step_chained_lines(
                    *args, self._line_view, cur_fl,
                    float(self.cfg.line.gamma), self._md_gate)
            else:
                out = _track_step_chained(*args)
            host = {k: out[k] for k in _HOST_KEYS}
            host.update(_snapshot_fields(fd))
            if with_lines:
                host.update(det2ln=out["det2ln"], n_line=out["n_line"],
                            lines=_line_fields(cur_fl))
        m.t_dispatch = sp.seconds
        rec = dict(fd=fd, ts=timestamp, m=m, fid=self.frame_id, prev=prev,
                   view_pid=self._view_pid, host=host)
        if with_lines:
            rec.update(fl=cur_fl, line_view_ids=self._line_view_ids)
        # the chain moves on to new tensors: a record's `prev` stays valid
        self._chain = {k: out[k] for k in ("T", "vel", "since", "scal")}
        self._last_feats = fd.feats
        self._last_ptpos, self._last_haspt = out["ptpos"], out["haspt"]
        self._last_ismap, self._last_prov = out["ismap"], out["prov"]
        self._pending.append(rec)
        # young-map damper: while the map is young (and, with lines, while
        # map lines are sparse) short windows, one left unread
        young = self.store.n_kf < 4 or (
            with_lines and int(self.store.ln_valid.sum()) < 8)
        W = self.readback_window if self.store.n_kf >= 4 \
            else min(self.readback_window, 2)
        inflight = 1 if young else self.max_inflight_windows
        if len(self._pending) >= W:
            recs, self._pending = self._pending, []
            self._windows.append((recs, HostCopy([r["host"] for r in recs])))
            while len(self._windows) > inflight and not self._resync:
                ret = self._absorb_window()
            if self._resync and self._windows:
                # results computed from a poisoned chain: those frames go
                # through the resync path at the next call's flush
                self._pending = [r for recs_, _ in self._windows
                                 for r in recs_] + self._pending
                self._windows.clear()
        return ret if ret is not None else (self.T_cw.copy(), None)

    def _adopted_scal(self, since: torch.Tensor, scal: torch.Tensor,
                      fid: int) -> torch.Tensor:
        """The decision chain's [ref_m, kappa] for dispatching frame `fid`
        with the last keyframe's exact reference count and kappa taken in:
        kappa always, the count only when the device fired no decision
        after that keyframe (a later one's estimate is newer). A device-side
        select: no host sync."""
        host, kf_fid = self._refm_host
        self._refm_host = None
        new = self._t(host)
        same_ref = since == fid - 1 - kf_fid
        return torch.stack([torch.where(same_ref, new[0], scal[0]), new[1]])

    def _absorb_window(self):
        """Finalize the oldest copied window, frame by frame (waits on its
        copy's event alone)."""
        recs, copy = self._windows.popleft()
        hosts = _copy_wait(copy, [r["m"] for r in recs])
        ret = None
        for rec, h in zip(recs, hosts):
            rec["host"] = h
            ret = self._finalize_rec(rec)
        return ret

    def flush(self):
        """Finalize every in-flight pipelined frame and absorb the staged
        keyframe work (sequence end, resync, or before a synchronous
        frame). Returns the last finalized frame's (T_cw, metrics), or
        None."""
        ret = None
        while self._windows:
            ret = self._absorb_window()
        if self._pending:
            recs, self._pending = self._pending, []
            self._windows.append((recs, HostCopy([r["host"] for r in recs])))
            ret = self._absorb_window()
        self._flush_kf_pipeline()
        return ret

    def _flush_kf_pipeline(self):
        """Absorb the staged mapping, line and loop work now."""
        self.mapper.flush()
        self.store.absorb_retriangulate()
        self._adopt_view()
        self._match_loop_words()
        while self._pending_loops:
            self._absorb_loop()

    def _adopt_view(self):
        """Take the mapper's post-BA tracking view once a staged BA has
        produced it (its device tensors are ordered after the BA)."""
        if self.mapper.pending_view is not None:
            self._view, self._view_pid = self.mapper.pending_view
            self.mapper.pending_view = None

    def _step_kf_pipeline(self) -> bool:
        """One step of the staged keyframe work per finalized frame: the
        mapper's stage, the view, the loop queue's head once its words are
        in and the mapper idle. True when a loop correction rewrote the
        map (the chain then resyncs)."""
        with tracing.span("kf.stage"):
            self.mapper.step_pending()
            self._adopt_view()
            self._match_loop_words()
            if self._pending_loops and self._pending_loops[0][1] is not None \
                    and not self.mapper.busy:
                return self._absorb_loop()
            return False

    def _match_loop_words(self):
        """Attach the mapper's freshly absorbed BoW words to their queued
        loop entry."""
        if self.mapper.absorbed_words is not None:
            wkf, words = self.mapper.absorbed_words
            self.mapper.absorbed_words = None
            for e in self._pending_loops:
                if e[0] == wkf:
                    e[1] = words
                    break

    def _absorb_loop(self) -> bool:
        """The loop step of the queue's oldest keyframe (staged words, or
        the host descent when they never came); on a correction the
        tracker's pose is re-expressed through its corrected reference
        keyframe and the chain resyncs."""
        kf_id, words = self._pending_loops.popleft()
        if self.loop_closer is None:
            return False
        T_ref_old = self.store.kf_pose[self.ref_kf].copy()
        with tracing.span("loop.query") as sp:
            if words is None:
                corrected = self.loop_closer.process_keyframe(kf_id)
            else:
                corrected = self.loop_closer.finish_keyframe(kf_id, words)
        for entry in reversed(self.kf_timings):
            if entry["kf"] == kf_id:
                entry["loop"] += sp.seconds
                break
        if corrected:
            T_cr = self.T_cw @ np.linalg.inv(T_ref_old)
            self.T_cw = (T_cr @ self.store.kf_pose[self.ref_kf]).astype(
                np.float32)
            self._refresh_local_view()
            self._refresh_ref_matches()
            if self.enable_lines:
                self._refresh_line_view()
            self._resync = True
        return corrected

    def _finalize_rec(self, rec: dict):
        """The host half of one pipelined frame, in order: a step of the
        staged keyframe work, then (chain poisoned) a synchronous re-track,
        (weak: fewer than min_track_inliers) the chain rolled back and a
        synchronous re-track, or the frame's associations, provisional ids,
        visibility counts, pose and the reaction to the device decision.
        The frame's record is current throughout; its root span closes
        here."""
        m: TrackMetrics = rec["m"]
        with tracing.frame(m):
            with tracing.span("finalize"):
                self._finalize_host(rec, m)
            tracing.end_frame(m)
        return self.T_cw.copy(), m

    def _finalize_host(self, rec: dict, m: TrackMetrics):
        self._step_kf_pipeline()
        fd = rec["fd"]() if callable(rec["fd"]) else rec["fd"]
        if self._resync:
            # the predecessor was finalized synchronously: the _last_*
            # state is already its own, not the poisoned chain's
            self._cur_fl = rec.get("fl")
            with tracing.span("track.sync"):
                if self.state == TrackState.NOT_INITIALIZED:
                    self._initialize(fd, rec["ts"], m, fid=rec["fid"])
                else:
                    self._track(fd, rec["ts"], m, fid=rec["fid"])
            return self._finish_metrics(m)
        h = rec["host"]
        n_mm, n_in, tracked_close, untracked_close, n_kp, n_st = \
            (int(x) for x in h["stats"])
        m.n_motion_matches, m.n_kp, m.n_stereo = n_mm, n_kp, n_st
        if n_in < self.cfg.tracking.min_track_inliers:
            self._resync = True
            prev = rec["prev"]
            self._cur_fl = rec.get("fl")
            with tracing.span("track.sync"):
                (self._last_feats, self._last_ptpos, self._last_haspt,
                 self._last_ismap, self._last_prov) = \
                    prev() if callable(prev) else prev
                self._track(fd, rec["ts"], m, fid=rec["fid"])
            return self._finish_metrics(m)
        m.n_inliers = n_in
        self._cur_det2ln = None
        if "fl" in rec:
            self._cur_fl = rec["fl"]
            det2ln = h["det2ln"]
            self._cur_det2ln = np.where(
                det2ln >= 0, rec["line_view_ids"][np.maximum(det2ln, 0)],
                -1).astype(np.int32)
            m.n_line_matches = int(h["n_line"])
        pid = rec["view_pid"]
        kp2last, kp2pt_l = h["kp2last"], h["kp2pt_l"]
        kp2pt = np.where(
            kp2pt_l >= 0, pid[np.maximum(kp2pt_l, 0)],
            np.where(kp2last >= 0, self._last_kp2pt[np.maximum(kp2last, 0)],
                     -1)).astype(np.int32)
        kp2pt = self._resolve_provisional(kp2pt, h["carried"])
        kp2pt[~h["ok"]] = -1
        np.add.at(self.store.pt_visible, pid[h["in_frustum"] & (pid >= 0)], 1)
        np.add.at(self.store.pt_found, kp2pt[kp2pt >= 0], 1)
        T_np = h["T"]
        self.state = TrackState.OK
        self.velocity = (T_np @ np.linalg.inv(self.T_cw)).astype(np.float32)
        self.T_cw = T_np.astype(np.float32)
        if int(h["decide"]) > 0 and not self.localization_only:
            with tracing.span("kf.create") as sp:
                self._create_kf(fd, kp2pt, rec["ts"], rec["fid"],
                                snap=_snapshot_host(h),
                                lines_np=h.get("lines"), n_in_kf=n_in)
            m.t_kf = sp.seconds
            m.new_kf = True
        self._last_kp2pt = kp2pt
        self._log_frame(rec["ts"])
        self._finish_metrics(m)

    def _resolve_provisional(self, kp2pt: np.ndarray,
                             carried: np.ndarray) -> np.ndarray:
        """Features without an association that carry a provisional
        identity get the point the last keyframe created for it."""
        if self._prov_kf_pid is not None:
            sel = (kp2pt < 0) & (carried >= 0)
            kp2pt[sel] = self._prov_kf_pid[carried[sel]]
        return kp2pt

    # ------------------------------------------------------------------

    def _snapshot_np(self, fd: FrameData):
        """Host copy of the frame's features and depth."""
        fields = _snapshot_fields(fd)
        tracing.count("host_waits", len(fields))
        return _snapshot_host({k: v.cpu().numpy() for k, v in fields.items()})

    def _initialize(self, fd: FrameData, timestamp: float, m: TrackMetrics,
                    fid: int | None = None):
        """StereoInitialization: every stereo-depth'd keypoint becomes a map
        point, the frame becomes KF 0 at identity. Monocular input goes to
        the H/F bootstrap instead."""
        self._flush_kf_pipeline()
        if self._mono:
            return self._initialize_mono(fd, timestamp, m)
        fid = self.frame_id if fid is None else fid
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
        if self.enable_lines and self._cur_fl is not None:
            self._cur_det2ln = None
            self._create_kf_lines(kf)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = kf
        self.last_kf_frame = fid
        if self.enable_loops and self.loop_closer is None:
            self.vocabulary = Vocabulary.train(
                feats["desc"][feats["valid"]], k=8, L=3, seed=0)
            self._make_loop_closer()
        if self.loop_closer is not None:
            self.loop_closer.process_keyframe(kf)
        self.mapper.cache_frame(kf, fd.feats)
        self.state = TrackState.OK
        self._has_velocity = False
        kp2pt = np.full(self.store.n_kp, -1, np.int32)
        kp2pt[good] = ids
        self._refresh_local_view()
        self._refresh_ref_matches()
        if self.enable_lines:
            self._refresh_line_view()
        self._remember_frame(fd, kp2pt)
        self._log_frame(timestamp)
        m.new_kf = True
        m.n_inliers = len(ids)

    def _initialize_mono(self, fd: FrameData, timestamp: float,
                         m: TrackMetrics):
        """Monocular bootstrap: hold a reference frame, match the current
        frame to it (>= 100 matches, else it becomes the reference), run the
        H/F initializer with hypotheses from the tracker's generator, and
        build the two-keyframe map scaled to median depth 1. No BA here:
        the two-view solution is already the estimate, and a two-keyframe
        monocular BA drifts along the free scale."""
        snap = self._snapshot_np(fd)
        if self._init_ref is None:
            if int(snap[0]["valid"].sum()) > 100:
                self._init_ref = (fd, snap, timestamp)
            return
        ref_fd, ref_snap, ref_ts = self._init_ref
        idx_t = matching.search_for_initialization(ref_fd.feats, fd.feats)
        valid = idx_t >= 0
        if int(valid.sum()) < 100:
            self._init_ref = (fd, snap, timestamp)
            return
        x2 = fd.feats.xy[torch.clamp(idx_t, min=0)]
        ok, R, t, X, good = initializer.initialize(
            self.cam, ref_fd.feats.xy, x2, valid,
            *initializer.draw_hypotheses(valid, self._reloc_gen))
        if not ok:
            return   # keep the reference, try the next frame
        med = float(np.median(X[good][:, 2]))
        if med <= 0:
            self._init_ref = (fd, snap, timestamp)
            return
        X, t = X / med, t / med
        s = self.store
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = R
        T1[:3, 3] = t
        none = np.full(s.n_kp, -1, np.int32)
        kf0 = s.add_keyframe(np.eye(4, dtype=np.float32), ref_snap[0],
                             ref_snap[1], none, 0, ref_ts)
        kf1 = s.add_keyframe(T1, snap[0], snap[1], none.copy(),
                             self.frame_id, timestamp)
        idx = idx_t.cpu().numpy()
        sel = np.nonzero(good)[0]
        ids = s.create_points(kf0, sel, X[sel].astype(np.float32))
        s.kf_pt_ids[kf1, idx[sel]] = ids
        s.mark_obs_dirty()
        s.set_parent_from_covisibility(kf1)
        s.refresh_obs_counts()
        self.T_cw = T1
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = kf1
        self.last_kf_frame = self.frame_id
        if self.enable_loops and self.loop_closer is None:
            self.vocabulary = Vocabulary.train(
                snap[0]["desc"][snap[0]["valid"]], k=8, L=3, seed=0)
            self._make_loop_closer()
        if self.loop_closer is not None:
            self.loop_closer.process_keyframe(kf0)
            self.loop_closer.process_keyframe(kf1)
        self.mapper.cache_frame(kf0, ref_fd.feats)
        self.mapper.cache_frame(kf1, fd.feats)
        self.state = TrackState.OK
        self._has_velocity = False
        kp2pt = np.full(s.n_kp, -1, np.int32)
        kp2pt[idx[sel]] = ids
        self._refresh_local_view()
        self._refresh_ref_matches()
        self._remember_frame(fd, kp2pt)
        self._log_frame(timestamp)
        m.new_kf = True
        m.n_inliers = len(ids)
        self._init_ref = None

    def _remember_frame(self, fd: FrameData, kp2pt: np.ndarray,
                        step: dict | None = None):
        """Stash what the next frame's motion model needs: the device state
        of the step, or (at keyframes and initialization) positions rebuilt
        from the store and no provisional identities."""
        self._last_feats = fd.feats
        self._last_kp2pt = kp2pt
        if step is not None:
            self._last_ptpos = step["ptpos"]
            self._last_haspt = step["haspt"]
            self._last_ismap = step["ismap"]
            self._last_prov = step["carried"]
        else:
            self._last_prov = torch.full((self.store.n_kp,), -1,
                                         dtype=torch.int32,
                                         device=self.device)
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
        cap = self.mapper.fixed_tv_cap or local_mapping.view_capacity(len(ids))
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
        T_fb, _, _, _ = pose_opt.optimize_pose(self.cam, self._t(self.T_cw),
                                               pobs, site="ref_anchor")
        tracing.count("host_waits")
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
        tracing.count("host_waits", 2)
        idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
        kp2pt = np.full(s.n_kp, -1, np.int32)
        kp2pt[ok] = s.kf_pt_ids[self.ref_kf, idx[ok]]
        return kp2pt

    def _run_step(self, fd: FrameData, T_pred: np.ndarray):
        """One `_track_core` from T_pred; returns (host results, step)."""
        (out,) = self._step_batch(
            [self], matching.FrameFeatures(*(a[None] for a in fd.feats)),
            fd.depth[None], [T_pred])
        return out

    @staticmethod
    def _step_batch(trackers: list["StereoTracker"],
                    cur: matching.FrameFeatures, depth: torch.Tensor,
                    T_preds: list[np.ndarray]) -> list[tuple[dict, dict]]:
        """`_track_core` for S trackers of one configuration at once: frame
        s (cur, depth with a leading S) against tracker s's last frame and
        local-map view (equal view capacities), from T_preds[s]. One upload
        of the poses, one batched step, one read-back. Returns (host results,
        step slice) per tracker."""
        tr0 = trackers[0]
        stack = lambda xs: xs[0][None] if len(xs) == 1 else torch.stack(xs)
        per = lambda get: [get(tr) for tr in trackers]
        last = matching.FrameFeatures(*map(stack, zip(*per(
            lambda tr: tr._last_feats))))
        view = matching.MapPointView(*map(stack, zip(*per(
            lambda tr: tr._view))))
        step = _track_core(
            tr0.cam, tr0._t(np.stack(T_preds).astype(np.float32)), last,
            stack(per(lambda tr: tr._last_ptpos)),
            stack(per(lambda tr: tr._last_haspt)),
            stack(per(lambda tr: tr._last_ismap)), cur, depth, view,
            tr0._inv_sigma2_lut, tr0.orb.n_levels, tr0.orb.scale,
            tr0.cfg.tracking.min_motion_matches, float(tr0.cfg.close_depth),
            last_prov=stack(per(lambda tr: tr._last_prov)))
        hosts = _read_back(step)
        return [(h, {k: v[i] for k, v in step.items()})
                for i, h in enumerate(hosts)]

    def _attempt_reloc(self, fd: FrameData) -> np.ndarray | None:
        """Relocalization: BoW candidates (at most 5) -> ratio-0.7 mutual
        descriptor match (>= 15) -> EPnP RANSAC (>= 10 inliers) -> pose LM
        (>= 10) -> projection rounds at th 2.5 then 0.75 until >= 50
        inliers. Returns T_cw or None."""
        if self.loop_closer is None:
            return None
        s = self.store
        f = fd.feats
        voc, db = self.loop_closer.voc, self.loop_closer.db
        ids, vals = voc.bow_vector(f.desc, f.valid)
        cands = db.detect_reloc_candidates(ids, vals)[:5]
        tracing.count("host_waits", 2)
        xy, octave = f.xy.cpu().numpy(), f.octave.cpu().numpy()
        for kf in cands:
            has_kf = s.kf_kp_valid[kf] & (s.kf_pt_ids[kf] >= 0)
            idx, ok, _ = hamming.match_descriptors(
                f.desc, f.valid, self._t(s.kf_desc[kf].view(np.int32)),
                self._t(has_kf), max_dist=hamming.TH_LOW, ratio=0.7)
            tracing.count("host_waits", 2)
            idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
            sel = np.nonzero(ok)[0]
            if len(sel) < 15:
                continue
            pts = s.kf_pt_ids[kf, idx[sel]]
            n = min(len(sel), 512)
            s2 = (self.orb.scale ** (2.0 * octave[sel[:n]])).astype(np.float32)
            T, _, n_inl = pnp.ransac_pnp(
                self.cam, self._t(s.pt_pos[pts[:n]]), self._t(xy[sel[:n]]),
                self._t(s2), torch.ones(n, dtype=torch.bool,
                                        device=self.device),
                self._reloc_gen)
            tracing.count("host_waits")
            if int(n_inl) < 10:
                continue
            # robust refinement on the whole candidate set
            kp2pt = np.full(s.n_kp, -1, np.int32)
            kp2pt[sel] = pts
            T2, n_in = self._reloc_pose(fd, T, kp2pt)
            if n_in < 10:
                continue
            # projection rounds over the candidate's local map, wide window
            # first, then a narrow confirmation pass
            covis, _ = s.covisible_kfs(kf, min_shared=15, top=10)
            kfs = np.concatenate([[kf], covis]).astype(np.int32)
            pids = np.unique(s.kf_pt_ids[kfs])
            pids = pids[pids >= 0]
            pids = pids[s.pt_valid[pids]]
            for th in (2.5, 0.75):
                if n_in >= 50:
                    break
                tracing.count("host_waits")
                kp2pt_w = self._project_view_match(fd, pids,
                                                   T2.cpu().numpy(), th=th)
                kp2pt = np.where(kp2pt >= 0, kp2pt, kp2pt_w)
                T2, n_in = self._reloc_pose(fd, T2, kp2pt)
            if n_in >= 50:
                self.ref_kf = kf
                self._refresh_local_view()
                self._refresh_ref_matches()
                self._reloc_kp2pt = kp2pt
                tracing.count("host_waits")
                return T2.cpu().numpy().astype(np.float32)
        return None

    def _reloc_pose(self, fd: FrameData, T: torch.Tensor, kp2pt: np.ndarray):
        """Pose LM from T on the keypoint -> map point table; returns
        (T_cw tensor, n_inliers)."""
        X = self.store.pt_pos[np.maximum(kp2pt, 0)]
        rows = np.where(kp2pt >= 0, np.arange(len(X)), -1)
        pobs = _gather_pose_obs(self.cam, self._t(X), self._t(rows),
                                fd.feats, self._inv_sigma2_lut)
        T2, _, _, n_in = pose_opt.optimize_pose(self.cam, T, pobs,
                                                site="reloc")
        tracing.count("host_waits")
        return T2, int(n_in)

    def _project_view_match(self, fd: FrameData, pids: np.ndarray,
                            T_cw: np.ndarray, th: float) -> np.ndarray:
        """Project the given map points into the current frame and match
        (the relocalization SearchByProjection, K2 at PROJECT_CAP rows).
        Returns kp2pid (N,) global ids."""
        return project_match(self.store, fd.feats, pids, T_cw, th, "reloc")

    def _reset_full(self):
        """Auto-reset when tracking is lost right after initialization:
        clear the map, database and trajectory bookkeeping, reinitialize.
        In-flight pipelined frames stay queued: each is finalized through
        the resync path, the first good one initializing the new map."""
        self.store = MapStore(self.cam, self.orb)
        self.kf_cache.clear()
        fixed_tv_cap = self.mapper.fixed_tv_cap
        self.mapper = local_mapping.LocalMapper(
            self.store, self.cfg, cache=self.kf_cache, device=self.device)
        self.mapper.fixed_tv_cap = fixed_tv_cap
        if self.pipeline:
            self._pipeline_mapper()
        self._pending_loops.clear()
        self._prov_kf_pid = None
        self._chain = None
        self._resync = True
        if self.loop_closer is not None:
            self._make_loop_closer()
        self.state = TrackState.NOT_INITIALIZED
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = -1
        self.last_kf_frame = -1
        self.logs.clear()
        self._view = None
        self._view_pid = None
        if self.enable_lines:
            self._refresh_line_view()

    def restore_map(self):
        """Make the map just loaded into the store trackable: rebuild the
        loop closer's keyframe database from the stored keyframes'
        descriptors (training the vocabulary from the first one when loops
        are on and none was given) and, on a non-empty map, start LOST at
        the newest valid keyframe, so that the next frame relocalizes
        against the map. The JAX package restores only the store (its next
        frame starts a second map at the identity); this is the port's
        divergence."""
        s = self.store
        kfs = np.nonzero(s.kf_valid[:s.n_kf])[0]
        self.kf_cache.clear()
        self._last_feats = None
        self._view = None
        self._view_pid = None
        self.velocity = np.eye(4, dtype=np.float32)
        self._has_velocity = False
        if len(kfs) == 0:
            self.state = TrackState.NOT_INITIALIZED
            return
        if self.enable_loops and self.vocabulary is None:
            k0 = kfs[0]
            self.vocabulary = Vocabulary.train(
                s.kf_desc[k0][s.kf_kp_valid[k0]], k=8, L=3, seed=0)
        if self.enable_loops:
            self._make_loop_closer()          # an empty database
            for kf in kfs:
                self.loop_closer.db.add(int(kf), *self.loop_closer.voc
                                        .bow_vector(s.kf_desc[kf],
                                                    s.kf_kp_valid[kf]))
        self.ref_kf = int(kfs[-1])
        self.last_kf_frame = -1
        self.T_cw = s.kf_pose[self.ref_kf].copy()
        self.state = TrackState.LOST

    def _predict_pose(self, fd: FrameData) -> np.ndarray:
        """The pose a tracked frame starts from: the motion model (velocity
        times the last pose), or, with no velocity (right after
        initialization or relocalization), the reference keyframe anchor
        when it finds >= 10 associations."""
        if not self._has_velocity and self.ref_kf >= 0 \
                and self.state == TrackState.OK:
            T_anchor = self._ref_anchor_pose(fd)
            if T_anchor is not None:
                return T_anchor.astype(np.float32)
        return (self.velocity @ self.T_cw).astype(np.float32)

    def _track(self, fd: FrameData, timestamp: float, m: TrackMetrics,
               fid: int | None = None):
        fid = self.frame_id if fid is None else fid
        self._flush_kf_pipeline()
        if self.state == TrackState.LOST:
            T_reloc = self._attempt_reloc(fd)
            if T_reloc is not None:
                m.reloc_kf = self.ref_kf
                self.T_cw = T_reloc
                self.velocity = np.eye(4, dtype=np.float32)
                self._has_velocity = False
                if self._last_feats is None:
                    # a restored map has no last frame: the motion model
                    # starts from this frame's relocalization matches
                    self._remember_frame(fd, self._reloc_kp2pt)
            elif self._last_feats is None:
                self._log_frame(timestamp, lost=True)
                return
        T_pred = self._predict_pose(fd)
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
        kp2pt = self._resolve_provisional(kp2pt, host["carried"])
        kp2pt[~host["ok"]] = -1
        # visibility stats (SearchLocalPoints IncreaseVisible)
        np.add.at(self.store.pt_visible, pid[host["in_frustum"] & (pid >= 0)], 1)
        np.add.at(self.store.pt_found, kp2pt[kp2pt >= 0], 1)

        if n_in < self.cfg.tracking.min_track_inliers:
            if self.store.n_kf <= 5 and not self.localization_only:
                # lost right after initialization: full reset
                m.state = TrackState.LOST.name
                self._reset_full()
                return
            self.state = TrackState.LOST
            self._has_velocity = False
            self._log_frame(timestamp, lost=True)
            return

        T_np = host["T"]
        self._cur_det2ln = None
        if self.enable_lines and self._cur_fl is not None:
            T_np = self._track_lines(fd, step, m)
        self.state = TrackState.OK
        self.velocity = (T_np @ np.linalg.inv(self.T_cw)).astype(np.float32)
        self._has_velocity = True
        self.T_cw = T_np.astype(np.float32)

        # localization-only mode creates no keyframes
        new_kf = (not self.localization_only) and self._need_new_kf(
            n_in, tracked_close, untracked_close, fid)
        if new_kf:
            with tracing.span("kf.create") as sp:
                self._create_kf(fd, kp2pt, timestamp, fid)
            m.t_kf = sp.seconds
            m.new_kf = True
        self._remember_frame(fd, kp2pt, None if new_kf else step)
        self._log_frame(timestamp)

    def _track_lines(self, fd: FrameData, step: dict,
                     m: TrackMetrics) -> np.ndarray:
        """The line step after point tracking: association with the local
        map lines and the joint point+line pose LM from the step's pose, on
        the step's association inliers (the freshly depth-seeded rows would
        anchor the refinement at the step's pose). Records the global map
        line id per detection; returns the refined T_cw."""
        cur = fd.feats
        T3, det2ln, n_line = _line_step(
            self.cam, step["T"], self._line_view, self._cur_fl,
            _line_point_obs(cur, step, self._inv_sigma2_lut),
            float(self.cfg.line.gamma), self._md_gate)
        tracing.count("host_waits", 3)
        det2ln = det2ln.cpu().numpy()
        self._cur_det2ln = np.where(
            det2ln >= 0, self._line_view_ids[np.maximum(det2ln, 0)],
            -1).astype(np.int32)
        m.n_line_matches = int(n_line)
        return T3.cpu().numpy()

    def _refresh_line_view(self):
        """The local map lines on the device, padded to line_view_cap: the
        valid lines the reference keyframe and its 19 most covisible
        keyframes observe (the highest ids when there are more, the excess
        counted in the mapper's stage_times["line_view_dropped"])."""
        s = self.store
        cap = self.line_view_cap
        if self.ref_kf >= 0:
            covis, _ = s.covisible_kfs(self.ref_kf, min_shared=15, top=19)
            local_kfs = np.concatenate([[self.ref_kf], covis]).astype(np.int32)
            ids = np.unique(s.kf_ln_ids[local_kfs])
            ids = ids[ids >= 0]
            ids = ids[s.ln_valid[ids]]
            if len(ids) > cap:
                st = self.mapper.stage_times
                st["line_view_dropped"] = st.get("line_view_dropped", 0) \
                    + len(ids) - cap
                ids = ids[-cap:]
        else:
            ids = np.zeros(0, np.int32)
        n, pad = len(ids), cap - len(ids)
        self._line_view_ids = np.concatenate(
            [ids, np.full(pad, -1, np.int32)]).astype(np.int32)
        D = s.ln_desc.shape[1]
        dr = np.tile(np.array([1, 0, 0], np.float32), (cap, 1))
        dr[:n] = s.ln_dir[ids]
        x0 = np.zeros((cap, 3), np.float32)
        x0[:n] = s.ln_x0[ids]
        de = np.zeros((cap, D), np.float32)
        de[:n] = s.ln_desc[ids]
        oc = np.zeros(cap, np.int32)
        oc[:n] = s.ln_oct[ids]
        self._line_view = (self._t(x0), self._t(dr), self._t(de), self._t(oc),
                           self._t(np.arange(cap) < n))

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
                   fid: int, snap: tuple | None = None,
                   lines_np: dict | None = None,
                   n_in_kf: int | None = None) -> bool:
        """CreateNewKeyFrame: insert the KF, create close-depth points (all
        under ThDepth, or the 100 nearest), then run the local-mapping and
        loop-closing steps. Returns True when a loop closure corrected the
        map. Pipelined (a finalized record's host snapshot `snap` and
        `lines_np` given, n_in_kf its inliers): the mapping stage is
        dispatched and the loop step queued, both absorbed at later
        finalized frames (`_step_kf_pipeline`); the reference count and
        kappa go to the device decision chain at the next dispatch."""
        s = self.store
        pipelined = snap is not None
        feats, depth = snap if pipelined else self._snapshot_np(fd)
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
        self._prov_kf_pid = kp2pt.copy()
        if self.enable_lines and self._cur_fl is not None:
            self._create_kf_lines(kf, lines_np)
        s.set_parent_from_covisibility(kf)
        self.ref_kf = kf
        self.last_kf_frame = fid
        self.mapper.cache_frame(kf, fd.feats)
        timing = dict(kf=kf, fid=fid, mapper=0.0, loop=0.0)
        self.kf_timings.append(timing)
        if pipelined:
            lc = self.loop_closer
            with tracing.span("kf.mapper") as sp:
                self.mapper.dispatch_kf_stage(kf, voc=None if lc is None
                                              else lc.voc, fuse_ba=True)
                self._adopt_view()
                self._match_loop_words()
                if lc is not None:
                    self._pending_loops.append([kf, None])
            timing["mapper"] = sp.seconds
            with tracing.span("kf.view"):
                self._refresh_ref_matches()
                if n_in_kf:
                    self._kappa = float(np.clip(
                        self._ref_matches / max(n_in_kf, 1), 0.2, 1.2))
                self._refm_host = (
                    np.float32([self._ref_matches, self._kappa]), fid)
                if self.enable_lines:
                    self._refresh_line_view()
            return False
        with tracing.span("kf.mapper") as sp:
            view_out = self.mapper.process_keyframe(kf)
        timing["mapper"] = sp.seconds
        corrected = False
        if self.loop_closer is not None:
            with tracing.span("loop.query") as sp:
                corrected = self.loop_closer.process_keyframe(kf)
            timing["loop"] = sp.seconds
        with tracing.span("kf.view"):
            # refresh the current pose from the (BA- or loop-)corrected KF
            # pose
            self.T_cw = s.kf_pose[kf].copy()
            if view_out is not None and not corrected:
                self._view, self._view_pid = view_out   # post-BA view
            else:
                self._refresh_local_view()
            self._refresh_ref_matches()
            if self.enable_lines:
                self._refresh_line_view()
        return corrected

    def _create_kf_lines(self, kf: int, lines_np: dict | None = None):
        """Line half of keyframe creation: the frame's lines (`lines_np`,
        the host copy of `_cur_fl`, read here when not given) become the
        keyframe's line snapshot with its map-line associations, valid
        stereo-triangulated lines of 28 px or more without one become new
        map lines (world frame at the current pose), then retriangulation
        (staged in pipelined mode), culling and the distinctive-descriptor
        update. Each stage is a span `lines.kf_<stage>`; its seconds
        accumulate in `line_kf_times[<stage>]`."""
        lt = self.line_kf_times
        stage = lambda key: tracing.span("lines.kf_" + key, lt, key)
        s = self.store
        with stage("snap"):
            if lines_np is None:
                fields = _line_fields(self._cur_fl)
                tracing.count("host_waits", len(fields))
                lines_np = {k: v.cpu().numpy() for k, v in fields.items()}
            X0c, dc = lines_np["X0"], lines_np["d"]
        with stage("create"):
            det2ln = (self._cur_det2ln if self._cur_det2ln is not None
                      else np.full(s.n_ln_det, -1, np.int32))
            s.add_keyframe_lines(kf, lines_np, det2ln.copy())
            lengths = np.linalg.norm(lines_np["p2"] - lines_np["p1"],
                                     axis=-1)
            newsel = np.nonzero(lines_np["valid"] & lines_np["has_r"]
                                & (det2ln < 0) & (lengths >= 28.0))[0]
            newsel = newsel[: s.room_for_lines(len(newsel))]
            if len(newsel):
                T_wc = np.linalg.inv(self.T_cw)
                Pw = (T_wc[:3, :3] @ X0c[newsel].T).T + T_wc[:3, 3]
                dw = (T_wc[:3, :3] @ dc[newsel].T).T
                dw /= np.maximum(np.linalg.norm(dw, axis=-1, keepdims=True),
                                 1e-9)
                X0w = Pw - np.sum(Pw * dw, axis=-1, keepdims=True) * dw
                s.create_lines(kf, newsel, X0w.astype(np.float32),
                               dw.astype(np.float32))
        with stage("retri"):
            s.retriangulate_lines(device=self.device)  # staged when pipelined
        with stage("cull"):
            s.cull_lines()
        with stage("desc"):
            s.update_line_descriptors()
        lt["n"] = lt.get("n", 0) + 1

    def trajectory(self):
        """(timestamps, T_wc stack) replayed through reference keyframes."""
        rel = np.stack([l.T_cr for l in self.logs])
        refs = np.array([l.ref_kf for l in self.logs])
        ts = np.array([l.timestamp for l in self.logs])
        return ts, traj.replay_trajectory(rel, refs, self.store.kf_pose)
