"""Device stages of the keyframe-rate mapping path.

Counterpart of the tensor math of lldslam_tpu/pipeline/mapper_fast.py
(`kf_stage_cached`, `ba_view_cached` and `joint_ba_view_cached`) without its
packed upload/readback buffers, which existed to amortise a slow host link:
here the stages take and return tensors.

1. `kf_stage_cached`: triangulation of the new keyframe against its
   covisible neighbours and fusion of its points into the fuse neighbours,
   with the keyframes' features gathered from the `KfCache` ring.
2. `ba_view_cached`: the windowed local BA with observations gathered from
   the cache by (slot, feature) index, plus the tracker's post-BA local-map
   view (solved position where the point is in the problem).
3. `joint_ba_view_cached`: the same windowed BA with the map lines of the
   window as a second landmark class (`lines_ba.local_joint_ba`).

The JAX package's fused keyframe programs (`kf_stage_words_flat`,
`fused_kf_ba_flat`, `fused_kf_joint_ba_flat`) run stage 1, the keyframe's
BoW descent and stage 2 or 3 as one program with one flat readback; the
port queues the same calls in that order (`LocalMapper.dispatch_kf_stage`,
`Vocabulary.device_words`) and reads their tensors back in one copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..frontend import matching
from ..geometry.camera import StereoCamera
from ..geometry import lines as glines
from ..optim import ba, lines_ba
from . import mapping_ops
from .kf_cache import CacheArrays


def view_from_store(store, pids: np.ndarray, cap: int,
                    device) -> matching.MapPointView:
    """MapPointView over global point ids, padded with invalid rows to `cap`
    (the counterpart of pack_view + unpack_view)."""
    P = len(pids)
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 8), np.uint32)
    normal = np.zeros((cap, 3), np.float32)
    mind = np.zeros(cap, np.float32)
    maxd = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    pos[:P] = store.pt_pos[pids]
    desc[:P] = store.pt_desc[pids]
    normal[:P] = store.pt_normal[pids]
    mind[:P] = store.pt_min_dist[pids]
    maxd[:P] = store.pt_max_dist[pids]
    valid[:P] = True
    def t(a):
        tracing.count("host_waits")    # a blocking upload from pageable
        return torch.from_numpy(a).to(device)
    return matching.MapPointView(pos=t(pos), desc=t(desc.view(np.int32)),
                                 normal=t(normal), min_dist=t(mind),
                                 max_dist=t(maxd), valid=t(valid))


def cache_feats(cache: CacheArrays, slot: int,
                valid: torch.Tensor | None = None) -> matching.FrameFeatures:
    return matching.FrameFeatures(
        xy=cache.xy[slot], ur=cache.ur[slot], octave=cache.octave[slot],
        angle=cache.angle[slot], desc=cache.desc[slot],
        valid=cache.valid[slot] if valid is None else valid)


def kf_stage_cached(cam: StereoCamera, cache: CacheArrays,
                    slots_tri: list[int], poses_tri: torch.Tensor,
                    free_tri: torch.Tensor, slots_fuse: list[int],
                    poses_fuse: torch.Tensor, valid_fuse: torch.Tensor,
                    view: matching.MapPointView, inv_sigma2_lut: torch.Tensor,
                    n_levels: int, scale: float):
    """Both keyframe-rate association stages. slots_tri[0] / poses_tri[0] /
    free_tri[0] are the new keyframe, the rest its triangulation
    neighbours; free masks mark features without a map point. Returns
    (tri: list of (n_good, match, X) per neighbour, fuse: list of
    (pt2kp, kp2pt) per fuse neighbour)."""
    s0 = slots_tri[0]
    xy1, desc1, oct1 = cache.xy[s0], cache.desc[s0], cache.octave[s0]
    tri = [mapping_ops.triangulate_pair(
        cam, poses_tri[0], poses_tri[1 + i], xy1, desc1, oct1, free_tri[0],
        cache.xy[s], cache.desc[s], cache.octave[s], free_tri[1 + i],
        inv_sigma2_lut) for i, s in enumerate(slots_tri[1:])]
    fuse = [mapping_ops.fuse_candidates(
        cam, poses_fuse[i], view, cache_feats(cache, s, valid_fuse[i]),
        n_levels=n_levels, scale=scale) for i, s in enumerate(slots_fuse)]
    return tri, fuse


def _cached_problem(cache: CacheArrays, slots, poses, fixed, points, pvalid,
                    obs_k, obs_fe, obs_p, n_obs: int,
                    inv_sigma2_lut) -> ba.BAProblem:
    """The window's BAProblem, its observations gathered from the cache."""
    O = obs_k.shape[0]
    slot = slots[obs_k]
    ur = cache.ur[slot, obs_fe]
    obs = ba.BAObs(
        k=obs_k, p=obs_p,
        uvr=torch.cat([cache.xy[slot, obs_fe], ur[:, None]], dim=-1),
        inv_sigma2=inv_sigma2_lut[cache.octave[slot, obs_fe].long()],
        is_stereo=ur >= 0,
        valid=torch.arange(O, device=obs_k.device) < n_obs)
    return ba.BAProblem(poses=poses, points=points, pose_fixed=fixed,
                        point_valid=pvalid, obs=obs)


def _post_ba_view(tv: matching.MapPointView, tv_pidx: torch.Tensor,
                  points: torch.Tensor) -> matching.MapPointView:
    """Solved position where the view's point is in the problem."""
    pos = torch.where((tv_pidx >= 0)[:, None],
                      points[torch.clamp(tv_pidx, min=0)], tv.pos)
    return tv._replace(pos=pos)


def ba_view_cached(cam: StereoCamera, cache: CacheArrays,
                   slots: torch.Tensor, poses: torch.Tensor,
                   fixed: torch.Tensor, points: torch.Tensor,
                   pvalid: torch.Tensor, obs_k: torch.Tensor,
                   obs_fe: torch.Tensor, obs_p: torch.Tensor, n_obs: int,
                   inv_sigma2_lut: torch.Tensor, tv_pidx: torch.Tensor,
                   tv: matching.MapPointView):
    """Windowed local BA with cache-gathered observations + the post-BA
    tracking view. slots/poses/fixed (K,...) window keyframes (padding rows
    fixed); points/pvalid (P,...); obs_* (O,) window index, feature index and
    point index, the first n_obs real; tv_pidx (V,) problem point index per
    view slot or -1. Returns (poses (K,4,4), points (P,3), keep (O,),
    MapPointView)."""
    problem = _cached_problem(cache, slots, poses, fixed, points, pvalid,
                              obs_k, obs_fe, obs_p, n_obs, inv_sigma2_lut)
    solved, keep = ba.local_ba(cam, problem)
    return (solved.poses, solved.points, keep,
            _post_ba_view(tv, tv_pidx, solved.points))


def joint_ba_view_cached(cam: StereoCamera, cache: CacheArrays,
                         slots: torch.Tensor, poses: torch.Tensor,
                         fixed: torch.Tensor, points: torch.Tensor,
                         pvalid: torch.Tensor, obs_k: torch.Tensor,
                         obs_fe: torch.Tensor, obs_p: torch.Tensor,
                         n_obs: int, inv_sigma2_lut: torch.Tensor,
                         tv_pidx: torch.Tensor, tv: matching.MapPointView,
                         ln_x0: torch.Tensor, ln_dir: torch.Tensor,
                         ln_valid: torch.Tensor, lobs: lines_ba.LineBAObs,
                         gamma: float):
    """`ba_view_cached` with the window's map lines (ln_* (LC, ...), world
    x0dir, padding rows invalid) and their observations `lobs` (window
    index, line index, padded to a fixed capacity) as a second landmark
    class. Returns (poses, points, X0 (LC, 3), d (LC, 3), keep (O,),
    keep_l (LO,), MapPointView)."""
    problem = _cached_problem(cache, slots, poses, fixed, points, pvalid,
                              obs_k, obs_fe, obs_p, n_obs, inv_sigma2_lut)
    q, alpha = glines.minimal_from_x0dir(ln_x0, ln_dir)
    joint = lines_ba.JointProblem(base=problem, q=q, alpha=alpha,
                                  line_valid=ln_valid, lobs=lobs)
    solved, keep, keep_l = lines_ba.local_joint_ba(cam, joint, gamma)
    X0, d = glines.x0dir_from_minimal(solved.q, solved.alpha)
    sb = solved.base
    return (sb.poses, sb.points, X0, d, keep, keep_l,
            _post_ba_view(tv, tv_pidx, sb.points))
