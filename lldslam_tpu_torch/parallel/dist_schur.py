"""Landmark-sharded distributed Schur bundle adjustment on torch.distributed.

Counterpart of lldslam_tpu/parallel/dist_schur.py. The mesh is a process
group with one rank per device, the PyTorch form of JAX's single-controller
`shard_map`: landmarks and their observations are split across the ranks,
landmark marginalization stays on the owning rank, and only pose-space
quantities cross ranks, as `all_reduce` calls.

Partition (laid out on the host by `make_dist_problem`):
- poses (K, 4, 4) replicated: K is small next to landmarks and
  observations;
- points in contiguous blocks of P/n per rank; each rank's observation rows
  reference only its own points, by rank-local index;
- each rank's observation rows padded to a common length (a multiple of 8),
  so the global table splits evenly over the ranks.

The solve is the port's own (`optim/ba.ba_solve`,
`optim/lines_ba.joint_ba_solve_cg`) with its `reduce_poses` hook set to an
`all_reduce` over the group: Hcc, bc, the reduced right-hand side, each CG
matvec's backscatter (both landmark classes in one call) and the LM cost.
Every LM accept, damping update and CG scalar is computed from those
all-reduced pose-space tensors, which every rank receives bit for bit
alike, so every rank takes the same steps and holds the same poses. About
69 `all_reduce` calls an LM iteration at 64 CG steps (`all_reduce_calls`
counts them).

Backends. NCCL makes the card's stream wait for a collective, not the host:
a solve on NCCL makes no host synchronisation. gloo accepts CUDA tensors in
`all_reduce` (not in `all_gather`, hence `assemble`'s one all-reduce) but
stages them through the host, so each call synchronises the host; that is
the route of two ranks on one card, which NCCL refuses.

Each rank's sums over its own observations run in a fixed order
(`ops/segment_sum`, through the solvers' layouts of its shard), so a solve
repeats bit for bit, and on one rank it equals the single route bit for
bit. Multi-rank runs still start from one map: `place` takes the
replicated poses from the group's first rank, and `assemble` gives every
rank every block, so a solve leaves the ranks' solved state equal; a map
built differently on each rank still feeds each rank's own observations
in.

A mismatch raises and never hangs: groups are made with a timeout, and
`place` / `place_joint` all-reduce the MIN and MAX of the layout sizes
(K, P/n, O/n, L/n, Ol/n) and raise when the ranks disagree. The solvers
themselves make no host synchronisation and trust their input.
"""
from __future__ import annotations

import logging
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..geometry.camera import StereoCamera
from ..optim import ba, lines_ba

GROUP_TIMEOUT = timedelta(seconds=60)

all_reduce_calls = 0      # all_reduce calls made by the solvers


class DistProblem(NamedTuple):
    """A BAProblem re-laid-out for `n_shards` ranks (numpy, on the host;
    see `make_dist_problem`)."""

    poses: np.ndarray        # (K, 4, 4) replicated
    pose_fixed: np.ndarray   # (K,) bool replicated
    points: np.ndarray       # (P_pad, 3), contiguous blocks of P_pad/n
    point_valid: np.ndarray  # (P_pad,) bool
    obs: ba.BAObs            # (n * O_pad,) numpy rows; obs.p is RANK-LOCAL
    n_shards: int


class DistJointProblem(NamedTuple):
    """DistProblem plus the line landmark class, both classes split by the
    same contiguous-block rule (the 4x4 line blocks of
    `lines_ba._schur_cg_joint` are sharded like the 3x3 point blocks)."""

    base: DistProblem
    q: np.ndarray            # (L_pad, 4), contiguous blocks of L_pad/n
    alpha: np.ndarray        # (L_pad,)
    line_valid: np.ndarray   # (L_pad,) bool
    lobs: lines_ba.LineBAObs  # (n * Ol_pad,) numpy rows; lobs.l RANK-LOCAL


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_mesh(n_devices: int | None = None, device="cuda",
              backend: str | None = None):
    """The process group to shard over: one rank per device.

    When the default group is initialized, returns it, or a `new_group` of
    its first `n_devices` ranks (a collective call: every rank of the
    default group must make it). Otherwise initializes, once per process, a
    one-rank default group on an in-memory `HashStore`, NCCL when `device`
    is a card and gloo for the CPU (or `backend` when given; a card with
    gloo is the caller's explicit choice, never a fallback). This is a
    process-wide side effect: the one-rank group stays the default group.
    It is the degenerate mesh of the JAX package's `force_dist=True` on one
    device."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is None or n_devices == world:
            return dist.group.WORLD
        if not 0 < n_devices < world:
            raise ValueError(f"make_mesh: {n_devices} ranks asked of a "
                             f"group of {world}")
        return dist.new_group(list(range(n_devices)), timeout=GROUP_TIMEOUT)
    if n_devices not in (None, 1):
        raise ValueError(f"make_mesh: {n_devices} ranks asked, but no "
                         "process group is initialized (spawn the ranks "
                         "first, e.g. parallel.ranks.run_ranks)")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(
            "cuda", device.index if device.index is not None
            else torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT, **kw)
    return dist.group.WORLD


def _all_reduce(group):
    """The `reduce_poses` / `reduce_points` hook: an in-place SUM over the
    group, counted in `all_reduce_calls`."""
    def reduce(x: torch.Tensor) -> torch.Tensor:
        global all_reduce_calls
        all_reduce_calls += 1
        dist.all_reduce(x, group=group)
        return x
    return reduce


def _shard_rows(owner: np.ndarray, valid: np.ndarray, n_shards: int):
    """Rows grouped by owning shard, padded per shard to a common multiple
    of 8 (at least 8). Returns (o_pad, src): src[i] is the original row
    feeding padded row i, -1 for padding; invalid rows are dropped."""
    shard = np.where(valid, owner, -1)
    counts = np.bincount(shard[shard >= 0], minlength=n_shards)
    o_pad = max(int(counts.max(initial=0)), 8)
    o_pad = -(-o_pad // 8) * 8
    src = np.full(n_shards * o_pad, -1, np.int64)
    for s in range(n_shards):
        rows = np.nonzero(shard == s)[0]
        src[s * o_pad: s * o_pad + len(rows)] = rows
    return o_pad, src, counts


def _take(a: np.ndarray, src: np.ndarray, fill=0) -> np.ndarray:
    out = np.full((len(src),) + a.shape[1:], fill, a.dtype)
    m = src >= 0
    out[m] = a[src[m]]
    return out


def make_dist_problem(problem: ba.BAProblem, n_shards: int):
    """Host-side re-layout of a BAProblem (tensors on any device, or numpy)
    for `dist_ba_solve`.

    Points pad up to a multiple of n_shards and split into contiguous
    blocks; observation rows group by the shard owning their point, pad
    per shard to a common length, and switch to shard-local point indices.
    Returns (DistProblem, obs_src): obs_src[i] is the original observation
    row feeding padded row i (-1 for padding), the inverse map for
    per-observation chi2.

    Observations with valid=False are dropped (no obs_src row maps them):
    a caller scattering per-row results back through obs_src must pre-fill
    its output. Every shard pads to the largest shard's count, so a skewed
    landmark distribution inflates every shard to the hottest one's length
    (logged when max/mean > 2)."""
    o = ba.BAObs(*map(_np, problem.obs))
    pts, ptv = _np(problem.points), _np(problem.point_valid)
    P_orig = pts.shape[0]
    P_pad = -(-P_orig // n_shards) * n_shards
    if P_pad != P_orig:
        pts = np.concatenate([pts, np.zeros((P_pad - P_orig, 3), pts.dtype)])
        ptv = np.concatenate([ptv, np.zeros(P_pad - P_orig, bool)])
    per = P_pad // n_shards
    o_pad, src, counts = _shard_rows(o.p // per, o.valid, n_shards)
    if counts.sum() > 0 and counts.max() > 2.0 * max(counts.mean(), 1.0):
        logging.getLogger(__name__).info(
            "dist_schur shard skew: max/mean obs per shard %.1f (%d/%.0f): "
            "padded work inflates to the hottest shard",
            counts.max() / max(counts.mean(), 1.0), counts.max(),
            counts.mean())
    obs = ba.BAObs(
        k=_take(o.k, src), p=(_take(o.p, src) % per).astype(np.int32),
        uvr=_take(o.uvr, src), inv_sigma2=_take(o.inv_sigma2, src),
        is_stereo=_take(o.is_stereo, src), valid=src >= 0)
    dp = DistProblem(poses=_np(problem.poses),
                     pose_fixed=_np(problem.pose_fixed), points=pts,
                     point_valid=ptv, obs=obs, n_shards=n_shards)
    return dp, src


def make_dist_joint_problem(joint: lines_ba.JointProblem, n_shards: int):
    """Host-side re-layout of a lines_ba.JointProblem for
    `dist_joint_ba_solve`: the point half through `make_dist_problem`,
    lines and their observations by the same contiguous-block rule (padding
    lines: q = (1, 0, 0, 0), alpha = 1, invalid). Returns
    (DistJointProblem, obs_src, lobs_src)."""
    base, obs_src = make_dist_problem(joint.base, n_shards)
    lo = lines_ba.LineBAObs(*map(_np, joint.lobs))
    q, alpha, lv = _np(joint.q), _np(joint.alpha), _np(joint.line_valid)
    L_orig = q.shape[0]
    L_pad = -(-max(L_orig, n_shards) // n_shards) * n_shards
    if L_pad != L_orig:
        qpad = np.zeros((L_pad - L_orig, 4), q.dtype)
        qpad[:, 0] = 1.0
        q = np.concatenate([q, qpad])
        alpha = np.concatenate([alpha, np.ones(L_pad - L_orig, alpha.dtype)])
        lv = np.concatenate([lv, np.zeros(L_pad - L_orig, bool)])
    per = L_pad // n_shards
    _, src, _ = _shard_rows(lo.l // per, lo.valid, n_shards)
    lobs = lines_ba.LineBAObs(
        k=_take(lo.k, src), l=(_take(lo.l, src) % per).astype(np.int32),
        x1l=_take(lo.x1l, src), x2l=_take(lo.x2l, src),
        x1r=_take(lo.x1r, src), x2r=_take(lo.x2r, src),
        octave=_take(lo.octave, src), has_r=_take(lo.has_r, src),
        valid=src >= 0)
    djp = DistJointProblem(base=base, q=q, alpha=alpha, line_valid=lv,
                           lobs=lobs)
    return djp, obs_src, src


def _check_layout(group, device, n_shards: int, sizes) -> None:
    """Raises unless the group has n_shards ranks and every rank holds the
    same layout sizes (one all_reduce of (sizes, -sizes) with MAX)."""
    n = dist.get_world_size(group)
    if n_shards != n:
        raise ValueError(f"problem laid out for {n_shards} shards, group has "
                         f"{n} ranks")
    t = torch.tensor(list(sizes) + [-s for s in sizes], dtype=torch.int64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    hi, lo = t[:len(sizes)].tolist(), [-v for v in t[len(sizes):].tolist()]
    if hi != lo:
        raise RuntimeError(f"ranks disagree on the layout (K, P/n, O/n, L/n, "
                           f"Ol/n): max {hi}, min {lo}")


def _block(a: np.ndarray, rank: int, n: int) -> np.ndarray:
    per = a.shape[0] // n
    return np.ascontiguousarray(a[rank * per: (rank + 1) * per])


def _to(a: np.ndarray, device, long: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, torch.int64 if long else None)


def _place_base(dp: DistProblem, group, device, rank, n) -> ba.BAProblem:
    poses = _to(dp.poses, device)
    if n > 1:   # replicated by construction: the first rank's poses
        dist.broadcast(poses, src=dist.get_global_rank(group, 0),
                       group=group)
    o = dp.obs
    return ba.BAProblem(
        poses=poses, pose_fixed=_to(dp.pose_fixed, device),
        points=_to(_block(dp.points, rank, n), device),
        point_valid=_to(_block(dp.point_valid, rank, n), device),
        obs=ba.BAObs(k=_to(_block(o.k, rank, n), device, True),
                     p=_to(_block(o.p, rank, n), device, True),
                     uvr=_to(_block(o.uvr, rank, n), device),
                     inv_sigma2=_to(_block(o.inv_sigma2, rank, n), device),
                     is_stereo=_to(_block(o.is_stereo, rank, n), device),
                     valid=_to(_block(o.valid, rank, n), device)))


def place(dp: DistProblem, group, device) -> ba.BAProblem:
    """This rank's shard on `device` as a BAProblem with rank-local point
    indices: its point block and observation rows, the poses replicated
    (broadcast from the group's first rank). Checks the layout across the
    ranks first (raises on a mismatch)."""
    rank, n = dist.get_rank(group), dp.n_shards
    _check_layout(group, device, n, (dp.poses.shape[0], dp.points.shape[0] // n,
                                     len(dp.obs.k) // n, 0, 0))
    return _place_base(dp, group, device, rank, n)


def place_joint(djp: DistJointProblem, group, device) -> lines_ba.JointProblem:
    """`place` for the joint problem: this rank's point and line blocks and
    their observation rows, as a lines_ba.JointProblem."""
    rank, n = dist.get_rank(group), djp.base.n_shards
    b = djp.base
    _check_layout(group, device, n, (
        b.poses.shape[0], b.points.shape[0] // n, len(b.obs.k) // n,
        djp.q.shape[0] // n, len(djp.lobs.k) // n))
    lo = djp.lobs
    blk = lambda a, long=False: _to(_block(a, rank, n), device, long)
    return lines_ba.JointProblem(
        base=_place_base(b, group, device, rank, n), q=blk(djp.q),
        alpha=blk(djp.alpha), line_valid=blk(djp.line_valid),
        lobs=lines_ba.LineBAObs(
            k=blk(lo.k, True), l=blk(lo.l, True), x1l=blk(lo.x1l),
            x2l=blk(lo.x2l), x1r=blk(lo.x1r), x2r=blk(lo.x2r),
            octave=blk(lo.octave), has_r=blk(lo.has_r), valid=blk(lo.valid)))


def assemble(group, *blocks: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's blocks stacked in rank order, on every rank: one
    all_reduce (SUM) of a zero-filled buffer in which each rank writes its
    own blocks (x + 0 is x, bit for bit). Each block has the same shape on
    every rank; returns one (n * rows, ...) tensor per block."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    flat = [b.reshape(-1) for b in blocks]
    sizes = [f.numel() for f in flat]
    buf = torch.zeros((n, sum(sizes)), dtype=blocks[0].dtype,
                      device=blocks[0].device)
    buf[rank] = torch.cat(flat)
    dist.all_reduce(buf, group=group)
    out, at = [], 0
    for b, m in zip(blocks, sizes):
        out.append(buf[:, at:at + m].reshape((n * b.shape[0],) + b.shape[1:]))
        at += m
    return out


def dist_ba_solve(cam: StereoCamera, local: ba.BAProblem, group,
                  iters: int = 5, cg_iters: int = 24):
    """LM/Schur BA with landmarks and observations sharded over `group`:
    `ba.ba_solve` (same schedule and math, equal up to float32 summation
    order) with the pose-space sums all-reduced. `local` is this rank's
    shard (`place`). Returns (poses (K, 4, 4) replicated, this rank's points
    (P/n, 3), this rank's chi2 rows (O/n,))."""
    solved, chi2 = ba.ba_solve(cam, local, iters=iters, cg_iters=cg_iters,
                               reduce_poses=_all_reduce(group))
    return solved.poses, solved.points, chi2


def dist_joint_ba_solve(cam: StereoCamera, local: lines_ba.JointProblem,
                        group, iters: int = 5, cg_iters: int = 24,
                        gamma: float = 0.5):
    """Joint pose + point + line BA with both landmark classes sharded over
    `group`: `lines_ba.joint_ba_solve_cg` with the pose-space sums
    all-reduced (one call per matvec carries both classes). Returns (poses
    replicated, this rank's points, q, alpha and point chi2 rows)."""
    solved, chi2, _ = lines_ba.joint_ba_solve_cg(
        cam, local, iters=iters, cg_iters=cg_iters, gamma=gamma,
        reduce_poses=_all_reduce(group))
    return (solved.base.poses, solved.base.points, solved.q, solved.alpha,
            chi2)
