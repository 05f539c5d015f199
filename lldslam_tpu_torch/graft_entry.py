"""Driver entry points of lldslam_tpu_torch, the counterparts of the JAX
package's `__graft_entry__.py`.

entry():            the per-frame forward step of the main path (stereo
                    frame build: pyramid, FAST, ORB on K1a, stereo match
                    with K1b) for the KITTI camera at 2000 features, with
                    a zero (2, 376, 1241) uint8 pair on the card.
dryrun_multichip(): one rank per device (spawned, NCCL on the cards, or
                    gloo on the CPU with device="cpu"), each running the
                    landmark-sharded point BA, the joint point+line BA and
                    the observation-sharded BA on a small synthetic problem,
                    and checking finite results and poses bit-equal across
                    the ranks.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .geometry.camera import StereoCamera

DRYRUN_CAM = StereoCamera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                          width=640, height=480)


def entry(device="cuda"):
    """(fn, args): `fn(*args)` builds one KITTI-size stereo frame."""
    from .frontend.frame import build_frame_pair
    from .ops.orb import OrbConfig

    cam = StereoCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376)
    fn = partial(build_frame_pair, cam=cam, cfg=OrbConfig(n_features=2000))
    pair = torch.zeros((2, 376, 1241), dtype=torch.uint8, device=device)
    return fn, (pair,)


def dryrun_problems(n_ranks: int, seed: int = 0):
    """The JAX entry's synthetic problems, made with numpy from a seed:
    8 poses on a line, 128 noisy points, 64 * n_ranks stereo observations;
    8 lines seen 4 times each in both views. Returns (BAProblem,
    JointProblem) on the CPU."""
    from .geometry import lines as gl
    from .optim import ba, lines_ba

    cam, rng = DRYRUN_CAM, np.random.default_rng(seed)
    K, Pn, O = 8, 128, 64 * n_ranks
    t = torch.from_numpy
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 2, 3] = np.arange(K) * 0.1
    pts = np.stack([rng.uniform(-5, 5, Pn), rng.uniform(-3, 3, Pn),
                    rng.uniform(8, 20, Pn)], -1).astype(np.float32)
    k = rng.integers(0, K, O).astype(np.int64)
    p = rng.integers(0, Pn, O).astype(np.int64)
    Xc = np.einsum("oij,oj->oi", poses[k, :3, :3], pts[p]) + poses[k, :3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
    uvr = np.stack([u, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy,
                    u - cam.bf / Xc[:, 2]], -1).astype(np.float32)
    noisy = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    problem = ba.BAProblem(
        poses=t(poses), points=t(noisy), pose_fixed=t(np.arange(K) == 0),
        point_valid=torch.ones(Pn, dtype=torch.bool),
        obs=ba.BAObs(k=t(k), p=t(p), uvr=t(uvr),
                     inv_sigma2=torch.ones(O), is_stereo=torch.ones(
                         O, dtype=torch.bool),
                     valid=torch.ones(O, dtype=torch.bool)))
    Ln = 8
    mid = np.stack([rng.uniform(-4, 4, Ln), rng.uniform(-2, 2, Ln),
                    rng.uniform(8, 16, Ln)], -1).astype(np.float32)
    dirs = rng.normal(size=(Ln, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    X0 = mid - np.sum(mid * dirs, -1, keepdims=True) * dirs
    q, alpha = gl.minimal_from_x0dir(t(X0), t(dirs))
    lk = rng.integers(0, K, 4 * Ln).astype(np.int64)
    ll = np.tile(np.arange(Ln, dtype=np.int64), 4)

    def proj2(T, X):
        Xc = np.einsum("oij,oj->oi", T[:, :3, :3], X) + T[:, :3, 3]
        return t(np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                           cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy],
                          -1).astype(np.float32))

    A, B = mid[ll] - 1.5 * dirs[ll], mid[ll] + 1.5 * dirs[ll]
    Tr = poses[lk].copy()
    Tr[:, 0, 3] -= cam.baseline
    lobs = lines_ba.LineBAObs(
        k=t(lk), l=t(ll), x1l=proj2(poses[lk], A), x2l=proj2(poses[lk], B),
        x1r=proj2(Tr, A), x2r=proj2(Tr, B),
        octave=torch.zeros(4 * Ln, dtype=torch.int32),
        has_r=torch.ones(4 * Ln, dtype=torch.bool),
        valid=torch.ones(4 * Ln, dtype=torch.bool))
    joint = lines_ba.JointProblem(base=problem, q=q, alpha=alpha,
                                  line_valid=torch.ones(Ln, dtype=torch.bool),
                                  lobs=lobs)
    return problem, joint


def _same_on_every_rank(group, label: str, *tensors) -> None:
    """Raises unless each tensor is finite and bit-equal on every rank."""
    from .parallel.dist_schur import assemble
    for x in tensors:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite result")
    for x, every in zip(tensors, assemble(group, *tensors)):
        for r, blk in enumerate(every.reshape((-1,) + x.shape)):
            if not torch.equal(blk, x):
                raise AssertionError(f"{label}: rank {r} holds other bits")


def dryrun_rank(rank: int, device, n_ranks: int) -> dict:
    """One rank of `dryrun_multichip` (run under `parallel.ranks`)."""
    from .parallel import dist_schur, sharded_ba

    cam = DRYRUN_CAM
    problem, joint = dryrun_problems(n_ranks)
    group = dist_schur.make_mesh(n_ranks, device=device)
    dp, _ = dist_schur.make_dist_problem(problem, n_ranks)
    poses, points, chi2 = dist_schur.dist_ba_solve(
        cam, dist_schur.place(dp, group, device), group, iters=2, cg_iters=8)
    _same_on_every_rank(group, "dist_ba_solve", poses)
    _same_on_every_rank(group, "dist_ba_solve points", *dist_schur.assemble(
        group, points, chi2))
    djp, _, _ = dist_schur.make_dist_joint_problem(joint, n_ranks)
    poses_j, points_j, q_j, a_j, chi2_j = dist_schur.dist_joint_ba_solve(
        cam, dist_schur.place_joint(djp, group, device), group, iters=2,
        cg_iters=8)
    _same_on_every_rank(group, "dist_joint_ba_solve", poses_j)
    _same_on_every_rank(group, "dist_joint_ba_solve landmarks",
                        *dist_schur.assemble(group, points_j, q_j, a_j,
                                             chi2_j))
    solved, chi2_s = sharded_ba.ba_solve_sharded(cam, problem, group, iters=1,
                                                 cg_iters=4, device=device)
    _same_on_every_rank(group, "ba_solve_sharded", solved.poses,
                        solved.points, chi2_s)
    return dict(poses=poses.cpu().numpy(), poses_joint=poses_j.cpu().numpy(),
                poses_sharded=solved.poses.cpu().numpy())


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Spawns `n_devices` ranks (one card each with NCCL; gloo ranks on the
    CPU with device="cpu") that each run `dryrun_rank`; raises if a rank
    fails or there are fewer cards than ranks. Returns each rank's poses."""
    from .parallel.ranks import run_ranks
    return run_ranks(dryrun_rank, n_devices, device, args=(n_devices,),
                     timeout_s=300.0)
