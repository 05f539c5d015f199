"""Observation-sharded bundle adjustment on torch.distributed.

Counterpart of lldslam_tpu/parallel/sharded_ba.py. The normal-equation
build is a sum over observations, so splitting the observation table into
contiguous row blocks over the ranks makes every scatter-add a partial sum
followed by an `all_reduce`: the collectives GSPMD inserts in the JAX
package, placed here by `ba.ba_solve`'s two hooks (every pose-space and
every point-space sum over observations, and the LM cost). Poses and points
stay replicated; every rank solves the reduced camera system itself, on
identical all-reduced inputs. For large maps the landmark-sharded Schur
solve (`dist_schur`) moves far less: O(K * 6) per matvec instead of the
point-space vectors too.
"""
from __future__ import annotations

import torch.distributed as dist

from ..geometry.camera import StereoCamera
from ..optim import ba
from .dist_schur import _all_reduce, assemble, make_mesh  # noqa: F401


def shard_problem(problem: ba.BAProblem, group, device=None) -> ba.BAProblem:
    """This rank's contiguous block of observation rows, everything else
    replicated, on `device` (the problem's own by default). The observation
    count must divide by the group's size (pad with invalid observations
    first, the framework's convention)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    O = problem.obs.k.shape[0]
    if O % n:
        raise ValueError(f"{O} observations do not split over {n} ranks")
    per = O // n
    device = problem.poses.device if device is None else device
    to = lambda t: t.to(device)
    return ba.BAProblem(
        poses=to(problem.poses), points=to(problem.points),
        pose_fixed=to(problem.pose_fixed),
        point_valid=to(problem.point_valid),
        obs=ba.BAObs(*(to(a[rank * per: (rank + 1) * per])
                       for a in problem.obs)))


def ba_solve_sharded(cam: StereoCamera, problem: ba.BAProblem, group,
                     iters: int = 5, cg_iters: int = 24, device=None):
    """`ba.ba_solve` with the observation table sharded over `group` and
    every sum over observations all-reduced. Every rank passes the same
    whole problem. Returns (problem' with the solved poses and points,
    chi2 per observation of the whole table), as `ba.ba_solve` does."""
    local = shard_problem(problem, group, device)
    reduce = _all_reduce(group)
    solved, chi2 = ba.ba_solve(cam, local, iters=iters, cg_iters=cg_iters,
                               reduce_poses=reduce, reduce_points=reduce)
    (chi2,) = assemble(group, chi2)
    return problem._replace(poses=solved.poses, points=solved.points), chi2
