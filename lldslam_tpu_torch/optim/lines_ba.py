"""Joint point + line bundle adjustment with two-class Schur elimination.

Counterpart of lldslam_tpu/optim/lines_ba.py. Line landmarks enter as
marginalized 4-DoF vertices (quaternion increment + alpha) with two
endpoint-distance rows per camera and two cameras per stereo observation,
information gamma^2 / 1.44^(2 octave). The reduced camera system subtracts
both landmark classes,

    S = Hcc - Wcp Hpp^-1 Wcp^T - Wcl Hll^-1 Wcl^T     (4x4 line blocks),

on the two paths of optim/ba.py:
- `joint_ba_solve` (local BA, `local_joint_ba`): the dense (K, P) point grid
  and (K, L) line grid, the reduced system solved directly;
- `joint_ba_solve_cg` (global BA after a loop closure): the sparse
  observation tables, the reduced system solved matrix-free by
  block-Jacobi preconditioned CG.
Line Jacobians are analytic (`residuals.line_jacobians`; the JAX package
differentiates in forward mode, and the port's tests hold the two
together). Accept/reject and damping stay on the device and the solves are
the `_ex` variants, so the LM loops never wait for the host.
`refine_lines_fixed_poses` (line-only Gauss-Newton with the poses held) is a
standalone utility: neither package calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lines as glines
from ..geometry.camera import StereoCamera
from ..ops.segment_sum import segment_layout, segment_sum_
from . import ba, residuals as res
from .pose_opt import LINE_PYR_FACTOR


class LineBAObs(NamedTuple):
    """Padded line-observation table."""

    k: torch.Tensor        # (O,) int64 keyframe index
    l: torch.Tensor        # (O,) int64 line index
    x1l: torch.Tensor      # (O, 2) observed left endpoints
    x2l: torch.Tensor
    x1r: torch.Tensor      # (O, 2) observed right endpoints
    x2r: torch.Tensor
    octave: torch.Tensor   # (O,) int32
    has_r: torch.Tensor    # (O,) bool
    valid: torch.Tensor    # (O,) bool


class JointProblem(NamedTuple):
    base: ba.BAProblem
    q: torch.Tensor          # (L, 4) line orientation (wxyz)
    alpha: torch.Tensor      # (L,)
    line_valid: torch.Tensor  # (L,) bool
    lobs: LineBAObs


def _stereo_residual(cam, T, q, alpha, x1l, x2l, x1r, x2r):
    """(..., 4): left then right endpoint residuals of one observation."""
    Tr = glines.right_camera_pose(T, cam.baseline)
    return torch.cat([res.line_residual(cam, T, q, alpha, x1l, x2l),
                      res.line_residual(cam, Tr, q, alpha, x1r, x2r)], dim=-1)


def _terms_common(cam, T, q, alpha, x1l, x2l, x1r, x2r, octave, has_r, avail,
                  Xc0_z, gamma: float, delta_scale: float, need_jac: bool):
    """Residuals r (..., 4), Jacobians Jc (..., 4, 6) / Jl (..., 4, 4)
    (None without `need_jac`), row weights W (..., 4) and chi2 (...) of a
    batch of line observations (T, q, alpha broadcast to it). `avail`
    marks the observations that exist; an observation also needs its
    closest line point in front (`Xc0_z` > 0.05) and a finite chi2 under
    1e6, else it contributes exactly zero."""
    r = _stereo_residual(cam, T, q, alpha, x1l, x2l, x1r, x2r)
    Jc = Jl = None
    if need_jac:
        # the pose increment exp(xi) T moves both cameras of the rig
        (Jc_l, Jl_l), (Jc_r, Jl_r) = (
            res.line_jacobians(cam, T, q, alpha, x1, x2, baseline=b)
            for x1, x2, b in ((x1l, x2l, 0.0), (x1r, x2r, cam.baseline)))
        Jc = torch.cat([Jc_l, Jc_r], dim=-2)
        Jl = torch.cat([Jl_l, Jl_r], dim=-2)
    info = (gamma * gamma) / (LINE_PYR_FACTOR ** (2.0 * octave.to(r.dtype)))
    right = has_r.to(r.dtype)[..., None].expand(*has_r.shape, 2)
    row_mask = torch.cat([torch.ones_like(right), right], dim=-1)
    chi2_raw = info * torch.sum(r * r * row_mask, dim=-1)
    active = (avail & (Xc0_z > 0.05) & torch.isfinite(chi2_raw)
              & (chi2_raw < 1e6)).to(r.dtype)
    r = r * active[..., None]
    if need_jac:
        Jc = Jc * active[..., None, None]
        Jl = Jl * active[..., None, None]
    chi2 = info * torch.sum(r * r * row_mask, dim=-1)
    delta_sq = (res.CHI2_STEREO * gamma * gamma) * delta_scale
    W = (info * res.huber_weight(chi2, delta_sq) * active)[..., None] \
        * row_mask
    return r, Jc, Jl, W, chi2


def _line_terms(cam: StereoCamera, problem: JointProblem, gamma: float,
                delta_scale: float = 1.0, need_jac: bool = True):
    """Per observation of the table: r (O, 4), Jc (O, 4, 6), Jl (O, 4, 4),
    W (O, 4), chi2 (O,)."""
    o = problem.lobs
    T = problem.base.poses[o.k]
    q, a = problem.q[o.l], problem.alpha[o.l]
    X0, d = glines.x0dir_from_minimal(q, a)
    Xc0, _ = glines.transform_line(T, X0, d)
    return _terms_common(cam, T, q, a, o.x1l, o.x2l, o.x1r, o.x2r, o.octave,
                         o.has_r, o.valid & problem.line_valid[o.l],
                         Xc0[..., 2], gamma, delta_scale, need_jac)


def _line_blocks(problem: JointProblem, r, Jc, Jl, W, lay: ba.ObsLayouts):
    """Sum line-observation terms into per-pose / per-line blocks (`lay`:
    the line table's layouts, by keyframe and by line)."""
    K = problem.base.poses.shape[0]
    L = problem.q.shape[0]
    JcW = Jc * W[:, :, None]
    Hcc = segment_sum_(ba._zeros((K, 6, 6), r), lay.k,
                       torch.einsum("ori,orj->oij", JcW, Jc))
    bc = segment_sum_(ba._zeros((K, 6), r), lay.k,
                      -torch.einsum("ori,or->oi", JcW, r))
    JlW = Jl * W[:, :, None]
    Hll = segment_sum_(ba._zeros((L, 4, 4), r), lay.p,
                       torch.einsum("ori,orj->oij", JlW, Jl))
    bl = segment_sum_(ba._zeros((L, 4), r), lay.p,
                      -torch.einsum("ori,or->oi", JlW, r))
    return Hcc, bc, Hll, bl, torch.einsum("ori,orj->oij", JcW, Jl)


def _densify_lobs(problem: JointProblem):
    """Scatter the (O,) line-observation table into dense (K, L) grids once
    (a line is observed at most once per keyframe); invalid rows land in a
    dropped extra cell."""
    K = problem.base.poses.shape[0]
    L = problem.q.shape[0]
    o = problem.lobs
    dev = problem.q.device
    cell = torch.where(o.valid, o.k * L + o.l, torch.full_like(o.k, K * L))
    n = K * L + 1

    def grid(vals, shape, dtype):
        g = torch.zeros((n,) + shape, dtype=dtype, device=dev)
        g[cell] = vals.to(dtype)
        return g[:K * L].reshape((K, L) + shape)

    return (grid(o.x1l, (2,), torch.float32), grid(o.x2l, (2,), torch.float32),
            grid(o.x1r, (2,), torch.float32), grid(o.x2r, (2,), torch.float32),
            grid(o.octave, (), torch.int32), grid(o.has_r, (), torch.bool),
            grid(torch.ones_like(o.valid), (), torch.bool))


def _line_terms_grid(cam: StereoCamera, poses, q, alpha, line_valid, grids,
                     gamma: float, delta_scale: float, need_jac: bool = True):
    """`_line_terms` over the dense (K, L) grid: r (K, L, 4),
    Jc (K, L, 4, 6), Jl (K, L, 4, 4), W (K, L, 4), chi2 (K, L)."""
    x1l, x2l, x1r, x2r, oct_g, hasr_g, val_g = grids
    T = poses[:, None]                                     # (K, 1, 4, 4)
    X0, d = glines.x0dir_from_minimal(q, alpha)            # (L, 3)
    Xc0, _ = glines.transform_line(T, X0[None], d[None])
    return _terms_common(cam, T, q[None], alpha[None], x1l, x2l, x1r, x2r,
                         oct_g, hasr_g, val_g & line_valid[None, :],
                         Xc0[..., 2], gamma, delta_scale, need_jac)


def _line_blocks_grid(r, Jc, Jl, W):
    """Line normal-equation blocks from grid terms."""
    JcW = Jc * W[..., None]                                  # (K, L, 4, 6)
    Hcc = torch.einsum("klri,klrj->kij", JcW, Jc)
    bc = -torch.einsum("klri,klr->ki", JcW, r)
    JlW = Jl * W[..., None]
    Hll = torch.einsum("klri,klrj->lij", JlW, Jl)
    bl = -torch.einsum("klri,klr->li", JlW, r)
    Bl = torch.einsum("klri,klrj->klij", JcW, Jl)            # (K, L, 6, 4)
    return Hcc, bc, Hll, bl, Bl


def _inv4x4(A: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 inverse by blockwise elimination on 2x2 sub-blocks with
    closed-form 2x2 inverses. A is damped SPD."""
    a, b = A[..., :2, :2], A[..., :2, 2:]
    c, d = A[..., 2:, :2], A[..., 2:, 2:]

    def inv2(M):
        m00, m01 = M[..., 0, 0], M[..., 0, 1]
        m10, m11 = M[..., 1, 0], M[..., 1, 1]
        det = m00 * m11 - m01 * m10
        idet = 1.0 / torch.where(det.abs() < 1e-20,
                                 torch.full_like(det, 1e-20), det)
        return torch.stack([torch.stack([m11, -m01], -1),
                            torch.stack([-m10, m00], -1)], -2) \
            * idet[..., None, None]

    ai = inv2(a)
    si = inv2(d - c @ ai @ b)
    aib, cai = ai @ b, c @ ai
    top = torch.cat([ai + aib @ si @ cai, -(aib @ si)], dim=-1)
    bot = torch.cat([-(si @ cai), si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _line_blocks_inv(Hll, seen, lam):
    """Damped line blocks, identity where a line has no active
    observation, inverted."""
    eye4 = torch.eye(4, dtype=Hll.dtype, device=Hll.device)
    return _inv4x4(torch.where(seen[:, None, None], ba._damp_diag(Hll, lam),
                               eye4))


def _apply_line_update(problem: JointProblem, dl) -> JointProblem:
    q = res._quat_mul(res._quat_increment(dl[:, :3]), problem.q)
    return problem._replace(q=q, alpha=problem.alpha + dl[:, 3])


def _select(accept, old: JointProblem, new: JointProblem) -> JointProblem:
    pick = lambda a, b: torch.where(accept, b, a)
    return old._replace(
        base=old.base._replace(poses=pick(old.base.poses, new.base.poses),
                               points=pick(old.base.points, new.base.points)),
        q=pick(old.q, new.q), alpha=pick(old.alpha, new.alpha))


def _line_rho(chi2, delta_sq):
    """Huber cost of the active line observations (chi2 > 0)."""
    return torch.sum(res.huber_rho(chi2, delta_sq) * (chi2 > 0).to(chi2.dtype))


def _final_chi2(cam: StereoCamera, problem: JointProblem, gamma: float):
    """Point chi2 (Op,) and unweighted line chi2 (Ol,) at the solution."""
    o = problem.base.obs
    rp = res.point_residual_stereo(cam, problem.base.poses[o.k],
                                   problem.base.points[o.p], o.uvr)
    chi2_p = o.inv_sigma2 * torch.sum(rp * rp * ba._row_weights(o.is_stereo),
                                      dim=-1)
    return chi2_p, _line_terms(cam, problem, gamma, need_jac=False)[4]


def _long_indices(problem: JointProblem) -> JointProblem:
    o, lo = problem.base.obs, problem.lobs
    return problem._replace(
        base=problem.base._replace(obs=o._replace(k=o.k.long(), p=o.p.long())),
        lobs=lo._replace(k=lo.k.long(), l=lo.l.long()))


def joint_ba_solve(cam: StereoCamera, problem: JointProblem, iters: int = 5,
                   gamma: float = 0.5):
    """LM on the joint problem over the dense (K, P) point grid and (K, L)
    line grid, GNC (Huber delta 8x inflated, halving per iteration), the
    reduced camera system solved directly. Returns (problem', point chi2
    (Op,), line chi2 (Ol,))."""
    problem = _long_indices(problem)
    base = problem.base
    uvr_g, w_g, st_g, pval_g = ba._densify_obs(base)
    grids = _densify_lobs(problem)
    point_valid, pose_fixed = base.point_valid, base.pose_fixed
    K = base.poses.shape[0]
    dt, dev = problem.q.dtype, problem.q.device
    eyeK = torch.eye(K, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    for i in range(iters):
        dscale = max(1.0, 64.0 * 0.5 ** i)
        delta_sq_l = (res.CHI2_STEREO * gamma * gamma) * dscale
        b0 = problem.base
        rp, Jcp, Jp, Wp, c_old_p = ba._terms_grid(
            cam, b0.poses, b0.points, point_valid, uvr_g, w_g, st_g, pval_g,
            dscale)
        Hcc, bc, Hpp, bp, Bp = ba._build_blocks_grid(rp, Jcp, Jp, Wp)
        rl, Jcl, Jl, Wl, chi2_l0 = _line_terms_grid(
            cam, b0.poses, problem.q, problem.alpha, problem.line_valid,
            grids, gamma, dscale)
        Hcc_l, bc_l, Hll, bl, Bl = _line_blocks_grid(rl, Jcl, Jl, Wl)
        Hcc, bc = Hcc + Hcc_l, bc + bc_l

        seen_p = Bp.abs().sum(dim=(0, 2, 3)) > 0
        Hpp_inv = ba._inv3x3(torch.where(seen_p[:, None, None],
                                         ba._damp_diag(Hpp, lam), eye3))
        Hll_inv = _line_blocks_inv(Hll, Bl.abs().sum(dim=(0, 2, 3)) > 0, lam)
        BHp = torch.einsum("kpij,pjl->kpil", Bp, Hpp_inv)
        BHl = torch.einsum("klij,ljm->klim", Bl, Hll_inv)
        S = torch.einsum("kij,kq->kiqj", ba._damp_diag(Hcc, lam), eyeK) \
            - torch.einsum("kpil,qpjl->kiqj", BHp, Bp) \
            - torch.einsum("klim,qljm->kiqj", BHl, Bl)
        rhs = bc - torch.einsum("kpil,pl->ki", BHp, bp) \
            - torch.einsum("klim,lm->ki", BHl, bl)
        S, rhs = ba._fix_gauge(S, rhs, pose_fixed)
        Sm = S.reshape(6 * K, 6 * K)
        Sm = 0.5 * (Sm + Sm.T)
        dsi = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Sm).abs(),
                                           min=1e-12))
        Ss = Sm * dsi[:, None] * dsi[None, :] \
            + 1e-6 * torch.eye(6 * K, dtype=dt, device=dev)
        dc = (torch.linalg.solve_ex(Ss, rhs.reshape(6 * K) * dsi)[0]
              * dsi).reshape(K, 6)
        dp = torch.einsum("pij,pj->pi", Hpp_inv,
                          bp - torch.einsum("kpij,ki->pj", Bp, dc))
        dl = torch.einsum("lij,lj->li", Hll_inv,
                          bl - torch.einsum("klij,ki->lj", Bl, dc))
        cand = _apply_line_update(problem._replace(base=ba._apply_update(
            b0, dc, dp * point_valid[:, None])),
            dl * problem.line_valid[:, None])
        c_old = c_old_p + _line_rho(chi2_l0, delta_sq_l)
        cb = cand.base
        chi2_l1 = _line_terms_grid(cam, cb.poses, cand.q, cand.alpha,
                                   cand.line_valid, grids, gamma, dscale,
                                   need_jac=False)[4]
        c_new = ba._total_cost_grid(cam, cb.poses, cb.points, point_valid,
                                    uvr_g, w_g, st_g, pval_g, dscale) \
            + _line_rho(chi2_l1, delta_sq_l)
        accept = c_new < c_old
        problem = _select(accept, problem, cand)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
    return (problem, *_final_chi2(cam, problem, gamma))


def _joint_cost(cam: StereoCamera, problem: JointProblem, gamma: float,
                dscale: float):
    """Total robust cost over both landmark classes (sparse tables)."""
    chi2 = _line_terms(cam, problem, gamma, dscale, need_jac=False)[4]
    return ba._total_cost(cam, problem.base, dscale) \
        + _line_rho(chi2, (res.CHI2_STEREO * gamma * gamma) * dscale)


def _schur_cg_joint(problem: JointProblem, Hcc, bc, Hpp, bp, Wcp, Hll, bl,
                    Wcl, lam, cg_iters: int, lay: ba.ObsLayouts,
                    lay_l: ba.ObsLayouts, reduce_poses=None,
                    reduce_points=None):
    """Matrix-free reduced camera system with both landmark classes
    marginalized: S @ v by observation-level segment sums per class (`lay`
    and `lay_l`: the point and line tables' layouts), block-Jacobi
    preconditioner on Jacobi-scaled blocks. Returns (dc, dp, dl). The
    hooks are `ba._schur_cg`'s; `reduce_points` serves both landmark
    classes, and one `reduce_poses` carries both classes' pose-space
    backscatter."""
    base = problem.base
    o, ol = base.obs, problem.lobs
    K, P, L = base.poses.shape[0], base.points.shape[0], problem.q.shape[0]
    dt, dev = bc.dtype, bc.device
    rk, rp = reduce_poses or ba._same, reduce_points or ba._same
    free = (~base.pose_fixed).to(dt)
    Hpp_inv = ba._point_blocks_inv(base, Hpp, Wcp, lam, lay.p, reduce_points)
    seen_l = rp(segment_sum_(ba._zeros(L, bc), lay_l.p,
                             Wcl.abs().sum(dim=(1, 2)))) > 0
    Hll_inv = _line_blocks_inv(Hll, seen_l, lam)
    Hcc_d = ba._damp_diag(Hcc, lam)

    def to_marks(v):
        """Both classes' z = W^T v per landmark, through H^-1."""
        zp = rp(segment_sum_(ba._zeros((P, 3), bc), lay.p,
                             torch.einsum("oij,oi->oj", Wcp, v[o.k])))
        zl = rp(segment_sum_(ba._zeros((L, 4), bc), lay_l.p,
                             torch.einsum("oij,oi->oj", Wcl, v[ol.k])))
        return zp, zl

    def to_poses(zp, zl):
        """y_k = sum_o W_o z[landmark(o)] over both classes."""
        y = segment_sum_(ba._zeros((K, 6), bc), lay.k,
                         torch.einsum("oij,oj->oi", Wcp, zp[o.p]))
        return rk(segment_sum_(y, lay_l.k,
                               torch.einsum("oij,oj->oi", Wcl, zl[ol.l])))

    def S_matvec(v):
        v = v * free[:, None]
        zp, zl = to_marks(v)
        y = torch.einsum("kij,kj->ki", Hcc_d, v) - to_poses(
            torch.einsum("pij,pj->pi", Hpp_inv, zp),
            torch.einsum("lij,lj->li", Hll_inv, zl))
        return y * free[:, None]

    rhs = (bc - to_poses(torch.einsum("pij,pj->pi", Hpp_inv, bp),
                         torch.einsum("lij,lj->li", Hll_inv, bl))) \
        * free[:, None]
    db = torch.sqrt(torch.clamp(torch.diagonal(Hcc_d, dim1=-2, dim2=-1),
                                min=1e-12))
    scale = db[:, :, None] * db[:, None, :]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Minv = torch.linalg.inv_ex(Hcc_d / scale + 1e-6 * eye6)[0] / scale

    def precond(r):
        return torch.einsum("kij,kj->ki", Minv, r) * free[:, None]

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = S_matvec(pdir)
        denom = torch.sum(pdir * Ap)
        alpha = rz / torch.where(denom.abs() < 1e-12,
                                 torch.full_like(denom, 1e-12), denom)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz.abs() < 1e-12,
                                    torch.full_like(rz, 1e-12), rz)
        pdir = z + beta * pdir
        rz = rz_new
    zp, zl = to_marks(x)
    dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - zp)
    dl = torch.einsum("lij,lj->li", Hll_inv, bl - zl)
    return (x, dp * base.point_valid[:, None],
            dl * (problem.line_valid & seen_l)[:, None])


def joint_ba_solve_cg(cam: StereoCamera, problem: JointProblem, iters: int = 10,
                      cg_iters: int = 64, gamma: float = 0.5,
                      reduce_poses=None, reduce_points=None):
    """Joint pose + point + line global BA on the sparse tables: `iters` LM
    iterations (GNC as in `joint_ba_solve`), each step from `cg_iters` CG
    steps on the two-class reduced system. Returns (problem', point chi2,
    line chi2). The hooks are `ba.ba_solve`'s; `reduce_points` serves both
    landmark classes."""
    problem = _long_indices(problem)
    o, ol = problem.base.obs, problem.lobs
    K, P, L = (problem.base.poses.shape[0], problem.base.points.shape[0],
               problem.q.shape[0])
    lay = ba.obs_layouts(o.k, K, o.p, P)
    lay_l = ba.obs_layouts(ol.k, K, ol.l, L)
    rk, rpt = reduce_poses or ba._same, reduce_points or ba._same
    lam = torch.full((), 1e-4, dtype=problem.q.dtype, device=problem.q.device)
    for i in range(iters):
        dscale = max(1.0, 64.0 * 0.5 ** i)
        base = problem.base
        rp, Jcp, Jp, Wp, _, _ = ba._terms(cam, base, dscale)
        Hcc, bc, Hpp, bp, Wcp = ba._build_blocks(base, rp, Jcp, Jp, Wp, lay)
        rl, Jcl, Jl, Wl, _ = _line_terms(cam, problem, gamma, dscale)
        Hcc_l, bc_l, Hll, bl, Wcl = _line_blocks(problem, rl, Jcl, Jl, Wl,
                                                 lay_l)
        dc, dp, dl = _schur_cg_joint(
            problem, rk(Hcc + Hcc_l), rk(bc + bc_l), rpt(Hpp), rpt(bp), Wcp,
            rpt(Hll), rpt(bl), Wcl, lam, cg_iters, lay, lay_l, reduce_poses,
            reduce_points)
        cand = _apply_line_update(
            problem._replace(base=ba._apply_update(base, dc, dp)), dl)
        accept = rk(_joint_cost(cam, cand, gamma, dscale)) \
            < rk(_joint_cost(cam, problem, gamma, dscale))
        problem = _select(accept, problem, cand)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
    return (problem, *_final_chi2(cam, problem, gamma))


def refine_lines_fixed_poses(cam: StereoCamera, problem: JointProblem,
                             gamma: float = 0.5, iters: int = 4):
    """Line refinement with the poses held fixed: per line a damped 4x4
    Gauss-Newton step over all its (robustly weighted) observations,
    `iters` times; a step that leaves a line non-finite is dropped.
    Returns (q, alpha)."""
    L = problem.q.shape[0]
    lay_l = segment_layout(problem.lobs.l.long(), L)
    q, a = problem.q, problem.alpha
    dt, dev = q.dtype, q.device
    damp = 1e-3 * torch.eye(4, dtype=dt, device=dev)
    for _ in range(iters):
        pb = problem._replace(q=q, alpha=a)
        r, _, Jl, W, _ = _line_terms(cam, pb, gamma)
        JlW = Jl * W[:, :, None]
        Hll = segment_sum_(ba._zeros((L, 4, 4), q), lay_l,
                           torch.einsum("ori,orj->oij", JlW, Jl)) + damp
        bl = segment_sum_(ba._zeros((L, 4), q), lay_l,
                          -torch.einsum("ori,or->oi", JlW, r))
        dl = torch.einsum("lij,lj->li", _inv4x4(Hll), bl)
        has = segment_sum_(ba._zeros(L, q), lay_l, W.sum(-1)) > 0
        dl = torch.where((has & problem.line_valid)[:, None], dl, 0.0)
        pb2 = _apply_line_update(pb, dl)
        fin = torch.isfinite(pb2.q).all(-1) & torch.isfinite(pb2.alpha)
        q = torch.where(fin[:, None], pb2.q, q)
        a = torch.where(fin, pb2.alpha, a)
    return q, a


def classify_line_outliers(problem: JointProblem, chi2_l: torch.Tensor,
                           gamma: float = 0.5) -> torch.Tensor:
    """Line observation inlier mask: chi2 against twice the gamma-scaled
    stereo threshold."""
    return problem.lobs.valid & (chi2_l <= 2.0 * res.CHI2_STEREO * gamma * gamma)


def local_joint_ba(cam: StereoCamera, problem: JointProblem,
                   gamma: float = 0.5):
    """Local-BA schedule with both landmark classes: 5 iterations, drop
    point and line outliers, 10 more, final classification. Returns
    (problem', keep_p (Op,), keep_l (Ol,))."""
    problem, chi2_p, chi2_l = joint_ba_solve(cam, problem, iters=5,
                                             gamma=gamma)
    keep_p = ba.classify_outliers(problem.base, chi2_p, cam)
    keep_l = classify_line_outliers(problem, chi2_l, gamma)
    problem = problem._replace(
        base=problem.base._replace(obs=problem.base.obs._replace(valid=keep_p)),
        lobs=problem.lobs._replace(valid=keep_l))
    problem, chi2_p, chi2_l = joint_ba_solve(cam, problem, iters=10,
                                             gamma=gamma)
    return (problem, ba.classify_outliers(problem.base, chi2_p, cam),
            classify_line_outliers(problem, chi2_l, gamma))
