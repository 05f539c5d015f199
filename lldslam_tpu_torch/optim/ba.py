"""Bundle adjustment: Levenberg-Marquardt with Huber IRLS, graduated
non-convexity and Schur elimination of the points.

Counterpart of lldslam_tpu/optim/ba.py, two paths over the same residuals:

- the dense (K, P) grid path (`_densify_obs` through `local_ba`): the
  coupling tensor is (K, P, 6, 3), the reduced camera system is solved
  directly, on the reference LocalBundleAdjustment schedule (5 iterations,
  drop outliers, 10 more, classify);
- the sparse observation-table path (`_terms` through `ba_solve`): the
  normal blocks are summed per observation in a fixed order
  (`ops/segment_sum.segment_sum_` over layouts of the keyframe and point
  indices built once per solve, so the card gives the same bits every run)
  and the reduced system is solved matrix-free by block-Jacobi
  preconditioned CG (`dense=False`, what global BA after a loop closure
  runs) or, with `dense=True` (the JAX package's default; here the default
  stays False, which every caller runs), directly from the (K, P, 6, 3)
  coupling tensor, itself a fixed-order segment sum over the cells
  k * P + p (`_schur_dense`).

The accept/reject test and the damping stay on the device, and the solves
use the `_ex` variants, which report failures in a tensor instead of
checking them on the host: the LM loops never wait for the host. The
packed readback of the JAX package is not carried over.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import StereoCamera
from ..ops.segment_sum import SegmentLayout, segment_layout, segment_sum_
from . import residuals as res
from .pose_opt import _row_weights


class BAObs(NamedTuple):
    """Padded point-observation table."""

    k: torch.Tensor           # (O,) int64 keyframe index
    p: torch.Tensor           # (O,) int64 point index
    uvr: torch.Tensor         # (O, 3)
    inv_sigma2: torch.Tensor  # (O,)
    is_stereo: torch.Tensor   # (O,) bool
    valid: torch.Tensor       # (O,) bool


class BAProblem(NamedTuple):
    poses: torch.Tensor       # (K, 4, 4) T_cw
    points: torch.Tensor      # (P, 3)
    pose_fixed: torch.Tensor  # (K,) bool — fixed frontier + gauge
    point_valid: torch.Tensor  # (P,) bool
    obs: BAObs


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - b * i, b * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c00 + b * c10 + c * c20
    idet = 1.0 / torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj * idet[..., None, None]


def _damp_diag(H: torch.Tensor, lam) -> torch.Tensor:
    """H + lam*diag(H) + eps I, batched."""
    n = H.shape[-1]
    I = torch.eye(n, dtype=H.dtype, device=H.device)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + (lam * d + 1e-8)[..., None] * I


def _fix_gauge(S: torch.Tensor, b: torch.Tensor, fixed: torch.Tensor):
    """Zero the rows/cols of fixed poses in the reduced system; unit
    diagonal on their blocks."""
    K = fixed.shape[0]
    free = (~fixed).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    b = b * free[:, None]
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    eyeK = torch.eye(K, dtype=S.dtype, device=S.device)
    S = S + (fixed.to(S.dtype)[:, None, None, None] * eyeK[:, None, :, None]
             * eye6[None, :, None, :])
    return S, b


def _densify_obs(problem: BAProblem):
    """Scatter the (O,) observation table into dense (K, P) grids once,
    before the LM loop; invalid rows land in a dropped extra cell."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    o = problem.obs
    dev = problem.points.device
    cell = torch.where(o.valid, o.k * P + o.p, torch.full_like(o.k, K * P))
    n = K * P + 1

    def grid(vals, shape, dtype):
        g = torch.zeros((n,) + shape, dtype=dtype, device=dev)
        g[cell] = vals.to(dtype)
        return g[:K * P].reshape((K, P) + shape)

    uvr_g = grid(o.uvr, (3,), torch.float32)
    w_g = grid(o.inv_sigma2, (), torch.float32)
    st_g = grid(o.is_stereo, (), torch.bool)
    val_g = grid(torch.ones_like(o.valid), (), torch.bool)
    return uvr_g, w_g, st_g, val_g


def _terms_grid(cam, poses, points, point_valid, uvr_g, w_g, st_g, val_g,
                dscale: float):
    """Residuals, Jacobians and IRLS weights over the dense (K, P) grid;
    also the current robust cost (raw chi2, no 1e6 gate)."""
    T = poses[:, None]                                      # (K, 1, 4, 4)
    X = points[None]                                        # (1, P, 3)
    r = res.point_residual_stereo(cam, T, X, uvr_g)         # (K, P, 3)
    Jc, Jp, Xc = res.point_jacobians_stereo(cam, T, X)
    row_w = _row_weights(st_g)
    chi2_raw = w_g * torch.sum(r * r * row_w, dim=-1)
    in_front = val_g & point_valid[None, :] & (Xc[..., 2] > 0.05)
    active = (in_front & (chi2_raw < 1e6)).to(r.dtype)
    r = r * active[..., None]
    Jc = Jc * active[..., None, None]
    Jp = Jp * active[..., None, None]
    chi2 = w_g * torch.sum(r * r * row_w, dim=-1)
    delta_sq = torch.where(st_g, res.CHI2_STEREO, res.CHI2_MONO) * dscale
    hub = res.huber_weight(chi2, delta_sq)
    W = (w_g * hub * active)[..., None] * row_w             # (K, P, 3)
    rho = res.huber_rho(chi2_raw, delta_sq)
    cost = torch.sum(rho * in_front.to(r.dtype))
    return r, Jc, Jp, W, cost


def _build_blocks_grid(r, Jc, Jp, W):
    """Normal-equation blocks from grid terms."""
    JcW = Jc * W[..., None]                                  # (K, P, 3, 6)
    Hcc = torch.einsum("kpri,kprj->kij", JcW, Jc)
    bc = -torch.einsum("kpri,kpr->ki", JcW, r)
    JpW = Jp * W[..., None]
    Hpp = torch.einsum("kpri,kprj->pij", JpW, Jp)
    bp = -torch.einsum("kpri,kpr->pi", JpW, r)
    B = torch.einsum("kpri,kprj->kpij", JcW, Jp)             # (K, P, 6, 3)
    return Hcc, bc, Hpp, bp, B


def _schur_solve_from_B(pose_fixed, point_valid, Hcc, bc, Hpp, bp, B, lam):
    """Reduced camera system from the dense coupling tensor, gauge fix,
    Jacobi-scaled solve, landmark back-substitution."""
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    seen = B.abs().sum(dim=(0, 2, 3)) > 0
    Hpp_inv = _inv3x3(torch.where(seen[:, None, None], _damp_diag(Hpp, lam),
                                  eye3))
    return _reduced_solve(pose_fixed, point_valid, Hcc, bc, Hpp_inv, bp, B,
                          lam)


def _total_cost_grid(cam, poses, points, point_valid, uvr_g, w_g, st_g,
                     val_g, dscale: float):
    T = poses[:, None]
    X = points[None]
    r = res.point_residual_stereo(cam, T, X, uvr_g)
    Xc = se3.apply(T, X)
    chi2 = w_g * torch.sum(r * r * _row_weights(st_g), dim=-1)
    delta_sq = torch.where(st_g, res.CHI2_STEREO, res.CHI2_MONO) * dscale
    active = (val_g & point_valid[None, :] & (Xc[..., 2] > 0.05)).to(r.dtype)
    return torch.sum(res.huber_rho(chi2, delta_sq) * active)


def ba_solve_grid(cam: StereoCamera, problem: BAProblem, iters: int = 5):
    """LM on the dense grid: GNC (the Huber delta starts 8x inflated and
    halves per iteration), accept on cost decrease. Returns (problem', final
    chi2 per observation)."""
    uvr_g, w_g, st_g, val_g = _densify_obs(problem)
    poses, points = problem.poses, problem.points
    free = (~problem.pose_fixed).to(poses.dtype)
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    for i in range(iters):
        dscale = max(1.0, 64.0 * 0.5 ** i)
        r, Jc, Jp, W, c_old = _terms_grid(
            cam, poses, points, problem.point_valid, uvr_g, w_g, st_g, val_g,
            dscale)
        dc, dp = _schur_solve_from_B(problem.pose_fixed, problem.point_valid,
                                     *_build_blocks_grid(r, Jc, Jp, W), lam)
        poses_c = se3.exp(dc * free[:, None]) @ poses
        points_c = points + dp
        c_new = _total_cost_grid(cam, poses_c, points_c, problem.point_valid,
                                 uvr_g, w_g, st_g, val_g, dscale)
        accept = c_new < c_old
        poses = torch.where(accept, poses_c, poses)
        points = torch.where(accept, points_c, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
    problem = problem._replace(poses=poses, points=points)
    o = problem.obs
    r = res.point_residual_stereo(cam, poses[o.k], points[o.p], o.uvr)
    chi2 = o.inv_sigma2 * torch.sum(r * r * _row_weights(o.is_stereo), dim=-1)
    return problem, chi2


def classify_outliers(problem: BAProblem, chi2: torch.Tensor,
                      cam: StereoCamera) -> torch.Tensor:
    """Observation inlier mask: chi2 gate + positive depth."""
    o = problem.obs
    th = torch.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
    Xc = se3.apply(problem.poses[o.k], problem.points[o.p])
    return o.valid & (chi2 <= th) & (Xc[..., 2] > 0)


def local_ba(cam: StereoCamera, problem: BAProblem):
    """LocalBundleAdjustment schedule: 5 iterations, drop outliers, 10 more,
    final outlier classification. Returns (problem', keep (O,))."""
    problem, chi2 = ba_solve_grid(cam, problem, iters=5)
    keep = classify_outliers(problem, chi2, cam)
    problem = problem._replace(obs=problem.obs._replace(valid=keep))
    problem, chi2 = ba_solve_grid(cam, problem, iters=10)
    return problem, classify_outliers(problem, chi2, cam)


# ---------------------------------------------------------------------------
# sparse observation-table path


def _terms(cam: StereoCamera, problem: BAProblem, delta_scale=1.0):
    """Per-observation residuals, Jacobians and IRLS weights. Returns
    r (O, 3), Jc (O, 3, 6), Jp (O, 3, 3), W (O, 3) row weights, chi2 (O,),
    active (O,)."""
    o = problem.obs
    T = problem.poses[o.k]
    X = problem.points[o.p]
    r = res.point_residual_stereo(cam, T, X, o.uvr)
    Jc, Jp, Xc = res.point_jacobians_stereo(cam, T, X)
    row_w = _row_weights(o.is_stereo)
    chi2_raw = o.inv_sigma2 * torch.sum(r * r * row_w, dim=-1)
    # near-camera and > 1000-sigma observations carry no usable signal and
    # would poison the float32 Schur complement
    active = (o.valid & problem.point_valid[o.p] & (Xc[..., 2] > 0.05)
              & (chi2_raw < 1e6)).to(r.dtype)
    r = r * active[:, None]
    Jc = Jc * active[:, None, None]
    Jp = Jp * active[:, None, None]
    chi2 = o.inv_sigma2 * torch.sum(r * r * row_w, dim=-1)
    delta_sq = torch.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO) \
        * delta_scale
    hub = res.huber_weight(chi2, delta_sq)
    W = (o.inv_sigma2 * hub * active)[:, None] * row_w
    return r, Jc, Jp, W, chi2, active


class ObsLayouts(NamedTuple):
    """Segment layouts of an observation table's two indices."""

    k: SegmentLayout       # rows by keyframe
    p: SegmentLayout       # rows by landmark


def obs_layouts(k: torch.Tensor, n_k: int, p: torch.Tensor,
                n_p: int) -> ObsLayouts:
    """The layouts of an observation table's keyframe index `k` over `n_k`
    keyframes and landmark index `p` over `n_p` landmarks, built once per
    solve."""
    return ObsLayouts(segment_layout(k, n_k), segment_layout(p, n_p))


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _build_blocks(problem: BAProblem, r, Jc, Jp, W, lay: ObsLayouts):
    """Sum observation terms into per-pose / per-point normal blocks."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    JcW = Jc * W[:, :, None]                                 # (O, 3, 6)
    Hcc = segment_sum_(_zeros((K, 6, 6), r), lay.k,
                       torch.einsum("ori,orj->oij", JcW, Jc))
    bc = segment_sum_(_zeros((K, 6), r), lay.k,
                      -torch.einsum("ori,or->oi", JcW, r))
    JpW = Jp * W[:, :, None]
    Hpp = segment_sum_(_zeros((P, 3, 3), r), lay.p,
                       torch.einsum("ori,orj->oij", JpW, Jp))
    bp = segment_sum_(_zeros((P, 3), r), lay.p,
                      -torch.einsum("ori,or->oi", JpW, r))
    Wcp = torch.einsum("ori,orj->oij", JcW, Jp)              # (O, 6, 3)
    return Hcc, bc, Hpp, bp, Wcp


def _same(x):
    return x


def _point_blocks_inv(problem: BAProblem, Hpp, Wcp, lam, lay_p: SegmentLayout,
                      reduce_points=None):
    """Damped point blocks, identity where a point has no active
    observation, inverted in closed form."""
    P = problem.points.shape[0]
    seen = (reduce_points or _same)(segment_sum_(
        _zeros(P, Hpp), lay_p, Wcp.abs().sum(dim=(1, 2)))) > 0
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    return _inv3x3(torch.where(seen[:, None, None], _damp_diag(Hpp, lam),
                               eye3))


def _reduced_solve(pose_fixed, point_valid, Hcc, bc, Hpp_inv, bp, B, lam):
    K = Hcc.shape[0]
    BHinv = torch.einsum("kpij,pjl->kpil", B, Hpp_inv)
    S = torch.einsum("kpil,qpjl->kiqj", BHinv, B)              # (K, 6, K, 6)
    eyeK = torch.eye(K, dtype=Hcc.dtype, device=Hcc.device)
    S = torch.einsum("kij,kq->kiqj", _damp_diag(Hcc, lam), eyeK) - S
    rhs = bc - torch.einsum("kpil,pl->ki", BHinv, bp)
    S, rhs = _fix_gauge(S, rhs, pose_fixed)
    Sm = S.reshape(6 * K, 6 * K)
    Sm = 0.5 * (Sm + Sm.T)
    dsi = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Sm).abs(), min=1e-12))
    Ss = Sm * dsi[:, None] * dsi[None, :] \
        + 1e-6 * torch.eye(6 * K, dtype=Sm.dtype, device=Sm.device)
    y = torch.linalg.solve_ex(Ss, rhs.reshape(6 * K) * dsi)[0]
    dc = (y * dsi).reshape(K, 6)
    dp = torch.einsum("pij,pj->pi", Hpp_inv,
                      bp - torch.einsum("kpij,ki->pj", B, dc))
    return dc, dp * point_valid[:, None]


def _schur_dense(problem: BAProblem, Hcc, bc, Hpp, bp, Wcp, lam,
                 lay: ObsLayouts, lay_kp: SegmentLayout):
    """The explicit reduced camera system of the (K, P, 6, 3) coupling
    tensor, summed per (keyframe, point) cell over the layout `lay_kp` of
    k * P + p; the solve and back-substitution of the dense grid path."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    Hpp_inv = _point_blocks_inv(problem, Hpp, Wcp, lam, lay.p)
    B = segment_sum_(_zeros((K * P, 6, 3), Wcp), lay_kp,
                     Wcp.contiguous()).reshape(K, P, 6, 3)
    return _reduced_solve(problem.pose_fixed, problem.point_valid, Hcc, bc,
                          Hpp_inv, bp, B, lam)


def _schur_cg(problem: BAProblem, Hcc, bc, Hpp, bp, Wcp, lam, cg_iters: int,
              lay: ObsLayouts, reduce_poses=None, reduce_points=None):
    """Matrix-free reduced-system CG: S @ v by two observation-level
    segment sums, block-Jacobi preconditioner on Jacobi-scaled blocks.
    Hcc, bc, Hpp and bp arrive summed over every observation; the two
    hooks sum the pose-space (K, .) and point-space (P, .) scatters of
    this function across the ranks that share the observations (None: one
    device holds them all)."""
    o = problem.obs
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    dt, dev = bc.dtype, bc.device
    rk, rp = reduce_poses or _same, reduce_points or _same
    free = (~problem.pose_fixed).to(dt)
    Hpp_inv = _point_blocks_inv(problem, Hpp, Wcp, lam, lay.p, reduce_points)
    Hcc_d = _damp_diag(Hcc, lam)

    def to_points(v):                     # z_p = sum_o Wcp_o^T v[k(o)]
        return rp(segment_sum_(_zeros((P, 3), bc), lay.p,
                               torch.einsum("oij,oi->oj", Wcp, v[o.k])))

    def to_poses(z):                      # y_k = sum_o Wcp_o z[p(o)]
        return rk(segment_sum_(_zeros((K, 6), bc), lay.k,
                               torch.einsum("oij,oj->oi", Wcp, z[o.p])))

    def S_matvec(v):
        v = v * free[:, None]
        y = torch.einsum("kij,kj->ki", Hcc_d, v)
        z = torch.einsum("pij,pj->pi", Hpp_inv, to_points(v))
        return (y - to_poses(z)) * free[:, None]

    rhs = (bc - to_poses(torch.einsum("pij,pj->pi", Hpp_inv, bp))) \
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
    dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - to_points(x))
    return x, dp * problem.point_valid[:, None]


def _apply_update(problem: BAProblem, dc, dp) -> BAProblem:
    free = (~problem.pose_fixed).to(dc.dtype)
    return problem._replace(poses=se3.exp(dc * free[:, None]) @ problem.poses,
                            points=problem.points + dp)


def _total_cost(cam, problem: BAProblem, delta_scale=1.0):
    o = problem.obs
    T = problem.poses[o.k]
    X = problem.points[o.p]
    r = res.point_residual_stereo(cam, T, X, o.uvr)
    chi2 = o.inv_sigma2 * torch.sum(r * r * _row_weights(o.is_stereo), dim=-1)
    delta_sq = torch.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO) \
        * delta_scale
    Xc = se3.apply(T, X)
    active = (o.valid & problem.point_valid[o.p] & (Xc[..., 2] > 0.05)) \
        .to(r.dtype)
    return torch.sum(res.huber_rho(chi2, delta_sq) * active)


def ba_solve(cam: StereoCamera, problem: BAProblem, iters: int = 5,
             dense: bool = False, cg_iters: int = 24, reduce_poses=None,
             reduce_points=None):
    """`iters` LM iterations on the observation table, each step solved by
    `cg_iters` CG steps, or with `dense` directly from the dense coupling
    tensor (GNC: the Huber delta starts 8x inflated and halves per
    iteration). Returns (problem', final chi2 per observation).

    When ranks share the observation table, `reduce_poses` sums a
    pose-space tensor (and the LM cost) over them and `reduce_points` a
    point-space one (both in place, returning the tensor): every sum over
    observations then covers all of them, so every rank takes the same
    steps (parallel/dist_schur.py, parallel/sharded_ba.py). None: this
    device holds every observation; the dense solve takes no hooks."""
    if dense and (reduce_poses is not None or reduce_points is not None):
        raise ValueError("ba_solve: dense=True solves on one device and "
                         "takes no reduce hooks")
    o = problem.obs
    problem = problem._replace(obs=o._replace(k=o.k.long(), p=o.p.long()))
    o = problem.obs
    K, P = problem.poses.shape[0], problem.points.shape[0]
    lay = obs_layouts(o.k, K, o.p, P)
    lay_kp = segment_layout(o.k * P + o.p, K * P) if dense else None
    rk, rp = reduce_poses or _same, reduce_points or _same
    lam = torch.full((), 1e-4, dtype=problem.poses.dtype,
                     device=problem.poses.device)
    for i in range(iters):
        dscale = max(1.0, 64.0 * 0.5 ** i)
        r, Jc, Jp, W, _, _ = _terms(cam, problem, dscale)
        Hcc, bc, Hpp, bp, Wcp = _build_blocks(problem, r, Jc, Jp, W, lay)
        if dense:
            dc, dp = _schur_dense(problem, Hcc, bc, Hpp, bp, Wcp, lam, lay,
                                  lay_kp)
        else:
            dc, dp = _schur_cg(problem, rk(Hcc), rk(bc), rp(Hpp), rp(bp),
                               Wcp, lam, cg_iters, lay, reduce_poses,
                               reduce_points)
        cand = _apply_update(problem, dc, dp)
        accept = rk(_total_cost(cam, cand, dscale)) \
            < rk(_total_cost(cam, problem, dscale))
        problem = problem._replace(
            poses=torch.where(accept, cand.poses, problem.poses),
            points=torch.where(accept, cand.points, problem.points))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0),
                          1e-9, 1e4)
    o = problem.obs
    r = res.point_residual_stereo(cam, problem.poses[o.k],
                                  problem.points[o.p], o.uvr)
    chi2 = o.inv_sigma2 * torch.sum(r * r * _row_weights(o.is_stereo), dim=-1)
    return problem, chi2
