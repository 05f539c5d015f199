"""The plain reference of the tracking step's joint point+line pose and of
the keyframe map's windowed local BA: plain torch, in float64.

Both are least-squares problems over camera poses and landmarks:

- a point observation is the stereo reprojection (u, v, and the right u
  where the keypoint has one) of a world point, weighted by the octave's
  information scale^(-2 octave);
- a line observation is the signed distance of each observed endpoint, in
  the left and (where it has one) the right image, to the projected
  infinite line, weighted by gamma^2 / 1.44^(2 octave), as LLD-SLAM states
  the line edge;
- both under the Huber kernel whose delta is the chi2 gate (7.815 stereo,
  5.991 mono; times gamma^2 for lines).

`Problem` holds one such problem; `solve` minimises it by Levenberg-
Marquardt, with the landmarks marginalised (Schur complement) and the
Jacobians taken by central differences in float64, so the reference needs
no derivative of its own to be right: only its residuals. A line is held
as two of its points, each moved across the line's direction only, so its
four degrees of freedom have no gauge. `dtype` below float64 (the
control) keeps the state in that precision: every update is rounded to it
and the residuals are evaluated on the rounded state.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .reference import se3_exp

CHI2_MONO, CHI2_STEREO = 5.991, 7.815
LINE_PYR = 1.44
F64 = torch.float64


def point_info(octave: torch.Tensor, scale: float) -> torch.Tensor:
    """scale^(-2 octave): a keypoint's information at its octave."""
    return torch.pow(torch.tensor(scale, dtype=F64, device=octave.device),
                     -2.0 * octave.to(F64))


def line_info(octave: torch.Tensor, gamma: float) -> torch.Tensor:
    return gamma * gamma / torch.pow(
        torch.tensor(LINE_PYR, dtype=F64, device=octave.device),
        2.0 * octave.to(F64))


def _px(cam, Xc):
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([cam["fx"] * Xc[..., 0] / z + cam["cx"],
                        cam["fy"] * Xc[..., 1] / z + cam["cy"]], -1), z


def _apply(T, X):
    return (T[..., :3, :3] @ X[..., None])[..., 0] + T[..., :3, 3]


def point_residual(cam, T, X, uvr):
    """(..., 3): observed (u, v, right u) minus predicted."""
    (p, z) = _px(cam, _apply(T, X))
    pred = torch.stack([p[..., 0], p[..., 1], p[..., 0] - cam["bf"] / z], -1)
    return uvr - pred


def right_pose(cam, T):
    """The right camera's T_cw: the left's, moved by the baseline."""
    Tr = T.clone()
    Tr[..., 0, 3] = T[..., 0, 3] - cam["bf"] / cam["fx"]
    return Tr


def line_residual(cam, T, A, B, x1, x2):
    """(..., 2): signed distances of the observed endpoints x1, x2 to the
    line through the projections of the world points A and B."""
    pa, _ = _px(cam, _apply(T, A))
    pb, _ = _px(cam, _apply(T, B))
    one = torch.ones_like(pa[..., :1])
    l = torch.linalg.cross(torch.cat([pa, one], -1), torch.cat([pb, one], -1),
                           dim=-1)
    l = l / torch.clamp(torch.linalg.norm(l[..., :2], dim=-1, keepdim=True),
                        min=1e-9)
    d = lambda x: l[..., 0] * x[..., 0] + l[..., 1] * x[..., 1] + l[..., 2]
    return torch.stack([d(x1), d(x2)], -1)


def line_front_z(T, A, B):
    """Depth of the line's point closest to the camera centre."""
    P = _apply(T, A)
    dn = (T[..., :3, :3] @ (B - A)[..., None])[..., 0]
    dn = dn / torch.clamp(torch.linalg.norm(dn, dim=-1, keepdim=True),
                          min=1e-9)
    return (P - (P * dn).sum(-1, keepdim=True) * dn)[..., 2]


def huber(chi2, d2):
    return torch.where(chi2 <= d2, chi2,
                       2.0 * torch.sqrt(d2 * torch.clamp(chi2, min=0.0)) - d2)


def huber_w(chi2, d2):
    return torch.where(chi2 <= d2, torch.ones_like(chi2),
                       torch.sqrt(d2 / torch.clamp(chi2, min=1e-12)))


@dataclass
class Problem:
    """Poses (K, 4, 4) T_cw with `fixed` (K,); points (P, 3) with `pvalid`
    and their observations `pk`, `pp` (pose and point index), `uvr` (O, 3),
    `pinfo`, `stereo`, `pobs` (O,) the ones in the problem; lines (L, 3)
    `A`, `B` with `lvalid` and their observations `lk`, `ll`, `x1l`, `x2l`,
    `x1r`, `x2r` (M, 2), `linfo`, `has_r`, `lobs` (M,).

    `move_landmarks` True (the BA): an observation of a line has four rows,
    both views', and one Huber kernel at the stereo gate; an observation
    counts where its point (or the line's closest point) lies over 5 cm in
    front and its chi2 under 1e6. False (the pose step): the landmarks
    stay, every observation counts, and `lcam` (M,) says which camera a
    line observation is in: each view of a line is an edge of its own, two
    rows (`x1l`, `x2l`), gated at the stereo chi2 where the line has a
    right view (`has_r`) and at the mono one elsewhere; a line is an
    outlier where its two edges' chi2 sum over twice the gate."""

    poses: torch.Tensor
    fixed: torch.Tensor
    points: torch.Tensor
    pvalid: torch.Tensor
    pk: torch.Tensor
    pp: torch.Tensor
    uvr: torch.Tensor
    pinfo: torch.Tensor
    stereo: torch.Tensor
    pobs: torch.Tensor
    A: torch.Tensor | None = None
    B: torch.Tensor | None = None
    lvalid: torch.Tensor | None = None
    lk: torch.Tensor | None = None
    ll: torch.Tensor | None = None
    x1l: torch.Tensor | None = None
    x2l: torch.Tensor | None = None
    x1r: torch.Tensor | None = None
    x2r: torch.Tensor | None = None
    linfo: torch.Tensor | None = None
    has_r: torch.Tensor | None = None
    lobs: torch.Tensor | None = None
    lcam: torch.Tensor | None = None
    gamma: float = 0.5
    move_landmarks: bool = True

    @property
    def lines(self) -> bool:
        return self.A is not None and self.lk is not None \
            and self.lk.shape[0] > 0


def _point_rows(cam, pr: Problem, poses, points):
    T, X = poses[pr.pk], points[pr.pp]
    r = point_residual(cam, T, X, pr.uvr)
    roww = torch.stack([torch.ones_like(pr.pinfo), torch.ones_like(pr.pinfo),
                        pr.stereo.to(pr.pinfo.dtype)], -1)
    return r, roww * pr.pinfo[:, None]


def _point_terms(cam, pr: Problem, poses, points, dscale):
    """chi2 (O,), active (O,), d2 (O,), depth (O,) of the point
    observations."""
    r, w = _point_rows(cam, pr, poses, points)
    chi2 = (w * r * r).sum(-1)
    z = _apply(poses[pr.pk], points[pr.pp])[..., 2]
    active = pr.pobs & pr.pvalid[pr.pp]
    if pr.move_landmarks:
        active = active & (z > 0.05) & (chi2 < 1e6)
    d2 = torch.where(pr.stereo, CHI2_STEREO, CHI2_MONO) * dscale
    return chi2, active, d2, z


def _line_res(cam, pr: Problem, T, a, b):
    """The residual rows of the line observations: both views' (4) in the
    BA, the observation's own view's (2) in the pose step."""
    if pr.lcam is None:
        return torch.cat([line_residual(cam, T, a, b, pr.x1l, pr.x2l),
                          line_residual(cam, right_pose(cam, T), a, b,
                                        pr.x1r, pr.x2r)], -1)
    Tv = torch.where(pr.lcam[:, None, None], right_pose(cam, T), T)
    return line_residual(cam, Tv, a, b, pr.x1l, pr.x2l)


def _line_rows(cam, pr: Problem, poses, A, B):
    r = _line_res(cam, pr, poses[pr.lk], A[pr.ll], B[pr.ll])
    w = pr.linfo[:, None].expand_as(r)
    if pr.lcam is None:
        hr = pr.has_r.to(pr.linfo.dtype)[:, None]
        w = w * torch.cat([torch.ones_like(hr).expand(-1, 2),
                           hr.expand(-1, 2)], -1)
    return r, w


def _line_terms(cam, pr: Problem, poses, A, B, dscale):
    r, w = _line_rows(cam, pr, poses, A, B)
    chi2 = (w * r * r).sum(-1)
    active = pr.lobs & pr.lvalid[pr.ll]
    g2 = pr.gamma * pr.gamma
    if pr.move_landmarks:
        z = line_front_z(poses[pr.lk], A[pr.ll], B[pr.ll])
        active = active & (z > 0.05) & torch.isfinite(chi2) & (chi2 < 1e6)
        d2 = torch.full_like(chi2, CHI2_STEREO * g2)
    else:
        d2 = torch.where(pr.has_r, CHI2_STEREO * g2, CHI2_MONO * g2)
    return torch.where(active, chi2, torch.zeros_like(chi2)), active, \
        d2 * dscale


def cost(cam, pr: Problem, poses=None, points=None, A=None, B=None,
         dscale: float = 1.0) -> torch.Tensor:
    """The Huber cost of the problem's observations at the given state
    (the problem's own where None)."""
    poses = pr.poses if poses is None else poses
    points = pr.points if points is None else points
    chi2, active, d2, _ = _point_terms(cam, pr, poses.to(F64),
                                       points.to(F64), dscale)
    c = (huber(chi2, d2) * active).sum()
    if pr.lines:
        A = pr.A if A is None else A
        B = pr.B if B is None else B
        chi2, active, d2 = _line_terms(cam, pr, poses.to(F64), A.to(F64),
                                       B.to(F64), dscale)
        c = c + (huber(chi2, d2) * active).sum()
    return c


def _perp_basis(A, B):
    """Two unit vectors across the direction B - A, (L, 3) each."""
    d = B - A
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    ref = torch.where((d[:, :1].abs() < 0.9),
                      torch.tensor([1.0, 0.0, 0.0], dtype=d.dtype,
                                   device=d.device),
                      torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype,
                                   device=d.device))
    u1 = torch.linalg.cross(d, ref, dim=-1)
    u1 = u1 / torch.linalg.norm(u1, dim=-1, keepdim=True)
    return u1, torch.linalg.cross(d, u1, dim=-1)


def _line_move(A, B, u1, u2, dl):
    """A and B moved across the line by dl (..., 4)."""
    return (A + dl[..., 0:1] * u1 + dl[..., 1:2] * u2,
            B + dl[..., 2:3] * u1 + dl[..., 3:4] * u2)


def _jac(f, n: int, like, h: float = 1e-6):
    """Central differences of f(delta (O, n)) -> (O, m): (O, m, n)."""
    cols = []
    for i in range(n):
        e = torch.zeros(n, dtype=F64, device=like.device)
        e[i] = h
        cols.append((f(e) - f(-e)) / (2 * h))
    return torch.stack(cols, -1)


def _block_sum(index, n, rows):
    out = torch.zeros((n, *rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, index, rows)


def _system(cam, pr: Problem, poses, points, A, B, dscale):
    """The Gauss-Newton blocks of each landmark class: a list of (pose index
    (O,), landmark index (O,), n landmarks, Jc^T W r, Jc^T W Jc, Jl^T W Jl,
    Jl^T W r, Jc^T W Jl) with IRLS weights at the state."""
    K = poses.shape[0]
    free = (~pr.fixed).to(F64)
    out = []
    chi2, active, d2, _ = _point_terms(cam, pr, poses, points, dscale)
    T, X = poses[pr.pk], points[pr.pp]
    w = (huber_w(chi2, d2) * active)[:, None] * _point_rows(
        cam, pr, poses, points)[1]
    r = point_residual(cam, T, X, pr.uvr)
    Jc = _jac(lambda e: point_residual(cam, se3_exp(e.expand(
        len(pr.pk), 6)) @ T, X, pr.uvr), 6, T) * free[pr.pk][:, None, None]
    Jl = _jac(lambda e: point_residual(cam, T, X + e, pr.uvr), 3, T)
    out.append((pr.pk, pr.pp, points.shape[0], r, w, Jc, Jl))
    if pr.lines:
        chi2, active, d2 = _line_terms(cam, pr, poses, A, B, dscale)
        T = poses[pr.lk]
        a, b = A[pr.ll], B[pr.ll]
        u1, u2 = _perp_basis(a, b)

        def res(Tx, ax, bx):
            return _line_res(cam, pr, Tx, ax, bx)
        w = (huber_w(chi2, d2) * active)[:, None] * _line_rows(
            cam, pr, poses, A, B)[1]
        r = res(T, a, b)
        Jc = _jac(lambda e: res(se3_exp(e.expand(len(pr.lk), 6)) @ T, a, b),
                  6, T) * free[pr.lk][:, None, None]
        Jl = _jac(lambda e: res(T, *_line_move(a, b, u1, u2, e)), 4, T)
        r = torch.where(active[:, None], r, torch.zeros_like(r))
        out.append((pr.lk, pr.ll, A.shape[0], r, w, Jc, Jl))
    return K, out


def _step(cam, pr: Problem, poses, points, A, B, lam, dscale):
    """One damped Gauss-Newton step: (dc (K, 6), dp (P, 3), dl (L, 4))."""
    K, classes = _system(cam, pr, poses, points, A, B, dscale)
    Hcc = torch.zeros((K, 6, 6), dtype=F64, device=poses.device)
    bc = torch.zeros((K, 6), dtype=F64, device=poses.device)
    S_minus = torch.zeros((6 * K, 6 * K), dtype=F64, device=poses.device)
    rhs_minus = torch.zeros(6 * K, dtype=F64, device=poses.device)
    marg = []
    for ki, li, n, r, w, Jc, Jl in classes:
        JcW = Jc.transpose(1, 2) * w[:, None, :]
        Hcc += _block_sum(ki, K, JcW @ Jc)
        bc -= _block_sum(ki, K, (JcW @ r[..., None])[..., 0])
        if not pr.move_landmarks:
            continue
        JlW = Jl.transpose(1, 2) * w[:, None, :]
        dl = Jl.shape[-1]
        Hll = _block_sum(li, n, JlW @ Jl)
        bl = -_block_sum(li, n, (JlW @ r[..., None])[..., 0])
        E = torch.zeros((n * K, 6, dl), dtype=F64, device=poses.device)
        E.index_add_(0, li * K + ki, JcW @ Jl)
        E = E.reshape(n, K, 6, dl).reshape(n, 6 * K, dl)
        diag = torch.diagonal(Hll, dim1=-2, dim2=-1)
        seen = diag.sum(-1) > 0
        eye = torch.eye(dl, dtype=F64, device=poses.device)
        Hd = Hll + lam * torch.diag_embed(diag) + 1e-12 * eye
        Hd = torch.where(seen[:, None, None], Hd, eye.expand_as(Hd))
        Hinv = torch.linalg.inv(Hd)
        EH = E @ Hinv
        S_minus += EH.permute(1, 0, 2).reshape(6 * K, -1) @ \
            E.permute(1, 0, 2).reshape(6 * K, -1).T
        rhs_minus += (EH @ bl[..., None])[..., 0].sum(0)
        marg.append((E, Hinv, bl, seen))
    diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    Hd = Hcc + lam * torch.diag_embed(diag)
    S = torch.block_diag(*Hd) - S_minus
    rhs = bc.reshape(-1) - rhs_minus
    fixed = pr.fixed.repeat_interleave(6)
    S = torch.where(fixed[:, None] | fixed[None, :], torch.zeros_like(S), S)
    S = S + torch.diag(fixed.to(F64)) + 1e-12 * torch.eye(
        6 * K, dtype=F64, device=poses.device)
    rhs = torch.where(fixed, torch.zeros_like(rhs), rhs)
    dc = torch.linalg.solve(S, rhs).reshape(K, 6)
    steps = []
    for E, Hinv, bl, seen in marg:
        x = bl - (E.transpose(1, 2) @ dc.reshape(-1))
        steps.append(torch.where(seen[:, None], (Hinv @ x[..., None])[..., 0],
                                 torch.zeros_like(x)))
    return dc, steps


def solve(cam, pr: Problem, iters: int = 20, dscales=None,
          dtype=F64) -> Problem:
    """Levenberg-Marquardt from the problem's state: `iters` steps, each
    accepted where the cost at `dscales[i]` (Huber delta scale, 1 by
    default) falls. Returns the problem at the solution (the state in
    `dtype`, held as float64)."""
    rnd = (lambda x: x) if dtype == F64 else (lambda x: x.to(dtype).to(F64))
    poses, points = rnd(pr.poses.to(F64)), rnd(pr.points.to(F64))
    A = rnd(pr.A.to(F64)) if pr.lines else pr.A
    B = rnd(pr.B.to(F64)) if pr.lines else pr.B
    lam = 1e-4
    for i in range(iters):
        ds = 1.0 if dscales is None else dscales[i]
        c0 = cost(cam, pr, poses, points, A, B, ds)
        dc, steps = _step(cam, pr, poses, points, A, B, lam, ds)
        free = (~pr.fixed)[:, None, None]
        p2 = rnd(torch.where(free, se3_exp(dc) @ poses, poses))
        x2, A2, B2 = points, A, B
        if pr.move_landmarks:
            x2 = rnd(points + steps[0] * pr.pvalid[:, None])
            if pr.lines:
                u1, u2 = _perp_basis(A, B)
                A2, B2 = _line_move(A, B, u1, u2,
                                    steps[1] * pr.lvalid[:, None])
                A2, B2 = rnd(A2), rnd(B2)
        c1 = cost(cam, pr, p2, x2, A2, B2, ds)
        if bool(c1 < c0):
            poses, points, A, B = p2, x2, A2, B2
            lam = max(lam * 0.5, 1e-12)
        else:
            lam = min(lam * 5.0, 1e6)
    return replace(pr, poses=poses, points=points, A=A, B=B)


def classify(cam, pr: Problem) -> Problem:
    """The pose step's problem with its outlier observations dropped at its
    state: a point whose chi2 is over its gate, a line whose two views'
    chi2 sum over twice its gate."""
    chi2, _, d2, _ = _point_terms(cam, pr, pr.poses, pr.points, 1.0)
    out = replace(pr, pobs=pr.pobs & (chi2 <= d2))
    if pr.lines:
        chi2, _, d2 = _line_terms(cam, pr, pr.poses, pr.A, pr.B, 1.0)
        per_line = torch.zeros(pr.A.shape[0], dtype=F64,
                               device=chi2.device).index_add_(0, pr.ll, chi2)
        out = replace(out, lobs=pr.lobs & (per_line[pr.ll] <= 2.0 * d2))
    return out


def gnc(n: int) -> list[float]:
    """The local BA's delta scales (its graduated non-convexity): 64,
    halved each iteration, down to 1."""
    return [max(1.0, 64.0 * 0.5 ** i) for i in range(n)]


def pose_step(cam, pr: Problem, dtype=F64) -> Problem:
    """The joint point+line pose step's minimum: two rounds, each solved to
    convergence at delta 1 and then classified (lines at twice their
    gate), as the program's two rounds of LM are."""
    pr = classify(cam, solve(cam, pr, 20, None, dtype))
    return solve(cam, pr, 20, None, dtype)
