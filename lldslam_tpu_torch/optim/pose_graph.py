"""Sim(3) pose-graph (essential graph) optimization.

Counterpart of lldslam_tpu/optim/pose_graph.py: vertices are keyframe Sim3
poses S_iw, edges relative measurements M_ij with residual
r = log(M_ij^-1 S_i S_j^-1). Per-edge 7x7 Jacobians come from one
forward-mode pass over the whole edge batch (`torch.func.jvp`, the 14
tangent directions as a leading batch dimension), are summed into
(K, 7, 7) blocks in a fixed order (`ops/segment_sum.segment_sum_`: the
card gives the same bits every run), and each Levenberg-Marquardt step is
solved by block-Jacobi preconditioned CG. The accept/reject test and the
damping update stay on the device (`torch.where` over the state) and the
small inverses and solves use the `_ex` variants, which leave their error
flags on the device, so the 15 iterations never wait for the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3
from ..ops.segment_sum import segment_layout, segment_sum_


class PoseGraph(NamedTuple):
    R: torch.Tensor        # (K, 3, 3)
    t: torch.Tensor        # (K, 3)
    s: torch.Tensor        # (K,)
    fixed: torch.Tensor    # (K,) bool
    e_i: torch.Tensor      # (E,) int64
    e_j: torch.Tensor      # (E,) int64
    m_R: torch.Tensor      # (E, 3, 3) measurement M_ij = S_i S_j^-1
    m_t: torch.Tensor      # (E, 3)
    m_s: torch.Tensor      # (E,)
    e_valid: torch.Tensor  # (E,) bool


def edge_residual(Si, Sj, M):
    """r = log(M^-1 * S_i * S_j^-1) in R^7."""
    rel = sim3.compose(Si, sim3.inv(Sj))
    return sim3.log(sim3.compose(sim3.inv(M), rel))


def _res(eps_i, eps_j, Ri, ti, si, Rj, tj, sj, mR, mt, ms):
    return edge_residual(sim3.compose(sim3.exp(eps_i), (Ri, ti, si)),
                         sim3.compose(sim3.exp(eps_j), (Rj, tj, sj)),
                         (mR, mt, ms))


def _edge_terms(g: PoseGraph):
    """Residuals (E, 7) and Jacobians (E, 7, 7) wrt both endpoints."""
    ei, ej = g.e_i.long(), g.e_j.long()
    args = (g.R[ei], g.t[ei], g.s[ei], g.R[ej], g.t[ej], g.s[ej],
            g.m_R, g.m_t, g.m_s)
    E = ei.shape[0]
    z = torch.zeros((14, E, 7), dtype=g.t.dtype, device=g.t.device)
    # one forward-mode pass: the 14 tangent directions (7 per endpoint)
    # ride a leading batch dimension of the edge computation
    d = torch.eye(14, dtype=z.dtype, device=z.device)[:, None, :] \
        .expand(14, E, 14)
    r, J = torch.func.jvp(lambda a, b: _res(a, b, *args), (z, z),
                          (d[..., :7], d[..., 7:]))
    w = g.e_valid.to(r.dtype)
    J = J.permute(1, 2, 0)                 # (E, residual, direction)
    return (r[0] * w[:, None], J[..., :7] * w[:, None, None],
            J[..., 7:] * w[:, None, None])


def optimize_pose_graph(g: PoseGraph, iters: int = 15,
                        cg_iters: int = 48) -> PoseGraph:
    """Returns the optimized PoseGraph (same edges, updated vertices)."""
    K = g.R.shape[0]
    dt, dev = g.t.dtype, g.t.device
    ei, ej = g.e_i.long(), g.e_j.long()
    # both endpoints' terms in one segment sum: the rows of e_i, then those
    # of e_j, which is the add order of one scatter over e_i and then one
    # over e_j
    lay = segment_layout(torch.cat([ei, ej]), K)
    free = (~g.fixed).to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    lam = torch.full((), 1e-6, dtype=dt, device=dev)
    r, Ji, Jj = _edge_terms(g)
    for _ in range(iters):
        err_old = torch.sum(r * r)
        H = segment_sum_(
            torch.zeros((K, 7, 7), dtype=dt, device=dev), lay,
            torch.cat([torch.einsum("eri,erj->eij", Ji, Ji),
                       torch.einsum("eri,erj->eij", Jj, Jj)]))
        b = segment_sum_(
            torch.zeros((K, 7), dtype=dt, device=dev), lay,
            torch.cat([-torch.einsum("eri,er->ei", Ji, r),
                       -torch.einsum("eri,er->ei", Jj, r)]))
        # adaptive LM damping (a fixed tiny damping lets CG amplify the
        # chain's low-stiffness bending modes in float32)
        H = H + lam * eye7[None]
        b = b * free[:, None]

        db = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                    min=1e-12))
        scale = db[:, :, None] * db[:, None, :]
        Minv = torch.linalg.inv_ex(H / scale + 1e-8 * eye7[None])[0] / scale
        Hij = torch.einsum("eri,erj->eij", Ji, Jj)

        def matvec(v):
            v = v * free[:, None]
            y = torch.einsum("kij,kj->ki", H, v)
            y = segment_sum_(y, lay, torch.cat([
                torch.einsum("eij,ej->ei", Hij, v[ej]),
                torch.einsum("eji,ej->ei", Hij, v[ei])]))
            return y * free[:, None]

        def precond(x):
            return torch.einsum("kij,kj->ki", Minv, x) * free[:, None]

        x = torch.zeros_like(b)
        rr = b
        zz = precond(rr)
        p = zz
        rz = torch.sum(rr * zz)
        for _ in range(cg_iters):
            Ap = matvec(p)
            denom = torch.sum(p * Ap)
            alpha = rz / torch.where(denom.abs() < 1e-12,
                                     torch.full_like(denom, 1e-12), denom)
            x = x + alpha * p
            rr = rr - alpha * Ap
            zz = precond(rr)
            rz_new = torch.sum(rr * zz)
            beta = rz_new / torch.where(rz.abs() < 1e-12,
                                        torch.full_like(rz, 1e-12), rz)
            p = zz + beta * p
            rz = rz_new
        dx = x * free[:, None]
        Rn, tn, sn = sim3.compose(sim3.exp(dx), (g.R, g.t, g.s))
        cand = g._replace(R=Rn, t=tn, s=sn)
        r_c, Ji_c, Jj_c = _edge_terms(cand)
        accept = torch.sum(r_c * r_c) < err_old
        g = g._replace(R=torch.where(accept, Rn, g.R),
                       t=torch.where(accept, tn, g.t),
                       s=torch.where(accept, sn, g.s))
        r = torch.where(accept, r_c, r)
        Ji = torch.where(accept, Ji_c, Ji)
        Jj = torch.where(accept, Jj_c, Jj)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0),
                          1e-8, 1e4)
    return g


def total_error(g: PoseGraph) -> torch.Tensor:
    r, _, _ = _edge_terms(g)
    return torch.sum(r * r)
