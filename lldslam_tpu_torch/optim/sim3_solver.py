"""Sim(3) relative pose: batched Horn closed form inside all-hypotheses
RANSAC, then Gauss-Newton refinement.

Counterpart of lldslam_tpu/optim/sim3_solver.py. Every hypothesis is solved
and scored in one batched pass ((H, N) bidirectional reprojection, chi2
9.210 both ways), then the best is taken by argmax (first index at a tie).
The hypothesis draw is split from the scoring (`draw_hypotheses`,
`score_sim3`) so the scoring can be fed any index set; the draw takes an
explicit `torch.Generator` where the JAX package splits a PRNGKey.

Scale is fixed to 1 (stereo): Horn returns s = 1 and the refinement
zeroes the scale column of its Jacobian, as the JAX package's
`fix_scale=True`, the only setting its stereo loop closer uses. The GN
solve uses `solve_ex`, which keeps its error flag on the device, so the 10
steps never wait for the host.
"""
from __future__ import annotations

import torch

from .. import tracing
from ..geometry import sim3 as gs
from ..geometry.camera import StereoCamera

CHI2_SIM3 = 9.210


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor):
    """Closed-form S12 = (R, t, s = 1) aligning P2 -> P1 (both (..., N, 3),
    N >= 3): Horn's quaternion method, top eigenvector of the 4x4 N-matrix
    built from M = sum Pr2 Pr1^T."""
    c1 = P1.mean(dim=-2)
    c2 = P2.mean(dim=-2)
    Pr1 = P1 - c1[..., None, :]
    Pr2 = P2 - c2[..., None, :]
    M = torch.einsum("...ni,...nj->...ij", Pr2, Pr1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    tracing.count("host_waits")         # eigh's error check
    q = torch.linalg.eigh(N)[1][..., -1]   # top eigenvector (w, x, y, z)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)
    s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    t = c1 - torch.einsum("...ij,...j->...i", R, c2)
    return R, t, s


def _project(cam: StereoCamera, X: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(X[..., 2], min=1e-6)
    return torch.stack([cam.fx * X[..., 0] / z + cam.cx,
                        cam.fy * X[..., 1] / z + cam.cy], -1)


def draw_hypotheses(valid: torch.Tensor, n_hyp: int, k: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, k) int64 indices drawn with replacement, uniformly over the
    valid entries (over all entries when none is valid)."""
    p = valid.to(torch.float32)
    p = torch.where(valid.any(), p, torch.ones_like(p))
    return torch.multinomial(p, n_hyp * k, replacement=True,
                             generator=generator).reshape(n_hyp, k)


def score_sim3(cam1: StereoCamera, cam2: StereoCamera, P1, P2, uv1, uv2,
               sigma2_1, sigma2_2, valid, idx):
    """Horn on each (H, 3) minimal set of `idx`, scored by bidirectional
    reprojection. Returns ((R, t, s) best, inlier mask (N,), n_inliers)."""
    R, t, s = horn_sim3(P1[idx], P2[idx])                # (H, ...)
    X1 = s[:, None, None] * torch.einsum("hij,nj->hni", R, P2) + t[:, None, :]
    err1 = torch.sum((_project(cam1, X1) - uv1[None]) ** 2, -1) \
        / sigma2_1[None]
    X2 = (1.0 / s)[:, None, None] * torch.einsum(
        "hji,hnj->hni", R, P1[None] - t[:, None, :])
    err2 = torch.sum((_project(cam2, X2) - uv2[None]) ** 2, -1) \
        / sigma2_2[None]
    inl = (err1 < CHI2_SIM3) & (err2 < CHI2_SIM3) & valid[None]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    tracing.count("host_waits", 5)      # each index by a device scalar
    return (R[best], t[best], s[best]), inl[best], scores[best]


def ransac_sim3(cam1: StereoCamera, cam2: StereoCamera, P1, P2, uv1, uv2,
                sigma2_1, sigma2_2, valid, generator: torch.Generator,
                n_hyp: int = 256):
    """All-hypotheses Sim3 RANSAC over 3-point sets. Returns ((R, t, s)
    best S12, inlier mask, n_inliers)."""
    idx = draw_hypotheses(valid, n_hyp, 3, generator)
    return score_sim3(cam1, cam2, P1, P2, uv1, uv2, sigma2_1, sigma2_2,
                      valid, idx)


def refine_sim3(cam1: StereoCamera, cam2: StereoCamera, S12, P1, P2, uv1,
                uv2, inv_sigma2_1, inv_sigma2_2, valid, iters: int = 10):
    """Bidirectional Sim3 projection refinement: Huber GN on the 7-dof
    left increment (the scale column zeroed), the Jacobian from
    one forward-mode pass with the 7 tangent directions as a batch, chi2
    9.210 inlier reclassification. Returns ((R, t, s), inliers, n)."""
    delta2 = CHI2_SIM3
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals(R, t, sc):
        """(..., 2N, 2) residuals of S = (R (..., 3, 3), t, sc (...))."""
        X1 = sc[..., None, None] * (P2 @ R.transpose(-1, -2)) + t[..., None, :]
        X2 = (1.0 / sc)[..., None, None] * ((P1 - t[..., None, :]) @ R)
        return torch.cat([(_project(cam1, X1) - uv1) * sq1,
                          (_project(cam2, X2) - uv2) * sq2], dim=-2)

    R, t, sc = S12
    sc = sc.reshape(())
    eye7 = torch.eye(7, dtype=P1.dtype, device=P1.device)
    z = torch.zeros((7, 7), dtype=P1.dtype, device=P1.device)
    w = torch.cat([valid, valid]).to(P1.dtype)
    for _ in range(iters):
        r, J = torch.func.jvp(
            lambda eps, S=(R, t, sc): residuals(*gs.compose(gs.exp(eps), S)),
            (z,), (eye7,))
        r = r[0].reshape(-1)
        J = J.reshape(7, -1).T                              # (4N, 7)
        J = torch.cat([J[:, :6], torch.zeros_like(J[:, 6:])], dim=1)
        chi2 = (r.reshape(-1, 2) ** 2).sum(-1)
        hub = torch.sqrt(torch.clamp(delta2 / torch.clamp(chi2, min=1e-12),
                                     max=1.0))
        ww = (w * hub)[:, None].expand(-1, 2).reshape(-1)
        Jw = J * ww[:, None]
        H = Jw.T @ Jw + 1e-6 * eye7
        g = -Jw.T @ (r * ww)
        dx = torch.linalg.solve_ex(H, g)[0]
        R, t, sc = gs.compose(gs.exp(dx), (R, t, sc))
    e = residuals(R, t, sc)
    c = (e ** 2).sum(-1)
    n = valid.shape[0]
    inl = valid & (c[:n] < delta2) & (c[n:] < delta2)
    return (R, t, sc), inl, inl.sum()
