"""Monocular map initialization: H/F RANSAC, model selection and
reconstruction.

Counterpart of lldslam_tpu/optim/initializer.py. Every homography (4-point
DLT) and fundamental (8-point DLT, Hartley-normalized once over all valid
matches) hypothesis is solved and scored in one batched pass (symmetric
transfer or point-to-epiline errors of all N matches, chi2 5.991 / 3.841,
the reference's score sum_inliers (5.991 - err / sigma^2) both ways), the
best of each is refit on its inliers by least squares, and the homography
wins when SH / (SH + SF) > 0.40. Reconstruction triangulates every match
under each pose candidate (4 from F through E = K^T F K, 8 from the
Faugeras decomposition of H) and keeps the candidate with the most points
in front of both cameras, with parallax and under 2 px reprojection error.

Determinants and the inverse of K are written out: on an H100 the first
`torch.linalg.det` of a process spends 0.1-0.9 s setting up its solver,
which would stall the bootstrap frame.

The hypothesis draw is split from the scoring, as in optim/sim3_solver.py:
`draw_hypotheses` takes an explicit `torch.Generator` where the JAX package
splits a PRNGKey, and `ransac_models` / `initialize` score any index sets
they are given. SVD null vectors have a free sign, and a pose candidate
list may come out of the SVD in another order; the chosen pose is the same.
"""
from __future__ import annotations

import torch

from ..geometry.camera import StereoCamera
from . import sim3_solver

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991


def _K(cam: StereoCamera, device, inverse: bool = False) -> torch.Tensor:
    """The intrinsic matrix, or its inverse."""
    if inverse:
        rows = [[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
                [0.0, 1.0 / cam.fy, -cam.cy / cam.fy], [0.0, 0.0, 1.0]]
    else:
        rows = [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) as the triple product of its rows."""
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :])) \
        .sum(-1)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., m, 9) -> (..., 3, 3): the right singular vector of the least
    singular value."""
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)[2][..., -1, :] \
        .reshape(*A.shape[:-2], 3, 3)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s[..., None, :]) @ Vt


def _normalize(x: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization over the valid points: (xn (N, 2), T (3, 3))."""
    w = valid.to(x.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (x * w[:, None]).sum(0) / n
    dev = ((x - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    xn = (x - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return xn, T


def _h_rows(x1, x2):
    """The two DLT rows of each correspondence, (..., n, 2, 9)."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    return torch.stack([r1, r2], dim=-2)


def _f_rows(x1, x2):
    """The epipolar constraint row of each correspondence, (..., n, 9)."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                        torch.ones_like(x)], -1)


def _dlt_h(x1, x2):
    """4-point homography DLT, batched: x1, x2 (..., 4, 2) -> H (..., 3, 3)
    with x2 ~ H x1."""
    return _null_vector(_h_rows(x1, x2).flatten(-3, -2))


def _dlt_f(x1, x2):
    """8-point fundamental DLT, batched: (..., 8, 2) -> rank-2 F with
    x2^T F x1 = 0."""
    return _rank2(_null_vector(_f_rows(x1, x2)))


def _h_transfer_err(H, x1, x2):
    """Symmetric transfer errors of H (..., 3, 3) on all matches: (e12, e21)
    each (..., N)."""
    def err(H, a, b):
        ah = torch.cat([a, torch.ones_like(a[:, :1])], -1)
        p = ah @ H.transpose(-1, -2)
        pz = p[..., 2:]
        p = p[..., :2] / torch.where(pz.abs() < 1e-9, 1e-9, pz)
        return ((p - b) ** 2).sum(-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv_ex(H + 1e-12 * eye)[0]
    return err(H, x1, x2), err(Hinv, x2, x1)


def _f_epi_err(F, x1, x2):
    """Point-to-epiline squared distances of F (..., 3, 3) both ways:
    (d1, d2) each (..., N)."""
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    h2 = torch.cat([x2, torch.ones_like(x2[:, :1])], -1)
    l2 = h1 @ F.transpose(-1, -2)
    l1 = h2 @ F
    d2 = (h2 * l2).sum(-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = (h1 * l1).sum(-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1, d2


def _score(e1, e2, chi2, valid, s2):
    """(inlier mask, reference score) of errors (..., N) at gate chi2."""
    a, b = e1 / s2, e2 / s2
    zero = torch.zeros_like(a)
    sc = (torch.where(a < chi2, SCORE_TH - a, zero)
          + torch.where(b < chi2, SCORE_TH - b, zero))
    return (a < chi2) & (b < chi2) & valid, (sc * valid).sum(-1)


def _refit_f(x1n, x2n, w):
    """All-inlier 8-point refit on normalized coordinates, w (N,) bool."""
    return _rank2(_null_vector(_f_rows(x1n, x2n) * w[:, None]))


def _refit_h(x1, x2, w):
    """All-inlier homography DLT, w (N,) bool."""
    rows = _h_rows(x1, x2) * w[:, None, None]
    return _null_vector(torch.cat([rows[:, 0], rows[:, 1]]))


def draw_hypotheses(valid: torch.Tensor, generator: torch.Generator,
                    n_hyp: int = 256):
    """(idx_h (n_hyp, 4), idx_f (n_hyp, 8)) int64, drawn with replacement
    uniformly over the valid matches."""
    return (sim3_solver.draw_hypotheses(valid, n_hyp, 4, generator),
            sim3_solver.draw_hypotheses(valid, n_hyp, 8, generator))


def ransac_models(x1, x2, valid, idx_h, idx_f, sigma: float = 1.0):
    """Both model RANSACs on the given minimal sets; x1, x2 (N, 2) float32
    pixels, valid (N,) bool. Returns (H, score_h, inl_h, F, score_f,
    inl_f): each model refit on its best hypothesis's inliers, its score
    that hypothesis's, its inliers the refit's."""
    s2 = sigma * sigma
    Hs = _dlt_h(x1[idx_h], x2[idx_h])                      # (n_hyp, 3, 3)
    in_h, sc_h = _score(*_h_transfer_err(Hs, x1, x2), CHI2_H, valid[None], s2)
    bh = torch.argmax(sc_h)
    x1n, T1 = _normalize(x1, valid)
    x2n, T2 = _normalize(x2, valid)
    Fs = T2.T @ _dlt_f(x1n[idx_f], x2n[idx_f]) @ T1
    in_f, sc_f = _score(*_f_epi_err(Fs, x1, x2), CHI2_F, valid[None], s2)
    bf = torch.argmax(sc_f)
    # the minimal 8-point estimate is too noisy for reconstruction's 2 px
    # reprojection gate: refit on the winners' inlier sets
    F_ref = T2.T @ _refit_f(x1n, x2n, in_f[bf]) @ T1
    H_ref = _refit_h(x1, x2, in_h[bh])
    in_fr, _ = _score(*_f_epi_err(F_ref, x1, x2), CHI2_F, valid, s2)
    in_hr, _ = _score(*_h_transfer_err(H_ref, x1, x2), CHI2_H, valid, s2)
    return H_ref, sc_h[bh], in_hr, F_ref, sc_f[bf], in_fr


def _triangulate_all(R, t, K, x1, x2):
    """Linear triangulation of every match under each pose (R (C, 3, 3),
    t (C, 3)) of camera 2 with camera 1 at identity: X (C, N, 3) in camera
    1's frame."""
    C, N = R.shape[0], x1.shape[0]
    P1 = K @ torch.eye(3, 4, dtype=K.dtype, device=K.device)
    P2 = K @ torch.cat([R, t[..., None]], -1)               # (C, 3, 4)
    P1 = P1.expand(C, 3, 4)
    a, b = x1[None], x2[None]                               # (1, N, 2)
    A = torch.stack([
        a[..., 0:1] * P1[:, None, 2] - P1[:, None, 0],
        a[..., 1:2] * P1[:, None, 2] - P1[:, None, 1],
        b[..., 0:1] * P2[:, None, 2] - P2[:, None, 0],
        b[..., 1:2] * P2[:, None, 2] - P2[:, None, 1]], dim=-2)  # (C,N,4,4)
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() < 1e-12, 1e-12, w)


def _check_rt(R, t, K, x1, x2, inl, sigma2: float):
    """Cheirality, parallax and reprojection test of each candidate pose
    (R (C, 3, 3), t (C, 3)): (n_good (C,), X (C, N, 3), good (C, N))."""
    X = _triangulate_all(R, t, K, x1, x2)
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]      # (C, 3)
    r1 = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-9)
    D = X - c2[:, None, :]
    r2 = D / torch.clamp(torch.linalg.norm(D, dim=-1, keepdim=True), min=1e-9)
    cospar = (r1 * r2).sum(-1)

    def reproj(P, obs):
        z = torch.clamp(P[..., 2], min=1e-9)
        u = K[0, 0] * P[..., 0] / z + K[0, 2]
        v = K[1, 1] * P[..., 1] / z + K[1, 2]
        return (u - obs[:, 0]) ** 2 + (v - obs[:, 1]) ** 2
    good = (inl & (X[..., 2] > 0) & (Xc2[..., 2] > 0) & (cospar < 0.99998)
            & (reproj(X, x1) < 4.0 * sigma2)
            & (reproj(Xc2, x2) < 4.0 * sigma2))
    return good.sum(-1), X, good


def _select(R, t, K, x1, x2, inl):
    """The candidate with the most good points; accepted when it explains
    most inliers with a clear margin over the runner-up and >= 50 points.
    Returns (ok, R, t, X (N, 3), good (N,))."""
    counts, X, good = _check_rt(R, t, K, x1, x2, inl, 1.0)
    best = torch.argmax(counts)
    n_best = counts[best]
    n_second = torch.sort(counts).values[-2]
    n_inl = torch.clamp(inl.sum(), min=1)
    ok = (n_best > 0.7 * n_inl) & (n_second < 0.75 * n_best) & (n_best >= 50)
    return ok, R[best], t[best], X[best], good[best]


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def reconstruct_f(cam: StereoCamera, F, x1, x2, inl):
    """E = K^T F K -> the 4 (R, t) candidates -> the best by cheirality.
    Returns (ok, R, t, X (N, 3), good (N,))."""
    K = _K(cam, F.device)
    U, _, Vt = torch.linalg.svd(K.T @ F @ K)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(_det3(R1))
    R2 = R2 * torch.sign(_det3(R2))
    t = _unit(U[:, 2])
    R = torch.stack([R1, R1, R2, R2])
    return _select(R, torch.stack([t, -t, t, -t]), K, x1, x2, inl)


def reconstruct_h(cam: StereoCamera, H, x1, x2, inl):
    """Faugeras SVD decomposition of a homography into 8 motion hypotheses,
    scored as reconstruct_f. Returns (ok, R, t, X (N, 3), good (N,))."""
    K = _K(cam, H.device)
    U, w, Vt = torch.linalg.svd(_K(cam, H.device, inverse=True) @ H @ K)
    s = _det3(U) * _det3(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                  / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3)
                                  / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    aux_st = root / ((d1 + d3) * d2 + 1e-12)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    aux_sp = root / ((d1 - d3) * d2 + 1e-12)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + 1e-12)
    z, o = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    for e1 in (1.0, -1.0):             # d' > 0
        for e3 in (1.0, -1.0):
            Rs.append(torch.stack([
                torch.stack([ctheta, z, -e1 * e3 * aux_st]),
                torch.stack([z, o, z]),
                torch.stack([e1 * e3 * aux_st, z, ctheta])]))
            ts.append((d1 - d3) * torch.stack([e1 * aux1, z, -e3 * aux3]))
    for e1 in (1.0, -1.0):             # d' < 0
        for e3 in (1.0, -1.0):
            Rs.append(torch.stack([
                torch.stack([cphi, z, e1 * e3 * aux_sp]),
                torch.stack([z, -o, z]),
                torch.stack([e1 * e3 * aux_sp, z, -cphi])]))
            ts.append((d1 + d3) * torch.stack([e1 * aux1, z, e3 * aux3]))
    R = s * U @ torch.stack(Rs) @ Vt
    t = _unit(torch.stack(ts) @ U.T)
    return _select(R, t, K, x1, x2, inl)


def initialize(cam: StereoCamera, x1, x2, valid, idx_h, idx_f):
    """The monocular bootstrap on the given hypothesis sets (see
    `draw_hypotheses`): both RANSACs, the homography when SH / (SH + SF) >
    0.40, else the fundamental, then its reconstruction. Returns (ok,
    R (3, 3), t (3,), X (N, 3), good (N,)) as numpy."""
    H, sh, inh, F, sf, inf_ = ransac_models(x1, x2, valid, idx_h, idx_f)
    sh, sf = float(sh), float(sf)
    if sh / max(sh + sf, 1e-9) > 0.40:
        out = reconstruct_h(cam, H, x1, x2, inh)
    else:
        out = reconstruct_f(cam, F, x1, x2, inf_)
    ok, R, t, X, good = (x.cpu().numpy() for x in out)
    return bool(ok), R, t, X, good
