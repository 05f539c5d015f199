"""Reprojection residuals and Jacobians for points and lines, and the Huber
kernel.

Counterpart of lldslam_tpu/optim/residuals.py:
- the stereo point residual (g2o's EdgeStereoSE3ProjectXYZ) with analytic
  Jacobians;
- the line endpoint residual (EdgeSE3ProjectLine: distances of the observed
  endpoints to the projected infinite line) on the minimal (q, alpha) line
  state, with analytic Jacobians. The JAX package differentiates it in
  forward mode (`jax.jacfwd`), which XLA fuses; in eager PyTorch
  `torch.func.jacfwd` of the same function cost 570 ms of a 1120-ms frame
  on the H100 (host dispatch), so the port writes the chain rule out.

Residual r = observation - prediction, camera tangent ordered (upsilon,
omega) and applied as exp(xi) * T_cw; a line tangent is three rotation
increments on q and one on alpha.
"""
from __future__ import annotations

import torch

from ..geometry import lines as glines, se3
from ..geometry.camera import StereoCamera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def point_residual_stereo(cam: StereoCamera, T_cw: torch.Tensor,
                          X: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """obs (..., 3) = (uL, v, uR). Returns residual (..., 3)."""
    Xc = se3.apply(T_cw, X)
    z = _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] / z + cam.cx
    pred = torch.stack([
        u,
        cam.fy * Xc[..., 1] / z + cam.cy,
        u - torch.full_like(z, cam.bf) / z,
    ], dim=-1)
    return obs - pred


def point_jacobians_stereo(cam: StereoCamera, T_cw: torch.Tensor,
                           X: torch.Tensor):
    """Returns (J_pose (..., 3, 6), J_point (..., 3, 3), Xc (..., 3))."""
    R = T_cw[..., :3, :3]
    Xc = se3.apply(T_cw, X)
    x, y = Xc[..., 0], Xc[..., 1]
    z = _safe_z(Xc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    zero = torch.zeros_like(x)
    dproj = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=-1),
    ], dim=-2)
    # d Xc / d xi = [I | -hat(Xc)]: J_pose = [-dproj | dproj @ hat(Xc)],
    # row i of A @ hat(v) being a_i x v
    Jw = torch.linalg.cross(dproj, Xc[..., None, :].expand_as(dproj), dim=-1)
    J_pose = torch.cat([-dproj, Jw], dim=-1)
    J_point = -(dproj @ R)
    return J_pose, J_point, Xc


def line_residual(cam: StereoCamera, T_cw, q, alpha, x1, x2):
    """Line endpoint residual (..., 2) of the minimal (q, alpha) state."""
    X0, d = glines.x0dir_from_minimal(q, alpha)
    return glines.endpoint_residual(cam, T_cw, X0, d, x1, x2)


def _cross_basis(v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) whose row j is e_j x v."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _endpoint_jacobian(cam: StereoCamera, C: torch.Tensor, dC: torch.Tensor,
                       x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., 2, n) derivative of the endpoint residual (glines.
    endpoint_residual: the distances of x1, x2 to the line through the
    projections of the camera-frame points C[..., 0, :] and C[..., 1, :])
    along n directions in which those points move by dC (..., 2, n, 3):
    the chain rule through the pinhole projection, the cross product of
    the homogeneous pixels and the normalisation, with a zero derivative
    where `project_line` and `line_eq_from_endpoints` clamp."""
    eps = glines._EPS
    z = C[..., 2]
    small = z.abs() < eps
    zs = torch.where(small, torch.full_like(z, eps), z)
    dz = torch.where(small[..., None], torch.zeros_like(dC[..., 2]),
                     dC[..., 2])
    u = cam.fx * C[..., 0] / zs + cam.cx
    v = cam.fy * C[..., 1] / zs + cam.cy
    z2 = (zs * zs)[..., None]
    du = cam.fx * (dC[..., 0] * zs[..., None] - C[..., 0, None] * dz) / z2
    dv = cam.fy * (dC[..., 1] * zs[..., None] - C[..., 1, None] * dz) / z2
    h = torch.stack([u, v, torch.ones_like(u)], -1)           # (..., 2, 3)
    dh = torch.stack([du, dv, torch.zeros_like(du)], -1)      # (..., 2, n, 3)
    h0, h1 = h[..., 0, :], h[..., 1, :]
    m = torch.linalg.cross(h0, h1, dim=-1)                    # (..., 3)
    dm = torch.linalg.cross(dh[..., 0, :, :], h1[..., None, :].expand_as(
        dh[..., 0, :, :]), dim=-1) + torch.linalg.cross(
        h0[..., None, :].expand_as(dh[..., 1, :, :]), dh[..., 1, :, :],
        dim=-1)                                               # (..., n, 3)
    nrm = torch.linalg.norm(m[..., :2], dim=-1)
    nc = torch.clamp(nrm, min=eps)
    dn = torch.where((nrm > eps)[..., None],
                     (m[..., None, 0] * dm[..., 0]
                      + m[..., None, 1] * dm[..., 1]) / nc[..., None],
                     torch.zeros_like(dm[..., 0]))            # (..., n)
    dl = dm / nc[..., None, None] \
        - m[..., None, :] * (dn / (nc * nc)[..., None])[..., None]
    dr = [dl[..., 0] * x[..., None, 0] + dl[..., 1] * x[..., None, 1]
          + dl[..., 2] for x in (x1, x2)]
    return torch.stack(dr, dim=-2)


def _line_camera_points(T_cw, X0, d, baseline: float):
    """The line's two points X0 and X0 + d in the camera `baseline` to the
    right of T_cw (C, (..., 2, 3)), and their derivatives (..., 2, 6, 3)
    along the pose increment exp(xi) T_cw (xi = (upsilon, omega))."""
    Cl = torch.stack([se3.apply(T_cw, X0), se3.apply(T_cw, X0 + d)], -2)
    eye = torch.eye(3, dtype=Cl.dtype, device=Cl.device)
    dC = torch.cat([eye.expand(Cl.shape[:-1] + (3, 3)), _cross_basis(Cl)],
                   dim=-2)
    if baseline:
        Cl = Cl - torch.stack([torch.full_like(Cl[..., 0], baseline),
                               torch.zeros_like(Cl[..., 0]),
                               torch.zeros_like(Cl[..., 0])], -1)
    return Cl, dC


def line_pose_jacobian(cam: StereoCamera, T_cw, X0, d, x1, x2,
                       baseline: float = 0.0) -> torch.Tensor:
    """(..., 2, 6) Jacobian of the endpoint residual of the world line
    (X0, d) seen from the camera `baseline` to the right of T_cw (the right
    view of a stereo pair: T_rl T_cw), w.r.t. the pose increment xi of
    exp(xi) T_cw."""
    C, dC = _line_camera_points(T_cw, X0, d, baseline)
    return _endpoint_jacobian(cam, C, dC, x1, x2)


def line_jacobians(cam: StereoCamera, T_cw, q, alpha, x1, x2,
                   baseline: float = 0.0):
    """Jacobians of the line residual of the minimal state (q, alpha), seen
    from the camera `baseline` to the right of T_cw, w.r.t. the pose
    increment of exp(xi) T_cw (..., 2, 6) and the line increment (..., 2,
    4): three rotation increments w of q' = quat(w) q (dR = [w]x R, so
    d' = d + w x d and X0' = X0 + alpha w x n, n = R[:, 1]) and one on
    alpha."""
    R = se3.mat_from_quat(q)
    d, n = R[..., :, 0], R[..., :, 1]
    X0 = alpha[..., None] * n
    C, dC = _line_camera_points(T_cw, X0, d, baseline)
    Jp = _endpoint_jacobian(cam, C, dC, x1, x2)
    dX0 = torch.cat([alpha[..., None, None] * _cross_basis(n),
                     n[..., None, :]], dim=-2)                 # (..., 4, 3)
    dd = torch.cat([_cross_basis(d), torch.zeros_like(n[..., None, :])],
                   dim=-2)
    dP = torch.stack([dX0, dX0 + dd], dim=-3)                  # (..., 2, 4, 3)
    Rcw = T_cw[..., None, None, :3, :3]
    Jl = _endpoint_jacobian(cam, C, (Rcw @ dP[..., None])[..., 0], x1, x2)
    return Jp, Jl


def _quat_increment(w: torch.Tensor) -> torch.Tensor:
    """Small-rotation quaternion: [1, w/2] normalized."""
    q = torch.cat([torch.ones_like(w[..., :1]), 0.5 * w], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def huber_weight(chi2: torch.Tensor, delta_sq) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside.
    `delta_sq` is a tensor or a Python number (never copied to the device:
    that copy would wait for the host)."""
    return torch.where(chi2 <= delta_sq, torch.ones_like(chi2),
                       torch.sqrt(delta_sq / torch.clamp(chi2, min=1e-12)))


def huber_rho(chi2: torch.Tensor, delta_sq) -> torch.Tensor:
    """Huber robust cost: quadratic inside delta, linear in |e| outside."""
    return torch.where(chi2 <= delta_sq, chi2,
                       2.0 * torch.sqrt(delta_sq * torch.clamp(chi2, min=0.0))
                       - delta_sq)
