"""Batched 3D/2D line geometry on tensors.

Counterpart of the functions of lldslam_tpu/geometry/lines.py that the
stereo point+line path runs, same conventions:

- a 3D line is the "x0dir" pair `(X0, d)`: `d` the unit direction, `X0` the
  point of the line closest to the origin (`X0 . d == 0`);
- its minimal 4-DoF state is a unit quaternion `q` (wxyz) of the rotation
  with columns `[d, X0/|X0|, d x X0/|X0|]` plus the scalar `alpha = |X0|`;
- a 2D line is a homogeneous `l = (a, b, c)` with a^2 + b^2 = 1, so the
  signed distance of a pixel is `l . (u, v, 1)`.

Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

from . import se3
from .camera import StereoCamera

_EPS = 1e-9


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _safe(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """x with |x| < eps replaced by eps."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


# ---------------------------------------------------------------------------
# 2D line equations


def line_eq_from_endpoints(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Endpoints (..., 2) x2 -> normalized line eq (..., 3), a^2+b^2 = 1."""
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    l = _cross(h1, h2)
    n = torch.linalg.norm(l[..., :2], dim=-1, keepdim=True)
    return l / torch.clamp(n, min=_EPS)


def point_line_distance(l: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Signed distance of pixel p (..., 2) to normalized line l (..., 3)."""
    return l[..., 0] * p[..., 0] + l[..., 1] * p[..., 1] + l[..., 2]


# ---------------------------------------------------------------------------
# 3D line codecs


def closest_point_form(P: torch.Tensor, d: torch.Tensor):
    """Any point P on the line + direction d -> (X0 perp d, unit d)."""
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=_EPS)
    X0 = P - torch.sum(P * d, dim=-1, keepdim=True) * d
    return X0, d


def minimal_from_x0dir(X0: torch.Tensor, d: torch.Tensor):
    """(X0, d) -> (q wxyz, alpha)."""
    alpha = torch.linalg.norm(X0, dim=-1)
    n = X0 / torch.clamp(alpha[..., None], min=_EPS)
    b = _cross(d, n)
    R = torch.stack([d, n, b], dim=-1)      # columns
    return se3.quat_from_mat(R), alpha


def x0dir_from_minimal(q: torch.Tensor, alpha: torch.Tensor):
    """(q, alpha) -> (X0, d)."""
    R = se3.mat_from_quat(q)
    return alpha[..., None] * R[..., :, 1], R[..., :, 0]


def transform_line(T: torch.Tensor, X0: torch.Tensor, d: torch.Tensor):
    """Rigidly transform an x0dir line by T (..., 4, 4), re-canonicalized."""
    P = se3.apply(T, X0)
    dn = (T[..., :3, :3] @ d[..., None])[..., 0]
    return closest_point_form(P, dn)


# ---------------------------------------------------------------------------
# projection and residuals


def project_line(cam: StereoCamera, T_cw: torch.Tensor, X0: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    """World x0dir line -> normalized image line eq (..., 3): two points of
    the line projected and joined."""
    def px(X):
        z = _safe(X[..., 2])
        return torch.stack([cam.fx * X[..., 0] / z + cam.cx,
                            cam.fy * X[..., 1] / z + cam.cy], dim=-1)
    return line_eq_from_endpoints(px(se3.apply(T_cw, X0)),
                                  px(se3.apply(T_cw, X0 + d)))


def endpoint_residual(cam: StereoCamera, T_cw: torch.Tensor, X0: torch.Tensor,
                      d: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """(..., 2): signed distances of the observed endpoints x1, x2 to the
    projected infinite line."""
    l = project_line(cam, T_cw, X0, d)
    return torch.stack([point_line_distance(l, x1),
                        point_line_distance(l, x2)], dim=-1)


def right_camera_pose(T_cw: torch.Tensor, baseline: float) -> torch.Tensor:
    """Left-camera pose -> right-camera pose T_rl @ T_cw, T_rl = (I, (-b,0,0)):
    row 0 minus b times row 3 (no tensor is written element-wise, which
    would copy the scalar from the host and wait for the card)."""
    row0 = T_cw[..., 0, :] - baseline * T_cw[..., 3, :]
    return torch.cat([row0[..., None, :], T_cw[..., 1:, :]], dim=-2)


# ---------------------------------------------------------------------------
# triangulation


def plane_normal_from_obs(cam: StereoCamera, T_cw: torch.Tensor,
                          p1: torch.Tensor, p2: torch.Tensor):
    """Image segment (pixels) + pose -> (world plane normal, camera centre)
    of the plane through the camera centre and the two pixel rays."""
    l = line_eq_from_endpoints(p1, p2)
    n_c = torch.stack([cam.fx * l[..., 0], cam.fy * l[..., 1],
                       cam.cx * l[..., 0] + cam.cy * l[..., 1] + l[..., 2]],
                      dim=-1)
    T_wc = se3.inv(T_cw)
    return (T_wc[..., :3, :3] @ n_c[..., None])[..., 0], T_wc[..., :3, 3]


def triangulate_multi_view(normals: torch.Tensor, centers: torch.Tensor,
                           mask: torch.Tensor):
    """Line through the planes n_i . X = n_i . c_i (normals, centers
    (..., N, 3), mask (..., N) bool): the null space of the masked stack
    [n_i | -n_i . c_i] from the two smallest eigenvectors of its 4x4 Gram
    matrix. Returns (X0, d, ok)."""
    rhs = torch.sum(normals * centers, dim=-1, keepdim=True)
    A = torch.cat([normals, -rhs], dim=-1) * mask[..., None]
    M = torch.einsum("...ni,...nj->...ij", A, A)
    v = torch.linalg.eigh(M)[1]               # ascending eigenvalues
    h1, h2 = v[..., :, 0], v[..., :, 1]
    use1 = h1[..., 3].abs() >= h2[..., 3].abs()
    hp = torch.where(use1[..., None], h1, h2)
    hq = torch.where(use1[..., None], h2, h1)
    wp = hp[..., 3]
    wp_safe = _safe(wp)
    P = hp[..., :3] / wp_safe[..., None]
    # direction: the combination of the two with a zero homogeneous part
    dvec = hq[..., :3] - (hq[..., 3] / wp_safe)[..., None] * hp[..., :3]
    ok = (mask.sum(dim=-1) >= 2) \
        & (torch.linalg.norm(dvec, dim=-1) > _EPS) & (wp.abs() > _EPS)
    X0, d = closest_point_form(P, dvec)
    return X0, d, ok
