"""Batched 3D/2D line geometry on tensors.

Counterpart of lldslam_tpu/geometry/lines.py, same conventions (the JAX
package's packed multi-view triangulation of its pipelined path is not
here):

- a 3D line is the "x0dir" pair `(X0, d)`: `d` the unit direction, `X0` the
  point of the line closest to the origin (`X0 . d == 0`);
- its minimal 4-DoF state is a unit quaternion `q` (wxyz) of the rotation
  with columns `[d, X0/|X0|, d x X0/|X0|]` plus the scalar `alpha = |X0|`;
- a 2D line is a homogeneous `l = (a, b, c)` with a^2 + b^2 = 1, so the
  signed distance of a pixel is `l . (u, v, 1)`.

Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import math

import torch

from . import se3
from .camera import StereoCamera

# Hough grid dimensions (Frame.h:45-46 FRAME_DIST_CELLS / FRAME_ANG_CELLS)
DIST_CELLS = 50
ANG_CELLS = 50

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


def hough_coords(p1: torch.Tensor, p2: torch.Tensor, diag: float):
    """2D segment -> (dist_cell, ang_cell) int32 on the 50x50 grid: the line
    equation's distance from the origin and angle, binned uniformly over
    [0, diag) x [0, pi)."""
    l = line_eq_from_endpoints(p1, p2)
    # canonical sign: c <= 0, so the distance -c >= 0
    l = l * torch.where(l[..., 2:3] > 0, -1.0, 1.0)
    dist = -l[..., 2]
    ang = torch.atan2(l[..., 1], l[..., 0])
    ang = torch.where(ang < 0, ang + math.pi, ang)
    ang = torch.where(ang >= math.pi, ang - math.pi, ang)
    di = torch.clamp((dist / diag * DIST_CELLS).to(torch.int32), 0,
                     DIST_CELLS - 1)
    ai = torch.clamp((ang / math.pi * ANG_CELLS).to(torch.int32), 0,
                     ANG_CELLS - 1)
    return di, ai


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


def plucker_from_x0dir(X0: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(X0, d) -> Pluecker (..., 6) [m, d] with moment m = X0 x d."""
    return torch.cat([_cross(X0, d), d], dim=-1)


def x0dir_from_plucker(L: torch.Tensor):
    """Pluecker [m, d] -> (X0, d): X0 = d x m / |d|^2, d normalized."""
    m, d = L[..., :3], L[..., 3:]
    nd = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=_EPS)
    return _cross(d, m) / nd, d / torch.sqrt(nd)


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


def _ray(cam: StereoCamera, px: torch.Tensor) -> torch.Tensor:
    """The camera-frame ray K^-1 (u, v, 1) of pixels (..., 2)."""
    return torch.stack([(px[..., 0] - cam.cx) / cam.fx,
                        (px[..., 1] - cam.cy) / cam.fy,
                        torch.ones_like(px[..., 0])], dim=-1)


def line_depths(T_cw: torch.Tensor, X0: torch.Tensor, d: torch.Tensor,
                cam: StereoCamera, x1: torch.Tensor, x2: torch.Tensor):
    """Depths along the rays of the observed endpoint pixels x1, x2 of the
    points of the line closest to them: the 2x2 normal equations of
    min |Xc0 + s dc - t r| in (s, t)."""
    Xc0, dc = transform_line(T_cw, X0, d)

    def depth_at(px):
        r = _ray(cam, px)
        a11 = torch.sum(dc * dc, dim=-1)
        a12 = -torch.sum(dc * r, dim=-1)
        a22 = torch.sum(r * r, dim=-1)
        b1 = -torch.sum(dc * Xc0, dim=-1)
        b2 = torch.sum(r * Xc0, dim=-1)
        det = _safe(a11 * a22 - a12 * a12)
        return (a11 * b2 - a12 * b1) / det   # r_z = 1: t is the depth
    return depth_at(x1), depth_at(x2)


# ---------------------------------------------------------------------------
# triangulation


def triangulate_two_view(n1: torch.Tensor, c1: torch.Tensor,
                         n2: torch.Tensor, c2: torch.Tensor,
                         parallel_thresh: float = 0.975):
    """Two back-projected planes (world normal n_i through camera centre
    c_i) -> world x0dir line: d = n1 x n2, X0 from the two plane equations
    and d . X = 0; planes closer to parallel than `parallel_thresh` (cosine)
    are degenerate. Returns (X0, d, ok)."""
    n1u = n1 / torch.clamp(torch.linalg.norm(n1, dim=-1, keepdim=True),
                           min=_EPS)
    n2u = n2 / torch.clamp(torch.linalg.norm(n2, dim=-1, keepdim=True),
                           min=_EPS)
    cosang = torch.sum(n1u * n2u, dim=-1).abs()
    ok = cosang < parallel_thresh
    d = _cross(n1u, n2u)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=_EPS)
    A = torch.stack([n1u, n2u, d], dim=-2)
    b = torch.stack([torch.sum(n1u * c1, dim=-1), torch.sum(n2u * c2, dim=-1),
                     torch.zeros_like(cosang)], dim=-1)
    # regularize the (near-)singular case so the solve stays finite
    reg = torch.where(ok, 0.0, 1e-3)[..., None, None] \
        * torch.eye(3, dtype=A.dtype, device=A.device)
    X0 = torch.linalg.solve_ex(A + reg, b[..., None])[0][..., 0]
    X0, d = closest_point_form(X0, d)
    return X0, d, ok


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


def endpoints_3d(X0: torch.Tensor, d: torch.Tensor, T_cw: torch.Tensor,
                 cam: StereoCamera, x1: torch.Tensor, x2: torch.Tensor):
    """World 3D endpoints of a line from the rays of its observed 2D
    endpoints in one view: the point of each ray at `line_depths`, snapped
    onto the line."""
    t1, t2 = line_depths(T_cw, X0, d, cam, x1, x2)
    Xc0, dc = transform_line(T_cw, X0, d)
    T_wc = se3.inv(T_cw)

    def lift(px, t):
        Xr = t[..., None] * _ray(cam, px)
        s = torch.sum((Xr - Xc0) * dc, dim=-1, keepdim=True)
        return se3.apply(T_wc, Xc0 + s * dc)
    return lift(x1, t1), lift(x2, t2)
