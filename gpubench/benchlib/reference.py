"""The plain reference that decides `correct`: plain torch and numpy.

It imports nothing of the program. It works out again, from the raw stereo
frames that the benchmark rendered, what the program's frame build derives
from them (the integer pyramid, the rounded 7x7 blur), and judges the
program's outputs against that:

- K1a (`describe`): the intensity-centroid angle and rotated BRIEF-256 of
  every keypoint the program detected, from the reference's own pyramid;
- K1b (`sad_refine`): the 11x11 SAD sweep over +-5 disparities and the
  parabola at every keypoint and right-view column the program chose;
- K2g (`gated_best2`): the gated Hamming best-2 over the rows and columns
  of a call, from the call's own inputs (the program's projections and
  descriptors; a step followed from the program's state);
- the trajectory against the generator's true poses, and the stereo line
  matches against the generator's world segments.

The arithmetic is ORB-SLAM2's as the program states it (the pyramid's
bilinear resize and the blur with the fused multiply-adds of XLA's float32
evaluation, emulated in float64), so a sound program agrees bit for bit.
`dtype` runs the same reference in a lower precision: the control.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PATTERN = Path(__file__).resolve().parent.parent / "data" / "orb_pattern.npy"
IC_HALF = 15
W_HALF, L_SWEEP = 5, 5
INF_DIST = 10_000


def _fma(a, b, c, dtype):
    """a * b + c rounded once (float32: the product is exact in float64);
    in a lower precision, computed in it."""
    if dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a.to(dtype) * b.to(dtype) + c.to(dtype)


def pyramid_shapes(h, w, n_levels, scale):
    return [(int(round(h / scale**l)), int(round(w / scale**l)))
            for l in range(n_levels)]


def _two_taps(n_in, n_out, device, dtype):
    """Inputs and weights of the triangle-kernel resize (no antialiasing):
    output i reads inputs i0 and i0 + 1."""
    inv = 1.0 / (n_out / n_in)
    i = torch.arange(n_out, dtype=dtype, device=device) + 0.5
    sf = _fma(i, torch.full((), inv, dtype=dtype, device=device),
              torch.full((), -0.5, dtype=dtype, device=device), dtype)
    x = (sf[None, :] - torch.arange(n_in, dtype=dtype,
                                    device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x, min=0.0)
    tot = w.sum(dim=0, keepdim=True)
    ok = tot.abs() > 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(ok, w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sf >= -0.5) & (sf <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    i0 = (w != 0).to(torch.int32).argmax(dim=0)
    cols = torch.arange(n_out, device=device)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    w1 = torch.where(i0 + 1 < n_in, w[i1, cols], torch.zeros_like(w[0]))
    return i0, i1, w[i0, cols], w1


def resize(img, shape, dtype):
    H, W = img.shape[-2:]
    h, w = shape
    x = img.reshape(-1, H, W)
    r0, r1, a0, a1 = _two_taps(H, h, img.device, dtype)
    rows = _fma(a1[:, None], x[:, r1, :], a0[:, None] * x[:, r0, :], dtype)
    c0, c1, b0, b1 = _two_taps(W, w, img.device, dtype)
    out = b0 * rows[..., c0] + b1 * rows[..., c1]
    return out.reshape(*img.shape[:-2], h, w)


def pyramid(frames, n_levels, scale, dtype=torch.float32):
    """frames (..., H, W) uint8 -> the integer pyramid, a list of levels."""
    x = frames.to(dtype)
    shapes = pyramid_shapes(*x.shape[-2:], n_levels, scale)
    out = [torch.round(x)]
    for l in range(1, n_levels):
        out.append(torch.round(resize(out[-1], shapes[l], dtype)))
    return out


def _gauss(dtype, device, ksize=7, sigma=2.0):
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return torch.tensor((k / k.sum()).astype(np.float32), device=device).to(
        dtype)


def blur(img, dtype=torch.float32):
    """round(7x7 Gaussian (sigma 2) blur), reflect-101 borders, taps
    accumulated as fma(k0, s0, k1 s1), then fma(k_i, s_i, acc)."""
    k = _gauss(dtype, img.device)
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W).to(dtype)

    def taps(sl):
        acc = _fma(k[0], sl[0], k[1] * sl[1], dtype)
        for i in range(2, 7):
            acc = _fma(k[i], sl[i], acc, dtype)
        return acc

    p = F.pad(x.float(), (0, 0, 3, 3), mode="reflect").to(dtype)
    v = taps([p[..., i:i + H, :] for i in range(7)])
    p = F.pad(v.float(), (3, 3, 0, 0), mode="reflect").to(dtype)
    o = taps([p[..., i:i + W] for i in range(7)])
    return torch.round(o.reshape(img.shape))


def stack(levels):
    """Levels (..., V, h_l, w_l) -> (..., L*V, H0, W0) zero-padded; image
    l*V + v."""
    H0, W0 = levels[0].shape[-2:]
    return torch.cat([F.pad(p, (0, W0 - p.shape[-1], 0, H0 - p.shape[-2]))
                      for p in levels], dim=-3)


def build_stacks(frames, n_levels, scale, dtype=torch.float32):
    """The pyramid stack and the blurred stack of (S, 2, H, W) uint8
    stereo frames, and the level shapes."""
    pyr = pyramid(frames, n_levels, scale, dtype)
    return (stack(pyr), stack([blur(p, dtype) for p in pyr]),
            [tuple(p.shape[-2:]) for p in pyr])


def _umax():
    umax = np.zeros(IC_HALF + 2, dtype=np.int32)
    vmax = int(math.floor(IC_HALF * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(IC_HALF * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(IC_HALF * IC_HALF - v * v)))
    v0 = 0
    for v in range(IC_HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:IC_HALF + 1]


def _gather(img, i, y, x):
    """img (I, H, W): values at (image, row, column), rows and columns
    clamped into the stack."""
    _, H, W = img.shape
    return img[i.long(), y.long().clamp(0, H - 1), x.long().clamp(0, W - 1)]


def describe(pyr_stack, blur_stack, xy, img_idx, image_hw,
             dtype=torch.float32):
    """Angle (S, n) and rotated BRIEF (S, n, 8) int32 of keypoints at level
    coordinates xy (S, n, 2) in images img_idx (S, n) of the stacks."""
    S, I, H, W = pyr_stack.shape
    dev = xy.device
    ys, xs = np.mgrid[-IC_HALF:IC_HALF + 1, -IC_HALF:IC_HALF + 1]
    inside = np.abs(xs) <= _umax()[np.abs(ys)]
    dy = torch.tensor(ys[inside], device=dev)
    dx = torch.tensor(xs[inside], device=dev)
    img = (img_idx + torch.arange(S, device=dev)[:, None] * I).reshape(-1)
    x, y = xy[..., 0].reshape(-1), xy[..., 1].reshape(-1)
    flat = pyr_stack.reshape(-1, H, W).to(dtype)
    v = _gather(flat, img[:, None], y[:, None] + dy, x[:, None] + dx)
    m10 = (v * dx.to(dtype)).sum(-1)
    m01 = (v * dy.to(dtype)).sum(-1)
    angle = torch.atan2(m01, m10)
    pat = torch.tensor(np.load(PATTERN), dtype=torch.float32, device=dev)
    pat = pat.to(dtype)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px, py = pat[None, :, :, 0], pat[None, :, :, 1]
    rx = torch.round(px * ca[:, None, None] - py * sa[:, None, None]).long()
    ry = torch.round(px * sa[:, None, None] + py * ca[:, None, None]).long()
    hw = torch.tensor(image_hw, device=dev)[img_idx.reshape(-1).long()]
    gx = torch.minimum((x[:, None, None] + rx).clamp(min=0),
                       hw[:, 1, None, None] - 1)
    gy = torch.minimum((y[:, None, None] + ry).clamp(min=0),
                       hw[:, 0, None, None] - 1)
    bl = blur_stack.reshape(-1, H, W).to(dtype)
    b = _gather(bl, img[:, None, None], gy, gx)        # (n, 256, 2)
    bits = (b[..., 0] < b[..., 1]).to(torch.int64).reshape(-1, 8, 32)
    words = (bits << torch.arange(32, device=dev)).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return angle.float().reshape(S, -1), words.reshape(S, -1, 8)


def sad_refine(pyr_stack, level_hw, lvl, ul, vl, ur, dtype=torch.float32):
    """best disparity index, its SAD and the parabola offset at each
    keypoint: left level l at image 2l, right at 2l + 1 of each frame's
    stack; (S, n) int32 inputs."""
    S, I, H, W = pyr_stack.shape
    dev = lvl.device
    flat = pyr_stack.reshape(-1, H, W).to(dtype)
    img = (lvl.long() * 2 + torch.arange(S, device=dev)[:, None] * I)
    img = img.reshape(-1)
    hw = torch.tensor(level_hw, device=dev)[lvl.reshape(-1).long()]
    h, w = hw[:, 0, None], hw[:, 1, None]
    o = torch.arange(-W_HALF, W_HALF + 1, device=dev)
    o_s = torch.arange(-W_HALF - L_SWEEP, W_HALF + L_SWEEP + 1, device=dev)
    rows = torch.minimum((vl.reshape(-1, 1) + o).clamp(min=0), h - 1)
    cl = torch.minimum((ul.reshape(-1, 1) + o).clamp(min=0), w - 1)
    cr = torch.minimum((ur.reshape(-1, 1) + o_s).clamp(min=0), w - 1)
    patch = flat[img[:, None, None], rows[:, :, None], cl[:, None, :]]
    strip = flat[img[:, None, None] + 1, rows[:, :, None], cr[:, None, :]]
    patch = patch - patch[:, W_HALF, W_HALF, None, None]
    n_d = 2 * L_SWEEP + 1
    win = lambda d: (strip[:, :, d:d + 2 * W_HALF + 1]
                     - strip[:, W_HALF, d + W_HALF, None, None])
    sad = torch.stack([(patch - win(d)).abs().sum((1, 2))
                       for d in range(n_d)], -1)
    best = torch.argmin(sad, -1)
    cost = sad.gather(-1, best[:, None])[:, 0]
    cm1 = sad.gather(-1, (best - 1).clamp(min=0)[:, None])[:, 0]
    cp1 = sad.gather(-1, (best + 1).clamp(max=n_d - 1)[:, None])[:, 0]
    delta = (cm1 - cp1) / torch.clamp(2.0 * (cm1 + cp1 - 2.0 * cost),
                                      min=1e-6)
    interior = (best > 0) & (best < n_d - 1)
    delta = torch.clamp(torch.where(interior, delta, torch.zeros_like(delta)),
                        -1.0, 1.0)
    return (best.to(torch.int32).reshape(S, -1), cost.float().reshape(S, -1),
            delta.float().reshape(S, -1))


def _bits(a):
    sh = torch.arange(32, dtype=torch.int32, device=a.device)
    return ((a[..., None] >> sh) & 1).reshape(*a.shape[:-1], 256)


def gate_count(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave, valid,
               dtype=torch.float32):
    return int(_gates(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave,
                      valid, dtype).sum())


def _gates(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave, valid,
           dtype):
    """Row i (a projected point) and column j (a keypoint) are candidates
    when the keypoint lies in the point's square window of radius r, its
    octave is the predicted one or the one below, its right u (when it has
    one) lies within r of the point's, the point is in the frustum and the
    keypoint valid."""
    c = lambda t: t.to(dtype)
    rr = c(r)[..., :, None]
    win = (((c(u)[..., :, None] - c(xy[..., 0])[..., None, :]).abs() <= rr)
           & ((c(v)[..., :, None] - c(xy[..., 1])[..., None, :]).abs() <= rr))
    po = pred_oct.long()[..., :, None]
    oc = octave.long()[..., None, :]
    urk = c(kp_ur)[..., None, :]
    ur_ok = (urk < 0) | ((c(ur)[..., :, None] - urk).abs() <= rr)
    return (win & (oc >= po - 1) & (oc <= po) & ur_ok
            & in_frustum[..., :, None] & valid[..., None, :])


def gated_best2(a, u, v, ur, r, pred_oct, in_frustum, b, xy, kp_ur, octave,
                valid, dtype=torch.float32):
    """(best column, best distance, second distance, second column) per
    row; the lowest column wins a tie, INF_DIST and column 0 where a row
    has no (second) candidate."""
    gate = _gates(u, v, ur, r, pred_oct, in_frustum, xy, kp_ur, octave,
                  valid, dtype)
    A, B = _bits(a), _bits(b)
    # popcount(a ^ b) = |a| + |b| - 2 a.b, exact in float32 (<= 256)
    d = (A.sum(-1)[..., :, None] + B.sum(-1)[..., None, :]
         - 2 * torch.matmul(A.float(), B.float().transpose(-1, -2)).long())
    d = torch.where(gate, d, torch.full_like(d, INF_DIST))
    i1 = d.argmin(-1, keepdim=True)
    d1 = d.gather(-1, i1)
    d.scatter_(-1, i1, INF_DIST)
    i2 = d.argmin(-1, keepdim=True)
    d2 = d.gather(-1, i2)
    return (i1[..., 0].int(), d1[..., 0].int(), d2[..., 0].int(),
            i2[..., 0].int())


def rows_off(got, want) -> int:
    """Rows (along the first axes but the last of each output) in which any
    output differs."""
    bad = None
    for g, w in zip(got, want):
        g, w = g.to(w.device), w
        n = g.shape[0] * g.shape[1] if g.dim() >= 2 else g.shape[0]
        diff = (g.reshape(n, -1) != w.reshape(n, -1)).any(-1)
        bad = diff if bad is None else bad | diff
    return int(bad.sum())


# -- the tracking step's pose ----------------------------------------------

def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(xi):
    """(..., 6) (translation part, rotation vector) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = torch.linalg.norm(phi, dim=-1)[..., None, None]
    K = _skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    small = th < 1e-8
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(th_s) / th_s)
    b = torch.where(small, torch.full_like(th, 0.5),
                    (1 - torch.cos(th_s)) / th_s**2)
    c = torch.where(small, torch.full_like(th, 1.0 / 6.0),
                    (th_s - torch.sin(th_s)) / th_s**3)
    R = eye + a * K + b * K @ K
    V = eye + b * K + c * K @ K
    T = torch.zeros((*xi.shape[:-1], 4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def pose_refine(cam: dict, T, X, obs, info, stereo, inlier,
                dtype=torch.float64, iters: int = 15):
    """The pose that minimises the step's own cost over its inliers: the
    information-weighted squared stereo reprojection error (u, v, and the
    right u where the keypoint has one) of each inlier's map point, by
    Gauss-Newton from the step's pose. T (S, 4, 4), X, obs (S, N, 3), info,
    stereo, inlier (S, N). In `dtype`; the 6x6 solve in at least float32."""
    fx, fy, cx, cy, bf = (cam[k] for k in ("fx", "fy", "cx", "cy", "bf"))
    T, X, obs = T.to(dtype), X.to(dtype), obs.to(dtype)
    w = (info * inlier).to(dtype)
    rw = torch.stack([w, w, w * stereo.to(dtype)], -1)          # (S, N, 3)
    solve_dt = torch.float64 if dtype == torch.float64 else torch.float32
    for _ in range(iters):
        R, t = T[..., :3, :3], T[..., :3, 3]
        Xc = X @ R.transpose(-1, -2) + t[..., None, :]
        x, y, z = Xc.unbind(-1)
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        u = fx * x / z + cx
        pred = torch.stack([u, fy * y / z + cy, u - bf / z], -1)
        r = torch.where(rw > 0, obs - pred, torch.zeros_like(pred))
        zero = torch.zeros_like(z)
        dp = torch.stack([                                       # (S, N, 3, 3)
            torch.stack([fx / z, zero, -fx * x / z**2], -1),
            torch.stack([zero, fy / z, -fy * y / z**2], -1),
            torch.stack([fx / z, zero, (bf - fx * x) / z**2], -1)], -2)
        eye = torch.eye(3, dtype=dtype, device=X.device).expand(dp.shape)
        J = dp @ torch.cat([eye, -_skew(Xc)], -1)               # (S, N, 3, 6)
        H = torch.einsum("snri,snr,snrj->sij", J, rw, J)
        g = torch.einsum("snri,snr,snr->si", J, rw, r)
        H = H.to(solve_dt) + 1e-9 * torch.eye(6, dtype=solve_dt,
                                              device=X.device)
        d = torch.linalg.solve(H, g.to(solve_dt)[..., None])[..., 0]
        T = se3_exp(d.to(dtype)) @ T
    return T


def centres(T) -> torch.Tensor:
    """Camera centres -R^T t of (..., 4, 4) T_cw, in float64."""
    T = T.double()
    return -(T[..., :3, :3].transpose(-1, -2) @ T[..., :3, 3:])[..., 0]


# -- trajectory and lines --------------------------------------------------

def centres_true(t_cw: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Camera centres of the true poses."""
    r = t_cw[:, :3, :3].astype(dtype)
    t = t_cw[:, :3, 3].astype(dtype)
    return -np.einsum("kji,kj->ki", r, t)


def ate(est: np.ndarray, true: np.ndarray) -> float:
    """RMSE (m) of camera centres, in the world of the first camera (no
    alignment: the program's map starts at the first frame's pose)."""
    return float(np.sqrt(np.mean(np.sum((est - true) ** 2, -1))))


def kept_lines(p1: np.ndarray, p2: np.ndarray, cap: int) -> np.ndarray:
    """The file rows a stored-line source keeps: all of them up to `cap`,
    else the `cap` longest in file order."""
    if len(p1) <= cap:
        return np.arange(len(p1))
    ln = np.linalg.norm(p2 - p1, axis=-1)
    return np.sort(np.argsort(-ln, kind="stable")[:cap])


def wrong_line_matches(r_idx: np.ndarray, seg_l: np.ndarray,
                       seg_r: np.ndarray) -> int:
    """Stereo matches (left detection i -> right detection r_idx[i]) whose
    two detections are of different world segments, or of none."""
    sel = np.nonzero(r_idx >= 0)[0]
    if len(sel) == 0:
        return 0
    ok = (sel < len(seg_l)) & (r_idx[sel] < len(seg_r))
    good = np.zeros(len(sel), bool)
    good[ok] = seg_l[sel[ok]] == seg_r[r_idx[sel[ok]]]
    return int((~good).sum())
