"""Synthetic stereo sequences, numpy only (no JAX).

Counterpart of the generator in bench.py (`_make_tex`, `_sample_tex`,
`_make_sequence`): a forward-moving stereo camera in a ray-cast corridor of
textured planes (ground, two walls, end wall) with multi-octave block
texture, rendered with full perspective plus Gaussian pixel noise. The
per-frame motion increment comes from this package's `se3.exp`, so the
machine without JAX can generate the same frames; for one seed the images
and poses agree with bench._make_sequence (the increment may differ by a
float32 ulp).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3


def make_tex(rng, h_m: float, w_m: float, res: float, stripe_every=None):
    """Multi-octave block texture for a plane (h_m x w_m metres, `res`
    px/metre): random intensity blocks at 2 m / 0.5 m / 0.125 m cells give
    FAST corners and BRIEF texture at every viewing distance, exactly the
    scale-covariant statistics ORB's octave prediction assumes. Optional
    vertical stripes (for the line workload) at `stripe_every` metres."""
    h_px, w_px = int(h_m * res), int(w_m * res)
    t = np.zeros((h_px, w_px), np.float32)
    for cell_m, amp in ((2.0, 55.0), (0.5, 45.0), (0.125, 35.0)):
        c_px = max(int(cell_m * res), 1)
        ch, cw = h_px // c_px + 1, w_px // c_px + 1
        blocks = rng.uniform(-amp, amp, (ch, cw)).astype(np.float32)
        t += np.kron(blocks, np.ones((c_px, c_px), np.float32))[:h_px, :w_px]
    t = np.clip(t + 128.0, 8.0, 248.0)
    if stripe_every is not None:
        x = stripe_every
        while x < w_m:
            x0, x1 = int(x * res), int((x + 0.18) * res)
            t[:, x0:x1] = 235.0 if (int(x / stripe_every) % 2 == 0) else 18.0
            x += stripe_every
    return t


def sample_tex(tex, u_px, v_px):
    """Bilinear texture fetch with clipped coordinates (vectorized)."""
    h, w = tex.shape
    u = np.clip(u_px, 0.0, w - 1.001)
    v = np.clip(v_px, 0.0, h - 1.001)
    u0 = u.astype(np.int32)
    v0 = v.astype(np.int32)
    fu = u - u0
    fv = v - v0
    return (tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv)


def make_sequence(cam, n_frames: int, n_per_m: float = 40.0, seed: int = 0,
                   with_lines: bool = False, half_w: float = 8.0,
                   cam_h: float = 1.65, speed: float = 1.0,
                   return_poses: bool = False):
    """Synthetic forward-motion stereo corridor, rendered by ray-casting
    textured planes (ground + two walls + end wall) with full perspective.

    Unlike the round-2/early-round-3 sprite worlds (fixed- or scaled-pixel
    patch stamps), every pixel here is a true projection of static 3D
    texture, so appearance is scale- and viewpoint-covariant: detected ORB
    octaves track MapPoint::PredictScale, descriptors are stable between
    frames, and association statistics match real imagery (KITTI-like
    feature lifetimes -> the reference's natural ~1-KF-per-4-8-frames
    cadence, NeedNewKeyFrame Tracking.cc:1223-1310). `with_lines` paints
    high-contrast vertical stripes on the walls — static 3D vertical line
    segments for the LLD line workload. `n_per_m` kept for signature
    compatibility (texture density is fixed per metre)."""
    rng = np.random.default_rng(seed)
    W, H = cam.width, cam.height
    length = 220.0 + 1.0 * n_frames
    res = 48.0                      # texture px per metre
    # half_w: corridor half-width (m); cam_h: camera height over ground;
    # speed: metres per frame — narrower/slower = indoor (EuRoC-like)
    wall_top = -6.0                 # wall extent above camera (y up is -)
    stripes = 3.0 if with_lines else None
    ground = make_tex(rng, 2 * half_w, length, res)
    wall_l = make_tex(rng, cam_h - wall_top, length, res,
                       stripe_every=stripes)
    wall_r = make_tex(rng, cam_h - wall_top, length, res,
                       stripe_every=stripes)
    endw = make_tex(rng, cam_h - wall_top, 2 * half_w, res)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dx = (xs - cam.cx) / cam.fx     # camera-frame ray dirs at z=1
    dy = (ys - cam.cy) / cam.fy

    def render(C, Rwc):
        """Ray-cast one camera: center C (world), rotation Rwc (cam->world).
        Camera frame: x right, y down, z forward; world starts aligned."""
        d = (Rwc[:, 0][:, None, None] * dx[None]
             + Rwc[:, 1][:, None, None] * dy[None]
             + Rwc[:, 2][:, None, None])          # (3, H, W)
        img = np.full((H, W), 12.0, np.float32)
        best_t = np.full((H, W), np.inf, np.float32)
        # plane list: (axis, offset, sign test, tex, (u_m, v_m) mapping)
        # ground: y = +cam_h
        with np.errstate(divide="ignore", invalid="ignore"):
            for which in ("ground", "wl", "wr", "end"):
                if which == "ground":
                    denom = d[1]
                    tt = (cam_h - C[1]) / denom
                elif which == "wl":
                    denom = d[0]
                    tt = (-half_w - C[0]) / denom
                elif which == "wr":
                    denom = d[0]
                    tt = (half_w - C[0]) / denom
                else:
                    denom = d[2]
                    tt = (length - C[2]) / denom
                valid = (np.abs(denom) > 1e-9) & (tt > 0.25)
                X = C[0] + tt * d[0]
                Y = C[1] + tt * d[1]
                Z = C[2] + tt * d[2]
                if which == "ground":
                    inside = (np.abs(X) <= half_w) & (Z >= 0) & (Z <= length)
                    u_m, v_m, tex = Z, X + half_w, ground
                elif which in ("wl", "wr"):
                    inside = (Y >= wall_top) & (Y <= cam_h) \
                        & (Z >= 0) & (Z <= length)
                    tex = wall_l if which == "wl" else wall_r
                    u_m, v_m = Z, Y - wall_top
                else:
                    inside = (np.abs(X) <= half_w) & (Y >= wall_top) \
                        & (Y <= cam_h)
                    u_m, v_m, tex = X + half_w, Y - wall_top, endw
                hit = valid & inside & (tt < best_t)
                if not hit.any():
                    continue
                val = sample_tex(tex, u_m[hit] * res, v_m[hit] * res)
                img[hit] = val
                best_t[hit] = tt[hit]
        return img

    frames = []
    poses = []
    T = np.eye(4, dtype=np.float32)   # T_cw
    xi = np.array([0.0, 0.0, -1.0 * speed, 0.0, 0.003, 0.0], np.float32)
    dT = se3.exp(torch.from_numpy(xi)).numpy()
    for _ in range(n_frames):
        poses.append(T.copy())
        Twc = np.linalg.inv(T)
        Rwc, C = Twc[:3, :3], Twc[:3, 3]
        C_r = C + Rwc[:, 0] * cam.baseline
        imL = render(C, Rwc) + rng.normal(0, 1.2, (H, W))
        imR = render(C_r, Rwc) + rng.normal(0, 1.2, (H, W))
        frames.append((np.clip(imL, 0, 255).astype(np.uint8),
                       np.clip(imR, 0, 255).astype(np.uint8)))
        T = dT @ T
    if return_poses:
        return frames, poses, dict(half_w=half_w, cam_h=cam_h,
                                   length=length, wall_top=wall_top)
    return frames
