"""The benchmark's own synthetic KITTI-like stereo world, from the seed.

A forward-moving stereo camera in a ray-cast corridor of textured planes
(ground, two walls, an end wall) with multi-octave block texture, rendered
with full perspective plus Gaussian pixel noise: the corridor of the JAX
bench's `_make_sequence`, rewritten in plain torch so that it renders on
the card, and frozen here so that no change to the program moves the
yardstick.

One change of motion: the bench's camera turns at a constant 0.003 rad a
frame, which leaves a straight corridor of 16 m after about 75 frames at
1 m/frame. Here the heading weaves, `yaw_amp * sin(2 pi k / yaw_period)`
(at most 0.0031 rad a frame, the bench's rate), so a camera keeps inside
the corridor for any number of frames. The corridor's length grows with
speed x frames, so no camera reaches the end wall.

`stored_lines` generates the stored line detections of the corridor
(the JAX bench's `_gen_stored_lines_ref_scale`, numpy), written in the
program's stored-line file format, and returns the world segment of every
detection, which the check uses as the truth of a stereo line match.

Everything random is drawn from generators seeded by `seed_of(seed, i)`.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

RES = 48.0          # texture pixels per metre
WALL_TOP = -6.0     # wall extent above the camera (y down)
HALF_W = 8.0        # corridor half-width (m)
CAM_H = 1.65        # camera height over the ground (m)
STRIPE_EVERY = 3.0  # vertical wall stripes of the lines world (m)
NOISE_SIGMA = 1.2   # pixel noise (grey levels)


def seed_of(seed: int, index: int) -> int:
    """A 63-bit seed for stream `index` of a run seeded `seed`."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def corridor_length(n_frames: int, speed: float) -> float:
    return 220.0 + speed * n_frames


def poses(n_frames: int, speed: float, yaw_amp: float = 0.05,
          yaw_period: float = 100.0) -> np.ndarray:
    """(n, 4, 4) float32 T_cw: frame 0 is the identity; the camera moves
    `speed` m a frame along its heading, which weaves about +z."""
    out = np.zeros((n_frames, 4, 4), np.float32)
    c = np.zeros(3)
    for k in range(n_frames):
        th = yaw_amp * math.sin(2.0 * math.pi * k / yaw_period)
        ct, st = math.cos(th), math.sin(th)
        r_wc = np.array([[ct, 0.0, st], [0.0, 1.0, 0.0], [-st, 0.0, ct]])
        t_cw = np.eye(4)
        t_cw[:3, :3] = r_wc.T
        t_cw[:3, 3] = -r_wc.T @ c
        out[k] = t_cw
        c = c + speed * r_wc[:, 2]
    return out


def make_texture(gen: torch.Generator, h_m: float, w_m: float,
                 stripes: bool, device) -> torch.Tensor:
    """Multi-octave block texture of a plane (h_m x w_m metres at RES px a
    metre): random blocks at 2 m / 0.5 m / 0.125 m cells, optional
    vertical stripes every STRIPE_EVERY metres."""
    h_px, w_px = int(h_m * RES), int(w_m * RES)
    t = torch.zeros((h_px, w_px), dtype=torch.float32, device=device)
    for cell_m, amp in ((2.0, 55.0), (0.5, 45.0), (0.125, 35.0)):
        c_px = max(int(cell_m * RES), 1)
        ch, cw = h_px // c_px + 1, w_px // c_px + 1
        blocks = (torch.rand((ch, cw), generator=gen, device=device)
                  * (2 * amp) - amp)
        t += blocks.repeat_interleave(c_px, 0).repeat_interleave(
            c_px, 1)[:h_px, :w_px]
    t = torch.clamp(t + 128.0, 8.0, 248.0)
    if stripes:
        x, k = STRIPE_EVERY, 1
        while x < w_m:
            t[:, int(x * RES):int((x + 0.18) * RES)] = (
                235.0 if k % 2 == 0 else 18.0)
            x += STRIPE_EVERY
            k += 1
    return t


def sample(tex: torch.Tensor, u_px: torch.Tensor,
           v_px: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with clipped coordinates (the last texel pair is
    chosen by index: a float32 bound just under w - 1 rounds to w - 1 on a
    texture wider than 16,384 texels)."""
    h, w = tex.shape
    u = torch.clamp(u_px, 0.0, w - 1.0)
    v = torch.clamp(v_px, 0.0, h - 1.0)
    u0 = torch.clamp(u.to(torch.int64), max=w - 2)
    v0 = torch.clamp(v.to(torch.int64), max=h - 2)
    fu, fv = u - u0, v - v0
    flat = tex.reshape(-1)
    at = lambda y, x: flat[y * w + x]
    return (at(v0, u0) * (1 - fu) * (1 - fv) + at(v0, u0 + 1) * fu * (1 - fv)
            + at(v0 + 1, u0) * (1 - fu) * fv
            + at(v0 + 1, u0 + 1) * fu * fv)


class Corridor:
    """One corridor: its textures and a ray-caster for its cameras."""

    def __init__(self, cam: dict, length: float, seed: int, stripes: bool,
                 device):
        self.cam, self.length, self.device = cam, length, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        wall_h = CAM_H - WALL_TOP
        self.ground = make_texture(self.gen, 2 * HALF_W, length, False, device)
        self.wall_l = make_texture(self.gen, wall_h, length, stripes, device)
        self.wall_r = make_texture(self.gen, wall_h, length, stripes, device)
        self.end = make_texture(self.gen, wall_h, 2 * HALF_W, False, device)
        H, W = cam["height"], cam["width"]
        ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
        xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
        self.dx = ((xs - cam["cx"]) / cam["fx"]).expand(H, W)
        self.dy = ((ys - cam["cy"]) / cam["fy"]).expand(H, W)

    def render(self, c: torch.Tensor, r_wc: torch.Tensor) -> torch.Tensor:
        """Noise-free (H, W) float32 image of a camera at centre c with
        rotation r_wc (camera x right, y down, z forward)."""
        d = (r_wc[:, 0, None, None] * self.dx
             + r_wc[:, 1, None, None] * self.dy + r_wc[:, 2, None, None])
        img = torch.full_like(self.dx, 12.0)
        best = torch.full_like(self.dx, math.inf)
        L = self.length
        planes = (
            ("ground", d[1], CAM_H - c[1]),
            ("wl", d[0], -HALF_W - c[0]),
            ("wr", d[0], HALF_W - c[0]),
            ("end", d[2], L - c[2]))
        for which, denom, num in planes:
            safe = torch.where(denom.abs() > 1e-9, denom,
                               torch.ones_like(denom))
            tt = num / safe
            valid = (denom.abs() > 1e-9) & (tt > 0.25)
            X, Y, Z = c[0] + tt * d[0], c[1] + tt * d[1], c[2] + tt * d[2]
            if which == "ground":
                inside = (X.abs() <= HALF_W) & (Z >= 0) & (Z <= L)
                u_m, v_m, tex = Z, X + HALF_W, self.ground
            elif which in ("wl", "wr"):
                inside = (Y >= WALL_TOP) & (Y <= CAM_H) & (Z >= 0) & (Z <= L)
                u_m, v_m = Z, Y - WALL_TOP
                tex = self.wall_l if which == "wl" else self.wall_r
            else:
                inside = ((X.abs() <= HALF_W) & (Y >= WALL_TOP)
                          & (Y <= CAM_H))
                u_m, v_m, tex = X + HALF_W, Y - WALL_TOP, self.end
            hit = valid & inside & (tt < best)
            img = torch.where(hit, sample(tex, u_m * RES, v_m * RES), img)
            best = torch.where(hit, tt, best)
        return img

    def frames(self, t_cw: np.ndarray, out: torch.Tensor) -> None:
        """Renders every pose of t_cw (n, 4, 4) as a uint8 stereo pair with
        pixel noise into out (n, 2, H, W), a host tensor."""
        base = self.cam["bf"] / self.cam["fx"]
        for k in range(t_cw.shape[0]):
            t_wc = np.linalg.inv(t_cw[k].astype(np.float64))
            r_wc = torch.tensor(t_wc[:3, :3], dtype=torch.float32,
                                device=self.device)
            c = torch.tensor(t_wc[:3, 3], dtype=torch.float32,
                             device=self.device)
            views = []
            for cc in (c, c + r_wc[:, 0] * base):
                im = self.render(cc, r_wc) + NOISE_SIGMA * torch.randn(
                    self.dx.shape, generator=self.gen, device=self.device)
                views.append(torch.clamp(im, 0.0, 255.0).to(torch.uint8))
            out[k].copy_(torch.stack(views), non_blocking=True)


def render_sequence(cam: dict, n_frames: int, speed: float, seed: int,
                    stripes: bool, device, pin: bool) -> tuple:
    """(frames (n, 2, H, W) uint8 host tensor, T_cw (n, 4, 4), world dict)
    of one corridor."""
    length = corridor_length(n_frames, speed)
    t_cw = poses(n_frames, speed)
    world = Corridor(cam, length, seed, stripes, device)
    out = torch.empty((n_frames, 2, cam["height"], cam["width"]),
                      dtype=torch.uint8, pin_memory=pin)
    world.frames(t_cw, out)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    del world
    return out, t_cw, dict(length=length)


# -- stored line detections ------------------------------------------------

def line_segments(rng: np.random.Generator, length: float, dz: float = 0.32,
                  desc_dim: int = 40):
    """The lines world's 3D segments: vertical wall segments every dz
    metres and horizontal rails every 7.5 dz, on both walls, one unit
    descriptor each. Returns (P1 (n, 3), P2 (n, 3), D (n, desc_dim))."""
    segs, descs = [], []
    for x in (-HALF_W, HALF_W):
        for z in np.arange(1.0, length, dz):
            y0 = rng.uniform(WALL_TOP + 1.0, 0.2)
            y1 = min(y0 + rng.uniform(1.2, 3.0), CAM_H - 0.1)
            segs.append(((x, y0, z + rng.uniform(-0.15, 0.15)),
                         (x, y1, z + rng.uniform(-0.15, 0.15))))
            d = rng.normal(size=desc_dim).astype(np.float32)
            descs.append(d / np.linalg.norm(d))
        for z in np.arange(2.0, length, 7.5 * dz):
            y = rng.uniform(WALL_TOP + 1.5, 0.8)
            segs.append(((x, y, z), (x, y, z + rng.uniform(2.0, 4.0))))
            d = rng.normal(size=desc_dim).astype(np.float32)
            descs.append(d / np.linalg.norm(d))
    P1 = np.array([s[0] for s in segs], np.float32)
    P2 = np.array([s[1] for s in segs], np.float32)
    return P1, P2, np.array(descs, np.float32)


def project_segments(cam: dict, t_cw: np.ndarray, P1, P2, off_x: float):
    """Endpoints (n, 2) x 2 of every segment in a camera shifted off_x
    along its x axis, and which are seen whole, 26 px long or more."""
    R, t = t_cw[:3, :3], t_cw[:3, 3] - np.array([off_x, 0.0, 0.0],
                                                 np.float32)
    X1, X2 = P1 @ R.T + t, P2 @ R.T + t
    ok = (X1[:, 2] > 0.5) & (X2[:, 2] > 0.5)
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    u1 = fx * X1[:, 0] / np.maximum(X1[:, 2], 1e-6) + cx
    v1 = fy * X1[:, 1] / np.maximum(X1[:, 2], 1e-6) + cy
    u2 = fx * X2[:, 0] / np.maximum(X2[:, 2], 1e-6) + cx
    v2 = fy * X2[:, 1] / np.maximum(X2[:, 2], 1e-6) + cy
    W, H, m = cam["width"], cam["height"], 2.0
    ok &= (u1 > m) & (u1 < W - m) & (v1 > m) & (v1 < H - m)
    ok &= (u2 > m) & (u2 < W - m) & (v2 > m) & (v2 < H - m)
    ok &= np.hypot(u2 - u1, v2 - v1) > 26.0
    return np.stack([u1, v1], -1), np.stack([u2, v2], -1), ok


def stored_lines(cam: dict, t_cw: np.ndarray, length: float, seed: int,
                 left: Path, right: Path, first_id: int = 0) -> list:
    """Writes frame i's detections to <left|right>/<first_id + i>.npz
    (p1, p2, octave, desc: the program's stored-line format) and returns,
    per frame and view, (segment ids, p1, p2) in file order."""
    rng = np.random.default_rng(seed)
    P1, P2, D = line_segments(rng, length)
    base = cam["bf"] / cam["fx"]
    truth = []
    for i, T in enumerate(t_cw):
        ids = []
        for out, off in ((left, 0.0), (right, base)):
            p1, p2, ok = project_segments(cam, T, P1, P2, off)
            idx = np.nonzero(ok)[0]
            nz = rng.normal(0, 0.008, (len(idx), D.shape[1])).astype(
                np.float32)
            out.mkdir(parents=True, exist_ok=True)
            np.savez(out / f"{first_id + i:06d}.npz",
                     p1=p1[idx].astype(np.float32),
                     p2=p2[idx].astype(np.float32),
                     octave=np.zeros(len(idx), np.int32),
                     desc=(D[idx] + nz).astype(np.float32))
            ids.append((idx, p1[idx].astype(np.float32),
                        p2[idx].astype(np.float32)))
        truth.append(tuple(ids))
    return truth
