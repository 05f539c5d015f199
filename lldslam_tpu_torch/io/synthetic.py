"""Synthetic stereo sequences, numpy only (no JAX).

1. `make_sequence`: the generator of bench.py (`_make_tex`, `_sample_tex`,
   `_make_sequence`): a forward-moving stereo camera in a ray-cast corridor
   of textured planes (ground, two walls, end wall) with multi-octave block
   texture, rendered with full perspective plus Gaussian pixel noise.
2. The patch worlds of the JAX package's end-to-end tests: textured 3D
   points stamped as 41x41 patches with bilinear subpixel placement, far
   first. `make_ring_sequence` is the loop-closure circle of
   tests/test_loop_e2e.py (`_make_ring_world`, `_circle_pose`);
   `make_points_world` and `corridor_poses` are the forward corridor of
   tests/test_pipeline.py (`_make_world`) that tests/test_reloc.py blinds;
   `render_points_rgbd` renders it as gray image and depth map
   (tests/test_rgbd_viewer_ckpt.py::_render_rgbd).
3. `gen_stored_lines`: stored line detections of the corridor of
   `make_sequence` (bench.py `_gen_stored_lines_ref_scale`), written in the
   stored-line format.
4. `make_loop_map` fills a MapStore with a drifting circle for loop-closer
   tests; `add_loop_lines` adds the map lines its keyframes observe.
5. `euroc_blocks`: EuRoC-like stereo rectification settings.

Motion increments come from this package's `se3.exp`, so the machine
without JAX generates the same frames; for one seed the images and poses
agree with the JAX-side generators (an increment may differ by a float32
ulp).
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
                   return_poses: bool = False, return_depth: bool = False):
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
    compatibility (texture density is fixed per metre).

    Returns the frames [(imL, imR) uint8], with `return_poses` followed by
    the T_cw per frame and the world's dimensions, and with `return_depth`
    followed by the left view's ray-cast depth per frame ((H, W) float32
    metres, inf where no plane is hit: the camera-frame ray has z = 1, so
    its parameter is the depth). The depth draws nothing from the random
    stream: the frames are the same either way."""
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
        Camera frame: x right, y down, z forward; world starts aligned.
        Returns (image, depth)."""
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
        return img, best_t

    frames = []
    poses = []
    depths = []
    T = np.eye(4, dtype=np.float32)   # T_cw
    xi = np.array([0.0, 0.0, -1.0 * speed, 0.0, 0.003, 0.0], np.float32)
    dT = se3.exp(torch.from_numpy(xi)).numpy()
    for _ in range(n_frames):
        poses.append(T.copy())
        Twc = np.linalg.inv(T)
        Rwc, C = Twc[:3, :3], Twc[:3, 3]
        C_r = C + Rwc[:, 0] * cam.baseline
        imL, depth = render(C, Rwc)
        imL = imL + rng.normal(0, 1.2, (H, W))
        imR = render(C_r, Rwc)[0] + rng.normal(0, 1.2, (H, W))
        frames.append((np.clip(imL, 0, 255).astype(np.uint8),
                       np.clip(imR, 0, 255).astype(np.uint8)))
        depths.append(depth)
        T = dT @ T
    out = (frames,)
    if return_poses:
        out += (poses, dict(half_w=half_w, cam_h=cam_h, length=length,
                            wall_top=wall_top))
    if return_depth:
        out += (depths,)
    return out if len(out) > 1 else frames


def gen_stored_lines(cam, poses, world: dict, left, right, seed: int = 5,
                     dz: float = 0.32, desc_dim: int = 40) -> list[int]:
    """Stored line detections of the `make_sequence` corridor (`world` is
    its third return value with `return_poses`), generated geometrically:
    vertical wall segments every `dz` metres and horizontal rails, projected
    with the true poses into both views, one unit descriptor per segment
    plus per-observation noise (sigma 0.008) well inside the match gate.
    Writes one file per frame per view into `left` / `right`; returns the
    left view's line count per frame."""
    from .stored_lines import save_frame_lines

    rng = np.random.default_rng(seed)
    half_w, cam_h = world["half_w"], world["cam_h"]
    length, wall_top = world["length"], world["wall_top"]
    segs, descs = [], []
    for x in (-half_w, half_w):
        for z in np.arange(1.0, length, dz):
            y0 = rng.uniform(wall_top + 1.0, 0.2)
            y1 = min(y0 + rng.uniform(1.2, 3.0), cam_h - 0.1)
            segs.append(((x, y0, z + rng.uniform(-0.15, 0.15)),
                         (x, y1, z + rng.uniform(-0.15, 0.15))))
            d = rng.normal(size=desc_dim).astype(np.float32)
            descs.append(d / np.linalg.norm(d))
        # horizontal rails every 7.5 dz
        for z in np.arange(2.0, length, 7.5 * dz):
            y = rng.uniform(wall_top + 1.5, 0.8)
            segs.append(((x, y, z), (x, y, z + rng.uniform(2.0, 4.0))))
            d = rng.normal(size=desc_dim).astype(np.float32)
            descs.append(d / np.linalg.norm(d))
    P1 = np.array([s[0] for s in segs], np.float32)
    P2 = np.array([s[1] for s in segs], np.float32)
    D = np.array(descs, np.float32)
    W, H = cam.width, cam.height

    def project(T_cw, off_x=0.0):
        R, t = T_cw[:3, :3], T_cw[:3, 3].copy()
        # right camera: the centre shifted by the baseline along camera x
        t = t - np.array([off_x, 0.0, 0.0], np.float32)
        X1 = P1 @ R.T + t
        X2 = P2 @ R.T + t
        ok = (X1[:, 2] > 0.5) & (X2[:, 2] > 0.5)
        u1 = cam.fx * X1[:, 0] / np.maximum(X1[:, 2], 1e-6) + cam.cx
        v1 = cam.fy * X1[:, 1] / np.maximum(X1[:, 2], 1e-6) + cam.cy
        u2 = cam.fx * X2[:, 0] / np.maximum(X2[:, 2], 1e-6) + cam.cx
        v2 = cam.fy * X2[:, 1] / np.maximum(X2[:, 2], 1e-6) + cam.cy
        m = 2.0
        ok &= (u1 > m) & (u1 < W - m) & (v1 > m) & (v1 < H - m)
        ok &= (u2 > m) & (u2 < W - m) & (v2 > m) & (v2 < H - m)
        ok &= np.hypot(u2 - u1, v2 - v1) > 26.0
        return np.stack([u1, v1], -1), np.stack([u2, v2], -1), ok

    counts = []
    for i, T_cw in enumerate(poses):
        for out, off in ((left, 0.0), (right, cam.baseline)):
            p1, p2, ok = project(T_cw, off)
            idx = np.nonzero(ok)[0]
            nz = rng.normal(0, 0.008, (len(idx), desc_dim)).astype(np.float32)
            save_frame_lines(out, i, p1[idx], p2[idx],
                             np.zeros(len(idx), np.int32), D[idx] + nz,
                             valid=np.ones(len(idx), bool))
            if off == 0.0:
                counts.append(len(idx))
    return counts


PATCH = 41       # side of a stamped patch (pixels)


def _patches(rng, n: int) -> np.ndarray:
    """Random texture patches with a dark ring around a bright centre."""
    patches = rng.uniform(0, 120, (n, PATCH, PATCH)).astype(np.float32)
    c = PATCH // 2
    patches[:, c - 2:c + 3, c - 2:c + 3] = 40.0
    bright = rng.uniform(180, 250, n)
    patches[:, c - 1:c + 2, c - 1:c + 2] = bright[:, None, None]
    return patches


def make_points_world(rng, n: int = 500):
    """Random textured 3D points in a corridor along +z, 4-60 m ahead (the
    world of tests/test_pipeline.py::_make_world). Returns (pts (n, 3),
    patches)."""
    pts = np.stack([
        rng.uniform(-30.0, 30.0, n),
        rng.uniform(-6.0, 6.0, n),
        rng.uniform(4.0, 60.0, n),
    ], -1).astype(np.float32)
    return pts, _patches(rng, n)


def make_ring_world(rng, n: int = 1600):
    """Textured points on a ring band the camera orbits inside (the world
    of tests/test_loop_e2e.py::_make_ring_world)."""
    th = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(18.0, 45.0, n)
    pts = np.stack([r * np.cos(th), rng.uniform(-6.0, 6.0, n),
                    r * np.sin(th)], -1).astype(np.float32)
    return pts, _patches(rng, n)


def circle_pose(theta: float, radius: float = 8.0) -> np.ndarray:
    """T_cw of a camera on the circle looking radially outward."""
    c = np.array([radius * np.cos(theta), 0.0, radius * np.sin(theta)])
    z = np.array([np.cos(theta), 0.0, np.sin(theta)])
    y = np.array([0.0, 1.0, 0.0])
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, :3] = np.stack([np.cross(y, z), y, z], axis=1)
    T_wc[:3, 3] = c
    return np.linalg.inv(T_wc).astype(np.float32)


def corridor_poses(n_frames: int) -> list[np.ndarray]:
    """T_cw per frame of the forward corridor with a slow yaw: each frame
    left-multiplies exp((0, 0, -0.25, 0, 0.004, 0))."""
    xi = torch.tensor([0.0, 0.0, -0.25, 0.0, 0.004, 0.0])
    dT = se3.exp(xi).numpy()
    poses, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        poses.append(T.copy())
        T = (dT @ T).astype(np.float32)
    return poses


def _stamp(im, patch, uc, vc):
    """Bilinear subpixel stamp of `patch` centred at float (uc, vc)."""
    h = PATCH // 2
    iu, iv = int(np.floor(uc)), int(np.floor(vc))
    dx, dy = uc - iu, vc - iv
    pp = np.pad(patch, 1, mode="edge")
    im[iv - h:iv + h + 1, iu - h:iu + h + 1] = (
        (1 - dy) * (1 - dx) * pp[1:-1, 1:-1] + (1 - dy) * dx * pp[1:-1, :-2]
        + dy * (1 - dx) * pp[:-2, 1:-1] + dy * dx * pp[:-2, :-2])


def render_points(cam, T_cw: np.ndarray, pts: np.ndarray,
                  patches: np.ndarray):
    """Stereo pair (float32, background 15) of a patch world: every point
    more than 0.5 m in front whose patch fits both images, far first."""
    W, H = cam.width, cam.height
    imL = np.full((H, W), 15.0, np.float32)
    imR = np.full((H, W), 15.0, np.float32)
    Xc = (T_cw[:3, :3] @ pts.T).T + T_cw[:3, 3]
    z = np.maximum(Xc[:, 2], 1e-6)
    u = cam.fx * Xc[:, 0] / z + cam.cx
    v = cam.fy * Xc[:, 1] / z + cam.cy
    ur = u - cam.bf / z
    h = PATCH // 2
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] <= 0.5:
            continue
        if h + 1 < u[i] < W - h - 1 and h + 1 < v[i] < H - h - 1 \
                and h + 1 < ur[i] < W - h - 1:
            _stamp(imL, patches[i], u[i], v[i])
            _stamp(imR, patches[i], ur[i], v[i])
    return imL, imR


def render_points_rgbd(cam, T_cw: np.ndarray, pts: np.ndarray,
                       patches: np.ndarray):
    """Gray image (background 15) and dense depth map (background wall at
    60 m) of a patch world: every point more than 0.5 m in front whose patch
    fits the image, far first, its patch region carrying its depth."""
    W, H = cam.width, cam.height
    img = np.full((H, W), 15.0, np.float32)
    depth = np.full((H, W), 60.0, np.float32)
    Xc = (T_cw[:3, :3] @ pts.T).T + T_cw[:3, 3]
    u = cam.fx * Xc[:, 0] / np.maximum(Xc[:, 2], 1e-6) + cam.cx
    v = cam.fy * Xc[:, 1] / np.maximum(Xc[:, 2], 1e-6) + cam.cy
    h = PATCH // 2
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] > 0.5 and h + 1 < u[i] < W - h - 1 \
                and h + 1 < v[i] < H - h - 1:
            _stamp(img, patches[i], u[i], v[i])
            iu, iv = int(u[i]), int(v[i])
            depth[iv - h:iv + h + 1, iu - h:iu + h + 1] = Xc[i, 2]
    return img, depth


def make_ring_sequence(cam, n_frames: int = 88, seed: int = 11):
    """The loop-closure circle of tests/test_loop_e2e.py: 1.08 turns of a
    radius-8 m circle in `n_frames` frames around a ring of textured
    points. Returns (frames [(imL, imR)], T_cw per frame)."""
    pts, patches = make_ring_world(np.random.default_rng(seed))
    poses = [circle_pose(2 * np.pi * 1.08 * i / n_frames)
             for i in range(n_frames)]
    return [render_points(cam, T, pts, patches) for T in poses], poses


# keyframe drift of make_loop_map at its last keyframe, (upsilon, omega)
LOOP_MAP_DRIFT = (0.4, 0.0, 0.3, 0.0, 0.04, 0.0)


def make_loop_map(store, n_kf: int = 24, seed: int = 0):
    """Fill an empty MapStore (this package's or the JAX package's: only
    their common API is used) with the keyframes of a drifting circle
    whose last keyframes revisit the first ones' place.

    `n_kf` keyframes over 1.25 turns of the ring world, each observing
    every ring point it sees (pixel noise 0.3, two flipped descriptor bits
    per observation, octave 0). A point keeps its id while consecutive
    keyframes see it and gets a new one when it comes back into view, as a
    tracker would create it, so the revisiting keyframes share words but no
    points with the first ones. Keyframe k's estimated pose is
    exp(k / (n_kf - 1) * drift) times its true pose, and each point is
    placed in the estimated frame of the keyframe that created it; the
    drift reaches LOOP_MAP_DRIFT at the last keyframe. Returns the true
    T_cw per keyframe."""
    rng = np.random.default_rng(seed)
    cam = store.cam
    pts, _ = make_ring_world(rng)
    base = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint64) \
        .astype(np.uint32)
    xi = torch.tensor(LOOP_MAP_DRIFT, dtype=torch.float32)
    n_kp = store.n_kp
    true_poses, prev = [], {}
    for k in range(n_kf):
        T = circle_pose(2 * np.pi * 1.25 * k / n_kf)
        true_poses.append(T)
        T_est = (se3.exp(xi * (k / max(n_kf - 1, 1))).numpy() @ T) \
            .astype(np.float32)
        Xc = (T[:3, :3] @ pts.T).T + T[:3, 3]
        z = np.maximum(Xc[:, 2], 1e-6)
        u = cam.fx * Xc[:, 0] / z + cam.cx
        v = cam.fy * Xc[:, 1] / z + cam.cy
        ur = u - cam.bf / z
        seen = np.nonzero((Xc[:, 2] > 0.5) & (u >= 20) & (u < cam.width - 20)
                          & (v >= 20) & (v < cam.height - 20)
                          & (ur >= 0))[0][:n_kp]
        m = len(seen)
        feats = dict(xy=np.zeros((n_kp, 2), np.float32),
                     ur=np.full(n_kp, -1.0, np.float32),
                     octave=np.zeros(n_kp, np.int32),
                     angle=np.zeros(n_kp, np.float32),
                     desc=np.zeros((n_kp, 8), np.uint32),
                     valid=np.arange(n_kp) < m)
        feats["xy"][:m] = np.stack([u[seen], v[seen]], -1) \
            + rng.normal(0, 0.3, (m, 2))
        feats["ur"][:m] = ur[seen] + rng.normal(0, 0.3, m)
        desc = base[seen].copy()
        for _ in range(2):
            bit = rng.integers(0, 256, m)
            desc[np.arange(m), bit // 32] ^= (np.uint32(1) << (bit % 32)
                                              .astype(np.uint32))
        feats["desc"][:m] = desc
        depth = np.full(n_kp, -1.0, np.float32)
        depth[:m] = Xc[seen, 2]
        kf = store.add_keyframe(T_est, feats, depth,
                                np.full(n_kp, -1, np.int32), k, 0.1 * k)
        old = np.array([w in prev for w in seen], bool)
        f_old = np.nonzero(old)[0]
        store.kf_pt_ids[kf, f_old] = [prev[w] for w in seen[f_old]]
        f_new = np.nonzero(~old)[0]
        T_wc = np.linalg.inv(T_est)
        Xw = (T_wc[:3, :3] @ Xc[seen[f_new]].T).T + T_wc[:3, 3]
        ids = store.create_points(kf, f_new, Xw.astype(np.float32))
        prev = dict(zip(seen[f_old].tolist(),
                        store.kf_pt_ids[kf, f_old].tolist()))
        prev.update(zip(seen[f_new].tolist(), ids.tolist()))
        store.mark_obs_dirty()
        store.set_parent_from_covisibility(kf)
    store.refresh_obs_counts()
    store._update_point_geometry(np.nonzero(store.pt_valid[:store.n_pt])[0])
    return true_poses


def add_loop_lines(store, true_poses, n_lines: int = 240, seed: int = 1,
                   desc_dim: int = 40):
    """Add map lines to a map made by `make_loop_map` (either package's
    MapStore), as a stereo line tracker would: vertical segments on the
    ring band, observed in both views of every keyframe that sees both
    endpoints (pixel noise 0.3, octave 0, a unit descriptor per segment
    plus noise 0.008 per observation). A line keeps its id while
    consecutive keyframes see it and is created again when it comes back
    into view, in the estimated frame of the creating keyframe (the frame
    its points are placed in). Returns the number of lines created."""
    rng = np.random.default_rng(seed)
    cam = store.cam
    th = rng.uniform(0, 2 * np.pi, n_lines)
    r = rng.uniform(18.0, 45.0, n_lines)
    y0 = rng.uniform(-5.0, -1.0, n_lines)
    y1 = y0 + rng.uniform(2.0, 5.0, n_lines)
    P1 = np.stack([r * np.cos(th), y0, r * np.sin(th)], -1)
    P2 = np.stack([r * np.cos(th), y1, r * np.sin(th)], -1)
    base = rng.normal(size=(n_lines, desc_dim))
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    LD, m = store.n_ln_det, 20.0

    def project(T, P, off=0.0):
        Xc = P @ T[:3, :3].T + T[:3, 3] - np.array([off, 0.0, 0.0])
        z = np.maximum(Xc[:, 2], 1e-6)
        uv = np.stack([cam.fx * Xc[:, 0] / z + cam.cx,
                       cam.fy * Xc[:, 1] / z + cam.cy], -1)
        ok = (Xc[:, 2] > 0.5) & (uv[:, 0] > m) & (uv[:, 0] < cam.width - m) \
            & (uv[:, 1] > m) & (uv[:, 1] < cam.height - m)
        return uv, ok

    prev, n_new = {}, 0
    for kf, T in enumerate(true_poses):
        a1, ok1 = project(T, P1)
        a2, ok2 = project(T, P2)
        b1, ok3 = project(T, P1, cam.baseline)
        b2, ok4 = project(T, P2, cam.baseline)
        seen = np.nonzero(ok1 & ok2 & ok3 & ok4 & (
            np.linalg.norm(a2 - a1, axis=-1) > 30.0))[0][:LD]
        n = len(seen)
        noisy = lambda a: np.zeros((LD, 2), np.float32) if n == 0 else \
            np.concatenate([a[seen] + rng.normal(0, 0.3, (n, 2)),
                            np.zeros((LD - n, 2))]).astype(np.float32)
        desc = np.zeros((LD, desc_dim), np.float32)
        desc[:n] = base[seen] + rng.normal(0, 0.008, (n, desc_dim))
        lines_np = dict(p1=noisy(a1), p2=noisy(a2), p1r=noisy(b1),
                        p2r=noisy(b2), has_r=np.arange(LD) < n,
                        octave=np.zeros(LD, np.int32), desc=desc,
                        valid=np.arange(LD) < n)
        ids = np.full(LD, -1, np.int32)
        old = np.array([w in prev for w in seen], bool)
        ids[np.nonzero(old)[0]] = [prev[w] for w in seen[old]]
        store.add_keyframe_lines(kf, lines_np, ids)
        f_new = np.nonzero(~old)[0]
        T_wc = np.linalg.inv(store.kf_pose[kf]) @ T
        q1 = P1[seen[f_new]] @ T_wc[:3, :3].T + T_wc[:3, 3]
        q2 = P2[seen[f_new]] @ T_wc[:3, :3].T + T_wc[:3, 3]
        d = (q2 - q1) / np.linalg.norm(q2 - q1, axis=-1, keepdims=True)
        X0 = q1 - np.sum(q1 * d, axis=-1, keepdims=True) * d
        new_ids = store.create_lines(kf, f_new, X0.astype(np.float32),
                                     d.astype(np.float32))
        n_new += len(new_ids)
        prev = dict(zip(seen[old].tolist(), ids[np.nonzero(old)[0]].tolist()))
        prev.update(zip(seen[f_new].tolist(), new_ids.tolist()))
    return n_new


def euroc_blocks() -> dict:
    """EuRoC MAV stereo rectification settings (752x480 views) after the
    reference's EuRoC.yaml, as config.parse_opencv_yaml returns them:
    LEFT.* / RIGHT.* width and height, and K, D (radial-tangential), R and
    P as (rows, cols, values)."""
    out = {}
    for side, K, D, R, P in (
            ("LEFT", [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0, 0, 1],
             [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0],
             [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
              0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
              -0.008089410156878961, -0.007044357138835809,
              0.9999424675829176],
             [435.2046959714599, 0, 367.4517211914062, 0, 0,
              435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]),
            ("RIGHT", [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0, 0, 1],
             [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0],
             [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
              0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
              -0.007729688520722713, 0.007064130529506649, 0.999945173484644],
             [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0,
              435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0])):
        out.update({f"{side}.width": 752, f"{side}.height": 480,
                    f"{side}.K": (3, 3, K), f"{side}.D": (1, 5, D),
                    f"{side}.R": (3, 3, R), f"{side}.P": (3, 4, P)})
    return out


def settings_yaml(cfg) -> str:
    """The reference-format settings file (config.load_config reads it back
    to `cfg`) of a SlamConfig's camera, ORB, tracking-gate and line blocks;
    stored-line paths are written only where `cfg` has them."""
    c, o, t, ln = cfg.camera, cfg.orb, cfg.tracking, cfg.line
    keys = {
        "Camera.fx": c.fx, "Camera.fy": c.fy, "Camera.cx": c.cx,
        "Camera.cy": c.cy, "Camera.k1": c.k1, "Camera.k2": c.k2,
        "Camera.p1": c.p1, "Camera.p2": c.p2, "Camera.k3": c.k3,
        "Camera.bf": c.bf, "Camera.fps": c.fps, "Camera.RGB": c.rgb,
        "Camera.width": c.width, "Camera.height": c.height,
        "ThDepth": t.th_depth, "ORBextractor.nFeatures": o.n_features,
        "ORBextractor.nLevels": o.n_levels,
        "ORBextractor.scaleFactor": o.scale,
        "ORBextractor.iniThFAST": o.ini_th, "ORBextractor.minThFAST": o.min_th,
        "minInitPoints": t.min_init_points,
        "minTrackInliers": t.min_track_inliers, "ldType": ln.ld_type,
        "mdThr": ln.md_thr, "gamma": ln.gamma, "minLineLen": ln.min_line_len,
        "maxInCell": ln.max_in_cell, "mappingThr": ln.mapping_thr,
    }
    if ln.detections_path:
        keys["lineDetectionsPath"] = ln.detections_path
    if ln.descriptors_path:
        keys["lineDescriptorsPath"] = ln.descriptors_path
    return "%YAML:1.0\n" + "".join(f"{k}: {v!r}\n" if isinstance(v, float)
                                   else f"{k}: {v}\n" for k, v in keys.items())


def write_kitti_sequence(seq_dir, frames, cfg, poses=None) -> None:
    """A KITTI-odometry-layout directory of stereo frames: image_0/%06d.png
    (left) and image_1/%06d.png (right) as 8-bit grayscale PNGs, times.txt
    at the camera's rate, settings.yaml of `cfg` and, where the frames' T_cw
    `poses` are given, gt.txt (T_wc as 3x4 rows)."""
    from pathlib import Path

    from .png import write_png

    seq_dir = Path(seq_dir)
    for cam_dir in ("image_0", "image_1"):
        (seq_dir / cam_dir).mkdir(parents=True, exist_ok=True)
    for i, (left, right) in enumerate(frames):
        for cam_dir, img in (("image_0", left), ("image_1", right)):
            write_png(seq_dir / cam_dir / f"{i:06d}.png",
                      np.asarray(img, np.uint8))
    np.savetxt(seq_dir / "times.txt",
               np.arange(len(frames)) / float(cfg.camera.fps), fmt="%.6e")
    (seq_dir / "settings.yaml").write_text(settings_yaml(cfg))
    if poses is not None:
        T_wc = np.stack([np.linalg.inv(p) for p in poses])
        np.savetxt(seq_dir / "gt.txt", T_wc[:, :3].reshape(len(T_wc), 12))
