"""Headless visualization: map, trajectory and frame overlays as images.

Counterpart of lldslam_tpu/viewer/render.py: pure-numpy rasterization of a
top-down map view (points, map lines, keyframe centres, trajectory) and of
keypoints and line segments over an input frame. Each function returns the
(H, W, 3) uint8 image, written as a PNG (io/png.py) when a `path` is
given.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io.png import write_png

BG = np.array([18, 20, 24], np.uint8)
PT = np.array([170, 175, 180], np.uint8)
KF = np.array([90, 160, 255], np.uint8)
TRAJ = np.array([255, 180, 60], np.uint8)
LINE = np.array([120, 220, 140], np.uint8)
TRACKED = np.array([40, 230, 60], np.uint8)
UNTRACKED = np.array([140, 140, 140], np.uint8)


def _to_png(img: np.ndarray, path: str | Path):
    write_png(path, img)


def _draw_segment(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    h, w, _ = img.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def render_topdown(store, T_wc_traj=None, path=None, size: int = 1024,
                   margin: float = 0.07) -> np.ndarray:
    """Orthographic top-down (x-z plane) view of the map: points, lines
    (+-2 m around X0 along the direction), keyframe centres and the
    trajectory, framed on the 1st-99th percentile of their extent. Returns
    the (size, size, 3) image."""
    img = np.tile(BG, (size, size, 1))
    pts = store.pt_pos[:store.n_pt][store.pt_valid[:store.n_pt]]
    kf_T = store.kf_pose[:store.n_kf][store.kf_valid[:store.n_kf]]
    centers = (-np.einsum("kji,kj->ki", kf_T[:, :3, :3], kf_T[:, :3, 3])
               if len(kf_T) else np.zeros((0, 3)))
    traj = (np.asarray(T_wc_traj)[:, :3, 3]
            if T_wc_traj is not None and len(T_wc_traj) else None)
    src = [p for p in (pts, centers) if len(p)]
    if traj is not None:
        src.append(traj)
    if not src:
        if path:
            _to_png(img, path)
        return img
    allp = np.concatenate(src)
    lo = np.percentile(allp[:, [0, 2]], 1, axis=0)
    hi = np.percentile(allp[:, [0, 2]], 99, axis=0)
    span = max(float((hi - lo).max()), 1e-3)
    lo = (lo + hi) / 2 - span / 2
    scale = size * (1 - 2 * margin) / span

    def to_px(xz):
        p = (np.asarray(xz) - lo) * scale + size * margin
        return p[..., 0], size - 1 - p[..., 1]

    if len(pts):
        xs, ys = to_px(pts[:, [0, 2]])
        img[np.clip(ys.round().astype(int), 0, size - 1),
            np.clip(xs.round().astype(int), 0, size - 1)] = PT
    for i in np.nonzero(store.ln_valid[:store.n_ln])[0]:
        a = store.ln_x0[i] - 2.0 * store.ln_dir[i]
        b = store.ln_x0[i] + 2.0 * store.ln_dir[i]
        _draw_segment(img, to_px(a[[0, 2]]), to_px(b[[0, 2]]), LINE)
    if traj is not None:
        xs, ys = to_px(traj[:, [0, 2]])
        for i in range(len(xs) - 1):
            _draw_segment(img, (xs[i], ys[i]), (xs[i + 1], ys[i + 1]), TRAJ)
    if len(centers):
        xs, ys = to_px(centers[:, [0, 2]])
        xi = np.clip(xs.round().astype(int), 1, size - 2)
        yi = np.clip(ys.round().astype(int), 1, size - 2)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                img[yi + dy, xi + dx] = KF
    if path:
        _to_png(img, path)
    return img


def render_frame_overlay(img_gray, feats_xy, tracked_mask, path=None,
                         lines_p1=None, lines_p2=None,
                         lines_valid=None) -> np.ndarray:
    """Keypoints (tracked green, untracked grey, as 3x3 crosses) and
    detected line segments over the gray input frame. Returns the
    (H, W, 3) image."""
    g = np.asarray(img_gray).astype(np.uint8)
    img = np.stack([g, g, g], -1)
    xy = np.asarray(feats_xy).round().astype(int)
    tracked = np.asarray(tracked_mask)
    h, w, _ = img.shape
    ok = ((xy[:, 0] >= 1) & (xy[:, 0] < w - 1) & (xy[:, 1] >= 1)
          & (xy[:, 1] < h - 1))
    for i in np.nonzero(ok)[0]:
        x, y = xy[i]
        color = TRACKED if tracked[i] else UNTRACKED
        img[y - 1:y + 2, x] = color
        img[y, x - 1:x + 2] = color
    if lines_p1 is not None:
        for i in np.nonzero(np.asarray(lines_valid))[0]:
            _draw_segment(img, np.asarray(lines_p1)[i],
                          np.asarray(lines_p2)[i], LINE)
    if path:
        _to_png(img, path)
    return img
