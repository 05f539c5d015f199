"""Seeded inputs for the port's three CUDA kernels at the shapes the main
path gives them, with the cases that reach their edges.

- K1a (`ops/orb_describe.describe`): the two float32 level stacks of a
  KITTI-size stereo frame (8 levels x 2 views, 376x1241 padded), one
  keypoint budget per level and view, a third of the keypoints within 2 px
  of the 16-px detection margin at each border (the BRIEF taps reach 18 px,
  so they are clamped to the level).
- K1b (`ops/stereo_sad.sad_refine`): the same stack and the frame's 2048
  left-keypoint slots (padding slots at (0, 0) of level 0), keypoints near
  the margins on every level, and 32 keypoints on a flat block whose SADs
  all tie.
- K2g (`ops/match_best2.gated_best2`): M projected map points against the
  2048 keypoints of a KITTI frame, 60% of the rows near a keypoint, so
  that a row has about one candidate, as a 2.5-4 px x 1.2^octave window at
  the KITTI keypoint density holds (0.03% of the pairs; `chip_smoke.py`
  counts the main path's own share per call beside it); tied columns
  (copies of keypoints 0-15 at the same position with the same descriptor)
  under rows 0-63, an empty row (64, outside the frustum) and a row with
  one candidate (65, keypoint 20).
- The pose LM (`ops/pose_lm.pose_lm`): S frames of a KITTI camera at the
  2048-keypoint capacity of the tracking step, each a kind: `mix` (about
  1,840 valid rows, 60% stereo, octaves 0-7, 0.5 px x 1.2^octave noise,
  20% outliers 20-60 px off, from a pose 0.1 m and 0.01 rad off), `few`
  (8 valid stereo rows, no outlier) or `none` (no valid row); with line
  rows, those of the joint point+line LM beside them (256 a problem at the
  stored-line capacity, seen from the problem's true pose).

`chip_smoke.py` and `tests/test_torch_cuda.py` hold each kernel to its plain
version on these inputs. Everything is made with numpy from `rng` and moved
to `device` once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import image
from ..ops.orb import EDGE_MARGIN, OrbConfig

KITTI_HW = (376, 1241)
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                 bf=386.1448)
EMPTY_ROW, ONE_ROW, ONE_COL = 64, 65, 20


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _coords(rng, size: int, n: int) -> np.ndarray:
    """A third within 2 px of the margin at the low border, a third at the
    high border, a third inside."""
    lo = EDGE_MARGIN + rng.integers(-2, 3, n)
    hi = size - 1 - EDGE_MARGIN + rng.integers(-2, 3, n)
    mid = rng.integers(EDGE_MARGIN, size - EDGE_MARGIN, n)
    pick = rng.integers(0, 3, n)
    return np.where(pick == 0, lo, np.where(pick == 1, hi, mid))


def _stack(rng, shapes, views: int, hw) -> np.ndarray:
    """Integer-valued float32 (L*V, H, W) stack, level l view v at l*V + v,
    zero outside each level."""
    out = np.zeros((len(shapes) * views,) + tuple(hw), np.float32)
    for l, (h, w) in enumerate(shapes):
        for v in range(views):
            out[l * views + v, :h, :w] = rng.integers(0, 256, (h, w))
    return out


def describe_inputs(rng, device, cfg: OrbConfig = OrbConfig(n_features=2000),
                    hw=KITTI_HW, views: int = 2):
    """(pyr_stack, blur_stack, xy, img_idx, image_hw) as the frame build
    passes them to K1a."""
    shapes = image.pyramid_shapes(*hw, cfg.n_levels, cfg.scale)
    xy, idx = [], []
    for v in range(views):
        for l, ((h, w), n_l) in enumerate(zip(shapes, cfg.per_level_budget())):
            xy.append(np.stack([_coords(rng, w, n_l), _coords(rng, h, n_l)], -1))
            idx.append(np.full(n_l, l * views + v))
    return (_t(_stack(rng, shapes, views, hw), device),
            _t(_stack(rng, shapes, views, hw), device),
            _t(np.concatenate(xy).astype(np.int32), device),
            _t(np.concatenate(idx).astype(np.int32), device),
            [s for s in shapes for _ in range(views)])


def sad_inputs(rng, device, cfg: OrbConfig = OrbConfig(n_features=2000),
               hw=KITTI_HW):
    """(pyr_stack, level_hw, lvl, ul, vl, ur) as stereo.match_stereo passes
    them to K1b: the left keypoints' level coords, the matched right u at
    a disparity of 0-60 level px."""
    shapes = image.pyramid_shapes(*hw, cfg.n_levels, cfg.scale)
    stack = _stack(rng, shapes, 2, hw)
    lvl, ul, vl = [], [], []
    for l, ((h, w), n_l) in enumerate(zip(shapes, cfg.per_level_budget())):
        lvl.append(np.full(n_l, l))
        ul.append(_coords(rng, w, n_l))
        vl.append(_coords(rng, h, n_l))
    lvl, ul, vl = (np.concatenate(x) for x in (lvl, ul, vl))
    ur = ul - rng.integers(0, 61, len(ul))
    # flat block on level 0 of both views: every SAD of these keypoints is 0
    stack[0:2, 100:160, 300:700] = 77.0
    flat = np.nonzero(lvl == 0)[0][:32]
    ul[flat] = rng.integers(330, 670, 32)
    vl[flat] = rng.integers(110, 150, 32)
    ur[flat] = ul[flat] - 10
    pad = cfg.max_kp - len(lvl)          # padding slots: level 0 at (0, 0)
    z = np.zeros(pad, np.int64)
    lvl, ul, vl, ur = (np.concatenate([x, z]).astype(np.int32)
                       for x in (lvl, ul, vl, ur))
    return (_t(stack, device), shapes, _t(lvl, device), _t(ul, device),
            _t(vl, device), _t(ur, device))


def gated_best2_inputs(rng, device, M: int, N: int = 2048, th: float = 1.0,
                       cfg: OrbConfig = OrbConfig(n_features=2000), hw=KITTI_HW):
    """The arguments of gated_best2 (a, u, v, ur, r, pred_oct, in_frustum,
    b, xy, kp_ur, octave, valid) for M projected map points and N frame
    keypoints."""
    H, W = hw
    desc = lambda n: rng.integers(0, 2**32, (n, 8), dtype=np.uint64) \
        .astype(np.uint32)
    b = desc(N)
    xy = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1) \
        .astype(np.float32)
    octave = rng.integers(0, cfg.n_levels, N).astype(np.int32)
    kp_ur = np.where(rng.uniform(size=N) < 0.6,
                     xy[:, 0] - rng.uniform(1, 80, N), -1.0).astype(np.float32)
    valid = rng.uniform(size=N) < 0.97
    half = N // 2
    b[half:half + 16], xy[half:half + 16] = b[:16], xy[:16]
    kp_ur[half:half + 16], octave[half:half + 16] = kp_ur[:16], octave[:16]
    valid[:16] = valid[half:half + 16] = valid[ONE_COL] = True

    # rows: 60% near a keypoint (the same point re-observed), the rest anywhere
    near = rng.integers(0, N, M)
    near[:64] = np.arange(64) % 16
    near[ONE_ROW] = ONE_COL
    at = rng.uniform(size=M) < 0.6
    at[:66] = True
    u = np.where(at, xy[near, 0] + rng.normal(0, 1.5, M), rng.uniform(0, W, M))
    v = np.where(at, xy[near, 1] + rng.normal(0, 1.5, M), rng.uniform(0, H, M))
    u[:64] = xy[near[:64], 0] + 0.5
    v[:64] = xy[near[:64], 1] - 0.5
    ur = u - rng.uniform(1, 80, M)
    ur[at] = np.where(kp_ur[near[at]] >= 0,
                      kp_ur[near[at]] + rng.normal(0, 1.0, at.sum()), ur[at])
    pred_oct = np.where(at, octave[near], rng.integers(0, cfg.n_levels, M))
    scale = np.float32(cfg.scale) ** np.arange(cfg.n_levels, dtype=np.float32)
    r = (np.where(rng.uniform(size=M) < 0.3, 2.5, 4.0) * th
         * scale[pred_oct]).astype(np.float32)
    in_frustum = rng.uniform(size=M) < 0.9
    in_frustum[:66] = True
    in_frustum[EMPTY_ROW] = False
    a = desc(M)
    flips = rng.uniform(size=(M, 8, 32)) < 0.1
    a[at] = b[near[at]] ^ (flips[at] * (1 << np.arange(32, dtype=np.uint64))
                          ).sum(-1).astype(np.uint32)
    # the one-candidate row: exactly on keypoint ONE_COL, a quarter-pixel window
    u[ONE_ROW], v[ONE_ROW] = xy[ONE_COL]
    ur[ONE_ROW] = kp_ur[ONE_COL]
    pred_oct[ONE_ROW] = octave[ONE_COL]
    r[ONE_ROW] = 0.25
    f32 = lambda x: _t(np.asarray(x, np.float32), device)
    return (_t(a.view(np.int32), device), f32(u), f32(v), f32(ur), f32(r),
            _t(pred_oct.astype(np.int32), device), _t(in_frustum, device),
            _t(b.view(np.int32), device), _t(xy, device), _t(kp_ur, device),
            _t(octave, device), _t(valid, device))


def _rot(rng, angle: float) -> np.ndarray:
    """A rotation by `angle` rad about a random axis (Rodrigues)."""
    k = rng.normal(size=3)
    k /= np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _pose_problem(rng, kind: str, N: int, cfg: OrbConfig):
    """One problem of `pose_lm_inputs`: (true pose, T_init, X, obs,
    inv_sigma2, is_stereo, valid) in numpy."""
    c = KITTI_CAM
    inv_lut = np.float32(cfg.scale) ** (-2.0 * np.arange(cfg.n_levels))
    T = np.eye(4)
    T[:3, :3] = _rot(rng, rng.uniform(0, 0.3))
    T[:3, 3] = rng.uniform(-2, 2, 3)
    z = rng.uniform(3, 40, N)
    u = rng.uniform(0, KITTI_HW[1], N)
    v = rng.uniform(0, KITTI_HW[0], N)
    Xc = np.stack([(u - c["cx"]) * z / c["fx"], (v - c["cy"]) * z / c["fy"],
                   z], -1)
    X = (Xc - T[:3, 3]) @ T[:3, :3]          # world points: T^-1 Xc
    octave = rng.integers(0, cfg.n_levels, N)
    sigma = 0.5 * np.float32(cfg.scale) ** octave
    obs = np.stack([u, v, u - c["bf"] / z], -1) \
        + rng.normal(size=(N, 3)) * sigma[:, None]
    out_rows = rng.uniform(size=N) < 0.2
    obs[out_rows] += rng.choice([-1, 1], (out_rows.sum(), 3)) \
        * rng.uniform(20, 60, (out_rows.sum(), 3))
    stereo = rng.uniform(size=N) < 0.6
    obs[~stereo, 2] = -1.0
    valid = rng.uniform(size=N) < 0.9
    if kind == "few":
        valid[:] = False
        valid[:8] = stereo[:8] = True
        obs[:8] = np.stack([u, v, u - c["bf"] / z], -1)[:8]
    elif kind == "none":
        valid[:] = False
    T0 = np.eye(4)
    T0[:3, :3] = _rot(rng, 0.01)
    T0[:3, 3] = rng.normal(size=3) * 0.1 / np.sqrt(3)
    return T, T0 @ T, X, obs, inv_lut[octave], stereo, valid


def _line_rows(rng, kind: str, T: np.ndarray, M: int):
    """The line rows of one problem seen from the true pose T: (X0, d,
    x1_l, x2_l, x1_r, x2_r, octave, has_right, valid) in numpy."""
    c = KITTI_CAM
    mid = np.stack([rng.uniform(-6, 6, M), rng.uniform(-2, 2, M),
                    rng.uniform(4, 30, M)], -1)
    dc = rng.normal(size=(M, 3))
    dc /= np.linalg.norm(dc, axis=-1, keepdims=True)
    ends = [mid - 0.8 * dc, mid + 0.8 * dc]
    for e in ends:
        e[:, 2] = np.maximum(e[:, 2], 2.0)
    A, B = ((e - T[:3, 3]) @ T[:3, :3] for e in ends)   # world endpoints
    d = (B - A) / np.linalg.norm(B - A, axis=-1, keepdims=True)
    X0 = A - np.sum(A * d, -1, keepdims=True) * d
    octave = rng.integers(0, 3, M)
    sigma = 0.5 * 1.44 ** octave

    def px(Xc, off):
        return np.stack([c["fx"] * (Xc[:, 0] - off) / Xc[:, 2] + c["cx"],
                         c["fy"] * Xc[:, 1] / Xc[:, 2] + c["cy"]], -1) \
            + rng.normal(size=(M, 2)) * sigma[:, None]

    b = c["bf"] / c["fx"]
    x1l, x2l, x1r, x2r = (px(e, off) for off in (0.0, b) for e in ends)
    bad = rng.uniform(size=M) < 0.2
    for x in (x1l, x2l):
        x[bad] += rng.choice([-1, 1], (bad.sum(), 2)) \
            * rng.uniform(20, 40, (bad.sum(), 2))
    has_right = rng.uniform(size=M) < 0.7
    x1r[~has_right] = x2r[~has_right] = 0.0
    valid = rng.uniform(size=M) < 0.9
    if kind == "few":
        valid[:] = False
        valid[:4] = True
        x1l[:4], x2l[:4] = (px(e, 0.0)[:4] for e in ends)
    elif kind == "none":
        valid[:] = False
    return X0, d, x1l, x2l, x1r, x2r, octave.astype(np.int32), has_right, \
        valid


def pose_lm_inputs(rng, device, kinds=("mix",), N: int = 2048,
                   cfg: OrbConfig = OrbConfig(n_features=2000), M: int = 0):
    """(T_init (S, 4, 4) float32, (X, obs, inv_sigma2, is_stereo, valid)
    each with the leading S) for S = len(kinds) problems; the camera is
    KITTI_CAM. With M > 0 the rows of the joint point+line LM follow: the
    nine fields of a LinePoseObs, M line rows a problem seen from its true
    pose (`mix`: octaves 0-2, 0.5 px x 1.44^octave noise, 20% of the left
    observations 20-40 px off, 70% with a right observation, 90% valid;
    `few`: 4 valid rows; `none`: none valid)."""
    out, lines = [], []
    for kind in kinds:
        T, *problem = _pose_problem(rng, kind, N, cfg)
        out.append(problem)
        if M:
            lines.append(_line_rows(rng, kind, T, M))
    T0, X, obs, info, stereo, valid = (np.stack(a) for a in zip(*out))
    f32 = lambda x: _t(np.asarray(x, np.float32), device)
    rows = (f32(X), f32(obs), f32(info), _t(stereo, device),
            _t(valid, device))
    if M:
        X0, d, x1l, x2l, x1r, x2r, oc, hr, lv = (np.stack(a)
                                                 for a in zip(*lines))
        rows += (*map(f32, (X0, d, x1l, x2l, x1r, x2r)), _t(oc, device),
                 _t(hr, device), _t(lv, device))
    return f32(T0), rows
