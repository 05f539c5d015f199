"""The generator: one seed gives the same frames and poses; the torch
ray-caster agrees with a numpy one; the stored detections repeat."""
from __future__ import annotations

import numpy as np
import torch

from benchlib import world

CAM = dict(fx=120.0, fy=120.0, cx=80.0, cy=24.0, bf=60.0, width=160,
           height=48)


def test_same_seed_same_frames_and_poses():
    a, ta, _ = world.render_sequence(CAM, 5, 1.0, 7, False, "cpu", False)
    b, tb, _ = world.render_sequence(CAM, 5, 1.0, 7, False, "cpu", False)
    c, _, _ = world.render_sequence(CAM, 5, 1.0, 8, False, "cpu", False)
    assert torch.equal(a, b) and np.array_equal(ta, tb)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and a.shape == (5, 2, 48, 160)


def test_poses_start_at_identity_and_stay_in_the_corridor():
    t_cw = world.poses(600, 1.2)
    assert np.allclose(t_cw[0], np.eye(4))
    c = np.stack([-t[:3, :3].T @ t[:3, 3] for t in t_cw])
    assert np.abs(c[:, 0]).max() < world.HALF_W - 4.0
    assert np.isclose(np.linalg.norm(c[1] - c[0]), 1.2, atol=1e-5)
    assert c[-1, 2] < world.corridor_length(600, 1.2) - 200.0


def _sample_np(tex, u, v):
    h, w = tex.shape
    u = np.clip(u, 0.0, w - 1.001)
    v = np.clip(v, 0.0, h - 1.001)
    u0, v0 = u.astype(np.int64), v.astype(np.int64)
    fu, fv = u - u0, v - v0
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)


def _render_np(cor, C, Rwc, rows):
    """The JAX bench's numpy ray-cast of the corridor, on some rows."""
    H, W = CAM["height"], CAM["width"]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    ys, xs = ys[rows], xs[rows]
    dx = (xs - CAM["cx"]) / CAM["fx"]
    dy = (ys - CAM["cy"]) / CAM["fy"]
    d = Rwc[:, 0][:, None, None] * dx + Rwc[:, 1][:, None, None] * dy \
        + Rwc[:, 2][:, None, None]
    img = np.full(dx.shape, 12.0, np.float32)
    best = np.full(dx.shape, np.inf, np.float32)
    L, hw, ch, top = cor.length, world.HALF_W, world.CAM_H, world.WALL_TOP
    tex = {k: getattr(cor, k).numpy() for k in
           ("ground", "wall_l", "wall_r", "end")}
    with np.errstate(divide="ignore", invalid="ignore"):
        for which in ("ground", "wl", "wr", "end"):
            denom = {"ground": d[1], "wl": d[0], "wr": d[0], "end": d[2]}[which]
            num = {"ground": ch - C[1], "wl": -hw - C[0], "wr": hw - C[0],
                   "end": L - C[2]}[which]
            tt = num / denom
            valid = (np.abs(denom) > 1e-9) & (tt > 0.25)
            X, Y, Z = C[0] + tt * d[0], C[1] + tt * d[1], C[2] + tt * d[2]
            if which == "ground":
                inside = (np.abs(X) <= hw) & (Z >= 0) & (Z <= L)
                u, v, t = Z, X + hw, tex["ground"]
            elif which in ("wl", "wr"):
                inside = (Y >= top) & (Y <= ch) & (Z >= 0) & (Z <= L)
                u, v = Z, Y - top
                t = tex["wall_l" if which == "wl" else "wall_r"]
            else:
                inside = (np.abs(X) <= hw) & (Y >= top) & (Y <= ch)
                u, v, t = X + hw, Y - top, tex["end"]
            hit = valid & inside & (tt < best)
            img[hit] = _sample_np(t, u[hit] * world.RES, v[hit] * world.RES)
            best[hit] = tt[hit]
    return img


def test_torch_render_matches_numpy_rows():
    cor = world.Corridor(CAM, 260.0, 11, True, "cpu")
    t_cw = world.poses(40, 1.0)
    rows = [0, 10, 23, 24, 40, 47]
    for k in (0, 17, 39):
        t_wc = np.linalg.inv(t_cw[k].astype(np.float64))
        r, c = t_wc[:3, :3].astype(np.float32), t_wc[:3, 3].astype(np.float32)
        got = cor.render(torch.from_numpy(c), torch.from_numpy(r)).numpy()[rows]
        want = _render_np(cor, c, r, rows)
        close = np.abs(got - want) <= 1e-3 * np.maximum(1.0, np.abs(want))
        assert close.mean() > 0.999, (k, np.abs(got - want).max())


def test_stored_lines_repeat(tmp_path):
    t_cw = world.poses(3, 1.0)
    cam = dict(CAM, width=1241, height=376, fx=718.856, fy=718.856,
               cx=607.1928, cy=185.2157, bf=386.1448)
    a = world.stored_lines(cam, t_cw, 240.0, 5, tmp_path / "a" / "l",
                           tmp_path / "a" / "r")
    b = world.stored_lines(cam, t_cw, 240.0, 5, tmp_path / "b" / "l",
                           tmp_path / "b" / "r")
    for (la, ra), (lb, rb) in zip(a, b):
        assert np.array_equal(la[0], lb[0]) and np.array_equal(ra[0], rb[0])
    za = np.load(tmp_path / "a" / "l" / "000001.npz")
    zb = np.load(tmp_path / "b" / "l" / "000001.npz")
    assert all(np.array_equal(za[k], zb[k]) for k in ("p1", "p2", "desc"))
    n = [len(ids[0]) for ids, _ in a]
    assert min(n) > 256    # more than the program's capacity, as in KITTI
