"""The pose LM kernel's routing, input checks and schedule, on the CPU (the
kernel itself runs on the card: tests/test_torch_cuda.py).

- `optimize_pose` on CPU tensors, points only or with lines, runs the plain
  version (`optimize_pose_plain`) and launches nothing.
- `ops.pose_lm.pose_lm` raises on malformed inputs, point or line rows,
  before any launch.
- The kernel's schedule is the plain algorithm: one pass an iteration at the
  candidate pose that sums its cost, H and b together, the system carried
  on reject, and a round's reclassification fused with the next round's
  first system. A float64 emulation of that schedule gives the plain
  version's float64 bits, points only and with line rows.
"""
import numpy as np
import pytest
import torch

from lldslam_tpu_torch.geometry import se3
from lldslam_tpu_torch.geometry.camera import StereoCamera
from lldslam_tpu_torch.io import kernel_inputs
from lldslam_tpu_torch.ops import pose_lm
from lldslam_tpu_torch.optim import pose_opt, residuals as res

CAM = StereoCamera(**kernel_inputs.KITTI_CAM, width=1241, height=376)
KINDS = ("mix", "few", "none", "mix")


def _problem(seed, kinds=KINDS, N=512, dtype=torch.float32):
    T0, obs = kernel_inputs.pose_lm_inputs(np.random.default_rng(seed), "cpu",
                                           kinds, N=N)
    X, o, info, stereo, valid = obs
    return T0.to(dtype), pose_opt.PointPoseObs(
        X.to(dtype), o.to(dtype), info.to(dtype), stereo, valid)


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_call_takes_the_plain_path():
    """Batched and single problems on CPU tensors: the plain version's
    bits, and no launch."""
    T0, p = _problem(0)
    before = pose_lm.launches
    assert _equal(pose_opt.optimize_pose(CAM, T0, p, site="track"),
                  pose_opt.optimize_pose_plain(CAM, T0, p))
    one = pose_opt.PointPoseObs(*(t[0] for t in p))
    assert _equal(pose_opt.optimize_pose(CAM, T0[0], one, rounds=2, iters=3),
                  pose_opt.optimize_pose_plain(CAM, T0[0], one, rounds=2,
                                               iters=3))
    assert pose_lm.launches == before and "track" not in \
        pose_lm.launches_by_site


def test_call_with_lines_takes_the_plain_path(monkeypatch):
    """On CPU tensors the joint point+line LM never reaches the kernel's
    wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the joint point+line LM reached the kernel")
    monkeypatch.setattr(pose_lm, "pose_lm", refuse)
    T0, p = _problem(1, kinds=("mix",), N=256)
    one = pose_opt.PointPoseObs(*(t[0] for t in p))
    rng = np.random.default_rng(1)
    M = 6
    f = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    d = f(M, 3)
    lns = pose_opt.LinePoseObs(
        X0=f(M, 3) + torch.tensor([0.0, 0.0, 10.0]),
        d=d / d.norm(dim=-1, keepdim=True), x1_l=300 * f(M, 2) + 400,
        x2_l=300 * f(M, 2) + 400, x1_r=300 * f(M, 2) + 400,
        x2_r=300 * f(M, 2) + 400, octave=torch.zeros(M, dtype=torch.int32),
        has_right=torch.ones(M, dtype=torch.bool),
        valid=torch.ones(M, dtype=torch.bool))
    got = pose_opt.optimize_pose(CAM, T0[0], one, lns, rounds=2, iters=6)
    assert _equal(got, pose_opt.optimize_pose_plain(CAM, T0[0], one, lns,
                                                    rounds=2, iters=6))
    assert got[2].shape == (M,)


def _bad(case):
    """The arguments of one malformed call."""
    T0, p = _problem(2, kinds=("mix", "mix"), N=64)
    X, obs, info, stereo, valid = p
    kw = {}
    if case == "dtype":
        X = X.double()
    elif case == "shape":
        obs = obs[..., :2].contiguous()
    elif case == "sequences":
        T0 = T0[:1]
    elif case == "contiguity":
        X = X.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "flags":
        valid = valid.to(torch.uint8)
    elif case == "capacity":
        N = pose_lm.MAX_N + 1
        X, obs = torch.zeros(2, N, 3), torch.zeros(2, N, 3)
        info, stereo = torch.ones(2, N), torch.zeros(2, N, dtype=torch.bool)
        valid = torch.zeros(2, N, dtype=torch.bool)
    elif case == "rounds":
        kw = dict(rounds=-1)
    lines = ()
    if case.startswith("line_"):
        _, rows = kernel_inputs.pose_lm_inputs(np.random.default_rng(2),
                                               "cpu", ("mix", "mix"), N=64,
                                               M=16)
        lines = list(rows[5:])
        if case == "line_fields":
            lines = lines[:8]
        elif case == "line_octave":
            lines[6] = lines[6].long()
        elif case == "line_rows":
            lines[1] = lines[1][:, :8].contiguous()
        elif case == "line_capacity":
            M = pose_lm.MAX_N + 1
            lines = [torch.zeros((2, M) + t.shape[2:], dtype=t.dtype)
                     for t in lines]
    return (CAM, T0, X, obs, info, stereo, valid, *lines), kw


@pytest.mark.parametrize("case", ["dtype", "shape", "sequences", "contiguity",
                                  "flags", "capacity", "rounds", "device",
                                  "line_fields", "line_octave", "line_rows",
                                  "line_capacity", "line_device"])
def test_wrapper_rejects_malformed_inputs(case):
    """Each malformed call raises ValueError before any launch; so does a
    well-formed call on CPU tensors (the kernel takes CUDA tensors)."""
    args, kw = _bad(case)
    before = pose_lm.launches
    with pytest.raises(ValueError):
        pose_lm.pose_lm(*args, **kw)
    assert pose_lm.launches == before


def _kernel_schedule(cam, T0, p, rounds, iters):
    """The kernel's schedule in plain ops (see csrc/pose_lm.cu)."""
    dm, ds = res.CHI2_MONO, res.CHI2_STEREO
    eye6 = torch.eye(6, dtype=T0.dtype)
    inl = p.valid.to(torch.float32)
    T = T0
    H, b, cost, _ = pose_opt._point_terms(cam, T, p, inl, dm, ds)
    for _ in range(rounds):
        lam = torch.full(T.shape[:-2], 1e-5, dtype=T.dtype)
        for _ in range(iters):
            Hd = H + lam[..., None, None] * torch.diag_embed(
                torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-8 * eye6
            Tc = se3.exp(torch.linalg.solve_ex(Hd, b)[0]) @ T
            Hc, bc, cc, _ = pose_opt._point_terms(cam, Tc, p, inl, dm, ds)
            acc = cc < cost
            T = torch.where(acc[..., None, None], Tc, T)
            H = torch.where(acc[..., None, None], Hc, H)
            b = torch.where(acc[..., None], bc, b)
            cost = torch.where(acc, cc, cost)
            lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-9,
                              1e3)
        chi2 = pose_opt._point_terms(cam, T, p, p.valid.to(torch.float32), dm,
                                     ds, need_system=False)[3]
        th = torch.where(p.is_stereo, ds, dm)
        inl = (p.valid & (chi2 <= th)).to(torch.float32)
        H, b, cost, _ = pose_opt._point_terms(cam, T, p, inl, dm, ds)
    return T, inl > 0, inl.sum(-1).to(torch.int32)


def _kernel_schedule_lines(cam, T0, p, l, rounds, iters, gamma=0.5):
    """The kernel's schedule with line rows, in plain ops: the points' and
    the lines' terms summed into one system, both reclassified after each
    round."""
    dm, ds = res.CHI2_MONO, res.CHI2_STEREO
    eye6 = torch.eye(6, dtype=T0.dtype)
    pin, lin = p.valid.to(torch.float32), l.valid.to(torch.float32)

    def system(T):
        H, b, cost, _ = pose_opt._point_terms(cam, T, p, pin, dm, ds)
        Hl, bl, cl, _, _ = pose_opt._line_terms(cam, T, l, lin, gamma)
        return H + Hl, b + bl, cost + cl
    T = T0
    H, b, cost = system(T)
    for _ in range(rounds):
        lam = torch.full((), 1e-5, dtype=T.dtype)
        for _ in range(iters):
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            Tc = se3.exp(torch.linalg.solve_ex(Hd, b)[0]) @ T
            Hc, bc, cc = system(Tc)
            acc = cc < cost
            T = torch.where(acc, Tc, T)
            H, b = torch.where(acc, Hc, H), torch.where(acc, bc, b)
            cost = torch.where(acc, cc, cost)
            lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-9,
                              1e3)
        chi2 = pose_opt._point_terms(cam, T, p, p.valid.to(torch.float32), dm,
                                     ds, need_system=False)[3]
        pin = (p.valid & (chi2 <= torch.where(p.is_stereo, ds, dm))).to(
            torch.float32)
        _, _, _, chi2_l, th_l = pose_opt._line_terms(
            cam, T, l, l.valid.to(torch.float32), gamma, need_system=False)
        lin = (l.valid & (chi2_l <= 2.0 * th_l)).to(torch.float32)
        H, b, cost = system(T)
    return T, pin > 0, lin > 0, pin.sum(-1).to(torch.int32)


@pytest.mark.parametrize("kind", ["mix", "few", "none"])
def test_kernel_schedule_with_lines_is_the_plain_algorithm(kind):
    """The same in float64 with the line rows of the joint point+line LM
    (2 x 6, 256 line rows beside 512 point rows): the plain version's pose,
    point and line inliers and count bit for bit, on a mix of outliers, a
    problem of 8 point and 4 line rows and one with none."""
    T0, rows = kernel_inputs.pose_lm_inputs(np.random.default_rng(4), "cpu",
                                            (kind,), N=512, M=256)
    f64 = lambda t: t[0].double() if t.is_floating_point() else t[0]
    p = pose_opt.PointPoseObs(*map(f64, rows[:5]))
    l = pose_opt.LinePoseObs(*map(f64, rows[5:]))
    got = pose_opt.optimize_pose_plain(CAM, f64(T0), p, l, rounds=2, iters=6)
    assert _equal(got, _kernel_schedule_lines(CAM, f64(T0), p, l, 2, 6))
    moved = float((got[0] - f64(T0))[:3, 3].norm())
    assert (moved > 1e-3) == (kind != "none")
    n_lines = int(got[2].sum())
    if kind == "mix":
        assert 150 < n_lines < int(l.valid.sum()) and int(got[3]) > 300
    else:
        assert (n_lines, int(got[3])) == ({"few": (4, 8), "none": (0, 0)}
                                          [kind])


@pytest.mark.parametrize("rounds,iters", [(4, 10), (2, 6), (0, 10), (3, 0)])
def test_kernel_schedule_is_the_plain_algorithm(rounds, iters):
    """In float64, where both run the same ops on the same values, the
    kernel's schedule (one pass an iteration, the system carried on reject,
    reclassification fused with the next round's system) gives the plain
    version's pose, inliers and count bit for bit, on a mix of outliers, a
    problem of 8 valid rows and one with none."""
    T0, p = _problem(3, dtype=torch.float64)
    T, inl, _, n = pose_opt.optimize_pose_plain(CAM, T0, p, rounds=rounds,
                                                iters=iters)
    assert _equal((T, inl, n), _kernel_schedule(CAM, T0, p, rounds, iters))
    if rounds and iters:
        moved = (T - T0)[:, :3, 3].norm(dim=-1)
        assert (moved[[0, 1, 3]] > 1e-3).all() and moved[2] == 0
        assert (n[[0, 3]] > 300).all() and n[1] == 8 and n[2] == 0
