"""CPU parity of the port's line modules with the JAX package: line
geometry and residuals, the stored-line source and its generator, stereo
line matching, map-line association, the pose LM with line edges, the joint
point+line BA (dense, local schedule and CG), multi-view retriangulation and
the loop closer's line remap with its joint global BA.

Inputs are made with numpy from a seed (or by the JAX package's own
generators) and go through both packages on the CPU. Integer outputs
(matches, claims, masks) are held exactly. A 3D line is compared by its
closest point X0 and its direction up to sign: `eigh` chooses eigenvector
signs freely, so the direction and with it the minimal form q may flip
while the line stays the same. Float sums run in another order in the two
frameworks, so solver results are held to stated tolerances.
"""
from functools import partial
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from bench import _gen_stored_lines_ref_scale, _make_sequence  # noqa: E402
from test_lines_ba import CAM as LBA_CAM  # noqa: E402
from test_lines_ba import _make_problem  # noqa: E402
from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.frontend import line_match as jlm  # noqa: E402
from lldslam_tpu.geometry import lines as jgl  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.io import stored_lines as jsl  # noqa: E402
from lldslam_tpu.loop import closing as jcl  # noqa: E402
from lldslam_tpu.loop.bow import Vocabulary as JVocabulary  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.optim import lines_ba as jlb  # noqa: E402
from lldslam_tpu.optim import pose_opt as jpo  # noqa: E402
from lldslam_tpu.optim import residuals as jres  # noqa: E402
from lldslam_tpu.slammap.map_store import MapStore as JMapStore  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.config import CameraConfig, SlamConfig  # noqa: E402
from lldslam_tpu_torch.frontend import line_match as tlm  # noqa: E402
from lldslam_tpu_torch.geometry import lines as tgl  # noqa: E402
from lldslam_tpu_torch.geometry import se3 as tse3  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.io import stored_lines as tsl  # noqa: E402
from lldslam_tpu_torch.io.synthetic import (add_loop_lines,  # noqa: E402
                                            gen_stored_lines, make_loop_map)
from lldslam_tpu_torch.loop import closing as tcl  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.optim import lines_ba as tlb  # noqa: E402
from lldslam_tpu_torch.optim import pose_opt as tpo  # noqa: E402
from lldslam_tpu_torch.optim import residuals as tres  # noqa: E402

torch.set_num_threads(2)

CAM_CFG = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
               width=640, height=240)
JCAM = JCameraConfig(**CAM_CFG).stereo_camera()
CAM = StereoCamera(*JCAM)
RING_CFG = dict(fx=400.0, fy=400.0, cx=256.0, cy=192.0, bf=200.0, fps=10.0,
                width=512, height=384)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol, scale=None):
    """max |got - want| <= tol * scale, the scale max(1, max |want|) unless
    given."""
    got, want = _n(got).astype(np.float64), _n(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    if scale is None:
        scale = max(1.0, np.abs(want).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def _same_line(X0_t, d_t, X0_j, d_j, tol):
    """Closest points within tol x max(1, |X0|) (metres); directions equal
    up to sign within tol."""
    X0_t, d_t, X0_j, d_j = (_n(x).astype(np.float64)
                            for x in (X0_t, d_t, X0_j, d_j))
    scale = np.maximum(1.0, np.linalg.norm(X0_j, axis=-1, keepdims=True))
    assert (np.abs(X0_t - X0_j) / scale).max(initial=0.0) <= tol
    sign = np.where(np.sum(d_t * d_j, -1, keepdims=True) < 0, -1.0, 1.0)
    assert np.abs(sign * d_t - d_j).max(initial=0.0) <= tol


# ---------------------------------------------------------------------------
# geometry and residuals


def _seeded_lines(seed=0, n=64):
    """n lines in front of a camera at a random pose near the origin: world
    x0dir, pose, observed endpoints (noise 0.5 px) in both views."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.05, 3)])
    T = np.asarray(jse3.exp(jnp.asarray(xi.astype(np.float32))))
    T_wc = np.linalg.inv(T)
    mid_c = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 20, n)], -1)
    dc = rng.normal(size=(n, 3))
    dc /= np.linalg.norm(dc, axis=-1, keepdims=True)
    A_c, B_c = mid_c - 0.8 * dc, mid_c + 0.8 * dc
    A_c[:, 2] = np.maximum(A_c[:, 2], 2.0)
    B_c[:, 2] = np.maximum(B_c[:, 2], 2.0)
    to_w = lambda X: X @ T_wc[:3, :3].T + T_wc[:3, 3]
    A, B = to_w(A_c), to_w(B_c)
    d = (B - A) / np.linalg.norm(B - A, axis=-1, keepdims=True)
    X0 = A - np.sum(A * d, -1, keepdims=True) * d

    def px(X, off=0.0):
        Xc = X @ T[:3, :3].T + T[:3, 3] - np.array([off, 0, 0])
        return np.stack([CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx,
                         CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy], -1) \
            + rng.normal(0, 0.5, (n, 2))

    f = lambda a: np.asarray(a, np.float32)
    return dict(T=f(T), X0=f(X0), d=f(d), P=f(A), x1=f(px(A)), x2=f(px(B)),
                x1r=f(px(A, CAM.baseline)), x2r=f(px(B, CAM.baseline)))


def _geometry_case(op, s):
    """(port outputs, JAX outputs) of one geometry/residual function."""
    j = {k: jnp.asarray(v) for k, v in s.items()}
    t = {k: _t(v) for k, v in s.items()}
    q_j, a_j = jgl.minimal_from_x0dir(j["X0"], j["d"])
    q_t, a_t = _t(np.asarray(q_j)), _t(np.asarray(a_j))
    if op == "line_eq":
        return ([tgl.line_eq_from_endpoints(t["x1"], t["x2"]),
                 tgl.point_line_distance(tgl.line_eq_from_endpoints(
                     t["x1"], t["x2"]), t["x1r"])],
                [jgl.line_eq_from_endpoints(j["x1"], j["x2"]),
                 jgl.point_line_distance(jgl.line_eq_from_endpoints(
                     j["x1"], j["x2"]), j["x1r"])])
    if op == "closest_point":
        return (tgl.closest_point_form(t["P"], 3.0 * t["d"]),
                jgl.closest_point_form(j["P"], 3.0 * j["d"]))
    if op == "minimal":
        qt, at = tgl.minimal_from_x0dir(t["X0"], t["d"])
        return ([qt, at, *tgl.x0dir_from_minimal(qt, at)],
                [q_j, a_j, *jgl.x0dir_from_minimal(q_j, a_j)])
    if op == "transform":
        return (tgl.transform_line(t["T"], t["X0"], t["d"]),
                jgl.transform_line(j["T"], j["X0"], j["d"]))
    if op == "project":
        return ([tgl.project_line(CAM, t["T"], t["X0"], t["d"])],
                [jgl.project_line(JCAM, j["T"], j["X0"], j["d"])])
    if op == "endpoint_residual":
        return ([tgl.endpoint_residual(CAM, t["T"], t["X0"], t["d"], t["x1"],
                                       t["x2"])],
                [jgl.endpoint_residual(JCAM, j["T"], j["X0"], j["d"], j["x1"],
                                       j["x2"])])
    if op == "right_camera":
        return ([tgl.right_camera_pose(t["T"], CAM.baseline)],
                [jgl.right_camera_pose(j["T"], JCAM.baseline)])
    if op == "plane_normal":
        Tb = np.stack([s["T"]] * len(s["x1"]))
        return (tgl.plane_normal_from_obs(CAM, _t(Tb), t["x1"], t["x2"]),
                jgl.plane_normal_from_obs(JCAM, jnp.asarray(Tb), j["x1"],
                                          j["x2"]))
    if op == "line_residual":
        return ([tres.line_residual(CAM, t["T"], q_t, a_t, t["x1r"],
                                    t["x2r"])],
                [jres.line_residual(JCAM, j["T"], q_j, a_j, j["x1r"],
                                    j["x2r"])])
    if op == "line_jacobians":
        # the JAX function differentiates the whole batch at once: its
        # per-observation Jacobians are the diagonal blocks
        Tb = np.stack([s["T"]] * len(s["x1"]))
        Jp, Jl = jres.line_jacobians(JCAM, jnp.asarray(Tb), q_j, a_j, j["x1"],
                                     j["x2"])
        diag = lambda J: np.einsum("iaib->iab", np.asarray(J))
        return (tres.line_jacobians(CAM, _t(Tb), q_t, a_t, t["x1"], t["x2"]),
                [diag(Jp), diag(Jl)])
    raise AssertionError(op)


@pytest.mark.parametrize("op", [
    "line_eq", "closest_point", "minimal", "transform", "project",
    "endpoint_residual", "right_camera", "plane_normal", "line_residual",
    "line_jacobians"])
def test_line_geometry_matches_jax(op):
    """Each function of geometry/lines.py and the line half of
    optim/residuals.py on 64 seeded lines: within 1e-5 of the JAX result
    relative to each output's magnitude. Outputs in pixels that are
    differences of image-scale terms (a line equation's offset times a
    pixel coordinate, cancelling to a residual of a pixel or less) are held
    relative to the image width instead, and the Jacobians to 1e-4 (a
    chain of float32 products through the projection)."""
    got, want = _geometry_case(op, _seeded_lines())
    assert len(got) == len(want)
    pixel = op in ("line_eq", "endpoint_residual", "line_residual",
                   "line_jacobians")
    for g, w in zip(got, want):
        _close(g, w, 1e-4 if op == "line_jacobians" else 1e-5,
               scale=float(CAM.width) if pixel and _n(w).ndim > 1
               and op != "line_eq" else None)


def test_triangulate_multi_view_matches_jax():
    """Multi-view triangulation from 2-8 planes per line (left and right
    cameras of keyframes along a baseline), some rows masked out: the same
    `ok` mask, X0 within 1e-4 relative and d within 1e-4 up to sign where
    ok (the null space of a float32 4x4 Gram matrix)."""
    rng = np.random.default_rng(4)
    s = _seeded_lines(seed=4, n=48)
    n, V = 48, 8
    normals, centers = [], []
    for v in range(V // 2):
        T = s["T"].copy()
        T[:3, 3] -= np.array([0.3 * v, 0.05 * v, 0.4 * v], np.float32)
        A, B = s["X0"] - 1.5 * s["d"], s["X0"] + 1.5 * s["d"]
        for off in (0.0, CAM.baseline):
            Tc = T.copy()
            Tc[0, 3] -= off
            Ac, Bc = (X @ Tc[:3, :3].T + Tc[:3, 3] for X in (A, B))
            px = lambda X: np.stack([CAM.fx * X[:, 0] / X[:, 2] + CAM.cx,
                                     CAM.fy * X[:, 1] / X[:, 2] + CAM.cy],
                                    -1) + rng.normal(0, 0.3, (n, 2))
            nw, cw = jgl.plane_normal_from_obs(
                JCAM, jnp.asarray(np.stack([Tc] * n)),
                jnp.asarray(px(Ac).astype(np.float32)),
                jnp.asarray(px(Bc).astype(np.float32)))
            normals.append(np.asarray(nw))
            centers.append(np.asarray(cw))
    normals = np.stack(normals, 1).astype(np.float32)
    centers = np.stack(centers, 1).astype(np.float32)
    mask = rng.uniform(size=(n, V)) < 0.7
    mask[:4] = False
    mask[4:8, 2:] = False                      # two planes: one stereo pair
    X0_j, d_j, ok_j = jgl.triangulate_multi_view(
        jnp.asarray(normals), jnp.asarray(centers), jnp.asarray(mask))
    X0_t, d_t, ok_t = tgl.triangulate_multi_view(_t(normals), _t(centers),
                                                 _t(mask))
    ok = np.asarray(ok_j)
    assert np.array_equal(_n(ok_t), ok) and ok.sum() >= 40
    _same_line(_n(X0_t)[ok], _n(d_t)[ok], np.asarray(X0_j)[ok],
               np.asarray(d_j)[ok], 1e-4)


# ---------------------------------------------------------------------------
# stored lines and the line world


def test_stored_line_source_matches_jax(tmp_path):
    """An over-capacity frame (300 lines, cap 256, ties in length), a short
    frame and a missing one through both packages' StoredLineSource: every
    array bitwise equal, the same cap_events and cap_dropped; the staged
    pair equals the two single-view loads."""
    rng = np.random.default_rng(7)
    for fid, n in ((0, 300), (1, 90)):
        p1 = rng.uniform(0, 600, (n, 2)).astype(np.float32)
        ln = rng.choice([20.0, 40.0, 60.0, 80.0], n).astype(np.float32)
        p2 = p1 + np.stack([ln, np.zeros(n, np.float32)], -1)
        for d in ("l", "r"):
            tsl.save_frame_lines(tmp_path / d, fid, p1, p2,
                                 rng.integers(0, 3, n),
                                 rng.normal(size=(n, 40)),
                                 valid=rng.uniform(size=n) < 0.95)
    j = jsl.StoredLineSource(tmp_path / "l", cap=256, desc_dim=40)
    t = tsl.StoredLineSource(tmp_path / "l", cap=256, desc_dim=40)
    for fid in (0, 1, 2):
        kl = t.frame(fid, device="cpu")
        for a, b in zip(kl, j._frame_np(fid)):
            assert a.dtype == torch.from_numpy(b).dtype
            assert np.array_equal(_n(a), b)
    assert (t.cap_events, t.cap_dropped) == (j.cap_events, j.cap_dropped)
    assert t.cap_events == 1 and t.cap_dropped > 0
    tr = tsl.StoredLineSource(tmp_path / "r", cap=256, desc_dim=40)
    kl, kr = tsl.stage_stored_pair(t, tr, 0, device="cpu")
    for got, src in ((kl, t), (kr, tr)):
        for a, b in zip(got, src.frame(0, device="cpu")):
            assert torch.equal(a, b)
    assert tr.cap_events == 2


@pytest.fixture(scope="module")
def line_world(tmp_path_factory):
    """Six frames of the seed-3 line corridor (tests/test_torch_system.py's
    camera) with stored detections written by bench.py's generator."""
    tmp = tmp_path_factory.mktemp("line_world")
    _, poses, world = _make_sequence(JCAM, 6, n_per_m=25.0, seed=3,
                                     with_lines=True, return_poses=True)
    _gen_stored_lines_ref_scale(JCAM, poses, world, str(tmp / "l"),
                                str(tmp / "r"))
    src = [jsl.StoredLineSource(tmp / d, cap=256, desc_dim=40)
           for d in ("l", "r")]

    def fl(fid):
        kl, kr = (jsl.StoredLineSource(tmp / d, 256, 40)._frame_np(fid)
                  for d in ("l", "r"))
        return kl, kr

    return dict(tmp=tmp, poses=poses, world=world, src=src, frame=fl)


def _key_lines(arrays, port: bool):
    names = ("p1", "p2", "octave", "length", "desc", "valid")
    if port:
        return interop.key_lines(dict(zip(names, arrays)))
    from lldslam_tpu.frontend.line_extract import KeyLines as JKeyLines
    return JKeyLines(*(jnp.asarray(a) for a in arrays))


def test_gen_stored_lines_matches_bench(line_world, tmp_path):
    """io.synthetic.gen_stored_lines, the numpy copy the card's machine
    runs, writes the files bench.py's generator writes, array for array."""
    counts = gen_stored_lines(CAM, line_world["poses"], line_world["world"],
                              tmp_path / "l", tmp_path / "r")
    assert len(counts) == 6 and min(counts) > 100
    for d in ("l", "r"):
        for fid in range(6):
            a = np.load(tmp_path / d / f"{fid:06d}.npz")
            b = np.load(line_world["tmp"] / d / f"{fid:06d}.npz")
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (d, fid, k)


def _stereo(line_world, fid):
    kl, kr = line_world["frame"](fid)
    j = jlm.match_stereo_lines(JCAM, _key_lines(kl, False),
                               _key_lines(kr, False), md_thr=0.6,
                               min_len=25.0)
    t = tlm.match_stereo_lines(CAM, _key_lines(kl, True),
                               _key_lines(kr, True), md_thr=0.6,
                               min_len=25.0)
    return j, t


def test_match_stereo_lines_matches_jax(line_world):
    """One frame of the line world: r_idx and has_stereo exact, the
    triangulated lines (X0, +-d) within 1e-4, the right endpoints equal."""
    for fid in (1, 4):
        j, t = _stereo(line_world, fid)
        hs = np.asarray(j.has_stereo)
        assert hs.sum() >= 100
        assert np.array_equal(_n(t.has_stereo), hs)
        assert np.array_equal(_n(t.r_idx), np.asarray(j.r_idx))
        _same_line(_n(t.X0)[hs], _n(t.d)[hs], np.asarray(j.X0)[hs],
                   np.asarray(j.d)[hs], 1e-4)
        for a, b in ((t.p1_r, j.p1_r), (t.p2_r, j.p2_r)):
            assert np.array_equal(_n(a), np.asarray(b))


def _map_lines(line_world, fid=1, n_dup=12, cap=320):
    """Map lines from one frame's stereo lines in the world frame (true
    pose), the first n_dup duplicated (same geometry and descriptor, so two
    map lines tie for one detection), padded with invalid rows to cap."""
    j, _ = _stereo(line_world, fid)
    hs = np.nonzero(np.asarray(j.has_stereo))[0]
    T_wc = np.linalg.inv(line_world["poses"][fid])
    X0c, dc = np.asarray(j.X0)[hs], np.asarray(j.d)[hs]
    P = X0c @ T_wc[:3, :3].T + T_wc[:3, 3]
    d = dc @ T_wc[:3, :3].T
    X0 = P - np.sum(P * d, -1, keepdims=True) * d
    desc = np.asarray(j.kl.desc)[hs]
    oct_ = np.asarray(j.kl.octave)[hs]
    sel = np.concatenate([np.arange(len(hs)), np.arange(n_dup)])
    m = len(sel)
    pad = lambda a, fill=0: np.concatenate(
        [a[sel], np.full((cap - m,) + a.shape[1:], fill, a.dtype)])
    return dict(X0=pad(X0.astype(np.float32)), d=pad(d.astype(np.float32), 1),
                desc=pad(desc), oct=pad(oct_),
                valid=np.arange(cap) < m)


def test_associate_lines_matches_jax(line_world):
    """Map lines from frame 1 associated with frame 2's stereo lines at a
    pose 2 cm off the true one: ln2det and det2ln exact, the duplicated map
    lines resolved to the lower index as in JAX, also on the JAX
    FrameLines carried over by `interop.frame_lines`."""
    ml = _map_lines(line_world)
    T = line_world["poses"][2].copy()
    T[:3, 3] += np.array([0.02, -0.01, 0.015], np.float32)
    j, t = _stereo(line_world, 2)
    lj, dj = jlm.associate_lines(JCAM, jnp.asarray(T), jnp.asarray(ml["X0"]),
                                 jnp.asarray(ml["d"]), jnp.asarray(ml["desc"]),
                                 jnp.asarray(ml["oct"]),
                                 jnp.asarray(ml["valid"]), j, md_thr=0.6)
    lt, dt = tlm.associate_lines(CAM, _t(T), _t(ml["X0"]), _t(ml["d"]),
                                 _t(ml["desc"]), _t(ml["oct"]),
                                 _t(ml["valid"]), t, md_thr=0.6)
    assert np.array_equal(_n(lt), np.asarray(lj))
    assert np.array_equal(_n(dt), np.asarray(dj))
    assert (np.asarray(dj) >= 0).sum() >= 60
    # the JAX FrameLines carried over by interop: the same association
    lt2, dt2 = tlm.associate_lines(CAM, _t(T), _t(ml["X0"]), _t(ml["d"]),
                                   _t(ml["desc"]), _t(ml["oct"]),
                                   _t(ml["valid"]), interop.frame_lines(j),
                                   md_thr=0.6)
    assert torch.equal(lt2, lt) and torch.equal(dt2, dt)


def _pose_scene(seed=5, N=300, M=160):
    """Points and lines seen from a known pose (noise 0.5 px, 8% gross
    outliers each), octaves 0-2, a quarter of the lines mono; the LM starts
    5 cm / 0.01 rad off."""
    rng = np.random.default_rng(seed)
    s = _seeded_lines(seed, M)
    T = s["T"]
    Tw = np.linalg.inv(T)
    Xc = np.stack([rng.uniform(-6, 6, N), rng.uniform(-2, 2, N),
                   rng.uniform(3, 25, N)], -1)
    X = Xc @ Tw[:3, :3].T + Tw[:3, 3]
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    obs = np.stack([u, v, u - CAM.bf / Xc[:, 2]], -1) \
        + rng.normal(0, 0.5, (N, 3))
    obs[rng.uniform(size=N) < 0.08] += rng.uniform(15, 40, 3)
    is_st = rng.uniform(size=N) < 0.8
    obs[~is_st, 2] = -1.0
    lut = np.power(1.0 / 1.2 ** 2, np.arange(8)).astype(np.float32)
    pts = dict(X=X.astype(np.float32), obs=obs.astype(np.float32),
               inv_sigma2=lut[rng.integers(0, 3, N)], is_stereo=is_st,
               valid=rng.uniform(size=N) < 0.95)
    bad = rng.uniform(size=M) < 0.08
    for k in ("x1", "x2"):
        s[k][bad] += rng.uniform(20, 40, (bad.sum(), 2)).astype(np.float32)
    has_r = rng.uniform(size=M) < 0.75
    lns = dict(X0=s["X0"], d=s["d"], x1_l=s["x1"], x2_l=s["x2"],
               x1_r=np.where(has_r[:, None], s["x1r"], 0).astype(np.float32),
               x2_r=np.where(has_r[:, None], s["x2r"], 0).astype(np.float32),
               octave=rng.integers(0, 3, M).astype(np.int32), has_right=has_r,
               valid=rng.uniform(size=M) < 0.95)
    xi = np.array([0.05, -0.03, 0.04, 0.01, -0.008, 0.006], np.float32)
    T0 = np.asarray(jse3.exp(jnp.asarray(xi))) @ T
    return T0.astype(np.float32), pts, lns


def _f64(rows):
    """A PointPoseObs or LinePoseObs with its float fields in float64."""
    return type(rows)(*(t.double() if t.is_floating_point() else t
                        for t in rows))


def _jax64(fn, *args):
    """fn of the JAX package in float64 (x64 enabled for the call) on numpy
    copies of torch tensors, back as torch float64."""
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(_n(a)) if torch.is_tensor(a) else a
                   for a in args))
        if isinstance(out, tuple):
            return tuple(torch.tensor(np.asarray(o), dtype=torch.float64)
                         for o in out)
        return torch.tensor(np.asarray(out), dtype=torch.float64)


def _joint_residuals(T, p, l):
    """The joint pose step's residuals at T, by the JAX package's own
    functions in float64: points (N, 3), left and right line views (M, 2)
    each."""
    def res(T, X, obs, X0, d, x1l, x2l, x1r, x2r):
        Tr = jgl.right_camera_pose(T, JCAM.baseline)
        return (jres.point_residual_stereo(JCAM, T, X, obs),
                jgl.endpoint_residual(JCAM, T, X0, d, x1l, x2l),
                jgl.endpoint_residual(JCAM, Tr, X0, d, x1r, x2r))
    return _jax64(res, T, p.X, p.obs, l.X0, l.d, l.x1_l, l.x2_l, l.x1_r,
                  l.x2_r)


def _joint_weights(rs, p, l, pt_in, ln_in, gamma=0.5):
    """Each residual block's (chi2, information, Huber delta, active) in the
    joint step's stated cost (the JAX package's thresholds)."""
    rp, rl, rr = rs
    st = p.is_stereo.to(rp.dtype)
    info_l = gamma ** 2 / 1.44 ** (2.0 * l.octave.to(rp.dtype))
    d_l = torch.where(l.has_right, jres.CHI2_STEREO * gamma ** 2,
                      jres.CHI2_MONO * gamma ** 2)
    row_w = torch.stack([torch.ones_like(st), torch.ones_like(st), st], -1)
    return [(p.inv_sigma2 * (rp * rp * row_w).sum(-1), p.inv_sigma2[:, None]
             * row_w, torch.where(p.is_stereo, jres.CHI2_STEREO,
                                  jres.CHI2_MONO), pt_in),
            (info_l * (rl * rl).sum(-1), info_l[:, None].expand_as(rl), d_l,
             ln_in),
            (info_l * (rr * rr).sum(-1), info_l[:, None].expand_as(rr), d_l,
             ln_in * l.has_right.to(rp.dtype))]


def _joint_cost(T, p, l, pt_in, ln_in):
    """The joint pose step's stated cost at T: the JAX package's Huber cost
    of the active point edges and of both views of the active lines."""
    return sum((_jax64(jres.huber_rho, c, d) * a).sum() for c, _, d, a in
               _joint_weights(_joint_residuals(T, p, l), p, l, pt_in, ln_in))


def _joint_cost_minimum(T, p, l, pt_in, ln_in, iters=40, h=1e-6):
    """The float64 minimum of `_joint_cost` over fixed inlier sets, from T:
    Levenberg-Marquardt on the Huber IRLS system of the JAX package's
    residuals, with central-difference Jacobians along the left pose's
    increment (none of either package's analytic Jacobians)."""
    E = torch.eye(6, dtype=torch.float64)
    cost = _joint_cost(T, p, l, pt_in, ln_in)
    lam = 1e-5
    for _ in range(iters):
        rs = _joint_residuals(T, p, l)
        plus = [_joint_residuals(tse3.exp(h * E[i]) @ T, p, l)
                for i in range(6)]
        minus = [_joint_residuals(tse3.exp(-h * E[i]) @ T, p, l)
                 for i in range(6)]
        H = torch.zeros(6, 6, dtype=torch.float64)
        g = torch.zeros(6, dtype=torch.float64)
        for k, (c, info, d, a) in enumerate(_joint_weights(rs, p, l, pt_in,
                                                           ln_in)):
            J = torch.stack([(plus[i][k] - minus[i][k]) / (2 * h)
                             for i in range(6)], -1)
            w = info * (_jax64(jres.huber_weight, c, d) * a)[:, None]
            H = H + torch.einsum("nri,nr,nrj->ij", J, w, J)
            g = g + torch.einsum("nri,nr,nr->i", J, w, rs[k])
        while lam < 1e6:
            dx = -torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H)),
                                     g)
            T_new = tse3.exp(dx) @ T
            c_new = _joint_cost(T_new, p, l, pt_in, ln_in)
            if c_new < cost:
                T, cost, lam = T_new, c_new, max(0.5 * lam, 1e-12)
                break
            lam *= 4.0
        else:
            break
    return T


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _pose_problem64():
    """`_pose_scene` in float64, with the inlier sets of the step's second
    round (its first round's reclassification) and the float64 minimum of
    the stated cost over them."""
    T0, pts, lns = _pose_scene()
    T0 = _t(T0).double()
    p = _f64(tpo.PointPoseObs(**{k: _t(v) for k, v in pts.items()}))
    l = _f64(interop.line_pose_obs(lns))
    _, pt_in, ln_in, _ = tpo.optimize_pose_plain(CAM, T0, p, l, rounds=1,
                                                 iters=6)
    best = _joint_cost_minimum(T0, p, l, pt_in.double(), ln_in.double())
    return T0, p, l, best


def test_right_view_line_jacobian_matches_central_differences():
    """The right view's analytic line Jacobian (`line_pose_jacobian` with
    the baseline) is the derivative of its endpoint residual at T_rl T
    along the left pose's increment exp(xi) T: central differences in
    float64 agree within 1e-4 relative."""
    s = _seeded_lines(3)
    T, X0, d, x1, x2 = (_t(s[k]).double() for k in ("T", "X0", "d", "x1r",
                                                   "x2r"))
    J = tres.line_pose_jacobian(CAM, T, X0, d, x1, x2, CAM.baseline)
    h, E = 1e-6, torch.eye(6, dtype=torch.float64)
    right = lambda Tl: tgl.endpoint_residual(
        CAM, tgl.right_camera_pose(Tl, CAM.baseline), X0, d, x1, x2)
    Jn = torch.stack([(right(tse3.exp(h * E[i]) @ T)
                       - right(tse3.exp(-h * E[i]) @ T)) / (2 * h)
                      for i in range(6)], -1)
    scale = Jn.abs().amax(dim=(-1, -2), keepdim=True)
    assert float(((J - Jn).abs() / scale).max()) <= 1e-4
    # the right camera's own increment (the JAX package's) is another
    # derivative: off by the baseline's lever arm
    J_own = tres.line_pose_jacobian(
        CAM, tgl.right_camera_pose(T, CAM.baseline), X0, d, x1, x2)
    assert float(((J_own - Jn).abs() / scale).max()) > 1e-2


def test_joint_pose_lm_reaches_its_cost_minimum_in_float64():
    """The joint point+line pose LM of the line step (2 rounds x 6
    iterations), op by op in float64, hands back the float64 minimum of
    its stated cost over the second round's inliers (each view of a line
    an edge), found by LM with central-difference Jacobians: camera centres
    within 1e-8 m."""
    T0, p, l, best = _pose_problem64()
    T, _, _, _ = tpo.optimize_pose_plain(CAM, T0, p, l, rounds=2, iters=6)
    assert float((_centre(T) - _centre(best)).norm()) <= 1e-8
    assert float((_centre(T0) - _centre(best)).norm()) > 1e-2


def test_optimize_pose_with_lines_matches_jax():
    """The joint point+line pose LM of the tracker's line step (2 rounds x
    6 iterations, line inliers at twice the threshold), against the JAX
    package's. A documented divergence (ROADMAP.md): the port takes the
    right view's Jacobian along the left pose's increment, JAX along the
    right camera's own, so JAX's step stops short of the minimum of its
    cost. The pose is held instead to the float64 minimum of that cost,
    built from the JAX package's own residuals, thresholds and Huber kernel
    in float64 (entries within 2e-6: the port's float32 reads 6.2e-7 there,
    JAX's and the port's before the repair 4.1e-6); point and line inlier
    masks equal JAX's exactly."""
    T0, pts, lns = _pose_scene()
    Tj, pj, lj, nj = jpo.optimize_pose(
        JCAM, jnp.asarray(T0),
        jpo.PointPoseObs(**{k: jnp.asarray(v) for k, v in pts.items()}),
        jpo.LinePoseObs(**{k: jnp.asarray(v) for k, v in lns.items()}),
        gamma=0.5, rounds=2, iters=6)
    Tt, pt, lt, nt = tpo.optimize_pose(
        CAM, _t(T0), tpo.PointPoseObs(**{k: _t(v) for k, v in pts.items()}),
        interop.line_pose_obs(lns), gamma=0.5, rounds=2, iters=6)
    _, _, _, best = _pose_problem64()
    np.testing.assert_allclose(_n(Tt), _n(best), rtol=0, atol=2e-6)
    assert np.array_equal(_n(pt), np.asarray(pj))
    assert np.array_equal(_n(lt), np.asarray(lj))
    assert int(nt) == int(nj)
    lin = np.asarray(lj)
    assert 0.7 * lns["valid"].sum() < lin.sum() < lns["valid"].sum()


# ---------------------------------------------------------------------------
# joint point+line BA


def _ba_problem(kind):
    rng = np.random.default_rng({"dense": 0, "local": 1, "cg": 2}[kind])
    problem, poses_gt, *_ = _make_problem(rng)
    if kind == "local":
        # 20% of the line observations corrupted: the outlier schedule
        lo = problem.lobs
        bad = rng.uniform(size=lo.x1l.shape[0]) < 0.2
        shift = lambda a: jnp.asarray(np.asarray(a) + bad[:, None] * rng.uniform(
            30, 60, (len(bad), 2)).astype(np.float32))
        problem = problem._replace(lobs=lo._replace(x1l=shift(lo.x1l),
                                                    x2l=shift(lo.x2l)))
    return problem, poses_gt


@pytest.mark.parametrize("kind", ["dense", "local", "cg"])
def test_joint_ba_matches_jax(kind):
    """tests/test_lines_ba.py's problem (6 keyframes, 60 points, 12 lines,
    both views) through `joint_ba_solve` (8 iterations), `local_joint_ba`
    (with 20% corrupted line observations) and `joint_ba_solve_cg` (8 x 32
    CG): poses within 1e-4 m / 1e-4 (rotation entries), points within
    1e-3 m, lines (X0, +-d) within 1e-3 relative (for the local schedule,
    the lines that keep two or more observations), keep masks equal; the
    solution within test_lines_ba's bounds of the truth."""
    problem, poses_gt = _ba_problem(kind)
    tp = interop.joint_problem(problem)
    gamma = 0.5
    if kind == "dense":
        sj, *_ = jlb.joint_ba_solve(LBA_CAM, problem, iters=8)
        st, *_ = tlb.joint_ba_solve(StereoCamera(*LBA_CAM), tp, iters=8)
    elif kind == "local":
        sj, kpj, klj = jlb.local_joint_ba(LBA_CAM, problem, gamma)
        st, kpt, klt = tlb.local_joint_ba(StereoCamera(*LBA_CAM), tp, gamma)
        assert np.array_equal(_n(kpt), np.asarray(kpj))
        assert np.array_equal(_n(klt), np.asarray(klj))
        assert (~np.asarray(klj)).sum() >= 5
    else:
        sj, *_ = jlb.joint_ba_solve_cg(LBA_CAM, problem, iters=8, cg_iters=32)
        st, *_ = tlb.joint_ba_solve_cg(StereoCamera(*LBA_CAM), tp, iters=8,
                                       cg_iters=32)
    Pj, Pt = np.asarray(sj.base.poses), _n(st.base.poses)
    np.testing.assert_allclose(Pt[:, :3, :], Pj[:, :3, :], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_n(st.base.points), np.asarray(sj.base.points),
                               rtol=0, atol=1e-3)
    X0j, dj = jgl.x0dir_from_minimal(sj.q, sj.alpha)
    X0t, dt = tgl.x0dir_from_minimal(st.q, st.alpha)
    # a line whose every observation the local schedule dropped keeps the
    # state of its first five iterations and constrains nothing after
    held = np.ones(len(np.asarray(sj.q)), bool) if kind != "local" else \
        np.bincount(np.asarray(problem.lobs.l)[np.asarray(klj)],
                    minlength=len(np.asarray(sj.q))) >= 2
    assert held.sum() >= 8
    _same_line(_n(X0t)[held], _n(dt)[held], np.asarray(X0j)[held],
               np.asarray(dj)[held], 1e-3)
    assert np.isfinite(_n(X0t)).all() and np.isfinite(_n(dt)).all()
    err = np.linalg.norm(Pt[:, :3, 3] - poses_gt[:, :3, 3], axis=-1)
    assert err.max() < 5e-3, err


# ---------------------------------------------------------------------------
# the map store and the loop closer


def _loop_stores(lines: bool = True):
    """make_loop_map's drifting circle (plus add_loop_lines' map lines) in
    a JAX MapStore, and the port's copy of it."""
    cc = JCameraConfig(**RING_CFG)
    js = JMapStore(cc.stereo_camera(), JOrbConfig(n_features=600), max_kf=64,
                   max_pt=20000)
    gt = make_loop_map(js)
    if lines:
        add_loop_lines(js, gt)
    cfg = SlamConfig(camera=CameraConfig(**RING_CFG),
                     orb=OrbConfig(n_features=600))
    ts = interop.map_store(js, cfg.camera.stereo_camera(), cfg.orb)
    return js, ts, gt, cfg


def test_retriangulate_lines_matches_jax():
    """Multi-view retriangulation of the lines the newest keyframe observes
    (>= 2 keyframe observations each) on the seeded loop map, the JAX
    package's staged solve absorbed at once: every map line within 1e-3 m
    (X0, at 18-45 m) and 1e-4 (direction, whose sign the store keeps) of
    the JAX result, and the refined lines moved."""
    js, ts, _, _ = _loop_stores()
    before = ts.ln_x0[:ts.n_ln].copy()
    js.retriangulate_lines()
    js.absorb_retriangulate(keep=0)
    ts.retriangulate_lines(device="cpu")
    n = ts.n_ln
    moved = np.linalg.norm(ts.ln_x0[:n] - before, axis=-1) > 1e-3
    assert moved.sum() >= 10, moved.sum()
    np.testing.assert_allclose(ts.ln_x0[:n], js.ln_x0[:n], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.ln_dir[:n], js.ln_dir[:n], rtol=0,
                               atol=1e-4)


def test_loop_correct_remaps_lines_like_jax(monkeypatch):
    """`_correct` on the loop map with lines (keyframe 21 revisits keyframe
    2, S_cm from the true poses, no guided matches). The port replays the
    JAX essential-graph solution (the pose graph's own parity is
    tests/test_torch_loop.py's), so what is compared is the line half: the
    map lines after the remap within 1e-4 relative of the JAX result, and
    after the joint point+line global BA (lines with >= 4 stereo-weighted
    observations) keyframe poses within 1e-3 m, lines within 1e-3 relative
    (median 1e-4), every line state finite and moved by the BA."""
    js, ts, gt, cfg = _loop_stores()
    descs = js.kf_desc[:4][js.kf_kp_valid[:4]]
    jv = JVocabulary.train(descs, k=8, L=3, seed=0)
    jcfg = JSlamConfig(camera=JCameraConfig(**RING_CFG),
                       orb=JOrbConfig(n_features=600))
    jlc = jcl.LoopCloser(js, jv, jcfg)
    tlc = tcl.LoopCloser(ts, interop.vocabulary(jv), cfg, device="cpu")
    remapped, solved = {}, {}

    def wrap(name, lc, ba):
        def run():
            s = lc.store
            remapped[name] = (s.ln_x0[:s.n_ln].copy(), s.ln_dir[:s.n_ln].copy())
            ba()
        return run

    jlc.global_ba = wrap("jax", jlc, partial(jlc.global_ba, force_dist=False))
    tlc.global_ba = wrap("port", tlc, tlc.global_ba)
    jpg_solve = jcl.pose_graph.optimize_pose_graph

    def record(g, **kw):
        solved["g"] = out = jpg_solve(g, **kw)
        return out

    def replay(g, **kw):
        # the JAX graph is padded to a capacity bucket
        o, K = solved["g"], g.R.shape[0]
        return g._replace(R=_t(np.asarray(o.R)[:K]), t=_t(np.asarray(o.t)[:K]),
                          s=_t(np.asarray(o.s)[:K]))

    monkeypatch.setattr(jcl.pose_graph, "optimize_pose_graph", record)
    monkeypatch.setattr(tcl.pose_graph, "optimize_pose_graph", replay)
    kf_c, kf_m = 21, 2
    rel = gt[kf_c] @ np.linalg.inv(gt[kf_m])
    S = (rel[:3, :3].astype(np.float32), rel[:3, 3].astype(np.float32), 1.0)
    before = ts.ln_x0[:ts.n_ln].copy()
    for lc in (jlc, tlc):
        lc._loop_guided = (None, None)
        lc._correct(kf_c, kf_m, S)
    (x_j, d_j), (x_t, d_t) = remapped["jax"], remapped["port"]
    assert np.linalg.norm(x_t - before, axis=-1).max() > 0.05
    _same_line(x_t, d_t, x_j, d_j, 1e-4)
    K, n = js.n_kf, js.n_ln
    np.testing.assert_allclose(ts.kf_pose[:K, :3, 3], js.kf_pose[:K, :3, 3],
                               rtol=0, atol=1e-3)
    assert np.isfinite(ts.ln_x0[:n]).all() and np.isfinite(ts.ln_dir[:n]).all()
    ex = np.linalg.norm(ts.ln_x0[:n] - js.ln_x0[:n], axis=-1) \
        / np.maximum(1.0, np.linalg.norm(js.ln_x0[:n], axis=-1))
    ed = np.abs(np.abs(np.sum(ts.ln_dir[:n] * js.ln_dir[:n], -1)) - 1.0)
    print(f"lines after global BA: X0 rel max {ex.max():.2e} median "
          f"{np.median(ex):.2e}; direction 1-|cos| max {ed.max():.2e}")
    assert ex.max() < 1e-3 and np.median(ex) < 1e-4, (ex.max(), np.median(ex))
    assert ed.max() < 1e-3, ed.max()
    assert np.abs(ts.ln_x0[:n] - x_t).max() > 1e-3     # the BA moved them
