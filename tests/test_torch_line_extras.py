"""The port's last standalone line and vocabulary functions against the JAX
package on the CPU: geometry/lines.py's hough_coords, Pluecker codecs,
line_depths, triangulate_two_view and endpoints_3d (the cases of
tests/test_geometry.py's TestLines), optim/lines_ba.py's
refine_lines_fixed_poses (tests/test_lines_ba.py's problem) and
loop/bow.py's Vocabulary.train_device.

Geometry is held to the port's line-geometry tolerance
(tests/test_torch_lines.py: 1e-5 relative to each output's magnitude),
integer outputs and the vocabulary exactly, and the line refinement to
the joint BA tests' 1e-3 relative on each line.
"""
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from test_lines_ba import CAM as LBA_CAM  # noqa: E402
from test_lines_ba import _make_problem  # noqa: E402
from test_torch_lines import CAM, JCAM, _close, _same_line  # noqa: E402
from test_torch_lines import _seeded_lines  # noqa: E402
from lldslam_tpu.geometry import lines as jgl  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.loop.bow import Vocabulary as JVocabulary  # noqa: E402
from lldslam_tpu.optim import lines_ba as jlb  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.geometry import lines as tgl  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.loop.bow import Vocabulary  # noqa: E402
from lldslam_tpu_torch.optim import lines_ba as tlb  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([JCAM.fx * Xc[:, 0] / Xc[:, 2] + JCAM.cx,
                     JCAM.fy * Xc[:, 1] / Xc[:, 2] + JCAM.cy], -1)


def _two_view_case(rng, n=32):
    """tests/test_geometry.py's wide-baseline two-view case: lines around
    5 m ahead, seen from the identity and from a pose 2 m to the side,
    both views' plane normals and centres (from the JAX function)."""
    P = (rng.normal(size=(n, 3)) * 2 + np.array([0, 0, 5.0])).astype(
        np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    X0, du = (np.asarray(x) for x in jgl.closest_point_form(
        jnp.asarray(P), jnp.asarray(d)))
    T1 = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T2 = np.asarray(jse3.exp(jnp.tile(jnp.array(
        [[2.0, 0.3, 0.0, 0.0, 0.2, 0.0]]), (n, 1))))
    obs = []
    for T in (T1, T2):
        pa = np.stack([_project(T[i], (X0 - du)[i:i + 1])[0]
                       for i in range(n)]).astype(np.float32)
        pb = np.stack([_project(T[i], (X0 + du)[i:i + 1])[0]
                       for i in range(n)]).astype(np.float32)
        obs += [np.asarray(x) for x in jgl.plane_normal_from_obs(
            JCAM, jnp.asarray(T), jnp.asarray(pa), jnp.asarray(pb))]
    return obs


@pytest.mark.parametrize("op", ["hough", "plucker", "line_depths",
                                "two_view", "endpoints_3d"])
def test_line_geometry_extras_match_jax(op):
    """Each function on 64 seeded lines (two_view: 32 wide-baseline lines):
    outputs within 1e-5 of the JAX result relative to each output's
    magnitude; Hough cells and the two-view `ok` mask exactly."""
    s = _seeded_lines()
    j = {k: jnp.asarray(v) for k, v in s.items()}
    t = {k: _t(v) for k, v in s.items()}
    if op == "hough":
        diag = float(np.hypot(CAM.width, CAM.height))
        for a, b in zip(tgl.hough_coords(t["x1"], t["x2"], diag),
                        jgl.hough_coords(j["x1"], j["x2"], diag)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        rng = np.random.default_rng(0)
        p1, p2 = rng.uniform([0, 0], [1241, 376], size=(2, 4096, 2)).astype(
            np.float32)
        d = float(np.hypot(1241, 376))
        for a, b in zip(tgl.hough_coords(_t(p1), _t(p2), d),
                        jgl.hough_coords(jnp.asarray(p1), jnp.asarray(p2),
                                         d)):
            assert np.array_equal(a.numpy(), np.asarray(b))
            assert a.dtype == torch.int32 and 0 <= int(a.min())
            assert int(a.max()) < tgl.DIST_CELLS == tgl.ANG_CELLS
        return
    if op == "plucker":
        Lt = tgl.plucker_from_x0dir(t["X0"], 2.5 * t["d"])
        Lj = jgl.plucker_from_x0dir(j["X0"], 2.5 * j["d"])
        got, want = [Lt, *tgl.x0dir_from_plucker(Lt)], [
            Lj, *jgl.x0dir_from_plucker(Lj)]
        np.testing.assert_allclose(got[1].numpy(), s["X0"], rtol=0,
                                   atol=1e-4 * np.abs(s["X0"]).max())
    elif op == "line_depths":
        got = tgl.line_depths(t["T"], t["X0"], t["d"], CAM, t["x1"], t["x2"])
        want = jgl.line_depths(j["T"], j["X0"], j["d"], JCAM, j["x1"],
                               j["x2"])
    elif op == "two_view":
        obs = _two_view_case(np.random.default_rng(0))
        X0t, dt, okt = tgl.triangulate_two_view(*map(_t, obs))
        X0j, dj, okj = jgl.triangulate_two_view(*map(jnp.asarray, obs))
        ok = np.asarray(okj)
        assert np.array_equal(okt.numpy(), ok) and ok.sum() >= 3
        _same_line(X0t.numpy()[ok], dt.numpy()[ok], np.asarray(X0j)[ok],
                   np.asarray(dj)[ok], 1e-5)
        # the degenerate rows stay finite (regularized solve)
        assert np.isfinite(X0t.numpy()).all()
        return
    else:
        got = tgl.endpoints_3d(t["X0"], t["d"], t["T"], CAM, t["x1"], t["x2"])
        want = jgl.endpoints_3d(j["X0"], j["d"], j["T"], JCAM, j["x1"],
                                j["x2"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def _refine_problem():
    """tests/test_lines_ba.py's problem (6 keyframes, 12 lines, both views)
    with the pixel noise of its split-schedule test (0.3 px on every line
    endpoint) and the true poses held."""
    rng = np.random.default_rng(3)
    problem, poses_gt, *_ = _make_problem(rng)
    lnoise = lambda a: jnp.asarray(np.asarray(a) + rng.normal(
        0, 0.3, a.shape).astype(np.float32))
    lo = problem.lobs
    problem = problem._replace(
        base=problem.base._replace(poses=jnp.asarray(poses_gt)),
        lobs=lo._replace(x1l=lnoise(lo.x1l), x2l=lnoise(lo.x2l),
                         x1r=lnoise(lo.x1r), x2r=lnoise(lo.x2r)))
    return problem, poses_gt


def test_refine_lines_fixed_poses_matches_jax():
    """The function's default 4 fixed-pose iterations: each line (X0, +-d)
    within 1e-3 relative of the JAX result, alpha within 1e-3 relative, and
    the lines' summed chi2 over their observations lower than at the start.
    (The 4x4 normal equations of two of the 12 lines are ill-conditioned
    under the fixed damping of 1e-3: float32 summation order moves their
    first step by up to 1.6% between the packages, and the following
    iterations pull them back to within 3e-4.)"""
    problem, _ = _refine_problem()
    qj, aj = jlb.refine_lines_fixed_poses(LBA_CAM, problem)
    tp = interop.joint_problem(problem)
    cam = StereoCamera(*LBA_CAM)
    qt, at = tlb.refine_lines_fixed_poses(cam, tp)
    X0j, dj = jgl.x0dir_from_minimal(qj, aj)
    X0t, dt = tgl.x0dir_from_minimal(qt, at)
    _same_line(X0t.numpy(), dt.numpy(), np.asarray(X0j), np.asarray(dj), 1e-3)
    _close(at, aj, 1e-3)
    chi2 = lambda q, a: float(tlb._line_terms(
        cam, tp._replace(q=q, alpha=a), 0.5, need_jac=False)[4].sum())
    c0, c1 = chi2(tp.q, tp.alpha), chi2(qt, at)
    print(f"line chi2 {c0:.1f} -> {c1:.1f}")
    assert c1 < 0.5 * c0


def _clustered_corpus(n=5000, n_centres=40, flips=12, seed=0):
    """n packed descriptors around n_centres random ones, each with `flips`
    random bits flipped (a corpus the k-medians can split)."""
    rng = np.random.default_rng(seed)
    centres = np.unpackbits(rng.integers(0, 256, (n_centres, 32),
                                         dtype=np.uint8), axis=-1)
    bits = centres[rng.integers(0, n_centres, n)]
    for i in range(n):
        bits[i, rng.choice(256, flips, replace=False)] ^= 1
    return np.packbits(bits, axis=-1).view(np.uint32)


@pytest.mark.parametrize("docs", [False, True])
def test_train_device_matches_jax(docs):
    """Vocabulary.train_device (k = 4, L = 2, seed 0) on a 5,000-descriptor
    corpus, with the default idf documents and with given document ids:
    the JAX package's tree, descriptors, words and weights exactly."""
    descs = _clustered_corpus()
    doc_ids = (np.arange(len(descs)) * 7 % 23).astype(np.int32) if docs \
        else None
    j = JVocabulary.train_device(descs, k=4, L=2, seed=0, doc_ids=doc_ids)
    t = Vocabulary.train_device(descs, k=4, L=2, seed=0, doc_ids=doc_ids,
                                device="cpu")
    assert t.device == torch.device("cpu") and (t.k, t.L) == (4, 2)
    assert j.n_words >= 10
    for name in ("node_children", "node_desc", "node_word", "word_weight"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    np.testing.assert_array_equal(t.transform_words(descs[:500]),
                                  j.transform_words(descs[:500]))
