"""The port's monocular initializer (lldslam_tpu_torch/optim/initializer.py)
against the JAX package's, on the two-view worlds of
tests/test_initializer.py: a general scene (the fundamental wins) and a
planar one (the homography wins).

The port draws its hypotheses from a torch.Generator, so the parity tests
hand it the index sets that `jax.random.choice` drew inside the JAX
functions (the same key split and weights). Tolerances, measured and
reasoned:

- Models are compared after scaling each to unit Frobenius norm with its
  largest entry positive, and against the float64 fit on the inliers of
  JAX's best hypothesis. F is fit on Hartley-normalized coordinates: in
  float32 the JAX refit lies 6.8e-5 and the port's 3.2e-5 from the float64
  fit (general scene), so each is held within 1e-4 of it and the two within
  2e-4 of each other.
- H is fit by the JAX package's DLT on raw pixel coordinates, whose design
  matrix spans five orders of magnitude: in float32 either package's refit
  lies about 1e-3 from the float64 fit (1.4e-3 JAX, 2.4e-3 port on the
  planar scene), so the two and each against float64 are held to 5e-3.
- Inlier masks may differ where an error sits at its chi2 gate: at most 1%.
- The chosen pose: through F, R and t within 1e-4 and X within 1e-3
  relative; through H, the Faugeras decomposition carries H's 1e-3 into R
  (1e-3) and the direction of t (1e-2), and both packages meet
  tests/test_initializer.py's bound against the ground truth.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_initializer import CAM, _two_view  # noqa: E402
from lldslam_tpu.optim import initializer as ji  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.optim import initializer as ti  # noqa: E402

torch.set_num_threads(2)
TCAM = StereoCamera(*CAM)
# (rng seed, planar, PRNGKey, outlier fraction) as tests/test_initializer.py
WORLDS = {"general": (0, False, 0, 0.1), "planar": (1, True, 1, 0.05)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(M):
    """M / |M|_F with its largest-magnitude entry positive."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def _jax_indices(key, valid, n_hyp=256):
    """The (H, F) index sets jax.random.choice draws in ransac_models."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    k1, k2 = jax.random.split(key)
    n = valid.shape[0]
    return (np.asarray(jax.random.choice(k1, n, (n_hyp, 4), True, p)),
            np.asarray(jax.random.choice(k2, n, (n_hyp, 8), True, p)))


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    seed, planar, key, out = WORLDS[request.param]
    x1, x2, _, R, t, X = _two_view(np.random.default_rng(seed), planar=planar,
                                   outlier_frac=out)
    valid = np.ones(len(x1), bool)
    idx = _jax_indices(jax.random.PRNGKey(key), valid)
    return dict(name=request.param, x1=x1, x2=x2, valid=valid, R=R, t=t, X=X,
                key=jax.random.PRNGKey(key), idx=idx)


def _h64(x1, x2, w):
    """The float64 homography DLT on the inliers w."""
    x1, x2 = x1.astype(np.float64), x2.astype(np.float64)
    x, y, u, v = x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    A = np.concatenate([np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1),
                        np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)])
    A = A * np.concatenate([w, w])[:, None]
    return np.linalg.svd(A)[2][-1].reshape(3, 3)


def _f64(x1, x2, w):
    """The float64 Hartley-normalized 8-point fit on the inliers w, rank
    2, in pixel coordinates."""
    def norm(x):
        x = x.astype(np.float64)
        m = x.mean(0)
        s = 1.0 / np.abs(x - m).mean(0)
        return (x - m) * s, np.array([[s[0], 0, -m[0] * s[0]],
                                      [0, s[1], -m[1] * s[1]], [0, 0, 1]])
    (a, T1), (b, T2) = norm(x1), norm(x2)
    x, y, u, v = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    A = np.stack([u * x, u * y, u, v * x, v * y, v, x, y, np.ones_like(x)],
                 -1) * w[:, None]
    U, S, Vt = np.linalg.svd(np.linalg.svd(A)[2][-1].reshape(3, 3))
    return T2.T @ (U * np.array([S[0], S[1], 0.0])) @ Vt @ T1


def test_ransac_models_on_jax_hypotheses(world):
    """Given JAX's index sets: the same best homography hypothesis, the
    best scores within 1e-2 (H, from the ill-conditioned DLT) and 1e-3 (F)
    relative, the refits within the module's tolerances, inlier masks equal
    but for <= 1% of the matches."""
    x1, x2, valid = world["x1"], world["x2"], world["valid"]
    ih, if_ = world["idx"]
    jout = [np.asarray(a) for a in ji.ransac_models(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), world["key"])]
    tout = [a.numpy() for a in ti.ransac_models(
        _t(x1), _t(x2), _t(valid), _t(ih).long(), _t(if_).long())]

    # the best hypothesis of each model, scored by both packages
    jx1, jx2 = jnp.asarray(x1), jnp.asarray(x2)
    jH = jax.vmap(lambda i: ji._dlt_h(jx1[i], jx2[i]))(jnp.asarray(ih))
    e12, e21 = jax.vmap(lambda H: ji._h_transfer_err(H, jx1, jx2))(jH)
    jsc = np.asarray((jnp.where(e12 < ji.CHI2_H, ji.SCORE_TH - e12, 0.0)
                      + jnp.where(e21 < ji.CHI2_H, ji.SCORE_TH - e21, 0.0))
                     .sum(-1))
    tH = ti._dlt_h(_t(x1)[_t(ih).long()], _t(x2)[_t(ih).long()])
    _, tsc = ti._score(*ti._h_transfer_err(tH, _t(x1), _t(x2)), ti.CHI2_H,
                       _t(valid)[None], 1.0)
    assert int(np.argmax(jsc)) == int(torch.argmax(tsc))
    np.testing.assert_allclose(tout[1], jout[1], rtol=1e-2)
    np.testing.assert_allclose(tout[4], jout[4], rtol=1e-3)

    # the refits, against each other and against the float64 fits on the
    # inliers of JAX's best hypotheses
    bh = int(np.argmax(jsc))
    w = np.asarray((e12[bh] < ji.CHI2_H) & (e21[bh] < ji.CHI2_H), np.float64)
    x1n, T1 = ji._normalize(jx1, jnp.asarray(valid))
    x2n, T2 = ji._normalize(jx2, jnp.asarray(valid))
    jF = jnp.einsum("ij,hjk,kl->hil", T2.T, jax.vmap(
        lambda i: ji._dlt_f(x1n[i], x2n[i]))(jnp.asarray(if_)), T1)
    d1, d2 = jax.vmap(lambda F: ji._f_epi_err(F, jx1, jx2))(jF)
    fsc = (jnp.where(d1 < ji.CHI2_F, ji.SCORE_TH - d1, 0.0)
           + jnp.where(d2 < ji.CHI2_F, ji.SCORE_TH - d2, 0.0)).sum(-1)
    bf = int(jnp.argmax(fsc))
    wf = np.asarray((d1[bf] < ji.CHI2_F) & (d2[bf] < ji.CHI2_F), np.float64)
    for key, i, ref, tol in (("H", 0, _h64(x1, x2, w), 5e-3),
                             ("F", 3, _f64(x1, x2, wf), 1e-4)):
        ref = _unit(ref)
        d = [np.abs(_unit(tout[i]) - _unit(jout[i])).max(),
             np.abs(_unit(jout[i]) - ref).max(),
             np.abs(_unit(tout[i]) - ref).max()]
        print(f"{world['name']}: {key} port-JAX {d[0]:.2e}, JAX-f64 "
              f"{d[1]:.2e}, port-f64 {d[2]:.2e}")
        assert d[1] <= tol and d[2] <= tol
        assert d[0] <= (tol if key == "H" else 2 * tol)
    for j, t in ((jout[2], tout[2]), (jout[5], tout[5])):
        assert (j != t).mean() <= 0.01, int((j != t).sum())


def test_initialize_on_jax_hypotheses(world):
    """Given JAX's index sets: the same model and the same verdict; the
    pose, good mask and points within the module's tolerances."""
    x1, x2, valid = world["x1"], world["x2"], world["valid"]
    ih, if_ = world["idx"]
    jok, jR, jt, jX, jg = ji.initialize(CAM, jnp.asarray(x1), jnp.asarray(x2),
                                        jnp.asarray(valid), world["key"])
    tok, tR, tt, tX, tg = ti.initialize(TCAM, _t(x1), _t(x2), _t(valid),
                                        _t(ih).long(), _t(if_).long())
    assert jok and tok
    through_h = world["name"] == "planar"
    dR = np.abs(tR - jR).max()
    dt = np.abs(tt / np.linalg.norm(tt) - jt / np.linalg.norm(jt)).max()
    both = jg & tg
    dX = (np.linalg.norm(tX - jX, axis=-1)
          / np.linalg.norm(jX, axis=-1))[both].max()
    print(f"{world['name']}: R {dR:.2e}, t {dt:.2e}, X {dX:.2e}, good "
          f"differs in {int((jg != tg).sum())} of {len(jg)}")
    assert dR <= (1e-3 if through_h else 1e-4)
    assert dt <= (1e-2 if through_h else 1e-4)
    assert dX <= (1e-2 if through_h else 1e-3)
    assert (jg != tg).mean() <= 0.01
    for R in (jR, tR):
        ang = np.arccos(np.clip((np.trace(R @ world["R"].T) - 1) / 2, -1, 1))
        assert ang < (0.02 if through_h else 0.01), ang


def test_own_draw_meets_the_jax_tests_bounds(world):
    """The port's own draw (torch.Generator) through `initialize`: the
    accuracy bounds of tests/test_initializer.py against the ground truth,
    and the homography chosen on the planar scene."""
    x1, x2, valid = world["x1"], world["x2"], world["valid"]
    g = torch.Generator().manual_seed(7)
    hyp = ti.draw_hypotheses(_t(valid), g)
    H, sh, _, F, sf, _ = ti.ransac_models(_t(x1), _t(x2), _t(valid), *hyp)
    rh = float(sh) / (float(sh) + float(sf))
    ok, R, t, X, good = ti.initialize(TCAM, _t(x1), _t(x2), _t(valid), *hyp)
    assert ok
    ang = np.arccos(np.clip((np.trace(R @ world["R"].T) - 1) / 2, -1, 1))
    if world["name"] == "planar":
        assert rh > 0.40, rh
        assert ang < 0.02, ang
        return
    assert rh <= 0.40, rh
    assert ang < 0.01, ang
    tgt = world["t"] / np.linalg.norm(world["t"])
    assert abs(t / np.linalg.norm(t) @ tgt) > 0.999
    X_gt = world["X"]
    s = np.median(np.linalg.norm(X[good], axis=-1)
                  / np.linalg.norm(X_gt[good], axis=-1))
    assert np.median(np.linalg.norm(X[good] / s - X_gt[good], axis=-1)) < 0.3
