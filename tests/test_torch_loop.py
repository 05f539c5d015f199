"""CPU parity of the port's loop-closing modules with the JAX package:
Sim(3) algebra, Horn / RANSAC / refinement, the Sim(3) pose graph, the
sparse bundle adjustment, the BoW vocabulary and keyframe database, and
the loop closer itself on a synthetic map carried across with
`interop.map_store`.

Inputs are made with numpy from a seed. Integer work (tree descent, word
ids, database candidates, K2 associations, detected candidates) is held
exactly. Float results are held within the tolerance stated at each test:
the two frameworks sum in another order and solve small systems with other
LAPACK paths. RANSAC draws cannot be reproduced across frameworks, so the
scoring is fed the indices JAX drew, and the port's own draw is compared
only where every clean hypothesis wins.
"""
from functools import partial
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.geometry import sim3 as jsim3  # noqa: E402
from lldslam_tpu.geometry.camera import StereoCamera as JStereoCamera  # noqa: E402
from lldslam_tpu.loop import closing as jcl  # noqa: E402
from lldslam_tpu.loop.bow import Vocabulary as JVocabulary  # noqa: E402
from lldslam_tpu.loop.bow import _descend as jdescend  # noqa: E402
from lldslam_tpu.loop.database import KeyFrameDatabase as JDatabase  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.optim import ba as jba  # noqa: E402
from lldslam_tpu.optim import pose_graph as jpg  # noqa: E402
from lldslam_tpu.optim import sim3_solver as jss  # noqa: E402
from lldslam_tpu.slammap.map_store import MapStore as JMapStore  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.config import CameraConfig, SlamConfig  # noqa: E402
from lldslam_tpu_torch.geometry import sim3 as tsim3  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.io.synthetic import make_loop_map  # noqa: E402
from lldslam_tpu_torch.loop import closing as tcl  # noqa: E402
from lldslam_tpu_torch.loop.bow import Vocabulary, _descend  # noqa: E402
from lldslam_tpu_torch.loop.database import KeyFrameDatabase  # noqa: E402
from lldslam_tpu_torch.ops import match_best2  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.optim import ba as tba  # noqa: E402
from lldslam_tpu_torch.optim import pose_graph as tpg  # noqa: E402
from lldslam_tpu_torch.optim import sim3_solver as tss  # noqa: E402
from lldslam_tpu_torch.pipeline.tracker import StereoTracker  # noqa: E402
from lldslam_tpu_torch.system import DEFAULT_VOCABULARY, System  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JCAM = JStereoCamera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                     width=640, height=480)
CAM = StereoCamera(*JCAM)
W, H = 512, 384
RING = dict(fx=400.0, fy=400.0, cx=W / 2, cy=H / 2, bf=200.0, fps=10.0,
            width=W, height=H)
RING_CC = JCameraConfig(**RING)
PORT_CFG = SlamConfig(camera=CameraConfig(**RING),
                      orb=OrbConfig(n_features=600))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _angle(Ra, Rb):
    """Rotation angle between batches of rotation matrices, from the skew
    part of Ra^T Rb in float64 (arccos of the trace is too coarse near 0
    in float32)."""
    d = np.einsum("kji,kjl->kil", Ra.astype(np.float64), Rb.astype(np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                  d[:, 1, 0] - d[:, 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1) / 2, 0, 1))


def _rot(rng, scale=0.3):
    xi = np.concatenate([np.zeros(3), rng.normal(0, scale, 3)])
    return np.asarray(jse3.exp(jnp.asarray(xi.astype(np.float32))))[:3, :3]


# ---------------------------------------------------------------------------
# Sim(3) algebra


def _xis(rng, n=64):
    """Tangent vectors, with exact-zero rotation / scale rows for the
    small-angle and sigma -> 0 branches."""
    xi = np.concatenate([rng.normal(0, 1.0, (n, 3)), rng.normal(0, 0.5, (n, 3)),
                         rng.normal(0, 0.3, (n, 1))], -1).astype(np.float32)
    xi[:8, 3:6] = 0.0
    xi[8:16, 6] = 0.0
    xi[16:20, 3:] = 0.0
    xi[20:24, 3:6] *= 1e-4
    return xi


@pytest.mark.parametrize("op", ["exp", "log", "compose", "inv", "apply",
                                "retract", "pack", "unpack", "to_se3",
                                "from_se3", "make", "identity"])
def test_sim3_ops_match_jax(op):
    """Every Sim(3) function on the same batch: atol 1e-5."""
    rng = np.random.default_rng(0)
    xa, xb = _xis(rng), _xis(rng)
    X = rng.normal(0, 3.0, (64, 3)).astype(np.float32)
    ja, jb = jsim3.exp(jnp.asarray(xa)), jsim3.exp(jnp.asarray(xb))
    ta, tb = tsim3.exp(_t(xa)), tsim3.exp(_t(xb))
    if op == "exp":
        want, got = ja, ta
    elif op == "log":
        want, got = (jsim3.log(ja),), (tsim3.log(ta),)
    elif op == "compose":
        want, got = jsim3.compose(ja, jb), tsim3.compose(ta, tb)
    elif op == "inv":
        want, got = jsim3.inv(ja), tsim3.inv(ta)
    elif op == "apply":
        want, got = (jsim3.apply(ja, jnp.asarray(X)),), (tsim3.apply(ta, _t(X)),)
    elif op == "retract":
        want = jsim3.retract(ja, jnp.asarray(xb))
        got = tsim3.retract(ta, _t(xb))
    elif op == "pack":
        want, got = (jsim3.pack(ja),), (tsim3.pack(ta),)
    elif op == "unpack":
        p = np.asarray(jsim3.pack(ja))
        want, got = jsim3.unpack(jnp.asarray(p)), tsim3.unpack(_t(p))
    elif op == "to_se3":
        want, got = (jsim3.to_se3(ja),), (tsim3.to_se3(ta),)
    elif op == "from_se3":
        T = np.asarray(jse3.exp(jnp.asarray(xa[:, :6])))
        want, got = jsim3.from_se3(jnp.asarray(T)), tsim3.from_se3(_t(T))
    elif op == "make":
        R, t = np.asarray(ja[0]), np.asarray(ja[1])
        want = jsim3.make(jnp.asarray(R), jnp.asarray(t), jnp.float32(1.5))
        got = tsim3.make(_t(R), _t(t), 1.5)
    else:
        want = jsim3.identity((4, 2))
        got = tsim3.identity((4, 2))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Horn, Sim3 RANSAC and refinement


def test_horn_sim3_matches_jax():
    """Horn on identical batched minimal sets (3 points each, 32 sets),
    scale fixed as the stereo loop closer runs it: atol 1e-4."""
    rng = np.random.default_rng(1)
    P2 = rng.uniform(-5, 5, (32, 3, 3)).astype(np.float32)
    R = np.stack([_rot(rng) for _ in range(32)])
    P1 = (1.3 * np.einsum("hij,hnj->hni", R, P2)
          + rng.normal(0, 1.0, (32, 1, 3))).astype(np.float32)
    P1 += rng.normal(0, 0.05, P1.shape).astype(np.float32)
    want = jss.horn_sim3(jnp.asarray(P1), jnp.asarray(P2), fix_scale=True)
    got = tss.horn_sim3(_t(P1), _t(P2))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=0, atol=1e-4)


def _proj(P):
    return np.stack([CAM.fx * P[:, 0] / P[:, 2] + CAM.cx,
                     CAM.fy * P[:, 1] / P[:, 2] + CAM.cy], -1)


def _sim3_scene(seed, n=60, outlier_frac=0.3, noise=0.0):
    rng = np.random.default_rng(seed)
    R = _rot(rng, 0.08)
    t = np.array([0.3, 0.1, 0.5], np.float32)
    P2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(5, 15, n)], -1).astype(np.float32)
    P1 = (R @ P2.T).T + t
    uv1 = (_proj(P1) + rng.normal(0, noise, (n, 2))).astype(np.float32)
    uv2 = (_proj(P2) + rng.normal(0, noise, (n, 2))).astype(np.float32)
    out = rng.uniform(size=n) < outlier_frac
    P1 = P1.astype(np.float32)
    P1[out] += rng.uniform(1.0, 3.0, (out.sum(), 3)).astype(np.float32)
    return R, t, P1, P2, uv1, uv2, out


def test_ransac_sim3_matches_jax():
    """30% outliers. Scoring fed the 256 index triples JAX drew under
    PRNGKey(0): the same inlier mask and the transform within 1e-3. The
    port's own draw (torch.Generator seeded 0) on this outlier-free-inlier
    data reaches the same inlier mask."""
    R, t, P1, P2, uv1, uv2, out = _sim3_scene(2)
    n = len(P1)
    ones, valid = np.ones(n, np.float32), np.ones(n, bool)
    args_j = [jnp.asarray(a) for a in (P1, P2, uv1, uv2, ones, ones, valid)]
    (Rj, tj, sj), inl_j, n_j = jss.ransac_sim3(JCAM, JCAM, *args_j,
                                               jax.random.PRNGKey(0))
    p = jnp.asarray(valid, jnp.float32) / n
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n,
                                       shape=(256, 3), replace=True, p=p))
    args_t = [_t(a) for a in (P1, P2, uv1, uv2, ones, ones, valid)]
    (Rt, tt, st), inl_t, n_t = tss.score_sim3(CAM, CAM, *args_t, _t(idx))
    assert np.array_equal(_n(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 0.9 * (~out).sum()
    np.testing.assert_allclose(_n(Rt), np.asarray(Rj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(_n(tt), np.asarray(tj), rtol=0, atol=1e-3)
    g = torch.Generator().manual_seed(0)
    (Rg, tg, _), inl_g, _ = tss.ransac_sim3(CAM, CAM, *args_t, g)
    assert np.array_equal(_n(inl_g), np.asarray(inl_j))
    np.testing.assert_allclose(_n(Rg), R, rtol=0, atol=1e-3)
    np.testing.assert_allclose(_n(tg), t, rtol=0, atol=1e-3)


def test_refine_sim3_matches_jax():
    """10 Huber GN steps from the same perturbed start, 0.5 px noise and
    10% outliers: R within 1e-4, t within 1e-3, equal inlier masks."""
    R, t, P1, P2, uv1, uv2, out = _sim3_scene(5, n=80, outlier_frac=0.1,
                                              noise=0.5)
    n = len(P1)
    R0 = (_rot(np.random.default_rng(6), 0.01) @ R).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.02])).astype(np.float32)
    ones, valid = np.ones(n, np.float32), np.ones(n, bool)
    (Rj, tj, sj), inl_j, _ = jss.refine_sim3(
        JCAM, JCAM, (jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(1.0)),
        *[jnp.asarray(a) for a in (P1, P2, uv1, uv2, ones, ones, valid)])
    (Rt, tt, st), inl_t, n_t = tss.refine_sim3(
        CAM, CAM, (_t(R0), _t(t0), torch.tensor(1.0)),
        *[_t(a) for a in (P1, P2, uv1, uv2, ones, ones, valid)])
    np.testing.assert_allclose(_n(Rt), np.asarray(Rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_n(tt), np.asarray(tj), rtol=0, atol=1e-3)
    assert float(st) == float(sj) == 1.0
    assert np.array_equal(_n(inl_t), np.asarray(inl_j))
    assert int(n_t) >= 0.85 * n


# ---------------------------------------------------------------------------
# Sim(3) pose graph


def _drifting_circle(K=24):
    """tests/test_loop.py's circle: noisy sequential edges, one exact loop
    edge, the initial estimate integrated along the noisy chain."""
    rng = np.random.default_rng(0)
    gt = np.stack([np.asarray(jse3.exp(jnp.asarray(np.array(
        [5 * np.cos(2 * np.pi * i / K), 5 * np.sin(2 * np.pi * i / K), 0.0,
         0, 0, 2 * np.pi * i / K], np.float32)))) for i in range(K)])
    e_i, e_j, mR, mt = [], [], [], []
    for i, j, noise in [(i, i - 1, True) for i in range(1, K)] + [(0, K - 1,
                                                                   False)]:
        M = gt[i] @ np.linalg.inv(gt[j])
        if noise:
            xi = rng.normal(0, 0.05, 6).astype(np.float32)
            xi[3:] = rng.normal(0, 0.01, 3)
            M = np.asarray(jse3.exp(jnp.asarray(xi))) @ M
        e_i.append(i)
        e_j.append(j)
        mR.append(M[:3, :3])
        mt.append(M[:3, 3])
    est = [gt[0]]
    for i in range(1, K):
        M = np.eye(4, dtype=np.float32)
        M[:3, :3], M[:3, 3] = mR[i - 1], mt[i - 1]
        est.append(M @ est[i - 1])
    est = np.stack(est).astype(np.float32)
    E = len(e_i)
    return dict(R=est[:, :3, :3], t=est[:, :3, 3], s=np.ones(K, np.float32),
                fixed=np.arange(K) == 0, e_i=np.array(e_i, np.int32),
                e_j=np.array(e_j, np.int32),
                m_R=np.stack(mR).astype(np.float32),
                m_t=np.stack(mt).astype(np.float32),
                m_s=np.ones(E, np.float32), e_valid=np.ones(E, bool))


def test_pose_graph_matches_jax():
    """The drifting 24-keyframe circle of tests/test_loop.py, 15 LM steps
    with 32 CG steps each: vertices within 1e-3 m and 1e-4 rad of the JAX
    result, and the error reduced 10x."""
    d = _drifting_circle()
    jg = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in d.items()})
    tg = interop.pose_graph(d)
    j_opt = jpg.optimize_pose_graph(jg, iters=15, cg_iters=32)
    t_opt = tpg.optimize_pose_graph(tg, iters=15, cg_iters=32)
    np.testing.assert_allclose(_n(t_opt.t), np.asarray(j_opt.t), rtol=0,
                               atol=1e-3)
    ang = _angle(np.asarray(j_opt.R), _n(t_opt.R))
    assert ang.max() < 1e-4, ang.max()
    e0 = float(tpg.total_error(tg))
    assert float(tpg.total_error(t_opt)) < 0.1 * e0
    assert abs(float(tpg.total_error(t_opt))
               - float(jpg.total_error(j_opt))) < 1e-3 * e0


# ---------------------------------------------------------------------------
# sparse bundle adjustment


def _ba_problem(seed=0, K=8, P=500):
    """8 keyframes along a slow arc, 500 points 6-20 m ahead, every point
    seen by every keyframe in view (0.5 px noise), keyframe 0 fixed, poses
    perturbed by ~3 cm / 0.01 rad and points by 0.1 m."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-3, 3, P),
                    rng.uniform(6, 20, P)], -1).astype(np.float32)
    T = np.stack([np.asarray(jse3.exp(jnp.asarray(np.array(
        [0.3 * k, 0.0, -0.4 * k, 0.0, 0.02 * k, 0.0], np.float32))))
        for k in range(K)])
    ks, ps = np.meshgrid(np.arange(K), np.arange(P), indexing="ij")
    ks, ps = ks.ravel(), ps.ravel()
    Xc = np.einsum("kij,kpj->kpi", T[:, :3, :3], np.broadcast_to(
        pts, (K, P, 3))).reshape(-1, 3) + T[ks, :3, 3]
    u = JCAM.fx * Xc[:, 0] / Xc[:, 2] + JCAM.cx
    v = JCAM.fy * Xc[:, 1] / Xc[:, 2] + JCAM.cy
    uvr = np.stack([u, v, u - JCAM.bf / Xc[:, 2]], -1)
    uvr = (uvr + rng.normal(0, 0.5, uvr.shape)).astype(np.float32)
    valid = (u > 0) & (u < JCAM.width) & (v > 0) & (v < JCAM.height)
    xi = np.concatenate([rng.normal(0, 0.03, (K, 3)),
                         rng.normal(0, 0.01, (K, 3))], -1).astype(np.float32)
    xi[0] = 0.0
    T0 = np.asarray(jse3.exp(jnp.asarray(xi))) @ T
    return dict(
        poses=T0.astype(np.float32),
        points=(pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32),
        pose_fixed=np.arange(K) == 0, point_valid=np.ones(P, bool),
        obs=dict(k=ks.astype(np.int32), p=ps.astype(np.int32), uvr=uvr,
                 inv_sigma2=np.ones(K * P, np.float32),
                 is_stereo=rng.uniform(size=K * P) < 0.8, valid=valid))


def test_ba_solve_matches_jax():
    """ba_solve (10 LM iterations, 64 CG steps each, as global BA runs it)
    on an 8-keyframe, 500-point problem:
    poses within 1e-4, points seen twice or more within 1e-3 relative to
    their distance, the final chi2 within 1e-3 relative."""
    d = _ba_problem()
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()
                          if k != "obs"},
                       obs=jba.BAObs(**{k: jnp.asarray(v)
                                        for k, v in d["obs"].items()}))
    tp = interop.ba_problem(d)
    js, jchi = jba.ba_solve(JCAM, jp, iters=10, dense=False, cg_iters=64)
    ts, tchi = tba.ba_solve(CAM, tp, iters=10, cg_iters=64)
    np.testing.assert_allclose(_n(ts.poses), np.asarray(js.poses), rtol=0,
                               atol=1e-4)
    # points seen by at least 2 keyframes (one view leaves the depth to the
    # damping alone)
    v = d["obs"]["valid"]
    well = np.bincount(d["obs"]["p"][v], minlength=len(d["points"])) >= 2
    pj = np.asarray(js.points)[well]
    rel = np.linalg.norm(_n(ts.points)[well] - pj, axis=-1) \
        / np.linalg.norm(pj, axis=-1)
    assert rel.max() < 1e-3, rel.max()
    assert well.mean() > 0.9
    np.testing.assert_allclose(_n(tchi)[v], np.asarray(jchi)[v], rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# vocabulary and database


@pytest.fixture(scope="module")
def shipped():
    jv = JVocabulary.load_npz(DEFAULT_VOCABULARY)
    return jv, interop.vocabulary(jv)


def test_descend_and_bow_vector_match_jax(shipped):
    """4000 descriptors (random, and near copies of vocabulary nodes so
    the descent runs deep) down the shipped 99106-word vocabulary: word ids
    exact; BoW vector ids exact and values within 1e-6."""
    jv, tv = shipped
    rng = np.random.default_rng(3)
    d = rng.integers(0, 2**32, (4000, 8), dtype=np.uint64).astype(np.uint32)
    near = jv.node_desc[rng.integers(1, len(jv.node_desc), 2000)].copy()
    bit = rng.integers(0, 256, 2000)
    near[np.arange(2000), bit // 32] ^= np.uint32(1) << (bit % 32).astype(
        np.uint32)
    d[:2000] = near
    valid = rng.uniform(size=4000) < 0.95
    want = np.asarray(jdescend(*(jnp.asarray(a) for a in (
        jv.node_children, jv.node_desc, jv.node_word)), jnp.asarray(d), jv.L))
    got = _descend(tv._children, tv._desc, tv._word,
                   _t(d.view(np.int32)), tv.L).numpy()
    assert np.array_equal(got, want)
    ji, jvals = jv.bow_vector(d, valid)
    ti, tvals = tv.bow_vector(d, valid)
    assert np.array_equal(ti, ji)
    np.testing.assert_allclose(tvals, jvals, rtol=0, atol=1e-6)


def test_vocabulary_train_identical():
    """Vocabulary.train(seed=0) on the same 2000 descriptors: the same tree
    arrays and idf weights."""
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 2**32, (2000, 8), dtype=np.uint64) \
        .astype(np.uint32)
    jv = JVocabulary.train(corpus, k=8, L=3, seed=0)
    tv = Vocabulary.train(corpus, k=8, L=3, seed=0)
    for f in ("node_children", "node_desc", "node_word", "word_weight"):
        assert np.array_equal(getattr(tv, f), getattr(jv, f)), f
    assert (tv.k, tv.L) == (jv.k, jv.L)


def _perturb(rng, descs, n_bits):
    out = descs.copy()
    for i in range(len(out)):
        for _ in range(n_bits):
            out[i, rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(
                rng.integers(0, 32))
    return out


def test_database_candidates_match_jax(shipped):
    """The same adds and erases in both databases, then loop and reloc
    candidates for revisiting queries: exact; and the contents carried
    across with interop.keyframe_database answer the same."""
    jv, tv = shipped
    rng = np.random.default_rng(2)
    corpus = rng.integers(0, 2**32, (3000, 8), dtype=np.uint64) \
        .astype(np.uint32)
    jdb, tdb = JDatabase(jv), KeyFrameDatabase(tv)
    frames = [corpus[i * 300:(i + 1) * 300] for i in range(8)]
    frames.append(_perturb(rng, frames[1], 6))
    frames.append(_perturb(rng, frames[2], 6))
    for i, f in enumerate(frames):
        jdb.add(i, *jv.bow_vector(f))
        tdb.add(i, *tv.bow_vector(f))
    for db in (jdb, tdb):
        db.erase(3)
        db.erase(42)      # absent: no-op
    groups = {1: [0, 2], 2: [1, 3], 0: [1]}
    for q, conn in ((8, {7}), (9, {8})):
        assert tdb.detect_loop_candidates(q, 0.01, conn, groups) \
            == jdb.detect_loop_candidates(q, 0.01, conn, groups)
    q = _perturb(rng, frames[2], 6)
    want = jdb.detect_reloc_candidates(*jv.bow_vector(q))
    assert tdb.detect_reloc_candidates(*tv.bow_vector(q)) == want
    assert 2 in want and 3 not in want
    copy = interop.keyframe_database(jdb, tv)
    assert copy.detect_reloc_candidates(*tv.bow_vector(q)) == want


# ---------------------------------------------------------------------------
# the loop closer on a synthetic map


def _loop_pair(shipped):
    """The drifting 24-keyframe circle of io.synthetic.make_loop_map in a
    JAX MapStore, carried into the port; a loop closer on each side."""
    jv, tv = shipped
    jorb = JOrbConfig(n_features=600)
    js = JMapStore(RING_CC.stereo_camera(), jorb, max_kf=64, max_pt=20000)
    gt = make_loop_map(js)
    ts = interop.map_store(js, PORT_CFG.camera.stereo_camera(), PORT_CFG.orb)
    jlc = jcl.LoopCloser(js, jv, JSlamConfig(camera=RING_CC, orb=jorb))
    # the single-device global BA: the test process exposes 8 CPU devices
    jlc.global_ba = partial(jlc.global_ba, force_dist=False)
    tlc = tcl.LoopCloser(ts, tv, PORT_CFG, device="cpu")
    return dict(js=js, ts=ts, jlc=jlc, tlc=tlc, gt=gt)


@pytest.fixture(scope="module")
def loop_map(shipped):
    return _loop_pair(shipped)


@pytest.fixture(scope="module")
def detected(loop_map):
    """Every keyframe in order through detection and the database on both
    sides, then Sim3 between the first query and its candidate."""
    m = loop_map
    jlc, tlc, js, ts = m["jlc"], m["tlc"], m["js"], m["ts"]
    found, words = [], []
    for k in range(js.n_kf):
        ji, jvals = jlc._kf_bow(k)
        ti, tvals = tlc.voc.bow_vector(ts.kf_desc[k], ts.kf_kp_valid[k])
        words.append(np.array_equal(ti, ji))
        found.append((jlc._detect(k, ji, jvals), tlc._detect(k, ti, tvals)))
        jlc.db.add(k, ji, jvals)
        tlc.db.add(k, ti, tvals)
    q = next(k for k, (c, _) in enumerate(found) if c is not None)
    c = found[q][0]
    return dict(words=words, found=found, query=(q, c),
                sim3=(jlc._compute_sim3(q, c), tlc._compute_sim3(q, c)))


def test_loop_project_match_exact(loop_map):
    """The K2 loop call site: the loop keyframe's local map projected into
    the revisiting keyframe at cap=8192 and th 2.5 / 2.0: kp2pid exact, and
    enough hits that the comparison means something."""
    m = loop_map
    jlc, tlc = m["jlc"], m["tlc"]
    pids = jlc._loop_points(2)
    assert np.array_equal(tlc._loop_points(2), pids)
    # keyframe 21 at its pose relative to keyframe 2 after a correction
    T = (m["gt"][21] @ np.linalg.inv(m["gt"][2]) @ m["js"].kf_pose[2]) \
        .astype(np.float32)
    before = match_best2.launches_by_site.get("loop", 0)
    for th in (2.5, 2.0):
        want = jlc._project_match(21, pids, T, th=th)
        got = tlc._project_match(21, pids, T, th=th)
        assert np.array_equal(got, want)
        assert (got >= 0).sum() >= 50
    # CPU tensors take the plain version: no kernel launch is counted
    assert match_best2.launches_by_site.get("loop", 0) == before


def test_loop_detection_and_sim3_match_jax(detected):
    """The same BoW words and the same detected candidate at every keyframe
    (the revisit of keyframe 2 by keyframe 21 is found), then Sim3 between
    them: both accept, the refined inlier counts within 2, R within 1e-3,
    t within 1e-2 m."""
    d = detected
    assert all(d["words"])
    assert all(cj == ct for cj, ct in d["found"]), d["found"]
    assert d["query"] == (21, 2)
    rj, rt = d["sim3"]
    assert rj is not None and rt is not None
    (Rj, tj, _), nj = rj
    (Rt, tt, _), nt = rt
    assert abs(nt - nj) <= 2
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-2)


def test_correct_matches_jax(shipped, detected):
    """On a fresh copy of the map, with the same S_cm (the JAX Sim3) and the
    same guided matches, `_correct` (essential graph, point remap, loop
    fusion, global BA with 64 CG steps) leaves keyframe poses within
    2e-3 m and 1e-3 rad of the JAX result, points within 5e-3 m (median),
    the same observations on >= 99.9% of the slots, and the loop pair near
    its true relative pose."""
    m = _loop_pair(shipped)
    jlc, tlc, js, ts = m["jlc"], m["tlc"], m["js"], m["ts"]
    (kf_c, kf_m), S = detected["query"], detected["sim3"][0][0]
    T_corr = np.eye(4, dtype=np.float32)
    Tm = js.kf_pose[kf_m]
    T_corr[:3, :3] = S[0] @ Tm[:3, :3]
    T_corr[:3, 3] = S[2] * (S[0] @ Tm[:3, 3]) + S[1]
    pids = jlc._loop_points(kf_m)
    kp2lp = jlc._project_match(kf_c, pids, T_corr, th=2.5)
    jlc._loop_guided = (kp2lp, pids)
    tlc._loop_guided = (tlc._project_match(kf_c, pids, T_corr, th=2.5), pids)
    assert np.array_equal(tlc._loop_guided[0], kp2lp)
    jlc._correct(kf_c, kf_m, S)
    tlc._correct(kf_c, kf_m, S)
    K = js.n_kf
    Pj, Pt = js.kf_pose[:K], ts.kf_pose[:K]
    np.testing.assert_allclose(Pt[:, :3, 3], Pj[:, :3, 3], rtol=0, atol=2e-3)
    ang = _angle(Pj[:, :3, :3], Pt[:, :3, :3])
    assert ang.max() < 1e-3, ang.max()
    assert ts.loop_edges == js.loop_edges
    same = (ts.kf_pt_ids[:K] == js.kf_pt_ids[:K]).mean()
    assert same >= 0.999, same
    live = js.pt_valid[:js.n_pt] & ts.pt_valid[:ts.n_pt]
    err = np.linalg.norm(ts.pt_pos[:ts.n_pt][live] - js.pt_pos[:js.n_pt][live],
                         axis=-1)
    assert np.median(err) < 5e-3 and np.mean(err < 5e-2) > 0.99, \
        (np.median(err), err.max())
    gt = m["gt"]
    rel_true = gt[kf_c] @ np.linalg.inv(gt[kf_m])
    rel = Pt[kf_c] @ np.linalg.inv(Pt[kf_m])
    assert np.linalg.norm(rel[:3, 3] - rel_true[:3, 3]) < 0.1


# ---------------------------------------------------------------------------
# wiring


def test_culled_keyframe_leaves_database(shipped):
    """The mapper's keyframe culling calls `on_kf_culled`, which the tracker
    points at the database: a culled keyframe leaves `db.kf_words` and no
    relocalization query returns a keyframe whose `kf_valid` is False; the
    hook follows the database through a full reset."""
    _, tv = shipped
    tr = StereoTracker(PORT_CFG, vocabulary=tv, device="cpu")
    lc, s = tr.loop_closer, tr.store
    assert tr.mapper.on_kf_culled == lc.db.erase
    rng = np.random.default_rng(4)
    n, m = s.n_kp, 120
    base = rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    for k in range(5):
        feats = dict(xy=rng.uniform(0, 300, (n, 2)).astype(np.float32),
                     ur=np.full(n, -1.0, np.float32),
                     octave=np.zeros(n, np.int32),
                     angle=np.zeros(n, np.float32),
                     desc=np.zeros((n, 8), np.uint32),
                     valid=np.arange(n) < m)
        feats["desc"][:m] = base
        ids = np.full(n, -1, np.int32)
        kf = s.add_keyframe(np.eye(4, dtype=np.float32), feats,
                            np.full(n, 5.0, np.float32), ids, k)
        if k == 0:
            s.create_points(kf, np.arange(m),
                            rng.uniform(-1, 1, (m, 3)).astype(np.float32))
        else:
            s.kf_pt_ids[kf, :m] = s.kf_pt_ids[0, :m]
            s.mark_obs_dirty()
        lc.db.add(kf, *lc.voc.bow_vector(s.kf_desc[kf], s.kf_kp_valid[kf]))
    s.refresh_obs_counts()
    tr.mapper.cull_keyframes(4)
    live = [k for k in range(5) if s.kf_valid[k]]
    assert len(live) == 3 and 0 in live and 4 in live
    assert sorted(lc.db.kf_words) == live
    cands = lc.db.detect_reloc_candidates(*lc.voc.bow_vector(base))
    assert cands and all(s.kf_valid[c] for c in cands)
    tr._reset_full()
    assert tr.loop_closer is not lc
    assert tr.mapper.on_kf_culled == tr.loop_closer.db.erase


def test_system_loads_shipped_vocabulary():
    """System(cfg) turns loops on with the shipped vocabulary, read from the
    port's own copy (nothing under lldslam_tpu/ is read)."""
    cfg = PORT_CFG
    s = System(cfg, device="cpu")
    tr = s.tracker
    assert tr.enable_loops and tr.loop_closer is not None
    assert tr.vocabulary.n_words == 99106
    assert DEFAULT_VOCABULARY == (ROOT / "lldslam_tpu_torch" / "loop"
                                  / "vocab_synth.npz")
    assert [p.name for p in (ROOT / "lldslam_tpu_torch").rglob("*.npz")] \
        == ["vocab_synth.npz"]
    off = System(cfg, enable_loops=False, device="cpu")
    assert off.tracker.loop_closer is None
    s.reset()
    assert s.tracker.loop_closer is not tr.loop_closer
    assert s.tracker.vocabulary is tr.vocabulary


def test_vocabulary_copy_is_byte_identical():
    """The port's vocabulary file is the JAX package's, byte for byte."""
    ours = DEFAULT_VOCABULARY.read_bytes()
    assert ours == (ROOT / "lldslam_tpu" / "loop" / "vocab_synth.npz").read_bytes()
    assert len(ours) > 3_000_000
