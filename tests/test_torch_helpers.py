"""CPU parity of the port's small helpers with the JAX package.

Each helper of the port is held to its JAX counterpart on seeded numpy
inputs: the camera's intrinsic matrix, stereo projection, disparity to depth
and the image bounds test (geometry/camera.py); vee, the SO(3) exponential,
compose, retract and identity (geometry/se3.py); the Hamming cross-check
(ops/hamming.py::mutual_filter); host gray conversion
(ops/image.py::to_gray_f32); the two-image frame build
(frontend/frame.py::build_frame); the keypoint set's capacity. Integers and
booleans exact; floats within 1e-6 of max(1, |JAX value|). The two-image
frame build equals the port's `build_frame_pair` of the stacked pair
exactly and agrees with JAX's `build_frame` as
tests/test_torch_frontend.py::test_build_frame_pair_matches holds the
stacked build (the pyramid may round a handful of pixels differently).

Bundle adjustment with the dense reduced system (`ba_solve(dense=True)`,
the JAX default) on the scene of tests/test_optim.py::TestBA (150 points,
5 keyframes, poses perturbed by 0.05 and points by 0.3, 10 iterations):
poses within 1e-4 and points within 1e-3 of the JAX solve; the CG route
(`dense=False`) and the dense route both recover the scene.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import _make_sequence  # noqa: E402
from lldslam_tpu.config import CameraConfig  # noqa: E402
from lldslam_tpu.frontend import frame as jframe  # noqa: E402
from lldslam_tpu.geometry import camera as jcam  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.ops import hamming as jham  # noqa: E402
from lldslam_tpu.ops import image as jimage  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.optim import ba as jba  # noqa: E402
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.geometry import camera as tcam  # noqa: E402
from lldslam_tpu_torch.geometry import se3 as tse3  # noqa: E402
from lldslam_tpu_torch.ops import hamming as tham  # noqa: E402
from lldslam_tpu_torch.ops import image as timage  # noqa: E402
from lldslam_tpu_torch.ops import orb as torb  # noqa: E402
from lldslam_tpu_torch.optim import ba as tba  # noqa: E402

torch.set_num_threads(2)

JCAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                    fps=10.0, width=640, height=240).stereo_camera()
TCAM = tcam.StereoCamera(*JCAM)


def _rng(name: str):
    return np.random.default_rng(sum(map(ord, name)))


def _points(rng, n=64):
    X = rng.uniform([-8, -3, -1], [8, 3, 30], (n, 3)).astype(np.float32)
    X[:4, 2] = [0.0, 1e-10, -2.0, 5.0]
    return X


def _xi(rng, n=32, scale=1.0):
    xi = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    xi[0, 3:] = 0.0                      # the small-angle branch
    xi[1, 3:] = 1e-4
    return xi


def _case(name: str):
    """(port result, JAX result) of one helper on seeded inputs."""
    rng = _rng(name)
    J, T = jnp.asarray, torch.from_numpy
    if name == "K":
        return TCAM.K(), JCAM.K()
    if name == "project_stereo":
        X = _points(rng)
        return tcam.project_stereo(TCAM, T(X)), jcam.project_stereo(JCAM, J(X))
    if name == "disparity_to_depth":
        uL = rng.uniform(0, 640, 256).astype(np.float32)
        uR = (uL - rng.uniform(-5, 60, 256)).astype(np.float32)
        uR[:3] = uL[:3]
        return (tcam.disparity_to_depth(TCAM, T(uL), T(uR)),
                jcam.disparity_to_depth(JCAM, J(uL), J(uR)))
    if name.startswith("in_image"):
        uv = rng.uniform([-20, -20], [660, 260], (512, 2)).astype(np.float32)
        uv[:4] = [[0, 0], [640, 10], [639.99, 239.99], [5, 240]]
        m = 0.0 if name == "in_image" else 19.0
        return (tcam.in_image(TCAM, T(uv), m), jcam.in_image(JCAM, J(uv), m))
    if name == "vee":
        W = rng.normal(size=(16, 3, 3)).astype(np.float32)
        return tse3.vee(T(W)), jse3.vee(J(W))
    if name == "so3_exp":
        w = _xi(rng)[:, 3:].copy()
        return tse3.so3_exp(T(w)), jse3.so3_exp(J(w))
    if name == "compose":
        A = jse3.exp(J(_xi(rng)))
        B = jse3.exp(J(_xi(rng)))
        A, B = np.array(A), np.array(B)
        return tse3.compose(T(A), T(B)), jse3.compose(J(A), J(B))
    if name == "retract":
        Tm = np.array(jse3.exp(J(_xi(rng))))
        xi = _xi(rng, scale=0.1)
        return tse3.retract(T(Tm), T(xi)), jse3.retract(J(Tm), J(xi))
    if name == "identity":
        return (tse3.identity((3, 2)), jse3.identity((3, 2)))
    if name == "mutual_filter":
        ab = rng.integers(0, 40, 50)
        ba_ = rng.integers(0, 50, 40)
        ba_[ab[:20]] = np.arange(20)
        return (tham.mutual_filter(T(ab), T(ba_)),
                jham.mutual_filter(J(ab), J(ba_)))
    if name.startswith("to_gray_f32"):
        shape = (24, 32, 3) if name.endswith("bgr") else (24, 32)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        return timage.to_gray_f32(img), jimage.to_gray_f32(img)
    if name == "capacity":
        n = torb.OrbConfig(n_features=600).max_kp
        tk = torb.Keypoints(*(torch.zeros((2, n) + s) for s in
                              ((2,), (), (), (), (8,), ())))
        jk = jorb.Keypoints(*(jnp.zeros((n,) + s) for s in
                              ((2,), (), (), (), (8,), ())))
        return tk.capacity, jk.capacity
    raise KeyError(name)


HELPERS = ["K", "project_stereo", "disparity_to_depth", "in_image",
           "in_image_margin", "vee", "so3_exp", "compose", "retract",
           "identity", "mutual_filter", "to_gray_f32", "to_gray_f32_bgr",
           "capacity"]


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_jax(name):
    got, want = _case(name)
    if isinstance(want, int):
        assert isinstance(got, int) and got == want
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.isfinite(got).all() == np.isfinite(want).all()
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= 1e-6 * np.maximum(1.0, np.abs(want))).all(), \
            err.max()


def test_build_frame_matches_jax():
    """The two-image wrapper: the port's build_frame equals its
    build_frame_pair of the stacked pair exactly, and JAX's build_frame
    as the stacked build agrees (keypoints and descriptors on >= 99.5% of
    the slots)."""
    left, right = _make_sequence(JCAM, 2, n_per_m=25.0, seed=3)[1]
    cfg = torb.OrbConfig(n_features=600)
    tf = tframe.build_frame(left, right, TCAM, cfg)
    tp = tframe.build_frame_pair(torch.from_numpy(np.stack([left, right])),
                                 TCAM, cfg)
    for a, b in zip(jax.tree.leaves(tuple(tf)), jax.tree.leaves(tuple(tp))):
        assert torch.equal(a, b)
    jf = jax.tree.map(np.asarray, jframe.build_frame(
        jnp.asarray(left), jnp.asarray(right), JCAM,
        jorb.OrbConfig(n_features=600)).feats)
    same_kp = ((tf.feats.xy.numpy() == jf.xy).all(-1)
               & (tf.feats.octave.numpy() == jf.octave)
               & (tf.feats.valid.numpy() == jf.valid))
    assert same_kp.mean() >= 0.995
    v = jf.valid & same_kp
    assert (tf.feats.desc.numpy() == jf.desc.view(np.int32)).all(-1)[v] \
        .mean() >= 0.995


# the scene of tests/test_optim.py::TestBA, from a generator of its own
BA_CAM = jcam.StereoCamera(fx=718.856, fy=718.856, cx=607.19, cy=185.21,
                           bf=386.1448, width=1241, height=376)


def _ba_scene(n_pts=150, n_kf=5):
    rng = np.random.default_rng(42)
    pts = rng.uniform([-10, -4, 5], [10, 4, 40],
                      size=(n_pts, 3)).astype(np.float32)
    xi = np.stack([np.linspace(0, 3, n_kf), np.zeros(n_kf),
                   np.linspace(0, 0.5, n_kf), np.zeros(n_kf),
                   np.linspace(0, 0.15, n_kf), np.zeros(n_kf)],
                  -1).astype(np.float32)
    Tt = np.array(jse3.exp(jnp.asarray(xi)))
    obs = np.array(jcam.project_stereo(
        BA_CAM, jse3.apply(jnp.asarray(Tt)[:, None], jnp.asarray(pts)[None])))
    dxi = np.concatenate([np.zeros((1, 6)), rng.normal(size=(n_kf - 1, 6))
                          * 0.05]).astype(np.float32)
    T0 = np.array(jse3.exp(jnp.asarray(dxi)) @ jnp.asarray(Tt))
    p0 = (pts + rng.normal(size=pts.shape) * 0.3).astype(np.float32)
    ks, ps = np.meshgrid(np.arange(n_kf), np.arange(n_pts), indexing="ij")
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return dict(T=Tt, pts=pts, T0=T0, p0=p0, k=ks.ravel().astype(np.int32),
                p=ps.ravel().astype(np.int32),
                uvr=obs.reshape(-1, 3).astype(np.float32), fixed=fixed)


def _ba_jax(sc, dense):
    n = len(sc["k"])
    prob = jba.BAProblem(
        poses=jnp.asarray(sc["T0"]), points=jnp.asarray(sc["p0"]),
        pose_fixed=jnp.asarray(sc["fixed"]),
        point_valid=jnp.ones(len(sc["p0"]), bool),
        obs=jba.BAObs(k=jnp.asarray(sc["k"]), p=jnp.asarray(sc["p"]),
                      uvr=jnp.asarray(sc["uvr"]), inv_sigma2=jnp.ones(n),
                      is_stereo=jnp.ones(n, bool), valid=jnp.ones(n, bool)))
    out, _ = jba.ba_solve(BA_CAM, prob, iters=10, dense=dense, cg_iters=40)
    return np.asarray(out.poses), np.asarray(out.points)


def _ba_torch(sc, dense):
    n = len(sc["k"])
    T = torch.from_numpy
    prob = tba.BAProblem(
        poses=T(sc["T0"]), points=T(sc["p0"]), pose_fixed=T(sc["fixed"]),
        point_valid=torch.ones(len(sc["p0"]), dtype=torch.bool),
        obs=tba.BAObs(k=T(sc["k"]).long(), p=T(sc["p"]).long(),
                      uvr=T(sc["uvr"]), inv_sigma2=torch.ones(n),
                      is_stereo=torch.ones(n, dtype=torch.bool),
                      valid=torch.ones(n, dtype=torch.bool)))
    out, _ = tba.ba_solve(tcam.StereoCamera(*BA_CAM), prob, iters=10,
                          dense=dense, cg_iters=40)
    return out.poses.numpy(), out.points.numpy()


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "cg"])
def test_ba_solve_matches_jax(dense):
    """ba_solve on the test_optim scene against the JAX solve of the same
    route: poses within 1e-4, points within 1e-3; both recover the scene
    as tests/test_optim.py::TestBA asks (pose error below 1% of the
    perturbation + 1e-4, median point error below 0.02)."""
    sc = _ba_scene()
    (tP, tX), (jP, jX) = _ba_torch(sc, dense), _ba_jax(sc, dense)
    print(f"dense={dense}: poses {np.abs(tP - jP).max():.2e}, points "
          f"{np.abs(tX - jX).max():.2e}")
    assert np.abs(tP - jP).max() <= 1e-4
    assert np.abs(tX - jX).max() <= 1e-3
    Tt = torch.from_numpy(sc["T"])
    err = lambda P: float(torch.linalg.norm(tse3.log(
        torch.from_numpy(P) @ tse3.inv(Tt)), dim=-1).max())
    assert err(tP) < 0.01 * err(sc["T0"]) + 1e-4
    assert np.median(np.linalg.norm(tX - sc["pts"], axis=-1)) < 0.02


def test_ba_solve_dense_refuses_reduce_hooks():
    sc = _ba_scene(20, 3)
    n = len(sc["k"])
    T = torch.from_numpy
    prob = tba.BAProblem(
        poses=T(sc["T0"]), points=T(sc["p0"]), pose_fixed=T(sc["fixed"]),
        point_valid=torch.ones(20, dtype=torch.bool),
        obs=tba.BAObs(k=T(sc["k"]).long(), p=T(sc["p"]).long(),
                      uvr=T(sc["uvr"]), inv_sigma2=torch.ones(n),
                      is_stereo=torch.ones(n, dtype=torch.bool),
                      valid=torch.ones(n, dtype=torch.bool)))
    with pytest.raises(ValueError, match="reduce hooks"):
        tba.ba_solve(tcam.StereoCamera(*BA_CAM), prob, dense=True,
                     reduce_poses=lambda x: x)
