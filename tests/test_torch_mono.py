"""The port's monocular path against the JAX package, on the CPU.

Single-view ORB extraction detects on the float (unquantized) pyramid and
rounds only inside the orientation and the blur; the port feeds K1a's plain
version round(level) and round(blur(level)). Measured on a 512x384 frame of
the bench corridor: float pyramid levels 0-3 exact and levels 4-7 within
two float32 ulps of 255 (XLA's CPU matrix product sums the column pass of
the resize in another order), so the levels are held within 1e-4; keypoints,
octaves, descriptors and init matches came out identical, and a keypoint may
differ only where a FAST score sits at a comparison (bounded at 0.5% of the
slots).

The whole-slice test runs the monocular world of tests/test_mono.py (12
frames of sideways motion, seed 17, 512x384, 600 features) through both
Systems. The bootstrap's RANSAC draws from different generators (jax.random
against torch.Generator), so the maps differ in detail: the test holds the
first OK frame, no LOST frame, the map size within 20% and the direction of
travel (cosine > 0.7 against the ground truth, > 0.95 against the JAX run).
"""
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import _make_sequence  # noqa: E402
from test_pipeline import _config, _make_world, _render  # noqa: E402
from lldslam_tpu.frontend import frame as jframe  # noqa: E402
from lldslam_tpu.frontend import matching as jmatch  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.ops import image as jimage  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.frontend import matching as tmatch  # noqa: E402
from lldslam_tpu_torch.ops import image as timage  # noqa: E402
from lldslam_tpu_torch.ops import orb as torb  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

JCFG = jorb.OrbConfig(n_features=600)
TCFG = torb.OrbConfig(n_features=600)


@pytest.fixture(scope="module")
def images():
    """Frames 0 and 2 of the bench corridor at 512x384 (left views)."""
    cam = _config().camera.stereo_camera()
    frames = _make_sequence(cam, 3, n_per_m=25.0, seed=3)
    return frames[0][0], frames[2][0]


def test_float_pyramid_levels(images):
    """build_pyramid(quantize=False): level 0 is the image, every level
    within 1e-4 (two float32 ulps at 255 is 3.1e-5) of JAX's."""
    img = images[0].astype(np.float32)
    jp = jimage.build_pyramid(jnp.asarray(img), JCFG.n_levels, JCFG.scale)
    tp = timage.build_pyramid(torch.from_numpy(img), TCFG.n_levels,
                              TCFG.scale)
    np.testing.assert_array_equal(tp[0].numpy(), img)
    for l, (j, t) in enumerate(zip(jp, tp)):
        assert t.shape == j.shape, l
        d = np.abs(t.numpy() - np.asarray(j))
        print(f"level {l}: max diff {d.max():.2e}, differing share "
              f"{(d > 0).mean():.4f}")
        assert d.max() <= 1e-4, l


def _same_keypoints(t, j):
    """Slots whose xy, octave and valid agree."""
    return ((t.xy.numpy() == np.asarray(j.xy)).all(-1)
            & (t.octave.numpy() == np.asarray(j.octave))
            & (t.valid.numpy() == np.asarray(j.valid)))


def test_extract_matches_jax(images):
    """orb.extract: keypoints and octaves equal on >= 99.5% of the slots
    (the rest at a FAST comparison); there the FAST response within 1e-4
    (it is a difference of float levels), the angle within 1e-5 rad, and
    the descriptors equal on >= 99.5% of the valid slots."""
    img = images[0].astype(np.float32)
    jk = jorb.extract(jnp.asarray(img), JCFG)
    tk = torb.extract(torch.from_numpy(img), TCFG)
    same = _same_keypoints(tk, jk)
    print(f"keypoint slots differing: {int((~same).sum())} of {len(same)}")
    assert same.mean() >= 0.995
    v = same & np.asarray(jk.valid)
    assert v.sum() > 300
    np.testing.assert_allclose(tk.response.numpy()[v],
                               np.asarray(jk.response)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tk.angle.numpy()[v], np.asarray(jk.angle)[v],
                               rtol=0, atol=1e-5)
    sd = (tk.desc.numpy() == np.asarray(jk.desc).view(np.int32)).all(-1)[v]
    print(f"descriptors differing: {int((~sd).sum())} of {int(v.sum())}")
    assert sd.mean() >= 0.995


def test_build_frame_mono_matches(images):
    """build_frame_mono: the extract's features, ur and depth -1 on every
    slot."""
    jf = jframe.build_frame_mono(jnp.asarray(images[1]), JCFG)
    tf = tframe.build_frame_mono(torch.from_numpy(images[1]), TCFG)
    same = _same_keypoints(tf.feats, jf.feats)
    assert same.mean() >= 0.995
    v = same & np.asarray(jf.feats.valid)
    sd = (tf.feats.desc.numpy()
          == np.asarray(jf.feats.desc).view(np.int32)).all(-1)[v]
    assert sd.mean() >= 0.995
    assert (tf.feats.ur.numpy() == -1).all() and (tf.depth.numpy() == -1).all()
    np.testing.assert_array_equal(tf.feats.ur.numpy(), np.asarray(jf.feats.ur))


def test_search_for_initialization_matches(images):
    """The bootstrap matcher on the same features: identical indices."""
    f0 = jframe.build_frame_mono(jnp.asarray(images[0]), JCFG).feats
    f1 = jframe.build_frame_mono(jnp.asarray(images[1]), JCFG).feats
    want = np.asarray(jmatch.search_for_initialization(f0, f1))
    got = tmatch.search_for_initialization(interop.frame_features(f0),
                                           interop.frame_features(f1))
    print(f"{int((want >= 0).sum())} matches")
    assert (want >= 0).sum() >= 30
    np.testing.assert_array_equal(got.numpy(), want)


def _mono_run(system, frames):
    states = []
    for i, img in enumerate(frames):
        _, m = system.track_monocular(img, timestamp=i * 0.1)
        states.append(m.state)
    _, T_wc = system.tracker.trajectory()
    return states, T_wc, int(system.map.pt_valid.sum())


def test_whole_slice_mono_matches_jax():
    """tests/test_mono.py's world through the JAX System and the port's:
    the same first OK frame (by frame 4), OK from there on in both, the
    port's valid map points within 20% of JAX's, and the direction of
    travel from the first tracked frame to the last with cosine > 0.7
    against the ground truth and > 0.95 against the JAX run."""
    rng = np.random.default_rng(17)
    pts, patches = _make_world(rng, n=500)
    jcfg = _config()
    cam = jcfg.camera.stereo_camera()
    n_frames = 12
    gt, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        gt.append(T.copy())
        xi = np.array([0.18, 0.0, -0.12, 0.0, 0.003, 0.0], np.float32)
        T = np.asarray(jse3.exp(jnp.asarray(xi)) @ jnp.asarray(T))
    frames = [_render(cam, g, pts, patches)[0] for g in gt]

    jsys = JSystem(jcfg)
    jsys.tracker.local_pt_cap = 2048
    jsys.tracker.mapper.p_cap = 2048
    jsys.tracker.mapper.o_cap = 6144
    tsys = System(interop.slam_config(asdict(jcfg)), device="cpu")
    tsys.tracker.mapper.p_cap = 2048
    tsys.tracker.mapper.o_cap = 6144
    j_states, j_T, j_pts = _mono_run(jsys, frames)
    t_states, t_T, t_pts = _mono_run(tsys, frames)
    print(f"states jax {j_states} port {t_states}; points jax {j_pts} port "
          f"{t_pts}")
    first = j_states.index("OK")
    assert first <= 4
    assert t_states.index("OK") == first
    for states in (j_states, t_states):
        assert states[first:] == ["OK"] * (n_frames - first), states
    assert abs(t_pts - j_pts) <= 0.2 * j_pts

    gt_p = np.stack([np.linalg.inv(g @ np.linalg.inv(gt[0]))[:3, 3]
                     for g in gt[n_frames - len(t_T):]])
    unit = lambda p: (p[-1] - p[0]) / np.linalg.norm(p[-1] - p[0])
    d_gt, d_j, d_t = unit(gt_p), unit(j_T[:, :3, 3]), unit(t_T[:, :3, 3])
    print(f"direction cosine: port-gt {d_t @ d_gt:.4f}, jax-gt "
          f"{d_j @ d_gt:.4f}, port-jax {d_t @ d_j:.4f}")
    assert d_t @ d_gt > 0.7
    assert d_t @ d_j > 0.95
