"""CPU parity of the port's frame build with the JAX package, at 640x240
with 600 ORB features on a bench._make_sequence frame.

Where the JAX package's arithmetic is fixed by its own float32 operations
(pyramid resize weights, the fused multiply-adds XLA emits for the blur, the
integer FAST/NMS/selection/orientation math) the port reproduces it bit for
bit. Two places are compared by tolerance, with the reason at each test:
the order in which XLA's CPU matrix product accumulates the resize, and the
bfloat16 SAD sums of the JAX package's CPU stereo route.
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
from lldslam_tpu.ops import fast as jfast  # noqa: E402
from lldslam_tpu.ops import image as jimage  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.ops import stereo as jstereo  # noqa: E402
from lldslam_tpu_torch.frontend import frame as tframe  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.ops import fast as tfast  # noqa: E402
from lldslam_tpu_torch.ops import image as timage  # noqa: E402
from lldslam_tpu_torch.ops import orb as torb  # noqa: E402
from lldslam_tpu_torch.ops import stereo as tstereo  # noqa: E402

torch.set_num_threads(2)

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                   fps=10.0, width=640, height=240).stereo_camera()
JCFG = jorb.OrbConfig(n_features=600)
TCFG = torb.OrbConfig(n_features=600)


@pytest.fixture(scope="module")
def pair():
    frames = _make_sequence(CAM, 2, n_per_m=25.0, seed=3)
    return np.stack(frames[1])


@pytest.fixture(scope="module")
def jax_pyr(pair):
    """The JAX package's quantized pyramid (bfloat16 levels) as float32."""
    pyr = jimage.build_pyramid(jnp.asarray(pair).astype(jnp.float32),
                               JCFG.n_levels, JCFG.scale, quantize=True)
    return [np.asarray(p.astype(jnp.float32)) for p in pyr]


def test_pyramid_levels(pair, jax_pyr):
    """Each level resized from the same previous level. The weights and the
    row pass reproduce JAX exactly; XLA's CPU matrix product accumulates the
    column pass in an order that depends on the level's shape, so a value
    within an ulp of x.5 may round the other way: at most 0.01% of a level's
    pixels may differ, each by exactly one level. Level 1 is exact."""
    tp = timage.build_pyramid(torch.from_numpy(pair.astype(np.float32)),
                              TCFG.n_levels, TCFG.scale, quantize=True)
    np.testing.assert_array_equal(tp[0].numpy(), jax_pyr[0])
    for l in range(1, TCFG.n_levels):
        got = torch.round(timage.resize_linear(
            torch.from_numpy(jax_pyr[l - 1]), jax_pyr[l].shape[-2:])).numpy()
        diff = np.abs(got - jax_pyr[l])
        assert diff.max() <= 1.0, l
        assert (diff > 0).mean() <= 1e-4, (l, int((diff > 0).sum()))
        if l == 1:
            assert (diff == 0).all()


def test_blur_fast_nms_exact(jax_pyr):
    """Blur (before and after rounding), FAST scores and NMS are exact on
    every level."""
    for lvl in jax_pyr:
        jb = np.asarray(jax.vmap(jimage.gaussian_blur)(
            jnp.asarray(lvl).astype(jnp.bfloat16)))
        tb = timage.gaussian_blur(torch.from_numpy(lvl)).numpy()
        np.testing.assert_array_equal(tb, jb)
        js = np.asarray(jax.vmap(lambda a: jfast.nms3x3(
            jfast.fast_score_map(a, JCFG.min_th)))(jnp.asarray(lvl)))
        ts = tfast.nms3x3(tfast.fast_score_map(torch.from_numpy(lvl),
                                               TCFG.min_th)).numpy()
        np.testing.assert_array_equal(ts, js)


def test_ic_angle_matches(jax_pyr):
    """Orientation of interior keypoints: the same integer moments, atan2
    within 1e-5 rad (the two atan2 implementations may differ by an ulp)."""
    rng = np.random.default_rng(0)
    img = jax_pyr[0][0]
    h, w = img.shape
    xy = np.stack([rng.integers(16, w - 16, 300), rng.integers(16, h - 16, 300)],
                  -1).astype(np.int32)
    want = np.asarray(jorb._ic_angle(jnp.asarray(img), jnp.asarray(xy)))
    got = torb._ic_angle(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extract_from_the_same_pyramid(jax_pyr):
    """Given JAX's pyramid: keypoint xy, octave, valid and response exact;
    angle within 1e-5 rad; descriptors identical for >= 99.5% of valid
    keypoints (a tap on a round() half-way point can flip through an ulp of
    sin/cos)."""
    jk = jorb.extract_stack_pyr(tuple(jnp.asarray(p) for p in jax_pyr), JCFG)
    jk = [np.asarray(x) for x in jk]
    tk = torb.extract_stack_pyr([torch.from_numpy(p) for p in jax_pyr], TCFG)
    for name, j, t in zip(("xy", "response", "octave"), jk[:3], tk[:3]):
        np.testing.assert_array_equal(t.numpy(), j.astype(t.numpy().dtype),
                                      err_msg=name)
    np.testing.assert_array_equal(tk.valid.numpy(), jk[5])
    v = jk[5]
    np.testing.assert_allclose(tk.angle.numpy()[v], jk[3][v], rtol=0, atol=1e-5)
    same = (tk.desc.numpy() == jk[4].view(np.int32)).all(-1)[v]
    print(f"descriptors differing: {int((~same).sum())} of {int(v.sum())}")
    assert same.mean() >= 0.995


def test_build_frame_pair_matches(pair, jax_pyr):
    """Whole frame build. Keypoints and descriptors agree on >= 99.5% of
    slots (the pyramid may differ at a handful of pixels, see
    test_pyramid_levels). Stereo is held against the JAX route that runs on
    the TPU: there the SAD windows come from the Pallas sampler as float32,
    while the JAX CPU route gathers from the bfloat16 levels and sums SAD in
    bfloat16 (~0.01 px noise on ur); JAX's match_stereo on float32 copies of
    the same levels reproduces the TPU arithmetic. ur within 1e-3 px and depth
    within 1e-4 relative on >= 99% of the keypoints matched by both; the
    matched sets agree on >= 99%."""
    jf = jframe.build_frame_pair(jnp.asarray(pair), CAM, JCFG)
    tf = tframe.build_frame_pair(torch.from_numpy(pair), StereoCamera(*CAM),
                                 TCFG)
    jfe = jax.tree.map(np.asarray, jf.feats)
    same_kp = ((tf.feats.xy.numpy() == jfe.xy).all(-1)
               & (tf.feats.octave.numpy() == jfe.octave)
               & (tf.feats.valid.numpy() == jfe.valid))
    assert same_kp.mean() >= 0.995
    v = jfe.valid & same_kp
    same_desc = (tf.feats.desc.numpy() == jfe.desc.view(np.int32)).all(-1)[v]
    assert same_desc.mean() >= 0.995

    kp = jorb.extract_stack_pyr(tuple(jnp.asarray(p) for p in jax_pyr), JCFG)
    kl = jax.tree.map(lambda a: a[0], kp)
    kr = jax.tree.map(lambda a: a[1], kp)
    ju, jd = jstereo.match_stereo(kl, kr, [jnp.asarray(p[0]) for p in jax_pyr],
                                  [jnp.asarray(p[1]) for p in jax_pyr], CAM,
                                  JCFG)
    ju, jd = np.asarray(ju), np.asarray(jd)
    tu, td = tf.feats.ur.numpy(), tf.depth.numpy()
    assert ((ju >= 0) == (tu >= 0)).mean() >= 0.99
    both = (ju >= 0) & (tu >= 0)
    assert both.sum() > 100
    assert (np.abs(ju - tu)[both] <= 1e-3).mean() >= 0.99
    assert (np.abs(jd - td)[both] <= 1e-4 * np.abs(jd[both])).mean() >= 0.99


def test_stereo_on_identical_keypoints(jax_pyr):
    """match_stereo alone on the same keypoints and float32 levels: matched
    sets identical, ur within 1e-3 px everywhere."""
    kp = jorb.extract_stack_pyr(tuple(jnp.asarray(p) for p in jax_pyr), JCFG)
    kl = jax.tree.map(lambda a: a[0], kp)
    kr = jax.tree.map(lambda a: a[1], kp)
    ju, _ = jstereo.match_stereo(kl, kr, [jnp.asarray(p[0]) for p in jax_pyr],
                                 [jnp.asarray(p[1]) for p in jax_pyr], CAM, JCFG)
    from lldslam_tpu_torch import interop
    tk = interop.keypoints(kp)
    tpyr = [torch.from_numpy(p) for p in jax_pyr]
    hw = torch.tensor([p.shape[-2:] for p in jax_pyr], dtype=torch.int32)
    tu, _ = tstereo.match_stereo(tk.view_of(0), tk.view_of(1),
                                 torb.stack_levels(tpyr), hw,
                                 StereoCamera(*CAM), TCFG)
    ju, tu = np.asarray(ju), tu.numpy()
    np.testing.assert_array_equal(tu >= 0, ju >= 0)
    assert np.abs(tu - ju)[ju >= 0].max() <= 1e-3
