"""CPU parity of the plain versions of the port's three fused kernels with
the JAX package.

K1a (ops/orb_describe.py) against the JAX orientation and BRIEF
(`orb._ic_angle`, `orb._brief_desc`), K1b (ops/stereo_sad.py) through
`stereo.match_stereo` against the JAX `match_stereo` on identical keypoints,
and K2g (ops/match_best2.py) through `search_by_projection` against the JAX
`search_by_projection` on a scene with tied columns and competing rows. On
the CPU each wrapper takes its plain version; the CUDA kernels are held to
those plain versions on the card (tests/test_torch_cuda.py). Inputs are made
with numpy from a seed and handed to both sides. The kernels' constant tables
are held to the port's own copies here, since no compiler runs on the CPU.
"""
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lldslam_tpu.config import CameraConfig  # noqa: E402
from lldslam_tpu.frontend import matching as jm  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.ops import stereo as jstereo  # noqa: E402
from lldslam_tpu_torch import interop  # noqa: E402
from lldslam_tpu_torch.frontend import matching as tm  # noqa: E402
from lldslam_tpu_torch.geometry.camera import StereoCamera  # noqa: E402
from lldslam_tpu_torch.ops import match_best2, orb_describe, stereo_sad  # noqa: E402
from lldslam_tpu_torch.ops import orb as torb  # noqa: E402
from lldslam_tpu_torch.ops import stereo as tstereo  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "lldslam_tpu_torch" / "csrc"
JCAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                    fps=10.0, width=640, height=240).stereo_camera()
CAM = StereoCamera(*JCAM)
LEVEL_HW = [(240, 320), (200, 267), (167, 222)]   # three levels, x1.2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(seed):
    """Integer-valued float32 levels of both views: (L, 2, h, w)."""
    rng = np.random.default_rng(seed)
    return [np.round(rng.uniform(0, 255, (2, h, w))).astype(np.float32)
            for h, w in LEVEL_HW]


def _margin_keypoints(rng, h, w, n):
    """Level coords at 16-18 px from every border (the detection margin is
    16 px and the BRIEF taps reach 18 px, so the clamp is exercised) and in
    the interior."""
    edge = rng.integers(16, 19, (n, 2))
    far = np.stack([w - 1 - edge[:, 0], h - 1 - edge[:, 1]], -1)
    inner = np.stack([rng.integers(16, w - 16, n), rng.integers(16, h - 16, n)], -1)
    pick = rng.integers(0, 3, (n, 2))
    xy = np.where(pick == 0, edge, np.where(pick == 1, far, inner))
    return xy.astype(np.int32)


def test_k1a_plain_equals_jax_orientation_and_brief():
    """Per level and view of a seeded pyramid: angles within 1e-5 rad (the
    tolerance of tests/test_torch_frontend.py::test_ic_angle_matches: the
    two atan2 implementations may differ by an ulp), descriptors exact."""
    rng = np.random.default_rng(0)
    pyr, blur = _levels(1), _levels(2)
    xy, idx, want_a, want_d = [], [], [], []
    for l, (h, w) in enumerate(LEVEL_HW):
        for v in range(2):
            k = _margin_keypoints(rng, h, w, 60)
            xy.append(k)
            idx.append(np.full(len(k), 2 * l + v, np.int32))
            a = jorb._ic_angle(jnp.asarray(pyr[l][v]), jnp.asarray(k))
            want_a.append(np.asarray(a))
            want_d.append(np.asarray(jorb._brief_desc(
                jnp.asarray(blur[l][v]), jnp.asarray(k), a)).view(np.int32))
    stack = torb.stack_levels([_t(p) for p in pyr])
    bstack = torb.stack_levels([_t(p) for p in blur])
    image_hw = [hw for hw in LEVEL_HW for _ in range(2)]
    angle, desc = orb_describe.describe(stack, bstack, _t(np.concatenate(xy)),
                                        _t(np.concatenate(idx)), image_hw)
    np.testing.assert_allclose(angle.numpy(), np.concatenate(want_a), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(desc.numpy(), np.concatenate(want_d))


def _stereo_keypoints(rng, n_per_level):
    """Left keypoints near the margins of each level, right keypoints at a
    disparity of 2-40 level px with the same descriptors; returned as JAX
    Keypoints fields (level-0 coords)."""
    scales = torb.OrbConfig().scale_factors()
    xs, oct_, xr = [], [], []
    for l, (h, w) in enumerate(LEVEL_HW):
        k = _margin_keypoints(rng, h, w, n_per_level).astype(np.float32)
        k[:, 0] = np.clip(k[:, 0], 45, w - 17)
        d = rng.integers(2, 41, n_per_level)
        xs.append(k * np.float32(scales[l]))
        r = k.copy()
        r[:, 0] -= d
        xr.append(r * np.float32(scales[l]))
        oct_.append(np.full(n_per_level, l, np.int32))
    n = n_per_level * len(LEVEL_HW)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)

    def kp(xy):
        return dict(xy=np.concatenate(xy), response=np.ones(n, np.float32),
                    octave=np.concatenate(oct_), angle=np.zeros(n, np.float32),
                    desc=desc, valid=np.ones(n, bool))
    return kp(xs), kp(xr)


def test_k1b_plain_equals_jax_sad_stage():
    """match_stereo on identical keypoints and float32 levels, three levels,
    windows clamped at the borders, plus flat windows that force SAD ties:
    matched set identical and u_right exact (the SAD sums are integers, the
    parabola and the refined u follow the JAX operation order). The
    kernel's own outputs reproduce u_right."""
    rng = np.random.default_rng(3)
    pyr = _levels(4)
    pyr[0][:, 100:140, :] = 50.0                  # flat band: all SADs tie
    kl, kr = _stereo_keypoints(rng, 40)
    kl["xy"][:6, 1] = kr["xy"][:6, 1] = 120.0
    jl, jr = jorb.Keypoints(**kl), jorb.Keypoints(**kr)
    ju, _ = jstereo.match_stereo(
        jl, jr, [jnp.asarray(p[0]) for p in pyr],
        [jnp.asarray(p[1]) for p in pyr], JCAM, jorb.OrbConfig())
    ju = np.asarray(ju)
    tl, tr = interop.keypoints(kl), interop.keypoints(kr)
    stack = torb.stack_levels([_t(p) for p in pyr])
    tu, _ = tstereo.match_stereo(tl, tr, stack, LEVEL_HW, CAM, torb.OrbConfig())
    np.testing.assert_array_equal(tu.numpy() >= 0, ju >= 0)
    assert (ju >= 0).sum() > 60
    np.testing.assert_array_equal(tu.numpy()[ju >= 0], ju[ju >= 0])

    sl = torch.tensor(torb.OrbConfig().scale_factors(),
                      dtype=torch.float32)[tl.octave.long()]
    ul = torch.round(tl.xy[:, 0] * (1.0 / sl)).to(torch.int32)
    vl = torch.round(tl.xy[:, 1] * (1.0 / sl)).to(torch.int32)
    ur = torch.round(tr.xy[:, 0] * (1.0 / sl)).to(torch.int32)
    best_d, best_c, delta = stereo_sad.sad_refine(stack, LEVEL_HW, tl.octave,
                                                  ul, vl, ur)
    assert best_d.dtype == torch.int32 and (best_c[:6] == 0).all()
    assert (best_d[:6] == 0).all() and (delta[:6] == 0).all()
    u_ref = (ur.float() + (best_d - 5).float() + delta) * sl
    np.testing.assert_array_equal(u_ref.numpy()[ju >= 0], ju[ju >= 0])


def _projection_scene(seed, P=512, N=256):
    """Map points in front of a camera and keypoints at their projections,
    with tied columns (duplicated keypoints: same position, octave and
    descriptor), competing rows (duplicated map points) and distractors."""
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(0, 0.2, 3)
    n_pt = P - 32
    Xc = np.stack([rng.uniform(-5, 5, n_pt), rng.uniform(-2, 2, n_pt),
                   rng.uniform(4, 20, n_pt)], -1)
    X = (Xc - T[:3, 3]).astype(np.float32)
    X[n_pt - 16:] = X[:16]                          # competing rows
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32)
    desc[n_pt - 16:n_pt] = desc[:16]
    Xcam = X + T[:3, 3]
    u = CAM.fx * Xcam[:, 0] / Xcam[:, 2] + CAM.cx
    v = CAM.fy * Xcam[:, 1] / Xcam[:, 2] + CAM.cy
    ur = u - CAM.bf / Xcam[:, 2]
    centre = -T[:3, 3]
    dist = np.linalg.norm(X - centre, axis=-1)
    octave = rng.integers(0, 3, n_pt).astype(np.int32)
    pad = lambda a, fill=0: np.concatenate(
        [a, np.full((P - n_pt,) + a.shape[1:], fill, a.dtype)])
    view = dict(pos=pad(X), desc=desc,
                normal=pad(((X - centre) / dist[:, None]).astype(np.float32)),
                min_dist=pad((dist * 0.5).astype(np.float32)),
                max_dist=pad((dist * 1.2 ** octave * 1.1).astype(np.float32)),
                valid=np.arange(P) < n_pt)
    seen = rng.choice(n_pt - 16, 200, replace=False)
    xy = np.stack([rng.uniform(0, CAM.width, N), rng.uniform(0, CAM.height, N)],
                  -1).astype(np.float32)
    xy[:200, 0] = u[seen] + rng.normal(0, 0.4, 200)
    xy[:200, 1] = v[seen] + rng.normal(0, 0.4, 200)
    fur = np.full(N, -1.0, np.float32)
    st = rng.uniform(size=200) < 0.6
    fur[:200][st] = (ur[seen] + rng.normal(0, 0.4, 200))[st]
    foct = rng.integers(0, 3, N).astype(np.int32)
    foct[:200] = octave[seen]
    fdesc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    flips = (rng.uniform(size=(200, 8, 32)) < 0.05)
    fdesc[:200] = desc[seen] ^ (flips * (1 << np.arange(32, dtype=np.uint64))
                                ).sum(-1).astype(np.uint32)
    # tied columns: copies of keypoints 0-19, one octave lower where that
    # stays inside the predicted-octave gate, so the ratio test (which
    # rejects a tie on one level) lets the lower column win
    dup = slice(N - 24, N - 4)
    xy[dup], fur[dup], fdesc[dup] = xy[:20], fur[:20], fdesc[:20]
    foct[dup] = np.maximum(foct[:20] - 1, 0)
    valid = rng.uniform(size=N) < 0.97
    valid[dup] = valid[:20] = True
    feats = dict(xy=xy, ur=fur, octave=foct,
                 angle=rng.uniform(-np.pi, np.pi, N).astype(np.float32),
                 desc=fdesc, valid=valid)
    return T, view, feats


@pytest.mark.parametrize("seed,th", [(0, 1.0), (1, 2.5)])
def test_k2g_search_by_projection_equals_jax(seed, th):
    """search_by_projection through the K2g plain version, M=512 rows and
    N=256 keypoints with tied columns and competing rows: pt2kp and kp2pt
    exact against the JAX package."""
    T, view, feats = _projection_scene(seed)
    jv = jm.MapPointView(**{k: jnp.asarray(v) for k, v in view.items()})
    jf = jm.FrameFeatures(**{k: jnp.asarray(v) for k, v in feats.items()})
    want = jm.search_by_projection(JCAM, jnp.asarray(T), jv, jf, th=th)
    before = match_best2.launches
    got = tm.search_by_projection(CAM, _t(T), interop.map_point_view(view),
                                  interop.frame_features(feats), th=th)
    assert match_best2.launches == before
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0].numpy() >= 0).sum() > 100
    # keypoints with a tied copy were matched (to the lower column, as the
    # equality with JAX shows)
    assert (got[1].numpy()[:20] >= 0).sum() >= 5


def _c_table(src: str, name: str) -> np.ndarray:
    body = re.search(name + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", src).group(1)
    return np.array([int(x) for x in body.replace("\n", " ").split(",")
                     if x.strip()])


def test_k1a_constant_tables_are_the_ports():
    """The BRIEF pairs and the circular patch's umax table compiled into the
    K1a kernel equal ops/orb_pattern.npy and the port's umax table; the
    patch has 749 pixels."""
    src = (CSRC / "orb_describe.cu").read_text()
    np.testing.assert_array_equal(_c_table(src, "kPattern"),
                                  orb_describe._pattern().reshape(-1))
    np.testing.assert_array_equal(_c_table(src, "kUmax"),
                                  orb_describe.umax_table())
    assert len(orb_describe.IC_DX) == 749
