"""The port's stereo rectification (lldslam_tpu_torch/ops/rectify.py) and
its EuRoC command line, on the CPU.

`make_rectify_maps` is host numpy in both packages and must agree bit for
bit. `remap` is a bilinear gather: the port and the JAX package evaluate
the same float32 expression, which XLA may contract into fused
multiply-adds, so the values are held within 1e-4 (a few ulps at 255) and
the BORDER_CONSTANT mask exactly.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_rectify as jtest_rectify  # noqa: E402
from lldslam_tpu.ops import rectify as jrect  # noqa: E402
from lldslam_tpu_torch import cli  # noqa: E402
from lldslam_tpu_torch.config import CameraConfig  # noqa: E402
from lldslam_tpu_torch.config import parse_opencv_yaml  # noqa: E402
from lldslam_tpu_torch.io.synthetic import euroc_blocks  # noqa: E402
from lldslam_tpu_torch.io.synthetic import make_sequence  # noqa: E402
from lldslam_tpu_torch.ops import rectify as trect  # noqa: E402

torch.set_num_threads(2)

# the EuRoC-like blocks: 752x480 views, radial-tangential distortion, a
# small rectifying rotation per view
EUROC = euroc_blocks()
K_L, D_L, R_L, P_L = (np.reshape(EUROC[f"LEFT.{k}"][2], EUROC[f"LEFT.{k}"][:2])
                      for k in "KDRP")
SIZE = (752, 480)


def test_make_rectify_maps_is_the_jax_function():
    want = jrect.make_rectify_maps(K_L, D_L, R_L, P_L, SIZE)
    got = trect.make_rectify_maps(K_L, D_L, R_L, P_L, SIZE)
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_remap_matches_jax_with_the_border():
    """A seeded image remapped by the EuRoC maps and by random maps that
    reach 5 px past every border: values within 1e-4, the zeroed
    BORDER_CONSTANT pixels the same."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (SIZE[1], SIZE[0])).astype(np.float32)
    mx, my = jrect.make_rectify_maps(K_L, D_L, R_L, P_L, SIZE)
    rx = rng.uniform(-5, SIZE[0] + 5, mx.shape).astype(np.float32)
    ry = rng.uniform(-5, SIZE[1] + 5, my.shape).astype(np.float32)
    for ax, ay, outside in ((mx, my, False), (rx, ry, True)):
        want = np.asarray(jrect.remap(jnp.asarray(img), jnp.asarray(ax),
                                      jnp.asarray(ay)))
        got = trect.remap(torch.from_numpy(img), torch.from_numpy(ax),
                          torch.from_numpy(ay)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got == 0, want == 0)
        assert ((want == 0).sum() > 1000) == outside
        assert np.abs(got - want).max() <= 1e-4


def test_stereo_rectifier_matches_jax():
    """StereoRectifier on the EuRoC blocks: the maps of both views equal
    the JAX rectifier's, a seeded uint8 pair rectifies within 1e-4."""
    want = jrect.StereoRectifier(EUROC)
    got = trect.StereoRectifier(EUROC, device="cpu")
    for w, g in zip(want.maps_l + want.maps_r, got.maps_l + got.maps_r):
        np.testing.assert_array_equal(g.numpy(), w)
    rng = np.random.default_rng(2)
    pair = rng.integers(0, 256, (2, SIZE[1], SIZE[0]), dtype=np.uint8)
    for w, g in zip(want(*pair), got(*pair)):
        assert g.device.type == "cpu"
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4


def test_remap_of_uint8_input():
    """A uint8 frame (as datasets give it) remaps as its float copy."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    mx, my = np.meshgrid(np.linspace(-1, 64, 64, dtype=np.float32),
                         np.linspace(-1, 48, 48, dtype=np.float32))
    a = trect.remap(torch.from_numpy(img), torch.from_numpy(mx),
                    torch.from_numpy(my))
    b = trect.remap(torch.from_numpy(img.astype(np.float32)),
                    torch.from_numpy(mx), torch.from_numpy(my))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_distorted_dot_through_the_port(monkeypatch):
    """tests/test_rectify.py's distorted-dot case with the port's maps and
    remap: the dot lands at its pinhole projection within 2 px."""
    monkeypatch.setattr(jtest_rectify, "rectify", _PortRectify)
    jtest_rectify.test_distorted_point_lands_at_pinhole_position()


class _PortRectify:
    """The JAX module's two functions, answered by the port."""

    make_rectify_maps = staticmethod(trect.make_rectify_maps)

    @staticmethod
    def remap(img, mx, my):
        return trect.remap(*(torch.from_numpy(np.asarray(a))
                             for a in (img, mx, my))).numpy()


def _matrix(name, M) -> str:
    M = np.atleast_2d(M)
    vals = ", ".join(f"{v:.10g}" for v in M.reshape(-1))
    return (f"{name}: !!opencv-matrix\n   rows: {M.shape[0]}\n   cols: "
            f"{M.shape[1]}\n   dt: d\n   data: [{vals}]\n")


def test_port_cli_euroc_rectified(tmp_path):
    """`python -m lldslam_tpu_torch.cli euroc settings seq times --device cpu
    --save-map map.npz` on a 3-frame EuRoC-layout sequence written here
    (mav0/cam{0,1}/data/<ns>.png, a times file, settings with the LEFT.* /
    RIGHT.* blocks): every pair is rectified, the TUM trajectory has three
    finite rows, the map checkpoint holds the keyframe, and the metrics say
    OK. The frames are pinhole renders treated as raw images with mild
    distortion, so rectification bends them slightly as real undistortion
    would."""
    PIL = pytest.importorskip("PIL.Image")
    cam = CameraConfig(fx=435.2047, fy=435.2047, cx=367.4518, cy=252.2005,
                       bf=47.9, width=752, height=480)
    frames = make_sequence(cam.stereo_camera(), 3, seed=3, half_w=3.0,
                           cam_h=1.2, speed=0.05)
    seq = tmp_path / "seq"
    stamps = [1403636579763555584 + 50_000_000 * i for i in range(3)]
    for view, k in (("cam0", 0), ("cam1", 1)):
        d = seq / "mav0" / view / "data"
        d.mkdir(parents=True)
        for s, f in zip(stamps, frames):
            PIL.fromarray(f[k]).save(d / f"{s}.png")
    times = tmp_path / "times.txt"
    times.write_text("\n".join(str(s) for s in stamps) + "\n")
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    P = np.concatenate([K, np.zeros((3, 1))], 1)
    P_r = P.copy()
    P_r[0, 3] = -cam.bf
    D = np.array([[-0.01, 0.002, 0.0, 0.0, 0.0]])
    text = "%YAML:1.0\n" + "".join(
        f"{k}: {v}\n" for k, v in (
            ("Camera.fx", cam.fx), ("Camera.fy", cam.fy),
            ("Camera.cx", cam.cx), ("Camera.cy", cam.cy),
            ("Camera.bf", cam.bf), ("Camera.fps", 20.0),
            ("Camera.width", 752), ("Camera.height", 480),
            ("ORBextractor.nFeatures", 1000), ("minInitPoints", 100),
            ("LEFT.height", 480), ("LEFT.width", 752),
            ("RIGHT.height", 480), ("RIGHT.width", 752)))
    for side, PP in (("LEFT", P), ("RIGHT", P_r)):
        text += (_matrix(f"{side}.D", D) + _matrix(f"{side}.K", K)
                 + _matrix(f"{side}.R", np.eye(3)) + _matrix(f"{side}.P", PP))
    settings = tmp_path / "EuRoC.yaml"
    settings.write_text(text)
    assert "LEFT.K" in parse_opencv_yaml(settings)

    out, metrics = tmp_path / "traj.txt", tmp_path / "m.jsonl"
    rc = cli.main(["euroc", str(settings), str(seq), str(times), "--out",
                   str(out), "--metrics", str(metrics), "--device", "cpu",
                   "--save-map", str(tmp_path / "map.npz")])
    assert rc == 0
    est = np.loadtxt(out)
    assert est.shape == (3, 8) and np.isfinite(est).all()
    np.testing.assert_allclose(est[:, 0], np.array(stamps) * 1e-9)
    ms = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [m["state"] for m in ms] == ["OK"] * 3
    with np.load(tmp_path / "map.npz") as z:
        n_kf, n_pt = z["__scalars__"][:2]
        assert n_kf >= 1 and n_pt > 100
