"""The PyTorch port's host-side inputs and outputs against the JAX package:
the numpy sequence generator, the BRIEF pattern table, configuration
parsing, trajectory export and the interop conversions. Inputs are made
with numpy from a seed and handed to both sides.
"""
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import _make_sequence  # noqa: E402
from lldslam_tpu import config as jconfig  # noqa: E402
from lldslam_tpu.frontend import frame as jframe  # noqa: E402
from lldslam_tpu.frontend import matching as jmatching  # noqa: E402
from lldslam_tpu.geometry import camera as jcamera  # noqa: E402
from lldslam_tpu.geometry import se3 as jse3  # noqa: E402
from lldslam_tpu.io import trajectory as jtraj  # noqa: E402
from lldslam_tpu.ops import orb as jorb  # noqa: E402
from lldslam_tpu.slammap.map_store import MapStore as JMapStore  # noqa: E402
from lldslam_tpu_torch import config, interop  # noqa: E402
from lldslam_tpu_torch.geometry import camera, se3  # noqa: E402
from lldslam_tpu_torch.io import synthetic  # noqa: E402
from lldslam_tpu_torch.io import trajectory as traj  # noqa: E402
from lldslam_tpu_torch.ops import orb  # noqa: E402

torch.set_num_threads(2)

CAM = jconfig.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                           fps=10.0, width=640, height=240).stereo_camera()


def test_synthetic_sequence_matches_bench():
    """Same seed, same frames and poses as bench._make_sequence. The motion
    increment comes from the port's se3.exp, which may differ from JAX's by
    a float32 ulp: at most 0.01% of pixels may differ, by one level; poses
    agree to 1e-6."""
    n = 4
    jf, jp, jinfo = _make_sequence(CAM, n, n_per_m=25.0, seed=3,
                                   return_poses=True)
    tf, tp, tinfo = synthetic.make_sequence(CAM, n, n_per_m=25.0, seed=3,
                                            return_poses=True)
    assert tinfo == jinfo
    np.testing.assert_allclose(np.stack(tp), np.stack(jp), rtol=0, atol=1e-6)
    for (jl, jr), (tl, tr) in zip(jf, tf):
        for j, t in ((jl, tl), (jr, tr)):
            d = np.abs(j.astype(np.int16) - t.astype(np.int16))
            assert d.max() <= 1
            assert (d > 0).mean() <= 1e-4


def test_orb_pattern_is_the_jax_table():
    """The port ships its own copy of the BRIEF pattern: byte-equal."""
    a = (ROOT / "lldslam_tpu/ops/orb_pattern.npy").read_bytes()
    b = (ROOT / "lldslam_tpu_torch/ops/orb_pattern.npy").read_bytes()
    assert a == b
    assert orb._pattern().shape == (256, 2, 2)


def test_se3_matches_jax():
    """exp, log, inv and apply on a seeded batch: float32, 1e-5."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (16, 6)).astype(np.float32)
    X = rng.normal(0, 5, (16, 3)).astype(np.float32)
    Tj = jse3.exp(jnp.asarray(xi))
    Tt = se3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(se3.log(Tt).numpy(), np.asarray(jse3.log(Tj)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(se3.inv(Tt).numpy(), np.asarray(jse3.inv(Tj)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        se3.apply(Tt, torch.from_numpy(X)).numpy(),
        np.asarray(jse3.apply(Tj, jnp.asarray(X))), rtol=0, atol=1e-4)


def test_camera_matches_jax():
    """project and backproject on seeded points: float32, 1e-4 px / m."""
    rng = np.random.default_rng(3)
    Xc = np.stack([rng.uniform(-5, 5, 64), rng.uniform(-2, 2, 64),
                   rng.uniform(1, 40, 64)], -1).astype(np.float32)
    tcam = interop.stereo_camera(CAM._asdict())
    uv = camera.project(tcam, torch.from_numpy(Xc))
    np.testing.assert_allclose(uv.numpy(),
                               np.asarray(jcamera.project(CAM, jnp.asarray(Xc))),
                               rtol=0, atol=1e-4)
    back = camera.backproject(tcam, uv, torch.from_numpy(Xc[:, 2]))
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jcamera.backproject(
            CAM, jnp.asarray(uv.numpy()), jnp.asarray(Xc[:, 2]))),
        rtol=0, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), Xc, rtol=1e-5, atol=1e-4)


def test_load_config_matches_jax():
    """The reference-format YAML parses to the same configuration."""
    path = ROOT / "tests/data/mini_kitti/settings.yaml"
    assert asdict(config.load_config(path, sequence="04")) == \
        asdict(jconfig.load_config(path, sequence="04"))
    d = asdict(jconfig.SlamConfig())
    assert interop.slam_config(d) == config.SlamConfig()


def test_trajectory_io_matches_jax(tmp_path):
    """replay, KITTI/TUM files (byte-equal) and ATE on seeded poses."""
    rng = np.random.default_rng(1)
    kf = np.asarray(jse3.exp(jnp.asarray(
        rng.normal(0, 0.3, (4, 6)).astype(np.float32))))
    rel = np.asarray(jse3.exp(jnp.asarray(
        rng.normal(0, 0.1, (10, 6)).astype(np.float32))))
    refs = rng.integers(0, 4, 10)
    want = jtraj.replay_trajectory(rel, refs, kf)
    got = traj.replay_trajectory(rel, refs, kf)
    np.testing.assert_array_equal(got, want)
    ts = np.arange(10) * 0.1
    jtraj.save_kitti(tmp_path / "j.txt", want)
    traj.save_kitti(tmp_path / "t.txt", got)
    jtraj.save_tum(tmp_path / "jt.txt", ts, want)
    traj.save_tum(tmp_path / "tt.txt", ts, got)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    assert (tmp_path / "jt.txt").read_bytes() == \
        (tmp_path / "tt.txt").read_bytes()
    noisy = got.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.05, (10, 3))
    assert traj.ate_rmse(noisy, got) == jtraj.ate_rmse(noisy, got)


def test_interop_round_trip():
    """JAX FrameData / MapPointView / MapStore arrays -> port -> numpy:
    values unchanged, uint32 descriptors carried as int32 bits."""
    rng = np.random.default_rng(2)
    n = 64
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    jf = jmatching.FrameFeatures(
        xy=jnp.asarray(rng.uniform(0, 600, (n, 2)).astype(np.float32)),
        ur=jnp.asarray(rng.uniform(-1, 600, n).astype(np.float32)),
        octave=jnp.asarray(rng.integers(0, 8, n).astype(np.int32)),
        angle=jnp.asarray(rng.uniform(-3, 3, n).astype(np.float32)),
        desc=jnp.asarray(desc), valid=jnp.asarray(rng.uniform(size=n) < 0.9))
    jkp = jorb.Keypoints(xy=jf.xy, response=jnp.ones(n), octave=jf.octave,
                         angle=jf.angle, desc=jf.desc, valid=jf.valid)
    tfd = interop.frame_data(jframe.FrameData(
        feats=jf, depth=jnp.asarray(rng.uniform(-1, 30, n).astype(np.float32)),
        right=jkp))
    tf = tfd.feats
    assert tf.desc.dtype == torch.int32
    back = interop.to_numpy(tfd)
    for part, src in (("feats", jf), ("right", jkp)):
        for k in src._fields:
            np.testing.assert_array_equal(back[part][k],
                                          np.asarray(getattr(src, k)))
    jv = jmatching.MapPointView(
        pos=jnp.asarray(rng.normal(0, 5, (n, 3)).astype(np.float32)),
        desc=jnp.asarray(desc),
        normal=jnp.asarray(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        min_dist=jnp.ones(n), max_dist=jnp.full(n, 50.0),
        valid=jnp.ones(n, bool))
    vb = interop.to_numpy(interop.map_point_view(jv))
    for k in jv._fields:
        np.testing.assert_array_equal(vb[k], np.asarray(getattr(jv, k)))
    jorb_cfg = interop.orb_config({"n_features": 600})
    js = JMapStore(CAM, jorb_cfg, max_kf=8, max_pt=256)
    js.kf_pose[:2] = np.asarray(jse3.exp(jnp.asarray(
        rng.normal(0, 0.3, (2, 6)).astype(np.float32))))
    js.n_kf = 2
    ts = interop.map_store(js, interop.stereo_camera(CAM._asdict()),
                           jorb_cfg)
    arrays = interop.map_store_arrays(ts)
    assert arrays, "no arrays carried"
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, getattr(js, k), err_msg=k)
    assert ts.n_kf == 2
