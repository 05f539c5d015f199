"""The synchronous stereo slice of the PyTorch port against the JAX package,
end to end, plus the port's import guard and its not-yet-ported entries.

The whole-slice test runs 12 frames of the seed-3 synthetic corridor at
640x240 with 600 ORB features (the tests/test_pipelined.py camera) through
both `System`s with loop closing off. Float sums run in another order in
the two frameworks, which can flip a Levenberg-Marquardt accept/reject step
in the pose LM or the local BA, so the trajectories are compared by bounds
and not bit for bit: every frame OK in both, keyframe frame ids equal up to
one keyframe, camera centres within 0.05 m per frame, and the port's ATE at
most max(1.5 x JAX ATE, JAX ATE + 0.01 m).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import _make_sequence  # noqa: E402
from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.config import TrackingConfig as JTrackingConfig  # noqa: E402
from lldslam_tpu.io.trajectory import ate_rmse  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu_torch.config import (CameraConfig, LineConfig,  # noqa: E402
                                      SlamConfig, TrackingConfig)
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 12
CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)


def _port_cfg():
    return SlamConfig(camera=CameraConfig(**CAM),
                      orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80))


def _run(system, frames):
    for i, (l, r) in enumerate(frames):
        system.track_stereo(l, r, timestamp=i * 0.1)
    tr = system.tracker
    _, T_wc = tr.trajectory()
    states = [m.state for m in tr.metrics]
    kfs = [m.frame_id for m in tr.metrics if m.new_kf]
    return T_wc, states, kfs


@pytest.fixture(scope="module")
def slice_runs():
    jcfg = JSlamConfig(camera=JCameraConfig(**CAM),
                       orb=JOrbConfig(n_features=600),
                       tracking=JTrackingConfig(min_init_points=80))
    frames, poses, _ = _make_sequence(jcfg.camera.stereo_camera(), N_FRAMES,
                                      n_per_m=25.0, seed=3,
                                      return_poses=True)
    gt = np.stack([np.linalg.inv(p) for p in poses])
    jax_run = _run(JSystem(jcfg, enable_loops=False), frames)
    port = System(_port_cfg(), enable_loops=False, pipeline=False,
                  device="cpu")
    port_run = _run(port, frames)
    return gt, jax_run, port_run, port


def test_whole_slice_matches_jax(slice_runs):
    gt, (T_j, st_j, kf_j), (T_t, st_t, kf_t), _ = slice_runs
    assert st_j == ["OK"] * N_FRAMES
    assert st_t == ["OK"] * N_FRAMES
    assert abs(len(kf_t) - len(kf_j)) <= 1, (kf_t, kf_j)
    assert len(set(kf_t) ^ set(kf_j)) <= 1, (kf_t, kf_j)
    dc = np.linalg.norm(T_t[:, :3, 3] - T_j[:, :3, 3], axis=-1)
    ate_j, ate_t = ate_rmse(T_j, gt), ate_rmse(T_t, gt)
    print(f"keyframes jax {kf_j} port {kf_t}; max centre diff "
          f"{dc.max():.4f} m; ATE jax {ate_j:.5f} m port {ate_t:.5f} m")
    assert dc.max() < 0.05, dc
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_t, ate_j)


def test_trajectory_exports(slice_runs, tmp_path):
    """KITTI and TUM files of the port's run: one row per frame (a keyframe
    row per live keyframe), finite, and the KITTI rows are the trajectory's
    top three rows."""
    *_, port = slice_runs
    port.save_trajectory_kitti(tmp_path / "kitti.txt")
    port.save_trajectory_tum(tmp_path / "tum.txt")
    port.save_keyframe_trajectory_tum(tmp_path / "kf.txt")
    port.flush()
    port.shutdown()
    _, T_wc = port.tracker.trajectory()
    k = np.loadtxt(tmp_path / "kitti.txt")
    assert k.shape == (N_FRAMES, 12)
    np.testing.assert_allclose(k.reshape(-1, 3, 4), T_wc[:, :3, :4],
                               rtol=0, atol=1e-5)
    t = np.loadtxt(tmp_path / "tum.txt")
    assert t.shape == (N_FRAMES, 8) and np.isfinite(t).all()
    s = port.map
    kf = np.loadtxt(tmp_path / "kf.txt", ndmin=2)
    assert kf.shape == (int(s.kf_valid[:s.n_kf].sum()), 8)


@pytest.mark.parametrize("what", ["loops", "pipeline", "lines", "rgbd",
                                  "mono", "save_map", "load_map"])
def test_unported_entries_raise(what, tmp_path):
    """Everything outside the slice raises NotImplementedError naming the
    ROADMAP queue; nothing falls back to another path."""
    cfg = _port_cfg()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        if what == "loops":
            System(cfg, enable_loops=True)
        elif what == "pipeline":
            System(cfg, pipeline=True)
        elif what == "lines":
            System(SlamConfig(camera=cfg.camera, orb=cfg.orb,
                              line=LineConfig(ld_type="LBDFloat"),
                              tracking=cfg.tracking))
        else:
            s = System(cfg)
            img = np.zeros((240, 640), np.uint8)
            {"rgbd": lambda: s.track_rgbd(img, img.astype(np.float32)),
             "mono": lambda: s.track_monocular(img),
             "save_map": lambda: s.save_map(tmp_path / "m"),
             "load_map": lambda: s.load_map(tmp_path / "m")}[what]()


def test_port_imports_without_jax():
    """Every module of lldslam_tpu_torch imports with JAX made unimportable,
    and none of them pulls in lldslam_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import lldslam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'lldslam_tpu' or "
        "m.startswith('lldslam_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
