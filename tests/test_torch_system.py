"""The synchronous stereo slice of the PyTorch port against the JAX package,
end to end, plus the port's import guard and its other entry points.

The whole-slice tests run 12 frames of the seed-3 synthetic corridor at
640x240 with 600 ORB features (the tests/test_pipelined.py camera) through
both `System`s, once with loop closing off and once with the default (loops
on, the shipped vocabulary). Float sums run in another order in
the two frameworks, which can flip a Levenberg-Marquardt accept/reject step
in the pose LM or the local BA, so the trajectories are compared by bounds
and not bit for bit: every frame OK in both, keyframe frame ids equal up to
one keyframe, camera centres within 0.05 m per frame, and the port's ATE at
most max(1.5 x JAX ATE, JAX ATE + 0.01 m).
"""
import importlib.util
import inspect
import re
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
from lldslam_tpu_torch.geometry import lines as tgl  # noqa: E402
from lldslam_tpu_torch.io.synthetic import add_loop_lines  # noqa: E402
from lldslam_tpu_torch.io.synthetic import make_loop_map  # noqa: E402
from lldslam_tpu_torch.loop.closing import LoopCloser  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.pipeline.kf_cache import KfCache  # noqa: E402
from lldslam_tpu_torch.pipeline.local_mapping import LocalMapper  # noqa: E402
from lldslam_tpu_torch.pipeline.tracker import StereoTracker  # noqa: E402
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


def _slice_runs(**kw):
    """The corridor through the JAX System and the port's System, both built
    with the keyword arguments `kw`."""
    jcfg = JSlamConfig(camera=JCameraConfig(**CAM),
                       orb=JOrbConfig(n_features=600),
                       tracking=JTrackingConfig(min_init_points=80))
    frames, poses, _ = _make_sequence(jcfg.camera.stereo_camera(), N_FRAMES,
                                      n_per_m=25.0, seed=3,
                                      return_poses=True)
    gt = np.stack([np.linalg.inv(p) for p in poses])
    jsys = JSystem(jcfg, **kw)
    jax_run = _run(jsys, frames)
    port = System(_port_cfg(), pipeline=False, device="cpu", **kw)
    port_run = _run(port, frames)
    return gt, jax_run, port_run, port, jsys


@pytest.fixture(scope="module")
def slice_runs():
    return _slice_runs(enable_loops=False)


def _check_slice(gt, jax_run, port_run):
    """Both runs OK on every frame, the keyframes equal up to one, camera
    centres within 0.05 m, the port's ATE within the module's bound."""
    (T_j, st_j, kf_j), (T_t, st_t, kf_t) = jax_run, port_run
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


def test_whole_slice_matches_jax(slice_runs):
    _check_slice(*slice_runs[:3])


def test_whole_slice_with_loops_matches_jax():
    """The default of both packages, loops on with the shipped vocabulary:
    the trajectories within the bounds above; in both, every keyframe went
    through the loop closer, the database holds exactly the valid
    keyframes, and no loop event fires on the loop-free corridor."""
    gt, jax_run, port_run, port, jsys = _slice_runs()
    _check_slice(gt, jax_run, port_run)
    for sys_ in (jsys, port):
        lc, s = sys_.tracker.loop_closer, sys_.map
        assert lc.voc.n_words == 99106
        assert lc.stage_times["n"] == s.n_kf
        assert set(lc.db.kf_words) == set(
            np.nonzero(s.kf_valid[:s.n_kf])[0].tolist())
        assert not lc.events


def test_trajectory_exports(slice_runs, tmp_path):
    """KITTI and TUM files of the port's run: one row per frame (a keyframe
    row per live keyframe), finite, and the KITTI rows are the trajectory's
    top three rows."""
    port = slice_runs[3]
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


def _line_obs_error(s) -> float:
    """Median distance (px) of every keyframe line observation's left
    endpoints to its map line projected at the keyframe's pose."""
    k, j = np.nonzero(s.kf_ln_ids[:s.n_kf] >= 0)
    ln = s.kf_ln_ids[k, j]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    r = tgl.endpoint_residual(s.cam, t(s.kf_pose[k]), t(s.ln_x0[ln]),
                              t(s.ln_dir[ln]), t(s.kf_ln_p1[k, j]),
                              t(s.kf_ln_p2[k, j]))
    return float(r.abs().median())


@pytest.mark.parametrize("what", ["loops", "pipeline", "lines", "rgbd",
                                  "mono", "save_map", "load_map"])
def test_unported_entries_raise(what, tmp_path):
    """Every entry point of this list is ported now, and none falls back
    to another path. `loops` is ported whole: on a map with lines the loop closer's global BA runs
    the joint point+line problem instead of raising: it moves the map lines
    and lowers their median endpoint distance to their keyframe
    observations (pixel noise 0.3) by a quarter or more. `lines` (the
    native line detector route: ldType LBDFloat without stored
    detections), `rgbd`, `mono`, `save_map` and `load_map` are ported too
    and no longer raise: the native route builds its System on the
    detector, and a blank stereo, RGB-D or monocular frame leaves the
    tracker NOT_INITIALIZED; an empty map saves and loads. `pipeline` (the
    pipelined tracker) builds, a blank pair staged by stage_stereo and
    passed as pair_dev leaves it NOT_INITIALIZED (a frame before
    initialization is synchronous), and its flush finalizes nothing."""
    cfg = _port_cfg()
    if what == "loops":
        lc = System(cfg, device="cpu").tracker.loop_closer
        s = lc.store
        add_loop_lines(s, make_loop_map(s))
        n = s.n_ln
        x0, err0 = s.ln_x0[:n].copy(), _line_obs_error(s)
        lc.global_ba()
        assert (s.ln_nobs[:n] >= 4).sum() >= 100
        assert np.isfinite(s.ln_x0[:n]).all() and np.isfinite(s.ln_dir[:n]).all()
        moved = np.linalg.norm(s.ln_x0[:n] - x0, axis=-1) > 1e-3
        assert moved.sum() >= 100, moved.sum()
        err1 = _line_obs_error(s)
        print(f"median line endpoint distance {err0:.3f} -> {err1:.3f} px")
        assert err1 < 0.75 * err0
        return
    if what in ("lines", "rgbd", "mono", "save_map", "load_map"):
        s = System(cfg, device="cpu") if what != "lines" else System(
            SlamConfig(camera=cfg.camera, orb=cfg.orb,
                       line=LineConfig(ld_type="LBDFloat"),
                       tracking=cfg.tracking), device="cpu")
        img = np.zeros((240, 640), np.uint8)
        if what == "lines":
            assert s.tracker.enable_lines and s.tracker._line_source is None
            _, m = s.track_stereo(img, img)
        elif what == "rgbd":
            _, m = s.track_rgbd(img, img.astype(np.float32))
        elif what == "mono":
            _, m = s.track_monocular(img)
        else:
            s.save_map(tmp_path / "m.npz")
            s.load_map(tmp_path / "m.npz")
            assert (s.map.n_kf, s.map.n_pt) == (0, 0)
            return
        assert m.state == "NOT_INITIALIZED" and s.map.n_kf == 0
        return
    assert what == "pipeline"
    s = System(cfg, pipeline=True, device="cpu")
    assert s.tracker.pipeline and s.tracker.mapper.fixed_tv_cap == 4096
    img = np.zeros((240, 640), np.uint8)
    T, m = s.track_stereo(None, None, pair_dev=s.stage_stereo(img, img))
    assert m.state == "NOT_INITIALIZED" and s.map.n_kf == 0
    assert np.array_equal(T, np.eye(4)) and s.flush() is None


def test_system_defaults_to_the_card():
    """System(cfg) with no device argument runs on the card: with one, its
    tracker sits on cuda; without one it raises at its first allocation
    instead of coming up on the CPU. The classes a caller may build
    directly (StereoTracker, LocalMapper, LoopCloser, KfCache) default to
    the card too."""
    cfg = _port_cfg()
    for cls in (System, StereoTracker, LocalMapper, LoopCloser, KfCache):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        s = System(cfg, enable_loops=False)
        assert s.tracker.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            System(cfg, enable_loops=False)
        with pytest.raises((RuntimeError, AssertionError)):
            System(cfg)


def test_multi_device_global_ba_has_its_counterpart():
    """The JAX package's multi-device global BA has its counterpart in the
    port (ROADMAP queue 1 item 7c): parallel.dist_schur and
    parallel.sharded_ba define every public function and class of the JAX
    modules (the JAX mesh-axis names aside), LoopCloser.global_ba takes
    `force_dist`, and neither module imports JAX."""
    for name in ("dist_schur", "sharded_ba"):
        jax_src = (ROOT / "lldslam_tpu" / "parallel" / f"{name}.py"
                   ).read_text()
        public = set(re.findall(r"^(?:def|class) ([a-zA-Z]\w*)", jax_src,
                                re.M))
        assert public, name
        mod = importlib.import_module(f"lldslam_tpu_torch.parallel.{name}")
        missing = [n for n in public if not callable(getattr(mod, n, None))]
        assert not missing, (name, missing)
        src = Path(mod.__file__).read_text()
        assert not re.search(r"^\s*(from|import)\s+(jax|lldslam_tpu)\b",
                             src, re.M), name
    assert "force_dist" in inspect.signature(LoopCloser.global_ba).parameters


def test_port_imports_without_jax():
    """Every module of lldslam_tpu_torch imports with JAX and PIL made
    unimportable, and none of them pulls in lldslam_tpu; no source file of
    the port imports PIL, not even inside a function."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['PIL'] = None\n"
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
    pil = [p.name for p in (ROOT / "lldslam_tpu_torch").rglob("*.py")
           if re.search(r"^\s*(from|import)\s+PIL\b", p.read_text(), re.M)]
    assert not pil, pil
