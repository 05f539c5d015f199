"""The stereo point+line slice of the PyTorch port against the JAX package,
end to end, and the port's command line on the checked-in KITTI-layout
sequence.

The slice runs 12 frames of the seed-3 line corridor (bench.py's
`_make_sequence` with lines painted on the walls) at 640x240 with 600 ORB
features, with stored LBD-style detections written by bench.py's
`_gen_stored_lines_ref_scale` (`ldType: LBDFloat`, mdThr 0.6), through both
`System`s with their defaults (synchronous, loops on with the shipped
vocabulary). Float sums run in another order in the two frameworks, and the
JAX package applies each keyframe's line retriangulation two keyframes
late (its staged solve) where the port applies it at once, so the runs are
compared by bounds: every frame OK in both, keyframe frame ids equal up to
one keyframe, camera centres within 0.05 m, the port's ATE within 1.5x of
the JAX run's (or 0.01 m above it), line matches per frame and valid map
lines at the end within 10%, and the stored-line capacity events equal.
"""
import json
from pathlib import Path
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import _gen_stored_lines_ref_scale, _make_sequence  # noqa: E402
from lldslam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from lldslam_tpu.config import LineConfig as JLineConfig  # noqa: E402
from lldslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from lldslam_tpu.config import TrackingConfig as JTrackingConfig  # noqa: E402
from lldslam_tpu.io.trajectory import ate_rmse  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu_torch import cli  # noqa: E402
from lldslam_tpu_torch.config import (CameraConfig, LineConfig,  # noqa: E402
                                      SlamConfig, TrackingConfig)
from lldslam_tpu_torch.ops.orb import OrbConfig  # noqa: E402
from lldslam_tpu_torch.system import System  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 12
CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)
MINI = ROOT / "tests" / "data" / "mini_kitti"


def _run(system, frames):
    for i, (l, r) in enumerate(frames):
        system.track_stereo(l, r, timestamp=i * 0.1)
    tr = system.tracker
    _, T_wc = tr.trajectory()
    src = tr._line_source
    return dict(
        T=T_wc, states=[m.state for m in tr.metrics],
        kfs=[m.frame_id for m in tr.metrics if m.new_kf],
        lm=np.array([m.n_line_matches for m in tr.metrics]),
        n_lines=int(system.map.ln_valid.sum()),
        cap=(src[0].cap_events + src[1].cap_events,
             src[0].cap_dropped + src[1].cap_dropped),
        lkt=dict(tr.line_kf_times), system=system)


@pytest.fixture(scope="module")
def line_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("line_slice")
    jcam = JCameraConfig(**CAM)
    frames, poses, world = _make_sequence(jcam.stereo_camera(), N_FRAMES,
                                          n_per_m=25.0, seed=3,
                                          with_lines=True, return_poses=True)
    left, right = str(tmp / "left"), str(tmp / "right")
    _gen_stored_lines_ref_scale(jcam.stereo_camera(), poses, world, left,
                                right)
    jcfg = JSlamConfig(
        camera=jcam, orb=JOrbConfig(n_features=600),
        line=JLineConfig(ld_type="LBDFloat", md_thr=0.6,
                         detections_path=left, descriptors_path=right),
        tracking=JTrackingConfig(min_init_points=80))
    cfg = SlamConfig(
        camera=CameraConfig(**CAM), orb=OrbConfig(n_features=600),
        line=LineConfig(ld_type="LBDFloat", md_thr=0.6,
                        detections_path=left, descriptors_path=right),
        tracking=TrackingConfig(min_init_points=80))
    gt = np.stack([np.linalg.inv(p) for p in poses])
    return gt, _run(JSystem(jcfg), frames), _run(System(cfg, device="cpu"),
                                                 frames)


def test_line_slice_trajectory_matches_jax(line_runs):
    gt, j, t = line_runs
    assert j["states"] == ["OK"] * N_FRAMES
    assert t["states"] == ["OK"] * N_FRAMES
    assert abs(len(t["kfs"]) - len(j["kfs"])) <= 1, (t["kfs"], j["kfs"])
    assert len(set(t["kfs"]) ^ set(j["kfs"])) <= 1, (t["kfs"], j["kfs"])
    dc = np.linalg.norm(t["T"][:, :3, 3] - j["T"][:, :3, 3], axis=-1)
    ate_j, ate_t = ate_rmse(j["T"], gt), ate_rmse(t["T"], gt)
    print(f"keyframes jax {j['kfs']} port {t['kfs']}; max centre diff "
          f"{dc.max():.4f} m; ATE jax {ate_j:.5f} m port {ate_t:.5f} m")
    assert dc.max() < 0.05, dc
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_t, ate_j)


def test_line_slice_lines_match_jax(line_runs):
    """Line matches on every frame after the first within 10% of the JAX
    run's (and over 80 a frame), valid map lines within 10%, the same
    stored-line capacity events; the port timed its keyframe line stages
    on every keyframe."""
    _, j, t = line_runs
    print(f"line matches jax {j['lm'].tolist()} port {t['lm'].tolist()}; "
          f"map lines jax {j['n_lines']} port {t['n_lines']}")
    assert t["lm"][0] == j["lm"][0] == 0
    assert (j["lm"][1:] > 80).all()
    rel = np.abs(t["lm"][1:] - j["lm"][1:]) / j["lm"][1:]
    assert rel.max() <= 0.10, rel
    assert abs(t["n_lines"] - j["n_lines"]) <= 0.10 * j["n_lines"]
    assert t["cap"] == j["cap"]
    lkt = t["lkt"]
    assert lkt["n"] == len(t["kfs"])
    assert set(lkt) == {"snap", "create", "retri", "cull", "desc", "n"}


def test_line_slice_loops_and_mapper(line_runs):
    """Loops on in both: every keyframe went through the loop closer and no
    event fires on the loop-free corridor; the port's joint local BA kept
    every line observation of its window (none over l_cap / lo_cap), as the
    JAX run does."""
    _, j, t = line_runs
    for run in (j, t):
        tr = run["system"].tracker
        lc = tr.loop_closer
        assert lc.stage_times["n"] == run["system"].map.n_kf
        assert not lc.events
        assert tr.mapper.stage_times.get("ln_obs_dropped", 0) == 0
        assert tr.mapper.stage_times.get("line_view_dropped", 0) == 0


def _cli_run(settings, out, metrics):
    """The CLI on mini KITTI with `settings`, on the CPU, within
    tests/test_cli_e2e.py's bounds (10 finite KITTI rows, unaligned ATE
    < 0.5 m, the last frame OK, line matches on some frame); returns the
    per-frame metrics."""
    rc = cli.main(["kitti", str(settings), str(MINI), "--out", str(out),
                   "--metrics", str(metrics), "--device", "cpu"])
    assert rc == 0
    est, gt = np.loadtxt(out), np.loadtxt(MINI / "gt.txt")
    assert est.shape == gt.shape == (10, 12)
    assert np.isfinite(est).all()
    T_est = np.tile(np.eye(4), (10, 1, 1))
    T_est[:, :3] = est.reshape(-1, 3, 4)
    T_gt = np.tile(np.eye(4), (10, 1, 1))
    T_gt[:, :3] = gt.reshape(-1, 3, 4)
    ate = ate_rmse(T_est, T_gt, align=False)
    print(f"mini KITTI through the port's CLI ({settings}): ATE {ate:.4f} m")
    assert ate < 0.5
    ms = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert len(ms) == 10 and ms[-1]["state"] == "OK"
    assert any(m["n_line_matches"] > 0 for m in ms)
    return ms


def test_port_cli_on_mini_kitti(tmp_path):
    """`python -m lldslam_tpu_torch.cli kitti settings.yaml seq_dir` on the
    checked-in mini KITTI sequence (PNG files decoded by the port's native
    loader, ldType LBDFloat), on the CPU, once on the stored lines of the
    shipped settings and once on the native detector (the settings without
    the detection paths), each within tests/test_cli_e2e.py's bounds (10
    finite KITTI rows, unaligned ATE < 0.5 m, the last frame OK, lines
    seen); with `--save-map` it writes a map
    checkpoint holding the run's keyframes."""
    out, metrics = tmp_path / "traj.txt", tmp_path / "metrics.jsonl"
    _cli_run(MINI / "settings.yaml", out, metrics)
    native = tmp_path / "native.yaml"
    native.write_text("".join(
        ln for ln in (MINI / "settings.yaml").read_text().splitlines(True)
        if not ln.startswith(("lineDetectionsPath", "lineDescriptorsPath"))))
    ms = _cli_run(native, out, metrics)
    assert sum(m["n_line_matches"] for m in ms) > 0
    assert cli.main(["kitti", str(MINI / "settings.yaml"), str(MINI),
                     "--out", str(out), "--limit", "1", "--device", "cpu",
                     "--save-map", str(tmp_path / "map.npz")]) == 0
    with np.load(tmp_path / "map.npz") as z:
        assert z["__scalars__"][0] == 1 and z["kf_valid"][0]
