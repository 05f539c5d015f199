"""Point inliers, line matches and states per frame of the synchronous and
the pipelined tracker, in the JAX package and in the port, on the CPU.

    python tools/pipelined_lines_inliers.py [--native] [N_FRAMES]  # 24

The world is the 640x240 line corridor of tests/test_torch_pipelined_paths.py
(lldslam_tpu_torch.io.synthetic.make_sequence, seed 3, lines painted on the
walls; 600 ORB features, min_init_points 80, ldType LBDFloat, mdThr 0.6,
loops off), with stored detections from gen_stored_lines, or with
--native on each package's own line detector (no detections path). Each package runs
it synchronously and pipelined (every frame through track_stereo, then
flush). Prints one JSON line per run: the package, the mode, and per frame
the point inliers, the line matches and the state. Takes a few minutes.
"""
import json
from pathlib import Path
import sys
import tempfile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from lldslam_tpu import config as jconfig  # noqa: E402
from lldslam_tpu.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from lldslam_tpu.system import System as JSystem  # noqa: E402
from lldslam_tpu_torch import config as tconfig  # noqa: E402
from lldslam_tpu_torch.io import synthetic  # noqa: E402
from lldslam_tpu_torch.ops.orb import OrbConfig as TOrbConfig  # noqa: E402
from lldslam_tpu_torch.system import System as TSystem  # noqa: E402

CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0, fps=10.0,
           width=640, height=240)


def _cfg(mod, orb, left, right):
    return mod.SlamConfig(
        camera=mod.CameraConfig(**CAM), orb=orb(n_features=600),
        tracking=mod.TrackingConfig(min_init_points=80),
        line=mod.LineConfig(ld_type="LBDFloat", md_thr=0.6,
                            detections_path=left, descriptors_path=right))


def main(n: int, native: bool) -> None:
    torch.set_num_threads(4)
    cam = tconfig.CameraConfig(**CAM).stereo_camera()
    frames, poses, world = synthetic.make_sequence(
        cam, n, seed=3, with_lines=True, return_poses=True)
    left = right = None
    if not native:
        tmp = tempfile.mkdtemp(prefix="pipelined_lines_inliers_")
        left, right = f"{tmp}/l", f"{tmp}/r"
        synthetic.gen_stored_lines(cam, poses, world, left, right)
    runs = (("jax", lambda pipe: JSystem(
                _cfg(jconfig, JOrbConfig, left, right), enable_loops=False,
                pipeline=pipe)),
            ("torch", lambda pipe: TSystem(
                _cfg(tconfig, TOrbConfig, left, right), enable_loops=False,
                pipeline=pipe, device="cpu")))
    for package, make in runs:
        for pipe in (False, True):
            s = make(pipe)
            for i, (l, r) in enumerate(frames):
                s.track_stereo(l, r, timestamp=0.1 * i)
            s.flush()
            ms = s.tracker.metrics
            print(json.dumps(dict(
                package=package, mode="pipelined" if pipe else "sync",
                detector="native" if native else "stored",
                inliers=[m.n_inliers for m in ms],
                line_matches=[m.n_line_matches for m in ms],
                states=[m.state for m in ms])), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--native"]
    main(int(args[0]) if args else 24, "--native" in sys.argv[1:])
