"""Smoke test of the PyTorch/CUDA port (lldslam_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: both CUDA kernels compiled from lldslam_tpu_torch/csrc with nvcc;
3. K1 (patch sampling) against its plain PyTorch version, exact, at the
   shapes the frame build gives it and at the BRIEF/SAD shapes of one level;
4. K2 (masked Hamming best-2) against its plain version, all four outputs
   exact, at the tracking (4096 x 2048) and fusion (2048 x 2048) shapes with
   forced ties, an empty row and a one-candidate row;
5. main path: 30 synthetic KITTI-size stereo frames (1241x376, 2000 ORB
   features, 8 levels x 1.2) through lldslam_tpu_torch.system.System on the
   card, with asserts on tracking state, keyframes, kernel launches and ATE.
The second-to-last line is the kernel table as JSON, the last line the
device summary as JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KITTI_W, KITTI_H = 1241, 376
N_FRAMES = 30
ATE_BOUND_M = 0.03      # JAX-CPU run of this sequence: 0.0084 m, + 0.02 m


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch device: {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build():
    from lldslam_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    path = cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_build.last_build_seconds:.1f} s)")


def _k1_case(rng, img, n, S, span, label):
    from lldslam_tpu_torch.ops import patch_sample as ps
    V, H, W = img.shape
    dev = img.device
    meta = np.zeros((n, 4), np.int32)
    meta[:, 0] = rng.integers(0, V, n)
    meta[:, 1] = rng.integers(0, H, n)
    meta[:, 2] = rng.integers(0, W, n)
    iy = rng.integers(-span, span + 1, (n, S)).astype(np.int32)
    ix = rng.integers(-span, span + 1, (n, S)).astype(np.int32)
    # keep the taps inside the image, as every caller does
    iy = np.clip(meta[:, 1:2] + iy, 0, H - 1) - meta[:, 1:2]
    ix = np.clip(meta[:, 2:3] + ix, 0, W - 1) - meta[:, 2:3]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (img, t(meta), t(iy), t(ix))
    got = ps.sample_patches(*args)
    want = ps.sample_patches_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err != 0.0:
        raise AssertionError(f"K1 {label}: max abs err {err} (want exact)")
    ms = cuda_ms(lambda: ps.sample_patches(*args))
    plain_ms = cuda_ms(lambda: ps.sample_patches_plain(*args))
    log(f"K1 {label}: n={n} S={S} img={tuple(img.shape)} {img.dtype}: exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def phase_k1(dev) -> dict:
    from lldslam_tpu_torch.ops.orb import OrbConfig, _IC_DX
    rng = np.random.default_rng(0)
    cfg = OrbConfig(n_features=2000)
    # one level's stereo pair as uint8 (the issue's BRIEF/SAD shapes)
    img8 = torch.from_numpy(rng.integers(0, 256, (2, KITTI_H, KITTI_W),
                                         dtype=np.uint8)).to(dev)
    res = [_k1_case(rng, img8, 868, 512, 19, "BRIEF level-0 uint8"),
           _k1_case(rng, img8, 868, 121, 5, "SAD patch uint8"),
           _k1_case(rng, img8, 868, 231, 10, "SAD strip uint8")]
    # the frame build's calls: float32 stack of 8 levels x 2 views
    stack = torch.from_numpy(np.round(rng.uniform(
        0, 255, (2 * cfg.n_levels, KITTI_H, KITTI_W))).astype(np.float32)).to(dev)
    n_kp = cfg.n_features * 2
    main = [_k1_case(rng, stack, n_kp, len(_IC_DX), 15, "IC-angle main path"),
            _k1_case(rng, stack, n_kp, 512, 19, "BRIEF main path"),
            _k1_case(rng, stack, cfg.max_kp, 121, 5, "SAD patch main path"),
            _k1_case(rng, stack, cfg.max_kp, 231, 10, "SAD strip main path")]
    res += main
    return dict(max_abs_err=max(r[0] for r in res),
                ms=sum(r[1] for r in main), plain_ms=sum(r[2] for r in main))


def _k2_case(rng, dev, M, N, label):
    from lldslam_tpu_torch.ops import match_best2 as mb
    a = rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    mask = rng.uniform(size=(M, N)) < 0.02
    b[N // 2:N // 2 + 16] = b[:16]          # duplicate columns -> exact ties
    mask[:64, :16] = True
    mask[:64, N // 2:N // 2 + 16] = True
    mask[64] = False                        # empty row
    mask[65] = False
    mask[65, 7] = True                      # one-candidate row
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (t(a.view(np.int32)), t(b.view(np.int32)), t(mask))
    got = mb.masked_best2(*args)
    want = mb.masked_best2_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_, nm in zip(got, want, ("best_idx", "best", "second",
                                     "second_idx")):
        if not torch.equal(g.to(torch.int64), w_.to(torch.int64)):
            bad = int((g.to(torch.int64) != w_.to(torch.int64)).sum())
            raise AssertionError(f"K2 {label}: {nm} differs in {bad} rows")
        err = max(err, float((g.double() - w_.double()).abs().max()))
    g = [x.cpu().numpy() for x in got]
    if not (g[1][64] == 10000 and g[0][64] == 0 and g[3][64] == 0
            and g[0][65] == 7 and g[2][65] == 10000 and g[3][65] == 0):
        raise AssertionError(f"K2 {label}: empty / one-candidate row contract")
    ms = cuda_ms(lambda: mb.masked_best2(*args))
    plain_ms = cuda_ms(lambda: mb.masked_best2_plain(*args))
    log(f"K2 {label}: M={M} N={N}: all four outputs exact; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def phase_k2(dev) -> dict:
    rng = np.random.default_rng(1)
    track = _k2_case(rng, dev, 4096, 2048, "tracking view")
    fuse = _k2_case(rng, dev, 2048, 2048, "fusion")
    return dict(max_abs_err=max(track[0], fuse[0]), ms=track[1],
                plain_ms=track[2])


def phase_main_path(dev) -> dict:
    from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu_torch.io.synthetic import make_sequence
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.ops import match_best2, patch_sample
    from lldslam_tpu_torch.ops.orb import OrbConfig
    from lldslam_tpu_torch.system import System

    cam_cfg = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=386.1448, fps=10.0, width=KITTI_W,
                           height=KITTI_H)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=2000),
                     tracking=TrackingConfig(min_init_points=100))
    t0 = time.perf_counter()
    frames, poses, _ = make_sequence(cam_cfg.stereo_camera(), N_FRAMES,
                                     seed=3, return_poses=True)
    log(f"main path: generated {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, enable_loops=False, pipeline=False, device=dev)
    patch_sample.launches = 0
    match_best2.launches = 0
    ms, states = [], []
    for i, (l, r) in enumerate(frames):
        t = time.perf_counter()
        _, m = sys_.track_stereo(l, r, timestamp=i * 0.1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        states.append(m.state)
        log(f"frame {i:2d}: {m.state} kf={int(m.new_kf)} inliers="
            f"{m.n_inliers} points={m.n_points} kfs={m.n_kfs} "
            f"{ms[-1]:.1f} ms")
    launches = dict(k1=patch_sample.launches, k2=match_best2.launches)
    tr = sys_.tracker
    kf_frames = [m.frame_id for m in tr.metrics if m.new_kf]
    _, T_wc = tr.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    ate = ate_rmse(T_wc, gt)
    steady = ms[1:]
    kf_ms = [1e3 * m.t_kf for m in tr.metrics if m.new_kf and m.t_kf > 0]
    log(f"main path: keyframes at {kf_frames}; ATE {ate:.5f} m; launches "
        f"{launches}; view capacity {len(tr._view_pid)}")
    log(f"main path: ms/frame median {statistics.median(steady):.1f} p90 "
        f"{float(np.percentile(steady, 90)):.1f} (first frame "
        f"{ms[0]:.1f}); {1e3 * len(steady) / sum(steady):.2f} frames/s; "
        f"ms per keyframe step (mapper + BA) "
        f"{statistics.median(kf_ms) if kf_ms else float('nan'):.1f}")
    if any(s != "OK" for s in states):
        raise AssertionError(f"not every frame OK: {states}")
    if len(kf_frames) < 5:
        raise AssertionError(f"only {len(kf_frames)} keyframes (want >= 5)")
    if launches["k1"] <= 0 or launches["k2"] <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    if not ate <= ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m above {ATE_BOUND_M} m")
    return launches


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    launches = phase_main_path(dev)
    kernels = [
        dict(name="sample_patches", route="cuda",
             source="lldslam_tpu_torch/csrc/patch_sample.cu",
             replaces="lldslam_tpu/ops/patch_sample.py:68",
             launches=launches["k1"], **k1),
        dict(name="masked_best2", route="cuda",
             source="lldslam_tpu_torch/csrc/match_best2.cu",
             replaces="lldslam_tpu/ops/pallas_match.py:110",
             launches=launches["k2"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
