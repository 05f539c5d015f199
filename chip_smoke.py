"""Smoke test of the PyTorch/CUDA port (lldslam_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: both CUDA kernels compiled from lldslam_tpu_torch/csrc with nvcc;
3. K1 (patch sampling) against its plain PyTorch version, exact, at the
   shapes the frame build gives it and at the BRIEF/SAD shapes of one level;
4. K2 (masked Hamming best-2) against its plain version, all four outputs
   exact, at the tracking (4096 x 2048), fusion (2048 x 2048) and loop /
   relocalization (8192 x 2048) shapes with forced ties, an empty row and a
   one-candidate row;
5. main path: 30 synthetic KITTI-size stereo frames (1241x376, 2000 ORB
   features, 8 levels x 1.2) through lldslam_tpu_torch.system.System on the
   card with its defaults (loop closing on, the shipped 99106-word
   vocabulary), with asserts on tracking state, keyframes, the loop step of
   every keyframe, kernel launches and ATE;
6. loop: the 88-frame circle of tests/test_loop_e2e.py (512x384, 600
   features) through System: a loop event, K2 at the loop call site, ATE
   under the test's bound;
7. reloc: the blackout scenario of tests/test_reloc.py through System, then
   K2 at the relocalization call site (8192 rows) on the relocalized frame,
   held exactly to the same call on CPU copies.
Kernel launches are counted per path (counts zeroed just before, read just
after): main, loop and reloc are System runs; reloc_site is the two direct
calls of the relocalization call site. The second-to-last line is the
kernel table as JSON, the last line the device summary as JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

KITTI_W, KITTI_H = 1241, 376
N_FRAMES = 30
ATE_BOUND_M = 0.03      # JAX-CPU run of this sequence: 0.0084 m, + 0.02 m
RING_ATE_BOUND_M = 0.60   # tests/test_loop_e2e.py (JAX-CPU run: 0.455 m)
RELOC_BOUND = (0.1, 0.02)   # m, rad: tests/test_reloc.py (JAX: 0.0298, 0.00088)
SHIPPED_WORDS = 99106


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
    loop = _k2_case(rng, dev, 8192, 2048, "loop / reloc")
    return dict(max_abs_err=max(track[0], fuse[0], loop[0]), ms=track[1],
                plain_ms=track[2], ms_8192=loop[1], plain_ms_8192=loop[2])


def reset_counts() -> None:
    from lldslam_tpu_torch.ops import match_best2, patch_sample
    patch_sample.launches = 0
    match_best2.launches = 0
    match_best2.launches_by_site = {}


def read_counts() -> dict:
    from lldslam_tpu_torch.ops import match_best2, patch_sample
    return dict(k1=patch_sample.launches, k2=match_best2.launches,
                k2_sites=dict(match_best2.launches_by_site))


def kitti_config():
    from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu_torch.ops.orb import OrbConfig
    cam_cfg = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=386.1448, fps=10.0, width=KITTI_W,
                           height=KITTI_H)
    return SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=2000),
                      tracking=TrackingConfig(min_init_points=100))


def patch_world_config():
    """The 512x384 camera of the JAX package's end-to-end tests."""
    from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu_torch.ops.orb import OrbConfig
    cam_cfg = CameraConfig(fx=400.0, fy=400.0, cx=256.0, cy=192.0, bf=200.0,
                           fps=10.0, width=512, height=384)
    return SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=100))


def track(sys_, frames, t0: float = 0.0, label: str = ""):
    """Frames through System.track_stereo, each synchronised; returns
    (per-frame ms, metrics)."""
    ms, out = [], []
    for i, (l, r) in enumerate(frames):
        t = time.perf_counter()
        _, m = sys_.track_stereo(l, r, timestamp=t0 + i * 0.1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        out.append(m)
        log(f"{label} frame {i:2d}: {m.state} kf={int(m.new_kf)} inliers="
            f"{m.n_inliers} points={m.n_points} kfs={m.n_kfs} "
            f"{ms[-1]:.1f} ms")
    return ms, out


def need_launches(counts: dict, label: str, sites=()) -> None:
    if counts["k1"] <= 0 or counts["k2"] <= 0:
        raise AssertionError(f"{label}: a kernel was not launched: {counts}")
    for site in sites:
        if counts["k2_sites"].get(site, 0) <= 0:
            raise AssertionError(f"{label}: K2 not launched at the {site} "
                                 f"call site: {counts}")


def phase_main_path(dev) -> dict:
    from lldslam_tpu_torch.io.synthetic import make_sequence
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.system import System

    cfg = kitti_config()
    t0 = time.perf_counter()
    frames, poses, _ = make_sequence(cfg.camera.stereo_camera(), N_FRAMES,
                                     seed=3, return_poses=True)
    log(f"main path: generated {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, device=dev)
    t0 = time.perf_counter()
    sys_.warmup()
    log(f"main path: System.warmup {1e3 * (time.perf_counter() - t0):.1f} ms")
    tr = sys_.tracker
    if tr.vocabulary is None or tr.vocabulary.n_words != SHIPPED_WORDS:
        raise AssertionError("the shipped vocabulary was not loaded")
    reset_counts()
    ms, metrics = track(sys_, frames, label="main path")
    counts = read_counts()
    states = [m.state for m in metrics]
    kf_frames = [m.frame_id for m in metrics if m.new_kf]
    _, T_wc = tr.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    ate = ate_rmse(T_wc, gt)
    steady = ms[1:]
    kf_ms = [1e3 * m.t_kf for m in metrics if m.new_kf and m.t_kf > 0]
    lc, s = tr.loop_closer, tr.store
    loop_ms = [1e3 * t["loop"] for t in tr.kf_timings]
    live = set(np.nonzero(s.kf_valid[:s.n_kf])[0].tolist())
    log(f"main path: keyframes at {kf_frames}; ATE {ate:.5f} m; launches "
        f"{counts}; view capacity {len(tr._view_pid)}")
    log(f"main path: ms/frame median {statistics.median(steady):.1f} p90 "
        f"{float(np.percentile(steady, 90)):.1f} (first frame "
        f"{ms[0]:.1f}); {1e3 * len(steady) / sum(steady):.2f} frames/s; "
        f"ms per keyframe step (mapper + BA + loop) "
        f"{statistics.median(kf_ms) if kf_ms else float('nan'):.1f}")
    log(f"main path: loop step ms per keyframe median "
        f"{statistics.median(loop_ms):.2f} (all {[round(x, 2) for x in loop_ms]}); "
        f"loop closer totals (s) bow {lc.stage_times.get('bow', 0):.4f} "
        f"detect {lc.stage_times.get('detect', 0):.4f} over "
        f"{lc.stage_times.get('n', 0)} keyframes; database {len(lc.db.kf_words)}; "
        f"events {len(lc.events)}")
    if any(x != "OK" for x in states):
        raise AssertionError(f"not every frame OK: {states}")
    if len(kf_frames) < 5:
        raise AssertionError(f"only {len(kf_frames)} keyframes (want >= 5)")
    if lc.stage_times.get("n", 0) != s.n_kf:
        raise AssertionError(f"{lc.stage_times.get('n', 0)} keyframes went "
                             f"through the loop closer, {s.n_kf} exist")
    if set(lc.db.kf_words) != live:
        raise AssertionError(f"database holds {sorted(lc.db.kf_words)}, "
                             f"valid keyframes {sorted(live)}")
    if lc.events:
        raise AssertionError(f"loop event on a loop-free corridor: "
                             f"{lc.events}")
    need_launches(counts, "main path", ("tracking", "fusion"))
    if not ate <= ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m above {ATE_BOUND_M} m")
    return counts


def phase_loop(dev) -> dict:
    from lldslam_tpu_torch.io.synthetic import make_ring_sequence
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.system import System

    cfg = patch_world_config()
    t0 = time.perf_counter()
    frames, gt = make_ring_sequence(cfg.camera.stereo_camera())
    log(f"loop: rendered {len(frames)} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, device=dev)
    sys_.tracker.mapper.p_cap = 4096
    sys_.tracker.mapper.o_cap = 8192
    reset_counts()
    ms, metrics = track(sys_, frames, label="loop")
    counts = read_counts()
    tr = sys_.tracker
    lc = tr.loop_closer
    lost = sum(m.state == "LOST" for m in metrics)
    _, T_wc = tr.trajectory()
    gt_wc = np.stack([gt[0] @ np.linalg.inv(g) for g in gt])
    ate = ate_rmse(T_wc, gt_wc, align=False)
    loop_ms = [1e3 * t["loop"] for t in tr.kf_timings]
    log(f"loop: events {[(e.query_kf, e.matched_kf, e.n_inliers) for e in lc.events]} "
        f"(JAX-CPU run: (28, 1, 104)); lost {lost}; keyframes {tr.store.n_kf}; "
        f"unaligned ATE {ate:.4f} m (JAX-CPU run 0.455 m); launches {counts}")
    for e in lc.events:
        log(f"loop: event ({e.query_kf}, {e.matched_kf}) ms by stage "
            + json.dumps({k: round(v, 2) for k, v in e.stage_ms.items()}))
    log(f"loop: ms/frame median {statistics.median(ms[1:]):.1f}; loop step "
        f"ms per keyframe median {statistics.median(loop_ms):.2f} max "
        f"{max(loop_ms):.1f}")
    if not lc.events:
        raise AssertionError("no loop event on the circle")
    if lost > 2:
        raise AssertionError(f"{lost} frames lost (want <= 2)")
    if not ate < RING_ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m above {RING_ATE_BOUND_M} m")
    need_launches(counts, "loop", ("tracking", "fusion", "loop"))
    return counts


def phase_reloc(dev) -> tuple[dict, dict]:
    """Returns the launch counts of the System run and those of the direct
    calls of the relocalization call site."""
    from lldslam_tpu_torch.frontend.matching import FrameFeatures
    from lldslam_tpu_torch.geometry import se3
    from lldslam_tpu_torch.io.synthetic import (corridor_poses,
                                                make_points_world,
                                                render_points)
    from lldslam_tpu_torch.loop.closing import PROJECT_CAP, project_match
    from lldslam_tpu_torch.system import System

    cfg = patch_world_config()
    cam = cfg.camera.stereo_camera()
    pts, patches = make_points_world(np.random.default_rng(3))
    gt = corridor_poses(34)
    frames = [render_points(cam, gt[i], pts, patches) for i in range(28)]
    blank = np.full((cam.height, cam.width), 15.0, np.float32)
    sys_ = System(cfg, device=dev)
    sys_.tracker.mapper.p_cap = 2048
    sys_.tracker.mapper.o_cap = 6144
    reset_counts()
    _, before = track(sys_, frames, label="reloc")
    _, blind = track(sys_, [(blank, blank)] * 3, t0=1.0, label="reloc blank")
    ms, (m,) = track(sys_, [render_points(cam, gt[4], pts, patches)], t0=2.0,
                     label="reloc revisit")
    counts = read_counts()
    tr = sys_.tracker
    T_est = tr.T_cw.copy()
    err = se3.log(torch.from_numpy(np.linalg.inv(T_est) @ gt[4])).numpy()
    e_t, e_r = float(np.linalg.norm(err[:3])), float(np.linalg.norm(err[3:]))
    log(f"reloc: revisit {m.state} against keyframe {m.reloc_kf}, "
        f"{m.n_inliers} inliers, error {e_t:.4f} m {e_r:.5f} rad (JAX-CPU "
        f"run 0.0298 m 0.00088 rad); relocalization frame {ms[0]:.1f} ms; "
        f"launches {counts}")
    if any(x.state != "OK" for x in before) or sys_.map.n_kf <= 5:
        raise AssertionError("the corridor before the blackout was not "
                             "tracked")
    if blind[-1].state != "LOST":
        raise AssertionError(f"blank frames did not lose tracking: "
                             f"{[x.state for x in blind]}")
    if m.state != "OK" or m.reloc_kf < 0:
        raise AssertionError("relocalization failed")
    if not (e_t < RELOC_BOUND[0] and e_r < RELOC_BOUND[1]):
        raise AssertionError(f"relocalized pose error {e_t} m {e_r} rad")
    need_launches(counts, "reloc", ("tracking", "fusion"))

    # the relocalization call site of K2, driven directly: the local map of
    # the relocalized keyframe and its covisible keyframes, projected into
    # the relocalized frame at its pose
    s = tr.store
    covis, _ = s.covisible_kfs(m.reloc_kf, min_shared=15, top=10)
    pids = np.unique(s.kf_pt_ids[np.concatenate([[m.reloc_kf], covis])])
    pids = pids[pids >= 0]
    pids = pids[s.pt_valid[pids]]
    fd = SimpleNamespace(feats=tr._last_feats)
    cpu_feats = FrameFeatures(*(x.cpu() for x in tr._last_feats))
    cpu_kp2pid = [project_match(s, cpu_feats, pids, T_est, th, "reloc")
                  for th in (2.5, 0.75)]
    reset_counts()
    got_kp2pid = [tr._project_view_match(fd, pids, T_est, th=th)
                  for th in (2.5, 0.75)]
    site = read_counts()
    for th, got, want in zip((2.5, 0.75), got_kp2pid, cpu_kp2pid):
        if not np.array_equal(got, want):
            raise AssertionError(f"reloc call site th={th}: kp2pid differs "
                                 f"from the CPU plain path in "
                                 f"{int((got != want).sum())} features")
        log(f"reloc: direct _project_view_match th={th}: {len(pids)} map "
            f"points in {PROJECT_CAP} K2 rows, {int((got >= 0).sum())} "
            f"matches, equal to the CPU plain path")
    if site["k2_sites"] != {"reloc": 2} or site["k1"] != 0:
        raise AssertionError(f"direct reloc call site launches {site} (want "
                             f"K2 twice at the reloc site, nothing else)")
    return counts, site


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    paths = dict(main=phase_main_path(dev), loop=phase_loop(dev))
    paths["reloc"], paths["reloc_site"] = phase_reloc(dev)
    main = paths["main"]
    kernels = [
        dict(name="sample_patches", route="cuda",
             source="lldslam_tpu_torch/csrc/patch_sample.cu",
             replaces="lldslam_tpu/ops/patch_sample.py:68",
             launches=main["k1"],
             launches_by_path={p: c["k1"] for p, c in paths.items()}, **k1),
        dict(name="masked_best2", route="cuda",
             source="lldslam_tpu_torch/csrc/match_best2.cu",
             replaces="lldslam_tpu/ops/pallas_match.py:110",
             launches=main["k2"],
             launches_by_path={p: c["k2"] for p, c in paths.items()},
             launches_by_site={p: c["k2_sites"] for p, c in paths.items()},
             **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
