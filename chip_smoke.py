"""Smoke test of the PyTorch/CUDA port (lldslam_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the three CUDA kernels compiled from lldslam_tpu_torch/csrc with
   nvcc;
3. K1a (fused ORB describe) and K1b (fused stereo SAD) against their plain
   PyTorch versions, every output exact, at the frame build's shapes
   (lldslam_tpu_torch.io.kernel_inputs: 4000 keypoints on 8 levels x 2
   views, a third within 2 px of the detection margin; 2048 SAD slots with
   forced SAD ties);
4. K2g (gated Hamming best-2) against its plain version, all four outputs
   exact, at the tracking (4096 x 2048), fusion (2048 x 2048) and loop /
   relocalization (8192 x 2048) shapes with tied columns, an empty row and
   a one-candidate row;
   each of phases 3-4 prints kernel ms, plain ms and bound ms (K1a's and
   K1b's bytes count the distinct pixels their taps touch in this run);
5. main path: 30 synthetic KITTI-size stereo frames (1241x376, 2000 ORB
   features, 8 levels x 1.2) through lldslam_tpu_torch.system.System on the
   card with its defaults (loop closing on, the shipped 99106-word
   vocabulary), with asserts on tracking state, keyframes, the loop step of
   every keyframe, kernel launches and ATE; it also reports the pairs K2g's
   gates pass per call at the tracking and fusion sites, and times K1a and
   K1b again on the last frame's own inputs against their bound;
6. loop: the 88-frame circle of tests/test_loop_e2e.py (512x384, 600
   features) through System: a loop event, K2g at the loop call site, ATE
   under the test's bound;
7. reloc: the blackout scenario of tests/test_reloc.py through System, then
   K2g at the relocalization call site (8192 rows) on the relocalized frame,
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


def device_ms(fn, reps: int = 20) -> float:
    """Device time (ms) of the kernels one call of fn() launches, summed and
    averaged over `reps` calls (torch.profiler's CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / reps


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


HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _exact(label, got, want) -> float:
    """Every output equal, bit for bit; returns the max abs difference (0)."""
    torch.cuda.synchronize()
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            bad = int((g != w).reshape(g.shape[0], -1).any(-1).sum())
            raise AssertionError(f"{label}: output {i} differs in {bad} rows")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def _timed(label, fn, plain, bytes_, ops) -> dict:
    """ms: the kernel's device time; call_ms: one call on the host clock of
    the stream (CUDA events, launch included); plain_ms, plain_device_ms:
    the plain version's."""
    row = dict(ms=device_ms(fn), call_ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
               plain_device_ms=device_ms(plain))
    row["bound_ms"], row["bound_by"] = bound(bytes_, ops)
    log(f"{label}: exact; kernel {row['ms']:.4f} ms on the device "
        f"({row['call_ms']:.4f} ms a call), plain {row['plain_ms']:.4f} ms "
        f"({row['plain_device_ms']:.4f} on the device), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound")
    return row


def distinct_pixels(shape, *taps) -> int:
    """How many distinct pixels of an (I, H, W) stack the taps touch; each
    tap set is (image, row, column), broadcast to one shape. Windows of
    nearby keypoints overlap, so a kernel that reads every pixel once reads
    this many."""
    _, H, W = shape
    flat = [((i.long() * H + y.long()) * W + x.long()).reshape(-1)
            for i, y, x in taps]
    return int(torch.unique(torch.cat(flat)).numel())


def _level_hw(shapes, idx):
    """(h, w) (n, 1) int32 of each keypoint's image."""
    t = torch.tensor(shapes, dtype=torch.int32, device=idx.device)[idx.long()]
    return t[:, 0:1], t[:, 1:2]


def k1a_work(d, angle) -> tuple[int, int, int, int]:
    """(bytes, operations, distinct pixels, taps) of K1a on its arguments d
    and the angles it returned. The pixels: moment taps clamped to the
    stack, BRIEF taps rotated by those angles and clamped to the level. The
    bytes: those pixels read once, xy and image index in, the angle and 8
    words out. The operations: two multiply-adds per moment tap, a rotation
    (6 ops) and a compare per BRIEF tap."""
    from lldslam_tpu_torch.ops import orb_describe as od
    pyr, blur, xy, idx, image_hw = d
    n, (_, H, W) = xy.shape[0], pyr.shape
    off = lambda o: torch.tensor(o, dtype=torch.int32, device=xy.device)
    hk, wk = _level_hw(image_hw, idx)
    gy, gx = od.rotated_taps(xy, angle, hk[:, 0], wk[:, 0])
    px = (distinct_pixels(pyr.shape, (
        idx[:, None], (xy[:, 1:2] + off(od.IC_DY)).clamp(0, H - 1),
        (xy[:, 0:1] + off(od.IC_DX)).clamp(0, W - 1)))
        + distinct_pixels(blur.shape, (idx[:, None, None], gy, gx)))
    n_ic = len(od.IC_DX)
    return (4 * px + n * (12 + 36), n * (4 * n_ic + 13 * 256), px,
            n * (n_ic + 512))


def k1b_work(s) -> tuple[int, int, int, int]:
    """(bytes, operations, distinct pixels, taps) of K1b on its arguments s.
    The pixels: the left patches and right strips, clamped to the level
    (padding slots all sit at (0, 0) of level 0 and count once). The bytes:
    those pixels, 4 ints in, 3 values out. The operations: 3 per SAD term."""
    from lldslam_tpu_torch.ops import stereo_sad as sd
    stack, shapes, lvl, ul, vl, ur = s
    n, dev = lvl.shape[0], lvl.device
    hk, wk = _level_hw(shapes, lvl)
    wh, sw = sd.W_HALF, sd.W_HALF + sd.L_SWEEP
    o = torch.arange(-wh, wh + 1, dtype=torch.int32, device=dev)
    o_s = torch.arange(-sw, sw + 1, dtype=torch.int32, device=dev)
    clip = lambda c, hi: torch.minimum(c.clamp(min=0), hi - 1)
    rows = clip(vl[:, None] + o, hk)[:, :, None]
    left = (2 * lvl)[:, None, None]
    px = distinct_pixels(
        stack.shape, (left, rows, clip(ul[:, None] + o, wk)[:, None, :]),
        (left + 1, rows, clip(ur[:, None] + o_s, wk)[:, None, :]))
    return 4 * px + n * (16 + 12), n * 11 * 121 * 3, px, n * 352


def phase_k1(dev) -> tuple[dict, dict]:
    from lldslam_tpu_torch.io import kernel_inputs as ki
    from lldslam_tpu_torch.ops import orb_describe, stereo_sad
    rng = np.random.default_rng(0)
    d = ki.describe_inputs(rng, dev)
    got = orb_describe.describe(*d)
    err = _exact("K1a orb_describe", got, orb_describe.describe_plain(*d))
    n_bytes, n_ops, px, taps = k1a_work(d, got[0])
    k1a = _timed(f"K1a orb_describe n={d[2].shape[0]} stack="
                 f"{tuple(d[0].shape)}, {px} distinct pixels for {taps} taps",
                 lambda: orb_describe.describe(*d),
                 lambda: orb_describe.describe_plain(*d), n_bytes, n_ops)
    k1a.update(max_abs_err=err, distinct_pixels=px, taps=taps)
    s = ki.sad_inputs(rng, dev)
    got = stereo_sad.sad_refine(*s)
    err = _exact("K1b stereo_sad", got, stereo_sad.sad_refine_plain(*s))
    ties = int((got[1] == 0).sum())
    if ties < 32:
        raise AssertionError(f"K1b: {ties} zero-cost rows, want the 32 forced "
                             f"ties")
    n_bytes, n_ops, px, taps = k1b_work(s)
    k1b = _timed(f"K1b stereo_sad n={s[2].shape[0]} ({ties} tied rows), {px} "
                 f"distinct pixels for {taps} taps",
                 lambda: stereo_sad.sad_refine(*s),
                 lambda: stereo_sad.sad_refine_plain(*s), n_bytes, n_ops)
    k1b.update(max_abs_err=err, distinct_pixels=px, taps=taps)
    return k1a, k1b


def _k2g_case(rng, dev, M, label) -> dict:
    from lldslam_tpu_torch.io import kernel_inputs as ki
    from lldslam_tpu_torch.ops import match_best2 as mb
    g = ki.gated_best2_inputs(rng, dev, M)
    N = g[7].shape[0]
    got = mb.gated_best2(*g)
    err = _exact(f"K2g {label}", got, mb.gated_best2_plain(*g))
    h = [x.cpu().numpy() for x in got]
    e, o, c = ki.EMPTY_ROW, ki.ONE_ROW, ki.ONE_COL
    if not (h[1][e] == 10000 and h[0][e] == 0 and h[3][e] == 0
            and h[0][o] == c and h[2][o] == 10000 and h[3][o] == 0):
        raise AssertionError(f"K2g {label}: empty / one-candidate row contract")
    tied = int((h[1][:64] == h[2][:64]).sum())
    if tied < 32 or (h[0][:64][h[1][:64] == h[2][:64]] >= N // 2).any():
        raise AssertionError(f"K2g {label}: tied rows {tied}, or a tie went "
                             f"to the higher column")
    gated = int(mb.gate_mask(*g[1:7], *g[8:]).sum())
    # row fields and descriptors, column fields and descriptors, 4 outputs;
    # deciding a pair takes at least a subtraction, an absolute value and a
    # comparison, and a gated pair 8 XOR, 8 popcounts and 7 adds
    row = _timed(f"K2g {label}: M={M} N={N}, {gated} gated pairs "
                 f"({100 * gated / (M * N):.4f}%), {tied} tied rows",
                 lambda: mb.gated_best2(*g),
                 lambda: mb.gated_best2_plain(*g),
                 M * (32 + 16 + 4 + 1 + 16) + N * (32 + 8 + 4 + 4 + 1),
                 3 * M * N + 23 * gated)
    row.update(max_abs_err=err, gated_pairs=gated)
    return row


def phase_k2g(dev) -> dict:
    rng = np.random.default_rng(1)
    cases = dict(tracking=_k2g_case(rng, dev, 4096, "tracking"),
                 fusion=_k2g_case(rng, dev, 2048, "fusion"),
                 loop_reloc=_k2g_case(rng, dev, 8192, "loop / reloc"))
    out = dict(cases["tracking"])
    out["max_abs_err"] = max(c["max_abs_err"] for c in cases.values())
    out["by_shape"] = cases
    return out


def reset_counts() -> None:
    from lldslam_tpu_torch.ops import match_best2, orb_describe, stereo_sad
    orb_describe.launches = 0
    stereo_sad.launches = 0
    match_best2.launches = 0
    match_best2.launches_by_site = {}


def read_counts() -> dict:
    from lldslam_tpu_torch.ops import match_best2, orb_describe, stereo_sad
    return dict(k1a=orb_describe.launches, k1b=stereo_sad.launches,
                k2g=match_best2.launches,
                k2g_sites=dict(match_best2.launches_by_site))


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
    if min(counts["k1a"], counts["k1b"], counts["k2g"]) <= 0:
        raise AssertionError(f"{label}: a kernel was not launched: {counts}")
    for site in sites:
        if counts["k2g_sites"].get(site, 0) <= 0:
            raise AssertionError(f"{label}: K2g not launched at the {site} "
                                 f"call site: {counts}")


def keep_inputs(mod, name: str, sites=None, last_only: bool = False):
    """Wraps the kernel wrapper mod.<name> so that a copy of the arguments
    of its calls (those at one of `sites`, where given; the last one only,
    where `last_only`) is kept as (site, args); returns (kept, restore)."""
    kernel, kept = getattr(mod, name), []

    def wrapper(*args, **kw):
        if sites is None or kw.get("site") in sites:
            if last_only:
                kept.clear()
            kept.append((kw.get("site"), tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)))
        return kernel(*args, **kw)

    setattr(mod, name, wrapper)
    return kept, lambda: setattr(mod, name, kernel)


def frame_kernels(kept_k1a, kept_k1b) -> dict:
    """K1a and K1b on the last frame's own inputs: device ms and the bound
    of the distinct pixels their taps touch."""
    from lldslam_tpu_torch.ops import orb_describe, stereo_sad
    (_, d), (_, s) = kept_k1a[-1], kept_k1b[-1]
    out = {}
    for key, fn, args, (n_bytes, n_ops, px, taps) in (
            ("k1a", orb_describe.describe, d,
             k1a_work(d, orb_describe.describe(*d)[0])),
            ("k1b", stereo_sad.sad_refine, s, k1b_work(s))):
        ms = device_ms(lambda: fn(*args))
        b_ms, by = bound(n_bytes, n_ops)
        out[key] = dict(n=args[2].shape[0], ms=ms, bound_ms=b_ms, bound_by=by,
                        distinct_pixels=px, taps=taps)
        log(f"main path, last frame's own inputs: {key} n={args[2].shape[0]}: "
            f"{px} distinct pixels for {taps} taps; kernel {ms:.4f} ms on the "
            f"device, bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / ms:.1f}% of bound")
    return out


def gate_density(kept) -> dict:
    """Per site: the rows M, columns N and gated pairs (the pairs the gates
    pass) of each K2g call, from the kept arguments, and the median share
    of gated pairs among the M x N."""
    from lldslam_tpu_torch.ops import match_best2 as mb
    out = {}
    for site, g in kept:
        o = out.setdefault(site, dict(M=[], N=[], pairs=[]))
        o["M"].append(g[0].shape[0])
        o["N"].append(g[7].shape[0])
        o["pairs"].append(int(mb.gate_mask(*g[1:7], *g[8:]).sum()))
    for o in out.values():
        o["median_share"] = statistics.median(
            p / (m * n) for p, m, n in zip(o["pairs"], o["M"], o["N"]))
    return out


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
    from lldslam_tpu_torch.ops import match_best2, orb_describe, stereo_sad
    kept_g, restore_g = keep_inputs(match_best2, "gated_best2",
                                    sites=("tracking", "fusion"))
    kept_a, restore_a = keep_inputs(orb_describe, "describe", last_only=True)
    kept_b, restore_b = keep_inputs(stereo_sad, "sad_refine", last_only=True)
    try:
        reset_counts()
        ms, metrics = track(sys_, frames, label="main path")
        counts = read_counts()
    finally:
        restore_g(), restore_a(), restore_b()
    frame_k = frame_kernels(kept_a, kept_b)
    gates = gate_density(kept_g)
    for site, o in gates.items():
        log(f"main path: K2g at the {site} site, {len(o['M'])} calls of "
            f"{min(o['M'])}-{max(o['M'])} x {min(o['N'])}-{max(o['N'])}: "
            f"gated pairs per call median {statistics.median(o['pairs'])} "
            f"(min {min(o['pairs'])}, max {max(o['pairs'])}), median share "
            f"{100 * o['median_share']:.4f}% of the M x N pairs")
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
    return dict(counts, frame_kernels=frame_k, k2g_gated_pairs=gates)


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
            f"points in {PROJECT_CAP} K2g rows, {int((got >= 0).sum())} "
            f"matches, equal to the CPU plain path")
    if site["k2g_sites"] != {"reloc": 2} or site["k1a"] or site["k1b"]:
        raise AssertionError(f"direct reloc call site launches {site} (want "
                             f"K2g twice at the reloc site, nothing else)")
    return counts, site


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1a, k1b = phase_k1(dev)
    k2g = phase_k2g(dev)
    paths = dict(main=phase_main_path(dev), loop=phase_loop(dev))
    paths["reloc"], paths["reloc_site"] = phase_reloc(dev)
    by_path = lambda k: {p: c[k] for p, c in paths.items()}
    kernels = [
        dict(name="orb_describe", route="cuda",
             source="lldslam_tpu_torch/csrc/orb_describe.cu",
             replaces="lldslam_tpu/ops/patch_sample.py:68", exact=True,
             launches=paths["main"]["k1a"], launches_by_path=by_path("k1a"),
             main_path_frame=paths["main"]["frame_kernels"]["k1a"],
             library_ms=None, **k1a),
        dict(name="stereo_sad", route="cuda",
             source="lldslam_tpu_torch/csrc/stereo_sad.cu",
             replaces="lldslam_tpu/ops/patch_sample.py:68", exact=True,
             launches=paths["main"]["k1b"], launches_by_path=by_path("k1b"),
             main_path_frame=paths["main"]["frame_kernels"]["k1b"],
             library_ms=None, **k1b),
        dict(name="gated_best2", route="cuda",
             source="lldslam_tpu_torch/csrc/match_best2.cu",
             replaces="lldslam_tpu/ops/pallas_match.py:110", exact=True,
             launches=paths["main"]["k2g"], launches_by_path=by_path("k2g"),
             launches_by_site=by_path("k2g_sites"),
             main_path_gated_pairs=paths["main"]["k2g_gated_pairs"],
             library_ms=None, **k2g),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
