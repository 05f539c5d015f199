"""Smoke test of the PyTorch/CUDA port (lldslam_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the five CUDA kernels compiled from lldslam_tpu_torch/csrc with
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
   then the points-only pose LM (csrc/pose_lm.cu, 4 x 10 iterations)
   against optimize_pose_plain on the same card tensors at the tracking
   step's 2048 rows (io.kernel_inputs.pose_lm_inputs), one mix problem a
   launch and mix, few, none, mix in one launch: poses within 5e-5 m and
   5e-6 rad, inlier masks equal but for rows within 1% of their chi2
   threshold (tests/test_torch_cuda.py::test_pose_lm_equals_plain), each
   problem of a batched launch bit-equal to its own S = 1 launch;
   each of phases 3-4 prints kernel ms, plain ms and bound ms (K1a's and
   K1b's bytes count the distinct pixels their taps touch in this run; the
   pose LM's bound is far below its time, which the latency of its 45
   dependent block-wide reductions sets);
5. main path: 30 synthetic KITTI-size stereo frames (1241x376, 2000 ORB
   features, 8 levels x 1.2) through lldslam_tpu_torch.system.System on the
   card with its defaults (loop closing on, the shipped 99106-word
   vocabulary), with asserts on tracking state, keyframes, the loop step of
   every keyframe, kernel launches and ATE; it also reports the pairs K2g's
   gates pass per call at the tracking and fusion sites, and times K1a and
   K1b again on the last frame's own inputs against their bound; the pose
   LM kernel launches twice a tracking step (counted at the track site)
   and its last frame's two calls are held to the plain LM as in phase 4,
   the last one timed;
6. lines: the stored-line world of the JAX bench's lines section (30
   seed-2 KITTI-size frames with lines painted on the walls, stored
   detections written by lldslam_tpu_torch.io.synthetic.gen_stored_lines
   into a temporary directory, ldType LBDFloat, mdThr 0.6) through System
   with loops on: asserts on states, keyframes, ATE, line matches per
   frame, valid map lines, stored-line capacity events and kernel
   launches; per-frame ms, the line step's, stereo matcher's and joint
   local BA's ms (wrapped functions) and the keyframe line stages; the last
   frame's stereo line match on the card against the CPU and its host
   syncs; the loop closer's joint global BA once on the final map; then the
   same frames with lines off (ATE with lines on against off);
7. loop: the 88-frame circle of tests/test_loop_e2e.py (512x384, 600
   features) through System: a loop event, K2g at the loop call site, ATE
   under the test's bound;
8. reloc: the blackout scenario of tests/test_reloc.py through System, then
   K2g at the relocalization call site (8192 rows) on the relocalized frame,
   held exactly to the same call on CPU copies;
9. mono: the left views of the main path's 30 frames through
   System.track_monocular (H/F bootstrap, loops on): asserts on the
   bootstrap frame, states, keyframes, map points, Sim(3)-aligned ATE and
   kernel launches (K1a once a frame, no K1b); ms per frame and the
   bootstrap frame's ms; K1a on the last frame's own one-view inputs,
   exact against its plain version, timed against its bound;
10. rgbd: 30 frames of a TUM-size corridor (the TUM fr1 camera, 1000
   features) with the left view's ray-cast depth (0 beyond 8 m) through
   System.track_rgbd: asserts on states, keyframes, map points and
   unaligned ATE; then the top-down map render and a map checkpoint saved
   and loaded into a fresh System with every array equal;
11. rectify: StereoRectifier with EuRoC-like blocks (752x480) on one
   synthetic pair on the card against the CPU, and its ms per pair;
12. loop_lines: one loop correction (`LoopCloser._correct`: pose graph,
   point and map-line remap, fusion through K2g, the joint point+line
   global BA) on the seeded loop map with map lines
   (io.synthetic.make_loop_map + add_loop_lines), on the card against the
   same correction on the CPU;
13. multiseq: lldslam_tpu_torch.parallel.MultiSequenceDriver at the main
   path's KITTI config with loops off, S = 4 corridors (seeds 3, 10, 11,
   12) for 20 frames, view capacity pinned to 4096: every sequence held to
   its own solo System run on the card (every frame OK, camera centres
   within 0.05 m, keyframe counts within one); K1a, K1b and K2g (tracking
   site) launched once per batched frame; on the last batched frame each
   kernel exact against its plain version and, sequence by sequence,
   against an S = 1 launch; the pose LM twice a batched step (S = 4 in one
   launch), the last batched frame's two calls held to the plain LM as in
   phase 4; ms per batched frame, sequence-frames per
   second against the solo runs', one torch.profiler window of 5 batched
   frames against 5 solo frames (device kernels, busy share), each
   kernel's device time at S = 4 against its bound; then S = 13 at the JAX
   bench's multi-sequence config (640x240, 600 features, seeds 10-22) for
   10 frames, every frame OK, timed;
14. native_lines: the port's CLI (`cli.main`, default device) on the
   checked-in mini KITTI sequence, PNGs decoded by the native prefetcher,
   once on its stored lines and once on the native line detector, each
   against the same command on the CPU; then the lines world written as
   KITTI-layout PNGs (ldType LBDFloat, mdThr 0.6, no detections path)
   through the CLI on the native detector: states, keyframes, ATE and line
   matches against the JAX package's CPU run of that world, the decoded
   pairs against the rendered frames, ms per frame, the detector's ms per
   view and peak memory, decode ms per image and the host's wait in the
   prefetcher per frame; then the detector alone on one KITTI view: two
   card calls bit-identical, the card against the CPU, and
   precompute_sequence's files read back to the detector's outputs.
15. pipelined (after main): the main path's config and world through
   System(pipeline=True) on the JAX bench's headline schedule (bench.py:
   267-305: warmup, 6 frames through track_stereo, the other 24 staged by
   stage_stereo and passed as pair_dev, the last 3 inside one profiler
   window, then flush), loops on: every frame OK and finalized once, in
   order; keyframes equal to the port's own pipelined run on the CPU
   (tools/torch_pipelined_keyframes.py); camera centres within 0.35 m of
   the synchronous main path; ATE under the JAX package's CPU run of the
   same schedule + 0.02 m; 0 host syncs in a steady-state dispatch; K1a
   and K1b on the last frame build and K2g on its last call at the
   tracking and at the fusion site exact against their plain versions; the
   pose LM twice a chained step, its last two calls held to the plain LM
   as in phase 4 (likewise in 16 and pipelined_native_lines); ms
   per call against the synchronous frames, the synchronous step's
   read-back wait, the busy share; then the same schedule again: the same
   keyframes and poses, bit for bit;
16. pipelined_lines (after lines): the stored-line world on the same
   schedule with its detections staged by stage_stored_pair: as 15 against
   the synchronous lines run (centres within 0.25 m), line matches against
   the JAX package's CPU run of that schedule (no profiler window);
17. pipelined_multiseq (last): PipelinedMultiSequenceDriver, S = 4 KITTI-size
   corridors for 20 frames with sequence 1 ending after 12, against each
   sequence's solo pipelined System: every frame OK, centres within 0.35 m,
   K1a and K1b once a batched frame, the last frame's batched K1a, K1b and
   K2g exact against their plain versions, the pose LM twice a batched
   step and its last batched calls held as in phase 4, sequence-frames/s;
18. dist (after loop_lines): the loop-event solvers repeat bit for bit and
   the distributed global BA (lldslam_tpu_torch.parallel.dist_schur) on
   the one-rank NCCL group of dist_schur.make_mesh equals the single route
   bit for bit, with no deterministic mode (the solvers' float sums run
   through the fixed-order segment-sum kernel, csrc/segment_sum.cu):
   LoopCloser.global_ba through the single and the distributed route, in
   turns, on copies of the loop phase's ring map (host ms of each route,
   median of 3; all_reduce calls and segment-sum launches per solve), every
   run bit-equal to the first; the loop-lines correction twice on the
   single route and once on the distributed route, all bit-equal and equal
   to the loop_lines phase's card result; the ring event's pose graph
   through optimize_pose_graph twice, bit-equal; both routes of global_ba
   on the corrected map, bit-equal and timed; then the segment-sum kernel
   on the inputs of every call site of one ring-map global BA and one
   loop-lines correction, each exact against CPU index_add_ (its plain
   version) and against a second launch, with its device ms, its bound,
   the atomic index_add_ on the card (the library yardstick),
   index_put_(accumulate=True), the CPU index_add_ and the layout build;
19. dist_ranks: graft_entry.dryrun_multichip on every card (NCCL, one rank
   a card) beside two spawned gloo ranks on one card, each running the
   loop-lines correction with global_ba routed by the world size: the
   ranks' maps bit-equal, rank 0 within the loop_lines bounds of the
   one-rank result; ms of each.
The main path's last frame's K1a and K1b inputs are held exactly to the
plain versions too. Kernel launches are counted per path (counts zeroed just
before, read just after): main, lines, loop, reloc, mono and rgbd are
System runs; reloc_site is the two direct calls of the relocalization call
site; loop_lines the two corrections (the CPU one launches nothing); dist
the loop-lines correction on the distributed route; multiseq and
multiseq_13 the driver runs; mini_kitti the two mini KITTI CLI runs;
native_lines the KITTI-size CLI run on the native detector; pipelined,
pipelined_lines and pipelined_native_lines the staged frames and the flush;
pipelined_multiseq the pipelined multi-sequence run. The pose LM's launches
are counted by the caller's site too (track, ref_anchor, reloc). The
second-to-last line is the kernel table as JSON, the last line the device
summary as JSON.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
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
# the JAX package's CPU run of the lines world (its System on the same 30
# frames, synchronous, loops on): line matches per frame median 232, 383
# valid map lines, ATE 0.00635 m with lines and 0.00697 m without, 60
# capacity events dropping 1864 stored lines
LINES_JAX = dict(ate_on=0.00635, ate_off=0.00697, cap=(60, 1864))
LINE_MATCH_RANGE = (209, 255)      # 232 +- 10%
LINE_MAP_RANGE = (326, 440)        # 383 +- 15%
# the JAX package's CPU runs of the mono and RGB-D phases' inputs: mono
# bootstraps at frame 1, keyframes at frames 1, 4, 11, 17, 27 (6 with the
# bootstrap's two), 739 map points, Sim(3)-aligned ATE 0.0414 m (scale
# 17.02); RGB-D keyframes at 0, 3, 12, 22, 886 points, unaligned ATE
# 0.00459 m
MONO_POINT_RANGE = (590, 890)      # 739 +- 20%
MONO_ATE_BOUND_M = 0.10
RGBD_KF_FRAMES = (0, 3, 12, 22)
RGBD_POINT_RANGE = (750, 1020)     # 886 +- 15%
RGBD_ATE_BOUND_M = 0.025           # 0.00459 m + 0.02 m
RGBD_MAX_DEPTH_M = 8.0             # a Kinect-class sensor reads no further
RECTIFY_TOL = 1e-3
# the JAX package's CPU run of the native_lines world (its synchronous
# System, loops on, the native detector, on the same 30 seed-2 frames and
# config): every frame OK, keyframes at frames 0, 3, 6, 10, 14, 18, 22, 27,
# line matches per frame median 1 (frames 1-29), ATE 0.006938 m
NATIVE_LINES_JAX = dict(ate=0.006938189419458925, n_kf=8, line_matches=1)
NATIVE_LINE_MATCH_RANGE = (0.9, 1.1)      # 1 +- 10%
MINI_KITTI = "tests/data/mini_kitti"
MINI_ATE_BOUND_M = 0.5                    # tests/test_cli_e2e.py
MINI_CENTRE_BOUND_M = 0.05                # the card against the CPU
# tests/test_torch_line_detect.py: endpoints within 1e-3 px, descriptors
# within 1e-5 + 0.5 x the line's endpoint difference (px)
DETECT_PX, DETECT_DESC, DETECT_DESC_PER_PX = 1e-3, 1e-5, 0.5
DETECT_FED_PX, DETECT_FED_DESC = 0.5, 0.02
MULTISEQ_SEEDS = (3, 10, 11, 12)
# the multi-sequence depths, cut (from 20, 5 and 10 frames) to keep the
# whole script near its time budget: 13 frames still hold four keyframes a
# sequence and outlast PIPE_MULTISEQ_END; 6 frames of S = 13 hold two
MULTISEQ_FRAMES = 13
MULTISEQ_VIEW_CAP = 4096    # a KITTI-size local view can exceed 2048 points
MULTISEQ_BOUND_M = 0.05     # tests/test_multi_seq.py:117
PROFILE_FRAMES = 3
SWEEP_SEEDS = tuple(range(10, 23))   # bench.py:376-381, 13 sequences
SWEEP_FRAMES = 6
# the pipelined phases (the JAX bench's headline schedule, bench.py:267-305:
# warm frames through track_stereo, then frames staged by stage_stereo and
# passed as pair_dev, then flush). The JAX package's CPU runs of the same
# schedule, loops on, on the main path's world (tools/
# jax_cpu_pipelined_reference.py main, two runs; its staged absorbs follow
# the host's timing): every frame OK, keyframes at 0, 3, 7, 10, 14, 17, 20,
# 23, 26, 29 / 0, 3, 7, 10, 13, 16, 19, 22, 25, 28 (its synchronous run: 0,
# 3, 6, 10, 15, 20, 24, 29), ATE 0.012774 / 0.016029 m, centres within
# 0.0522 / 0.0530 m of its synchronous run; the bound takes the first
PIPE_WARM = 6
PIPE_PROFILE = 3                  # the last staged frames, profiled
PIPE_ATE_BOUND_M = 0.012774 + 0.02
PIPE_CENTRE_BOUND_M = 0.35        # tests/test_pipelined.py
PIPE_LINES_CENTRE_BOUND_M = 0.25  # tests/test_lines_e2e.py
PIPE_MULTISEQ_END = 12            # sequence 1 ends after this many frames
# the stored-line world (tools/jax_cpu_pipelined_reference.py lines, two
# runs; its staged absorbs follow the host's timing): every frame OK,
# keyframes at 0, 3, 7, 10, 13, 16, 19, 22, 25, 28, line matches per frame
# median 206 / 208 (frames 1-29), 409 valid map lines, ATE 0.008241 /
# 0.008070 m
PIPE_LINES_ATE_BOUND_M = 0.008241 + 0.02
# the port's own pipelined runs of the two worlds on the CPU, on the same
# schedule (tools/torch_pipelined_keyframes.py cpu)
PIPE_KF_CPU = (0, 3, 7, 10, 16, 19, 22, 25, 28)
PIPE_LINES_KF_CPU = (0, 3, 7, 10, 16, 19, 22, 25, 28)
PIPE_LINE_MATCH_RANGE = (175, 237)      # 206 +- 15%
# pipelined_native_lines: the JAX package's pipelined CPU run of the
# native-line world on the same schedule (tools/jax_cpu_pipelined_reference
# .py native_lines): every frame OK, keyframes at 0, 3, 7, 10, 13, 16, 19,
# 22, 25, 28, ATE 0.010142 m, 13 valid map lines, and the line matches per
# frame below (median 0, total 7, none after frame 13); its synchronous run
# on the same frames: median 1, total 20. The card's line matches are held
# to the JAX pipelined run's, median and total within +-15%; the
# synchronous run's median is logged beside them (the pipelined route
# starves the association in both packages, ROADMAP section 3)
PIPE_NATIVE_LINE_MATCH_SHARE = (0.85, 1.15)
PIPE_NATIVE_LINE_MATCHES_JAX = (0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
# the port's own pipelined CPU run of the world (tools/
# torch_pipelined_keyframes.py cpu native_lines): its keyframes (the
# schedule reads no clock, so the card must give them)
PIPE_NATIVE_KF_CPU = (0, 3, 7, 10, 16, 19, 22, 25, 28)
# a shorter profiler window (a native lines frame launches the detector's
# operations twice on top)
PIPE_NATIVE_PROFILE = 2
# cold_start: rounds after the first call in each of its two processes,
# and each process's time limit
COLD_REPS = 3
COLD_TIMEOUT_S = 300
# a first call after System.warmup over the warm median, at most; the
# relocalization frame is not held (PERF.md section 6: its rounds differ
# in work, the map growing between them)
COLD_AFTER_WARMUP_RATIO = 1.5
COLD_NOT_HELD = ("reloc_frame",)
# the pose LM kernel against the plain LM on the same card tensors
# (tests/test_torch_cuda.py::test_pose_lm_equals_plain): poses within these
# (m, rad), float32 sums in another order; inlier masks equal but for rows
# whose chi2 at the plain pose lies within this share of their threshold
POSE_LM_TOL = (5e-5, 5e-6)
POSE_LM_NEAR = 0.01


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


def _profile(fn):
    """torch.profiler session around fn() (synchronised); returns every
    event it recorded, host and device."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.events())


_spin_cycles_per_ms = None
_queue_depth = None
WAIT_TEST_LAUNCHES = 1000   # launches that queue behind a spin unblocked
QUEUE_TEST_COUNTS = (250, 500, 750, 1000, 1250, 1500, 2000, 3000)


def spin_cycles_per_ms() -> float:
    """The spin kernel's (torch.cuda._sleep) cycles per ms, measured once."""
    global _spin_cycles_per_ms
    if _spin_cycles_per_ms is None:
        cycles = 20_000_000
        a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _spin_cycles_per_ms = cycles / a.elapsed_time(b)
    return _spin_cycles_per_ms


def launch_queue_depth() -> dict:
    """How many kernel launches the host queues behind a spin kernel
    before a launch blocks, measured once: for each count of
    QUEUE_TEST_COUNTS, a 200-ms spin, then that many launches of one
    small elementwise kernel, timed on the host; the count blocked if the
    host took at least 0.9 of the spin. Two kernels: a contiguous add
    (few argument bytes) and an add on transposed views (an offset
    calculator in its arguments, as the strided operations of the path
    have). Returns per kernel the readings and the largest count that did
    not block, and `depth`, the smaller of the two."""
    global _queue_depth
    if _queue_depth is not None:
        return _queue_depth
    x = torch.zeros(64, 64, device="cuda")
    y = torch.ones(64, 64, device="cuda")
    kinds = dict(contiguous=lambda: x.add_(y),
                 strided=lambda: x.t().add_(y.t()))
    out = {}
    for kind, fn in kinds.items():
        fn()
        rows, free = [], 0
        for n in QUEUE_TEST_COUNTS:
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            torch.cuda._sleep(int(200 * spin_cycles_per_ms()))
            e1.record()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t)
            e1.synchronize()
            spin_ms = e0.elapsed_time(e1)
            torch.cuda.synchronize()
            blocked = host_ms >= 0.9 * spin_ms
            rows.append([n, round(host_ms, 2), round(spin_ms, 2), blocked])
            if blocked:
                break
            free = n
        out[kind] = dict(readings=rows, depth=free)
    out["depth"] = min(v["depth"] for v in out.values())
    log(f"launch queue: launches that queue behind a 200-ms spin without "
        f"the host blocking: contiguous add {out['contiguous']['depth']}, "
        f"strided add {out['strided']['depth']} (launches, host ms, spin ms,"
        f" blocked: {out['contiguous']['readings']} / "
        f"{out['strided']['readings']})")
    _queue_depth = out
    return out


def host_waits(fn) -> dict:
    """Whether one call of fn() makes the host wait for the device,
    independent of CUDA's sync debug mode (which does not see every
    synchronising operation): a spin kernel holds the stream for three
    times fn's own host time (at least 50 ms) while the host calls fn();
    had the host waited for the stream anywhere in the call, the call
    returns only after the spin. A host that fills the card's launch queue
    blocks in a launch too, so the verdict is conclusive only for calls of
    at most WAIT_TEST_LAUNCHES kernel launches (counted in a profiler
    session) and no more than this run's launch_queue_depth(). Returns the
    verdict, the launches, the call's host ms and the spin's device ms."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    alone_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    launches = sum(e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS
                   for e in _profile(fn))
    spin = max(50.0, 3 * alone_ms)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    e0.record()
    torch.cuda._sleep(int(spin * spin_cycles_per_ms()))
    e1.record()
    t = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    e1.synchronize()
    spin_ms = e0.elapsed_time(e1)
    torch.cuda.synchronize()
    return dict(waits=host_ms >= 0.9 * spin_ms, launches=launches,
                conclusive=launches <= min(WAIT_TEST_LAUNCHES,
                                           launch_queue_depth()["depth"]),
                host_ms=host_ms,
                spin_ms=spin_ms)


def device_ms(fn, reps: int = 20, tries: int = 4) -> float:
    """Device time (ms) of one call of fn(), on CUDA events and without the
    host's launch time: a spin kernel (torch.cuda._sleep) holds the stream
    while the host queues `reps` calls behind it, and the events between
    the spin's end and the last call time the device's own work, back to
    back (the gaps between queued operations included). Valid only if the
    host queued every call before the spin ended: the host time from just
    before the spin was queued to the last event must be shorter than the
    spin's own device time. A run where it was not is repeated with a spin
    twice as long; fn that waits on the device never gets ahead and fails.
    (torch.profiler is not used here: on the H100 its sessions have dropped
    device records, a different number in different runs.)"""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    spin_cycles_per_ms()
    spin_target_ms = 2 * host_ms + 2.0
    missed = []
    for _ in range(tries):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in "abc")
        t0 = time.perf_counter()
        e0.record()
        torch.cuda._sleep(int(spin_target_ms * _spin_cycles_per_ms))
        e1.record()
        for _ in range(reps):
            fn()
        e2.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        e2.synchronize()
        spin_ms = e0.elapsed_time(e1)
        if queued_ms < spin_ms:
            return e1.elapsed_time(e2) / reps
        missed.append((round(queued_ms, 3), round(spin_ms, 3)))
        spin_target_ms *= 2
    raise AssertionError(f"device_ms: the host never queued {reps} calls "
                         f"ahead of the device (host ms, spin ms: {missed})")


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
    the stream (CUDA events, launch included); plain_ms: the plain
    version's call, the same way (K1a's plain version makes the host wait
    on the device, so device_ms cannot isolate a plain version's device
    time)."""
    row = dict(ms=device_ms(fn), call_ms=cuda_ms(fn), plain_ms=cuda_ms(plain))
    row["bound_ms"], row["bound_by"] = bound(bytes_, ops)
    log(f"{label}: exact; kernel {row['ms']:.4f} ms on the device "
        f"({row['call_ms']:.4f} ms a call), plain {row['plain_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
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


def pose_lm_work(args, rounds: int = 4, iters: int = 10
                 ) -> tuple[int, int]:
    """(bytes, operations) of one pose LM launch on its arguments: each
    row's inputs read once (X, obs, information, the stereo and valid
    flags: 30 bytes) and its inlier flag written, a problem's pose in and
    out and its count; about 300 operations a row in each of the
    1 + rounds x (iters + 1) passes (residual, Huber weight, Jacobian and
    the 27 sums of H, b and the cost)."""
    T0, X = args[1], args[2]
    S = T0.shape[0] if T0.dim() == 3 else 1
    rows = S * X.shape[-2]
    return rows * 31 + S * (64 + 64 + 4), rows * 300 * (1 + rounds * (iters + 1))


def _pose_gaps(Ta, Tb) -> tuple[float, float]:
    """(translation m, rotation rad) between two (4, 4) float64 poses."""
    W = Ta[:3, :3].T @ Tb[:3, :3]
    return (float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])),
            float(0.5 * np.linalg.norm([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0],
                                        W[1, 0] - W[0, 1]])))


def _near_threshold(cam, T, X, obs, info, stereo) -> np.ndarray:
    """Rows whose chi2 at pose T (float64 on the host) lies within
    POSE_LM_NEAR of their threshold."""
    from lldslam_tpu_torch.optim import residuals as res
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
    r = obs - np.stack([u, cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy,
                        u - cam.bf / Xc[:, 2]], -1)
    chi2 = info * (r[:, 0] ** 2 + r[:, 1] ** 2 + stereo * r[:, 2] ** 2)
    th = np.where(stereo, res.CHI2_STEREO, res.CHI2_MONO)
    return np.abs(chi2 - th) <= POSE_LM_NEAR * th


def hold_pose_lm(label: str, kept, timed: bool = False,
                 gamma: float = 0.5) -> dict:
    """The pose LM kernel (`ops.pose_lm.pose_lm`) on kept (site, args)
    calls against `optimize_pose_plain` on the same card tensors: for each
    problem (each s of a batched call) the poses within POSE_LM_TOL, the
    inlier masks equal but for rows near their threshold at the plain pose,
    the counts apart by at most those rows and equal to the mask's; in a
    call of S > 1 problems each problem bit-equal to its own S = 1 launch.
    A call with line rows (the line step's joint LM, site "line") runs the
    line step's schedule at `gamma`, its line inliers held the same way.
    `timed`: the last call's kernel device ms, the plain LM's ms a call
    (CUDA events: its 6,000 launches overflow the launch queue that
    device_ms needs) and the bound."""
    from lldslam_tpu_torch.ops import pose_lm
    from lldslam_tpu_torch.optim import pose_opt
    from lldslam_tpu_torch.optim.pose_opt import (LinePoseObs, PointPoseObs,
                                                  optimize_pose_plain)
    from lldslam_tpu_torch.pipeline.tracker import (LINE_LM_ITERS,
                                                    LINE_LM_ROUNDS)
    if not kept:
        raise AssertionError(f"{label}: no pose LM call kept")
    host = lambda t: t.double().cpu().numpy()
    gap_t = gap_r = 0.0
    problems = apart = near_rows = line_calls = 0
    for _, args in kept:
        cam, T0, rows, lrows = args[0], args[1], args[2:7], args[7:]
        kw = dict(rounds=LINE_LM_ROUNDS, iters=LINE_LM_ITERS,
                  gamma=gamma) if lrows else {}
        got = pose_lm.pose_lm(*args, **kw)
        want = optimize_pose_plain(
            cam, T0, PointPoseObs(*rows),
            LinePoseObs(*lrows) if lrows else None, **kw)
        b = (lambda t: t) if T0.dim() == 3 else (lambda t: t[None])
        Tg, Tw = host(b(got[0])), host(b(want[0]))
        ig, iw = b(got[1]).cpu().numpy(), b(want[1]).cpu().numpy()
        ng, nw = b(got[2]).cpu().numpy(), b(want[3]).cpu().numpy()
        X, obs, info = (host(b(t)) for t in rows[:3])
        st = b(rows[3]).cpu().numpy()
        S = Tg.shape[0]
        for s in range(S):
            dt, da = _pose_gaps(Tg[s], Tw[s])
            near = _near_threshold(cam, Tw[s], X[s], obs[s], info[s], st[s])
            off = int(((ig[s] != iw[s]) & ~near).sum())
            l_apart = l_near = 0
            if lrows:
                # the line rows' reclassification sum at the plain pose
                lo = LinePoseObs(*(t.double() if t.is_floating_point() else t
                                   for t in lrows))
                _, _, _, c2, th = pose_opt._line_terms(
                    cam, want[0].double(), lo, lo.valid.double(), gamma,
                    need_system=False)
                l_near_m = ((c2 - 2 * th).abs() <= POSE_LM_NEAR * 2 * th
                            ).cpu().numpy()
                l_diff = (got[3] != want[2]).cpu().numpy()
                l_apart, l_near = int(l_diff.sum()), int(l_near_m.sum())
                off += int((l_diff & ~l_near_m).sum())
                line_calls += 1
            if (dt > POSE_LM_TOL[0] or da > POSE_LM_TOL[1] or off
                    or abs(int(ng[s]) - int(nw[s])) > int(near.sum())
                    or int(ng[s]) != int(ig[s].sum())):
                raise AssertionError(
                    f"{label}: pose LM problem {s} of {S} off the plain LM: "
                    f"{dt} m, {da} rad, {off} inlier rows apart off the "
                    f"threshold band, inliers {int(ng[s])} / {int(nw[s])}")
            if S > 1:
                one = pose_lm.pose_lm(cam, *(t[s:s + 1] for t in args[1:]))
                if not all(torch.equal(x[s], y[0]) for x, y in zip(got, one)):
                    raise AssertionError(f"{label}: pose LM problem {s} of "
                                         f"{S} differs from its S = 1 launch")
            gap_t, gap_r = max(gap_t, dt), max(gap_r, da)
            apart += int((ig[s] != iw[s]).sum()) + l_apart
            near_rows += int(near.sum()) + l_near
            problems += 1
    out = dict(calls=len(kept), problems=problems,
               rows=int(kept[-1][1][2].shape[-2]), line_calls=line_calls,
               max_translation_gap_m=gap_t, max_rotation_gap_rad=gap_r,
               inlier_rows_apart=apart, near_threshold_rows=near_rows)
    msg = (f"{label}: pose LM kernel on {len(kept)} calls ({problems} "
           f"problems of {out['rows']} point rows, {line_calls} with line "
           f"rows) against the plain LM: poses "
           f"within {gap_t:.3e} m and {gap_r:.3e} rad, {apart} inlier rows "
           f"apart, all within {POSE_LM_NEAR:.0%} of their threshold "
           f"({near_rows} such rows)")
    if timed:
        args = kept[-1][1]
        obs_ = PointPoseObs(*args[2:7])
        out["ms"] = device_ms(lambda: pose_lm.pose_lm(*args))
        out["call_ms"] = cuda_ms(lambda: pose_lm.pose_lm(*args))
        out["plain_ms"] = cuda_ms(
            lambda: optimize_pose_plain(args[0], args[1], obs_), reps=5,
            warm=1)
        out["bound_ms"], out["bound_by"] = bound(*pose_lm_work(args))
        msg += (f"; kernel {out['ms']:.4f} ms on the device "
                f"({out['call_ms']:.4f} ms a call), plain "
                f"{out['plain_ms']:.2f} ms, bound {out['bound_ms']:.4f} ms "
                f"({out['bound_by']}; the latency of the dependent passes "
                f"bounds it), {100 * out['bound_ms'] / out['ms']:.1f}% of "
                f"bound")
    log(msg)
    return out


def phase_pose_lm(dev) -> dict:
    """The pose LM kernel against the plain LM at the tracking step's
    capacity (io.kernel_inputs.pose_lm_inputs, N = 2048, 4 x 10): one mix
    problem a launch, and mix, few, none, mix in one launch."""
    from lldslam_tpu_torch.geometry.camera import StereoCamera
    from lldslam_tpu_torch.io import kernel_inputs as ki
    cam = StereoCamera(**ki.KITTI_CAM, width=KITTI_W, height=KITTI_H)
    rng = np.random.default_rng(2)
    by_s = {}
    for kinds in (("mix",), ("mix", "few", "none", "mix")):
        T0, obs = ki.pose_lm_inputs(rng, dev, kinds)
        by_s[f"S{len(kinds)}"] = hold_pose_lm(
            f"pose LM S={len(kinds)} ({', '.join(kinds)})",
            [("track", (cam, T0, *obs))], timed=True)
    out = dict(by_s["S1"])
    out["by_S"] = by_s
    return out


def reset_counts() -> None:
    from lldslam_tpu_torch.ops import (match_best2, orb_describe, pose_lm,
                                       segment_sum, stereo_sad)
    orb_describe.launches = 0
    stereo_sad.launches = 0
    match_best2.launches = 0
    match_best2.launches_by_site = {}
    segment_sum.launches = 0
    pose_lm.launches = 0
    pose_lm.launches_by_site = {}


def read_counts() -> dict:
    from lldslam_tpu_torch.ops import (match_best2, orb_describe, pose_lm,
                                       segment_sum, stereo_sad)
    return dict(k1a=orb_describe.launches, k1b=stereo_sad.launches,
                k2g=match_best2.launches,
                k2g_sites=dict(match_best2.launches_by_site),
                segsum=segment_sum.launches, lm=pose_lm.launches,
                lm_sites=dict(pose_lm.launches_by_site))


def need_lm_launches(counts: dict, cores: int, label: str) -> None:
    """The pose LM kernel launched twice for each of the `cores` calls of
    `_track_core` (a batched call counts once), all at the track site."""
    track = counts["lm_sites"].get("track", 0)
    if cores <= 0 or track != 2 * cores:
        raise AssertionError(f"{label}: {track} pose LM launches at the "
                             f"track site for {cores} tracking steps")
    log(f"{label}: pose LM launches {counts['lm']} by site "
        f"{counts['lm_sites']} ({cores} tracking steps)")


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


def tum_config():
    """The TUM fr1 camera of ORB-SLAM2's TUM1.yaml (640x480, Camera.bf
    40.0), 1000 features, 8 levels x 1.2."""
    from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu_torch.ops.orb import OrbConfig
    cam_cfg = CameraConfig(fx=517.306408, fy=516.469215, cx=318.643040,
                           cy=255.313989, bf=40.0, fps=30.0, width=640,
                           height=480)
    return SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=1000),
                      tracking=TrackingConfig(min_init_points=100))


def track(sys_, frames, t0: float = 0.0, label: str = "", mode="stereo"):
    """Frames through System.track_stereo ((left, right) each),
    track_monocular (an image each) or track_rgbd ((image, depth) each),
    each synchronised; returns (per-frame ms, metrics)."""
    feed = dict(stereo=lambda f, ts: sys_.track_stereo(*f, timestamp=ts),
                mono=lambda f, ts: sys_.track_monocular(f, timestamp=ts),
                rgbd=lambda f, ts: sys_.track_rgbd(*f, timestamp=ts))[mode]
    ms, out = [], []
    for i, f in enumerate(frames):
        t = time.perf_counter()
        _, m = feed(f, t0 + i * 0.1)
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
    of its calls (those at one of `sites`, where given; the last one at
    each site only, where `last_only`) is kept as (site, args); returns
    (kept, restore)."""
    kernel, kept = getattr(mod, name), []

    def wrapper(*args, **kw):
        if sites is None or kw.get("site") in sites:
            if last_only:   # the last call at each site
                kept[:] = [k for k in kept if k[0] != kw.get("site")]
            kept.append((kw.get("site"), tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)))
        return kernel(*args, **kw)

    setattr(mod, name, wrapper)
    return kept, lambda: setattr(mod, name, kernel)


def frame_kernels(label: str, kept_k1a, kept_k1b=None) -> dict:
    """K1a (and K1b, where kept) on the last frame's own inputs: exact
    against the plain version, device ms and the bound of the distinct
    pixels their taps touch."""
    from lldslam_tpu_torch.ops import orb_describe, stereo_sad
    out = {}
    for key, fn, plain, kept, work in (
            ("k1a", orb_describe.describe, orb_describe.describe_plain,
             kept_k1a, lambda d: k1a_work(d, orb_describe.describe(*d)[0])),
            ("k1b", stereo_sad.sad_refine, stereo_sad.sad_refine_plain,
             kept_k1b, k1b_work)):
        if kept is None:
            continue
        args = kept[-1][1]
        if args[0].dim() == 4:
            # a stereo frame goes through the batched build as S = 1
            args = tuple(a[0] if torch.is_tensor(a) else a for a in args)
        err = _exact(f"{label}, last frame's {key}", fn(*args), plain(*args))
        n_bytes, n_ops, px, taps = work(args)
        ms = device_ms(lambda: fn(*args))
        b_ms, by = bound(n_bytes, n_ops)
        out[key] = dict(n=args[2].shape[0], images=args[0].shape[0], ms=ms,
                        bound_ms=b_ms, bound_by=by, distinct_pixels=px,
                        taps=taps, max_abs_err=err)
        log(f"{label}, last frame's own inputs: {key} n={args[2].shape[0]} "
            f"over {args[0].shape[0]} images: exact; {px} distinct pixels for "
            f"{taps} taps; kernel {ms:.4f} ms on the device, bound "
            f"{b_ms:.4f} ms ({by}), {100 * b_ms / ms:.1f}% of bound")
    return out


def gate_density(kept) -> dict:
    """Per site: the rows M, columns N and gated pairs (the pairs the gates
    pass) of each K2g call, from the kept arguments, and the median share
    of gated pairs among the M x N."""
    from lldslam_tpu_torch.ops import match_best2 as mb
    out = {}
    for site, g in kept:
        o = out.setdefault(site, dict(M=[], N=[], pairs=[]))
        o["M"].append(g[0].shape[-2])      # rows of one sequence (S = 1)
        o["N"].append(g[7].shape[-2])
        o["pairs"].append(int(mb.gate_mask(*g[1:7], *g[8:]).sum()))
    for o in out.values():
        o["median_share"] = statistics.median(
            p / (m * n) for p, m, n in zip(o["pairs"], o["M"], o["N"]))
    return out


def main_sequence():
    """The main path's 30 seed-3 KITTI-size stereo frames and their T_cw."""
    from lldslam_tpu_torch.io.synthetic import make_sequence
    t0 = time.perf_counter()
    frames, poses, _ = make_sequence(kitti_config().camera.stereo_camera(),
                                     N_FRAMES, seed=3, return_poses=True)
    log(f"main path: generated {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    return frames, poses


def phase_main_path(dev, frames, poses) -> dict:
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.system import System

    cfg = kitti_config()
    sys_ = System(cfg, device=dev)
    t0 = time.perf_counter()
    sys_.warmup()
    log(f"main path: System.warmup {1e3 * (time.perf_counter() - t0):.1f} ms")
    tr = sys_.tracker
    if tr.vocabulary is None or tr.vocabulary.n_words != SHIPPED_WORDS:
        raise AssertionError("the shipped vocabulary was not loaded")
    from lldslam_tpu_torch.ops import (match_best2, orb_describe, pose_lm,
                                       stereo_sad)
    kept_g, restore_g = keep_inputs(match_best2, "gated_best2",
                                    sites=("tracking", "fusion"))
    kept_a, restore_a = keep_inputs(orb_describe, "describe", last_only=True)
    kept_b, restore_b = keep_inputs(stereo_sad, "sad_refine", last_only=True)
    kept_lm, restore_lm = keep_inputs(pose_lm, "pose_lm", sites=("track",))
    # the tracking step's read-back: the host's wait for the device and
    # the one copy, what the pipelined schedule takes off the frame
    from lldslam_tpu_torch.pipeline import tracker as tmod
    rb_ms, cores = [], [0]
    restore_rb = timed_calls(tmod, "_read_back", rb_ms)
    restore_core = count_calls(tmod, "_track_core", cores)
    try:
        reset_counts()
        ms, metrics = track(sys_, frames, label="main path")
        counts = read_counts()
    finally:
        restore_g(), restore_a(), restore_b(), restore_rb()
        restore_lm(), restore_core()
    frame_k = frame_kernels("main path", kept_a, kept_b)
    need_lm_launches(counts, cores[0], "main path")
    lm = hold_pose_lm("main path, last frame's", kept_lm[-2:], timed=True)
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
    log(f"main path: the tracking step's read-back (host wait and copy) ms "
        f"median {statistics.median(rb_ms):.2f} p90 "
        f"{float(np.percentile(rb_ms, 90)):.2f} over {len(rb_ms)} calls")
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
    return dict(counts, frame_kernels=frame_k, k2g_gated_pairs=gates,
                pose_lm=lm, kf_frames=kf_frames, T_wc=T_wc, ms=ms,
                read_back_ms=rb_ms)


def timed_calls(mod, name: str, times: list, keep: list | None = None):
    """Wraps mod.<name> so that each call's host milliseconds, the device
    finished (torch.cuda.synchronize), go to `times`, and, where `keep` is
    given, the last call's arguments to it; returns the restore function."""
    fn = getattr(mod, name)

    def wrapper(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        if keep is not None:
            keep[:] = [args, kw]
        return out

    setattr(mod, name, wrapper)
    return lambda: setattr(mod, name, fn)


def stereo_lines_on_cpu(args, kw) -> dict:
    """The stereo line match of the lines run's last frame, on the card
    again and on CPU copies of its inputs: flipped matches (a descriptor
    distance at the mdThr gate may round differently in cuBLAS), the
    largest difference of the matched lines, and the host syncs one call
    makes (sync debug mode "warn")."""
    from lldslam_tpu_torch.frontend import line_match
    cam, kl, kr = args
    card = line_match.match_stereo_lines(cam, kl, kr, **kw)
    cpu = line_match.match_stereo_lines(
        cam, type(kl)(*(x.cpu() for x in kl)),
        type(kr)(*(x.cpu() for x in kr)), **kw)
    syncs = host_syncs(lambda: line_match.match_stereo_lines(cam, kl, kr,
                                                             **kw))
    both = card.has_stereo.cpu() & cpu.has_stereo
    sign = torch.where((card.d.cpu() * cpu.d).sum(-1, keepdim=True) < 0,
                       -1.0, 1.0)
    out = dict(
        flips=int((card.r_idx.cpu() != cpu.r_idx).sum()),
        matched=int(cpu.has_stereo.sum()),
        max_x0_diff=float((card.X0.cpu() - cpu.X0)[both].abs().max()),
        max_d_diff=float((sign * card.d.cpu() - cpu.d)[both].abs().max()),
        syncs=syncs,
        ms=cuda_ms(lambda: line_match.match_stereo_lines(cam, kl, kr, **kw)))
    log(f"lines: stereo match of the last frame on the card against the CPU: "
        f"{out['flips']} of {kl.p1.shape[0]} matches differ ({out['matched']} "
        f"matched on the CPU), matched lines within {out['max_x0_diff']:.2e} m "
        f"(X0) and {out['max_d_diff']:.2e} (+-d); {out['syncs']} host syncs "
        f"per call; {out['ms']:.3f} ms a call")
    return out


def host_syncs(fn) -> int:
    """Host syncs one call of fn() makes (sync debug mode "warn")."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def eigh_against_power(dev) -> dict:
    """The stereo line fit's top eigenvector two ways on 256 seeded 3x3
    covariances of 8 collinear samples each (the matcher's shape): the JAX
    package's route `torch.linalg.eigh` and the port's power iteration
    (`line_match._top_eigvec`): host syncs per call, ms a call (CUDA
    events) and the largest difference of the vectors up to sign."""
    from lldslam_tpu_torch.frontend.line_match import _top_eigvec
    g = torch.Generator(device="cpu").manual_seed(0)
    d = torch.nn.functional.normalize(torch.randn(256, 3, generator=g), dim=-1)
    t = torch.linspace(0.0, 2.0, 8)[None, :, None]
    X = (torch.randn(256, 1, 3, generator=g) + t * d[:, None, :]
         + 1e-3 * torch.randn(256, 8, 3, generator=g)).to(dev)
    Xc = X - X.mean(1, keepdim=True)
    cov = torch.einsum("lsi,lsj->lij", Xc, Xc) / 8
    chord = X[:, -1] - X[:, 0]
    e = torch.linalg.eigh(cov)[1][..., -1]
    p = _top_eigvec(cov, chord)
    sign = torch.where((e * p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    out = dict(eigh_syncs=host_syncs(lambda: torch.linalg.eigh(cov)),
               power_syncs=host_syncs(lambda: _top_eigvec(cov, chord)),
               eigh_ms=cuda_ms(lambda: torch.linalg.eigh(cov)),
               power_ms=cuda_ms(lambda: _top_eigvec(cov, chord)),
               max_diff=float((sign * p - e).abs().max()))
    log(f"lines: stereo line fit, 256 3x3: eigh {out['eigh_syncs']} host "
        f"syncs, {out['eigh_ms']:.4f} ms; power iteration "
        f"{out['power_syncs']} syncs, {out['power_ms']:.4f} ms; vectors "
        f"within {out['max_diff']:.2e}")
    return out


def jacobians_against_jacfwd(dev, cam) -> dict:
    """The line Jacobians the line step and the joint BA use, written out
    (`residuals.line_pose_jacobian`, `residuals.line_jacobians`), against
    forward-mode differentiation of the same residuals (`torch.func.jacfwd`,
    the JAX package's route) on seeded lines at the line step's shape (256
    lines) and the joint local BA's grid (24 keyframes x 512 lines): the
    largest difference relative to the largest entry, and ms a call."""
    from lldslam_tpu_torch.geometry import lines as gl, se3
    from lldslam_tpu_torch.optim import residuals as res
    g = torch.Generator(device="cpu").manual_seed(1)
    out = {}
    for label, n in (("line_step", 256), ("joint_ba", 24 * 512)):
        r = lambda *s: torch.randn(*s, generator=g)
        T = se3.exp(0.1 * r(n, 6)).to(dev)
        X0, d = gl.closest_point_form(3.0 * r(n, 3) + torch.tensor(
            [0.0, 0.0, 12.0]), r(n, 3))
        q, a = (x.to(dev) for x in gl.minimal_from_x0dir(X0, d))
        x1 = (300.0 + 100.0 * r(n, 2)).to(dev)
        x2 = x1 + 40.0

        def fwd():
            def f(ep, el):
                q2 = res._quat_mul(res._quat_increment(el[..., :3]), q)
                Tr = gl.right_camera_pose(se3.exp(ep) @ T, cam.baseline)
                return res.line_residual(cam, Tr, q2, a + el[..., 3], x1, x2)
            z6 = torch.zeros(1, 6, device=dev)
            z4 = torch.zeros(1, 4, device=dev)
            return (torch.func.jacfwd(lambda e: f(e, z4))(z6)[..., 0, :],
                    torch.func.jacfwd(lambda e: f(z6, e))(z4)[..., 0, :])

        an = lambda: res.line_jacobians(cam, T, q, a, x1, x2,
                                        baseline=cam.baseline)
        err = max(float((x - y).abs().max() / y.abs().max())
                  for x, y in zip(an(), fwd()))
        out[label] = dict(n=n, rel_err=err, analytic_ms=cuda_ms(an),
                          jacfwd_ms=cuda_ms(fwd))
        log(f"lines: line Jacobians (pose and line, right camera), {n} "
            f"observations: analytic {out[label]['analytic_ms']:.3f} ms, "
            f"torch.func.jacfwd {out[label]['jacfwd_ms']:.3f} ms a call; "
            f"largest difference {err:.2e} of the largest entry")
    return out


def run_lines(dev, cfg, frames, poses, world, label: str) -> dict:
    """Stored detections of the frames' world written to a temporary
    directory, then the frames through System(cfg with lines) on `dev`:
    kernel launches (counts zeroed just before, read just after), per-frame
    ms, the line step's, the stereo matcher's and the joint local BA's ms
    (found by wrapping the functions), line matches, map lines, capacity
    events, ATE; then the loop closer's global BA once on the final map."""
    import dataclasses
    import tempfile
    from lldslam_tpu_torch.config import LineConfig
    from lldslam_tpu_torch.frontend import line_match
    from lldslam_tpu_torch.io.synthetic import gen_stored_lines
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.pipeline import mapper_fast, tracker as tmod
    from lldslam_tpu_torch.system import System

    cam = cfg.camera.stereo_camera()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lines_")
    t0 = time.perf_counter()
    per_frame = gen_stored_lines(cam, poses, world, f"{tmp}/left",
                                 f"{tmp}/right")
    log(f"{label}: wrote stored detections in "
        f"{time.perf_counter() - t0:.1f} s, {statistics.median(per_frame)} "
        f"per frame median ({min(per_frame)}-{max(per_frame)})")
    # the stored-line route as the JAX bench's lines section sets it
    # (bench.py:554-558)
    sys_ = System(dataclasses.replace(cfg, line=LineConfig(
        ld_type="LBDFloat", md_thr=0.6, detections_path=f"{tmp}/left",
        descriptors_path=f"{tmp}/right")), device=dev)
    sys_.warmup()
    tr = sys_.tracker
    step_ms, stereo_ms, jba_ms, last_stereo = [], [], [], []
    restore = [timed_calls(tmod, "_line_step", step_ms),
               timed_calls(line_match, "match_stereo_lines", stereo_ms,
                           keep=last_stereo),
               timed_calls(mapper_fast, "joint_ba_view_cached", jba_ms)]
    try:
        reset_counts()
        ms, metrics = track(sys_, frames, label=label)
        counts = read_counts()
    finally:
        for r in restore:
            r()
    states = [m.state for m in metrics]
    kf_frames = [m.frame_id for m in metrics if m.new_kf]
    _, T_wc = tr.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    lm = [m.n_line_matches for m in metrics]
    src = tr._line_source
    s = tr.store
    out = dict(
        counts=counts, states=states, kf_frames=kf_frames, T_wc=T_wc,
        detections=(f"{tmp}/left", f"{tmp}/right"),
        ate=ate_rmse(T_wc, gt), ms=ms, step_ms=step_ms, stereo_ms=stereo_ms,
        jba_ms=jba_ms, line_matches=lm, n_lines=int(s.ln_valid.sum()),
        n_lines_created=int(s.n_ln),
        cap=(src[0].cap_events + src[1].cap_events,
             src[0].cap_dropped + src[1].cap_dropped),
        line_kf_ms={k: (v if k == "n" else 1e3 * v)
                    for k, v in tr.line_kf_times.items()},
        dropped={k: tr.mapper.stage_times.get(k, 0)
                 for k in ("ln_obs_dropped", "line_view_dropped")},
        events=len(tr.loop_closer.events), stereo=stereo_lines_on_cpu(
            *last_stereo))
    steady = ms[1:]
    log(f"{label}: keyframes at {kf_frames}; ATE {out['ate']:.5f} m; "
        f"launches {counts}")
    log(f"{label}: line matches per frame {lm}; median (frames 1-) "
        f"{statistics.median(lm[1:])}; valid map lines {out['n_lines']} of "
        f"{out['n_lines_created']} created; cap events / lines dropped "
        f"{out['cap']}; {out['dropped']}")
    log(f"{label}: ms/frame median {statistics.median(steady):.1f} p90 "
        f"{float(np.percentile(steady, 90)):.1f} (first frame {ms[0]:.1f}); "
        f"line step ms median {statistics.median(step_ms):.2f} (max "
        f"{max(step_ms):.2f}); stereo line match ms median "
        f"{statistics.median(stereo_ms):.2f}; joint local BA ms per keyframe "
        f"{[round(x, 1) for x in jba_ms]}; keyframe line stages ms "
        + json.dumps({k: round(v, 2) for k, v in out["line_kf_ms"].items()}))

    # the joint global BA once on the final map
    lc = tr.loop_closer
    if lc._gather_line_problem() is None:
        raise AssertionError(f"{label}: no map line has >= 4 observations")
    poses_before = s.kf_pose[:s.n_kf].copy()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lc.global_ba()
    torch.cuda.synchronize()
    gba_ms = 1e3 * (time.perf_counter() - t)
    c0 = np.einsum("kji,kj->ki", poses_before[:, :3, :3], poses_before[:, :3, 3])
    K = s.n_kf
    c1 = np.einsum("kji,kj->ki", s.kf_pose[:K, :3, :3], s.kf_pose[:K, :3, 3])
    moved = float(np.linalg.norm(c1 - c0, axis=-1).max())
    live = s.ln_valid[:s.n_ln]
    finite = bool(np.isfinite(s.ln_x0[:s.n_ln][live]).all()
                  and np.isfinite(s.ln_dir[:s.n_ln][live]).all())
    out.update(global_ba_ms=gba_ms, global_ba_centre_moved=moved,
               global_ba_lines_finite=finite)
    log(f"{label}: joint global BA (10 LM x 64 CG) {gba_ms:.1f} ms over {K} "
        f"keyframes and {int(live.sum())} lines; camera centres moved "
        f"{moved:.4f} m at most; line states finite: {finite}")
    return out


def lines_sequence():
    """The lines world's 30 seed-2 KITTI-size frames, their T_cw and the
    world's dimensions."""
    from lldslam_tpu_torch.io.synthetic import make_sequence
    return make_sequence(kitti_config().camera.stereo_camera(), N_FRAMES,
                         seed=2, with_lines=True, return_poses=True)


def phase_lines(dev, frames, poses, world) -> dict:
    """The stored-line world of the JAX bench's lines section (bench.py
    `_bench_lines`): 30 seed-2 frames with lines painted on the walls, KITTI
    size, 2000 features, loops on; then the same frames with lines off."""
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.system import System

    cfg = kitti_config()
    out = run_lines(dev, cfg, frames, poses, world, "lines")
    out["line_fit"] = eigh_against_power(dev)
    out["jacobians"] = jacobians_against_jacfwd(dev, cfg.camera.stereo_camera())
    off = System(cfg, device=dev)
    ms_off, m_off = track(off, frames, label="lines off")
    _, T_off = off.tracker.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    out.update(ate_off=ate_rmse(T_off, gt), ms_off=ms_off,
               states_off=[m.state for m in m_off],
               kf_frames_off=[m.frame_id for m in m_off if m.new_kf])
    log(f"lines: ATE lines on {out['ate']:.5f} m, off {out['ate_off']:.5f} m "
        f"(JAX-CPU run {LINES_JAX['ate_on']} / {LINES_JAX['ate_off']} m); "
        f"lines off: keyframes {out['kf_frames_off']}, ms/frame median "
        f"{statistics.median(ms_off[1:]):.1f}")
    lm = statistics.median(out["line_matches"][1:])
    checks = [
        (all(x == "OK" for x in out["states"]), f"states {out['states']}"),
        (len(out["kf_frames"]) >= 5, f"keyframes {out['kf_frames']}"),
        (out["ate"] <= ATE_BOUND_M, f"ATE {out['ate']} m"),
        (LINE_MATCH_RANGE[0] <= lm <= LINE_MATCH_RANGE[1],
         f"line matches median {lm}"),
        (LINE_MAP_RANGE[0] <= out["n_lines"] <= LINE_MAP_RANGE[1],
         f"valid map lines {out['n_lines']}"),
        (out["cap"] == LINES_JAX["cap"], f"cap events {out['cap']}"),
        (out["global_ba_lines_finite"], "non-finite line after global BA"),
        (out["global_ba_centre_moved"] < 0.05,
         f"global BA moved a camera {out['global_ba_centre_moved']} m"),
        (all(x == "OK" for x in out["states_off"]),
         f"lines off: states {out['states_off']}"),
        (out["ate_off"] <= ATE_BOUND_M, f"lines off: ATE {out['ate_off']} m"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("lines: " + "; ".join(bad))
    need_launches(out["counts"], "lines", ("tracking", "fusion"))
    return out


def _kitti_rows(path) -> np.ndarray:
    """(N, 4, 4) T_wc of a KITTI trajectory file."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3] = rows
    return T


def cli_run(args, out_dir, device=None) -> dict:
    """`cli.main` on `args` (dataset, settings, sequence) with its default
    device unless `device` is given: the trajectory (T_wc) and the
    per-frame metrics it wrote."""
    from lldslam_tpu_torch import cli
    out, met = f"{out_dir}/traj.txt", f"{out_dir}/metrics.jsonl"
    extra = [] if device is None else ["--device", device]
    if cli.main([*args, "--out", out, "--metrics", met, *extra]) != 0:
        raise AssertionError(f"cli {args} returned nonzero")
    with open(met) as f:
        ms = [json.loads(x) for x in f]
    return dict(T=_kitti_rows(out), metrics=ms,
                kfs=[m["frame_id"] for m in ms if m["new_kf"]],
                states=[m["state"] for m in ms],
                line_matches=[m["n_line_matches"] for m in ms])


def mini_kitti_runs(dev) -> dict:
    """The CLI on mini KITTI on the card, with the shipped settings (stored
    lines) and with a copy that lacks the detection paths (the native
    detector), each held to tests/test_cli_e2e.py's bounds and to the same
    command on the CPU (keyframes equal, camera centres within 0.05 m);
    kernel launches of the two card runs."""
    import os
    import tempfile
    from lldslam_tpu_torch.io.trajectory import ate_rmse

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mini_")
    native = f"{tmp}/native.yaml"
    with open(f"{MINI_KITTI}/settings.yaml") as f:
        keep = [ln for ln in f if not ln.startswith(("lineDetectionsPath",
                                                      "lineDescriptorsPath"))]
    with open(native, "w") as f:
        f.writelines(keep)
    gt = _kitti_rows(f"{MINI_KITTI}/gt.txt")
    out, bad = dict(counts=dict(k1a=0, k1b=0, k2g=0, k2g_sites={},
                                segsum=0, lm=0, lm_sites={})), []
    reset_counts()
    for label, settings in (("stored", f"{MINI_KITTI}/settings.yaml"),
                            ("native", native)):
        os.makedirs(f"{tmp}/{label}/card")
        os.makedirs(f"{tmp}/{label}/cpu")
        t = time.perf_counter()
        card = cli_run(["kitti", settings, MINI_KITTI], f"{tmp}/{label}/card")
        card_s = time.perf_counter() - t
        counts = read_counts()
        cpu = cli_run(["kitti", settings, MINI_KITTI], f"{tmp}/{label}/cpu",
                      device="cpu")
        reset_counts()
        total = out["counts"]
        for k in ("k1a", "k1b", "k2g", "segsum", "lm"):
            total[k] += counts[k]
        for key in ("k2g_sites", "lm_sites"):
            for site, c in counts[key].items():
                total[key][site] = total[key].get(site, 0) + c
        ate = ate_rmse(card["T"], gt, align=False)
        dc = float(np.linalg.norm(card["T"][:, :3, 3] - cpu["T"][:, :3, 3],
                                  axis=-1).max())
        out[label] = dict(ate=ate, kfs=card["kfs"], cpu_kfs=cpu["kfs"],
                          centre_diff=dc, line_matches=card["line_matches"],
                          cpu_line_matches=cpu["line_matches"], s=card_s)
        log(f"native_lines: mini KITTI CLI on the card, {label} lines: "
            f"{card['states']}; keyframes {card['kfs']} (CPU {cpu['kfs']}); "
            f"line matches {card['line_matches']} (CPU "
            f"{cpu['line_matches']}); unaligned ATE {ate:.4f} m; centres "
            f"within {dc:.5f} m of the CPU run; {card_s:.1f} s")
        checks = [
            (card["T"].shape == (10, 4, 4) and np.isfinite(card["T"]).all(),
             "10 finite rows"),
            (ate < MINI_ATE_BOUND_M, f"ATE {ate}"),
            (card["states"][-1] == "OK", f"states {card['states']}"),
            (any(x > 0 for x in card["line_matches"]), "no line match"),
            (card["kfs"] == cpu["kfs"], "keyframes against the CPU"),
            (dc < MINI_CENTRE_BOUND_M, f"centres {dc} m from the CPU run")]
        bad += [f"{label}: {msg}" for ok, msg in checks if not ok]
    if "PIL" in sys.modules:
        bad.append("PIL was imported")
    if bad:
        raise AssertionError("native_lines, mini KITTI: " + "; ".join(bad))
    return out


def detector_work(H: int, W: int, L: int, chunk: int) -> dict:
    """What the native detector must do on one (H, W) uint8 view with L peak
    slots, and what its eager support pass moves. Least bytes: the image
    read once, each slot's outputs (p1, p2, octave, length, 40-float
    descriptor, valid) written once. Operations: per pixel the Sobel (12),
    the magnitude (5), the orientation, its bin and rho (about 40 with
    atan2, cos and sin); per (slot, pixel) the support test (band distance
    3, orientation gap 4, 3 comparisons, 2 ands: 12) and, in the refit,
    the weighted sums (2 each for the weight, x, y and the three
    covariance terms, 3 for the centred coordinates, 4 for the span: 19).
    A fused support pass would read phi, the magnitude and the edge mask
    (9 bytes a pixel) once per chunk of peaks; the eager one reads or
    writes about 61 float (chunk, H*W) arrays per chunk (19 in the support
    test, 31 in the weighted sums, 11 in the span), 244 bytes per pixel and
    slot."""
    px = H * W
    n_bytes = px + L * (4 * 4 + 4 + 4 + 40 * 4 + 1)
    n_ops = px * 57 + L * px * (12 + 19)
    b_ms, by = bound(n_bytes, n_ops)
    chunks = -(-L // chunk)
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=b_ms, bound_by=by,
                fused_bytes=9 * px * chunks,
                fused_ms=1e3 * 9 * px * chunks / HBM_BYTES_PER_S,
                eager_bytes=244 * px * chunks * chunk,
                eager_ms=1e3 * 244 * px * chunks * chunk / HBM_BYTES_PER_S)


def detector_alone(dev, img: np.ndarray, seq) -> dict:
    """The native detector on one KITTI view: two card calls bit-identical;
    the card against the CPU (valid masks and slots equal, endpoints within
    1e-3 px, descriptors within 1e-5 + 0.5 x their endpoint difference,
    apart from the lines a pixel feeds
    whose bin or support an atan2 ulp moved, held to 0.5 px and a
    descriptor distance of 0.02); then precompute_sequence on the first 3
    frames of `seq` on the card, its files read back through
    StoredLineSource equal to the detector's outputs."""
    import tempfile
    from lldslam_tpu_torch.frontend import line_extract as le
    from lldslam_tpu_torch.io import stored_lines

    cfg = le.LineDetConfig(max_lines=256)
    x = torch.from_numpy(img).to(dev)
    a, b = le.detect_lines(x, cfg), le.detect_lines(x, cfg)
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    c = le.detect_lines(x.cpu(), cfg)
    # the pixels an ulp moved: bins and the support masks of the CPU's peaks
    vc, vg = le._votes(x.cpu().float(), cfg), le._votes(x.float(), cfg)
    edge_c, phi_c, bins_c = vc[3], vc[4], vc[5]
    edge_g, phi_g, bins_g = (t.cpu() for t in vg[3:6])
    moved = (edge_c | edge_g) & (bins_c != bins_g)
    H, W = img.shape
    xs = torch.arange(W, dtype=torch.float32).repeat(H)[None]
    ys = torch.arange(H, dtype=torch.float32).repeat_interleave(W)[None]
    diag = float(np.hypot(H, W))
    mag_c = vc[2]
    acc = le._accumulate(bins_c.reshape(-1), torch.where(
        edge_c, mag_c, 0.0).reshape(-1), vc[6] * cfg.n_phi)
    accp = torch.nn.functional.pad(acc.reshape(vc[6], cfg.n_phi), (0, 0, 1, 1))
    accp = torch.cat([accp[:, -1:], accp, accp[:, :1]], dim=1)
    win = torch.nn.functional.max_pool2d(accp[None, None], 3, stride=1)[0, 0]
    a2 = acc.reshape(vc[6], cfg.n_phi)
    _, flat = le._top_k(torch.where((a2 >= win) & (a2 >= cfg.min_support), a2,
                                    0.0).reshape(-1), cfg.max_lines)
    rho_k = ((flat // cfg.n_phi).float() + 0.5) * cfg.rho_res * 2.0 - diag
    phi_k = (flat % cfg.n_phi).float().add(0.5) * le._bin_to_phi(cfg.n_phi)
    sup = [le._support(xs, ys, phi.reshape(1, -1), edge.reshape(1, -1), rho_k,
                       torch.cos(phi_k), torch.sin(phi_k), phi_k, cfg)
           for phi, edge in ((phi_c, edge_c), (phi_g, edge_g))]
    fed = (sup[0] != sup[1]).any(-1)
    for bin_ in torch.cat([bins_c[moved], bins_g[moved]]).tolist():
        dr = (flat // cfg.n_phi - bin_ // cfg.n_phi).abs()
        dp = (flat % cfg.n_phi - bin_ % cfg.n_phi).abs()
        fed |= (dr <= 1) & (torch.minimum(dp, cfg.n_phi - dp) <= 1)
    n_flip = int((sup[0] != sup[1]).any(0).sum()) + int(moved.sum())
    g = [t.cpu() for t in a]
    ep = torch.maximum((g[0] - c[0]).abs().amax(-1),
                       (g[1] - c[1]).abs().amax(-1))
    dd = (g[4] - c[4]).abs().amax(-1)
    dist = torch.linalg.norm(g[4] - c[4], dim=-1)
    strict, both = ~fed, fed & g[5] & c[5]
    ok = (bool(torch.equal(g[5][strict], c[5][strict]))
          and float(ep[strict].max()) <= DETECT_PX
          and bool((dd[strict] <= DETECT_DESC
                    + DETECT_DESC_PER_PX * ep[strict]).all())
          and bool((ep[both] <= DETECT_FED_PX).all())
          and bool((dist[both] <= DETECT_FED_DESC).all()))
    n_fed = int((fed & (g[5] | c[5])).sum())
    log(f"native_lines: detector on one KITTI view: {int(c[5].sum())} lines "
        f"on the CPU, {int(g[5].sum())} on the card; two card calls "
        f"bit-identical: {same}; {n_flip} pixels flipped by an ulp "
        f"(of {int(edge_c.sum())} edge pixels), {n_fed} lines fed by one; "
        f"the others within {float(ep[strict].max()):.2e} px and "
        f"{float(dd[strict].max()):.2e} (descriptors) of the CPU")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pre_")
    first = type(seq)(seq.left[:3], seq.right[:3], seq.timestamps[:3])
    stored_lines.precompute_sequence(first, f"{tmp}/l", f"{tmp}/r", cfg,
                                     device=dev)
    exact = True
    for i in range(3):
        for side, path in (("l", first.left[i]), ("r", first.right[i])):
            kl = le.detect_lines(torch.from_numpy(
                first.frame(i)[0 if side == "l" else 1]).to(dev), cfg)
            src = stored_lines.StoredLineSource(f"{tmp}/{side}", cap=256)
            got = src.frame(i, device=dev)
            n = int(kl.valid.sum())
            exact &= bool(got.valid[:n].all()) and int(got.valid.sum()) == n
            for k in (0, 1, 2, 4):
                exact &= torch.equal(got[k][:n], kl[k][kl.valid])
    log(f"native_lines: precompute_sequence on 3 frames on the card read back "
        f"through StoredLineSource equal to the detector: {exact}")
    if not (same and ok and exact):
        raise AssertionError(f"native_lines detector: bit-identical {same}, "
                             f"card against CPU {ok}, files {exact}")
    return dict(bit_identical=same, flipped_pixels=n_flip, fed_lines=n_fed,
                max_px=float(ep[strict].max()),
                max_desc=float(dd[strict].max()))


def phase_native_lines(dev, frames, poses) -> dict:
    """mini KITTI through the CLI (stored and native lines), then the lines
    world as KITTI-layout PNGs through the CLI on the native detector, then
    the detector alone (see the module docstring, phase 14)."""
    import dataclasses
    import tempfile
    from lldslam_tpu_torch import native
    from lldslam_tpu_torch.config import LineConfig
    from lldslam_tpu_torch.frontend import line_extract as le
    from lldslam_tpu_torch.io import datasets
    from lldslam_tpu_torch.io.synthetic import write_kitti_sequence
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.system import System

    out = dict(mini=mini_kitti_runs(dev))
    out["mini_counts"] = out["mini"].pop("counts")
    cfg = dataclasses.replace(kitti_config(), line=LineConfig(
        ld_type="LBDFloat", md_thr=0.6))
    seq_dir = tempfile.mkdtemp(prefix="chip_smoke_native_")
    t = time.perf_counter()
    write_kitti_sequence(seq_dir, frames, cfg, poses)
    log(f"native_lines: wrote {2 * len(frames)} KITTI-size PNGs in "
        f"{time.perf_counter() - t:.1f} s")
    seq = datasets.load_kitti(seq_dir)
    paths = seq.left + seq.right
    decode = []
    for p in paths[:20]:
        t = time.perf_counter()
        native.read_png(p)
        decode.append(1e3 * (time.perf_counter() - t))
    frame_ms, wait_ms, det_ms = [], [], []
    restore = [timed_calls(System, "track_stereo", frame_ms),
               timed_calls(datasets.PrefetchedStereoSequence, "frame",
                           wait_ms),
               timed_calls(le, "detect_lines", det_ms)]
    try:
        reset_counts()
        run = cli_run(["kitti", f"{seq_dir}/settings.yaml", seq_dir],
                      f"{seq_dir}")
        counts = read_counts()
    finally:
        for r in restore:
            r()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    ate = ate_rmse(run["T"], gt)
    lm = statistics.median(run["line_matches"][1:])
    pre = datasets.prefetch(seq)
    pairs_equal = all(
        np.array_equal(a, f[0]) and np.array_equal(b, f[1])
        for (a, b, _), f in ((pre.frame(i), frames[i])
                             for i in (0, len(frames) - 1)))
    pre.close()
    # the detector alone on frame 0's left view: CUDA events, peak memory
    img = native.read_png(seq.left[0])
    x = torch.from_numpy(img).to(dev)
    dcfg = le.LineDetConfig(max_lines=256, min_len=cfg.line.min_line_len)
    view_ms = cuda_ms(lambda: le.detect_lines(x, dcfg), reps=12)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    le.detect_lines(x, dcfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    work = detector_work(*img.shape, dcfg.max_lines, le.SUPPORT_CHUNK)
    steady = frame_ms[1:]
    out.update(
        counts=counts, states=run["states"], kfs=run["kfs"], ate=ate,
        T_wc=run["T"],
        line_matches=run["line_matches"], line_matches_median=lm,
        pairs_equal=pairs_equal, ms=frame_ms,
        ms_median=statistics.median(steady),
        ms_p90=float(np.percentile(steady, 90)),
        detect_ms_per_view=view_ms, detect_host_ms=statistics.median(det_ms),
        detect_work=work,
        detect_peak_bytes=int(peak),
        decode_ms_per_image=statistics.median(decode),
        wait_ms_per_frame=statistics.median(wait_ms),
        wait_ms_max=max(wait_ms))
    log(f"native_lines: keyframes at {run['kfs']}; ATE {ate:.5f} m (JAX-CPU "
        f"{NATIVE_LINES_JAX['ate']:.5f}); line matches per frame "
        f"{run['line_matches']}, median {lm}; launches {counts}")
    log(f"native_lines: ms/frame median {out['ms_median']:.1f} p90 "
        f"{out['ms_p90']:.1f} (first {frame_ms[0]:.1f}); detector "
        f"{view_ms:.3f} ms per view (CUDA events, median of 12; host-clock "
        f"median in the run {out['detect_host_ms']:.2f} ms), peak memory of "
        f"one call {peak / 2**20:.1f} MiB; PNG decode "
        f"{out['decode_ms_per_image']:.2f} ms per image; host blocked in the "
        f"prefetcher's frame(i) {out['wait_ms_per_frame']:.3f} ms per frame "
        f"(max {out['wait_ms_max']:.3f}); first and last pairs equal to the "
        f"rendered frames: {pairs_equal}")
    log(f"native_lines: detector work on one view: {work['bytes']} bytes "
        f"and {work['ops']:.3e} operations, bound {work['bound_ms']:.4f} ms "
        f"({work['bound_by']}), {100 * work['bound_ms'] / view_ms:.2f}% of "
        f"bound; a fused support pass would move "
        f"{work['fused_bytes'] / 1e6:.1f} MB ({work['fused_ms']:.4f} ms), "
        f"the eager one about "
        f"{work['eager_bytes'] / 1e9:.1f} GB ({work['eager_ms']:.2f} ms)")
    checks = [
        (all(x == "OK" for x in run["states"]), f"states {run['states']}"),
        (ate <= NATIVE_LINES_JAX["ate"] + 0.02, f"ATE {ate} m"),
        (len(run["kfs"]) >= 5, f"keyframes {run['kfs']}"),
        (NATIVE_LINE_MATCH_RANGE[0] <= lm <= NATIVE_LINE_MATCH_RANGE[1],
         f"line matches median {lm}"),
        (pairs_equal, "decoded pairs differ from the rendered frames")]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("native_lines: " + "; ".join(bad))
    need_launches(counts, "native_lines", ("tracking", "fusion"))
    need_launches(out["mini_counts"], "mini_kitti", ("tracking", "fusion"))
    out["detector"] = detector_alone(dev, img, seq)
    out["vote"] = vote_site(dev, img, native.read_png(seq.right[0]))
    return out


def vote_work(O: int, n: int, voting: int, n_long: int) -> dict:
    """Bytes each pass of the vote on the card moves (each read or write
    once), over O pixels, n bins, `voting` voting pixels and n_long long
    bins: the memset of the counts, the count pass (every pixel's bin and
    vote in, an atomic on each voting pixel's count), the one-block scan
    (counts in, offsets and the long bins' list out), the scatter (every
    pixel's bin and vote in; each voting pixel's offset and cursor in, its
    slot out) and the ordering sum (offsets, the long bins' list, each
    voting pixel's slot and vote in, every bin out)."""
    n4 = (n + 4) // 4
    layout = (16 * n4 + O * 8 + voting * 4 + n * 4 + (n + 1) * 4
              + n_long * 4 + O * 8 + voting * 12)
    reduce_ = (n + 1) * 4 + n_long * 4 + voting * 8 + n * 4
    return dict(layout_bytes=layout, reduce_bytes=reduce_,
                call_bytes=layout + reduce_)


def vote_site(dev, img: np.ndarray, right: np.ndarray) -> dict:
    """The native detector's vote (line_extract._accumulate: segment_sum.
    bin_sum, its layout built with no sort) on one KITTI view: the card's
    accumulator bit-equal to the CPU's index_add_ over every pixel on the
    same bins and votes, and to a second call (raises otherwise); four
    launches a call, so 8 in the two calls (raises otherwise). Device times
    behind a spin kernel (device_ms, median of 20): the ordering sum alone
    (bin_reduce on a built layout: "the kernel"), the layout alone
    (bin_layout: count, scan, scatter), a whole call, and the atomic
    index_add_ (the library yardstick); a whole call on CUDA events (as the
    parent measured it), index_put_(accumulate=True) a call and the CPU
    index_add_ (host clock); whether the vote, index_put_ and the whole
    detector make the host wait (host_waits). Bounds: the bytes each
    launch moves (vote_work). The longest bin and the bins of more than
    SMALL_BIN voting pixels on this view and on `right`."""
    from lldslam_tpu_torch.frontend import line_extract as le
    from lldslam_tpu_torch.ops import segment_sum

    cfg = le.LineDetConfig(max_lines=256)
    x = torch.from_numpy(img).to(dev)
    _, _, mag, edge, _, bins, n_rho = le._votes(x.float(), cfg)
    w = torch.where(edge, mag, 0.0).reshape(-1)
    b = bins.reshape(-1)
    n, O = n_rho * cfg.n_phi, w.shape[0]
    launches = segment_sum.launches
    got, again = le._accumulate(b, w, n), le._accumulate(b, w, n)
    launched = segment_sum.launches - launches
    want = le._accumulate(b.cpu(), w.cpu(), n)
    torch.cuda.synchronize()
    exact = torch.equal(got.cpu(), want) and torch.equal(got, again)

    def bin_stats(bv, wv) -> dict:
        lay = segment_sum.bin_layout(bv, wv, n)
        off = lay.offsets[:n + 1].long()
        length = off[1:] - off[:-1]
        return dict(voting=int(length.sum()), filled=int((length > 0).sum()),
                    longest=int(length.max()), n_long=int(lay.n_long),
                    lay=lay)

    st = bin_stats(b, w)
    _, _, mag_r, edge_r, _, bins_r, _ = le._votes(
        torch.from_numpy(right).to(dev).float(), cfg)
    st_r = bin_stats(bins_r.reshape(-1),
                     torch.where(edge_r, mag_r, 0.0).reshape(-1))
    lay, voting = st.pop("lay"), st["voting"]
    st_r.pop("lay")
    acc = torch.zeros(n, device=dev)
    bc, wc = b.cpu(), w.cpu()
    plain = []
    for _ in range(10):
        t = time.perf_counter()
        torch.zeros(n).index_add_(0, bc, wc)
        plain.append(1e3 * (time.perf_counter() - t))
    row = dict(
        rows=O, voting_rows=voting, columns=1, segments=n, exact=exact,
        max_abs_err=float((got.cpu() - want).abs().max()),
        calls_per_frame=2, launches_per_call=launched // 2,
        filled_segments=st["filled"], longest_bin=st["longest"],
        long_bins=st["n_long"], right_view=st_r,
        ms=device_ms(lambda: segment_sum.bin_reduce(lay, w, n)),
        layout_ms=device_ms(lambda: segment_sum.bin_layout(b, w, n)),
        call_device_ms=device_ms(lambda: le._accumulate(b, w, n)),
        call_ms=cuda_ms(lambda: le._accumulate(b, w, n)),
        library_ms=device_ms(lambda: acc.index_add_(0, b, w)),
        library_ms_index_put=cuda_ms(lambda: acc.index_put_(
            (b.long(),), w, accumulate=True)),
        plain_ms=statistics.median(plain))
    row["host_waits"] = {
        "accumulate": host_waits(lambda: le._accumulate(b, w, n)),
        "index_put_": host_waits(lambda: acc.index_put_(
            (b.long(),), w, accumulate=True)),
        "detect_lines": host_waits(lambda: le.detect_lines(x, cfg))}
    work = vote_work(O, n, voting, st["n_long"])
    row.update(work)
    row["bound_ms"], row["bound_by"] = bound(work["reduce_bytes"], voting)
    row["bound_ms_layout"], _ = bound(work["layout_bytes"], 0)
    row["bound_ms_call"], _ = bound(work["call_bytes"], voting)
    row["factor"] = row["ms"] / row["library_ms"]
    row["call_factor"] = row["call_device_ms"] / row["library_ms"]
    log(f"vote site: {O} rows ({voting} voting, {st['filled']} bins "
        f"filled, the longest {st['longest']} pixels, {st['n_long']} bins "
        f"over {segment_sum.SMALL_BIN}; right view {st_r['voting']} voting, "
        f"longest {st_r['longest']}, {st_r['n_long']} long) -> {n} bins; "
        f"card against CPU index_add_ bit-equal {exact}, {launched} "
        f"launches in 2 calls; on the device: the ordering sum "
        f"{row['ms']:.4f} ms (bound {row['bound_ms']:.5f} ms, "
        f"{100 * row['bound_ms'] / row['ms']:.2f}%; atomic index_add_ "
        f"{row['library_ms']:.4f} ms, factor {row['factor']:.2f}), the "
        f"layout {row['layout_ms']:.4f} ms (bound "
        f"{row['bound_ms_layout']:.5f} ms), a whole call "
        f"{row['call_device_ms']:.4f} ms (bound {row['bound_ms_call']:.5f} "
        f"ms, {100 * row['bound_ms_call'] / row['call_device_ms']:.2f}%; "
        f"factor {row['call_factor']:.2f}); a call on CUDA events "
        f"{row['call_ms']:.4f} ms; index_put_(accumulate) "
        f"{row['library_ms_index_put']:.4f} ms a call, CPU index_add_ "
        f"{row['plain_ms']:.3f} ms; the host waits for the device in: "
        + json.dumps({k: v["waits"] for k, v in row["host_waits"].items()}))
    if not exact or launched != 8 or not all(
            v["conclusive"] and not v["waits"]
            for k, v in row["host_waits"].items() if k != "index_put_"):
        raise AssertionError(f"vote site: bit-equal {exact}, launches "
                             f"{launched}, host waits {row['host_waits']}")
    return row


def phase_loop(dev) -> dict:
    """The ring through System; also keeps a copy of the loop event's pose
    graph (the input of its first optimize_pose_graph call)."""
    from lldslam_tpu_torch.io.synthetic import make_ring_sequence
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.optim import pose_graph
    from lldslam_tpu_torch.system import System

    cfg = patch_world_config()
    t0 = time.perf_counter()
    frames, gt = make_ring_sequence(cfg.camera.stereo_camera())
    log(f"loop: rendered {len(frames)} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, device=dev)
    sys_.tracker.mapper.p_cap = 4096
    sys_.tracker.mapper.o_cap = 8192
    graphs, restore = keep_inputs(pose_graph, "optimize_pose_graph")
    reset_counts()
    try:
        ms, metrics = track(sys_, frames, label="loop")
    finally:
        restore()
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
    if counts["segsum"] <= 0:
        raise AssertionError(f"loop: the loop event launched no segment sum: "
                             f"{counts}")
    return dict(counts=counts, store=tr.store, voc=lc.voc, cfg=cfg,
                graph=pose_graph.PoseGraph(*(t.clone()
                                             for t in graphs[0][1][0])))


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
    if counts["lm_sites"].get("reloc", 0) <= 0:
        raise AssertionError(f"reloc: the pose LM kernel was not launched at "
                             f"the reloc site: {counts['lm_sites']}")
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


def ate_sim3(est_T_wc: np.ndarray, gt_T_wc: np.ndarray):
    """ATE RMSE (m) of the camera centres after the least-squares similarity
    (Umeyama) that maps the estimate onto the ground truth, and its scale:
    a monocular map has a free scale."""
    p = est_T_wc[:, :3, 3].astype(np.float64)
    g = gt_T_wc[:, :3, 3].astype(np.float64)
    pc, gc = p - p.mean(0), g - g.mean(0)
    U, S, Vt = np.linalg.svd(gc.T @ pc / len(p))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    scale = float(np.trace(np.diag(S) @ D) / (pc ** 2).sum(-1).mean())
    res = scale * pc @ R.T - gc
    return float(np.sqrt((res ** 2).sum(-1).mean())), scale


def phase_mono(dev, frames, poses) -> dict:
    """The main path's left views through System.track_monocular; the
    bootstrap's matcher, RANSAC and reconstruction timed by wrapping them."""
    from lldslam_tpu_torch.frontend import matching
    from lldslam_tpu_torch.ops import orb_describe
    from lldslam_tpu_torch.optim import initializer
    from lldslam_tpu_torch.system import System

    sys_ = System(kitti_config(), device=dev)
    sys_.warmup()
    kept_a, restore_a = keep_inputs(orb_describe, "describe", last_only=True)
    boot_ms = dict(match=[], ransac=[], reconstruct=[])
    restore = [restore_a,
               timed_calls(matching, "search_for_initialization",
                           boot_ms["match"]),
               timed_calls(initializer, "ransac_models", boot_ms["ransac"]),
               timed_calls(initializer, "reconstruct_h",
                           boot_ms["reconstruct"]),
               timed_calls(initializer, "reconstruct_f",
                           boot_ms["reconstruct"])]
    try:
        reset_counts()
        ms, metrics = track(sys_, [l for l, _ in frames], label="mono",
                            mode="mono")
        counts = read_counts()
    finally:
        for r in restore:
            r()
    tr, s = sys_.tracker, sys_.map
    states = [m.state for m in metrics]
    boot = states.index("OK") if "OK" in states else -1
    kf_frames = [m.frame_id for m in metrics if m.new_kf]
    _, T_wc = tr.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])[N_FRAMES - len(T_wc):]
    ate, scale = ate_sim3(T_wc, gt)
    points = int(s.pt_valid.sum())
    path_m = float(np.linalg.norm(gt[-1, :3, 3] - gt[0, :3, 3]))
    inliers = [m.n_inliers for m in metrics]
    after = ms[boot + 1:]
    out = dict(counts=counts, states=states, bootstrap=boot,
               kf_frames=kf_frames, n_kf=s.n_kf,
               n_kf_valid=int(s.kf_valid[:s.n_kf].sum()), points=points,
               ate=ate, scale=scale, ms=ms, inliers=inliers, boot_ms=boot_ms,
               frame_kernels=frame_kernels("mono", kept_a))
    log(f"mono: states {states}")
    log(f"mono: bootstrap at frame {boot} ({ms[boot]:.1f} ms); keyframes at "
        f"{kf_frames} ({s.n_kf} created, {out['n_kf_valid']} valid); "
        f"{points} map points; Sim(3)-aligned ATE {ate:.5f} m over "
        f"{path_m:.1f} m, scale {scale:.3f} (JAX-CPU run 0.0414 m, 17.02); "
        f"inliers {inliers}; launches {counts}")
    log(f"mono: ms/frame after the bootstrap median "
        f"{statistics.median(after):.1f} p90 "
        f"{float(np.percentile(after, 90)):.1f}; frame 0 {ms[0]:.1f} ms; "
        f"bootstrap calls (ms, device synchronised) "
        + json.dumps({k: [round(x, 2) for x in v]
                      for k, v in boot_ms.items()}))
    n_tracked = len(after)
    checks = [
        (states[0] == "NOT_INITIALIZED", f"frame 0 {states[0]}"),
        (boot in (1, 2), f"bootstrap at frame {boot}"),
        (boot > 0 and states[boot:] == ["OK"] * (N_FRAMES - boot),
         "a frame after the bootstrap not OK"),
        (s.n_kf >= 4, f"{s.n_kf} keyframes"),
        (MONO_POINT_RANGE[0] <= points <= MONO_POINT_RANGE[1],
         f"{points} map points"),
        (ate <= MONO_ATE_BOUND_M, f"ATE {ate} m"),
        (counts["k1a"] == N_FRAMES and counts["k1b"] == 0,
         f"K1a / K1b launches {counts['k1a']} / {counts['k1b']}"),
        (counts["k2g_sites"].get("tracking", 0) >= n_tracked,
         f"K2g tracking launches {counts['k2g_sites']} for {n_tracked} "
         f"tracked frames"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("mono: " + "; ".join(bad))
    return out


def phase_rgbd(dev) -> dict:
    """A TUM-size corridor with depth through System.track_rgbd; then the
    map's top-down render and a checkpoint round trip."""
    import tempfile
    from lldslam_tpu_torch.io.synthetic import make_sequence
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    from lldslam_tpu_torch.system import System
    from lldslam_tpu_torch.viewer import render

    cfg = tum_config()
    t0 = time.perf_counter()
    frames, poses, _, depths = make_sequence(
        cfg.camera.stereo_camera(), N_FRAMES, seed=3, half_w=2.0, cam_h=1.2,
        speed=0.05, return_poses=True, return_depth=True)
    inputs = [(l, np.where(d <= RGBD_MAX_DEPTH_M, d, 0.0).astype(np.float32))
              for (l, _), d in zip(frames, depths)]
    log(f"rgbd: generated {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, device=dev)
    sys_.warmup()
    reset_counts()
    ms, metrics = track(sys_, inputs, label="rgbd", mode="rgbd")
    counts = read_counts()
    states = [m.state for m in metrics]
    kf_frames = [m.frame_id for m in metrics if m.new_kf]
    _, T_wc = sys_.tracker.trajectory()
    gt = np.stack([np.linalg.inv(p) for p in poses])
    ate = ate_rmse(T_wc, gt, align=False)
    points = int(sys_.map.pt_valid.sum())
    log(f"rgbd: keyframes at {kf_frames} (JAX-CPU run "
        f"{list(RGBD_KF_FRAMES)}); {points} map points; unaligned ATE "
        f"{ate:.5f} m; launches {counts}")
    log(f"rgbd: ms/frame median {statistics.median(ms[1:]):.1f} p90 "
        f"{float(np.percentile(ms[1:], 90)):.1f} (first frame {ms[0]:.1f})")
    t = time.perf_counter()
    img = render.render_topdown(sys_.map, T_wc, size=512)
    render_ms = 1e3 * (time.perf_counter() - t)
    drawn = int((img != render.BG).any(-1).sum())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_map_") as tmp:
        t = time.perf_counter()
        sys_.save_map(f"{tmp}/map.npz")
        save_ms = 1e3 * (time.perf_counter() - t)
        fresh = System(cfg, device=dev, enable_loops=False)
        t = time.perf_counter()
        fresh.load_map(f"{tmp}/map.npz")
        load_ms = 1e3 * (time.perf_counter() - t)
    arrays = {k: v for k, v in vars(sys_.map).items()
              if isinstance(v, np.ndarray)}
    unequal = [k for k, v in arrays.items()
               if not np.array_equal(getattr(fresh.map, k), v)]
    unequal += [k for k in ("n_kf", "n_pt", "n_ln")
                if getattr(fresh.map, k) != getattr(sys_.map, k)]
    log(f"rgbd: render_topdown {img.shape}, {drawn} pixels drawn, "
        f"{render_ms:.1f} ms; save_map {save_ms:.1f} ms, load_map "
        f"{load_ms:.1f} ms, {len(arrays)} arrays, unequal {unequal}")
    checks = [
        (states == ["OK"] * N_FRAMES, f"states {states}"),
        (len(kf_frames) == len(RGBD_KF_FRAMES) and all(
            abs(a - b) <= 1 for a, b in zip(kf_frames, RGBD_KF_FRAMES)),
         f"keyframes {kf_frames}"),
        (RGBD_POINT_RANGE[0] <= points <= RGBD_POINT_RANGE[1],
         f"{points} map points"),
        (ate <= RGBD_ATE_BOUND_M, f"ATE {ate} m"),
        (counts["k1a"] == N_FRAMES and counts["k1b"] == 0
         and counts["k2g_sites"].get("tracking", 0) >= N_FRAMES - 1,
         f"launches {counts}"),
        (img.shape == (512, 512, 3) and drawn > 100, f"render {drawn}"),
        (not unequal, f"checkpoint arrays unequal: {unequal}"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("rgbd: " + "; ".join(bad))
    return dict(counts=counts, kf_frames=kf_frames, points=points, ate=ate,
                ms=ms, render_ms=render_ms, save_ms=save_ms, load_ms=load_ms)


def phase_rectify(dev) -> dict:
    """StereoRectifier with the EuRoC-like blocks on one synthetic pair, on
    the card against the CPU."""
    from lldslam_tpu_torch.config import CameraConfig
    from lldslam_tpu_torch.io.synthetic import euroc_blocks, make_sequence
    from lldslam_tpu_torch.ops.rectify import StereoRectifier

    cam = CameraConfig(fx=435.2047, fy=435.2047, cx=367.4517, cy=252.2009,
                       bf=47.9064, width=752, height=480).stereo_camera()
    (pair,) = make_sequence(cam, 1, seed=4, half_w=3.0, cam_h=1.2, speed=0.05)
    blocks = euroc_blocks()
    card, cpu = StereoRectifier(blocks, device=dev), StereoRectifier(
        blocks, device="cpu")
    got, want = card(*pair), cpu(*pair)
    torch.cuda.synchronize()
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    zeros = [int((w == 0).sum()) for w in want]
    ms = cuda_ms(lambda: card(*pair))
    on_card = [torch.from_numpy(x).to(dev) for x in pair]
    ms_dev = cuda_ms(lambda: card(*on_card))
    log(f"rectify: EuRoC-like blocks, 752x480 pair: max |card - CPU| "
        f"{err:.2e} (zeroed border pixels {zeros}); {ms:.3f} ms a pair from "
        f"host arrays (upload included), {ms_dev:.3f} ms from images on the "
        f"card")
    if not err <= RECTIFY_TOL:
        raise AssertionError(f"rectify: card against CPU {err}")
    return dict(max_abs_err=err, ms=ms, ms_on_card=ms_dev)


def _angle_rad(Ra, Rb):
    """Rotation angles between two stacks of rotations (radians)."""
    d = np.einsum("kji,kjl->kil", Ra.astype(np.float64), Rb.astype(np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                  d[:, 1, 0] - d[:, 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1) / 2, 0, 1))


def phase_loop_lines(dev) -> dict:
    """One loop correction with map lines on the card against the CPU: the
    seeded loop map (make_loop_map's drifting circle, keyframe 21 revisiting
    keyframe 2) with add_loop_lines' map lines in two stores; Sim3 on the
    CPU, the guided matches (K2g at the loop site) on the card, then
    `_correct` on both devices: keyframe poses, points and map lines after
    the pose graph, the remap, fusion and the joint point+line global BA."""
    from lldslam_tpu_torch.io.synthetic import add_loop_lines, make_loop_map
    from lldslam_tpu_torch.loop.closing import LoopCloser
    from lldslam_tpu_torch.slammap.map_store import MapStore
    from lldslam_tpu_torch.system import _default_vocabulary

    cfg = patch_world_config()
    cam = cfg.camera.stereo_camera()
    voc = _default_vocabulary()
    stores = [MapStore(cam, cfg.orb, max_kf=64, max_pt=20000) for _ in "ab"]
    for st in stores:
        add_loop_lines(st, make_loop_map(st))
    cpu = LoopCloser(stores[0], voc, cfg, device="cpu")
    card = LoopCloser(stores[1], voc, cfg, device=dev)
    res = cpu._compute_sim3(21, 2)
    if res is None:
        raise AssertionError("loop_lines: no Sim3 between keyframes 21 and 2")
    S = res[0]
    Tm = stores[0].kf_pose[2]
    T_corr = np.eye(4, dtype=np.float32)
    T_corr[:3, :3] = S[0] @ Tm[:3, :3]
    T_corr[:3, 3] = S[2] * (S[0] @ Tm[:3, 3]) + S[1]
    pids = cpu._loop_points(2)
    reset_counts()
    kp2lp = card._project_match(21, pids, T_corr, th=2.5)
    if not np.array_equal(kp2lp, cpu._loop_guided[0]):
        raise AssertionError("loop_lines: guided matches differ from the CPU")
    card._loop_guided = (kp2lp, pids)
    lines_before = stores[1].ln_x0[:stores[1].n_ln].copy()
    t = time.perf_counter()
    cpu._correct(21, 2, S)
    cpu_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    card._correct(21, 2, S)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t)
    counts = read_counts()
    a, b = stores
    n = a.n_ln
    d = store_diff(a, b)
    moved = float(np.linalg.norm(b.ln_x0[:n] - lines_before, axis=-1).max())
    finite = bool(np.isfinite(b.ln_x0[:n]).all() and np.isfinite(
        b.ln_dir[:n]).all())
    out = dict(counts=counts, card_ms=card_ms, cpu_ms=cpu_ms, **d,
               store=b, inputs=(S, T_corr, pids), line_moved=moved,
               stage_ms={k: 1e3 * v for k, v in card.stage_times.items()
                         if not k.startswith("n")})
    log(f"loop_lines: _correct with {d['n_lines']} map lines, card "
        f"{card_ms:.1f} ms, CPU {cpu_ms:.1f} ms; card against CPU: "
        f"{_diff_text(d)}; lines moved up to {moved:.3f} m; launches "
        f"{counts}; stage ms "
        + json.dumps({k: round(v, 2) for k, v in out["stage_ms"].items()}))
    checks = loop_lines_checks(d) + [
        (d["n_lines"] >= 100 and finite, f"{d['n_lines']} lines, finite "
                                         f"{finite}"),
        (moved > 0.05, f"the correction moved the lines {moved} m"),
        (counts["k2g_sites"].get("loop", 0) >= 2 and counts["segsum"] > 0,
         f"launches {counts}"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("loop_lines: " + "; ".join(bad))
    return out


def store_diff(a, b) -> dict:
    """Map b against map a: keyframe centres (max m) and rotations (max
    rad), live points (median and max m), observations equal (share), map
    lines valid in both: X0 relative to max(1, |X0|) (max, median) and
    1 - |cos| of the directions (max)."""
    K, n = a.n_kf, a.n_ln
    live = a.pt_valid[:a.n_pt] & b.pt_valid[:b.n_pt]
    de = np.linalg.norm(a.pt_pos[:a.n_pt][live] - b.pt_pos[:b.n_pt][live],
                        axis=-1)
    lv = a.ln_valid[:n] & b.ln_valid[:n]
    ex = np.linalg.norm(b.ln_x0[:n] - a.ln_x0[:n], axis=-1)[lv] \
        / np.maximum(1.0, np.linalg.norm(a.ln_x0[:n], axis=-1)[lv])
    ed = np.abs(np.abs(np.sum(b.ln_dir[:n] * a.ln_dir[:n], -1)) - 1.0)[lv]
    return dict(
        pose_dt=float(np.abs(b.kf_pose[:K, :3, 3]
                             - a.kf_pose[:K, :3, 3]).max()),
        pose_da=float(_angle_rad(a.kf_pose[:K, :3, :3],
                                 b.kf_pose[:K, :3, :3]).max()),
        point_median=float(np.median(de)), point_max=float(de.max()),
        same_obs=float((a.kf_pt_ids[:K] == b.kf_pt_ids[:K]).mean()),
        n_lines=int(lv.sum()), line_x0_rel_max=float(ex.max(initial=0.0)),
        line_x0_rel_median=float(np.median(ex)) if len(ex) else 0.0,
        line_dir_max=float(ed.max(initial=0.0)))


def _diff_text(d: dict) -> str:
    return (f"poses {d['pose_dt']:.2e} m / {d['pose_da']:.2e} rad, points "
            f"median {d['point_median']:.2e} max {d['point_max']:.2e} m, "
            f"observations {100 * d['same_obs']:.3f}% equal, lines X0 rel max "
            f"{d['line_x0_rel_max']:.2e} median {d['line_x0_rel_median']:.2e}, "
            f"direction 1-|cos| max {d['line_dir_max']:.2e}")


def loop_lines_checks(d: dict) -> list:
    """The loop_lines bounds (the card against the CPU): poses 2e-3 m
    / 1e-3 rad, points median 5e-3 m, lines X0 relative median 2e-3 and
    max 2e-2, directions 1e-3."""
    return [
        (d["pose_dt"] <= 2e-3 and d["pose_da"] <= 1e-3,
         f"poses {d['pose_dt']} m {d['pose_da']} rad"),
        (d["point_median"] < 5e-3 and d["same_obs"] >= 0.999,
         f"points {d['point_median']} m, obs {d['same_obs']}"),
        (d["line_x0_rel_median"] < 2e-3 and d["line_x0_rel_max"] < 2e-2
         and d["line_dir_max"] < 1e-3, "lines"),
    ]


DIST_REPS = 3
# the JAX package's float scatter-sums that segment_sum_ replaces on the card
# (XLA `.at[].add`; no Pallas kernel)
SEGMENT_SUM_REPLACES = (
    "lldslam_tpu/optim/ba.py:104-108, 208, 217-222; "
    "lldslam_tpu/optim/lines_ba.py:115-119, 398-428, 542-547; "
    "lldslam_tpu/optim/pose_graph.py:80-84, 104-105; "
    "lldslam_tpu/frontend/line_extract.py:93 (.at[].add)")


def same_bits(a, b) -> bool:
    """Map b equals map a bit for bit: keyframe poses, observations, points
    (live flags and positions) and map lines (X0 and direction)."""
    K, P, n = a.n_kf, a.n_pt, a.n_ln
    return ((a.n_kf, a.n_pt, a.n_ln) == (b.n_kf, b.n_pt, b.n_ln)
            and all(np.array_equal(x, y, equal_nan=True) for x, y in (
                (a.kf_pose[:K], b.kf_pose[:K]),
                (a.kf_pt_ids[:K], b.kf_pt_ids[:K]),
                (a.pt_valid[:P], b.pt_valid[:P]), (a.pt_pos[:P], b.pt_pos[:P]),
                (a.ln_x0[:n], b.ln_x0[:n]), (a.ln_dir[:n], b.ln_dir[:n]))))


def gba_routes(dev, store, voc, cfg, label: str) -> dict:
    """LoopCloser.global_ba on copies of `store` through the single route
    and the distributed route (force_dist: the one-rank NCCL group), in
    turns, DIST_REPS times each: host ms of each (synchronised, median),
    the all_reduce calls and the segment-sum launches per solve. Every run
    is held bit-equal to the first single run: the solvers sum in a fixed
    order (ops/segment_sum), so a solve repeats to the bit, and on one rank
    the distributed route is the single route's arithmetic."""
    import copy

    from lldslam_tpu_torch.loop.closing import LoopCloser
    from lldslam_tpu_torch.ops import segment_sum
    from lldslam_tpu_torch.parallel import dist_schur

    def run(route):
        st = copy.deepcopy(store)
        lc = LoopCloser(st, voc, cfg, device=dev)
        calls, launches = dist_schur.all_reduce_calls, segment_sum.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        lc.global_ba(force_dist=route == "dist")
        torch.cuda.synchronize()
        return (st, 1e3 * (time.perf_counter() - t),
                dist_schur.all_reduce_calls - calls,
                segment_sum.launches - launches)

    ms = dict(single=[], dist=[])
    runs, calls, launches = [], [], []
    for i in range(DIST_REPS):
        for route in ("single", "dist"):
            st, t, n, m = run(route)
            ms[route].append(t)
            runs.append((f"{route} run {i}", st))
            launches.append(m)
            if route == "dist":
                calls.append(n)
    ref = runs[0][1]
    differ = [(name, st) for name, st in runs[1:] if not same_bits(ref, st)]
    res = dict(single_ms=statistics.median(ms["single"]),
               dist_ms=statistics.median(ms["dist"]), ms=ms,
               all_reduce=calls[0], segsum_per_solve=launches[0],
               bit_equal=not differ)
    log(f"dist: {label} global BA ({store.n_kf} keyframes, "
        f"{int(store.pt_valid[:store.n_pt].sum())} points, {store.n_ln} map "
        f"lines): single {res['single_ms']:.1f} ms, distributed "
        f"({torch.distributed.get_backend()}, one rank) {res['dist_ms']:.1f} "
        f"ms (median of {DIST_REPS}; all "
        f"{json.dumps({k: [round(v, 1) for v in x] for k, x in ms.items()})}"
        f"); all_reduce calls per solve {calls}; segment-sum launches per "
        f"solve {launches}; every run bit-equal to single run 0: "
        f"{not differ}")
    bad = [msg for ok, msg in (
        (len(set(calls)) == 1 and calls[0] > 0, f"all_reduce calls {calls}"),
        (len(set(launches)) == 1 and launches[0] > 0,
         f"segment-sum launches {launches}"),
        (not differ, "not bit-equal to single run 0: " + "; ".join(
            f"{name}: {_diff_text(store_diff(ref, st))}"
            for name, st in differ))) if not ok]
    if bad:
        raise AssertionError(f"dist {label}: " + "; ".join(bad))
    return res


def loop_lines_correct(dev, inputs, route: str):
    """The loop-lines correction of phase_loop_lines on a fresh map on
    `dev`: the guided matches (K2g at the loop site), then `_correct(21, 2,
    S)` with global_ba on `route` ("single", "dist", or "auto": chosen by
    the world size). Returns (store, ms of `_correct`, ms of its global
    BA)."""
    from lldslam_tpu_torch.io.synthetic import add_loop_lines, make_loop_map
    from lldslam_tpu_torch.loop.closing import LoopCloser
    from lldslam_tpu_torch.slammap.map_store import MapStore
    from lldslam_tpu_torch.system import _default_vocabulary

    cfg = patch_world_config()
    store = MapStore(cfg.camera.stereo_camera(), cfg.orb, max_kf=64,
                     max_pt=20000)
    add_loop_lines(store, make_loop_map(store))
    lc = LoopCloser(store, _default_vocabulary(), cfg, device=dev)
    force = dict(single=False, dist=True, auto=None)[route]
    lc.global_ba = lambda: LoopCloser.global_ba(lc, force_dist=force)
    S, T_corr, pids = inputs
    lc._loop_guided = (lc._project_match(21, pids, T_corr, th=2.5), pids)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    lc._correct(21, 2, S)
    torch.cuda.synchronize(dev)
    return (store, 1e3 * (time.perf_counter() - t),
            1e3 * lc.stage_times["global_ba"])


@contextlib.contextmanager
def keep_segment_calls(kept: dict):
    """Wraps segment_sum_ where the solvers call it (optim/ba.py,
    optim/lines_ba.py, optim/pose_graph.py): under the key (module, out
    shape, src shape) `kept` holds the first such call's inputs, as copies
    of (out before the call, layout, src), and the number of calls."""
    from lldslam_tpu_torch.ops import segment_sum
    from lldslam_tpu_torch.optim import ba, lines_ba, pose_graph

    def recorder(mod):
        def keep(out, layout, src):
            key = (mod, tuple(out.shape), tuple(src.shape))
            if key not in kept:
                kept[key] = dict(args=(out.clone(), layout, src.clone()),
                                 calls=0)
            kept[key]["calls"] += 1
            return segment_sum.segment_sum_(out, layout, src)
        return keep

    mods = dict(ba=ba, lines_ba=lines_ba, pose_graph=pose_graph)
    for name, mod in mods.items():
        mod.segment_sum_ = recorder(name)
    try:
        yield kept
    finally:
        for mod in mods.values():
            mod.segment_sum_ = segment_sum.segment_sum_


SHORT_MEAN = 8   # csrc/segment_sum.cu kShortMean: O < 8 n leads by rows


def segment_work(O: int, n: int, C: int, filled: int) -> int:
    """Bytes a launch of the segment-sum kernel moves, each read or write
    once: every row's C floats and its perm entry, each filled segment's C
    outputs read and written, and what the grid reads to find its rows:
    every row's sorted segment (a thread per row, O < SHORT_MEAN n) or
    every segment's offsets (a block per segment)."""
    rows = O * C * 4 + O * 8 + 2 * filled * C * 4
    return rows + (O * 8 if O < SHORT_MEAN * n else (n + 1) * 8)


def segment_sum_rows(dev, kept: dict, label: str) -> dict:
    """The segment-sum kernel on each kept call of a real solve (`kept`
    from keep_segment_calls): bit-equal to CPU index_add_ (its plain
    version) on copies of the same inputs, and to a second launch; its
    device time (device_ms) against its bound; the atomic index_add_ on
    the card (device_ms: the library yardstick), index_put_(accumulate=
    True) on the card (a call on CUDA events: its range check makes the
    host wait), the CPU index_add_ (host clock) and the layout's build on
    the card (a call on CUDA events). Returns a row per site."""
    from lldslam_tpu_torch.ops.segment_sum import segment_layout, segment_sum_

    rows = {}
    for (mod, out_shape, src_shape), k in kept.items():
        out0, lay, src = k["args"]
        got = segment_sum_(out0.clone(), lay, src)
        again = segment_sum_(out0.clone(), lay, src)
        want = out0.cpu().index_add_(0, lay.index.cpu(), src.cpu())
        torch.cuda.synchronize()
        n, O = out_shape[0], src_shape[0]
        C = int(np.prod(src_shape[1:]))
        name = f"{label}: {mod} {tuple(out_shape)} <- {tuple(src_shape)}"
        if not (torch.equal(got.cpu(), want) and torch.equal(got, again)):
            raise AssertionError(
                f"segment_sum {name}: differs from CPU index_add_ "
                f"(max {float((got.cpu() - want).abs().max())}) or from a "
                f"second launch")
        buf = out0.clone()
        cpu = [t.cpu() for t in (out0, lay.index, src)]
        plain = []
        for _ in range(20):
            t = time.perf_counter()
            cpu[0].clone().index_add_(0, cpu[1], cpu[2])
            plain.append(1e3 * (time.perf_counter() - t))
        row = dict(
            calls=k["calls"], rows=O, columns=C, segments=n, exact=True,
            max_abs_err=0.0, ms=device_ms(lambda: segment_sum_(buf, lay, src)),
            call_ms=cuda_ms(lambda: segment_sum_(buf, lay, src)),
            library_ms=device_ms(lambda: buf.index_add_(0, lay.index, src)),
            library_ms_index_put=cuda_ms(lambda: buf.index_put_(
                (lay.index,), src, accumulate=True)),
            plain_ms=statistics.median(plain),
            layout_ms=cuda_ms(lambda: segment_layout(lay.index, n)))
        filled = int((lay.offsets[1:] > lay.offsets[:-1]).sum())
        row["filled_segments"] = filled
        row["bound_ms"], row["bound_by"] = bound(
            segment_work(O, n, C, filled), O * C)
        row["factor"] = row["ms"] / row["library_ms"]
        rows[name] = row
        log(f"segment_sum {name}: {k['calls']} calls; exact "
            f"against CPU index_add_, repeats; kernel {row['ms']:.4f} ms on "
            f"the device ({row['call_ms']:.4f} ms a call), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
            f"{100 * row['bound_ms'] / row['ms']:.2f}%); atomic index_add_ "
            f"{row['library_ms']:.4f} ms on the device (kernel / atomic "
            f"{row['factor']:.2f}), "
            f"index_put_(accumulate) {row['library_ms_index_put']:.4f} ms a "
            f"call, CPU index_add_ {row['plain_ms']:.4f} ms; layout build "
            f"{row['layout_ms']:.4f} ms a call")
    return rows


def phase_dist(dev, ring: dict, loop_lines: dict) -> dict:
    """The loop-event solvers repeat, and the distributed global BA on one
    process (the one-rank NCCL group of dist_schur.make_mesh) equals the
    single route, all bit for bit, with no deterministic mode. (1) The
    loop phase's ring map after its event through both routes of
    global_ba (gba_routes). (2) The loop-lines correction on the card (K2g
    at the loop site, the pose graph, the remap, fusion, the joint global
    BA) twice on the single route and once on the distributed route, each
    equal to the loop_lines phase's card result. (3) The ring event's pose
    graph through optimize_pose_graph twice. (4) Both routes of global_ba
    on the corrected loop-lines map. (5) The segment-sum kernel on the
    calls of one ring-map global BA and of one loop-lines correction
    (segment_sum_rows)."""
    import copy

    from lldslam_tpu_torch.loop.closing import LoopCloser
    from lldslam_tpu_torch.ops import segment_sum
    from lldslam_tpu_torch.optim import pose_graph
    from lldslam_tpu_torch.parallel import dist_schur
    from lldslam_tpu_torch.system import _default_vocabulary

    group = dist_schur.make_mesh(device=dev)
    log(f"dist: group backend {torch.distributed.get_backend(group)}, "
        f"world {torch.distributed.get_world_size(group)}")
    ring_out = gba_routes(dev, ring["store"], ring["voc"], ring["cfg"],
                          "ring map")
    kept_ring, kept_ll = {}, {}
    with keep_segment_calls(kept_ring):
        LoopCloser(copy.deepcopy(ring["store"]), ring["voc"], ring["cfg"],
                   device=dev).global_ba(force_dist=False)
    inputs = loop_lines["inputs"]
    with keep_segment_calls(kept_ll):
        single = [loop_lines_correct(dev, inputs, "single")]
    single.append(loop_lines_correct(dev, inputs, "single"))
    calls = dist_schur.all_reduce_calls
    reset_counts()
    store, correct_ms, gba_ms = loop_lines_correct(dev, inputs, "dist")
    counts = read_counts()
    calls = dist_schur.all_reduce_calls - calls
    same = dict(second_single=same_bits(single[0][0], single[1][0]),
                dist=same_bits(single[0][0], store),
                loop_lines_phase=same_bits(loop_lines["store"], store))
    log(f"dist: loop-lines _correct with the distributed global BA "
        f"{correct_ms:.1f} ms (its global BA {gba_ms:.1f} ms, all_reduce "
        f"calls {calls}), with the single route {single[0][1]:.1f} / "
        f"{single[1][1]:.1f} ms ({single[0][2]:.1f} / {single[1][2]:.1f} "
        f"ms); bit-equal to the first single run: {same}; distributed "
        f"against single: {_diff_text(store_diff(single[0][0], store))}; "
        f"launches {counts}")
    g = ring["graph"]
    launches = segment_sum.launches
    a = pose_graph.optimize_pose_graph(g, iters=15, cg_iters=48)
    pg_launches = segment_sum.launches - launches
    b = pose_graph.optimize_pose_graph(g, iters=15, cg_iters=48)
    pg_same = all(torch.equal(x, y) for x, y in zip(a, b))
    pg_moved = float((a.t - g.t).abs().max())
    log(f"dist: the ring event's pose graph ({g.R.shape[0]} keyframes, "
        f"{g.e_i.shape[0]} edges) twice: bit-equal {pg_same}, centres moved "
        f"up to {pg_moved:.3f}; segment-sum launches per call {pg_launches}")
    bad = [msg for ok, msg in [
        (all(same.values()), f"loop-lines corrections not bit-equal: {same}"),
        (pg_same and pg_moved > 0, "the pose graph did not repeat or move"),
        (pg_launches > 0, "the pose graph launched no segment sum"),
        (counts["k2g_sites"].get("loop", 0) >= 2, f"launches {counts}"),
        (counts["segsum"] > 0, f"no segment-sum launch: {counts}"),
        (calls > 0, "no all_reduce: the single route ran")] if not ok]
    if bad:
        raise AssertionError("dist loop-lines: " + "; ".join(bad))
    lines_out = gba_routes(dev, store, _default_vocabulary(),
                           patch_world_config(), "loop-lines map")
    rows_ring = segment_sum_rows(dev, kept_ring, "ring global BA")
    rows = dict(rows_ring, **segment_sum_rows(dev, kept_ll,
                                              "loop-lines correction"))
    top = max(rows_ring, key=lambda r: rows_ring[r]["calls"])
    per_gba = {k: sum(r["calls"] * r[k] for r in rows_ring.values())
               for k in ("ms", "library_ms")}
    log(f"segment_sum: per ring-map global BA "
        f"{sum(r['calls'] for r in rows_ring.values())} launches, "
        f"{per_gba['ms']:.3f} ms of kernel time against "
        f"{per_gba['library_ms']:.3f} ms of atomic index_add_")
    segsum = dict(rows[top], site=top, by_site=rows,
                  launches_per_global_ba=ring_out["segsum_per_solve"],
                  launches_per_pose_graph=pg_launches,
                  per_global_ba_ms=per_gba)
    return dict(counts=counts, ring=ring_out, loop_lines=lines_out,
                correct_ms=correct_ms, gba_ms=gba_ms, single_ms=single[0][1],
                single_gba_ms=single[0][2], store=store, segsum=segsum,
                pose_graph_repeats=pg_same)


def loop_lines_rank(rank: int, device, inputs) -> dict:
    """One spawned rank of phase_dist_ranks: the loop-lines correction on
    `device`, global_ba routed by the world size. Returns the corrected
    map, the ms of the correction and of its global BA, the world size and
    the all_reduce calls."""
    from lldslam_tpu_torch.parallel import dist_schur

    store, ms, gba_ms = loop_lines_correct(device, inputs, "auto")
    return dict(ms=ms, gba_ms=gba_ms, all_reduce=dist_schur.all_reduce_calls,
                world=torch.distributed.get_world_size(), store=store)


def phase_dist_ranks(dev, loop_lines: dict, dist_out: dict) -> dict:
    """graft_entry.dryrun_multichip on every card (NCCL, one rank a card)
    and, at the same time, two spawned gloo ranks on one card, each running
    the loop-lines correction with global_ba routed by the world size (2):
    the two ranks' maps bit-equal (same_bits), rank 0 within the loop_lines
    bounds of the one-rank result (two ranks sum in another order)."""
    from lldslam_tpu_torch import graft_entry
    from lldslam_tpu_torch.parallel.ranks import run_ranks

    def timed(fn, *args, **kw):
        t = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t

    # the dry run starts beside the gloo ranks: both spend most of their
    # time starting processes, and the dry run's solves are tiny
    n = torch.cuda.device_count()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        dry = pool.submit(timed, graft_entry.dryrun_multichip, n)
        out, ranks_s = timed(run_ranks, loop_lines_rank, 2,
                             f"cuda:{dev.index or 0}",
                             args=(loop_lines["inputs"],), timeout_s=300.0)
        _, dry_s = dry.result()
    log(f"dist_ranks: dryrun_multichip({n}) on NCCL: {dry_s:.1f} s with "
        f"spawning (beside the gloo ranks)")
    a, b = out[0]["store"], out[1]["store"]
    same = same_bits(a, b)
    d = store_diff(dist_out["store"], a)
    log(f"dist_ranks: two gloo ranks on {dev}: {ranks_s:.1f} s with "
        f"spawning; _correct {[round(o['ms'], 1) for o in out]} ms, its "
        f"global BA {[round(o['gba_ms'], 1) for o in out]} ms (one rank: "
        f"{dist_out['correct_ms']:.1f} ms, its global BA "
        f"{dist_out['gba_ms']:.1f} ms); world {[o['world'] for o in out]}, "
        f"all_reduce calls {[o['all_reduce'] for o in out]}; the ranks' maps "
        f"bit-equal {same}; rank 0 against the one-rank result: "
        f"{_diff_text(d)}")
    bad = [msg for ok, msg in loop_lines_checks(d) + [
        (same, "the ranks' maps differ"),
        (all(o["world"] == 2 and o["all_reduce"] > 0 for o in out),
         "a rank did not take the distributed route")] if not ok]
    if bad:
        raise AssertionError("dist_ranks: " + "; ".join(bad))
    return dict(dryrun_s=dry_s, ranks_s=ranks_s,
                correct_ms=[o["ms"] for o in out],
                gba_ms=[o["gba_ms"] for o in out])


def sweep_config():
    """The JAX bench's multi-sequence config (bench.py:376-379): 640x240,
    600 features, min_init_points 80."""
    from lldslam_tpu_torch.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu_torch.ops.orb import OrbConfig
    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0, bf=200.0,
                           fps=10.0, width=640, height=240)
    return SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80))


def keep_batched(mod, name: str, dim: int, armed: list, site=None):
    """Wraps mod.<name> so that, while armed[0] is set, a copy of the
    arguments of its last call whose first tensor has `dim` dims (a batched
    call; at `site`, where given) is kept; returns (kept, restore)."""
    fn, kept = getattr(mod, name), []

    def wrapper(*args, **kw):
        if armed[0] and args[0].dim() == dim and (site is None
                                                   or kw.get("site") == site):
            kept[:] = [tuple(a.clone() if torch.is_tensor(a) else a
                             for a in args)]
        return fn(*args, **kw)

    setattr(mod, name, wrapper)
    return kept, lambda: setattr(mod, name, fn)


def count_calls(cls, name: str, counter: list):
    """Wraps cls.<name> so that each call adds one to counter[0]."""
    fn = getattr(cls, name)

    def wrapper(*args, **kw):
        counter[0] += 1
        return fn(*args, **kw)

    setattr(cls, name, wrapper)
    return lambda: setattr(cls, name, fn)


def drive_driver(drv, seqs, frames, label: str, t0: float = 0.0) -> dict:
    """Frames `frames` of every sequence through drv.process, each frame
    synchronised: per-frame ms, launch deltas, batched sequences and the
    solo tracking steps (a sequence off the batch, or a weak-motion
    fallback) of each frame."""
    from lldslam_tpu_torch.pipeline.tracker import StereoTracker
    solo_steps = [0]
    restore = count_calls(StereoTracker, "_run_step", solo_steps)
    rows = []
    try:
        for i in frames:
            c0, n0 = read_counts(), solo_steps[0]
            t = time.perf_counter()
            res = drv.process([s[i] for s in seqs], [t0 + i * 0.1] * len(seqs))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            c1 = read_counts()
            rows.append(dict(
                frame=i, ms=ms, states=[m.state for _, m in res],
                batched=sum(m.t_dispatch > 0 for _, m in res),
                new_kf=sum(m.new_kf for _, m in res),
                solo_steps=solo_steps[0] - n0,
                k1a=c1["k1a"] - c0["k1a"], k1b=c1["k1b"] - c0["k1b"],
                k2g_tracking=c1["k2g_sites"].get("tracking", 0)
                - c0["k2g_sites"].get("tracking", 0)))
            r = rows[-1]
            log(f"{label} frame {i:2d}: {r['states'].count('OK')}/{len(seqs)} "
                f"OK, {r['batched']} batched, {r['new_kf']} keyframes, "
                f"launches K1a {r['k1a']} K1b {r['k1b']} K2g tracking "
                f"{r['k2g_tracking']} (solo steps {r['solo_steps']}), "
                f"{ms:.1f} ms")
    finally:
        restore()
    return rows


def check_batched_launches(rows, n_seq: int, label: str) -> int:
    """Every frame after the first batched all n_seq sequences, with one
    launch each of K1a and K1b and one K2g launch at the tracking site for
    the batch (plus one for each solo tracking step). Returns the number
    of batched frames."""
    bad = [r for r in rows[1:] if r["batched"] != n_seq or r["k1a"] != 1
           or r["k1b"] != 1 or r["k2g_tracking"] != 1 + r["solo_steps"]]
    if bad or any(s != "OK" for r in rows for s in r["states"]):
        raise AssertionError(f"{label}: frames off the batched contract or "
                             f"not OK: {bad or rows}")
    return len(rows) - 1


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def profile_window(step, n: int) -> dict:
    """One torch.profiler window over n calls of step(): device operations
    (kernels, copies, fills) per frame, the device-busy share of the
    window's host time (the union of the device intervals), and ms a frame
    under the profiler. The window is complete if it kept a device record
    for at least 99% of the kernel launches its host records show; the
    H100's profiler has dropped device records, so an incomplete window is
    logged and its busy share reported as None (not measured)."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    # a first session after a long unprofiled stretch may miss device
    # operations: one short session first, discarded
    _profile(lambda: torch.ones(1, device="cuda").add_(1))
    wall = []

    def frames():
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall.append(1e6 * (time.perf_counter() - t))

    events = _profile(frames)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev)
    launched = sum(e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS
                   for e in events)
    kept = kernels / launched if launched else 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    wall_us = wall[0]
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    out = dict(ops_per_frame=len(spans) / n, kernels_per_frame=kernels / n,
               launches_per_frame=launched / n, kept=kept,
               busy_ms=busy / 1e3 / n, ms_per_frame=wall_us / 1e3 / n,
               busy_share=busy / wall_us)
    if kept < 0.99:
        log(f"profile_window: incomplete, {kernels} kernel records for "
            f"{launched} launches; busy share not measured")
        out["busy_share"] = out["busy_ms"] = None
    return out


def _window(p: dict) -> str:
    busy = ("busy not measured" if p["busy_share"] is None else
            f"busy {p['busy_ms']:.2f} of {p['ms_per_frame']:.1f} ms "
            f"({100 * p['busy_share']:.2f}%)")
    return (f"{p['ops_per_frame']:.0f} device operations a frame "
            f"({p['kernels_per_frame']:.0f} kernels of "
            f"{p['launches_per_frame']:.0f} launches), {busy}")


def batched_kernel_rows(kept_a, kept_b, kept_g) -> dict:
    """The last batched frame's K1a, K1b and K2g (tracking site) arguments:
    each kernel exact against its plain version, each sequence's slice
    exact against an S = 1 launch on that sequence alone; the device time
    of the batched launch, its bound (the S single-frame works summed) and
    the plain version's ms."""
    from lldslam_tpu_torch.ops import match_best2 as mb
    from lldslam_tpu_torch.ops import orb_describe, stereo_sad
    out = {}
    cases = (
        ("k1a", orb_describe.describe, orb_describe.describe_plain, kept_a,
         lambda a, s: (a[0][s], a[1][s], a[2][s], a[3][s], a[4])),
        ("k1b", stereo_sad.sad_refine, stereo_sad.sad_refine_plain, kept_b,
         lambda a, s: (a[0][s], a[1], a[2][s], a[3][s], a[4][s], a[5][s])),
        ("k2g", mb.gated_best2, mb.gated_best2_plain, kept_g,
         lambda a, s: tuple(x[s] for x in a)))
    for key, fn, plain, kept, part in cases:
        (args,) = kept
        n_seq = args[0].shape[0]
        got = fn(*args)
        err = _exact(f"multiseq {key} S={n_seq}", got, plain(*args))
        for s in range(n_seq):
            _exact(f"multiseq {key} sequence {s} against S = 1",
                   [g[s] for g in got], fn(*part(args, s)))
        if key == "k1a":
            work = [k1a_work(part(args, s), got[0][s]) for s in range(n_seq)]
            n_bytes, n_ops = sum(w[0] for w in work), sum(w[1] for w in work)
            shape = f"n={args[2].shape[1]} over {args[0].shape[1]} images"
        elif key == "k1b":
            work = [k1b_work(part(args, s)) for s in range(n_seq)]
            n_bytes, n_ops = sum(w[0] for w in work), sum(w[1] for w in work)
            shape = f"n={args[2].shape[1]}"
        else:
            M, N = args[0].shape[1], args[7].shape[1]
            gated = int(mb.gate_mask(*args[1:7], *args[8:]).sum())
            n_bytes = n_seq * (M * (32 + 16 + 4 + 1 + 16)
                               + N * (32 + 8 + 4 + 4 + 1))
            n_ops = 3 * n_seq * M * N + 23 * gated
            shape = f"M={M} N={N}, {gated} gated pairs"
        ms = device_ms(lambda: fn(*args))
        b_ms, by = bound(n_bytes, n_ops)
        out[key] = dict(S=n_seq, ms=ms, plain_ms=cuda_ms(lambda: plain(*args)),
                        bound_ms=b_ms, bound_by=by, max_abs_err=err,
                        share=b_ms / ms)
        log(f"multiseq: {key} S={n_seq} {shape}: exact against the plain "
            f"version and each sequence against an S = 1 launch; "
            f"{ms:.4f} ms on the device, plain {out[key]['plain_ms']:.4f} ms, "
            f"bound {b_ms:.5f} ms ({by}), {100 * b_ms / ms:.1f}% of bound")
    return out


def phase_multiseq(dev) -> dict:
    """S = 4 KITTI-size corridors through MultiSequenceDriver against their
    solo Systems; then S = 13 at the bench's multi-sequence config."""
    from lldslam_tpu_torch.io.synthetic import make_sequence
    from lldslam_tpu_torch.ops import (match_best2, orb_describe, pose_lm,
                                       stereo_sad)
    from lldslam_tpu_torch.parallel.multi_seq import MultiSequenceDriver
    from lldslam_tpu_torch.pipeline import tracker as tmod
    from lldslam_tpu_torch.system import System

    cfg = kitti_config()
    cam = cfg.camera.stereo_camera()
    n_seq, n_all = len(MULTISEQ_SEEDS), MULTISEQ_FRAMES + PROFILE_FRAMES
    t0 = time.perf_counter()
    seqs = [make_sequence(cam, n_all, seed=seed) for seed in MULTISEQ_SEEDS]
    log(f"multiseq: generated {n_seq} x {n_all} frames in "
        f"{time.perf_counter() - t0:.1f} s")

    # solo: each sequence through its own System, view capacity pinned
    solo, solo_ms = [], []
    for s, frames in enumerate(seqs):
        sys_ = System(cfg, enable_loops=False, device=dev)
        sys_.warmup()
        sys_.tracker.mapper.fixed_tv_cap = MULTISEQ_VIEW_CAP
        ms, metrics = track(sys_, frames[:MULTISEQ_FRAMES],
                            label=f"multiseq solo {s}")
        if any(m.state != "OK" for m in metrics):
            raise AssertionError(f"multiseq: solo sequence {s} not OK")
        solo.append(sys_)
        solo_ms.extend(ms[1:])

    drv = MultiSequenceDriver(cfg, n_seq, enable_loops=False,
                              view_cap=MULTISEQ_VIEW_CAP, device=dev)
    armed = [False]
    kept_a, ra = keep_batched(orb_describe, "describe", 4, armed)
    kept_b, rb = keep_batched(stereo_sad, "sad_refine", 4, armed)
    kept_g, rg = keep_batched(match_best2, "gated_best2", 3, armed,
                              site="tracking")
    kept_lm, rlm = keep_inputs(pose_lm, "pose_lm", sites=("track",))
    cores = [0]
    rc = count_calls(tmod, "_track_core", cores)
    try:
        reset_counts()
        rows = drive_driver(drv, seqs, range(MULTISEQ_FRAMES - 1), "multiseq")
        armed[0] = True
        rows += drive_driver(drv, seqs, [MULTISEQ_FRAMES - 1], "multiseq")
        counts = read_counts()
    finally:
        ra(), rb(), rg(), rlm(), rc()
    n_batched = check_batched_launches(rows, n_seq, "multiseq")
    kernels = batched_kernel_rows(kept_a, kept_b, kept_g)
    need_lm_launches(counts, cores[0], "multiseq")
    kernels["pose_lm"] = hold_pose_lm(
        "multiseq, last batched frame's",
        [k for k in kept_lm if k[1][1].shape[0] == n_seq][-2:], timed=True)

    # parity with the solo runs
    parity = []
    for s, (tr, ref) in enumerate(zip(drv.trackers, solo)):
        _, T = tr.trajectory()
        _, T_solo = ref.tracker.trajectory()
        dc = np.linalg.norm(T[:, :3, 3] - T_solo[:, :3, 3], axis=-1)
        parity.append(dict(max_centre_diff=float(dc.max()),
                           kf=tr.store.n_kf, kf_solo=ref.map.n_kf))
        log(f"multiseq: sequence {s} (seed {MULTISEQ_SEEDS[s]}): camera "
            f"centres within {dc.max():.5f} m of its solo run; keyframes "
            f"{tr.store.n_kf} batched, {ref.map.n_kf} solo")
    bad = [p for p in parity if p["max_centre_diff"] >= MULTISEQ_BOUND_M
           or abs(p["kf"] - p["kf_solo"]) > 1]
    if bad:
        raise AssertionError(f"multiseq: sequences off their solo runs: "
                             f"{parity}")

    batched_ms = [r["ms"] for r in rows[1:]]
    seq_fps = 1e3 * n_seq * len(batched_ms) / sum(batched_ms)
    solo_fps = 1e3 * len(solo_ms) / sum(solo_ms)
    # one profiler window each: 5 batched frames, 5 frames of solo sequence 0
    frame_b, frame_s = (iter(range(MULTISEQ_FRAMES, n_all)) for _ in "bs")

    def batched_frame():
        i = next(frame_b)
        drv.process([s[i] for s in seqs], [0.1 * i] * n_seq)

    def solo_frame():
        i = next(frame_s)
        solo[0].track_stereo(*seqs[0][i], timestamp=0.1 * i)

    prof_b = profile_window(batched_frame, PROFILE_FRAMES)
    prof_s = profile_window(solo_frame, PROFILE_FRAMES)
    log(f"multiseq: S={n_seq}: ms per batched frame median "
        f"{statistics.median(batched_ms):.1f} p90 "
        f"{float(np.percentile(batched_ms, 90)):.1f} over {n_batched} frames; "
        f"{seq_fps:.2f} sequence-frames/s batched against {solo_fps:.2f} "
        f"frames/s solo (ms/frame median {statistics.median(solo_ms):.1f}); "
        f"launches {counts}")
    log(f"multiseq: profiler window of {PROFILE_FRAMES} frames: batched "
        f"S={n_seq} {_window(prof_b)}; solo {_window(prof_s)}")
    out = dict(counts=counts, kernels=kernels, parity=parity,
               batched_ms=batched_ms, solo_ms=solo_ms, seq_fps=seq_fps,
               solo_fps=solo_fps, profile_batched=prof_b, profile_solo=prof_s)
    del drv, solo

    # S = 13 at the bench's multi-sequence config
    cfg13 = sweep_config()
    cam13 = cfg13.camera.stereo_camera()
    seqs13 = [make_sequence(cam13, SWEEP_FRAMES, seed=seed)
              for seed in SWEEP_SEEDS]
    drv13 = MultiSequenceDriver(cfg13, len(seqs13), enable_loops=False,
                                device=dev)
    reset_counts()
    rows13 = drive_driver(drv13, seqs13, range(SWEEP_FRAMES), "multiseq_13")
    counts13 = read_counts()
    check_batched_launches(rows13, len(seqs13), "multiseq_13")
    ms13 = [r["ms"] for r in rows13[1:]]
    fps13 = 1e3 * len(seqs13) * len(ms13) / sum(ms13)
    log(f"multiseq_13: S={len(seqs13)} 640x240: every frame OK; ms per "
        f"batched frame median {statistics.median(ms13):.1f} p90 "
        f"{float(np.percentile(ms13, 90)):.1f}; {fps13:.2f} "
        f"sequence-frames/s; launches {counts13}")
    out["sweep"] = dict(counts=counts13, ms=ms13, seq_fps=fps13,
                        first_frame_ms=rows13[0]["ms"])
    out["seqs"] = seqs
    return out


def _hold_kernels(label, kept_a, kept_b, kept_g) -> dict:
    """K1a and K1b on the kept inputs of a pipelined run's last frame
    build, K2g on its last call at the tracking site (the chained step) and
    at the fusion site (the staged keyframe stage): each exact against its
    plain version."""
    from lldslam_tpu_torch.ops import match_best2 as mb
    from lldslam_tpu_torch.ops import orb_describe, stereo_sad
    sites = sorted(site for site, _ in kept_g)
    if sites != ["fusion", "tracking"]:
        raise AssertionError(f"{label}: K2g kept at the sites {sites}")
    out = {}
    for key, fn, plain, kept in (
            ("k1a", orb_describe.describe, orb_describe.describe_plain,
             kept_a),
            ("k1b", stereo_sad.sad_refine, stereo_sad.sad_refine_plain,
             kept_b),
            ("k2g", mb.gated_best2, mb.gated_best2_plain, kept_g)):
        for site, args in kept:
            name = key if site is None else f"{key} at the {site} site"
            out[name] = _exact(f"{label}, last {name}", fn(*args),
                               plain(*args))
    log(f"{label}: K1a, K1b (the last frame build) and K2g (its last call "
        f"at the tracking and at the fusion site) exact against their plain "
        f"versions")
    return out


def run_pipelined(dev, cfg, frames, label: str, lines: bool = False,
                  measure: bool = True, profile: bool = True,
                  native: bool = False, n_profile: int = PIPE_PROFILE
                  ) -> dict:
    """The JAX bench's headline schedule through System(cfg,
    pipeline=True): warmup, PIPE_WARM frames through track_stereo, the
    rest staged by stage_stereo (with `lines`, their stored detections by
    stage_stored_pair; with `native`, cfg has lines and no detections, so
    the tracker runs the line detector on both views) and passed as
    pair_dev, then flush. Kernel launches counted over the staged frames
    and the flush, per-call host ms (no per-frame synchronisation: a call
    dispatches its frame and finalizes older ones); with `measure` and
    `profile` the last `n_profile` staged frames inside one profiler
    window; with `measure` the host syncs of one steady-state dispatch
    (the chained step on its last inputs; with `native` the whole dispatch
    of the last staged pair: frame build, the detector on both views, the
    stereo line match and the chained line step), and K1a, K1b and K2g
    (at both its sites) held to their plain versions on their last calls'
    inputs."""
    from lldslam_tpu_torch.io.stored_lines import stage_stored_pair
    from lldslam_tpu_torch.ops import (match_best2, orb_describe, pose_lm,
                                       stereo_sad)
    from lldslam_tpu_torch.pipeline import tracker as tmod
    from lldslam_tpu_torch.system import System

    sys_ = System(cfg, pipeline=True, device=dev)
    sys_.warmup()
    tr = sys_.tracker
    warm_ms = []
    for i in range(PIPE_WARM):
        t = time.perf_counter()
        _, m = sys_.track_stereo(*frames[i], timestamp=0.1 * i)
        torch.cuda.synchronize()
        warm_ms.append(1e3 * (time.perf_counter() - t))
        log(f"{label} warm frame {i}: finalized "
            f"{'none' if m is None else f'{m.frame_id} {m.state}'}, "
            f"{warm_ms[-1]:.1f} ms")
    staged_lines = [None] * len(frames)
    if lines:
        src = tr._line_source
        staged_lines = [stage_stored_pair(src[0], src[1], i, device=dev)
                        for i in range(len(frames))]
    staged = [(i, sys_.stage_stereo(*frames[i]), staged_lines[i])
              for i in range(PIPE_WARM, len(frames))]
    torch.cuda.synchronize()
    profile = measure and profile
    n_meas = len(staged) - (n_profile if profile else 0)
    step_name = "_track_step_chained_lines" if lines or native \
        else "_track_step_chained"
    cores = [0]
    restore = [count_calls(tmod, "_track_core", cores)]
    if measure:
        kept_step, r = keep_inputs(tmod, step_name, last_only=True)
        restore.append(r)
        kept_a, r = keep_inputs(orb_describe, "describe", last_only=True)
        restore.append(r)
        kept_b, r = keep_inputs(stereo_sad, "sad_refine", last_only=True)
        restore.append(r)
        kept_g, r = keep_inputs(match_best2, "gated_best2",
                                sites=("tracking", "fusion"), last_only=True)
        restore.append(r)
        kept_lm, r = keep_inputs(pose_lm, "pose_lm",
                                 sites=("track", "line"))
        restore.append(r)
    results, ms = [], []
    feed = iter(staged)

    def one():
        i, h, lv = next(feed)
        results.append(sys_.track_stereo(None, None, timestamp=0.1 * i,
                                         pair_dev=h, lines_dev=lv))

    prof = None
    try:
        reset_counts()
        cores[0] = 0
        for _ in range(n_meas):
            t = time.perf_counter()
            one()
            ms.append(1e3 * (time.perf_counter() - t))
        if profile:
            prof = profile_window(one, n_profile)
        t = time.perf_counter()
        sys_.flush()
        torch.cuda.synchronize()
        flush_ms = 1e3 * (time.perf_counter() - t)
        counts = read_counts()
    finally:
        for r in restore:
            r()
    need_lm_launches(counts, cores[0], label)
    metrics = tr.metrics
    _, T_wc = tr.trajectory()
    out = dict(
        counts=counts, tracker=tr, T_wc=T_wc, metrics=metrics,
        states=[m.state for m in metrics],
        kf_frames=[m.frame_id for m in metrics if m.new_kf],
        ms=ms, warm_ms=warm_ms, flush_ms=flush_ms, profile=prof,
        finalized_in_calls=[m.frame_id for _, m in results if m is not None],
        t_get_ms=[1e3 * m.t_get for m in metrics if m.t_get > 0],
        t_dispatch_ms=[1e3 * m.t_dispatch for m in metrics[PIPE_WARM:]])
    log(f"{label}: staged frames {PIPE_WARM}-{len(frames) - 1}: per call "
        f"ms median {statistics.median(ms):.1f} p90 "
        f"{float(np.percentile(ms, 90)):.1f} mean "
        f"{statistics.mean(ms):.1f} over {n_meas} unprofiled calls; flush "
        f"{flush_ms:.1f} ms; the chained step's dispatch ms median "
        f"{statistics.median(out['t_dispatch_ms']):.2f}; host wait on the "
        f"window copies ms {[round(x, 2) for x in out['t_get_ms']]}; "
        f"keyframes at {out['kf_frames']}; launches {counts}")
    if measure:
        args = kept_step[-1][1]
        step = getattr(tmod, step_name)
        if native:
            pair = staged[-1][1]
            step = native_dispatch(tr, pair, step)
        out["dispatch_syncs"] = host_syncs(lambda: step(*args))
        if native:
            out["dispatch_waits"] = {
                k: host_waits(fn) for k, fn in native_pieces(tr, pair).items()}
        out["kernels_exact"] = _hold_kernels(label, kept_a, kept_b, kept_g)
        # the last chained step's two point LMs, and with lines its joint
        # point+line LM
        n_lm = 3 if lines or native else 2
        if lines or native:
            assert [k[0] for k in kept_lm[-3:]] == ["track", "track", "line"]
        out["pose_lm"] = hold_pose_lm(f"{label}, last chained step's",
                                      kept_lm[-n_lm:],
                                      gamma=float(cfg.line.gamma))
        log(f"{label}: host syncs in one steady-state dispatch: "
            f"{out['dispatch_syncs']}" + (
                f"; profiler window of {n_profile} staged frames: "
                f"{_window(prof)}" if profile else ""))
    return out


def native_dispatch(tr, pair, step):
    """The device work of one pipelined frame on the native-line route,
    as a function of the chained step's arguments: the frame build of
    `pair`, the line detector on both views, the stereo line match and
    `step` (its `cur_fl` replaced by this match)."""
    from lldslam_tpu_torch.frontend import frame, line_extract, line_match

    def run(*args):
        frame.build_frame_pair(pair, tr.cam, tr.orb)
        kl = line_extract.detect_lines(pair[0], tr.line_cfg)
        kr = line_extract.detect_lines(pair[1], tr.line_cfg)
        fl = line_match.match_stereo_lines(
            tr.cam, kl, kr, md_thr=tr._md_gate,
            min_len=tr.cfg.line.min_line_len)
        return step(*args[:-3], fl, *args[-2:])
    return run


def native_pieces(tr, pair) -> dict:
    """The parts of a native-line dispatch before the chained step, as
    functions, each under WAIT_TEST_LAUNCHES kernel launches so that
    host_waits can tell: the frame build of `pair` (frame.build_frame_batch)
    as its pyramid, each level's detection, the descriptors and the stereo
    match, each on the outputs of the pieces before it (computed here
    once); the detector on each view; the stereo line match (of the pair's
    detections). The chained step itself launches more than the queue
    holds, so sync debug mode alone covers it."""
    from lldslam_tpu_torch.frontend import line_extract, line_match
    from lldslam_tpu_torch.ops import image, orb, stereo
    cfg = tr.orb
    stack = pair[None].to(torch.float32)
    pyramid = lambda: image.build_pyramid(stack, cfg.n_levels, cfg.scale,
                                          quantize=True)
    pyr = pyramid()
    pyr_stack = orb.stack_levels(pyr)
    budgets = cfg.per_level_budget()
    levels = [orb.detect_level(im, n, cfg) for im, n in zip(pyr, budgets)]
    kp = orb.describe_levels(pyr, levels, cfg, pyr_stack)
    level_hw = [tuple(p.shape[-2:]) for p in pyr]
    detect = lambda v: line_extract.detect_lines(pair[v], tr.line_cfg)
    kl, kr = detect(0), detect(1)
    pieces = dict(build_pyramid=lambda: orb.stack_levels(pyramid()))
    for l, (im, n) in enumerate(zip(pyr, budgets)):
        pieces[f"build_level_{l}"] = \
            lambda im=im, n=n: orb.detect_level(im, n, cfg)
    pieces.update(
        build_describe=lambda: orb.describe_levels(pyr, levels, cfg,
                                                   pyr_stack),
        build_stereo=lambda: stereo.match_stereo(
            kp.view_of(0), kp.view_of(1), pyr_stack, level_hw, tr.cam, cfg),
        detect_left=lambda: detect(0), detect_right=lambda: detect(1),
        match=lambda: line_match.match_stereo_lines(
            tr.cam, kl, kr, md_thr=tr._md_gate,
            min_len=tr.cfg.line.min_line_len))
    return pieces


def _parity(label, out, ref_kf, ref_T, bound_m, cpu_kf) -> list:
    """Checks of a pipelined run against its synchronous reference and the
    keyframes of the port's own pipelined run of it on the CPU."""
    dc = np.linalg.norm(out["T_wc"][:, :3, 3] - ref_T[:, :3, 3], axis=-1)
    out["max_centre_diff"] = float(dc.max())
    log(f"{label}: keyframes {out['kf_frames']} against the synchronous "
        f"run's {ref_kf}; camera centres within {dc.max():.5f} m of it")
    fids = [m.frame_id for m in out["metrics"]]
    kf = out["kf_frames"]
    return [
        (all(x == "OK" for x in out["states"]), f"states {out['states']}"),
        (fids == list(range(len(ref_T))), f"finalized frames {fids}"),
        # the device decision lags the host's reference count, so the
        # keyframes move off the synchronous run's (the JAX package's own
        # pipelined CPU run makes 10 keyframes to its synchronous 8 on the
        # main world); the schedule reads no clock, so the card's keyframes
        # are the CPU's
        (kf == list(cpu_kf), f"keyframes {kf}, the CPU's {list(cpu_kf)}"),
        (dc.max() < bound_m, f"centres {dc.max()} m from the synchronous "
                             f"run"),
        (out["dispatch_syncs"] == 0,
         f"{out['dispatch_syncs']} host syncs in a dispatch"),
        (len(out["finalized_in_calls"]) >= 1,
         "no frame finalized before the flush"),
    ]


def phase_pipelined(dev, frames, poses, main) -> dict:
    """The main path's config and world through the pipelined System (the
    JAX bench's headline), loops on, against the synchronous main path."""
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    out = run_pipelined(dev, kitti_config(), frames, "pipelined")
    # the same schedule again: on the card the device runs behind the host
    # by a varying amount, and nothing in the schedule may depend on it
    again = run_pipelined(dev, kitti_config(), frames, "pipelined again",
                          measure=False)
    d2 = float(np.linalg.norm(again["T_wc"][:, :3, 3]
                              - out["T_wc"][:, :3, 3], axis=-1).max())
    same = np.array_equal(again["T_wc"], out["T_wc"])
    out.update(again_kf_frames=again["kf_frames"], again_centre_diff=d2,
               again_bit_equal=same, again_ms=again["ms"])
    log(f"pipelined: a second run: keyframes {again['kf_frames']}, camera "
        f"centres within {d2:.2e} m of the first, every pose bit-equal "
        f"{same}")
    gt = np.stack([np.linalg.inv(p) for p in poses])
    out["ate"] = ate_rmse(out["T_wc"], gt)
    sync_ms = main["ms"][PIPE_WARM:]
    out["sync_ms"] = sync_ms
    lc = out["tracker"].loop_closer
    log(f"pipelined: ATE {out['ate']:.5f} m (bound {PIPE_ATE_BOUND_M:.5f}); "
        f"synchronous main path ms/frame over the same frames median "
        f"{statistics.median(sync_ms):.1f} p90 "
        f"{float(np.percentile(sync_ms, 90)):.1f}; synchronous median less "
        f"pipelined median {statistics.median(sync_ms) - statistics.median(out['ms']):.1f} "
        f"ms (its read-back {statistics.median(main['read_back_ms'][PIPE_WARM:]):.2f} "
        f"ms median); loop closer keyframes "
        f"{lc.stage_times.get('n', 0)} (staged words "
        f"{lc.stage_times.get('n_words_staged', 0)}), events {len(lc.events)}")
    checks = _parity("pipelined", out, main["kf_frames"], main["T_wc"],
                     PIPE_CENTRE_BOUND_M, PIPE_KF_CPU)
    s = out["tracker"].store
    checks += [
        (out["ate"] <= PIPE_ATE_BOUND_M, f"ATE {out['ate']} m"),
        (again["kf_frames"] == out["kf_frames"] and same,
         f"second run: keyframes {again['kf_frames']}, centres {d2} m, "
         f"bit-equal {same}"),
        (lc.stage_times.get("n", 0) == s.n_kf,
         f"{lc.stage_times.get('n', 0)} keyframes through the loop closer, "
         f"{s.n_kf} exist"),
        (not lc.events, f"loop event on a corridor: {lc.events}")]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("pipelined: " + "; ".join(bad))
    need_launches(out["counts"], "pipelined", ("tracking", "fusion"))
    return out


def phase_pipelined_lines(dev, frames, poses, sync_lines) -> dict:
    """The stored-line world through the pipelined System (the JAX bench's
    lines section), loops on, against the synchronous lines run."""
    import dataclasses
    from lldslam_tpu_torch.config import LineConfig
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    left, right = sync_lines["detections"]
    cfg = dataclasses.replace(kitti_config(), line=LineConfig(
        ld_type="LBDFloat", md_thr=0.6, detections_path=left,
        descriptors_path=right))
    # no profiler window here: the main world's is the phase's busy share,
    # and a lines frame's 32,000 device records cost the script ~30 s
    out = run_pipelined(dev, cfg, frames, "pipelined_lines", lines=True,
                        profile=False)
    gt = np.stack([np.linalg.inv(p) for p in poses])
    out["ate"] = ate_rmse(out["T_wc"], gt)
    lm = [m.n_line_matches for m in out["metrics"]]
    s = out["tracker"].store
    out.update(line_matches=lm, n_lines=int(s.ln_valid.sum()))
    log(f"pipelined_lines: ATE {out['ate']:.5f} m (synchronous "
        f"{sync_lines['ate']:.5f}); line matches per frame {lm}; valid map "
        f"lines {out['n_lines']} (synchronous {sync_lines['n_lines']}); "
        f"staged line solves left {len(s._pending_retri)}")
    checks = _parity("pipelined_lines", out, sync_lines["kf_frames"],
                     sync_lines["T_wc"], PIPE_LINES_CENTRE_BOUND_M,
                     PIPE_LINES_KF_CPU)
    checks += [
        (out["ate"] <= PIPE_LINES_ATE_BOUND_M, f"ATE {out['ate']} m"),
        (PIPE_LINE_MATCH_RANGE[0] <= statistics.median(lm[1:])
         <= PIPE_LINE_MATCH_RANGE[1],
         f"line matches median {statistics.median(lm[1:])}"),
        (out["n_lines"] > 0 and not s._pending_retri,
         f"map lines {out['n_lines']}, unwritten solves "
         f"{len(s._pending_retri)}")]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("pipelined_lines: " + "; ".join(bad))
    need_launches(out["counts"], "pipelined_lines", ("tracking", "fusion"))
    return out


def phase_pipelined_native_lines(dev, frames, poses, native) -> dict:
    """The lines world through the pipelined System on the native detector
    (ldType LBDFloat, mdThr 0.6, no detections path: the tracker detects
    lines on both views of every frame), loops on, on the JAX bench's
    headline schedule with a profiler window of PIPE_NATIVE_PROFILE
    frames, against the synchronous native run of the native_lines phase
    (`native`, the CLI on the same frames as PNGs), the JAX package's
    pipelined CPU run of this world (PIPE_NATIVE_LINE_MATCHES_JAX) and the
    keyframes of the port's own (PIPE_NATIVE_KF_CPU)."""
    import dataclasses
    from lldslam_tpu_torch.config import LineConfig
    from lldslam_tpu_torch.io.trajectory import ate_rmse
    cfg = dataclasses.replace(kitti_config(), line=LineConfig(
        ld_type="LBDFloat", md_thr=0.6))
    out = run_pipelined(dev, cfg, frames, "pipelined_native_lines",
                        native=True, n_profile=PIPE_NATIVE_PROFILE)
    gt = np.stack([np.linalg.inv(p) for p in poses])
    out["ate"] = ate_rmse(out["T_wc"], gt)
    lm = [m.n_line_matches for m in out["metrics"]]
    s = out["tracker"].store
    sync_lm = statistics.median(native["line_matches"][1:])
    sync_ms = native["ms"][PIPE_WARM:]
    out.update(line_matches=lm, n_lines=int(s.ln_valid.sum()),
               sync_ms=sync_ms, sync_line_matches_median=sync_lm)
    log(f"pipelined_native_lines: ATE {out['ate']:.5f} m (synchronous "
        f"{native['ate']:.5f}); line matches per frame {lm}, median "
        f"{statistics.median(lm[1:])} (synchronous {sync_lm}); valid map "
        f"lines {out['n_lines']}; per call ms median "
        f"{statistics.median(out['ms']):.1f} against the synchronous native "
        f"run's {statistics.median(sync_ms):.1f} ms a frame over the same "
        f"frames; staged line solves left {len(s._pending_retri)}; the "
        f"dispatch's parts behind a spin kernel: " + json.dumps(
            {k: [v["waits"], v["launches"], round(v["host_ms"], 2),
                 round(v["spin_ms"], 2)]
             for k, v in out["dispatch_waits"].items()}) + " (waits, kernel "
        f"launches, host ms behind the spin, spin ms; a verdict counts for "
        f"at most {min(WAIT_TEST_LAUNCHES, launch_queue_depth()['depth'])} "
        f"launches)")
    checks = _parity("pipelined_native_lines", out, native["kfs"],
                     native["T_wc"], PIPE_LINES_CENTRE_BOUND_M,
                     PIPE_NATIVE_KF_CPU)
    # the line matches against the JAX package's pipelined run of the
    # world; the synchronous run's median (1) is logged, not bound: both
    # packages' pipelined routes starve the association (ROADMAP section 3)
    ref = PIPE_NATIVE_LINE_MATCHES_JAX
    lo, hi = PIPE_NATIVE_LINE_MATCH_SHARE
    med, ref_med = statistics.median(lm[1:]), statistics.median(ref[1:])
    out.update(line_matches_jax=list(ref), line_matches_median=med,
               line_matches_equal_jax=lm == list(ref))
    log(f"pipelined_native_lines: line matches median {med} (the JAX "
        f"package's pipelined run {ref_med}, the synchronous native run "
        f"{sync_lm}: not held), total {sum(lm)} (JAX pipelined {sum(ref)}); "
        f"frame for frame the JAX pipelined run's: "
        f"{out['line_matches_equal_jax']}")
    checks += [
        (out["ate"] <= ATE_BOUND_M, f"ATE {out['ate']} m"),
        (lo * ref_med <= med <= hi * ref_med
         and lo * sum(ref) <= sum(lm) <= hi * sum(ref),
         f"line matches {lm}, the JAX pipelined run's {list(ref)}"),
        (out["n_lines"] > 0 and not s._pending_retri,
         f"map lines {out['n_lines']}, unwritten solves "
         f"{len(s._pending_retri)}"),
        # every part before the chained step within the queue, no wait
        (all(w["conclusive"] and not w["waits"]
             for w in out["dispatch_waits"].values()),
         f"a part of the dispatch waited or outran the launch queue: "
         f"{out['dispatch_waits']}"),
        # the vote: two detector calls a staged frame
        (out["counts"]["segsum"] >= 2 * (len(frames) - PIPE_WARM),
         f"segment-sum launches {out['counts']['segsum']}")]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise AssertionError("pipelined_native_lines: " + "; ".join(bad))
    need_launches(out["counts"], "pipelined_native_lines",
                  ("tracking", "fusion"))
    return out


def phase_cold_start() -> dict:
    """tools/torch_cold_start.py in two fresh processes (no JAX): one that
    runs each rare path cold, one that calls System.warmup first and then
    runs each path; each then runs COLD_REPS more rounds of every path,
    whose readings, pooled, give the warm median."""
    runs = {}
    for key, extra in (("cold", []), ("warmed", ["--warmup"])):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "tools/torch_cold_start.py",
                            "--reps", str(COLD_REPS), *extra],
                           capture_output=True, text=True,
                           timeout=COLD_TIMEOUT_S)
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            raise AssertionError(f"cold_start {key}: exit {p.returncode}: "
                                 f"{p.stdout[-2000:]} {p.stderr[-3000:]}")
        runs[key] = json.loads(lines[-1])
        runs[key]["process_s"] = time.perf_counter() - t
    cold, warmed = runs["cold"]["paths"], runs["warmed"]["paths"]
    table = {}
    for name in cold:
        a, b = cold[name]["ms"], warmed[name]["ms"]
        w = statistics.median(a[1:] + b[1:])
        table[name] = dict(cold_ms=a[0], after_warmup_ms=b[0],
                           warm_median_ms=w, cold_ratio=a[0] / w,
                           after_warmup_ratio=b[0] / w, readings_cold=a,
                           readings_warmed=b)
        log(f"cold_start {name}: first call {a[0]:.1f} ms cold, {b[0]:.1f} "
            f"ms after System.warmup, warm median {w:.1f} ms of "
            f"{len(a) + len(b) - 2} (ratios {a[0] / w:.2f} / {b[0] / w:.2f})")
    log(f"cold_start: System.warmup {runs['warmed']['warmup_s']:.2f} s; "
        f"processes {runs['cold']['process_s']:.1f} / "
        f"{runs['warmed']['process_s']:.1f} s; {runs['cold']['card']}")
    slow = {k: round(v["after_warmup_ratio"], 3) for k, v in table.items()
            if k not in COLD_NOT_HELD
            and v["after_warmup_ratio"] > COLD_AFTER_WARMUP_RATIO}
    if slow:
        raise AssertionError(f"cold_start: first calls after System.warmup "
                             f"over {COLD_AFTER_WARMUP_RATIO}x their warm "
                             f"median: {slow}")
    return dict(paths=table, warmup_s=runs["warmed"]["warmup_s"],
                process_s={k: v["process_s"] for k, v in runs.items()})


def phase_pipelined_multiseq(dev, seqs) -> dict:
    """The multiseq phase's S = 4 KITTI-size corridors (`seqs`, their first
    MULTISEQ_FRAMES frames) through PipelinedMultiSequenceDriver (loops
    off, view capacity 4096) against each sequence's own pipelined System,
    sequence 1 ending after PIPE_MULTISEQ_END frames. The last frame's
    batched K1a, K1b and K2g (tracking site) calls are held to their plain
    versions."""
    from lldslam_tpu_torch.ops import (match_best2, orb_describe, pose_lm,
                                       stereo_sad)
    from lldslam_tpu_torch.parallel.multi_seq import \
        PipelinedMultiSequenceDriver
    from lldslam_tpu_torch.pipeline import tracker as tmod
    from lldslam_tpu_torch.system import System

    cfg = kitti_config()
    n_seq, n = len(MULTISEQ_SEEDS), MULTISEQ_FRAMES
    ends = [PIPE_MULTISEQ_END if s == 1 else n for s in range(n_seq)]
    solo, solo_ms = [], []
    for s, frames in enumerate(seqs):
        sys_ = System(cfg, enable_loops=False, pipeline=True, device=dev)
        sys_.tracker.mapper.fixed_tv_cap = MULTISEQ_VIEW_CAP
        t = time.perf_counter()
        for i in range(ends[s]):
            sys_.track_stereo(*frames[i], timestamp=0.1 * i)
        sys_.flush()
        torch.cuda.synchronize()
        solo_ms.append(1e3 * (time.perf_counter() - t) / ends[s])
        solo.append(sys_.tracker)
    drv = PipelinedMultiSequenceDriver(cfg, n_seq, enable_loops=False,
                                       view_cap=MULTISEQ_VIEW_CAP, device=dev)
    rows, armed = [], [False]
    kept = dict(
        k1a=keep_batched(orb_describe, "describe", 4, armed),
        k1b=keep_batched(stereo_sad, "sad_refine", 4, armed),
        k2g=keep_batched(match_best2, "gated_best2", 3, armed,
                         site="tracking"),
        lm=keep_inputs(pose_lm, "pose_lm", sites=("track",)))
    cores = [0]
    restore_core = count_calls(tmod, "_track_core", cores)
    reset_counts()
    t_all = time.perf_counter()
    for i in range(n):
        c0 = read_counts()
        armed[0] = i == n - 1
        t = time.perf_counter()
        drv.process([seqs[s][i] if i < ends[s] else None
                     for s in range(n_seq)], [0.1 * i] * n_seq)
        armed[0] = False
        c1 = read_counts()
        rows.append(dict(frame=i, ms=1e3 * (time.perf_counter() - t),
                         members=len(drv._members),
                         k1a=c1["k1a"] - c0["k1a"], k1b=c1["k1b"] - c0["k1b"],
                         k2g_tracking=c1["k2g_sites"].get("tracking", 0)
                         - c0["k2g_sites"].get("tracking", 0)))
        r = rows[-1]
        log(f"pipelined_multiseq frame {i:2d}: {r['members']} batched, "
            f"launches K1a {r['k1a']} K1b {r['k1b']} K2g tracking "
            f"{r['k2g_tracking']}, {r['ms']:.1f} ms")
    drv.flush()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t_all)
    counts = read_counts()
    for _, restore in kept.values():
        restore()
    restore_core()
    need_lm_launches(counts, cores[0], "pipelined_multiseq")
    kept_lm = kept.pop("lm")[0]
    lm = hold_pose_lm("pipelined_multiseq, last batched step's",
                      [k for k in kept_lm if k[1][1].shape[0] >= 2][-2:])
    exact = {}
    for key, fn, plain in (
            ("k1a", orb_describe.describe, orb_describe.describe_plain),
            ("k1b", stereo_sad.sad_refine, stereo_sad.sad_refine_plain),
            ("k2g", match_best2.gated_best2, match_best2.gated_best2_plain)):
        (args,) = kept[key][0]
        if args[0].shape[0] < 2:
            raise AssertionError(f"pipelined_multiseq: the last frame's {key} "
                                 f"call has S = {args[0].shape[0]}")
        exact[key] = _exact(f"pipelined_multiseq, last batched {key}",
                            fn(*args), plain(*args))
    log(f"pipelined_multiseq: the last frame's batched K1a, K1b and K2g "
        f"(tracking site, S = {kept['k2g'][0][0][0].shape[0]}) exact against "
        f"their plain versions")
    live = sum(ends)
    parity, bad = [], []
    for s, tr in enumerate(drv.trackers):
        _, T = tr.trajectory()
        _, T_solo = solo[s].trajectory()
        dc = np.linalg.norm(T[:, :3, 3] - T_solo[:, :3, 3], axis=-1)
        states = [m.state for m in tr.metrics]
        parity.append(dict(max_centre_diff=float(dc.max()),
                           kf=tr.store.n_kf, kf_solo=solo[s].store.n_kf))
        log(f"pipelined_multiseq: sequence {s} (seed {MULTISEQ_SEEDS[s]}, "
            f"{ends[s]} frames): centres within {dc.max():.5f} m of its solo "
            f"pipelined run; keyframes {tr.store.n_kf} batched, "
            f"{solo[s].store.n_kf} solo")
        if (len(T) != ends[s] or states != ["OK"] * ends[s]
                or dc.max() >= PIPE_CENTRE_BOUND_M):
            bad.append((s, len(T), states, float(dc.max())))
    full = [r for r in rows if r["members"] >= 2]
    if bad or len(full) < n - 4 or any(
            r["k1a"] != 1 or r["k1b"] != 1 or r["k2g_tracking"] < 1
            for r in full) or drv.n_rebuilds < 2:
        raise AssertionError(f"pipelined_multiseq: {bad}; rows {rows}; "
                             f"rebuilds {drv.n_rebuilds}")
    ms_b = [r["ms"] for r in full]
    out = dict(counts=counts, parity=parity, rows=rows, wall_ms=wall_ms,
               kernels_exact=exact, pose_lm=lm,
               seq_fps=1e3 * live / wall_ms,
               solo_fps=1e3 / statistics.mean(solo_ms), solo_ms=solo_ms)
    log(f"pipelined_multiseq: S={n_seq}: per call ms median "
        f"{statistics.median(ms_b):.1f} p90 "
        f"{float(np.percentile(ms_b, 90)):.1f} over {len(full)} batched "
        f"calls; {out['seq_fps']:.2f} sequence-frames/s incl. the flush "
        f"against {out['solo_fps']:.2f} frames/s solo pipelined; rebuilds "
        f"{drv.n_rebuilds}; launches {counts}")
    return out


_T0 = time.perf_counter()


def phase_done(label: str, value=None):
    """Logs the seconds since the script started after a phase; returns
    the phase's value."""
    log(f"phase {label} done at {time.perf_counter() - _T0:.1f} s")
    return value


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_done("build", phase_build())
    k1a, k1b = phase_done("k1", phase_k1(dev))
    k2g = phase_done("k2g", phase_k2g(dev))
    k_lm = phase_done("pose_lm", phase_pose_lm(dev))
    frames, poses = main_sequence()
    main_out = phase_done("main", phase_main_path(dev, frames, poses))
    paths = dict(main=main_out)
    pipe = phase_done("pipelined", phase_pipelined(dev, frames, poses,
                                                   main_out))
    paths["pipelined"] = pipe["counts"]
    lines_world = lines_sequence()
    sync_lines = phase_done("lines", phase_lines(dev, *lines_world))
    paths["lines"] = sync_lines["counts"]
    paths["pipelined_lines"] = phase_done(
        "pipelined_lines", phase_pipelined_lines(dev, *lines_world[:2],
                                                 sync_lines))["counts"]
    native = phase_done("native_lines",
                        phase_native_lines(dev, *lines_world[:2]))
    paths["mini_kitti"] = native["mini_counts"]
    paths["native_lines"] = native["counts"]
    paths["pipelined_native_lines"] = phase_done(
        "pipelined_native_lines", phase_pipelined_native_lines(
            dev, *lines_world[:2], native))["counts"]
    ring = phase_done("loop", phase_loop(dev))
    paths["loop"] = ring["counts"]
    paths["reloc"], paths["reloc_site"] = phase_done("reloc",
                                                     phase_reloc(dev))
    mono = phase_done("mono", phase_mono(dev, frames, poses))
    paths["mono"] = mono["counts"]
    paths["rgbd"] = phase_done("rgbd", phase_rgbd(dev))["counts"]
    phase_done("rectify", phase_rectify(dev))
    loop_lines = phase_done("loop_lines", phase_loop_lines(dev))
    paths["loop_lines"] = loop_lines["counts"]
    dist_out = phase_done("dist", phase_dist(dev, ring, loop_lines))
    paths["dist"] = dist_out["counts"]
    phase_done("dist_ranks", phase_dist_ranks(dev, loop_lines, dist_out))
    multi = phase_done("multiseq", phase_multiseq(dev))
    paths["multiseq"] = multi["counts"]
    paths["multiseq_13"] = multi["sweep"]["counts"]
    pipe_multi = phase_done("pipelined_multiseq",
                            phase_pipelined_multiseq(dev, multi["seqs"]))
    paths["pipelined_multiseq"] = pipe_multi["counts"]
    torch.distributed.destroy_process_group()    # dist's one-rank group
    phase_done("cold_start", phase_cold_start())
    by_path = lambda k: {p: c[k] for p, c in paths.items()}
    batched = lambda k: dict(
        multi["kernels"][k], launches=paths["multiseq"][k],
        launches_per_batched_frame=1, S13_launches=paths["multiseq_13"][k])
    kernels = [
        dict(name="orb_describe", route="cuda",
             source="lldslam_tpu_torch/csrc/orb_describe.cu",
             replaces="lldslam_tpu/ops/patch_sample.py:68", exact=True,
             launches=paths["main"]["k1a"], launches_by_path=by_path("k1a"),
             main_path_frame=paths["main"]["frame_kernels"]["k1a"],
             mono_frame=mono["frame_kernels"]["k1a"],
             multiseq_S4=batched("k1a"), library_ms=None, **k1a),
        dict(name="stereo_sad", route="cuda",
             source="lldslam_tpu_torch/csrc/stereo_sad.cu",
             replaces="lldslam_tpu/ops/patch_sample.py:68", exact=True,
             launches=paths["main"]["k1b"], launches_by_path=by_path("k1b"),
             main_path_frame=paths["main"]["frame_kernels"]["k1b"],
             multiseq_S4=batched("k1b"), library_ms=None, **k1b),
        dict(name="gated_best2", route="cuda",
             source="lldslam_tpu_torch/csrc/match_best2.cu",
             replaces="lldslam_tpu/ops/pallas_match.py:110", exact=True,
             launches=paths["main"]["k2g"], launches_by_path=by_path("k2g"),
             launches_by_site=by_path("k2g_sites"),
             main_path_gated_pairs=paths["main"]["k2g_gated_pairs"],
             multiseq_S4=batched("k2g"), library_ms=None, **k2g),
        dict(name="segment_sum", route="cuda",
             source="lldslam_tpu_torch/csrc/segment_sum.cu",
             replaces=SEGMENT_SUM_REPLACES, launches=paths["loop"]["segsum"],
             launches_by_path=by_path("segsum"), vote_site=native["vote"],
             **dist_out["segsum"]),
        dict(name="pose_lm", route="cuda",
             source="lldslam_tpu_torch/csrc/pose_lm.cu",
             replaces="lldslam_tpu/optim/pose_opt.py:110", exact=False,
             tolerance_m_rad=POSE_LM_TOL, launches=paths["main"]["lm"],
             launches_by_path=by_path("lm"),
             launches_by_site=by_path("lm_sites"),
             main_path_frame=paths["main"]["pose_lm"],
             pipelined_frame=pipe["pose_lm"],
             multiseq_S4=multi["kernels"]["pose_lm"],
             pipelined_multiseq=pipe_multi["pose_lm"], library_ms=None,
             **k_lm),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
