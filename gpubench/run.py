#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Every part of a cell is found by its name:
the cell's entry in BENCHMARK.json names its configuration
(`gpubench/configs/<config>.json`, whose `slam` groups become the port's
`SlamConfig`) and its traffic mix (`gpubench/traffic/<traffic>.json`, data),
which names the world that renders its frames
(`gpubench/worlds/<world>.py`) and the schedule that drives the window
(`gpubench/schedules/<schedule>.py`); its limits are
`gpubench/limits/<cell>.json`, and each per-layer metric is read by
`gpubench/metrics/<metric>.py`. A name without its file ends the run with
no result.

A fresh process sets up (imports, the program's kernels, the schedule's
System and its warm-up, the frames rendered on the card from the seed, the
warm frames, then calls up to the first that gives back finalized poses),
then hands frames to the program for `--seconds` seconds, closed loop, and
on to the next call that gives back finalized poses (poses come back a
readback window at a time), and prints one JSON line last: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from host-clock spans over the same window and a profiler
session over a few calls after it. Then it frees the program and decides
`correct` against the plain reference (benchlib/reference.py,
benchlib/solve.py). Set-up's phases are printed on standard error.

Exit codes: 0 a result printed (correct or not); 1 no card, or fewer cards
than the cell asks for; 2 a run that could not finish (frames ran out, a
module of JAX or of the JAX package loaded, a name without its file).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "lldslam_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, name: str) -> dict:
    """The cell's entry, its configuration, traffic mix and limits, and
    the per-layer metrics it reports, each found by its name. A cell kept
    out of BENCHMARK.json (`held_out/<cell>.json`: its entries, and the
    per-layer metrics that would list it) runs by hand and in the tests."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    held = HERE / "held_out" / f"{name}.json"
    if cell is None and held.is_file():
        extra = load_json(held)
        bench = dict(bench, **{k: bench[k] + extra[k] for k in
                               ("configs", "workloads", "per_layer")})
        bench["per_layer"] = [
            dict(m, workloads=m["workloads"] + [name])
            if m["name"] in extra["per_layer_also"] else m
            for m in bench["per_layer"]]
        cell = extra["workloads"][0]
    if cell is None:
        raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")
    return dict(
        cell=cell,
        config=load_json(HERE / "configs" / f"{cell['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])],
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])])


def load_module(kind: str, name: str):
    """gpubench/<kind>/<name>.py as a module; a name without its file ends
    the run."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"gpubench: no {kind[:-1]} {name!r}: {path} is "
                         "not there")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """gpubench/metrics/<metric>.py's `read`."""
    return load_module("metrics", metric).read


def merged(groups: dict, *overrides: dict) -> dict:
    """Configuration groups with each override's keys set in them."""
    out = {k: dict(v) for k, v in groups.items()}
    for o in overrides:
        for k, v in o.items():
            out[k] = dict(out.get(k, {}), **v)
    return out


def slam_config(groups: dict):
    """The port's SlamConfig from the configuration's groups: each group
    named after a SlamConfig field builds that field's own class, so a
    configuration can set any group SlamConfig takes."""
    import dataclasses
    from lldslam_tpu_torch.config import SlamConfig
    fields = {f.name: f for f in dataclasses.fields(SlamConfig)}
    unknown = set(groups) - set(fields)
    if unknown:
        raise SystemExit(f"gpubench: SlamConfig has no group {sorted(unknown)}")
    kw = {}
    for name, group in groups.items():
        f = fields[name]
        default = f.default_factory() if f.default_factory is not \
            dataclasses.MISSING else f.default
        kw[name] = type(default)(**group)
    return SlamConfig(**kw)


def frames_needed(traffic: dict, seconds: float, n_seq: int) -> int:
    """Frames a sequence: enough that the window cannot run out at the
    mix's ceiling rate, with the warm frames, the staged ones and the
    traced windows' after it."""
    rate = traffic["ceiling_frames_per_s"] / n_seq
    return (traffic["warm_frames"] + math.ceil(rate * seconds)
            + traffic.get("stage_ahead", 0) + 3 * traffic["trace_calls"]
            + 2 * 16)


def device_of(opts: dict, chips: int):
    import torch
    if opts.get("device") is not None:
        return torch.device(opts["device"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return torch.device("cuda:0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, opts: dict | None = None) -> int:
    """opts (tests, the control and planted faults only): device ("cpu"),
    overrides of the configuration's groups and of the traffic's keys,
    warmup False, and the control's dtype."""
    opts = opts or {}
    args = parse(argv)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / ".gpubench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / ".gpubench_cache" / "torch_extensions"))
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        files = cell_files(bench, args.workload)
        cell, conf = files["cell"], files["config"]
        traffic = dict(files["traffic"], **opts.get("traffic", {}))
        groups = merged(conf["slam"], opts.get("config", {}))
        world_mod = load_module("worlds", traffic["world"])
        sched_mod = load_module("schedules", traffic["schedule"])
    except (OSError, SystemExit) as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    import torch
    # one host thread for torch's CPU ops: the program's host work is one
    # Python thread, and idle worker threads spinning beside it on the
    # machine's few cores spread the runs (PERF.md)
    torch.set_num_threads(1)
    dev = device_of(opts, cell["chips"])
    if dev is None:
        print(f"gpubench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from benchlib import check, probes, trace, work, world
    on_card = dev.type == "cuda"
    phases = {"imports": time.perf_counter() - T_START}

    def phase(name):
        if on_card:
            torch.cuda.synchronize(dev)
        phases[name] = time.perf_counter() - T_START - sum(phases.values())

    cam = groups["camera"]
    n_seq = world_mod.sequences(traffic)
    n_frames = frames_needed(traffic, args.seconds, n_seq)
    scratch = Path(tempfile.mkdtemp(prefix="gpubench_",
                                    dir=os.environ.get("TMPDIR")))
    w = world_mod.make(cam, traffic, args.seed, n_frames, dev, scratch)
    groups = merged(groups, w["config"])
    cfg = slam_config(groups)
    phase("world")

    captures = probes.Captures(traffic["checked"],
                               world.seed_of(args.seed, 1 << 22))
    layers = probes.Layers(HERE / "layers") if args.trace else None
    sched = sched_mod.Schedule(cfg, w, conf, traffic, captures, dev,
                               opts.get("warmup", True))
    phase("system_and_warmup")
    sched.warm(traffic["warm_frames"])
    # the window opens and closes on a call that gave back finalized
    # frames: poses come back a readback window at a time, and a window
    # cut between two of them would count a varying part of one
    for _ in range(16):
        if sched.step():
            break
    phase("warm_frames")
    gc.collect()
    setup_s = time.perf_counter() - T_START
    print("gpubench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr)

    # -- the measured window ------------------------------------------------
    trs = sched.trackers
    m0 = [len(tr.metrics) for tr in trs]
    k0 = [len(tr.kf_timings) for tr in trs]
    lk0 = [dict(tr.line_kf_times) for tr in trs]
    done = []
    calls = 0
    read0 = getattr(sched, "lines_read_s", 0.0)
    captures.armed = True
    if layers:
        layers.armed = True
    try:
        t0 = time.perf_counter()
        while True:
            got = sched.step()
            done += got
            calls += 1
            window_s = time.perf_counter() - t0
            if window_s >= args.seconds and got:
                break
    except sched_mod.OutOfFrames as e:
        print(f"gpubench: {e}: the traffic's ceiling rate is too low",
              file=sys.stderr)
        shutil.rmtree(scratch, ignore_errors=True)
        return 2
    captures.armed = False
    lines_read_s = getattr(sched, "lines_read_s", 0.0) - read0
    window = dict(
        frames=len(done), calls=calls, window_s=window_s,
        latencies=[d[2] for d in done if d[2] is not None],
        metrics=[m for tr, a in zip(trs, m0) for m in tr.metrics[a:]],
        kf=[k for tr, a in zip(trs, k0) for k in tr.kf_timings[a:]],
        line_kf={key: sum(tr.line_kf_times.get(key, 0.0) - b.get(key, 0.0)
                          for tr, b in zip(trs, lk0))
                 for key in {k for tr in trs for k in tr.line_kf_times}},
        per_call=sched.per_call())
    traced = None
    if layers:
        window["spans"] = dict(layers.seconds)
        captures.tracing = True

        def reset():
            for v in captures.traced.values():
                v.clear()
        traced = trace.traced_window(sched.step, traffic["trace_calls"],
                                     reset, dev)
        captures.tracing = False
        layers.armed = False
        traced["frames"] = traffic["trace_calls"] * sched.per_call()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # -- after the window: the program's results, then its state freed ------
    sched.flush()
    trajs = trajectories(trs)
    ids = [id(tr) for tr in trs]
    states = [m.state for tr in trs for m in tr.metrics]
    del sched, trs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    dtype = opts.get("control")
    limits = files["limits"]
    scale, gamma = cfg.orb.scale, float(cfg.line.gamma)
    numbers = check.kernel_numbers(captures, w["frames"], cfg.orb, dev, dtype)
    numbers["lost_frames"] = sum(s != "OK" for s in states)
    numbers["pose_gap_m"], numbers["checked_poses"] = check.pose_gap(
        captures, cam, scale, dtype, None if cfg.line.enabled else ids)
    if "line_pose_gap_m" in limits:
        numbers["line_pose_gap_m"], numbers["checked_line_poses"], \
            numbers["line_pose_gap_max_m"] = check.line_pose_gap(
                captures, cam, scale, gamma, ids, dtype)
    if "ba_excess" in limits:
        numbers["ba_excess"], numbers["checked_bas"], \
            numbers["ba_excess_unmoved"] = check.ba_excess(
                captures, cam, scale, dtype)
    numbers["ate_m"] = check.ate(trajs, w["truths"])
    if w["line_truth"] is not None:
        numbers["line_wrong"], numbers["line_matches"] = check.line_wrong(
            captures, w["line_truth"], conf["line_capacity"])
        if numbers["line_matches"] == 0:
            numbers["line_wrong"] = None          # nothing checked: fails
    for key in ("k1a", "k1b", "k2g"):
        if numbers[f"checked_{key}"] == 0:
            numbers[f"{key}_rows_off"] = None     # nothing checked: fails
    correct, checks = check.judge(numbers, limits)
    check_s = time.perf_counter() - t_check

    run = dict(window=window, traced=traced, captures=captures,
               work=work, config=conf)
    if args.trace:
        metrics = {}
        for m in files["per_layer"]:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = dict(frames_per_s=len(done) / window_s, setup_s=setup_s)
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in files["end_to_end"]}
    shutil.rmtree(scratch, ignore_errors=True)
    found = banned_modules()
    if found:
        print(f"gpubench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 2
    device = dict(platform="gpu" if on_card else dev.type,
                  kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
                  count=cell["chips"], memory_peak_bytes=int(peak))
    if traced is not None:
        device.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    lost = sum(s != "OK" for s in states)
    result = dict(correct=bool(correct), attempted=len(states), failed=lost,
                  metrics=metrics, device=device)
    if traced is not None:
        result["breakdown"] = dict(device_ops=traced["device_ops"],
                                   idle_gaps=traced["idle_gaps"])
    result["checks"] = checks
    n_lm = [m.n_line_matches for m in window["metrics"]]
    print(f"gpubench: the window's work: {len(window['kf'])} keyframes, "
          f"{sum(n_lm) / max(len(n_lm), 1):.2f} line inliers a frame, "
          f"{lines_read_s:.3f} s reading stored detections", file=sys.stderr)
    print(f"gpubench: {window['frames']} frames finalized in "
          f"{window_s:.3f} s over {calls} calls; setup {setup_s:.3f} s; "
          f"{len(window['latencies'])} pose latencies; checked calls "
          f"k1a {numbers['checked_k1a']}, k1b {numbers['checked_k1b']}, "
          f"k2g {numbers['checked_k2g']}, poses {numbers['checked_poses']}, "
          f"line poses {numbers.get('checked_line_poses', 0)} (largest "
          f"gap {numbers.get('line_pose_gap_max_m')} m), local BAs "
          f"{numbers.get('checked_bas', 0)} (a map left unmoved would read "
          f"ba_excess {numbers.get('ba_excess_unmoved')}); ATE "
          f"{numbers['ate_m']} m (not compared); stereo line matches "
          f"checked {numbers.get('line_matches', 0)}; the check took "
          f"{check_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def trajectories(trackers) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per sequence, (frame indices, camera centres (n, 3)) of every frame
    the program logged."""
    out = []
    for tr in trackers:
        ts, t_wc = tr.trajectory()
        out.append((np.rint(np.asarray(ts) * 10).astype(int),
                    np.asarray(t_wc)[:, :3, 3].astype(np.float64)))
    return out


if __name__ == "__main__":
    sys.exit(main())
