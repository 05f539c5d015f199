"""The per-layer metrics read from the program's own spans and counters
(`lldslam_tpu_torch/tracing.py`): a traced run of the stream cell on the
CPU at a small size reads a number for each host span and counter metric,
and None or a number for each device-trace one (the CPU has no device
trace); on records without spans or counters every one of them reads
None."""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import GPUBENCH, ROOT, SMALL

import run

HOST = ("lm_dispatch_ms", "search_dispatch_ms", "finalize_ms", "kf_stage_ms",
        "host_waits_per_frame", "host_unspanned_ms")
DEVICE = ("lm_device_ms", "search_device_ms", "kf_device_ms")

DRIVER = """
import sys, torch
sys.path[:0] = [{gpubench!r}, {root!r}]
torch.set_num_threads(2)
import run
opts = dict(device="cpu", warmup=False, config={small!r})
sys.exit(run.main({argv!r}, opts))
"""


@pytest.fixture(scope="module")
def traced():
    code = DRIVER.format(
        gpubench=str(GPUBENCH), root=str(ROOT), small=SMALL,
        argv=["--workload", "kitti_points.stream", "--seed", "2147483659",
              "--seconds", "8", "--trace", "1"])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_traced_run_reads_every_span_and_counter_metric(traced):
    got = traced["metrics"]
    for name in HOST:
        assert isinstance(got[name]["value"], float), (name, got.get(name))
    for name in DEVICE:
        assert name not in got or isinstance(got[name]["value"], float)
    v = {k: m["value"] for k, m in got.items()}
    assert 0 < v["lm_dispatch_ms"] + v["search_dispatch_ms"] \
        < v["dispatch_ms"]
    assert v["finalize_ms"] > 0 and v["kf_stage_ms"] > 0
    assert v["host_waits_per_frame"] > 0
    print({k: v[k] for k in HOST + ("dispatch_ms",)})


def test_the_new_metrics_are_declared_for_the_stream_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in HOST + DEVICE:
        m = declared[name]
        assert m["workloads"] == ["kitti_points.stream"]
        assert m["moves"] == "frames_per_s" and m["better"] == "lower"
        assert m["source"] == ("device_trace" if name in DEVICE else
                               "program_counter" if name.startswith("host_w")
                               else "program_span")


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_without_spans_or_counters_a_metric_reads_none(name):
    """A program without the spans and counters (a record with neither, a
    device trace with no program range) reads None and does not raise."""
    record = SimpleNamespace(frame_id=0, t_dispatch=0.1, n_line_matches=0)
    window = dict(frames=5, calls=5, per_call=1, window_s=2.0,
                  metrics=[record] * 5, kf=[])
    trace = dict(frames=6, op_device_s={"k2g": 1e-3}, busy_s=0.1,
                 window_s=1.0)
    runs = [dict(window=window, traced=trace),
            dict(window=dict(window, frames=0, calls=0, window_s=0.0,
                             metrics=[]), traced=None),
            dict(window=window, traced=dict(trace, incomplete=True))]
    for r in runs:
        assert run.reader(name)(r) is None
