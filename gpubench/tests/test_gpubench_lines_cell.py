"""The cell `kitti_lines.lbd_stream` (LLD-SLAM's KITTI 04-12 deployment with
stored LBD detections): it resolves by its name, its new readers read the
line step's joint pose LM from the program's spans and counters (and read
nothing where the program has none), a run of a few frames on the CPU at a
small size comes out correct, and one with the line step left unchanged,
or with the control in the program's place, does not."""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import GPUBENCH, ROOT, SMALL
from faults import FAULTS

import run
from benchlib import pose_lm_work, work

CELL = "kitti_lines.lbd_stream"
NEW = ("line_lm_dispatch_ms", "line_lm_device_ms", "line_lm_roofline")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

DRIVER = """
import sys, json, torch
sys.path[:0] = [{gpubench!r}, {root!r}]
torch.set_num_threads(2)
import run
{fault}
opts = dict(device="cpu", warmup=False, config={small!r})
{extra}
sys.exit(run.main({argv!r}, opts))
"""


def _run(seconds, fault="", extra="", trace=0, seed=2654435761):
    code = DRIVER.format(
        gpubench=str(GPUBENCH), root=str(ROOT), fault=fault, extra=extra,
        small=SMALL, argv=["--workload", CELL, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_cell_resolves_to_its_files():
    files = run.cell_files(BENCH, CELL)
    assert files["cell"]["config"] == "kitti_lines"
    assert files["cell"]["chips"] == 1
    conf = files["config"]
    assert conf["reduced"] == ["line"] and conf["slam"]["line"]["md_thr"] == 0.6
    assert files["traffic"]["ceiling_frames_per_s"] == 20.0
    assert files["traffic"]["stored_lines"] and files["traffic"]["stripes"]
    # the held-out twin's limits, but the line step's gap held to 1e-3 m:
    # between the sound runs' medians on the card (at most 3.7e-4) and the
    # line step left unchanged (at least 2.4e-3), which the twin's 4e-3
    # lets through on some seeds
    held = json.loads(
        (GPUBENCH / "limits" / "kitti_lines.stored_stream.json").read_text())
    assert files["limits"] == dict(held, line_pose_gap_m=0.001)
    reported = {m["name"] for m in files["per_layer"]}
    assert reported == {"line_matches_per_frame", "line_kf_ms", *NEW}
    assert {m["name"] for m in files["end_to_end"]} == {"frames_per_s",
                                                        "setup_s"}
    t = files["traffic"]
    assert run.frames_needed(t, BENCH["run_seconds"], 1) - t["warm_frames"] \
        >= t["ceiling_frames_per_s"] * BENCH["run_seconds"]


def _record(spans=(), counts=None):
    return SimpleNamespace(frame_id=0, n_line_matches=3, spans=list(spans),
                           counts=dict(counts or {}))


def _synthetic(with_program: bool):
    """A run of 4 frames: each with a `track.line_lm` span of 0.5 ms and
    one launch of 2048 point and 256 line rows where `with_program`; a
    traced window of 6 frames with 0.9 ms of device time in
    `op:track.line_lm`."""
    spans = [("frame", 0, 9_000_000, -1), ("dispatch", 100, 2_000_100, 0),
             ("track.line_step", 200, 1_000_200, 1)]
    counts = {"host_waits": 5}
    if with_program:
        spans.append(("track.line_lm", 300, 500_300, 2))
        counts.update(pose_lm_kernel=3, line_lm_kernel=1,
                      line_lm_rows=2048 + 2 * 256, line_lm_lines=256)
    window = dict(frames=4, calls=4, per_call=1, window_s=1.0, kf=[],
                  metrics=[_record(spans, counts)] * 4)
    ops = {"track.line_lm": 0.9e-3} if with_program else {"k2g": 1e-3}
    traced = dict(frames=6, op_device_s=ops, busy_s=0.1, window_s=1.0)
    return dict(window=window, traced=traced, work=work,
                captures=SimpleNamespace(traced={}))


def test_the_new_readers_read_the_line_step():
    r = _synthetic(True)
    assert run.reader("line_lm_dispatch_ms")(r) == pytest.approx(0.5)
    assert run.reader("line_lm_device_ms")(r) == pytest.approx(0.15)
    share = run.reader("line_lm_roofline")(r)
    least = work.bound_s(*pose_lm_work.launch(2048, 256)) * 6
    assert share == pytest.approx(100.0 * least / 0.9e-3)
    assert 0 < share < 100


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_line_lm_span_reads_none(name):
    """The parent's program (no `track.line_lm` span, no line LM
    counters), an empty window and an incomplete trace read None."""
    bare = _synthetic(False)
    empty = dict(bare, window=dict(bare["window"], frames=0, metrics=[]),
                 traced=None)
    incomplete = dict(_synthetic(True))
    incomplete["traced"] = dict(incomplete["traced"], incomplete=True)
    for r in (bare, empty) + ((incomplete,) if name != NEW[0] else ()):
        assert run.reader(name)(r) is None


def test_the_work_of_a_launch():
    """Bytes and operations of a launch, by rows, passes and the passes
    that reclassify; the line step's launch is bound by its operations."""
    n_bytes, n_ops = pose_lm_work.launch(10, 4, rounds=1, iters=2,
                                         problems=2)
    assert n_bytes == 10 * 31 + 4 * 63 + 2 * 132
    assert n_ops == 4 * (10 * 339 + 4 * 1015) + 4 * 73
    n_bytes, n_ops = pose_lm_work.launch(2048, 256)
    assert n_ops == 15 * (2048 * 339 + 256 * 1015) + 2 * 256 * 73
    assert n_ops / work.F32_OPS_PER_S > n_bytes / work.HBM_BYTES_PER_S


def test_a_sound_run_of_the_cell_is_correct():
    out = _run(8)
    assert out["correct"] is True, out["checks"]
    assert {"line_pose_gap_m", "line_wrong"} <= set(out["checks"])
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault,extra", [
    ("line_step_unchanged", ""), ("", "opts['control'] = torch.bfloat16")])
def test_the_line_step_unchanged_and_the_control_are_not_correct(fault,
                                                                 extra):
    out = _run(8, fault=FAULTS[fault] if fault else "", extra=extra)
    assert out["correct"] is False, out["checks"]
    c = out["checks"]["line_pose_gap_m"]
    assert c["value"] is None or c["value"] > c["limit"], out["checks"]


@pytest.mark.cuda
def test_the_cell_runs_correct_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", CELL, "--seed",
         "3141592653", "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert set(NEW) <= set(got), got
    assert 0 < got["line_lm_roofline"]["value"] <= 100
