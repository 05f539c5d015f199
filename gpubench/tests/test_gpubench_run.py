"""Whole runs of the harness on the CPU at a small size (the program's
plain versions), with the timed path broken underneath: `correct` has to
come out false for each fault a cell can have, and for the control. Each
run is a fresh process, as the benchmark's are."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import GPUBENCH, ROOT, SMALL
from faults import FAULTS

DRIVER = """
import sys, json, torch
sys.path[:0] = [{gpubench!r}, {root!r}]
torch.set_num_threads(2)
import run
{fault}
opts = dict(device="cpu", warmup=False, config={small!r}, traffic={traffic!r})
{extra}
sys.exit(run.main({argv!r}, opts))
"""

def _run(cell, seconds, fault="", extra="", traffic=None, seed=3000000017):
    code = DRIVER.format(
        gpubench=str(GPUBENCH), root=str(ROOT), fault=fault, extra=extra,
        small=SMALL, traffic=traffic or {},
        argv=["--workload", cell, "--seed", str(seed), "--seconds",
              str(seconds), "--trace", "0"])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("cell", ["kitti_points.stream",
                                  "kitti_lines.stored_stream"])
def test_a_sound_run_prints_its_line_last_and_is_correct(cell):
    out, err = _run(cell, 8)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 1
    last = err.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in last)


@pytest.mark.parametrize("cell,fault,number", [
    ("kitti_points.stream", "k1a_bit", "k1a_rows_off"),
    ("kitti_points.stream", "pose_unchanged", "pose_gap_m"),
    ("kitti_points.stream", "ba_unchanged", "ba_excess"),
    ("kitti_lines.stored_stream", "line_swapped", "line_wrong"),
    ("kitti_lines.stored_stream", "line_step_unchanged", "line_pose_gap_m"),
    ("kitti_lines.stored_stream", "ba_unchanged", "ba_excess"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, number):
    out, _ = _run(cell, 8, fault=FAULTS[fault])
    assert out["correct"] is False, out["checks"]
    c = out["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("cell", ["kitti_points.stream",
                                  "kitti_lines.stored_stream"])
def test_the_control_is_not_correct(cell):
    out, _ = _run(cell, 8, extra="opts['control'] = torch.bfloat16")
    assert out["correct"] is False
    c = out["checks"]
    assert c["pyramid_px_off"]["value"] > 0 and c["k1a_rows_off"]["value"] > 0
    for name in ("pose_gap_m", "line_pose_gap_m", "ba_excess"):
        if name in c:
            assert c[name]["value"] > c[name]["limit"], c


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchlib.reference, benchlib.work, benchlib.world,"
            " benchlib.check, benchlib.solve;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(GPUBENCH))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    tops = set(eval(p.stdout))
    assert not tops & {"jax", "jaxlib", "flax", "lldslam_tpu",
                       "lldslam_tpu_torch"}


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run;"
            "from benchlib import probes, trace;"
            "run.load_module('schedules', 'stream');"
            "run.load_module('worlds', 'corridor');"
            "print(run.banned_modules())" % (str(GPUBENCH), str(ROOT)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_without_a_card_the_run_exits_without_a_result(tmp_path):
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "kitti_points.stream", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kitti_lines.stored_stream",
                                  "kitti_points.stream"])
def test_each_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
