"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of every file by its name."""
from __future__ import annotations

import json
import math
import re
import shutil

import pytest

from conftest import GPUBENCH, ROOT

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    r = BENCH["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text_fields():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_name_resolves_to_a_file():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (GPUBENCH / "configs" / f"{c['name']}.json").exists()
        assert set(conf["reduced"]) <= set(conf["slam"]) | set(conf)
        run.slam_config(conf["slam"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        files = run.cell_files(BENCH, w["name"])
        t = files["traffic"]
        assert t["name"] == w["traffic"]
        assert hasattr(run.load_module("worlds", t["world"]), "make")
        assert hasattr(run.load_module("schedules", t["schedule"]),
                       "Schedule")
        assert set(files["limits"]) >= {"lost_frames", "pose_gap_m",
                                         "k1a_rows_off", "k1b_rows_off",
                                         "k2g_rows_off", "ba_excess"}
    for m in BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_every_config_group_builds_the_ports_own_class():
    from lldslam_tpu_torch.config import LineConfig, SlamConfig
    cfg = run.slam_config(dict(line=dict(ld_type="LBDFloat", md_thr=0.6),
                               camera=dict(fx=500.0)))
    assert isinstance(cfg, SlamConfig) and isinstance(cfg.line, LineConfig)
    assert cfg.line.md_thr == 0.6 and cfg.camera.fx == 500.0
    assert cfg.orb == SlamConfig().orb
    with pytest.raises(SystemExit):
        run.slam_config(dict(no_such_group={}))


@pytest.mark.parametrize("kind,name", [("worlds", "no_such_world"),
                                       ("schedules", "no_such_schedule"),
                                       ("metrics", "no_such_metric")])
def test_a_name_without_its_file_is_refused(kind, name):
    with pytest.raises(SystemExit):
        run.load_module(kind, name)


def test_a_new_traffic_mix_and_cell_are_picked_up_without_editing(tmp_path):
    shutil.copytree(GPUBENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="kitti_points.slow", config=
                                   "kitti_points", traffic="slow", chips=1,
                                   why="a slower camera"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((GPUBENCH / "traffic" / "stream.json").read_text())
    mix.update(name="slow", speeds_m_per_frame=[0.5])
    (tmp_path / "gpubench" / "traffic" / "slow.json").write_text(
        json.dumps(mix))
    shutil.copy(GPUBENCH / "limits" / "kitti_points.stream.json",
                tmp_path / "gpubench" / "limits" / "kitti_points.slow.json")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "run_copy2", tmp_path / "gpubench" / "run.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    files = copy.cell_files(bench, "kitti_points.slow")
    assert files["traffic"]["speeds_m_per_frame"] == [0.5]
    assert files["limits"]["lost_frames"] == 0


def test_each_metric_is_reported_where_it_says():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        files = run.cell_files(BENCH, w)
        assert len(files["end_to_end"]) >= 2 and files["per_layer"]


def test_a_new_metric_file_is_picked_up_without_editing_the_harness(
        tmp_path):
    shutil.copytree(GPUBENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="frames_in_window", unit="frames", better="higher",
        source="host_clock", layer="facade", moves="frames_per_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "gpubench" / "metrics" / "frames_in_window.py").write_text(
        "def read(run):\n    return float(run['window']['frames'])\n")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "run_copy", tmp_path / "gpubench" / "run.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    for w in bench["workloads"]:
        files = copy.cell_files(bench, w["name"])
        assert "frames_in_window" in [m["name"] for m in files["per_layer"]]
    assert copy.reader("frames_in_window")(dict(window=dict(frames=7))) == 7.0


@pytest.mark.parametrize("name", ["no_such_cell"])
def test_an_unknown_cell_is_refused(name):
    with pytest.raises(SystemExit):
        run.cell_files(BENCH, name)


def test_a_held_out_cell_runs_by_its_name_outside_the_benchmark():
    name = "kitti_lines.stored_stream"
    assert name not in {w["name"] for w in BENCH["workloads"]}
    files = run.cell_files(BENCH, name)
    assert files["cell"]["config"] == "kitti_lines"
    run.slam_config(files["config"]["slam"])
    reported = {m["name"] for m in files["per_layer"]}
    assert {"line_matches_per_frame", "line_kf_ms", "dispatch_ms"} <= reported
    assert {"line_pose_gap_m", "line_wrong"} <= set(files["limits"])
    assert {m["name"] for m in files["end_to_end"]} == {"frames_per_s",
                                                        "setup_s"}


def test_frames_rendered_cover_the_ceiling_rate():
    for w in BENCH["workloads"]:
        t = run.cell_files(BENCH, w["name"])["traffic"]
        n_seq = run.load_module("worlds", t["world"]).sequences(t)
        n = run.frames_needed(t, BENCH["run_seconds"], n_seq)
        assert n - t["warm_frames"] >= math.ceil(
            t["ceiling_frames_per_s"] / n_seq * BENCH["run_seconds"])
