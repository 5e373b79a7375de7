"""BENCHMARK.json against the contract's shape, and the harness finding
each configuration, workload, driver and metric by name, also one added
later in a copy of the folder."""

import json
import re
import shutil

import pytest
from conftest import BENCH, cells

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = BENCH.parent


def test_benchmark_json_shape():
    b = harness.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench_port/run.py"]
    assert b["paths"] == ["bench_port"]
    assert 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"] + b["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench_port/")
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in b["end_to_end"])
    moves = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in moves and UNIT.match(m["unit"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


@pytest.mark.parametrize("cell", cells())
def test_every_cell_finds_its_files(cell):
    b = harness.benchmark()
    entry = harness.cell_entry(b, cell)
    wl = harness.workload(cell)
    assert wl["config"] == entry["config"]
    harness.config(entry["config"])
    drv = harness.driver(wl["driver"])
    for fn in ("setup", "step", "min_iters", "release", "check", "control",
               "trace_info"):
        assert callable(getattr(drv, fn))
    e2e = [m["name"] for m in harness.cell_metrics(b, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(b, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        reader = harness.metric_reader(m["name"])
        assert reader.read(_empty_summary()) is None


def _empty_summary():
    return {"iters": 1, "window_s": 0.0, "busy_s": 0.0, "kernels": {},
            "span_kernel_s": {}, "backward_kernel_s": 0.0,
            "span_device_s": {}, "iter_s": 1.0}


def test_a_file_added_later_is_found_by_name(tmp_path):
    copy = tmp_path / "bench_port"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    wl = dict(harness.workload("genre-infer-b128"), batch=4)
    (copy / "workloads" / "genre-infer-b4.json").write_text(json.dumps(wl))
    cfg = dict(harness.config("genre"), name="genre-f32", dtype="float32")
    (copy / "configs" / "genre-f32.json").write_text(json.dumps(cfg))
    (copy / "metrics" / "two.infer.py").write_text(
        "def read(summary):\n    return 2.0\n")
    assert harness.workload("genre-infer-b4", copy)["batch"] == 4
    assert harness.config("genre-f32", copy)["dtype"] == "float32"
    assert harness.metric_reader("two.infer", copy).read({}) == 2.0
    assert harness.driver("genre_infer", copy).KIND == "infer"
    bench = harness.benchmark()
    bench["per_layer"].append({"name": "two.infer", "workloads": [
        "genre-infer-b4"]})
    assert [m["name"] for m in harness.cell_metrics(
        bench, "genre-infer-b4", "per_layer")] == ["two.infer"]


@pytest.mark.parametrize("bad", ["../x", "a/b", "", ".hidden", "a b"])
def test_names_that_leave_their_folder_are_refused(bad):
    with pytest.raises(ValueError):
        harness.check_name(bad)


def test_window_and_statistics():
    calls = []
    lat, window = harness.closed_loop(calls.append, 0.0, min_iters=5)
    assert calls == [0, 1, 2, 3, 4] and len(lat) == 5 and window >= 0
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == \
        pytest.approx(4.8)
    ok, checks = harness.judge({"a": 0.1, "b": float("nan")},
                               {"a": 0.2, "b": 1.0, "c": 1.0})
    assert not ok and checks["b"]["value"] == float("inf")
    assert checks["c"]["value"] == float("inf")
    assert harness.judge({"a": 0.1}, {"a": 0.2})[0]
