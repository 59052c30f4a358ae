"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""
import json
import re

import pytest

from conftest import BENCH

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load(path):
    with open(path) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's time
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


def test_configs_match_their_files():
    for c in bench()["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        data = load(ROOT / c["file"])
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/configs/")


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_file_names_what_exists(cell):
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    data = load(BENCH / "workloads" / f"{cell}.json")
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == entry[key]
    assert entry["config"] in {c["name"] for c in b["configs"]}
    assert (BENCH / "configs" / f"{entry['config']}.json").exists()
    assert (BENCH / "traffic" / f"{entry['traffic']}.py").exists()
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    assert set(data["limits"]) and all(v > 0 for v in data["limits"].values())


def reported(b, cell, kind):
    return {m["name"] for m in b[kind]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_enough():
    b = bench()
    for w in b["workloads"]:
        e2e = reported(b, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(b, w["name"], "per_layer")


def test_metrics_well_formed_and_moves_reported():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and "\n" not in m["layer"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in reported(b, cell, "end_to_end")


def test_every_per_layer_metric_has_its_reader():
    for m in bench()["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        text = path.read_text()
        assert f'SOURCE = "{m["source"]}"' in text
        assert "def read(record)" in text


def test_roofline_shares_named_and_in_percent():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_readers_find_nothing_in_an_empty_record():
    from common import load_reader

    for m in bench()["per_layer"]:
        assert load_reader(m["name"])({}) is None
