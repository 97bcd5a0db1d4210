"""The harness finds every configuration, workload and metric that
BENCHMARK.json names, by name, and BENCHMARK.json keeps the contract's
character and consistency rules."""
import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all("/" not in w or w.startswith("portbench") for w in BENCH["command"])


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for text in [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    run = harness.make_run(cell, 1, 1, False, "cpu", "/nonexistent")
    assert run.workload["config"] == w["config"]
    assert (ROOT / next(c["file"] for c in BENCH["configs"] if c["name"] == w["config"])).is_file()
    ent = importlib.import_module(f"portbench.entries.{run.workload['entry']}")
    for fn in ("setup", "window", "traced", "release", "check", "metrics"):
        assert callable(getattr(ent, fn))
    assert run.workload["limits"] and all(v > 0 for v in run.workload["limits"].values())
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_is_found_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        reporting = set(moved.get("workloads", cells))
        assert set(m["workloads"]) == reporting, m["name"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(layer) <= 200 for layer in layers)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_every_config_is_used_and_states_what_was_cut():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
