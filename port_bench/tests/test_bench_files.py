"""Every cell, configuration, traffic mix and metric is a file of its own
that the harness finds by the name in BENCHMARK.json, and the file agrees
with its entry."""

import json
import re

import pytest

from port_bench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1] == "port_bench/run.py" and BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = json.loads((run.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    run.family_module(cfg).check(cfg)  # the sizes against the program's table, by family


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(cell):
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    r = run.prepare(cell["name"], 1, "cpu")
    assert (run.BENCH / "drivers" / f"{r.traffic['driver']}.py").exists()
    assert r.limits and all(v >= 0 for v in r.limits.values())
    names = {m["name"] for m in r.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and r.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_reader(metric):
    reader = run.load_module(run.BENCH / "metrics" / f"{metric['name']}.py")
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (metric["layer"], metric["unit"],
                                                         metric["moves"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in metric["workloads"]:
        assert cell in e2e[metric["moves"]].get("workloads", [cell])
    assert reader.read({}) is None  # nothing to read: nothing reported


def test_names_and_bounds():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]["bound"] <= 0.25
