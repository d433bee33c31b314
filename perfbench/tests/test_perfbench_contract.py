"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by name."""
import json
import re
import shutil

import pytest

from perfbench_tiny import ROOT
from perfbench import registry
from perfbench import run as harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_run_length():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_every_cell_reports_what_it_must():
    for cell in BENCH["workloads"]:
        name = cell["name"]
        e2e = {m["name"] for m in registry.metrics_of(BENCH, "end_to_end",
                                                       name)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = registry.metrics_of(BENCH, "per_layer", name)
        assert per
        for m in per:
            assert m["moves"] in e2e, (name, m["name"])
        assert cell["chips"] == 1 and len(cell["why"]) <= 200


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_a_cell_finds_its_files_by_name(cell):
    w = registry.cell(BENCH, cell)
    cfg = registry.config(w["config"])
    mix = registry.mix(w["traffic"])
    lim = registry.limits(cell)
    assert lim["steps"] >= 1 and lim["limits"]
    for mod in (registry.driver(cfg["driver"]),
                registry.reference(cfg["reference"])):
        assert mod.__name__.split(".")[0] == "perfbench"
    assert mix["trace_steps"] >= 1
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"perfbench/configs/{w['config']}.json"
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_a_metric_finds_its_reader_by_name(metric):
    assert callable(registry.metric(metric).read)


def test_a_metric_and_a_mix_are_added_as_files(tmp_path, monkeypatch):
    """A new per-layer metric and a new mix are new files and entries:
    the harness reads them with no edit to a file it has."""
    copy = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", copy,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "metrics" / "steps_seen.extra.py").write_text(
        "def read(ctx):\n    return float(len(ctx.steps))\n")
    (copy / "mixes" / "extra_mix.json").write_text('{"trace_steps": 1}')
    monkeypatch.setattr(registry, "HERE", copy)
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "steps_seen.extra", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "FL driver", "moves": "round_s",
         "workloads": ["femnist.resident"]}])
    names = [m["name"] for m in registry.metrics_of(
        bench, "per_layer", "femnist.resident")]
    assert "steps_seen.extra" in names
    ctx = harness.Context(steps=[{}, {}, {}])
    assert registry.metric("steps_seen.extra").read(ctx) == 3.0
    assert registry.mix("extra_mix") == {"trace_steps": 1}
