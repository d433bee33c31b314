"""Everything the harness runs, found by name.

- a cell is an entry of ``workloads`` in ``BENCHMARK.json``;
- its configuration is ``configs/<config>.json`` (sizes, precision,
  source, and the names of its driver and its plain reference);
- its traffic mix is ``mixes/<traffic>.json``, read by ``gen.py``;
- the limits that decide ``correct`` are ``limits/<cell>.json``;
- a metric, end to end or per layer, is read by ``metrics/<name>.py``;
- a driver, the code that calls the program, is ``drivers/<driver>.py``.

A later cell, mix, configuration or metric adds files and entries; no
file here needs an edit for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> Dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str) -> Dict:
    return _json("configs", name)


def mix(name: str) -> Dict:
    return _json("mixes", name)


def limits(cell_name: str) -> Dict:
    return _json("limits", cell_name)


def metric(name: str) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, loaded by
    path (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    mod_name = "perfbench.metrics." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{name}")


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.reference.{name}")


def metrics_of(bench: Dict, section: str, cell_name: str) -> List[Dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell_name`` reports: those that list it, and those that list no
    cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]
