"""Helpers of the benchmark's CPU tests: the cells' configurations cut
to a size a test run holds (the same code paths, the widths shrunk), and
a run of the harness on the CPU with them."""
from __future__ import annotations

import contextlib
import copy
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import registry  # noqa: E402

#: a seed past 32 signed bits, as the driver's are
SEED = 2**31 + 12345

_CONFIG = registry.config


def tiny_config(name: str) -> dict:
    """The configuration ``name`` at a size the CPU runs in a second."""
    cfg = copy.deepcopy(_CONFIG(name))
    if cfg["driver"] == "fl_bank":
        cfg.update(num_clusters=2, devices_per_cluster=2, tau=1, q=2, pi=1,
                   image=[8, 8, 1], conv_channels=[4, 8], dense_width=16,
                   num_classes=5)
        cfg["leaves"] = [
            {"name": "c1.b", "shape": [4]},
            {"name": "c1.w", "shape": [5, 5, 1, 4], "fan_in": 25},
            {"name": "c2.b", "shape": [8]},
            {"name": "c2.w", "shape": [5, 5, 4, 8], "fan_in": 100},
            {"name": "f1.b", "shape": [16]},
            {"name": "f1.w", "shape": [32, 16], "fan_in": 32},
            {"name": "f2.b", "shape": [5]},
            {"name": "f2.w", "shape": [16, 5], "fan_in": 16}]
        cfg["params"] = sum(int(torch.tensor(leaf["shape"]).prod())
                            for leaf in cfg["leaves"])
        cfg["assumed"].update(samples_per_device=8, batch=4, eval_batch=16)
    else:
        raise KeyError(f"no tiny size for driver {cfg['driver']!r}")
    return cfg


class Refuse:
    """An import hook that refuses the top-level names a run may not
    load."""

    def __init__(self, names):
        self.names = tuple(names)

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"a run imported {name}")
        return None


def run_tiny(monkeypatch, workload: str, seconds: float = 0.2,
             trace: int = 0):
    """The harness's run of ``workload`` on the CPU at the tiny size:
    (exit code, the JSON of its last line or None, its standard
    error). The run is in this process, so JAX and the JAX package,
    which other tests load, are taken out of ``sys.modules`` and refused
    on import for its length, as a run's own process would hold
    neither."""
    from perfbench import run as harness
    for name in [m for m in sys.modules
                 if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(sys, "meta_path",
                        [Refuse(harness.FORBIDDEN)] + sys.meta_path)
    monkeypatch.setattr(registry, "config", tiny_config)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.run(["--workload", workload, "--seed", str(SEED),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
