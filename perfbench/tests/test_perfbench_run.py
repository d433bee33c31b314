"""Whole runs of the harness on the CPU at the tiny size: the result line,
the refusal without a card, the modules a run loads, and the
comparison failing under a lower precision and under each fault of the
timed path."""
import json
import sys

import pytest
import torch

import perfbench_tiny as T
from perfbench import compare, registry
from perfbench import run as harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["femnist.resident", "femnist.upload_int8"])
def test_last_line_carries_the_contract_keys(cell, monkeypatch):
    rc, res, err = T.run_tiny(monkeypatch, cell)
    assert rc == 0, err
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert "round_s" in res["metrics"] and "setup_s" in res["metrics"]
    # no device metric from a CPU run
    assert "peak_mem_gib" not in res["metrics"]
    lim = registry.limits(cell)["limits"]
    assert set(res["checks"]) == set(lim)
    assert err.strip().splitlines()[-len(lim):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in res["checks"].items()]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.run(["--workload", "femnist.resident", "--seed", "1",
                      "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_run_loads_neither_jax_nor_the_jax_package(monkeypatch):
    """Runs with JAX and the JAX package ``repro`` out of ``sys.modules``
    and refused on import (``run_tiny``; ``repro_torch`` is not
    ``repro``): a run that loads either fails."""
    for cell in ("femnist.resident", "femnist.upload_int8"):
        rc, res, err = T.run_tiny(monkeypatch, cell, seconds=0.01)
        assert rc == 0, err
        assert harness.forbidden_modules() == []
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}


def test_femnist_comparison_fails_in_bf16():
    """The reference computed in bfloat16, put in the program's place,
    fails the cell's comparison (the card's control is TF32, which a CPU
    does not have)."""
    from perfbench.drivers import fl_bank
    cfg = T.tiny_config("femnist_cnn")
    mix = registry.mix("resident_full")
    dev = torch.device("cpu")
    ref = fl_bank.reference(cfg, mix, T.SEED, dev, 3)
    low = fl_bank.reference(cfg, mix, T.SEED, dev, 3, precision="bfloat16")
    got = fl_bank.gaps(low, ref)
    lim = registry.limits("femnist.resident")["limits"]
    rows = [(k, got[k], v) for k, v in lim.items()]
    assert not compare.verdict(rows), rows


# -- the timed path broken underneath a run ---------------------------------

def _frozen_round(self):
    """A round that returns the state unchanged."""
    self._begin_round()
    self._next_key()


def _half_batch(orig):
    def step(self, Y, M, xs, ys, idx, lr):
        return orig(self, Y, M, xs, ys, idx[:, :idx.shape[1] // 2], lr)
    return step


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "no_mix"])
def test_a_broken_fl_round_is_not_correct(fault, monkeypatch):
    from repro_torch.core import cefedavg
    if fault == "frozen":
        monkeypatch.setattr(cefedavg.FLSimulator, "step_round",
                            _frozen_round)
    elif fault == "half_batch":
        monkeypatch.setattr(cefedavg.FLSimulator, "_sgd_step",
                            _half_batch(cefedavg.FLSimulator._sgd_step))
    else:
        monkeypatch.setattr(cefedavg, "gossip_mix_rows", lambda W, Y: Y)
    rc, res, err = T.run_tiny(monkeypatch, "femnist.upload_int8"
                              if fault == "half_batch"
                              else "femnist.resident", seconds=0.01)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def test_result_line_is_one_json_object(monkeypatch):
    rc, res, _ = T.run_tiny(monkeypatch, "femnist.upload_int8",
                            seconds=0.01)
    assert rc == 0 and list(res) == KEYS
    assert "round_s" in res["metrics"]
    json.dumps(res)
