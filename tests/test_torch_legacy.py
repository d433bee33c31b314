"""The port's legacy pytree engine (``FLSimulator(bank=False)``) against the
reference's.

The configuration of ``tests/test_sharded_bank.py`` (MLP 16-32-4, 4
clusters of 2 on a ring, tau 2, q 2, pi 4, batch 16, lr 0.1, seed 0) runs
two rounds in both packages from the same init and data: static, under
``mobile_sampled`` with ``chaos`` faults, with int8 uploads and error
feedback, with local DP (clip 1, noise multiplier 0.5), and under two
random ``schedule=`` programs of ``tests/test_program.py`` (adaptive
local steps, mid-program gossip; the second uploads top-k deltas). The
params, momentum and residual trees stay within 1e-5 (f32 sums in other
orders; the DP noise is the port's ``random.normal``, within 2 ulp of the
reference's). Inside the port, the legacy engine matches the bank engine
(1e-5) and resumes bit for bit, and its ``"legacy"`` checkpoints cross
to the reference and back.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.checkpoint import RunCheckpoint as RefRunCheckpoint
from repro.core.cefedavg import FLSimulator
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch import tree as tr
from repro_torch.checkpoint import RunCheckpoint
from repro_torch.convert import tree_from_numpy
from repro_torch.core import program as tprg
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.models.cnn import apply_mlp_classifier as t_apply
from test_program import random_program

ATOL = 1e-5
ROUNDS = 2
INIT = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0), 16, 32, 4))


def _program(pkg: str, seed: int, upload: bool):
    """``test_program.random_program`` of ``seed`` in package ``pkg`` (the
    first one that uploads where ``upload``, as that file draws it)."""
    rng = np.random.default_rng(seed)
    prog = random_program(rng, cases.NDEV, allow_upload=upload)
    while upload and not prog.has_upload:
        prog = random_program(rng, cases.NDEV, allow_upload=True)
    if pkg == "repro":
        return prog

    def port_op(op):
        if hasattr(op, "level"):   # IntraMix / InterGossip are TierMix
            return tprg.TierMix(op.level, op.pi)
        return getattr(tprg, type(op).__name__)(**dataclasses.asdict(op))
    return tprg.RoundProgram(tuple(port_op(op) for op in prog.ops),
                             tau_dev=prog.tau_dev)


#: name -> (torch_dist_cases case, extra simulator options)
CASES = {
    "static": ("static", {}),
    "mobile_chaos": ("mobile_chaos", {}),
    "int8_ef": ("int8_ef", {}),
    "local_dp": ("static", {"dp": (1.0, 0.5)}),
    "schedule": ("static", {"program": (2, False)}),
    "schedule_topk": ("static", {"program": (42, True),
                                 "compression": dict(kind="topk",
                                                     topk_frac=0.25)}),
}


def _kwargs(pkg: str, name: str):
    case, opt = CASES[name]
    fl, kw = cases.build(pkg, case)
    if "dp" in opt:
        prv = importlib.import_module(pkg + ".core.privacy")
        kw["dp"] = prv.DPConfig(*opt["dp"])
    if "program" in opt:
        kw["schedule"] = _program(pkg, *opt["program"])
    if "compression" in opt:
        cmp = importlib.import_module(pkg + ".core.compress")
        kw["compression"] = cmp.CompressionConfig(**opt["compression"])
    return fl, kw


def _ref(name, **extra):
    fl, kw = _kwargs("repro", name)
    data = {k: jnp.asarray(v) for k, v in cases.fl_data(fl.n).items()}
    return FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                       apply_mlp_classifier, fl, data, **kw, **extra)


def _port(name, **extra):
    fl, kw = _kwargs("repro_torch", name)
    return TSim(lambda g: tree_from_numpy(INIT), t_apply, fl,
                cases.fl_data(fl.n), device="cpu", **kw, **extra)


def _leaves(tree):
    if tree is None:
        return None
    return [np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor)
                       else leaf) for leaf in jax.tree.leaves(tree)]


def _gap(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _trees(sim) -> dict:
    return {"params": _leaves(sim.params), "mom": _leaves(sim.mom),
            "residual": _leaves(sim.residual)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_matches_reference(name):
    ref, port = _ref(name, bank=False), _port(name, bank=False)
    assert port.bank is None and port.store is None
    for _ in range(ROUNDS):
        ref.step_round()
        port.step_round()
    a, b = _trees(port), _trees(ref)
    gaps = {}
    for k in a:
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            gaps[k] = _gap(a[k], b[k])
    print(f"legacy {name}: port against the reference {gaps} (atol {ATOL})")
    assert max(gaps.values()) < ATOL, gaps
    np.testing.assert_allclose(port.evaluate(128), ref.evaluate(128),
                               atol=ATOL)
    for t, r in ((port.edge_models(), ref.edge_models()),
                 (port.global_model(), ref.global_model())):
        assert _gap(_leaves(t), _leaves(r)) < ATOL


@pytest.mark.parametrize("name", ["static", "mobile_chaos", "int8_ef"])
def test_legacy_matches_bank(name):
    """The port's two engines: per-leaf unfused mixing against the fused
    gossip-mix pass, mask-frozen full steps against compacted cohorts."""
    leg, bank = _port(name, bank=False), _port(name)
    for _ in range(ROUNDS):
        leg.step_round()
        bank.step_round()
    a, b = _trees(leg), _trees(bank)
    assert max(_gap(a[k], b[k]) for k in a if a[k] is not None) < ATOL
    assert leg._lowered.keys() and all(k[0] == "legacy"
                                       for k in leg._lowered)


def test_legacy_kill_and_resume_is_bitwise(tmp_path):
    full, killed = _port("int8_ef", bank=False), _port("int8_ef", bank=False)
    for _ in range(3):
        full.step_round()
    for _ in range(2):
        killed.step_round()
    RunCheckpoint(str(tmp_path)).save(killed, round_idx=2)
    resumed = _port("int8_ef", bank=False)
    meta = RunCheckpoint(str(tmp_path)).restore(resumed)
    assert meta["round"] == 2 and meta["engine"] == "legacy"
    resumed.step_round()
    a, b = _trees(full), _trees(resumed)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(full.key, resumed.key)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_legacy_checkpoint_crosses(tmp_path, direction):
    """A legacy run checkpoint of one package restores into the other's
    legacy engine tree for tree, and the next round agrees with the
    writer's within 1e-5."""
    make_w, make_r = (_ref, _port) if direction == "ref_to_port" \
        else (_port, _ref)
    rc_w, rc_r = ((RefRunCheckpoint, RunCheckpoint)
                  if direction == "ref_to_port"
                  else (RunCheckpoint, RefRunCheckpoint))
    writer = make_w("int8_ef", bank=False)
    writer.step_round()
    rc_w(str(tmp_path)).save(writer, round_idx=1)
    reader = make_r("int8_ef", bank=False)
    meta = rc_r(str(tmp_path)).restore(reader)
    assert meta["engine"] == "legacy" and meta["round"] == 1
    a, b = _trees(writer), _trees(reader)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    writer.step_round()
    reader.step_round()
    a, b = _trees(writer), _trees(reader)
    assert max(_gap(a[k], b[k]) for k in a) < ATOL


def test_legacy_state_and_guards():
    sim = _port("static", bank=False)
    # the tree properties write through
    sim.params = tr.tree_map(lambda x: x * 0.0, sim.params)
    assert all(float(leaf.abs().max()) == 0.0
               for leaf in tr.tree_leaves(sim.params))
    assert sim.residual is None
    fn = sim._round
    assert callable(fn) and ("legacy", sim._canonical.signature) \
        in sim._lowered
    from repro_torch.core.runtime import compute_bound_runtime_model
    with pytest.raises(ValueError, match="bank engine"):
        sim.step_round_async(0, compute_bound_runtime_model())
    with pytest.raises(ValueError, match="bank engine"):
        _port("static", bank=False, streaming=True)
