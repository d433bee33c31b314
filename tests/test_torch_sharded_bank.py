"""The port's device-parallel bank engine (``repro_torch.core.sharded.
ShardedBankCEFedAvg``) on one gloo world of 8 CPU ranks, against the
reference's single-device ``FLSimulator``.

The world is spawned once for the module (``torch_dist_cases.
sharded_bank_world``: one intra-op thread a rank, a free port); while it
runs, this process computes the reference's runs of the same cases from
the same numpy inputs — the reference's own oracle for its sharded engine
(``tests/test_sharded_bank.py``), which needs no 8-device XLA host here.

- Trajectories: every case of ``CASES`` (static, the ``lognormal`` +
  mobility + sampling scenario, ``mobile_sampled`` + ``chaos`` faults,
  int8 + EF uploads, the four baselines, ``pods=2``, depth 3 static and
  under a scenario, ``adaptive_tau``, ``pi_decay``, async at s = 2)
  within the reference's ATOL = 2e-4 (f32 sums in another order); the
  observed gaps are printed.
- Structure: every rank holds (1, T) buffers, init included (the
  full-bank constructor is forbidden while the sims are built); static
  and depth-3 rounds issue no gather, and a rank's received ppermute
  bytes a round are at most ``models_received_per_replica() × T × 4``
  (equal on the ring of 4); scenario rounds take R−1 rotations a group.
- Kill-and-resume inside the port, bit for bit; checkpoints cross from
  the sharded engine to the single-process port and to the reference,
  and back, row for row.
- The ``--engine bank`` launcher: its rank function resumes bit for bit
  with every bank flag, one spawned run end to end, and its guards
  (NCCL with more ranks than cards refused before any rank starts).
"""
import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.checkpoint import RunCheckpoint as RefRunCheckpoint
from repro.core.cefedavg import FLSimulator
from repro.core.runtime import compute_bound_runtime_model
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.checkpoint import RunCheckpoint
from repro_torch.checkpoint.ckpt import load_checkpoint
from repro_torch.convert import tree_from_numpy
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.launch import mesh as lm
from repro_torch.launch import train
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

ATOL = 2e-4
NDEV = cases.NDEV
INIT = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0), 16, 32, 4))
RT = compute_bound_runtime_model()


def _data(n):
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(200, 16, 4, seed=4)
    parts = dirichlet_partition(y, n, alpha=0.5, seed=5)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def _ref(name, **extra):
    fl, kw = cases.build("repro", name)
    kw.update(extra)
    return FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                       apply_mlp_classifier, fl,
                       {k: jnp.asarray(v) for k, v in _data(fl.n).items()},
                       **kw)


def _port(name, **extra):
    fl, kw = cases.build("repro_torch", name)
    kw.update(extra)
    return TSim(lambda g: tree_from_numpy(INIT), t_apply, fl, _data(fl.n),
                device="cpu", **kw)


def _rows(sim):
    """Host copies of the bank's buffers (either package's sim)."""
    b = sim.bank
    return {k: None if v is None else np.array(
        v.numpy() if isinstance(v, torch.Tensor) else v, copy=True)
        for k, v in (("params", b.params), ("mom", b.mom),
                     ("residual", b.residual))}


def _int8(pkg):
    import importlib
    return {"compression": importlib.import_module(
        pkg + ".core.compress").CompressionConfig("int8")}


@pytest.fixture(scope="module")
def crossing(tmp_path_factory):
    """Checkpoints of the reference and of the single-process port (the
    ``mobile_chaos`` case with int8+EF uploads, after one round) for the
    world to restore, and both sims' next round."""
    d = tmp_path_factory.mktemp("sharded")
    out = {"dir": str(d)}
    for what, make, rc_cls in (("ref", _ref, RefRunCheckpoint),
                               ("port", _port, RunCheckpoint)):
        sim = make("mobile_chaos", **_int8("repro" if what == "ref"
                                            else "repro_torch"))
        sim.step_round()
        path = str(d / what)
        rc_cls(path).save(sim, round_idx=1)
        out[what] = path
        out[what + "_saved"] = _rows(sim)
        sim.step_round()
        out[what + "_next"] = _rows(sim)
    return out


@pytest.fixture(scope="module")
def world(crossing):
    """The 8-rank world, started here and read by ``ranks``: the
    reference's runs (``refs``) are computed meanwhile."""
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(lm.run_local_ranks, cases.sharded_bank_world, NDEV,
                    args=(INIT, crossing["dir"], crossing["ref"],
                          crossing["port"]),
                    device="cpu", timeout_s=600)
    yield fut
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(world):
    out = {}
    for name in cases.CASES:
        sim = _ref(name)
        plans = cases.run_case(sim, name, RT)
        out[name] = dict(_rows(sim), plans=plans, eval=sim.evaluate(128),
                         tau_dev=(np.asarray(sim.last_program.tau_dev)
                                  if sim.last_program is not None
                                  and sim.last_program.adaptive else None))
    return out


@pytest.fixture(scope="module")
def ranks(world):
    return world.result()


def _stack(ranks, name, key):
    return np.concatenate([r[name][key] for r in ranks])


# ---------------------------------------------------------------------------
# trajectories against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_bank_matches_reference(refs, ranks, name):
    ref = refs[name]
    gaps = {}
    for key in ("params", "mom", "residual"):
        if ref[key] is None:
            assert ranks[0][name][key] is None
            continue
        got = _stack(ranks, name, key)
        gaps[key] = float(np.abs(got - ref[key]).max())
    print(f"{name}: max abs gap to the reference "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (atol {ATOL})")
    assert all(v < ATOL for v in gaps.values()), gaps
    for r in ranks:
        for mine, theirs in zip(r[name]["plans"], ref["plans"]):
            if theirs is None:
                assert mine is None
                continue
            np.testing.assert_array_equal(mine[0], np.asarray(theirs[0]))
            np.testing.assert_array_equal(mine[1], np.asarray(theirs[1]))


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_bank_is_bitwise_the_card_checks_witness(ranks, name):
    """``chip_smoke.py``'s witness for whole sharded rounds on the card:
    the single-process port engine taking its SGD steps one row at a
    time and summing each boundary in the sharded lowering's order
    reproduces the sharded bank bit for bit."""
    cs = cases.chip_smoke()
    sim = _port(name)
    cs._one_row_at_a_time(sim)
    cs._lowering_order_mixing(sim)
    cases.run_case(sim, name, RT)
    for key, want in _rows(sim).items():
        if want is None:
            assert ranks[0][name][key] is None
            continue
        np.testing.assert_array_equal(_stack(ranks, name, key), want)


def test_scenario_cases_sample_partial_cohorts(ranks):
    for name in ("scenario", "depth3_scenario"):
        masks = [p[0] for p in ranks[0][name]["plans"]]
        assert any(m.sum() < NDEV for m in masks), name


def test_evaluation_matches_reference(refs, ranks):
    """Edge models summed by one all_reduce of each rank's row times its
    projection column: the reference's accuracy, and loss within 1e-4."""
    for name in ("static", "mobile_chaos", "depth3"):
        acc_r, loss_r = refs[name]["eval"]
        for r in ranks:
            acc, loss = r[name]["eval"]
            assert acc == pytest.approx(acc_r, abs=1e-6), name
            assert loss == pytest.approx(loss_r, abs=1e-4), name
    rows = _stack(ranks, "static", "params")
    for r in ranks:
        np.testing.assert_allclose(r["static"]["global_row"], rows.mean(0),
                                   atol=1e-6, rtol=0)


def test_adaptive_cutoffs_and_pi_decay_lowering(refs, ranks):
    want = refs["adaptive_tau"]["tau_dev"]
    assert want is not None
    for r in ranks:
        np.testing.assert_array_equal(r["adaptive_tau"]["tau_dev"], want)
        # decay_round=5: only the early program lowered so far
        assert r["pi_decay"]["lowered"] == 1


# ---------------------------------------------------------------------------
# memory and traffic contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_every_rank_holds_its_own_row(ranks, name):
    """(1, T) params, momentum and residual on every rank, rank r holding
    global row r (the sims were built with ``ModelBank.from_model``
    forbidden: init never builds the full bank)."""
    T = ranks[0][name]["T"]
    for r, res in enumerate(ranks):
        assert res[name]["rows"] == (r, r + 1)
        assert res[name]["shapes"] and all(
            s == (1, T) for s in res[name]["shapes"])


@pytest.mark.parametrize("name", ["static", "depth3"])
def test_static_rounds_gossip_without_gathering(ranks, name):
    """No gather of the bank in a static or depth-3 round; the ppermute
    bytes a rank receives at the fused boundary stay within
    ``models_received_per_replica() × T × 4`` — equal on the ring of 4,
    where every cluster has two neighbors."""
    T = ranks[0][name]["T"]
    bound = ranks[0][name]["gossip_bound"] * T * 4
    assert bound > 0
    for res in ranks:
        for tr in res[name]["traffic"]:
            assert "gather" not in tr and "all_gather" not in tr, tr
            assert tr["all_reduce"]["calls"] > 0
            recv = tr["ppermute"]["recv"]
            assert recv <= bound, (recv, bound)
            if name == "static":
                assert recv == bound, (recv, bound)


def test_scenario_rounds_take_weighted_rotations(ranks):
    """Masked and faulted operators run R−1 rotations of the row a mixing
    group, and no grouped mean or gather."""
    T = ranks[0]["mobile_chaos"]["T"]
    for res in ranks:
        for tr in res["mobile_chaos"]["traffic"]:
            assert set(tr) == {"ppermute"}, tr
            calls = tr["ppermute"]["calls"]
            assert calls % (NDEV - 1) == 0
            assert tr["ppermute"]["recv"] == calls * T * 4


def test_engine_guards(ranks):
    g = ranks[0]["guards"]
    assert "one bank row per replica device: n=4, devices=8" in \
        g["n_mismatch"]
    assert g["streaming"].startswith("ValueError") and \
        "ShardedStreamedBank" in g["streaming"]
    assert "is not the mesh's cpu" in g["device"]
    assert g["world"].startswith("need 4 devices for 4 bank rows, have 8")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["int8_ef_chaos", "async_s2"])
def test_kill_and_resume_is_bitwise(ranks, what):
    for res in ranks:
        got = res["resume"][what]
        assert got["rounds"] == 3
        assert got["bitwise"] and got["hist"], got


def test_sharded_checkpoint_restores_in_port_and_reference(ranks):
    """Rank 0 wrote the gathered rows; the single-process port and the
    reference restore them row for row and continue within ATOL of the
    sharded run's next round."""
    ck = ranks[0]["ckpt"]
    saved = {k: np.concatenate([r["ckpt"]["saved"][k] for r in ranks])
             for k in ("params", "mom", "residual")}
    nxt = np.concatenate([r["ckpt"]["saved_next"]["params"] for r in ranks])
    for what, make, rc_cls in (("port", _port, RunCheckpoint),
                               ("ref", _ref, RefRunCheckpoint)):
        sim = make("mobile_chaos", **_int8("repro" if what == "ref"
                                            else "repro_torch"))
        meta = rc_cls(ck["saved_dir"]).restore(sim)
        assert meta["round"] == 2
        have = _rows(sim)
        for k in saved:
            np.testing.assert_array_equal(have[k], saved[k], err_msg=what)
        sim.step_round()
        gap = float(np.abs(_rows(sim)["params"] - nxt).max())
        print(f"restored in {what}, next round: max abs gap {gap:.3e}")
        assert gap < ATOL, (what, gap)


@pytest.mark.parametrize("what", ["ref", "port"])
def test_checkpoints_restore_into_sharded(crossing, ranks, what):
    """The reference's and the single-process port's checkpoints give
    each rank its own rows, bit for bit, and the next round agrees."""
    state, _ = load_checkpoint(os.path.join(crossing[what], "run.npz"))
    got = [r["ckpt"]["from_" + what] for r in ranks]
    assert all(g["round"] == 1 for g in got)
    for k in ("params", "mom", "residual"):
        rows = np.concatenate([g["restored"][k] for g in got])
        np.testing.assert_array_equal(rows, crossing[what + "_saved"][k])
        np.testing.assert_array_equal(rows, state["/bank/" + k])
    nxt = np.concatenate([g["next"]["params"] for g in got])
    gap = float(np.abs(nxt - crossing[what + "_next"]["params"]).max())
    print(f"{what} checkpoint continued sharded: max abs gap {gap:.3e}")
    assert gap < ATOL


# ---------------------------------------------------------------------------
# the --engine bank launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["static_hier", "async"])
def test_launcher_resumes_bitwise(ranks, what):
    """Every bank flag at once (hierarchy 2,2,2, mobile_sampled + chaos,
    pi_decay, and s = 2): 3 rounds against 2 + checkpoint + resume."""
    for res in ranks:
        got = res["launcher"][what]
        full, resumed = got["full"], got["resumed"]
        np.testing.assert_array_equal(full["row"], resumed["row"])
        assert full["row"].shape[0] == 1
        for col in ("round", "wall_time", "acc", "loss", "participants"):
            assert full["hist"][col] == resumed["hist"][col], col
        assert resumed["hist"]["round"] == [1, 2, 3]


def test_launcher_spawns_local_ranks(capsys):
    out = train.main(["--engine", "bank", "--data-parallel", "4",
                      "--dist-backend", "gloo", "--device", "cpu",
                      "--rounds", "1", "--clusters", "2"])
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    assert all(r["row"].shape == out[0]["row"].shape for r in out)
    assert np.isfinite(out[0]["hist"]["loss"]).all()
    # every rank evaluated the same edge models
    assert len({r["hist"]["acc"][0] for r in out}) == 1


def test_launcher_guards(monkeypatch, tmp_path):
    bank = ["--engine", "bank", "--data-parallel", "8"]
    for argv in (["--schedule", "adaptive_tau"], ["--pipeline"],
                 ["--resume"] + bank,
                 ["--population", "100", "--faults", "chaos"]):
        with pytest.raises(SystemExit):
            train.main(argv)
    # the default pytree engine runs on the card unless told otherwise
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--rounds", "1"])
    # tensor parallelism within a replica: 2 ranks (gloo, CPU) train
    # reduced qwen2 and checkpoint the gathered replica average, the
    # file of --model-parallel 1
    ckpt = str(tmp_path / "tp.npz")
    out = train.main(["--reduced", "--rounds", "1", "--model-parallel", "2",
                      "--dist-backend", "gloo", "--device", "cpu",
                      "--ckpt", ckpt])
    assert len(out) == 2 and out[0]["model_traffic"]["all_reduce"]["calls"]
    assert out[0]["hist"]["loss"] == out[1]["hist"]["loss"]
    from repro.checkpoint import load_checkpoint
    from repro.configs import get_model_config
    from repro.models import model as rm
    shapes = jax.eval_shape(lambda k: rm.init_model(
        k, get_model_config("qwen2-0.5b").reduced())[0],
        jax.random.PRNGKey(0))
    tree, meta = load_checkpoint(ckpt, like=shapes)
    assert meta == {"arch": "qwen2-0.5b", "rounds": 1}
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and np.isfinite(a).all()
    # the bank and population engines keep one rank a row
    for argv in (bank + ["--model-parallel", "2"],
                 ["--population", "100", "--model-parallel", "2"]):
        with pytest.raises(ValueError, match="not tensor-parallel"):
            train.main(argv + ["--dist-backend", "gloo", "--device", "cpu"])
    # --population with --data-parallel runs the sharded streamed bank
    # (ROADMAP A14's streamed half): NCCL refuses the CPU, gloo runs it
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors"):
        train.main(["--population", "100", "--data-parallel", "2",
                    "--device", "cpu"])
    ranks = train.main(["--population", "100", "--data-parallel", "2",
                        "--device", "cpu", "--dist-backend", "gloo",
                        "--rounds", "1"])
    assert len(ranks) == 2 and ranks[1]["peak_rank_slab_bytes"] > 0
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors"):
        train.main(bank + ["--device", "cpu"])
    # NCCL with more ranks than cards: refused before any rank starts
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def no_spawn(*a, **kw):
        raise AssertionError("a rank was started")
    monkeypatch.setattr(torch.multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="NCCL puts one rank on each "
                                           "card: 8 ranks need 8 cards"):
        train.main(bank)
    with pytest.raises(RuntimeError, match="one rank on each card"):
        lm.run_local_ranks(print, 3, backend="nccl")
