"""Crash-consistent resume in the port (twins of ``tests/test_resume.py``)
and across the two packages.

Inside the port a run killed at round k and resumed from its
RunCheckpoint replays rounds k..R bit for bit: parameters, momentum, the
EF residual, schedule state and the recorded history (the host-seconds
columns aside), for the flat engine at staleness None, 0 and 2, with
error feedback, with a ``pi_feedback`` schedule, and for the streamed
pipelined population. Across the packages the checkpoint's tree is the
same: the reference saves at round 2 and the port, restored from it,
runs round 3 within 1e-5 of the reference's uninterrupted run (f32 sums
in another order over one round); a port checkpoint loads in the
reference's ``load_checkpoint(like=...)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import RunCheckpoint as RefRunCheckpoint
from repro.checkpoint.ckpt import load_checkpoint as ref_load
from repro.checkpoint.runckpt import _capture as ref_capture
from repro.config import FLConfig, FaultConfig, ScenarioConfig
from repro.core.cefedavg import FLSimulator
from repro.core.clock import run_wall_clock as ref_run_wall_clock
from repro.core.compress import CompressionConfig
from repro.core.runtime import paper_runtime_model
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.checkpoint import RunCheckpoint
from repro_torch.config import FaultConfig as TFaultConfig
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.config import PopulationConfig as TPopulationConfig
from repro_torch.config import ScenarioConfig as TScenarioConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.clock import EventClock, run_wall_clock
from repro_torch.core.compress import CompressionConfig as TCompression
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

ATOL = 1e-5
FLKW = dict(num_clusters=4, devices_per_cluster=3, tau=2, q=1, pi=2,
            topology="ring")
SCKW = dict(name="chaos", speed_dist="lognormal", speed_spread=0.5)
FAULTKW = dict(outage_prob=0.2, outage_len=2, link_drop_prob=0.15,
               timeout_factor=1.2, max_retries=2, seed=11)
INIT = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(1), 16, 32, 4))


def _data(n):
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    parts = dirichlet_partition(y, n, alpha=0.5, seed=5)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def _port(*, scenario=True, schedule=None, compression=None):
    fl = TFLConfig(**FLKW)
    sc = (TScenarioConfig(faults=TFaultConfig(**FAULTKW), **SCKW)
          if scenario else None)
    return TSim(lambda g: tree_from_numpy(INIT), t_apply, fl, _data(fl.n),
                lr=0.1, batch_size=16, seed=1, scenario=sc,
                schedule=schedule, compression=compression, device="cpu")


def _ref(*, scenario=True, compression=None):
    fl = FLConfig(**FLKW)
    sc = (ScenarioConfig(faults=FaultConfig(**FAULTKW), **SCKW)
          if scenario else None)
    data = {k: jnp.asarray(v) for k, v in _data(fl.n).items()}
    return FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                       apply_mlp_classifier, fl, data, lr=0.1,
                       batch_size=16, seed=1, scenario=sc,
                       compression=compression)


def _replayable(hist):
    """The history without its host-seconds columns (real elapsed time)."""
    return {k: v for k, v in hist.items()
            if k not in ("page_s", "compute_s", "eval_s")}


def _state(sim):
    b = sim.bank
    out = [b.params.numpy().copy(), b.mom.numpy().copy()]
    if b.residual is not None:
        out.append(b.residual.numpy().copy())
    return out


def _run(tmpdir, make, *, kill_at=None, rounds=8, staleness=None):
    """One trajectory through run_wall_clock with per-round checkpoints;
    ``kill_at`` truncates the first pass and resumes a FRESH sim."""
    d = str(tmpdir)
    rt = t_runtime()
    kw = dict(eval_every=2, ckpt_dir=d, ckpt_every=1,
              async_staleness=staleness)
    sim = make()
    if kill_at is None:
        return sim, run_wall_clock(sim, rt, rounds, **kw)
    run_wall_clock(sim, rt, kill_at, **kw)
    sim2 = make()
    return sim2, run_wall_clock(sim2, rt, rounds, resume=True, **kw)


@pytest.mark.parametrize("staleness", [None, 0, 2])
def test_flat_engine_kill_and_resume_bit_identical(tmp_path, staleness):
    ref_sim, ref = _run(tmp_path / "ref", _port, staleness=staleness)
    got_sim, got = _run(tmp_path / "killed", _port, kill_at=3,
                        staleness=staleness)
    assert _replayable(ref) == _replayable(got)
    for a, b in zip(_state(ref_sim), _state(got_sim)):
        np.testing.assert_array_equal(a, b)


def test_resume_with_error_feedback_residual(tmp_path):
    """The EF residual is part of the run state: dropping it from the
    checkpoint would change the post-resume trajectory."""
    def make():
        return _port(compression=TCompression(kind="topk", topk_frac=0.25,
                                              error_feedback=True))
    ref_sim, ref = _run(tmp_path / "ref", make, rounds=6)
    got_sim, got = _run(tmp_path / "killed", make, rounds=6, kill_at=3)
    assert got_sim.bank.residual is not None
    assert float(got_sim.bank.residual.abs().max()) > 0
    assert _replayable(ref) == _replayable(got)
    for a, b in zip(_state(ref_sim), _state(got_sim)):
        np.testing.assert_array_equal(a, b)


def test_resume_restores_schedule_state(tmp_path):
    def make():
        return _port(schedule="pi_feedback")
    ref_sim, ref = _run(tmp_path / "ref", make)
    got_sim, got = _run(tmp_path / "killed", make, kill_at=4)
    assert _replayable(ref) == _replayable(got)
    assert ref_sim._schedule_fn.state == got_sim._schedule_fn.state
    # the post-resume depths match the uninterrupted run's tail
    k = len(got_sim._schedule_fn.pi_trace)
    assert (ref_sim._schedule_fn.pi_trace[-k:]
            == got_sim._schedule_fn.pi_trace)


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    sim = _port()
    hist = run_wall_clock(sim, t_runtime(), 2, eval_every=1,
                          ckpt_dir=str(tmp_path), ckpt_every=1,
                          resume=True)   # nothing to resume
    assert hist["round"] == [1, 2]
    assert RunCheckpoint(str(tmp_path)).exists()


def _population_sim(codec):
    fl = TFLConfig(num_clusters=4, devices_per_cluster=4, tau=2, q=2, pi=2,
                   topology="ring")
    sc = TScenarioConfig(
        name="mobile", sample_fraction=0.5, dropout_prob=0.1,
        move_prob=0.25, seed=7,
        population=TPopulationConfig(clients_per_cluster=100,
                                     cohort_per_cluster=3, codec=codec))
    return TSim(lambda g: tree_from_numpy(INIT), t_apply, fl, _data(fl.n),
                lr=0.1, batch_size=16, seed=1, scenario=sc, pipeline=True,
                device="cpu")


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_streamed_pipelined_kill_and_resume_bit_identical(tmp_path, codec):
    """The pipelined population run restored from its store snapshot (the
    in-flight page-out landed before the save, the device references
    re-seeded after the restore) replays its rounds bit for bit."""
    def make():
        return _population_sim(codec)
    ref_sim, ref = _run(tmp_path / "ref", make, rounds=5)
    got_sim, got = _run(tmp_path / "killed", make, rounds=5, kill_at=3)
    assert _replayable(ref) == _replayable(got)
    a, b = ref_sim.store.snapshot(), got_sim.store.snapshot()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(
        got_sim.layout.flatten_one(got_sim.global_model()).numpy(),
        ref_sim.layout.flatten_one(ref_sim.global_model()).numpy())


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "topk_ef"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, ef):
    """The reference saves at round 2 (its event clock and history with
    it); the port restores it into a fresh sim, clock and history and runs
    round 3, whose bank, residual and evaluation agree with the
    reference's uninterrupted third round."""
    comp = (dict(kind="topk", topk_frac=0.25, error_feedback=True)
            if ef else None)
    rt = paper_runtime_model()
    ref = _ref(compression=None if comp is None
               else CompressionConfig(**comp))
    saved = ref_run_wall_clock(ref, rt, 2, eval_every=1,
                               ckpt_dir=str(tmp_path), ckpt_every=1)
    full = _ref(compression=None if comp is None
                else CompressionConfig(**comp))
    ref_hist = ref_run_wall_clock(full, rt, 3, eval_every=1)

    port = _port(compression=None if comp is None else TCompression(**comp))
    clock = EventClock(t_runtime(), port.fl)
    hist = {k: [] for k in saved}
    meta = RunCheckpoint(str(tmp_path)).restore(port, clock=clock,
                                                hist=hist)
    assert meta["round"] == 2 and port.round_index == 2
    assert hist == saved and clock.now == saved["wall_time"][-1]
    np.testing.assert_array_equal(port.key, np.asarray(ref.key))
    port.step_round()
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(full.bank.params), atol=ATOL)
    np.testing.assert_allclose(port.bank.mom.numpy(),
                               np.asarray(full.bank.mom), atol=ATOL)
    if ef:
        np.testing.assert_allclose(port.bank.residual.numpy(),
                                   np.asarray(full.bank.residual),
                                   atol=ATOL)
    acc, loss = port.evaluate()
    assert abs(loss - ref_hist["loss"][-1]) <= ATOL
    assert abs(acc - ref_hist["acc"][-1]) <= 1.0 / 400 + 1e-9


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """A port run's checkpoint has the reference's tree: the reference's
    ``load_checkpoint`` takes it against a reference sim's ``like`` tree,
    and ``RunCheckpoint.restore`` continues it in the reference."""
    port = _port(compression=TCompression(kind="int8"))
    for _ in range(2):
        port.step_round()
    RunCheckpoint(str(tmp_path)).save(port, round_idx=2)
    ref = _ref(compression=CompressionConfig(kind="int8"))
    like = ref_capture(ref, 0, None, None, None)
    state, meta = ref_load(str(tmp_path / "run.npz"), like=like)
    assert meta["round"] == 2 and meta["engine"] == "bank"
    np.testing.assert_array_equal(state["bank"]["residual"],
                                  port.bank.residual.numpy())
    RefRunCheckpoint(str(tmp_path)).restore(ref)
    np.testing.assert_array_equal(np.asarray(ref.bank.params),
                                  port.bank.params.numpy())
    np.testing.assert_array_equal(np.asarray(ref.key), port.key)
    assert ref.round_index == port.round_index == 2
    np.testing.assert_array_equal(ref.engine.labels, port.engine.labels)
    # both continue one round from the same state
    ref.step_round()
    port.step_round()
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=ATOL)


def _mobile_chaos(pkg):
    """``mobile_sampled`` + ``chaos`` faults, 4 clusters x 2
    (``torch_dist_cases``' case), from INIT in either package."""
    import torch_dist_cases as cases
    fl, kw = cases.build(pkg, "mobile_chaos")
    data = _data(fl.n)
    if pkg == "repro":
        return FLSimulator(lambda k: jax.tree.map(jnp.asarray, INIT),
                           apply_mlp_classifier, fl,
                           {k: jnp.asarray(v) for k, v in data.items()},
                           **kw)
    return TSim(lambda g: tree_from_numpy(INIT), t_apply, fl, data,
                device="cpu", **kw)


def test_async_checkpoint_crosses_the_packages(tmp_path):
    """An async (s = 2) run checkpointed at round 2 and continued one
    round in the other package (ROADMAP C4). The file carries the event
    clock's timeline carry; the port's restore hands it to the sim, the
    reference's does not (C4 stands there). So the port continues a
    reference checkpoint as its own uninterrupted run, and the reference
    continues a port checkpoint from a cold timeline, as it continues
    its own, which here differs from its uninterrupted run."""
    from repro.checkpoint import RunCheckpoint as RefRC
    from repro.core.clock import EventClock as RefClock
    from repro.core.runtime import compute_bound_runtime_model
    from repro_torch.core.runtime import compute_bound_runtime_model as t_rt
    S, rt, trt = 2, compute_bound_runtime_model(), t_rt()
    kw = dict(eval_batch=128, async_staleness=S, ckpt_every=2)
    ref_saved = ref_run_wall_clock(_mobile_chaos("repro"), rt, 2,
                                   ckpt_dir=str(tmp_path / "ref"), **kw)
    port_saved = run_wall_clock(_mobile_chaos("repro_torch"), trt, 2,
                                ckpt_dir=str(tmp_path / "port"), **kw)
    ref_full, port_full = _mobile_chaos("repro"), _mobile_chaos(
        "repro_torch")
    ref_run_wall_clock(ref_full, rt, 3, eval_batch=128, async_staleness=S)
    run_wall_clock(port_full, trt, 3, eval_batch=128, async_staleness=S)

    port = _mobile_chaos("repro_torch")
    RunCheckpoint(str(tmp_path / "ref")).restore(
        port, clock=EventClock(trt, port.fl),
        hist={k: [] for k in ref_saved}, staleness=S)
    port.step_round_async(S, trt)
    np.testing.assert_allclose(port.bank.params.numpy(),
                               port_full.bank.params.numpy(), atol=ATOL)

    def ref_resumed(path, saved):
        ref = _mobile_chaos("repro")
        RefRC(str(path)).restore(ref, clock=RefClock(rt, ref.fl),
                                 hist={k: [] for k in saved}, staleness=S)
        ref.step_round_async(S, rt)
        return np.asarray(ref.bank.params)
    from_ref = ref_resumed(tmp_path / "ref", ref_saved)
    from_port = ref_resumed(tmp_path / "port", port_saved)
    np.testing.assert_allclose(from_port, from_ref, atol=ATOL)
    # the cold timeline reorders this round's events: without the carry
    # the port's continuation above could not match
    assert np.abs(from_ref - np.asarray(ref_full.bank.params)).max() \
        > 100 * ATOL


def test_restore_rejects_another_configuration(tmp_path):
    """A checkpoint of a run with an EF residual does not restore into a
    sim without one: the structure error names the residual's path."""
    from repro_torch.checkpoint import CheckpointStructureError
    sim = _port(compression=TCompression(kind="topk", topk_frac=0.25))
    rc = RunCheckpoint(str(tmp_path))
    rc.save(sim, round_idx=0)
    with pytest.raises(CheckpointStructureError) as ei:
        rc.restore(_port())
    assert ei.value.extra == ("/bank/residual",)


def test_load_rows_writes_in_place_and_checks_shapes():
    """``ModelBank.load_rows`` writes in place and checks shapes."""
    sim = _port()
    b = sim.bank
    ptr = b.params.data_ptr()
    rows = np.full(tuple(b.params.shape), 0.5, np.float32)
    b.load_rows(rows, rows)
    assert b.params.data_ptr() == ptr
    assert torch.equal(b.params, torch.from_numpy(rows))
    with pytest.raises(ValueError, match="do not match"):
        b.load_rows(rows[:1], rows)
