"""The port's round schedules, per-op clock pricing, fault penalty and
runtime helpers against ``repro.core.program`` / ``clock`` / ``runtime``.

Host-side quantities are numpy in both packages and compared EXACTLY:
``adaptive_tau_map``, ``block_programs``, the program each named
schedule picks round by round (ops and ``tau_dev``), the per-device
step counts and times, the fault penalty, the runtime helpers and the
``run_wall_clock`` columns ``wall_time`` and ``participants``. Banks
after 3 rounds of ``adaptive_tau`` and ``pi_decay`` agree within 1e-5
(the MLP 16-32-4 over 4 clusters of 4, τ=2, q=2, π=3, batch 16, lr 0.1,
scenario seed 7; f32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import FLConfig
from repro.core import clock as rclock
from repro.core import program as rprg
from repro.core import runtime as rrt
from repro.core.cefedavg import FLSimulator
from repro.core.scenario import get_faults, get_scenario
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import clock as tclock
from repro_torch.core import program as tprg
from repro_torch.core import runtime as trt
from repro_torch.core import scenario as tsc
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

FL_KW = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=4,
             tau=2, q=2, pi=3, topology="ring")
ATOL = 1e-5
ROUNDS = 3


def _data(n):
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    return build_fl_data(x, y, dirichlet_partition(y, n, 0.5, seed=5),
                         tx, ty, 64)


def _pair(sname="lognormal", fname=None, *, fl_kw=None, r_sched=None,
          t_sched=None):
    fl_kw = {**FL_KW, **(fl_kw or {})}
    n = fl_kw["num_clusters"] * fl_kw["devices_per_cluster"]
    data = _data(n)
    rs = ts = None
    if sname is not None:
        rs = dataclasses.replace(
            get_scenario(sname), seed=7,
            faults=None if fname is None else get_faults(fname))
        ts = dataclasses.replace(
            tsc.get_scenario(sname), seed=7,
            faults=None if fname is None else tsc.get_faults(fname))
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0),
                                              16, 32, 4))
    ref = FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                      apply_mlp_classifier, FLConfig(**fl_kw),
                      {k: jnp.asarray(v) for k, v in data.items()},
                      lr=0.1, batch_size=16, scenario=rs, schedule=r_sched)
    port = TSim(lambda g: tree_from_numpy(init), t_apply, TFLConfig(**fl_kw),
                data, lr=0.1, batch_size=16, scenario=ts, schedule=t_sched,
                device="cpu")
    return ref, port


def _record(sim):
    """Wrap ``sim.step_round`` to keep each round's program."""
    progs, step = [], sim.step_round

    def rec():
        plan = step()
        progs.append(sim.last_program)
        return plan
    sim.step_round = rec
    return progs


def _same_program(a, b):
    assert repr(b.ops) == repr(a.ops)
    assert (a.tau_dev is None) == (b.tau_dev is None)
    if a.tau_dev is not None:
        np.testing.assert_array_equal(b.tau_dev, a.tau_dev)


@pytest.mark.parametrize("seed", range(4))
def test_adaptive_tau_map_equals_reference(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 6))
    n = m * int(rng.integers(1, 5))
    labels = rng.integers(0, m, n)
    mask = (rng.random(n) < 0.7).astype(float)
    mult = rng.lognormal(-0.18, 0.6, n)
    for tau, floor in ((4, 1), (7, 2)):
        a = rprg.adaptive_tau_map(tau, labels, mask, mult, m, floor)
        b = tprg.adaptive_tau_map(tau, labels, mask, mult, m, floor)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


def test_block_programs_equal_reference():
    fl, tfl = FLConfig(**FL_KW), TFLConfig(**FL_KW)
    td = np.array([1, 2, 2, 1] * 4, np.int32)
    pairs = [(rprg.canonical_program(fl, faults=True),
              tprg.canonical_program(tfl, faults=True)),
             (rprg.make_schedule("adaptive_tau", fl,
                                 speeds=np.linspace(0.3, 1.5, 16))(0, None),
              tprg.make_schedule("adaptive_tau", tfl,
                                 speeds=np.linspace(0.3, 1.5, 16))(0, None)),
             (rprg.RoundProgram((rprg.LocalSteps(3, adaptive=True),
                                 rprg.IntraMix(), rprg.LocalSteps(2),
                                 rprg.IntraMix(), rprg.InterGossip(2)),
                                tau_dev=td),
              tprg.RoundProgram((tprg.LocalSteps(3, adaptive=True),
                                 tprg.IntraMix(), tprg.LocalSteps(2),
                                 tprg.IntraMix(), tprg.InterGossip(2)),
                                tau_dev=td))]
    for a, b in pairs:
        ra, rb = rprg.block_programs(a), tprg.block_programs(b)
        assert len(ra) == len(rb) == a.num_blocks
        for x, y in zip(ra, rb):
            _same_program(x, y)


@pytest.mark.parametrize("name", tprg.SCHEDULES)
def test_schedule_traces_and_banks_match_reference(name):
    """Three rounds of each named schedule under ``run_wall_clock`` with
    the compute-bound profile (whose compute term the adaptive cut-offs
    move) over a bimodal fleet (whose slow clusters get cut-offs below
    τ): the program of every round, the wall times, and the bank.
    ``pi_decay`` switches depth after round 1 here (its ``decay_round``
    passed through ``make_schedule``)."""
    if name == "pi_decay":
        r_s = rprg.make_schedule(name, FLConfig(**FL_KW), decay_round=1)
        t_s = tprg.make_schedule(name, TFLConfig(**FL_KW), decay_round=1)
    else:
        r_s = t_s = name
    ref, port = _pair("bimodal", r_sched=r_s, t_sched=t_s)
    rp, tp = _record(ref), _record(port)
    rh = rclock.run_wall_clock(ref, rrt.compute_bound_runtime_model(),
                               ROUNDS)
    th = tclock.run_wall_clock(port, trt.compute_bound_runtime_model(),
                               ROUNDS)
    assert len(rp) == len(tp) == ROUNDS
    for a, b in zip(rp, tp):
        _same_program(a, b)
    assert th["wall_time"] == rh["wall_time"]
    assert th["participants"] == rh["participants"]
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(port.bank.mom.numpy(),
                               np.asarray(ref.bank.mom), atol=ATOL, rtol=0)
    if name == "adaptive_tau":
        assert any((p.tau_dev < FL_KW["tau"]).any() for p in tp)
    if name == "pi_decay":
        assert [o.pi for o in tp[-1].ops
                if isinstance(o, tprg.InterGossip)] == [1]
    if name == "pi_feedback":
        assert port._schedule_fn.pi_trace == ref._schedule_fn.pi_trace
    if name == "adaptive_tau_online":
        np.testing.assert_array_equal(
            port._schedule_fn.estimator.multipliers,
            ref._schedule_fn.estimator.multipliers)


def test_tau_dev_cutoff_freezes_devices_mid_block():
    """The reference's cut-off setting (one cluster of 2, τ=3, cut-offs
    3 and 1): device 0 runs the static run's three steps, device 1 stops
    after one and keeps that state to the block's end; the bank equals
    the reference's."""
    fl_kw = dict(FL_KW, tau=3, q=1, pi=1, num_clusters=1,
                 devices_per_cluster=2)
    td = np.array([3, 1], np.int32)
    r_cut = rprg.RoundProgram((rprg.MaskRenorm(),
                               rprg.LocalSteps(3, adaptive=True),
                               rprg.IntraMix(), rprg.InterGossip(1)),
                              tau_dev=td)
    t_cut = tprg.RoundProgram((tprg.MaskRenorm(),
                               tprg.LocalSteps(3, adaptive=True),
                               tprg.IntraMix(), tprg.InterGossip(1)),
                              tau_dev=td)
    ref, port = _pair(None, fl_kw=fl_kw, r_sched=r_cut, t_sched=t_cut)
    _, static = _pair(None, fl_kw=fl_kw)
    ref.step_round()
    port.step_round()
    static.step_round()
    M, Ms = port.bank.mom.numpy(), static.bank.mom.numpy()
    np.testing.assert_allclose(M[0], Ms[0], atol=1e-6, rtol=0)
    assert np.abs(M[1] - Ms[1]).max() > 0
    np.testing.assert_allclose(M, np.asarray(ref.bank.mom), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("sname,fname", [("mobile_sampled", "chaos"),
                                         ("bimodal", "stragglers")])
def test_wall_clock_with_faults_matches_reference(sname, fname):
    """Histories under faults, with the straggler retry ladder charged
    (a bimodal fleet's slow devices exhaust their retries)."""
    ref, port = _pair(sname, fname)
    rh = rclock.run_wall_clock(ref, rrt.paper_runtime_model(), ROUNDS)
    th = tclock.run_wall_clock(port, trt.paper_runtime_model(), ROUNDS)
    assert th["wall_time"] == rh["wall_time"]
    assert th["participants"] == rh["participants"]
    np.testing.assert_allclose(th["loss"], rh["loss"], atol=ATOL, rtol=0)


def test_fault_penalty_and_device_steps_equal_reference():
    rt, trt_ = rrt.compute_bound_runtime_model(), \
        trt.compute_bound_runtime_model()
    ref_e = _pair("bimodal", "stragglers")[0].engine
    port_e = _pair("bimodal", "stragglers")[1].engine
    fc, tfc = get_faults("stragglers"), tsc.get_faults("stragglers")
    charged = 0
    for _ in range(4):
        rp, tp = ref_e.step(), port_e.step()
        speeds = port_e.speed_multipliers * trt_.hw.device_flops
        for r_prog, t_prog in (
                (rprg.canonical_program(FLConfig(**FL_KW), faults=True),
                 tprg.canonical_program(TFLConfig(**FL_KW), faults=True)),
                (rprg.make_schedule("adaptive_tau", FLConfig(**FL_KW),
                                    engine=ref_e)(0, rp),
                 tprg.make_schedule("adaptive_tau", TFLConfig(**FL_KW),
                                    engine=port_e)(0, tp))):
            a = rclock.fault_compute_penalty(rt, r_prog, fc, rp.fault,
                                             speeds, rp.mask)
            b = tclock.fault_compute_penalty(trt_, t_prog, tfc, tp.fault,
                                             speeds, tp.mask)
            assert a == b
            charged += b > 0
            np.testing.assert_array_equal(
                tclock.program_device_steps(t_prog, 16),
                rclock.program_device_steps(r_prog, 16))
            np.testing.assert_array_equal(
                tclock.program_device_times(trt_, t_prog, speeds),
                rclock.program_device_times(rt, r_prog, speeds))
    assert charged >= 1


def test_online_speed_estimator_equals_reference():
    a, b = rprg.OnlineSpeedEstimator(6, 0.3), tprg.OnlineSpeedEstimator(6,
                                                                        0.3)
    assert not b.ready
    np.testing.assert_array_equal(b.multipliers, np.ones(6))
    rng = np.random.default_rng(2)
    for _ in range(4):
        steps = rng.integers(0, 4, 6).astype(float)
        times = rng.random(6)
        mask = (rng.random(6) < 0.8).astype(float)
        a.observe(steps, times, mask)
        b.observe(steps, times, mask)
        np.testing.assert_array_equal(b.multipliers, a.multipliers)
    assert b.ready


def test_runtime_helpers_equal_reference():
    for speeds in (None, [1e8, 2e8, 5e7]):
        a = rrt.compute_bound_runtime_model(speeds)
        b = trt.compute_bound_runtime_model(speeds)
        assert dataclasses.asdict(b.hw) == dataclasses.asdict(a.hw)
        assert dataclasses.asdict(b.wl) == dataclasses.asdict(a.wl)
        assert b.round_time("ce_fedavg", 2, 8, 10) \
            == a.round_time("ce_fedavg", 2, 8, 10)
    for impl in ("dense", "sparse", "ringweight"):
        for m, dpc in ((1, 4), (4, 2), (8, 8)):
            kw = dict(num_clusters=m, devices_per_cluster=dpc, pi=3,
                      degrees=[2] * m, model_bits=1e6)
            assert trt.gossip_traffic_per_round(impl, **kw) \
                == rrt.gossip_traffic_per_round(impl, **kw)
    with pytest.raises(ValueError):
        trt.gossip_traffic_per_round("bogus", num_clusters=2,
                                     devices_per_cluster=1, pi=1,
                                     degrees=[1, 1], model_bits=1.0)
    args = (100, 0.05, 1.0, 0.5, 0.2, 0.1, 64, 8, 2, 8, 0.7, 10)
    assert trt.convergence_bound(*args) == rrt.convergence_bound(*args)


def test_schedule_errors():
    with pytest.raises(ValueError, match="unknown schedule"):
        tprg.make_schedule("nope", TFLConfig(**FL_KW))
    prog = tprg.make_schedule("adaptive_tau", TFLConfig(**FL_KW),
                              speeds=np.ones(16))(0, None)
    assert prog.adaptive and prog.tau_dev.tolist() == [2] * 16
