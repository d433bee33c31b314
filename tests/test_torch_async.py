"""The port's async bounded-staleness rounds against ``repro``.

- Timelines: ``async_program_timeline`` (events, start and end times,
  makespans, carries across rounds) and ``EventClock.charge_program_async``
  are numpy in both packages and equal EXACTLY.
- s = 0 is the barrier: inside the port an s=0 async round equals the
  flat barrier round bit for bit (compaction off), over the reference's
  fuzzed geometries of ``test_s0_parity_flat_fuzzed``; against the
  compacted barrier it stays within 2e-4, the reference's own bound.
- s = 2 against the reference's s = 2: banks within 1e-5 (f32 sums in
  another order), the event trace (times, blocks, clusters, phases,
  realized edges) equal, and every realized edge within the bound.

The MLP 16-32-4 with batch 16 and lr 0.1 under the compute-bound
runtime profile, as in the reference's tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import FLConfig
from repro.core import clock as rclock
from repro.core import program as rprg
from repro.core.cefedavg import FLSimulator
from repro.core.runtime import compute_bound_runtime_model
from repro.core.scenario import get_scenario
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.config import ScenarioConfig as TScenarioConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import clock as tclock
from repro_torch.core import program as tprg
from repro_torch.core import scenario as tsc
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.runtime import compute_bound_runtime_model as t_rt
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

RT, TRT = compute_bound_runtime_model(), t_rt()
ATOL = 1e-5


def _fuzz_kw(seed):
    """The reference's fuzzed geometry and schedule for one seed."""
    rng = np.random.default_rng(seed)
    algo = rng.choice(["ce_fedavg", "hier_favg", "dec_local_sgd"])
    m = int(rng.integers(2, 5))
    dpc = 1 if algo == "dec_local_sgd" else int(rng.integers(1, 4))
    if algo == "dec_local_sgd":
        m = max(m, 3)
    return dict(algorithm=str(algo), num_clusters=m, devices_per_cluster=dpc,
                tau=int(rng.integers(1, 4)), q=int(rng.integers(1, 4)),
                pi=int(rng.integers(2, 8)),
                topology=str(rng.choice(["ring", "complete"])))


def _data(n):
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    return build_fl_data(x, y, dirichlet_partition(y, n, 0.5, seed=5),
                         tx, ty, 64)


def _init(seed):
    return jax.device_get(init_mlp_classifier(jax.random.PRNGKey(seed),
                                              16, 32, 4))


def _port(fl_kw, scenario=None, seed=0):
    init = _init(seed)
    return TSim(lambda g: tree_from_numpy(init), t_apply, TFLConfig(**fl_kw),
                _data(TFLConfig(**fl_kw).n), lr=0.1, batch_size=16,
                seed=seed, scenario=scenario, device="cpu")


def _ref(fl_kw, scenario=None, seed=0):
    data = {k: jnp.asarray(v) for k, v in
            _data(FLConfig(**fl_kw).n).items()}
    return FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                       apply_mlp_classifier, FLConfig(**fl_kw), data, lr=0.1,
                       batch_size=16, seed=seed, scenario=scenario)


def _scenario(sname, seed=7):
    return (dataclasses.replace(get_scenario(sname), seed=seed),
            dataclasses.replace(tsc.get_scenario(sname), seed=seed))


def _check_trace(sim, staleness):
    trace = sim.last_async["trace"]
    assert trace
    for ev in trace:
        ph = np.asarray(ev["phases"])
        assert (ph[list(ev["clusters"])] == ev["block"]).all()
        for (i, j) in ev["edges"]:
            assert abs(int(ph[i]) - int(ph[j])) <= staleness


@pytest.mark.parametrize("staleness", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_timelines_equal_reference(seed, staleness):
    """Three carried rounds of a fuzzed geometry under a sampled
    lognormal fleet with adaptive cut-offs on odd rounds."""
    kw = _fuzz_kw(seed + 10)
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    rng = np.random.default_rng(seed)
    n, m = fl.n, fl.num_clusters
    carry_r = carry_t = None
    for r in range(3):
        speeds = rng.lognormal(-0.18, 0.6, n) * RT.hw.device_flops
        mask = (rng.random(n) < 0.7).astype(float)
        labels = rng.integers(0, m, n)
        if r % 2:
            td = rng.integers(1, fl.tau + 1, n).astype(np.int32)
            rp = rprg.RoundProgram(tuple(
                dataclasses.replace(o, adaptive=True)
                if isinstance(o, rprg.LocalSteps) else o
                for o in rprg.canonical_program(fl).ops), tau_dev=td)
            tp = tprg.RoundProgram(tuple(
                dataclasses.replace(o, adaptive=True)
                if isinstance(o, tprg.LocalSteps) else o
                for o in tprg.canonical_program(tfl).ops), tau_dev=td)
        else:
            rp, tp = rprg.canonical_program(fl), tprg.canonical_program(tfl)
        a = rclock.async_program_timeline(RT, fl, rp, speeds, mask, labels,
                                          staleness, carry=carry_r)
        b = tclock.async_program_timeline(TRT, tfl, tp, speeds, mask,
                                          labels, staleness, carry=carry_t)
        for k in ("T", "start", "comp", "comm", "adjacency"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b["makespan"] == a["makespan"]
        assert [tuple(e) for e in b["events"]] \
            == [tuple(e) for e in a["events"]]
        np.testing.assert_array_equal(b["carry_out"]["T_end"],
                                      a["carry_out"]["T_end"])
        for x, y in zip(b["carry_out"]["cols"], a["carry_out"]["cols"]):
            np.testing.assert_array_equal(x, y)
        carry_r, carry_t = a["carry_out"], b["carry_out"]
    np.testing.assert_array_equal(tclock.async_adjacency(tfl),
                                  rclock.async_adjacency(fl))


def test_charge_program_async_equals_reference():
    kw = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
              tau=2, q=3, pi=4, topology="ring")
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    a, b = rclock.EventClock(RT, fl), tclock.EventClock(TRT, tfl)
    rng = np.random.default_rng(0)
    for s in (2, 2, 0, 1):
        speeds = rng.lognormal(-0.18, 0.6, fl.n) * RT.hw.device_flops
        mask = (rng.random(fl.n) < 0.8).astype(float)
        ta = a.charge_program_async(rprg.canonical_program(fl), speeds,
                                    mask, staleness=s)
        tb = b.charge_program_async(tprg.canonical_program(tfl), speeds,
                                    mask, staleness=s)
        assert ta == tb
        assert (a._async_carry is None) == (b._async_carry is None)


@pytest.mark.parametrize("sname", [None, "sampled"], ids=str)
@pytest.mark.parametrize("seed", range(4))
def test_s0_equals_barrier_bitwise(seed, sname):
    """Without a scenario, and under a sampled fleet whose masks freeze
    rows of the flat round on both sides."""
    kw = _fuzz_kw(seed)
    sc = None if sname is None else _scenario(sname, seed)[1]
    sb, sa = _port(kw, sc, seed=seed), _port(kw, sc, seed=seed)
    sb._compact_enabled = False
    for _ in range(3):
        sb.step_round()
        sa.step_round_async(0, TRT)
    assert np.array_equal(sb.bank.params.numpy(), sa.bank.params.numpy())
    assert np.array_equal(sb.bank.mom.numpy(), sa.bank.mom.numpy())
    assert sa._async_carry is None
    assert (sa.last_async["phases"]
            == 3 * sa.last_program.num_blocks).all()


@pytest.mark.parametrize("sname", ["lognormal", "sampled", "mobility"])
def test_s0_matches_compacted_barrier(sname):
    kw = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
              tau=2, q=2, pi=4, topology="ring")
    _, ts = _scenario(sname)
    sb, sa = _port(kw, ts), _port(kw, ts)
    for _ in range(3):
        sb.step_round()
        sa.step_round_async(0, TRT)
    np.testing.assert_allclose(sa.bank.params.numpy(),
                               sb.bank.params.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(sa.bank.mom.numpy(), sb.bank.mom.numpy(),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("sname", ["lognormal", "mobile_sampled"])
def test_s2_matches_reference(sname):
    kw = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
              tau=2, q=3, pi=4, topology="ring")
    rs, ts = _scenario(sname)
    ref, port = _ref(kw, rs), _port(kw, ts)
    for _ in range(2):
        ref.step_round_async(2, RT)
        port.step_round_async(2, TRT)
        ra, ta = ref.last_async, port.last_async
        assert ta["staleness"] == ra["staleness"] == 2
        np.testing.assert_array_equal(ta["phases"], ra["phases"])
        assert len(ta["trace"]) == len(ra["trace"]) > 1
        for x, y in zip(ta["trace"], ra["trace"]):
            assert (x["time"], x["block"], x["clusters"], x["edges"]) \
                == (y["time"], y["block"], y["clusters"], y["edges"])
            np.testing.assert_array_equal(x["phases"], y["phases"])
        assert ta["timeline"]["makespan"] == ra["timeline"]["makespan"]
        _check_trace(port, 2)
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(port.bank.mom.numpy(),
                               np.asarray(ref.bank.mom), atol=ATOL, rtol=0)


@pytest.mark.parametrize("staleness", [1, 3])
@pytest.mark.parametrize("seed", range(2))
def test_staleness_bound_holds_on_every_edge(seed, staleness):
    kw = _fuzz_kw(seed)
    sc = TScenarioConfig(name="fuzz", speed_dist="lognormal",
                         speed_spread=0.6, sample_fraction=0.5, seed=seed)
    sa = _port(kw, sc, seed=seed)
    for _ in range(3):
        sa.step_round_async(staleness, TRT)
        _check_trace(sa, staleness)
    assert sa._async_carry is not None
    sa.step_round_async(0, TRT)
    assert sa._async_carry is None


def test_async_wall_clock_matches_reference():
    kw = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
              tau=2, q=2, pi=4, topology="ring")
    rs, ts = _scenario("lognormal")
    rh = rclock.run_wall_clock(_ref(kw, rs), RT, 3, async_staleness=2)
    th = tclock.run_wall_clock(_port(kw, ts), TRT, 3, async_staleness=2)
    assert th["wall_time"] == rh["wall_time"]
    assert th["participants"] == rh["participants"]
    np.testing.assert_allclose(th["loss"], rh["loss"], atol=ATOL, rtol=0)
    # s=0 through the clock is the barrier loop, to the last second
    b0 = tclock.run_wall_clock(_port(kw, ts), TRT, 2)
    a0 = tclock.run_wall_clock(_port(kw, ts), TRT, 2, async_staleness=0)
    assert a0["wall_time"] == b0["wall_time"]


def test_async_rejects_the_streamed_engine_and_uploads():
    kw = dict(algorithm="ce_fedavg", num_clusters=2, devices_per_cluster=2,
              tau=1, q=1, pi=1, topology="ring")
    init = _init(0)
    streamed = TSim(lambda g: tree_from_numpy(init), t_apply,
                    TFLConfig(**kw), _data(4), lr=0.1, batch_size=16,
                    streaming=True, device="cpu")
    with pytest.raises(ValueError, match="resident rows"):
        streamed.step_round_async(1, TRT)
    upload = tprg.canonical_program(TFLConfig(**kw), compress=True)
    sim = TSim(lambda g: tree_from_numpy(init), t_apply, TFLConfig(**kw),
               _data(4), lr=0.1, batch_size=16, schedule=upload,
               device="cpu")
    with pytest.raises(NotImplementedError, match="plain programs"):
        sim.step_round_async(1, TRT)
