"""The port's scenario engine and fault model against
``repro.core.scenario``.

Every draw of ``ScenarioEngine`` and ``FaultModel`` is keyed by
``np.random.SeedSequence`` and runs the same numpy code in both
packages, so plans are compared EXACTLY, not within a tolerance: for
every preset of ``SCENARIOS``, without faults and under each preset of
``FAULTS``, six rounds of labels, masks, both operators, the degraded
backhaul ``H_eff``, the speed multipliers and the fault traces
(``cluster_down``, ``link_up``, components, ``attempts``, ``timed_out``,
``ref_mult``) must be equal. The geometry is 4 clusters of 3 devices on
a ring, scenario seed 7 and fault seed 3.
"""
import dataclasses

import numpy as np
import pytest

from repro.config import FaultConfig, FLConfig
from repro.core import scenario as rsc
from repro_torch.config import FaultConfig as TFaultConfig
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.core import scenario as tsc

FL_KW = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=3,
             tau=2, q=2, pi=3, topology="ring")
ROUNDS = 6
FAULT_CASES = [None] + sorted(rsc.FAULTS)


def _engines(sname, fname, **fl_kw):
    kw = {**FL_KW, **fl_kw}
    faults_r = (None if fname is None
                else dataclasses.replace(rsc.get_faults(fname), seed=3))
    faults_t = (None if fname is None
                else dataclasses.replace(tsc.get_faults(fname), seed=3))
    ref = rsc.ScenarioEngine(
        dataclasses.replace(rsc.get_scenario(sname), seed=7,
                            faults=faults_r), FLConfig(**kw))
    port = tsc.ScenarioEngine(
        dataclasses.replace(tsc.get_scenario(sname), seed=7,
                            faults=faults_t), TFLConfig(**kw))
    return ref, port


def _assert_fault_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in ("round_index", "cluster_down", "link_up", "n_components",
              "attempts", "timed_out", "ref_mult"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.trace() == b.trace() and a.any == b.any


def _assert_plan_equal(a, b):
    assert a.round_index == b.round_index
    assert a.num_clusters == b.num_clusters
    for f in ("labels", "mask", "W_intra", "W_inter"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.H_eff is None) == (b.H_eff is None)
    if a.H_eff is not None:
        np.testing.assert_array_equal(a.H_eff, b.H_eff)
    np.testing.assert_array_equal(a.cohort, b.cohort)
    np.testing.assert_array_equal(a.cluster_sizes, b.cluster_sizes)
    _assert_fault_equal(a.fault, b.fault)


@pytest.mark.parametrize("fname", FAULT_CASES, ids=str)
@pytest.mark.parametrize("sname", sorted(rsc.SCENARIOS))
def test_plans_equal_reference(sname, fname):
    ref, port = _engines(sname, fname)
    np.testing.assert_array_equal(port.speed_multipliers,
                                  ref.speed_multipliers)
    np.testing.assert_array_equal(port.H, ref.H)
    assert (port.faults is None) == (ref.faults is None)
    for _ in range(ROUNDS):
        rp, tp = ref.step(), port.step()
        _assert_plan_equal(rp, tp)
        np.testing.assert_array_equal(port.labels, ref.labels)
        np.testing.assert_array_equal(port.active_speeds(tp),
                                      ref.active_speeds(rp))
    assert port.round_index == ref.round_index == ROUNDS


def test_faults_fire_across_the_presets():
    """The fault cases above are not vacuous: over the six rounds the
    presets realize dark clusters, dropped links and timed-out devices
    (the coverage the parity sweep relies on)."""
    seen = {"down": 0, "link": 0, "timeout": 0, "attempts": 0}
    for sname in ("bimodal", "mobile_sampled"):
        for fname in rsc.FAULTS:
            _, port = _engines(sname, fname)
            for _ in range(ROUNDS):
                f = port.step().fault
                seen["down"] += int(f.cluster_down.sum())
                seen["link"] += int((~f.link_up).sum())
                seen["timeout"] += int(f.timed_out.sum())
                seen["attempts"] += int(f.attempts.sum())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("algo,dpc", [("hier_favg", 3), ("fedavg", 3),
                                      ("local_edge", 3),
                                      ("dec_local_sgd", 1)])
def test_plans_equal_reference_other_algorithms(algo, dpc):
    ref, port = _engines("mobile_sampled", "chaos", algorithm=algo,
                         devices_per_cluster=dpc)
    for _ in range(3):
        _assert_plan_equal(ref.step(), port.step())


def test_fault_model_realize_equals_reference():
    """``FaultModel.realize`` over arbitrary cohorts, speeds and labels,
    with long outage windows and every fault class on."""
    kw = dict(outage_prob=0.3, outage_len=3, link_drop_prob=0.25,
              timeout_factor=1.2, max_retries=2, retry_backoff=1.3, seed=11)
    fl = dict(FL_KW, num_clusters=5, topology="complete")
    ref = rsc.FaultModel(FaultConfig(**kw), FLConfig(**fl))
    port = tsc.FaultModel(TFaultConfig(**kw), TFLConfig(**fl))
    rng = np.random.default_rng(0)
    n = 15
    for r in range(8):
        mask = (rng.random(n) < 0.7).astype(float)
        speeds = rng.lognormal(-0.18, 0.6, n)
        labels = rng.integers(0, 5, n)
        _assert_fault_equal(ref.realize(r, mask, speeds, labels),
                            port.realize(r, mask, speeds, labels))
        np.testing.assert_array_equal(ref.cluster_down(r),
                                      port.cluster_down(r))
        np.testing.assert_array_equal(ref.link_up(r), port.link_up(r))
        for a, b in zip(ref.timeouts(mask, speeds),
                        port.timeouts(mask, speeds)):
            np.testing.assert_array_equal(a, b)


def test_fault_presets_and_errors():
    assert sorted(tsc.FAULTS) == sorted(rsc.FAULTS)
    for name in rsc.FAULTS:
        assert dataclasses.asdict(tsc.get_faults(name)) \
            == dataclasses.asdict(rsc.get_faults(name))
        tsc.get_faults(name).validate()
        assert not tsc.get_faults(name).trivial
    with pytest.raises(ValueError, match="unknown fault preset"):
        tsc.get_faults("meteor")
    with pytest.raises(ValueError, match="unknown scenario"):
        tsc.get_scenario("meteor")
    # a trivial fault config attaches no FaultModel, as in the reference
    sc = dataclasses.replace(tsc.get_scenario("sampled"),
                             faults=TFaultConfig())
    assert tsc.ScenarioEngine(sc, TFLConfig(**FL_KW)).faults is None
    with pytest.raises(AssertionError):
        TFaultConfig(outage_prob=1.0).validate()


def test_time_to_accuracy_scenarios_flag_on_cpu(capsys):
    """The launcher's ``--scenarios`` flag, as the reference's: one row
    per (scenario, algorithm) at the quickstart size."""
    from repro_torch.launch import time_to_accuracy as cli
    res = cli.main(["--device", "cpu", "--rounds", "1", "--scenarios",
                    "lognormal", "mobility", "--algorithms", "ce_fedavg",
                    "fedavg", "--target", "0.1"])
    assert set(res) == {(s, a) for s in ("lognormal", "mobility")
                        for a in ("ce_fedavg", "fedavg")}
    out = capsys.readouterr().out
    assert "scenario" in out and "mobility" in out
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--scenarios", "meteor"])
