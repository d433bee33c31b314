"""The port's scenario rounds (compacted cohorts, fault-gated operators,
masked flat rounds) against ``repro.FLSimulator``.

The MLP 16-32-4 over 4 clusters of 4 devices on a ring (τ=2, q=2, π=3,
batch 16, lr 0.1, scenario seed 7) runs 3 rounds in both packages from
the same init and data under ``sampled``, ``mobility`` and
``mobile_sampled``, each without faults and under ``chaos``. Keyed
quantities are exactly equal: the round's plan (mask, labels) and the
cohort capacity ``last_bucket``. The resident banks agree within 1e-5
(f32 sums in another order over 8 SGD steps a round; the runs agree to
about 3e-6 on the momentum).

Inside the port, the compacted round equals the mask-frozen flat round
(``_compact_enabled=False``) bit for bit: both take each step's
gradients on a gather of the same k cohort rows, in the same order, and
mix the same full bank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import FLConfig, FaultConfig, ScenarioConfig
from repro.core import program as rprg
from repro.core.cefedavg import FLSimulator
from repro.core.modelbank import cohort_buckets as r_buckets
from repro.core.modelbank import compact_plan as r_compact_plan
from repro.core.scenario import get_faults, get_scenario
from repro.data.federated import (build_fl_data, dirichlet_partition,
                                  make_synthetic_classification)
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.config import FaultConfig as TFaultConfig
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.config import ScenarioConfig as TScenarioConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import program as tprg
from repro_torch.core import scenario as tsc
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.modelbank import compact_plan
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


def _scenarios(sname, fname):
    rf = None if fname is None else get_faults(fname)
    tf = None if fname is None else tsc.get_faults(fname)
    return (dataclasses.replace(get_scenario(sname), seed=7, faults=rf),
            dataclasses.replace(tsc.get_scenario(sname), seed=7, faults=tf))


def _pair(scenarios=(None, None), *, fl_kw=None, port_only=False,
          r_kw=None, t_kw=None):
    """(reference sim, port sim) from the same init and data, under the
    (reference, port) scenario configs."""
    fl_kw = {**FL_KW, **(fl_kw or {})}
    data = _data(fl_kw["num_clusters"] * fl_kw["devices_per_cluster"])
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0),
                                              16, 32, 4))
    port = TSim(lambda g: tree_from_numpy(init), t_apply, TFLConfig(**fl_kw),
                data, lr=0.1, batch_size=16, scenario=scenarios[1],
                device="cpu", **(t_kw or {}))
    if port_only:
        return None, port
    ref = FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                      apply_mlp_classifier, FLConfig(**fl_kw),
                      {k: jnp.asarray(v) for k, v in data.items()},
                      lr=0.1, batch_size=16, scenario=scenarios[0],
                      **(r_kw or {}))
    return ref, port


def _banks_close(ref, port, atol=ATOL):
    np.testing.assert_allclose(port.bank.params.numpy(),
                               np.asarray(ref.bank.params), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(port.bank.mom.numpy(),
                               np.asarray(ref.bank.mom), atol=atol, rtol=0)


def _run_both(ref, port, rounds):
    buckets = []
    for _ in range(rounds):
        rp, tp = ref.step_round(), port.step_round()
        np.testing.assert_array_equal(tp.mask, rp.mask)
        np.testing.assert_array_equal(tp.labels, rp.labels)
        np.testing.assert_array_equal(port.labels, ref.labels)
        assert port.last_bucket == ref.last_bucket
        buckets.append(port.last_bucket)
    return buckets


@pytest.mark.parametrize("seed", range(4))
def test_compact_plan_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40))
    mask = (rng.random(n) < rng.random()).astype(float)
    mask[int(rng.integers(n))] = 1.0
    for buckets in (None, r_buckets(n)):
        a, b = r_compact_plan(mask, buckets), compact_plan(mask, buckets)
        np.testing.assert_array_equal(b.idx, a.idx)
        np.testing.assert_array_equal(b.lane, a.lane)
        assert (b.k, b.k_pad) == (a.k, a.k_pad)
        assert b.idx.dtype == np.int32 and len(set(b.idx)) == b.k_pad


@pytest.mark.parametrize("fname", [None, "chaos"], ids=str)
@pytest.mark.parametrize("sname", ["sampled", "mobility", "mobile_sampled"])
def test_scenario_bank_matches_reference(sname, fname):
    ref, port = _pair(_scenarios(sname, fname))
    _run_both(ref, port, ROUNDS)
    _banks_close(ref, port)
    np.testing.assert_array_equal(port.key, np.asarray(ref.key))
    np.testing.assert_allclose(port.evaluate(), ref.evaluate(), atol=ATOL)


def test_fully_dark_round_matches_reference():
    """Two clusters under long outage windows: the fault trace holds a
    round with every cluster dark (an empty cohort, which runs the flat
    round with a zero mask and identity operators) beside rounds with
    a live cohort."""
    fl_kw = dict(FL_KW, num_clusters=2)
    sc = dict(name="dark", sample_fraction=0.75, seed=7)
    fc = dict(outage_prob=0.6, outage_len=2, seed=1)
    ref, port = _pair((ScenarioConfig(**dict(sc, faults=FaultConfig(**fc))),
                       TScenarioConfig(**dict(sc,
                                              faults=TFaultConfig(**fc)))),
                      fl_kw=fl_kw)
    dark = live = 0
    for _ in range(4):
        before = port.bank.params.clone()
        rp, tp = ref.step_round(), port.step_round()
        np.testing.assert_array_equal(tp.mask, rp.mask)
        assert port.last_bucket == ref.last_bucket
        if tp.mask.sum() == 0:
            dark += 1
            assert tp.fault.cluster_down.all()
            assert port.last_bucket == 8       # the flat round ran
            assert bool((port.bank.params == before).all())
        else:
            live += 1
    assert dark >= 1 and live >= 1, (dark, live)
    _banks_close(ref, port)


def test_compaction_across_bucket_boundaries():
    """The reference's bucket-boundary setting: cohorts that wander
    across power-of-two capacities round to round (8 rounds of 4x2
    devices, dropout 0.55) stay equal to the reference's, bucket for
    bucket."""
    fl_kw = dict(FL_KW, devices_per_cluster=2, pi=4)
    sc = dict(sample_fraction=1.0, dropout_prob=0.55, seed=7)
    ref, port = _pair((ScenarioConfig(**sc), TScenarioConfig(**sc)),
                      fl_kw=fl_kw)
    seen = set(_run_both(ref, port, 8))
    assert len(seen) >= 2 and seen <= set(r_buckets(8)), seen
    assert min(seen) < 8
    _banks_close(ref, port)


@pytest.mark.parametrize("fname", [None, "chaos"], ids=str)
def test_compacted_equals_flat_in_port(fname):
    _, a = _pair(_scenarios("sampled", fname), port_only=True)
    _, b = _pair(_scenarios("sampled", fname), port_only=True)
    b._compact_enabled = False
    compacted = 0
    for _ in range(ROUNDS):
        a.step_round()
        b.step_round()
        compacted += a.last_bucket < a.bank.n
        assert b.last_bucket == b.bank.n
    assert compacted >= 1
    assert np.array_equal(a.bank.params.numpy(), b.bank.params.numpy())
    assert np.array_equal(a.bank.mom.numpy(), b.bank.mom.numpy())


def test_flat_masked_round_matches_reference():
    """With compaction off in both packages, the mask-frozen flat round
    of a faulted mobile scenario."""
    ref, port = _pair(_scenarios("mobile_sampled", "chaos"))
    ref._compact_enabled = port._compact_enabled = False
    _run_both(ref, port, ROUNDS)
    _banks_close(ref, port)


def test_static_program_at_another_depth_matches_reference():
    """A fixed program whose gossip depth π=2 differs from fl.pi=3
    resolves through the masked-operator construction over the static
    labels (no scenario), as the reference's ``_inter_operator`` does."""
    ops = (tprg.MaskRenorm(), tprg.LocalSteps(2), tprg.IntraMix(),
           tprg.LocalSteps(2), tprg.IntraMix(), tprg.InterGossip(2))
    rops = (rprg.MaskRenorm(), rprg.LocalSteps(2), rprg.IntraMix(),
            rprg.LocalSteps(2), rprg.IntraMix(), rprg.InterGossip(2))
    ref, port = _pair(r_kw=dict(schedule=rprg.RoundProgram(rops)),
                      t_kw=dict(schedule=tprg.RoundProgram(ops)))
    for _ in range(2):
        assert ref.step_round() is None and port.step_round() is None
    _banks_close(ref, port)
    np.testing.assert_array_equal(port._inter_static[2],
                                  ref._inter_static[2])
