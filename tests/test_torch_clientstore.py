"""The port's host side of the streamed engine against the JAX package:
the client store, the population engine's keyed draws, the masked
operators and the slab buckets. All numpy on both sides, so everything
is exactly equal."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.config import FLConfig, PopulationConfig, ScenarioConfig
from repro.core import clientstore as rcs
from repro.core import clock as rclock
from repro.core import modelbank as rmb
from repro.core import scenario as rsc
from repro.core.runtime import paper_runtime_model
from repro.kernels.gossip_mix import FlatLayout as RLayout
from repro.models.cnn import init_mlp_classifier
from repro_torch import config as tcfg
from repro_torch.core import clientstore as tcs
from repro_torch.core import clock as tclock
from repro_torch.core import modelbank as tmb
from repro_torch.core import scenario as tsc
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.kernels.gossip_mix import FlatLayout as TLayout

CODECS = ("f32", "f16", "int8")


def _layouts():
    init = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(0), 16,
                                              32, 4))
    from repro_torch.convert import tree_from_numpy
    return RLayout.for_tree(init), TLayout.for_tree(tree_from_numpy(init))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("codec", CODECS)
def test_store_matches_reference(codec, shards):
    """The same sequence of commits, fetches and snapshots on both
    stores gives the same bytes, encoded and decoded."""
    rl, tl = _layouts()
    assert tl.segments == rl.segments and tl.total == rl.total
    rng = np.random.default_rng(shards)
    init = rng.standard_normal(tl.total).astype(np.float32)
    rs = rcs.ClientStore(rl, 4, init, codec=codec, num_shards=shards)
    ts = tcs.ClientStore(tl, 4, init, codec=codec, num_shards=shards)
    assert ts.bits_per_row == rs.bits_per_row and ts.nbytes == rs.nbytes
    steps = [np.array([2, 5, 9, 3000]), np.array([5, 7, 2]),
             np.arange(0, 40, 3), np.array([9991])]
    for ids in steps:
        rows = (rng.standard_normal((ids.size, tl.total)) * 2).astype(
            np.float32)
        rs.commit(ids, rows)
        ts.commit(ids, rows)
        probe = np.concatenate([ids, [1, 9999]])
        np.testing.assert_array_equal(ts.fetch(probe), rs.fetch(probe))
        for a, b in zip(ts.fetch_encoded(probe), rs.fetch_encoded(probe)):
            np.testing.assert_array_equal(a, b)
        ta, ra = ts.snapshot(), rs.snapshot()
        assert ta.keys() == ra.keys()
        for k in ra:
            np.testing.assert_array_equal(ta[k], ra[k])
    q, s = rs.fetch_encoded(steps[2])
    rs.commit_encoded(steps[2][:3], q[:3], s[:3])
    ts.commit_encoded(steps[2][:3], q[:3], s[:3])
    refs = rng.standard_normal((4, tl.total)).astype(np.float32)
    rs.update_clusters(refs)
    ts.update_clusters(refs)
    assert ts.num_stored == rs.num_stored
    assert ts.shard_nbytes() == rs.shard_nbytes() and ts.nbytes == rs.nbytes
    # a store loaded from the reference's snapshot is the same store
    loaded = tcs.ClientStore(tl, 4, init, codec=codec, num_shards=shards)
    loaded.load(rs.snapshot())
    for k, v in rs.snapshot().items():
        np.testing.assert_array_equal(loaded.snapshot()[k], v)


def test_memory_formulas_match_reference():
    for args in ((16, 1000), (8, 100), (64, 6_603_710)):
        assert tcs.resident_slab_nbytes(*args) \
            == rcs.resident_slab_nbytes(*args)
    for codec in CODECS:
        assert tcs.cold_row_nbytes(1000, codec, 8) \
            == rcs.cold_row_nbytes(1000, codec, 8)


POPULATIONS = {
    "fixed": dict(clients_per_cluster=100, cohort_per_cluster=3),
    "uniform": dict(clients_per_cluster=250, size_dist="uniform",
                    size_spread=0.4, cohort_per_cluster=5, codec="f16"),
    "lognormal": dict(clients_per_cluster=40, size_dist="lognormal",
                      size_spread=0.5, cohort_per_cluster=7, codec="int8"),
    "femnist": dict(clients_per_cluster=1250, cohort_per_cluster=7,
                    codec="int8"),
}
SCEN = {
    "fixed": dict(sample_fraction=0.5, dropout_prob=0.1, move_prob=0.25,
                  seed=7),
    "uniform": dict(speed_dist="lognormal", speed_spread=0.6,
                    sample_fraction=0.8, move_prob=0.5, seed=3),
    "lognormal": dict(speed_dist="bimodal", dropout_prob=0.3, seed=11),
    "femnist": dict(sample_fraction=1.0, dropout_prob=0.0, move_prob=0.25,
                    seed=7),
}


@pytest.mark.parametrize("name", sorted(POPULATIONS))
def test_population_draws_match_reference(name):
    m = 8 if name == "femnist" else 4
    fl_kw = dict(algorithm="ce_fedavg", num_clusters=m,
                 devices_per_cluster=4, topology="ring")
    r = rsc.PopulationEngine(
        ScenarioConfig(**SCEN[name],
                       population=PopulationConfig(**POPULATIONS[name])),
        FLConfig(**fl_kw))
    t = tsc.PopulationEngine(
        tcfg.ScenarioConfig(
            **SCEN[name],
            population=tcfg.PopulationConfig(**POPULATIONS[name])),
        tcfg.FLConfig(**fl_kw))
    np.testing.assert_array_equal(t.sizes, r.sizes)
    np.testing.assert_array_equal(t.offsets, r.offsets)
    np.testing.assert_array_equal(t.H, r.H)
    assert t.population == r.population and t.cohort_cap == r.cohort_cap
    if name == "femnist":
        assert t.population == 10_000 and t.cohort_cap == 64
    for _ in range(6):
        tp, rp = t.step(), r.step()
        for f in ("clients", "labels", "speeds", "mask", "cohort"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(rp, f))
        assert tp.round_index == rp.round_index
        np.testing.assert_array_equal(t.representatives(tp.clients),
                                      r.representatives(rp.clients))
        np.testing.assert_array_equal(t.speed_multipliers,
                                      r.speed_multipliers)
    ids = np.array([0, 1, 99, 100, r.population - 1])
    np.testing.assert_array_equal(t.home_cluster(ids), r.home_cluster(ids))


@pytest.mark.parametrize("algo", ["ce_fedavg", "hier_favg", "fedavg",
                                  "local_edge"])
def test_masked_operators_match_reference(algo):
    rng = np.random.default_rng(5)
    kw = dict(algorithm=algo, num_clusters=4, devices_per_cluster=4, pi=3)
    rfl, tfl = FLConfig(**kw), tcfg.FLConfig(**kw)
    H = rsc.PopulationEngine(
        ScenarioConfig(population=PopulationConfig()), rfl).H
    for _ in range(3):
        labels = rng.integers(0, 4, 11)
        mask = (rng.random(11) < 0.6).astype(float)
        for pi in (None, 1):
            for a, b in zip(tsc.make_masked_w(tfl, labels, mask, H, pi=pi),
                            rsc.make_masked_w(rfl, labels, mask, H, pi=pi)):
                np.testing.assert_array_equal(a, b)


def test_buckets_and_slab_bank():
    for n in (1, 2, 5, 16, 20, 64, 100):
        assert tmb.cohort_buckets(n) == rmb.cohort_buckets(n)
        for k in range(1, n + 1):
            assert tmb.bucket_for(k, tmb.cohort_buckets(n)) \
                == rmb.bucket_for(k, rmb.cohort_buckets(n))
    with pytest.raises(ValueError, match="exceeds"):
        tmb.bucket_for(9, tmb.cohort_buckets(8))
    _, tl = _layouts()
    rows = np.arange(3 * tl.total, dtype=np.float32).reshape(3, -1)
    slab = tmb.ModelBank.from_rows(tl, rows, -rows, device="cpu")
    assert slab.n == 3 and slab.resident_nbytes \
        == tcs.resident_slab_nbytes(3, tl.total)
    np.testing.assert_array_equal(slab.params.numpy(), rows)
    slab.params.add_(1)   # the slab is a copy, not a view of the rows
    assert rows[0, 0] == 0.0
    with pytest.raises(ValueError, match="do not match"):
        tmb.ModelBank.from_rows(tl, rows[:, :5], rows[:, :5], device="cpu")


def test_paging_charge_and_configs_match_reference():
    for args in ((3, 3, 8 * 1016), (0, 0, 64), (56, 56, 52_829_712)):
        assert tclock.paging_comm_time(t_runtime(), *args) \
            == rclock.paging_comm_time(paper_runtime_model(), *args)
    assert set(tsc.SCENARIOS) == set(rsc.SCENARIOS)
    for name in rsc.SCENARIOS:
        assert dataclasses.asdict(tsc.get_scenario(name)) \
            == dataclasses.asdict(rsc.get_scenario(name))
    with pytest.raises(ValueError, match="unknown scenario"):
        tsc.get_scenario("nope")
    for bad in (dict(codec="bf16"), dict(cohort_per_cluster=0),
                dict(size_dist="pareto")):
        with pytest.raises(AssertionError):
            tcfg.PopulationConfig(**bad).validate()
    assert tcfg.ScenarioConfig(
        population=tcfg.PopulationConfig()).trivial is False
