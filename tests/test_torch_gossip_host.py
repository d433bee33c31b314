"""The port's host-side gossip plans (``repro_torch.core.gossip``) against
``repro.core.gossip``.

``staleness_mask``, ``fault_gate``, ``color_edges`` and
``GossipSchedule`` are numpy in both packages, so every result is
compared EXACTLY: operators bit for bit, permutations, weight tables,
traffic counts and ``dense_equivalent``. The identity cases (every
cluster advancing at one phase; no cluster down) must return the
operator unchanged, bit for bit — the anchor of async s=0 against the
barrier and of a fault-free gated round against the ungated one.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import gossip as rg
from repro.core import topology as rtopo
from repro_torch.core import gossip as tg
from repro_torch.core import topology as ttopo

TOPOLOGIES = [("ring", 5), ("complete", 4), ("star", 5), ("torus", 9),
              ("erdos_renyi", 7)]


def _operator(rng, n):
    W = rng.random((n, n)).astype(np.float32)
    return W / W.sum(1, keepdims=True)


def _mask_case(seed, staleness):
    rng = np.random.default_rng(seed)
    m, dpc = int(rng.integers(2, 5)), int(rng.integers(1, 4))
    n = m * dpc
    labels = rng.permutation(np.repeat(np.arange(m), dpc))
    W = _operator(rng, n)
    phases = rng.integers(0, 4, size=m)
    adv = rng.random(m) < 0.6
    if not adv.any():
        adv[int(rng.integers(m))] = True
    phases[adv] = int(phases[adv][0])
    a = rg.staleness_mask(W, labels, phases, staleness, adv)
    b = tg.staleness_mask(W, labels, phases, staleness, adv)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(b.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("staleness", [0, 1, 3])
@pytest.mark.parametrize("seed", range(6))
def test_staleness_mask_equals_reference(seed, staleness):
    _mask_case(seed, staleness)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 3))
def test_staleness_mask_fuzz(seed, staleness):
    _mask_case(seed, staleness)


def test_staleness_mask_barrier_is_bitwise_identity():
    rng = np.random.default_rng(1)
    W = _operator(rng, 12)
    labels = np.repeat(np.arange(4), 3)
    for phase in (0, 3):
        out = tg.staleness_mask(W, labels, np.full(4, phase), 2,
                                np.ones(4, bool))
        assert out.dtype == np.float32
        assert np.array_equal(out.view(np.int32), W.view(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_fault_gate_equals_reference(seed):
    rng = np.random.default_rng(seed)
    m, dpc = 4, 3
    labels = rng.permutation(np.repeat(np.arange(m), dpc))
    W = _operator(rng, m * dpc)
    down = rng.random(m) < 0.4
    np.testing.assert_array_equal(tg.fault_gate(W, labels, down),
                                  rg.fault_gate(W, labels, down))
    # no cluster down: the operator itself, bit for bit
    out = tg.fault_gate(W, labels, np.zeros(m, bool))
    assert np.array_equal(out.view(np.int32), W.view(np.int32))
    # every cluster down: the identity
    np.testing.assert_array_equal(tg.fault_gate(W, labels, np.ones(m, bool)),
                                  np.eye(m * dpc, dtype=np.float32))


@pytest.mark.parametrize("name,m", TOPOLOGIES)
def test_color_edges_equals_reference(name, m):
    adj = rtopo.build_adjacency(name, m)
    np.testing.assert_array_equal(ttopo.build_adjacency(name, m), adj)
    assert tg.color_edges(adj) == rg.color_edges(adj)


@pytest.mark.parametrize("mode", ["rounds", "exact"])
@pytest.mark.parametrize("dpc", [1, 2])
@pytest.mark.parametrize("name,m", TOPOLOGIES)
def test_gossip_schedule_equals_reference(name, m, dpc, mode):
    H = rtopo.mixing_matrix(rtopo.build_adjacency(name, m), "metropolis")
    a = rg.GossipSchedule.build(H, 3, dpc, mode)
    b = tg.GossipSchedule.build(H, 3, dpc, mode)
    assert (b.mode, b.num_clusters, b.devices_per_cluster, b.pi) \
        == (a.mode, a.num_clusters, a.devices_per_cluster, a.pi)
    assert b.perms == a.perms
    for f in ("w_self", "weights", "h_pi", "degrees"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
    assert b.num_matchings == a.num_matchings
    assert b.models_received_per_replica() \
        == a.models_received_per_replica()
    assert b.models_received_total(m * dpc) \
        == a.models_received_total(m * dpc)
    np.testing.assert_array_equal(b.dense_equivalent(), a.dense_equivalent())
    expect = H if mode == "rounds" else np.linalg.matrix_power(H, 3)
    np.testing.assert_allclose(b.dense_equivalent(), expect, atol=1e-12)
