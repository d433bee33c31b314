"""The port's communicator-group registry (``repro_torch.core.groups``) at
the depth-3 (2, 2, 2) preset on one gloo world of 8 CPU ranks spawned for
the module (``torch_dist_cases.groups_world``) — the twins of the
reference's registry tests (``tests/test_groups.py``, its multidevice
half, which needs an 8-device XLA host).

Tier members and lookup, the registry's cache and its subgroups (made
once, when it is built), each tier's edge-colored schedule against its
mixing matrix with per-parent matchings, the gated operators, and the
registry's means and gossips on each rank's row against the dense block
averages and ``TierMix`` operators within 1e-6."""
import numpy as np
import pytest

import torch_dist_cases as cases
from repro.config import FLConfig as RefFLConfig
from repro.core.topology import Hierarchy as RefHierarchy
from repro_torch.config import FLConfig
from repro_torch.core import topology as topo
from repro_torch.launch import mesh as lm

TOL = 1e-6
FL3 = FLConfig(**cases.FL3)
X = cases.rows_of(0, 16)


@pytest.fixture(scope="module")
def ranks():
    return lm.run_local_ranks(cases.groups_world, cases.NDEV, device="cpu",
                              timeout_s=300)


def test_members_lookup_and_cache(ranks):
    for res in ranks:
        m = res["members"]
        assert m["device"] == m["edge"] == ((0, 1), (2, 3), (4, 5), (6, 7))
        assert m["region"] == ((0, 1, 2, 3), (4, 5, 6, 7))
        assert res["tier2_is_region"] and res["cached"]
        assert res["depth"] == 3 and res["flat"] == cases.NDEV
        assert "level 2 (region): 2 groups × 4 replicas" in res["describe"]
        # the pairs partition (device, edge) and the halves (region)
        assert res["subgroups"] == 2


def test_members_match_the_reference_hierarchy():
    ref = RefHierarchy.from_config(RefFLConfig(**cases.FL3))
    port = topo.Hierarchy.from_config(FL3)
    for lvl in range(ref.depth):
        assert port.group_size(lvl) == ref.group_size(lvl)
        assert port.num_groups(lvl) == ref.num_groups(lvl)
        assert port.tier_name(lvl) == ref.tier_name(lvl)


@pytest.mark.parametrize("lvl", [1, 2])
def test_gossip_schedule_matches_mixing(ranks, lvl):
    """Each tier's schedule applies exactly H_ℓ, with matchings inside
    each parent group and across nodes."""
    dense, mixing, perms, node = ranks[0]["schedules"][lvl]
    np.testing.assert_allclose(dense, mixing, atol=1e-12, rtol=0)
    assert ranks[0]["sched_cached"]
    parent = 4 if lvl == 1 else 8
    for perm in perms:
        for src, dst in perm:
            assert src // parent == dst // parent
            assert src // node != dst // node


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_gated_operators_are_the_gossip_gates(ranks, lvl):
    for res in ranks:
        op, stale, want_stale, faulted, want_fault = res["gated"][lvl]
        np.testing.assert_array_equal(stale, want_stale)
        np.testing.assert_array_equal(faulted, want_fault)
        np.testing.assert_allclose(op.sum(1), 1.0, atol=1e-12)


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_mean_matches_block_average(ranks, lvl):
    members = ranks[0]["members"][("device", "edge", "region")[lvl]]
    want = X.copy()
    for g in members:
        want[list(g)] = X[list(g)].mean(0)
    got = np.concatenate([r["mean"][lvl] for r in ranks])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("lvl", [1, 2])
@pytest.mark.parametrize("mode", ["rounds", "exact"])
def test_mean_then_gossip_is_the_tier_operator(ranks, lvl, mode):
    """mean ∘ gossip at tier ℓ = the dense (n, n) TierMix(ℓ, π)."""
    op = ranks[0]["gated"][lvl][0]
    got = np.concatenate([r["gossip"][(lvl, mode)] for r in ranks])
    np.testing.assert_allclose(got, op @ X.astype(np.float64), atol=TOL,
                               rtol=0)
    if lvl == 2 and mode == "rounds":
        body = np.concatenate([r["in_body"] for r in ranks])
        np.testing.assert_allclose(body, got, atol=0, rtol=0)


def test_tree_mean_keeps_dtype(ranks):
    dt = {r["tree_mean"][0] for r in ranks}
    assert dt == {"torch.bfloat16"}
    got = np.stack([r["tree_mean"][1].reshape(-1) for r in ranks])
    want = np.concatenate([r["mean"][2] for r in ranks])
    np.testing.assert_allclose(got, want, atol=0.02, rtol=2 ** -7)


def test_registry_rejects_mismatched_mesh(ranks):
    assert "hierarchy has 4 leaf devices but the mesh's flat replica " \
           "axis has 8" in ranks[0]["mismatch"]
