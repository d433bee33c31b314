"""Tensor parallelism within a replica: the MoE family, mixtral (a
binding capacity: both rounds drop assignments) and llama4-maverick (a
shared expert, top-1). At mp 2 the reduced configs' 4 experts split 2 a
rank; the router's logits are gathered before ``topk``, so every rank
routes and drops as mp 1 does: the kept assignments of every MoE layer
and step are held equal to mp 1's. Otherwise as
``tests/test_torch_tensor_parallel.py``: dp 2 x mp 2 within 1e-5 of dp 2
x mp 1 and within 2e-4 of the reference's (2, 2) mesh after 2 rounds
with momentum, ``lm_loss``'s gradients at mp 2 within 1e-5 of
``jax.grad``."""
import numpy as np
import pytest

import tp_reference as ref

FAMILIES = ["moe", "moe_shared"]


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    inits = {f: ref.ref_init(f, 2) for f in FAMILIES}
    w4, w2 = ref.world_jobs(FAMILIES, inits)
    return ref.run_worlds(w4, w2, FAMILIES, inits,
                          str(tmp_path_factory.mktemp("tp")))


@pytest.mark.parametrize("family", FAMILIES)
def test_dp2_mp2_matches_mp1(res, family):
    ref.check_mp1(res, FAMILIES, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_dp2_mp2_matches_reference_mesh(res, family):
    ref.check_reference(res, FAMILIES, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_lm_loss_grads_at_mp2_match_jax(res, family):
    ref.check_grads(res, FAMILIES, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_dropped_sets_equal_mp1(res, family):
    """Every MoE layer call of both rounds keeps the same assignments at
    mp 2 (every model rank) as at mp 1; mixtral's capacity binds."""
    i = FAMILIES.index(family)
    want = {r[i]["replica"]: r[i]["keep"] for r in res["w2"]}
    for rank in res["w4"]:
        got = rank[i]["keep"]
        exp = want[rank[i]["replica"]]
        assert len(got) == len(exp) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, exp))
    dropped = sum(int((~k).sum()) for k in want[0])
    print(f"{family}: {len(want[0])} MoE layer calls, {dropped} dropped "
          f"assignments on replica 0")
    if family == "moe":
        assert dropped > 0
