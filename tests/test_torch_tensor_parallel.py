"""Tensor parallelism within a replica (``--model-parallel``): the dense
(qwen2), encoder-decoder (whisper) and VLM (pixtral) families.

The port's ``ShardedCEFedAvg`` on a gloo world of 4 CPU ranks, dp 2 x mp
2, trains each reduced f32 config 2 rounds with momentum from the
reference's replicas, and is held within 1e-5 of the port's dp 2 x mp 1
world and within 2e-4 of the reference's ``ShardedCEFedAvg`` on a (2, 2)
mesh (a subprocess with 4 forced host devices); ``lm_loss`` and its
gradients at mp 2 within 1e-5 of ``jax.grad``. Also dp 1 x mp 4 of
qwen2, whose 2 kv heads do not divide the model group (each rank keeps
both and maps its one query head to its global kv group), against a
world of one, and the same with its query heads padded to 8 (each rank
masks its 2 heads by their global index); ``shard_tree`` /
``gather_tree`` round trips. Rank-side
code: ``tests/torch_tp_cases.py``."""
import numpy as np
import pytest

import torch_tp_cases as cases
import tp_reference as ref
from repro_torch import sharding as sh
from repro_torch.core import sharded as ts
from repro_torch.launch import mesh as lm

FAMILIES = ["dense", "encdec", "vlm"]


@pytest.fixture(scope="module")
def inits():
    return {f: ref.ref_init(f, 2) for f in FAMILIES + ["dense_padded"]}


@pytest.fixture(scope="module")
def res(inits, tmp_path_factory):
    w4, w2 = ref.world_jobs(FAMILIES, inits)
    w4 += [("round", "dense", 1, 4, inits["dense"])]
    w4 += [("round_trip", f, 4, inits[f]) for f in FAMILIES]
    w2 += [("round_trip", f, 2, inits[f]) for f in FAMILIES]
    w4 += [("round", "dense_padded", 1, 4, inits["dense_padded"])]
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


def test_mp4_replicates_the_kv_heads(res, inits):
    """dp 1 x mp 4 of the reduced qwen2 (4 query heads, 2 kv heads): the
    kv projections stay whole on every rank; 2 rounds within 1e-5 of a
    world of one from the same replica."""
    exp = cases.experiment("repro_torch", "dense", 1)
    specs = sh.resolve_specs(ts.abstract_model(exp.model),
                             ts.mdl.logical_axes(exp.model),
                             lm.make_mesh((1, 4), ("data", "model")))
    attn = specs["layers"]["attn"]
    assert attn["wq"] == (None, None, "model", None)
    assert attn["wk"] == (None, None, None, None)
    assert attn["bk"] == (None, None, None)
    with lm.single_rank_world("gloo", "cpu") as mesh:
        want = cases.round_job({(1, 1): mesh}, "dense", 1, 1,
                               inits["dense"])
    got = ref.by_replica(res["w4"], len(FAMILIES))[0]
    g = ref.gap(got["params"], want["params"])
    print(f"dense dp 1 x mp 4 against a world of one: params {g:.3e}, "
          f"losses {got['losses']} / {want['losses']}")
    assert g < ref.TOL
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ref.TOL,
                               rtol=0)


def test_mp4_masks_padded_heads_by_global_index(res, inits):
    """dp 1 x mp 4 of the reduced qwen2 with its 4 query heads padded to
    8: a rank holds 2 heads, and rank 1's (global heads 2 and 3) are both
    padding, which only the global offset shows (slot % 4 >= 2). 2
    rounds within 1e-5 of a world of one, and the padded heads' ``wq``,
    ``bq`` and ``wo`` slices are untouched (their outputs are masked,
    so their gradients are zero)."""
    exp = cases.experiment("repro_torch", "dense_padded", 1)
    specs = sh.resolve_specs(ts.abstract_model(exp.model),
                             ts.mdl.logical_axes(exp.model),
                             lm.make_mesh((1, 4), ("data", "model")))
    assert specs["layers"]["attn"]["wq"] == (None, None, "model", None)
    init = inits["dense_padded"]
    with lm.single_rank_world("gloo", "cpu") as mesh:
        want = cases.round_job({(1, 1): mesh}, "dense_padded", 1, 1, init)
    got = ref.by_replica(res["w4"], 2 * len(FAMILIES) + 1)[0]
    g = ref.gap(got["params"], want["params"])
    print(f"padded dense dp 1 x mp 4 against a world of one: params "
          f"{g:.3e}, losses {got['losses']} / {want['losses']}")
    assert g < ref.TOL
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ref.TOL,
                               rtol=0)
    pad = [h for h in range(8) if h % 4 >= 2]
    attn, attn0 = got["params"]["layers"]["attn"], init["layers"]["attn"]
    for name, axis in (("wq", 2), ("bq", 1), ("wo", 1)):
        before = np.take(attn0[name][0], pad, axis=axis)
        after = np.take(attn[name], pad, axis=axis)
        np.testing.assert_array_equal(after, before)
        assert not np.array_equal(np.take(attn[name], [0, 1], axis=axis),
                                  np.take(attn0[name][0], [0, 1],
                                          axis=axis))


def test_shard_and_gather_round_trip(res):
    """Each rank's slices gathered over the model group give back the
    whole tree bit for bit, at mp 4 and mp 2, for every family here."""
    n4 = len(FAMILIES) + 1
    assert all(all(r[n4:n4 + len(FAMILIES)]) for r in res["w4"])
    n2 = 2 * len(FAMILIES)
    assert all(all(r[n2:n2 + len(FAMILIES)]) for r in res["w2"])
