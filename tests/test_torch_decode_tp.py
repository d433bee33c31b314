"""Model-parallel decode and ``attn_seq_shard`` (the dry-run's serving
programs): one gloo world of 2 CPU ranks (rank code in
``tests/torch_decode_cases.py``) against the unsplit port in this
process, at the reduced f32 configs.

- ``decode_step`` at dp 1 x mp 2 (the rank's heads, experts or inner
  slice, its part of the cache as ``serve_specs`` places it, the
  vocabulary split) over 4 tokens within 1e-5 of mp 1, for every family;
- at dp 2 x mp 1 with a batch of 1 (``serve_specs`` puts the kv
  positions over ``data``: ``core.collectives.SequenceSplit``) within
  1e-5 of the unsplit step, for every family with a KV cache;
- ``lm_loss`` and its gradients with ``attn_seq_shard`` at mp 2 (3
  query heads, which do not split: each rank attends its half of the q
  rows) within 1e-5 of mp 1."""
import numpy as np
import pytest

import torch_decode_cases as cases
from repro_torch import tree as tr
from repro_torch.launch import mesh as lm

FAMILIES = list(cases.FAMILIES)
KV_FAMILIES = [f for f in FAMILIES if f != "ssm"]
TOL = 1e-5


@pytest.fixture(scope="module")
def res():
    jobs = [("decode", f, 1, 2, 2) for f in FAMILIES]
    jobs += [("decode", f, 2, 1, 1) for f in KV_FAMILIES]
    jobs += [("seq_shard", 2)]
    out = lm.run_local_ranks(cases.world, 2, args=(jobs,), device="cpu",
                             timeout_s=600)
    return {job[:5] if job[0] == "decode" else job: r
            for job, r in zip(jobs, out[0])}


def _unsplit(family: str, batch: int) -> np.ndarray:
    cfg = cases.config(family)
    return cases.decode(cfg, cases.whole_params(cfg),
                        cases.whole_cache(cfg, batch),
                        cases.tokens(cfg, batch))


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_mp2_matches_mp1(res, family):
    got = res[("decode", family, 1, 2, 2)]
    want = _unsplit(family, 2)
    assert got["logits"].shape == want.shape
    assert np.abs(got["logits"] - want).max() <= TOL
    # the split layers reduce over the model group, and nothing crosses
    # the (size 1) data group
    assert got["traffic"]["model"]["all_reduce"]["calls"] > 0
    assert not got["traffic"]["data"]


@pytest.mark.parametrize("family", KV_FAMILIES)
def test_decode_kv_positions_over_data_match_unsplit(res, family):
    got = res[("decode", family, 2, 1, 1)]
    want = _unsplit(family, 1)
    assert np.abs(got["logits"] - want).max() <= TOL
    # the softmax's max, its sum and the output: three reductions an
    # attention call over the data group
    assert got["traffic"]["data"]["all_reduce"]["calls"] % 3 == 0


def test_attn_seq_shard_mp2_matches_mp1(res):
    got = res[("seq_shard", 2)]
    cfg = cases.config("dense", **cases.SEQ_SHARD)
    # one gather of the q rows' outputs an attention call
    assert got["traffic"]["model"]["all_gather"]["calls"] == cfg.num_layers
    loss, grads = cases.loss_and_grads(cfg, cases.whole_params(cfg),
                                       cases.seq_batch())
    assert abs(got["loss"] - float(loss.detach())) <= TOL
    gap = max(float(np.abs(a - b.numpy()).max()) for a, b in
              zip(tr.tree_leaves(got["grads"]), tr.tree_leaves(grads)))
    assert gap <= TOL
