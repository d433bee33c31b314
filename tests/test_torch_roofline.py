"""The dry-run's inputs and arithmetic against the reference's
(``repro_torch.launch.specs`` and ``.roofline``), the counted GEMM
operations against the parameter count, and the kernels' routing under
``flags.analysis``.

- ``train_batch_shapes``, ``prefill_batch_shapes`` and the decode cache
  and tokens of ``decode_input_shapes``: shapes and dtypes equal the
  reference's for every arch, applicable shape and production mesh;
- ``model_flops`` and the parameter counts equal the reference's for
  every arch (``abstract_model`` on ``meta`` against ``jax.eval_shape``);
- ``roofline_terms`` equals the reference's under its own constants;
- the counted operations of a reduced qwen2-0.5b prefill, less the
  attention twin's, are 2·tokens·Σ(matrix-product weights) exactly, and
  a training step's (the dry-run's own count) three times that;
- a ``meta`` tensor outside ``flags.analysis`` raises in the kernels'
  dispatch; under it a CPU tensor still takes the plain version, bit
  for bit, and neither kernel nor twin counts anything."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_experiment as r_experiment
from repro.configs import get_model_config as rcfg
from repro.core import sharded as rsd
from repro.launch import roofline as r_rf
from repro.launch import specs as r_specs
from repro_torch import flags
from repro_torch import kernels
from repro_torch import tree as tr
from repro_torch.config import (INPUT_SHAPES, ExperimentConfig, FLConfig,
                                ShapeConfig)
from repro_torch.configs import ARCHS, applicable_shapes
from repro_torch.configs import get_experiment as t_experiment
from repro_torch.configs import get_model_config as tcfg
from repro_torch.core import sharded as tsd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as lm
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs as t_specs
from repro_torch.models import model as mdl

ARCH_IDS = sorted(ARCHS)


def _sig(leaves):
    """(shape, dtype name) of each leaf, torch or jax."""
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves]


def _dict_sig(d):
    return {k: _sig([v])[0] for k, v in d.items()}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single_pod", "multi_pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, multi_pod):
    R = 32 if multi_pod else 16
    for name in applicable_shapes(arch):
        shape = INPUT_SHAPES[name]
        if shape.kind == "train":
            got = t_specs.train_batch_shapes(
                t_experiment(arch, multi_pod=multi_pod), shape, R)
            want = r_specs.train_batch_shapes(
                r_experiment(arch, multi_pod=multi_pod), shape, R)
            assert _dict_sig(got) == _dict_sig(want), (arch, name)
        elif shape.kind == "prefill":
            got = t_specs.prefill_batch_shapes(tcfg(arch), shape)
            want = r_specs.prefill_batch_shapes(rcfg(arch), shape)
            assert _dict_sig(got) == _dict_sig(want), (arch, name)
        else:
            cache, tok, pos = t_specs.decode_input_shapes(tcfg(arch), shape)
            rcache, rtok, rpos = r_specs.decode_input_shapes(rcfg(arch),
                                                             shape)
            assert sorted(cache) == sorted(rcache)
            assert _sig(tr.tree_leaves(cache)) == _sig(
                jax.tree.leaves(rcache)), (arch, name)
            assert _sig([tok]) == _sig([rtok])
            assert rpos.shape == () and pos == shape.seq_len - 1
            assert all(t.is_meta for t in tr.tree_leaves(cache))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_param_counts_match_reference(arch):
    ours = tsd.abstract_model(tcfg(arch))
    theirs, _ = rsd.abstract_model(rcfg(arch))
    for kind, tokens in (("train", 8 * 2 * 256 * 4096), ("infer", 128)):
        got = rf.model_flops(tcfg(arch), ours, kind, tokens)
        want = r_rf.model_flops(rcfg(arch), theirs, kind, tokens)
        assert got == want, (arch, kind, got, want)


@pytest.mark.parametrize("terms", [(3.2e15, 1.1e12, 4.0e9),
                                   (1.0e12, 9.0e12, 2.0e9),
                                   (5.0e11, 2.0e10, 8.0e11),
                                   (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference_under_its_constants(terms):
    got = rf.roofline_terms(*terms, peak_flops=r_rf.PEAK_FLOPS,
                            hbm_bw=r_rf.HBM_BW, coll_bw=r_rf.ICI_BW)
    assert got == r_rf.roofline_terms(*terms)


def test_collective_term_prices_each_group_at_its_link():
    coll = {"model": 9.0e9, "data": 5.0e9}
    one = rf.roofline_terms(0.0, 0.0, coll, coll_bw=rf.link_rates(
        lm.make_mesh((2, 8), ("data", "model"))))
    two = rf.roofline_terms(0.0, 0.0, coll, coll_bw=rf.link_rates(
        lm.make_production_mesh()))
    assert one["collective_s"] == 9.0e9 / rf.NVLINK_BW + 5.0e9 / rf.NET_BW
    assert two["collective_s"] == 14.0e9 / rf.NET_BW


MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_out")


def _gemm_weights(cfg, params) -> int:
    """Σ of the weights that enter a matrix product in the dense family:
    the attention and MLP weights, and the (tied) head."""
    n = sum(leaf.numel() for keys, leaf in rf._leaves(params)
            if keys[-1] in MATMUL_KEYS)
    return n + params["tok_embed"].numel() * cfg.tie_embeddings


def test_gemm_flops_of_prefill_and_train_step():
    cfg = tcfg("qwen2-0.5b").reduced()
    B, S = 2, 64
    params = tsd.abstract_model(cfg)
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    with flags.analysis(), rf.count_cost(params, batch) as rec:
        logits, _ = mdl.forward(cfg, params, batch)
    assert logits.shape == (B, S, mdl.padded_vocab(cfg))
    want = 2 * B * S * _gemm_weights(cfg, params)
    assert rec["twin_flops"] > 0
    assert rec["flops"] - rec["twin_flops"] == want
    exp = ExperimentConfig(model=cfg, fl=FLConfig(num_clusters=1,
                                                  devices_per_cluster=1))
    fig = dr.count_train(exp, lm.make_mesh((1, 1), ("data", "model")),
                         ShapeConfig("t", S, B, "train"), production=False)
    step = fig["components"]["local_step"]
    assert step["flops"] - step["twin_flops"] == 3 * want


def test_meta_raises_outside_analysis():
    for arch in ("qwen2-0.5b", "mamba2-2.7b"):
        cfg = tcfg(arch).reduced()
        batch = {"tokens": torch.empty((1, 64), dtype=torch.int32,
                                       device="meta")}
        with pytest.raises(ValueError, match="no kernel for meta"):
            mdl.forward(cfg, tsd.abstract_model(cfg), batch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b"])
def test_cpu_takes_plain_version_under_analysis(arch):
    cfg = tcfg(arch).reduced()
    params = mdl.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))}
    want, _ = mdl.forward(cfg, params, batch)
    before = (fa.launches, fa.bwd_launches, ss.launches, ss.bwd_launches,
              dict(kernels.twin_counts))
    with flags.analysis():
        got, _ = mdl.forward(cfg, params, batch)
    assert torch.equal(got, want)
    assert (fa.launches, fa.bwd_launches, ss.launches, ss.bwd_launches,
            dict(kernels.twin_counts)) == before
