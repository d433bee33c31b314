"""The port's configuration registry against ``repro.configs``.

The port registers the reference's ten archs, each with a
``ModelConfig`` equal, field by field, to the reference's, and the
paper experiments' configs match. The dense archs ``minitron-8b``
(squared-ReLU MLP) and ``qwen2.5-14b`` (QKV bias, rope_theta 1e6), and
``mistral-large-123b``, run their reduced forward on the CPU through
the plain kernels: logits within 1e-4 of the reference's on the
reference's own parameters (sums in another order over two layers).
At full width the parameter counts of those three and of the MoE,
encoder-decoder and VLM archs equal the reference's, counted from
``meta`` tensors on the port's side (mistral-large-123b is about 246 GB
in bf16 and llama4-maverick about 800 GB, more than one card holds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.data.lm import synthetic_lm_batch as r_batch
from repro.models import model as rm
from repro_torch import configs as tcfg
from repro_torch.convert import tree_from_numpy
from repro_torch.data.lm import synthetic_lm_batch
from repro_torch.models import model as tm

DENSE_NEW = ("minitron-8b", "qwen2.5-14b", "mistral-large-123b")
#: the archs of the moe, encdec and vlm families
FAMILIES_NEW = ("mixtral-8x7b", "llama4-maverick-400b-a17b",
                "whisper-medium", "pixtral-12b")


@pytest.mark.parametrize("arch", sorted(tcfg.ARCHS))
def test_registered_configs_equal_reference(arch):
    assert tcfg.ARCHS[arch] == rcfg.ARCHS[arch]
    a = dataclasses.asdict(tcfg.get_model_config(arch))
    b = dataclasses.asdict(rcfg.get_model_config(arch))
    assert a == b
    assert tcfg.get_model_config(arch).family in tm.PORTED_FAMILIES


def test_registry_covers_every_ported_family_arch():
    """The registry is the reference's: every arch, every LM family."""
    assert tcfg.ARCHS == rcfg.ARCHS
    assert {tcfg.get_model_config(a).family for a in tcfg.ARCHS} == set(
        tm.PORTED_FAMILIES)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_model_config("gpt-5")


@pytest.mark.parametrize("name", ["femnist_cnn", "cifar_vgg11"])
def test_paper_experiment_configs_equal_reference(name):
    import importlib
    assert tcfg.PAPER_EXPERIMENTS == rcfg.PAPER_EXPERIMENTS
    a = importlib.import_module(f"repro_torch.configs.{name}")
    b = importlib.import_module(f"repro.configs.{name}")
    assert dataclasses.asdict(a.FL) == dataclasses.asdict(b.FL)
    for f in ("MODEL_NAME", "NUM_CLASSES", "IMAGE", "PARAMS"):
        assert getattr(a, f) == getattr(b, f)


def test_cifar_vgg11_params_match_the_config():
    from repro_torch.configs import cifar_vgg11
    from repro_torch.models.cnn import init_vgg11
    from repro_torch.tree import tree_leaves
    params = init_vgg11(torch.Generator().manual_seed(0),
                        num_classes=cifar_vgg11.NUM_CLASSES)
    assert sum(t.numel() for t in tree_leaves(params)) == cifar_vgg11.PARAMS


@pytest.mark.parametrize("arch", DENSE_NEW)
def test_reduced_forward_matches_reference(arch):
    rc = rcfg.get_model_config(arch).reduced()
    tc = tcfg.get_model_config(arch).reduced()
    host = jax.device_get(rm.init_model(jax.random.PRNGKey(0), rc)[0])
    jp = jax.tree.map(jnp.asarray, host)
    tp = tree_from_numpy(host)
    batch = synthetic_lm_batch((2, 64), tc.vocab_size, seed=1)
    ref = r_batch((2, 64), rc.vocab_size, seed=1)
    logits, _ = tm.forward(tc, tp, batch)
    exp, _ = rm.forward(rc, jp, {k: jnp.asarray(v) for k, v in ref.items()})
    assert tuple(logits.shape) == exp.shape
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(exp, np.float32), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", DENSE_NEW + FAMILIES_NEW)
def test_full_width_param_count_equals_reference(arch):
    cfg = tcfg.get_model_config(arch)
    params = tm.init_model(torch.Generator().manual_seed(0), cfg, "meta")
    shapes = jax.eval_shape(
        lambda k: rm.init_model(k, rcfg.get_model_config(arch))[0],
        jax.random.PRNGKey(0))
    assert tm.param_count(params) == rm.param_count(shapes)
