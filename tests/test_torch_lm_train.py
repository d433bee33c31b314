"""Training the port's language models on the CPU: ``lm_loss`` gradients
of reduced qwen2-0.5b against ``jax.grad`` of the reference's
``lm_loss`` (f32, within 1e-5: sums in another order over two layers),
without and with ``remat`` (the reference's ``jax.checkpoint`` of each
layer body; the port's ``torch.utils.checkpoint``), and the port's
gradients with ``remat`` equal to those without, bit for bit, for every
family. The reference's parameters cross with ``repro_torch.convert``;
batches come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as r_config
from repro.models import model as rm
from repro_torch import tree as tr
from repro_torch.configs import get_model_config as t_config
from repro_torch.convert import tree_from_numpy
from repro_torch.data.lm import synthetic_lm_batch
from repro_torch.models import model as tm

TOL = 1e-5
FAMILIES = {"qwen2-0.5b": {}, "mixtral-8x7b": {},
            "llama4-maverick-400b-a17b": {}, "mamba2-2.7b": {},
            "zamba2-2.7b": dict(num_layers=4), "whisper-medium": {},
            "pixtral-12b": {}}


def _setup(arch, B=2, S=32, seed=0):
    kw = FAMILIES[arch]
    rc, tc = r_config(arch).reduced(**kw), t_config(arch).reduced(**kw)
    host = jax.device_get(rm.init_model(jax.random.PRNGKey(seed), rc)[0])
    batch = synthetic_lm_batch((B, S), tc.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 100)
    if tc.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, tc.encoder_seq, tc.d_model)) * 0.02).astype(np.float32)
    if tc.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal(
            (B, tc.num_patches, tc.d_model)) * 0.02).astype(np.float32)
    return rc, tc, host, batch


def _port_grads(tc, host, batch, remat):
    params = tree_from_numpy(host)
    leaves, treedef = tr.tree_flatten(params)
    live = [p.requires_grad_(True) for p in leaves]
    loss = tm.lm_loss(tc, tr.tree_unflatten(treedef, live), batch,
                      remat=remat)
    return loss.detach(), torch.autograd.grad(loss, live)


@pytest.mark.parametrize("remat", [False, True])
def test_qwen2_grads_match_reference(remat):
    rc, tc, host, batch = _setup("qwen2-0.5b")
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rloss, rgrads = jax.value_and_grad(
        lambda p: rm.lm_loss(rc, p, rb, remat=remat))(
            jax.tree.map(jnp.asarray, host))
    loss, grads = _port_grads(tc, host, batch, remat)
    assert abs(float(loss) - float(rloss)) < TOL
    exp = jax.tree.leaves(rgrads)
    assert len(exp) == len(grads)
    for g, e in zip(grads, exp):
        assert tuple(g.shape) == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_remat_grads_equal_bit_for_bit(arch):
    _, tc, host, batch = _setup(arch, seed=1)
    l0, g0 = _port_grads(tc, host, batch, remat=False)
    l1, g1 = _port_grads(tc, host, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_forward_remat_keeps_the_outputs():
    _, tc, host, batch = _setup("zamba2-2.7b", seed=2)
    params = tree_from_numpy(host)
    a, _ = tm.forward(tc, params, batch)
    b, _ = tm.forward(tc, params, batch, remat=True)
    assert torch.equal(a, b)
