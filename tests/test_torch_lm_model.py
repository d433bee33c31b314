"""The port's language models (``repro_torch.models.model``) against the
reference (``repro.models.model``) on the CPU, for the ported families:
reduced zamba2-2.7b (hybrid, 4 layers = 2 groups), mamba2-2.7b (ssm)
and qwen2-0.5b (dense, GQA with QKV bias), at f32.

The port runs the reference's own parameters, carried across with
``repro_torch.convert``. Tolerances: logits 1e-4 and loss 1e-5 against
the reference (sums in another order over a few layers); decode against
forward inside the port 1e-4; the init's tree, shapes and dtypes
exactly; Zamba2-2.7B's full-width parameter count exactly, from meta
tensors. Also: bf16 trees cross bit for bit, the serve driver runs on
the CPU, and unported archs and families raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as r_config
from repro.data.lm import synthetic_lm_batch as r_batch
from repro.models import model as rm
from repro_torch import tree as tr
from repro_torch.configs import get_model_config as t_config
from repro_torch.convert import tree_from_numpy
from repro_torch.data.lm import TokenStream, synthetic_lm_batch
from repro_torch.launch import serve
from repro_torch.models import model as tm

ARCHS = {"zamba2-2.7b": dict(num_layers=4), "mamba2-2.7b": {},
         "qwen2-0.5b": {}}
ZAMBA2_PARAMS = 2_422_670_240


def _cfgs(arch, **kw):
    kw = {**ARCHS[arch], **kw}
    return r_config(arch).reduced(**kw), t_config(arch).reduced(**kw)


def _params(rc, seed=0):
    host = jax.device_get(rm.init_model(jax.random.PRNGKey(seed), rc)[0])
    return jax.tree.map(jnp.asarray, host), tree_from_numpy(host)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_reference(arch):
    rc, tc = _cfgs(arch)
    jp, tp = _params(rc)
    batch = synthetic_lm_batch((2, 96), tc.vocab_size, seed=1)
    ref = r_batch((2, 96), rc.vocab_size, seed=1)
    assert all(np.array_equal(batch[k], ref[k]) for k in batch)
    logits, aux = tm.forward(tc, tp, batch)
    exp, _ = rm.forward(rc, jp, {k: jnp.asarray(v) for k, v in ref.items()})
    assert tuple(logits.shape) == exp.shape == (2, 96, tm.padded_vocab(tc))
    assert float(aux) == 0.0
    _close(logits, exp, 1e-4)
    loss = tm.lm_loss(tc, tp, batch)
    exp_loss = rm.lm_loss(rc, jp, {k: jnp.asarray(v) for k, v in ref.items()})
    assert abs(float(loss) - float(exp_loss)) <= 1e-5 * abs(float(exp_loss))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_steps_match_reference(arch):
    """Eight decode steps from an empty cache, logits and caches step for
    step."""
    rc, tc = _cfgs(arch)
    jp, tp = _params(rc, seed=1)
    B, S = 2, 8
    toks = synthetic_lm_batch((B, S), tc.vocab_size, seed=2)["tokens"]
    jc, _ = rm.init_decode_cache(rc, B, S, dtype=jnp.float32)
    tcache = tm.init_decode_cache(tc, B, S, dtype=torch.float32,
                                  device="cpu")
    assert sorted(tcache) == sorted(jc)
    for i in range(S):
        lj, jc = rm.decode_step(rc, jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(i, jnp.int32))
        lt, tcache = tm.decode_step(tc, tp, tcache, toks[:, i:i + 1], i)
        _close(lt, lj, 1e-4)
    for k in jc:
        assert tuple(tcache[k].shape) == jc[k].shape
        _close(tcache[k], jc[k], 1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_forward_in_port(arch):
    """Incremental decode logits == the full-sequence forward's, in the
    port alone (the reference's property, tests/test_models.py)."""
    _, tc = _cfgs(arch)
    gen = torch.Generator().manual_seed(3)
    params = tm.init_model(gen, tc, "cpu")
    B, S = 2, 20
    toks = synthetic_lm_batch((B, S), tc.vocab_size, seed=3)["tokens"]
    full, _ = tm.forward(tc, params, {"tokens": toks})
    cache = tm.init_decode_cache(tc, B, S, device="cpu")
    outs = []
    for i in range(S):
        lg, cache = tm.decode_step(tc, params, cache, toks[:, i:i + 1], i)
        outs.append(lg)
    _close(torch.cat(outs, dim=1), full.numpy(), 1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference_shapes(arch, dtype):
    rc, tc = _cfgs(arch, dtype=dtype, param_dtype=dtype)
    shapes = jax.eval_shape(lambda k: rm.init_model(k, rc)[0],
                            jax.random.PRNGKey(0))
    params = tm.init_model(torch.Generator().manual_seed(0), tc, "cpu")
    t_leaves, t_def = tr.tree_flatten(params)
    j_leaves, j_def = tr.tree_flatten(shapes)
    assert t_def == j_def
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert tm.param_count(params) == rm.param_count(shapes)


def test_zamba2_full_width_param_count_from_shapes():
    cfg = t_config("zamba2-2.7b")
    params = tm.init_model(torch.Generator().manual_seed(0), cfg, "meta")
    assert all(t.is_meta for t in tr.tree_leaves(params))
    assert tm.param_count(params) == ZAMBA2_PARAMS
    assert tuple(params["layers"]["mamba"]["wx"].shape) == (9, 6, 2560, 5120)
    assert tuple(params["shared_block"]["attn"]["wq"].shape) == (2560, 32, 80)


def test_bf16_reference_tree_converts_bit_for_bit():
    rc = r_config("zamba2-2.7b").reduced(num_layers=4, dtype="bfloat16",
                                         param_dtype="bfloat16")
    host = jax.device_get(rm.init_model(jax.random.PRNGKey(4), rc)[0])
    tree = tree_from_numpy(host)
    n_bf16 = 0
    for t, h in zip(tr.tree_leaves(tree), tr.tree_leaves(host)):
        h = np.asarray(h)
        assert tuple(t.shape) == h.shape
        if h.dtype == ml_dtypes.bfloat16:
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  h.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), h)
    assert n_bf16 > 20


def test_serve_driver_on_cpu(capsys):
    out = serve.main(["--arch", "zamba2-2.7b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "8",
                      "--decode-tokens", "4", "--max-seq", "16"])
    assert out["finite"] and tuple(out["tokens"].shape) == (2, 5)
    assert "tok/s" in capsys.readouterr().out


def test_token_stream_matches_reference():
    from repro.data.lm import TokenStream as RStream
    cluster_of = lambda r: r // 2  # noqa: E731
    a, b = TokenStream(512, 4, cluster_of), RStream(512, 4, cluster_of)
    for _ in range(2):
        x, y = a.next_batch((3, 5)), b.next_batch((3, 5))
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_unported_archs_and_families_raise():
    with pytest.raises(KeyError, match="A15"):
        t_config("mixtral-8x7b")
    moe = dataclasses.replace(t_config("qwen2-0.5b").reduced(), family="moe")
    with pytest.raises(NotImplementedError, match="A15"):
        tm.init_model(torch.Generator(), moe, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_model(torch.Generator(), t_config("qwen2-0.5b").reduced())
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "qwen2-0.5b", "--reduced"])
