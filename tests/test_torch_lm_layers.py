"""The port's LM layers (``repro_torch.models.layers``) against the
reference (``repro.models.layers``) on the CPU, at f32.

Both sides get the same numpy inputs; parameters are the reference's own
init, carried across with ``repro_torch.convert``. Tolerance 1e-5 (2e-5
where attention sums a softmax over thousands of keys): torch and XLA
sum in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as r_config
from repro.models import layers as RL
from repro_torch.configs import get_model_config as t_config
from repro_torch.convert import tree_from_numpy
from repro_torch.models import layers as TL

TOL = 1e-5


def _cfgs(**kw):
    """The reduced qwen2-0.5b (GQA 4/2 heads, QKV bias) on both sides."""
    return (r_config("qwen2-0.5b").reduced(**kw),
            t_config("qwen2-0.5b").reduced(**kw))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _params(tree):
    """The reference's params as numpy (for jax) and tensors (port)."""
    host = jax.device_get(tree)
    return (jax.tree.map(jnp.asarray, host), tree_from_numpy(host))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    rc, tc = _cfgs(norm=norm)
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 7, rc.d_model, scale=3.0)
    p = {"scale": _rand(rng, rc.d_model), "bias": _rand(rng, rc.d_model)}
    if norm == "rmsnorm":
        del p["bias"]
    jp, tp = _params(p)
    _close(TL.apply_norm(tc, tp, torch.from_numpy(x)),
           RL.apply_norm(rc, jp, jnp.asarray(x)))


def test_rope_splits_halves():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 3, 64)
    pos = np.arange(5, 14)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_apply_mlp(act):
    rc, tc = _cfgs(mlp_act=act)
    jp, tp = _params(RL.init_mlp(jax.random.PRNGKey(2), rc, rc.d_model,
                                 rc.d_ff)[0])
    if act == "gelu":  # nonzero biases
        rng = np.random.default_rng(2)
        for k in ("b_in", "b_out"):
            b = _rand(rng, *tp[k].shape)
            jp[k], tp[k] = jnp.asarray(b), torch.from_numpy(b)
    x = _rand(np.random.default_rng(3), 2, 5, rc.d_model)
    _close(TL.apply_mlp(tc, tp, torch.from_numpy(x)),
           RL.apply_mlp(rc, jp, jnp.asarray(x)))


def _attn_params(rc, seed=4, **kw):
    """Reference attention params with random (nonzero) QKV biases."""
    jp, tp = _params(RL.init_attention(jax.random.PRNGKey(seed), rc,
                                       **kw)[0])
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        if k in tp:
            b = _rand(rng, *tp[k].shape, scale=0.5)
            jp[k], tp[k] = jnp.asarray(b), torch.from_numpy(b)
    return jp, tp


def test_qkv_project_with_bias():
    rc, tc = _cfgs()
    assert rc.qkv_bias and rc.num_kv_heads < rc.num_heads
    jp, tp = _attn_params(rc)
    x = _rand(np.random.default_rng(5), 2, 6, rc.d_model)
    for t, j in zip(TL.qkv_project(tc, tp, torch.from_numpy(x)),
                    RL.qkv_project(rc, jp, jnp.asarray(x))):
        assert tuple(t.shape) == j.shape
        _close(t, j)


# (Sq, Sk, causal, window, q_offset): both branches of attention_core;
# the last case crosses the 2048 switch into the block scan
ATTN_CASES = [
    (64, 64, True, 0, 0),
    (64, 64, False, 0, 0),
    (80, 80, True, 16, 0),
    (16, 64, True, 0, 48),
    (40, 100, True, 24, 60),
    (2100, 2100, True, 300, 0),
]


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", ATTN_CASES)
def test_attention_core(Sq, Sk, causal, window, q_offset):
    rng = np.random.default_rng(Sq + Sk + window)
    B, H, Hkv, D = (1, 2, 1, 16) if Sq > 2048 else (2, 4, 2, 32)
    q, k, v = (_rand(rng, B, S, h, D)
               for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    got = TL.attention_core(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window, q_offset=q_offset)
    exp = RL.attention_core(*map(jnp.asarray, (q, k, v)), causal=causal,
                            window=window, q_offset=q_offset)
    assert tuple(got.shape) == exp.shape == (B, Sq, H, D)
    _close(got, exp, 2e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_apply_and_decode_attention(window):
    rc, tc = _cfgs(sliding_window=window)
    jp, tp = _attn_params(rc, seed=6)
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 12, rc.d_model)
    _close(TL.apply_attention(tc, tp, torch.from_numpy(x)),
           RL.apply_attention(rc, jp, jnp.asarray(x)))
    # one decode step at pos 9 against a cache holding positions 0..8
    S, hk, hd = 16, rc.num_kv_heads, rc.resolved_head_dim
    kc, vc = _rand(rng, 2, S, hk, hd), _rand(rng, 2, S, hk, hd)
    x1 = _rand(rng, 2, 1, rc.d_model)
    o_j, k_j, v_j = RL.decode_attention(rc, jp, jnp.asarray(x1),
                                        jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(9, jnp.int32))
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    o_t, k_t, v_t = TL.decode_attention(tc, tp, torch.from_numpy(x1), kt,
                                        vt, 9)
    assert k_t is kt and v_t is vt  # written in place
    _close(o_t, o_j)
    _close(k_t, k_j)
    _close(v_t, v_j)


def test_padded_heads_are_inert():
    rc, tc = _cfgs(head_pad_to=6)
    assert RL.padded_heads(rc) == TL.padded_heads(tc) == 6
    jp, tp = _attn_params(rc, seed=7)
    assert tuple(tp["wq"].shape) == jp["wq"].shape == (rc.d_model, 6, 64)
    x = _rand(np.random.default_rng(7), 2, 10, rc.d_model)
    _close(TL.apply_attention(tc, tp, torch.from_numpy(x)),
           RL.apply_attention(rc, jp, jnp.asarray(x)))
    out = torch.ones(2, 10, 6, 64)
    masked = TL._mask_padded_heads(tc, out)
    exp = RL._mask_padded_heads(rc, jnp.ones((2, 10, 6, 64)))
    _close(masked, exp, 0)


def test_dense_init_scale_and_dtype():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, 400, (400, 300), torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (400, 300)
    std = float(w.float().std())
    assert abs(std - 1 / 20) < 2e-3, std
    cfg = dataclasses.replace(t_config("qwen2-0.5b").reduced(),
                              norm="layernorm")
    p = TL.init_norm(cfg, 8, "cpu", (3,))
    assert tuple(p["scale"].shape) == (3, 8) and bool((p["bias"] == 0).all())
