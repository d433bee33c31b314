"""The port's language models (``repro_torch.models.model``) against the
reference (``repro.models.model``) on the CPU, at f32, for every family:
reduced zamba2-2.7b (hybrid, 4 layers = 2 groups), mamba2-2.7b (ssm),
qwen2-0.5b (dense, GQA with QKV bias), mixtral-8x7b (moe, sliding
window), llama4-maverick (moe: a (dense SWA, MoE full) pair with the
shared expert), whisper-medium (encdec: layernorm, gelu, sinusoidal
positions, cross-attention) and pixtral-12b (vlm: patch embeddings
before the tokens).

The port runs the reference's own parameters, carried across with
``repro_torch.convert``. Tolerances: logits 1e-4 and loss 1e-5 against
the reference (sums in another order over a few layers); 16 decode
steps 1e-4 (logits and caches); decode against forward inside the port
1e-4 (every family but vlm, whose decode never sees the patches, as in
the reference; encdec with its cross caches filled from the encoder);
the init's tree, shapes and dtypes exactly; Zamba2-2.7B's full-width
parameter count exactly, from meta tensors. Also: bf16 trees cross bit
for bit, the serve driver runs on the CPU, and the ``cnn`` family
raises.
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
from repro_torch.models import layers as L
from repro_torch.models import model as tm

ARCHS = {"zamba2-2.7b": dict(num_layers=4), "mamba2-2.7b": {},
         "qwen2-0.5b": {}, "mixtral-8x7b": {},
         "llama4-maverick-400b-a17b": {}, "whisper-medium": {},
         "pixtral-12b": {}}
ZAMBA2_PARAMS = 2_422_670_240


def _cfgs(arch, **kw):
    kw = {**ARCHS[arch], **kw}
    return r_config(arch).reduced(**kw), t_config(arch).reduced(**kw)


def _params(rc, seed=0):
    host = jax.device_get(rm.init_model(jax.random.PRNGKey(seed), rc)[0])
    return jax.tree.map(jnp.asarray, host), tree_from_numpy(host)


def _batch(cfg, B, S, seed):
    """The reference's ``_reduced_batch`` (tests/test_models.py) from
    numpy: tokens and labels, encdec frames and vlm patch embeddings
    (seeded normals x 0.02; vlm keeps S - num_patches text tokens)."""
    batch = synthetic_lm_batch((B, S), cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
        batch["tokens"] = batch["tokens"][:, :S - cfg.num_patches]
        batch["labels"] = batch["labels"][:, :S - cfg.num_patches]
    return batch


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_reference(arch):
    rc, tc = _cfgs(arch)
    jp, tp = _params(rc)
    batch = _batch(tc, 2, 96, seed=1)
    ref = r_batch((2, 96), rc.vocab_size, seed=1)
    assert all(np.array_equal(batch[k][:, :ref[k].shape[1]], ref[k][
        :, :batch[k].shape[1]]) for k in ref)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = tm.forward(tc, tp, batch)
    exp, exp_aux = rm.forward(rc, jp, jbatch)
    assert tuple(logits.shape) == exp.shape == (2, 96, tm.padded_vocab(tc))
    if tc.family == "moe":
        assert float(aux) > 0.0
        assert abs(float(aux) - float(exp_aux)) <= 1e-6
    else:
        assert float(aux) == 0.0
    _close(logits, exp, 1e-4)
    loss = tm.lm_loss(tc, tp, batch)
    exp_loss = rm.lm_loss(rc, jp, jbatch)
    assert abs(float(loss) - float(exp_loss)) <= 1e-5 * abs(float(exp_loss))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_steps_match_reference(arch):
    """Sixteen decode steps from an empty cache (encdec: cross caches
    filled with the same seeded normals), logits and caches step for
    step."""
    rc, tc = _cfgs(arch)
    jp, tp = _params(rc, seed=1)
    B, S = 2, 16
    toks = synthetic_lm_batch((B, S), tc.vocab_size, seed=2)["tokens"]
    jc, _ = rm.init_decode_cache(rc, B, S, dtype=jnp.float32)
    tcache = tm.init_decode_cache(tc, B, S, dtype=torch.float32,
                                  device="cpu")
    assert sorted(tcache) == sorted(jc)
    rng = np.random.default_rng(2)
    for k in ("xk", "xv"):
        if k in jc:
            fill = rng.standard_normal(jc[k].shape).astype(np.float32)
            jc[k] = jnp.asarray(fill)
            tcache[k].copy_(torch.from_numpy(fill))
    for i in range(S):
        lj, jc = rm.decode_step(rc, jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(i, jnp.int32))
        lt, tcache = tm.decode_step(tc, tp, tcache, toks[:, i:i + 1], i)
        _close(lt, lj, 1e-4)
    for k in jc:
        assert tuple(tcache[k].shape) == jc[k].shape
        _close(tcache[k], jc[k], 1e-4)


def _cross_caches(cfg, params, frames, cache):
    """Fill an encdec cache's xk/xv from the encoder output, as the
    reference's tests/test_models.py does."""
    enc = tm._encode(cfg, params, frames)
    ks, vs = zip(*(L.qkv_project(cfg, tm._layer(params["dec_layers"], i)[
        "cross_attn"], enc, enc)[1:] for i in range(cfg.num_layers)))
    cache["xk"], cache["xv"] = torch.stack(ks), torch.stack(vs)


@pytest.mark.parametrize("arch", sorted(
    a for a in ARCHS if t_config(a).family != "vlm"))
def test_decode_matches_forward_in_port(arch):
    """Incremental decode logits == the full-sequence forward's, in the
    port alone (the reference's property, tests/test_models.py). It holds
    only where no assignment is dropped (a decode step never drops), so
    MoE runs at capacity_factor E / k, whose capacity of more than T
    slots an expert cannot bind: asserted."""
    _, tc = _cfgs(arch)
    if tc.family == "moe":
        tc = dataclasses.replace(
            tc, capacity_factor=tc.num_experts / tc.experts_per_token)
    gen = torch.Generator().manual_seed(3)
    params = tm.init_model(gen, tc, "cpu")
    B, S = 2, 20
    batch = _batch(tc, B, S, seed=3)
    toks = batch["tokens"]
    drops = []
    full, _ = tm.forward(tc, params, batch, drops=drops)
    assert len(drops) == (tc.num_layers // (2 if tc.moe_shared_expert
                                             else 1)
                          if tc.family == "moe" else 0)
    assert all(int(d) == 0 for d in drops)
    cache = tm.init_decode_cache(tc, B, S, device="cpu")
    if tc.family == "encdec":
        _cross_caches(tc, params, batch["frames"], cache)
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-medium", "pixtral-12b"])
def test_serve_driver_new_families_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6",
                      "--decode-tokens", "3", "--max-seq", "12",
                      "--num-layers", "2"])
    assert out["finite"] and tuple(out["tokens"].shape) == (2, 4)
    assert "layers=2" in capsys.readouterr().out


def test_token_stream_matches_reference():
    from repro.data.lm import TokenStream as RStream
    cluster_of = lambda r: r // 2  # noqa: E731
    a, b = TokenStream(512, 4, cluster_of), RStream(512, 4, cluster_of)
    for _ in range(2):
        x, y = a.next_batch((3, 5)), b.next_batch((3, 5))
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_unported_archs_and_families_raise():
    """Every LM family runs; ``cnn`` (the FL path's models) raises in
    ``init_model`` as in the reference; entry points need a card unless
    asked for the CPU."""
    cnn = dataclasses.replace(t_config("qwen2-0.5b").reduced(), family="cnn")
    with pytest.raises(ValueError, match="cnn"):
        tm.init_model(torch.Generator(), cnn, "cpu")
    r_cnn = dataclasses.replace(r_config("qwen2-0.5b").reduced(),
                                family="cnn")
    with pytest.raises(ValueError, match="cnn"):
        rm.init_model(jax.random.PRNGKey(0), r_cnn)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_model(torch.Generator(), t_config("qwen2-0.5b").reduced())
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "qwen2-0.5b", "--reduced"])
