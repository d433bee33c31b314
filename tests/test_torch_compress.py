"""The port's uplink compression (``repro_torch.core.compress``) against
``repro.core.compress``, bit for bit.

The same numpy deltas, residuals, FlatLayout segments and keys go
through the reference's ``compress_flat`` (``jax.vmap`` over device
rows, as its upload does) and the port's batched one, and through both
``compress_tree``s: the sent values and the new EF residuals are equal
bit for bit — top-k selection and the int8 scale are exact, the
stochastic rounding's uniforms are jax's to the bit, and the
arithmetic is the same f32 operations in the same order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as rc
from repro_torch.core import compress as tc

#: leaf sizes of a small model: bias-sized, odd, and one long leaf
SEGMENTS = ((0, 100), (100, 37), (137, 263), (400, 5000), (5400, 1))
T = 5401
ROWS = 6
CONFIGS = {
    "int8_stochastic": dict(kind="int8"),
    "int8_deterministic": dict(kind="int8", stochastic=False),
    "int8_no_ef": dict(kind="int8", error_feedback=False),
    "topk5": dict(kind="topk", topk_frac=0.05),
    "topk30_no_ef": dict(kind="topk", topk_frac=0.3, error_feedback=False),
    "topk_all": dict(kind="topk", topk_frac=1.0),
    "none": dict(kind="none"),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    vec = rng.standard_normal((ROWS, T)).astype(np.float32)
    res = (0.1 * rng.standard_normal((ROWS, T))).astype(np.float32)
    # ties at the top-k threshold and a zero leaf row
    vec[0, 400:600] = 0.25
    vec[1, 100:137] = 0.0
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), ROWS))
    return vec, res, keys


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compress_flat_bitwise(name):
    kw = CONFIGS[name]
    vec, res, keys = _inputs()
    ro, rr = jax.vmap(lambda d, r, k: rc.compress_flat(
        rc.CompressionConfig(**kw), d, r, k, SEGMENTS))(
            jnp.asarray(vec), jnp.asarray(res), jnp.asarray(keys))
    to, tr_ = tc.compress_flat(tc.CompressionConfig(**kw),
                               torch.from_numpy(vec), torch.from_numpy(res),
                               keys, SEGMENTS)
    _same(to.numpy(), ro)
    _same(tr_.numpy(), rr)


@pytest.mark.parametrize("name", ["int8_stochastic", "topk5"])
def test_compress_flat_one_row_and_no_residual(name):
    """One device's (T,) row with a (2,) key, and no residual at all."""
    kw = CONFIGS[name]
    vec, res, keys = _inputs(1)
    cfg, tcfg = rc.CompressionConfig(**kw), tc.CompressionConfig(**kw)
    ro, rr = rc.compress_flat(cfg, jnp.asarray(vec[2]), jnp.asarray(res[2]),
                              jnp.asarray(keys[2]), SEGMENTS)
    to, tr_ = tc.compress_flat(tcfg, torch.from_numpy(vec[2]),
                               torch.from_numpy(res[2]), keys[2], SEGMENTS)
    _same(to.numpy(), ro)
    _same(tr_.numpy(), rr)
    ro, rr = rc.compress_flat(cfg, jnp.asarray(vec[2]), None,
                              jnp.asarray(keys[2]), SEGMENTS)
    to, tr_ = tc.compress_flat(tcfg, torch.from_numpy(vec[2]), None,
                               keys[2], SEGMENTS)
    _same(to.numpy(), ro)
    assert rr is None and tr_ is None


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.standard_normal((40, 30)).astype(np.float32),
                      "b": rng.standard_normal(30).astype(np.float32)},
            "conv": [rng.standard_normal((3, 3, 2, 4)).astype(np.float32)]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("with_residual", [True, False])
def test_compress_tree_bitwise(name, with_residual):
    kw = CONFIGS[name]
    tree, res = _tree(2), _tree(3) if with_residual else None
    key = jax.random.PRNGKey(8)
    ro, rr = rc.compress_tree(
        rc.CompressionConfig(**kw), jax.tree.map(jnp.asarray, tree),
        None if res is None else jax.tree.map(jnp.asarray, res), key)
    to, tr_ = tc.compress_tree(
        tc.CompressionConfig(**kw),
        jax.tree.map(torch.from_numpy, tree),
        None if res is None else jax.tree.map(torch.from_numpy, res),
        np.asarray(key))
    for a, b in zip(jax.tree.leaves(ro),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), to))):
        _same(b, a)
    if rr is None:
        assert tr_ is None
    else:
        for a, b in zip(jax.tree.leaves(rr), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), tr_))):
            _same(b, a)


def test_topk_keeps_largest_and_residual_holds_the_rest():
    cfg = tc.CompressionConfig(kind="topk", topk_frac=0.25)
    t = {"w": torch.tensor([1.0, -8.0, 0.1, 3.0, 0.2, -0.3, 6.0, 0.05])}
    sent, res = tc.compress_tree(cfg, t)
    w = sent["w"].numpy()
    assert (w != 0).sum() == 2 and w[1] == -8.0 and w[6] == 6.0
    np.testing.assert_array_equal(res["w"].numpy() + w, t["w"].numpy())


def test_compression_ratio_and_config_checks():
    for kw in ({"kind": "none"}, {"kind": "int8"},
               {"kind": "topk", "topk_frac": 0.05}):
        assert tc.compression_ratio(tc.CompressionConfig(**kw)) == \
            rc.compression_ratio(rc.CompressionConfig(**kw))
    assert tc.compression_ratio(tc.CompressionConfig("int8")) == 0.25
    assert ({f.name: f.default for f in
             dataclasses.fields(tc.CompressionConfig)}
            == {f.name: f.default for f in
                dataclasses.fields(rc.CompressionConfig)})
    for bad in ({"kind": "fp4"}, {"kind": "topk", "topk_frac": 0.0}):
        with pytest.raises(ValueError):
            tc.compress_flat(tc.CompressionConfig(**bad), torch.ones(4),
                             None, None, ((0, 4),))
