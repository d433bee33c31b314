"""The port's privacy substrates (``repro_torch.core.privacy``) against
``repro.core.privacy``.

Same numpy updates and keys in both packages. Clipping is f32 arithmetic
over a norm summed in another order (within 1e-6). The Gaussian draws
are jax's uniforms to the bit through XLA's erf_inv polynomial, within
two ulp (``tests/test_torch_random.py``), so the privatized updates and
the unit-scale secure-aggregation masks agree within 1e-6; the noise is
also checked by its distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as rp
from repro_torch.core import privacy as tp

ATOL = 1e-6


def _tree(seed, shape=(7, 3)):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(shape).astype(np.float32),
            "b": rng.standard_normal(shape[1]).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(port_tree, ref_tree, atol=ATOL):
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 port_tree)),
                    jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm(max_norm):
    t = _tree(1)
    _close(tp.clip_by_global_norm(_t(t), max_norm),
           rp.clip_by_global_norm(_j(t), max_norm))
    assert abs(float(tp.global_norm(_t(t)))
               - float(rp.global_norm(_j(t)))) <= ATOL
    assert float(tp.global_norm(tp.clip_by_global_norm(_t(t), 0.5))) \
        <= 0.5 + 1e-5


@pytest.mark.parametrize("nm", [0.0, 0.3, 1.0])
def test_privatize_update_tree(nm):
    t = _tree(2)
    key = jax.random.PRNGKey(9)
    _close(tp.privatize_update(_t(t), tp.DPConfig(1.0, nm), np.asarray(key)),
           rp.privatize_update(_j(t), rp.DPConfig(1.0, nm), key))


@pytest.mark.parametrize("nm", [0.0, 0.5])
@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_privatize_update_flat_rows(nm, scale):
    """Rows of a bank with one key each (the reference's ``jax.vmap``
    over devices), clipped (norms above and below the bound) and noised;
    a single (T,) row with a (2,) key too."""
    rng = np.random.default_rng(3)
    vec = (scale * rng.standard_normal((5, 3001))).astype(np.float32)
    vec[0] *= 1e-3
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), 5))
    dp, tdp = rp.DPConfig(1.0, nm), tp.DPConfig(1.0, nm)
    exp = jax.vmap(lambda d, k: rp.privatize_update_flat(d, dp, k))(
        jnp.asarray(vec), jnp.asarray(keys))
    got = tp.privatize_update_flat(torch.from_numpy(vec), tdp, keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL,
                               rtol=0)
    one = tp.privatize_update_flat(torch.from_numpy(vec[1]), tdp, keys[1])
    np.testing.assert_allclose(
        one.numpy(), np.asarray(rp.privatize_update_flat(
            jnp.asarray(vec[1]), dp, jnp.asarray(keys[1]))),
        atol=ATOL, rtol=0)


def test_privatize_flat_draws_in_column_chunks(monkeypatch):
    """A draw longer than one chunk is the same draw, tile by tile."""
    rng = np.random.default_rng(5)
    vec = torch.from_numpy(rng.standard_normal((3, 1000)).astype(np.float32))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(6), 3))
    dp = tp.DPConfig(1.0, 0.5)
    whole = tp.privatize_update_flat(vec, dp, keys)
    monkeypatch.setattr(tp, "_NOISE_COLUMNS", 64)
    assert torch.equal(tp.privatize_update_flat(vec, dp, keys), whole)


def test_noise_is_calibrated():
    """σ = noise_multiplier × clip_norm, zero mean, Gaussian tails."""
    dp = tp.DPConfig(clip_norm=1.0, noise_multiplier=1.0)
    noisy = tp.privatize_update({"w": torch.zeros(200_000)}, dp,
                                np.asarray(jax.random.PRNGKey(0)))["w"]
    x = noisy.numpy().astype(np.float64)
    assert abs(x.mean()) < 0.01 and 0.99 < x.std() < 1.01
    assert 0.04 < (np.abs(x) > 1.96).mean() < 0.06
    dp = tp.DPConfig(clip_norm=2.0, noise_multiplier=0.25)
    flat = tp.privatize_update_flat(torch.zeros(2, 100_000), dp,
                                    np.asarray(jax.random.split(
                                        jax.random.PRNGKey(1), 2)))
    assert 0.49 < float(flat.std()) < 0.51


def test_secure_agg_masks_equal_the_reference_and_cancel():
    """Each device's mask (at unit scale) equals the reference's; the
    masked cluster sum is the true sum, in both packages."""
    cluster = [0, 1, 2, 3]
    trees = [_tree(10 + i) for i in cluster]
    for dev in cluster:
        _close(tp.mask_update(_t(trees[dev]), dev, cluster, seed=5),
               rp.mask_update(_j(trees[dev]), dev, cluster, seed=5))
    true_sum = jax.tree.map(lambda *ls: sum(ls), *trees)
    sec = tp.masked_cluster_sum([_t(t) for t in trees], cluster, seed=5,
                                scale=10.0)
    _close(sec, true_sum, atol=1e-4)
    masked = tp.mask_update(_t(trees[0]), 0, [0, 1], seed=5, scale=10.0)
    assert float((masked["w"] - _t(trees[0])["w"]).abs().max()) > 1.0


def test_gaussian_epsilon_equal():
    for nm in (0.0, 0.3, 0.5, 1.0, 4.0):
        assert tp.gaussian_epsilon(nm) == rp.gaussian_epsilon(nm)
    assert tp.gaussian_epsilon(0.5, 1e-3) == rp.gaussian_epsilon(0.5, 1e-3)
    assert tp.DPConfig().enabled is False
