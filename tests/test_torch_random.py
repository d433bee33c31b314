"""The port's host-side threefry stream is bit-exact to ``jax.random``
(jax 0.9 defaults: threefry2x32, partitionable): same keys, same splits,
same fold-ins, same ``randint`` draws — so the port trains on the
reference's batches."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import random as rnd

SEEDS = (0, 1, 2, 17, 123456, 2**31 - 1)


def _jk(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches(seed):
    np.testing.assert_array_equal(rnd.PRNGKey(seed),
                                  np.asarray(_jk(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (1, 2, 3, 8, 33))
def test_split_matches(seed, num):
    got = rnd.split(rnd.PRNGKey(seed), num)
    np.testing.assert_array_equal(got,
                                  np.asarray(jax.random.split(_jk(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", (0, 1, 7, 2**32 - 1))
def test_fold_in_matches(seed, data):
    got = rnd.fold_in(rnd.PRNGKey(seed), data)
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.fold_in(_jk(seed), data)))


def test_chained_key_schedule_matches():
    """The simulator's schedule: a round key split per round, per block
    and per local step, as ``FLSimulator`` does it."""
    kj, kp = jax.random.PRNGKey(1), rnd.PRNGKey(1)
    for _ in range(3):
        kj, rj = jax.random.split(kj)
        sp = rnd.split(kp)
        kp, rp = sp[0], sp[1]
        for bj, bp in zip(jax.random.split(rj, 4), rnd.split(rp, 4)):
            for sj, sp_ in zip(jax.random.split(bj, 2), rnd.split(bp, 2)):
                np.testing.assert_array_equal(
                    rnd.randint(sp_, (16, 16), 0, 64),
                    np.asarray(jax.random.randint(sj, (16, 16), 0, 64)))
    np.testing.assert_array_equal(kp, np.asarray(kj))


@pytest.mark.parametrize("seed", (0, 5, 99))
@pytest.mark.parametrize("shape,lo,hi", [
    ((64, 16), 0, 64), ((16, 16), 0, 64), ((4, 3), 0, 1000),
    ((7,), -5, 12), ((2, 3, 5), 0, 7), ((1,), 0, 1), ((3,), 4, 4),
    ((8, 50), 0, 2**31 - 1)])
def test_randint_matches(seed, shape, lo, hi):
    got = rnd.randint(rnd.PRNGKey(seed), shape, lo, hi)
    exp = np.asarray(jax.random.randint(_jk(seed), shape, lo, hi))
    assert got.dtype == exp.dtype == np.int32
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("shape", ((5,), (3, 4), (2, 2, 3)))
def test_random_bits_match(shape):
    got = rnd.random_bits(rnd.PRNGKey(3), shape)
    exp = np.asarray(jax.random.bits(_jk(3), shape, dtype=np.uint32))
    np.testing.assert_array_equal(got, exp)


# ---------------------------------------------------------------------------
# the device path of the bits, and the float draws on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ((5,), (3, 4), (2, 2, 3), (1000,)))
def test_device_bits_equal_the_numpy_path(shape):
    for seed in (0, 3, 2**31 - 1):
        got = rnd.device_bits(rnd.PRNGKey(seed), shape, "cpu")
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      rnd.random_bits(rnd.PRNGKey(seed),
                                                      shape))


def test_device_bits_batched_keys_and_column_chunks():
    """Keys (..., 2) draw one row each; ``offset`` continues a row's
    counters, so column chunks tile the whole draw."""
    keys = rnd.split(rnd.PRNGKey(7), 6).reshape(2, 3, 2)
    whole = rnd.random_bits(keys, (301,))
    got = rnd.device_bits(keys, (301,), "cpu")
    assert tuple(got.shape) == (2, 3, 301)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), whole)
    parts = [rnd.device_bits(keys, (c1 - c0,), "cpu", offset=c0)
             for c0, c1 in ((0, 100), (100, 101), (101, 301))]
    np.testing.assert_array_equal(
        torch.cat(parts, -1).numpy().view(np.uint32), whole)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        rnd.device_bits(rnd.PRNGKey(0), (4,), "cpu", offset=2**31 - 2)


@pytest.mark.parametrize("seed", (0, 5, 99))
@pytest.mark.parametrize("shape", ((7,), (16, 16), (3, 1000)))
def test_uniform_matches_bitwise(seed, shape):
    got = rnd.uniform(rnd.PRNGKey(seed), shape, "cpu").numpy()
    exp = np.asarray(jax.random.uniform(_jk(seed), shape))
    assert got.dtype == exp.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_uniform_batched_keys_match_vmap_bitwise():
    """One key a row: ``jax.vmap`` of the draw over split keys."""
    keys = jax.random.split(_jk(11), 9)
    exp = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (513,)))(
        keys))
    got = rnd.uniform(np.asarray(keys), (513,), "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))


@pytest.mark.parametrize("seed", (0, 3, 123))
def test_normal_within_two_ulp_of_jax(seed):
    """``normal`` feeds the same uniforms (bit for bit) through XLA's f32
    erf_inv polynomial; log1p and the polynomial's rounding differ from
    XLA's CPU code by an ulp here and there. Over 2e5 draws the largest
    gap seen is 7.2e-7 absolute (2.4e-7 relative, two ulp); the test
    holds 1e-6 absolute and 3e-7 relative."""
    got = rnd.normal(rnd.PRNGKey(seed), (200_000,), "cpu").numpy()
    exp = np.asarray(jax.random.normal(_jk(seed), (200_000,)))
    diff = np.abs(got - exp)
    assert diff.max() <= 1e-6
    assert (diff / np.maximum(np.abs(exp), 1e-30)).max() <= 3e-7
    keys = jax.random.split(_jk(seed), 4)
    exp = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (999,)))(keys))
    got = rnd.normal(np.asarray(keys), (999,), "cpu").numpy()
    assert np.abs(got - exp).max() <= 1e-6


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999, 0.99999994])
    got = rnd.erf_inv(x)
    assert got[0] == -float("inf") and got[1] == float("inf")
    exp = np.asarray(jax.scipy.special.erfinv(x.numpy()))
    np.testing.assert_allclose(got[2:].numpy(), exp[2:], rtol=3e-7)
