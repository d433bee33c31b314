"""The port's host-side threefry stream is bit-exact to ``jax.random``
(jax 0.9 defaults: threefry2x32, partitionable): same keys, same splits,
same fold-ins, same ``randint`` draws — so the port trains on the
reference's batches."""
import jax
import numpy as np
import pytest

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
