"""Vectorised key draws of the port's threefry stream against
``jax.vmap`` of ``jax.random``: ``fold_in`` over an array of ids (the
streamed round's per-client keys, ids past 2**16 included) and
``randint`` over a batch of keys, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import random as rnd

IDS = np.concatenate([np.arange(10_001),
                      [2**16 - 1, 2**16, 2**16 + 1, 2**20 + 3, 99_999,
                       2**31 - 1]]).astype(np.int32)


@pytest.mark.parametrize("seed", (0, 5, 2**31 - 1))
def test_fold_in_over_ids_matches_vmap(seed):
    exp = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(seed), jnp.asarray(IDS))
    got = rnd.fold_in(rnd.PRNGKey(seed), IDS)
    assert got.shape == (IDS.size, 2) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(exp))
    # one id through the array path is the scalar fold_in
    np.testing.assert_array_equal(got[70_000 % IDS.size],
                                  rnd.fold_in(rnd.PRNGKey(seed),
                                              int(IDS[70_000 % IDS.size])))


@pytest.mark.parametrize("shape,hi", [((16,), 64), ((3, 5), 1000),
                                      ((1,), 7)])
def test_randint_over_key_batch_matches_vmap(shape, hi):
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(9), 11))
    exp = jax.vmap(lambda k: jax.random.randint(k, shape, 0, hi))(keys)
    got = rnd.randint(keys, shape, 0, hi)
    np.testing.assert_array_equal(got, np.asarray(exp))
    np.testing.assert_array_equal(
        rnd.split(keys, 3), np.asarray(jax.vmap(
            lambda k: jax.random.split(k, 3))(keys)))


def test_streamed_round_draw_matches_reference_schedule():
    """The per-client draw of a streamed round: every local step's key
    folded with every trainer's client id, then ``randint`` of one batch
    — (steps, lanes, batch) in one call, as the reference's
    ``vmap(randint(fold_in(step_key, id)))`` inside its step scan."""
    steps = np.asarray(jax.random.split(jax.random.PRNGKey(3), 16))
    cids = IDS[[0, 7, 65_536 % IDS.size, -1, -2, -3]]
    exp = jax.vmap(lambda s: jax.vmap(lambda i: jax.random.randint(
        jax.random.fold_in(s, i), (16,), 0, 64))(jnp.asarray(cids)))(steps)
    got = rnd.randint(rnd.fold_in(steps[:, None, :], cids), (16,), 0, 64)
    assert got.shape == (16, cids.size, 16)
    np.testing.assert_array_equal(got, np.asarray(exp))
