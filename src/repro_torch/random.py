"""JAX's counter-based key stream on the host, bit for bit.

The reference draws every minibatch with ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``, the jax 0.9 defaults). The port
draws the same batches by recomputing that stream in numpy ``uint32``
arithmetic: a key is a (2,) uint32 array, as JAX's raw key data.

- ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``;
- ``split(key, num)[i]`` and ``fold_in(key, i)`` are both the threefry
  hash of the counter pair ``(0, i)`` under ``key``;
- ``random_bits(key, shape)`` at flat index i is the xor of the two hash
  words of the counter ``(i >> 32, i & 0xFFFFFFFF)``;
- ``randint`` combines two such draws (from ``split(key)``) modulo the
  span, as ``jax.random.randint`` does.

``fold_in``, ``split``, ``random_bits`` and ``randint`` also take a
batch of keys, shaped (..., 2), and ``fold_in`` an array of data: one
vectorised call then gives what ``jax.vmap`` of the function gives, so
a round's per-client draws cost one numpy pass, not a Python loop.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block cipher of counters ``(x0, x1)``
    (uint32 arrays of one shape) under ``key`` (..., 2) uint32, whose
    leading axes broadcast against the counters'."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for g in range(5):
            for r in _ROTATIONS[g % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(g + 1) % 3]
            x[1] = x[1] + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.PRNGKey(seed)`` (a 32-bit seed)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0,
                     seed & 0xFFFFFFFF], np.uint32)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) uint32 words of a row-major uint64 iota over ``shape``."""
    iota = np.arange(int(np.prod(shape, dtype=np.int64)),
                     dtype=np.uint64).reshape(tuple(shape))
    return ((iota >> np.uint64(32)).astype(np.uint32),
            (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys; for keys
    (..., 2), (..., num, 2)."""
    key = np.asarray(key, np.uint32)
    hi, lo = _counters((num,))
    b0, b1 = threefry2x32(key[..., None, :], hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: a new (2,) uint32 key.

    ``data`` may be an integer array (ids, taken modulo 2**32 as JAX
    does); the key's leading axes broadcast against it, and the result
    is (broadcast shape..., 2) — ``jax.vmap(jax.random.fold_in)`` in
    one call."""
    words = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(np.uint32)
    b0, b1 = threefry2x32(key, np.zeros_like(words), words)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element, as ``jax.random.bits``; for keys
    (..., 2) the result is (..., *shape)."""
    key = np.asarray(key, np.uint32)
    hi, lo = _counters(shape)
    lead = key.shape[:-1]
    kk = key.reshape(lead + (1,) * len(tuple(shape)) + (2,))
    b0, b1 = threefry2x32(kk, hi, lo)
    return (b0 ^ b1).reshape(lead + tuple(shape))


def randint(key: np.ndarray, shape: Sequence[int], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32); for
    keys (..., 2) the result is (..., *shape), as under ``jax.vmap``."""
    ks = split(key)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(int(maxval) - int(minval), 1))
    # JAX's multiplier: (2**16 mod span) squared in wrapping uint32
    # arithmetic, then mod span
    mult = (1 << 16) % int(span)
    mult = np.uint32(((mult * mult) & 0xFFFFFFFF) % int(span))
    with np.errstate(over="ignore"):
        offset = (higher % span) * mult + (lower % span)
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)
