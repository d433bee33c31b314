"""A frozen copy of the counter-based key stream that the FL program
draws its batches and its upload uniforms from (JAX's threefry2x32 with
``jax_threefry_partitionable=True``), written again for the benchmark's
reference so that a later change to the program cannot move it.

Keys are (2,) uint32 arrays, or (..., 2) batches of them, on the host.
``device_uniform`` computes the 32-bit draws on a torch device in int64
arithmetic masked to 32 bits: the same bits as the host cipher, by a
route of its own.
"""
from __future__ import annotations

import numpy as np
import torch

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
MASK = 0xFFFFFFFF


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 cipher of counters ``(x0, x1)`` under
    ``key`` (..., 2), in numpy uint32."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(PARITY))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for g in range(5):
            for r in ROTATIONS[g % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(g + 1) % 3]
            x[1] = x[1] + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    seed = int(seed)
    return np.array([(seed >> 32) & MASK, seed & MASK], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """(..., num, 2) keys: the cipher of counters (0, i)."""
    key = np.asarray(key, np.uint32)
    lo = np.arange(num, dtype=np.uint32)
    b0, b1 = threefry2x32(key[..., None, :], np.zeros_like(lo), lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    w = np.asarray(int(data) & MASK, np.uint32)
    b0, b1 = threefry2x32(key, np.zeros_like(w), w)
    return np.stack([b0, b1], axis=-1)


def bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits an element, (..., *shape) for keys (..., 2): the xor
    of the two words of counter (i >> 32, i & MASK) at flat index i."""
    key = np.asarray(key, np.uint32)
    count = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(count, dtype=np.uint64).reshape(tuple(shape))
    hi = (iota >> np.uint64(32)).astype(np.uint32)
    lo = (iota & np.uint64(MASK)).astype(np.uint32)
    kk = key.reshape(key.shape[:-1] + (1,) * len(tuple(shape)) + (2,))
    b0, b1 = threefry2x32(kk, hi, lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + tuple(shape))


def randint(key: np.ndarray, shape, lo: int, hi: int) -> np.ndarray:
    """Integers in [lo, hi): two draws combined modulo the span, as
    ``jax.random.randint``."""
    ks = split(key)
    higher = bits(ks[..., 0, :], shape).astype(np.uint64)
    lower = bits(ks[..., 1, :], shape).astype(np.uint64)
    span = max(int(hi) - int(lo), 1)
    mult = ((1 << 16) % span) ** 2 % (1 << 32) % span
    off = (((higher % span) * mult) % (1 << 32) + lower % span) % (1 << 32)
    return (int(lo) + (off % span).astype(np.int64)).astype(np.int64)


def device_uniform(keys: np.ndarray, count: int,
                   device: torch.device) -> torch.Tensor:
    """(rows, count) f32 uniforms on [0, 1), one row a key (``keys`` is
    (rows, 2)): the top 23 bits of each draw as a mantissa in [1, 2),
    minus 1. The cipher runs in int64 masked to 32 bits."""
    ks = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)
                          ).to(device)
    k0, k1 = ks[:, :1], ks[:, 1:]
    sched = (k0, k1, k0 ^ k1 ^ PARITY)
    ctr = torch.arange(count, dtype=torch.int64, device=device)[None]
    x0 = k0.expand(-1, count).clone()
    x1 = (ctr + k1) & MASK
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + sched[(g + 1) % 3]) & MASK
        x1 = (x1 + sched[(g + 2) % 3] + (g + 1)) & MASK
    word = x0 ^ x1
    mant = (word >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0
