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
  span, as ``jax.random.randint`` does;
- ``uniform`` keeps the top 23 bits of a draw as the mantissa of a float
  in [1, 2) and subtracts 1, and ``normal`` is ``sqrt(2)·erf_inv(u)`` of
  a uniform ``u`` on [nextafter(-1, 0), 1), as ``jax.random`` does both.

``fold_in``, ``split``, ``random_bits`` and ``randint`` also take a
batch of keys, shaped (..., 2), and ``fold_in`` an array of data: one
vectorised call then gives what ``jax.vmap`` of the function gives, so
a round's per-client draws cost one numpy pass, not a Python loop.

The uplink draws are too many for the host (a full-width int8 upload
takes one uniform per bank entry, 4.2e8 of them): ``device_bits`` runs
the same cipher in torch int32 arithmetic on any device (wrapping adds,
logical right shifts by masking), bit for bit the numpy path, and
``uniform`` and ``normal`` build on it. Keys and their splits stay on
the host.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# the bits on a torch device, and the float draws built on them
# ---------------------------------------------------------------------------

def _i32(words: np.ndarray) -> np.ndarray:
    """uint32 words as the int32 values of the same bits."""
    return np.asarray(words, np.uint32).view(np.int32)


def _rotl_i32(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit left rotation of int32 ``x``, in place: the right shift is
    arithmetic on int32, so its sign-filled high bits are masked off."""
    hi = x << r
    x.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
    return x.bitwise_or_(hi)


def device_bits(key: np.ndarray, shape: Sequence[int],
                device: Union[str, torch.device], *, offset: int = 0
                ) -> torch.Tensor:
    """:func:`random_bits` as int32 on ``device`` (the same 32 bits per
    element, bit for bit): keys (..., 2) give (..., *shape). ``offset``
    starts the counters at flat index ``offset``, so a long draw can be
    taken in column chunks: ``device_bits(k, (c,), dev, offset=o)`` is
    columns ``o:o + c`` of ``device_bits(k, (o + c,), dev)``."""
    key = np.asarray(key, np.uint32)
    shape = tuple(int(s) for s in shape)
    count = int(np.prod(shape, dtype=np.int64))
    if offset < 0 or offset + count > 2**31:
        raise ValueError(f"device_bits takes counters below 2**31, not "
                         f"{offset}..{offset + count}")
    lead = key.shape[:-1]
    ks = torch.from_numpy(_i32(key).reshape(-1, 2).copy()).to(device)
    k0, k1 = ks[:, :1], ks[:, 1:]
    k2 = k0 ^ k1 ^ int(_i32(_PARITY))
    sched = (k0, k1, k2)
    # the counters' high words are 0, their low words the flat index
    x0 = k0.expand(ks.shape[0], count).clone()
    x1 = torch.arange(offset, offset + count, dtype=torch.int32,
                      device=device).expand(ks.shape[0], count) + k1
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0.add_(x1)
            _rotl_i32(x1, r).bitwise_xor_(x0)
        x0.add_(sched[(g + 1) % 3])
        x1.add_(sched[(g + 2) % 3] + (g + 1))
    return x0.bitwise_xor_(x1).reshape(lead + shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from int32 bits, in place: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1 (``jax.random.uniform``)."""
    bits.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF).bitwise_or_(
        0x3F800000)
    return bits.view(torch.float32).sub_(1.0)


def uniform(key: np.ndarray, shape: Sequence[int],
            device: Union[str, torch.device], *,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32 on [0, 1)) on ``device``,
    bit for bit; keys (..., 2) give (..., *shape), and ``offset`` as in
    :func:`device_bits`."""
    return _unit_floats(device_bits(key, shape, device, offset=offset))


#: XLA's f32 ``erf_inv`` (Giles' single-precision approximation): its
#: polynomial coefficients for w = -log1p(-x²) below 5 and from 5 up
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function, evaluated as XLA's ``ErfInv32``:
    w = -log1p(-x²); below 5 a degree-8 polynomial in w - 2.5, else in
    sqrt(w) - 3; times x, and ±inf at ±1."""
    w = torch.log1p(x * -x).neg_()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_ERF_INV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERF_INV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERF_INV_LT5)):
        p = torch.where(lt, lo[i], hi[i]).add_(p.mul_(w))
    p.mul_(x)
    return torch.where(x.abs() == 1.0, x * float("inf"), p)


#: ``normal``'s uniform range: [nextafter(-1, 0), 1), whose width rounds
#: to 2 in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1), np.float32(0)))
_NORMAL_SPAN = float(np.float32(1) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: np.ndarray, shape: Sequence[int],
           device: Union[str, torch.device], *,
           offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32) on ``device``: the same
    uniform draw, bit for bit, through :func:`erf_inv`; keys (..., 2)
    give (..., *shape), and ``offset`` as in :func:`device_bits`."""
    u = uniform(key, shape, device, offset=offset)
    u = u.mul_(_NORMAL_SPAN).add_(_NORMAL_LO).clamp_min_(_NORMAL_LO)
    return erf_inv(u).mul_(_SQRT2)
