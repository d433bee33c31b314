"""Uplink compression for CE-FedAvg and the cold-row codecs of the
streaming client store (port of ``repro.core.compress``).

The uplink half (paper §2: quantization and sparsification) compresses
the model deltas devices upload at aggregation boundaries:

- ``topk``   magnitude sparsification with error feedback (the residual
             of what was not sent is added to the next upload);
- ``int8``   per-leaf affine quantization, stochastic rounding by
             default (``jax.random.uniform`` draws, bit for bit);
- ``none``   exact.

``compress_flat`` takes a batch of flat rows at once — the bank's (n, T)
deltas with one key per row, as the reference's ``jax.vmap`` of it over
devices — and works per FlatLayout segment, one batched pass a segment:
the top-k threshold of every row from one ``torch.topk``, the int8 scale
of every row from one absmax, the uniforms from one device draw
(:func:`repro_torch.random.uniform`). Values, residuals and the per-leaf
key order equal the reference's bit for bit.

The cold-row codecs below are host numpy, copied verbatim: the serial
streamed driver encodes and decodes with them at round boundaries, and
they are the oracle the device codec
(:mod:`repro_torch.kernels.cold_codec`) is held against byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree as tr


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | topk | int8
    topk_frac: float = 0.05     # fraction of entries kept (topk)
    stochastic: bool = True     # stochastic rounding (int8)
    error_feedback: bool = True  # residual accumulation

    def validate(self):
        if self.kind not in ("none", "topk", "int8"):
            raise ValueError(f"compression kind {self.kind!r}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac {self.topk_frac} outside (0, 1]")

    def bits_per_param(self) -> float:
        """Effective uplink bits per model parameter."""
        if self.kind == "none":
            return 32.0
        if self.kind == "int8":
            return 8.0
        # topk: 32-bit value + 32-bit index per kept entry
        return 64.0 * self.topk_frac


def _topk_leaf(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep each row's ``k = max(1, int(size * frac))`` largest |x| (every
    entry at or above the k-th largest, ties included) and zero the rest;
    x is (rows, size)."""
    k = max(1, int(x.shape[-1] * frac))
    a = x.abs()
    thresh = torch.topk(a, k, dim=-1, sorted=False).values.amin(
        dim=-1, keepdim=True)
    return x * (a >= thresh).to(x.dtype)


def _int8_leaf(x: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row affine int8 of (rows, size) ``x``, dequantized: one scale
    ``max|x| / 127`` a row; ``floor(x/scale + u)`` with uniforms ``u``
    (stochastic rounding), else round half to even."""
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True),
                            1e-12) / 127.0
    y = x / scale
    if u is not None:
        y = torch.floor(y.add_(u))
    else:
        y = torch.round(y)
    q = y.clamp_(-127, 127).to(torch.int8)
    return q.to(x.dtype) * scale


def _compress_rows(cfg: CompressionConfig, src: torch.Tensor,
                   key: Optional[np.ndarray]) -> torch.Tensor:
    """What one leaf's (rows, size) ``src`` sends; ``key`` is one key per
    row, (rows, 2), or None."""
    if cfg.kind == "topk":
        return _topk_leaf(src, cfg.topk_frac)
    u = (rnd.uniform(key, src.shape[-1:], src.device)
         if cfg.stochastic and key is not None else None)
    return _int8_leaf(src, u)


def compress_tree(cfg: CompressionConfig, tree: Any,
                  residual: Optional[Any] = None,
                  key: Optional[np.ndarray] = None
                  ) -> Tuple[Any, Optional[Any]]:
    """Returns (dequantized compressed tree, new error-feedback residual)
    for one device's update ``tree``; ``key`` is a (2,) host key, split
    once per leaf.

    The returned tree holds the values the receiver reconstructs, so it
    can be fed straight into the mixing operators; the compression loss
    is (tree + residual) - returned."""
    cfg.validate()
    if cfg.kind == "none":
        return tree, residual
    leaves, treedef = tr.tree_flatten(tree)
    res_leaves = (tr.tree_leaves(residual) if residual is not None
                  else [torch.zeros_like(leaf) for leaf in leaves])
    keys = (rnd.split(key, len(leaves)) if key is not None
            else [None] * len(leaves))
    out, new_res = [], []
    for leaf, res, k in zip(leaves, res_leaves, keys):
        src = leaf + res if cfg.error_feedback else leaf
        sent = _compress_rows(cfg, src.reshape(1, -1),
                              None if k is None else k[None])
        sent = sent.reshape(leaf.shape)
        out.append(sent)
        new_res.append(src - sent if cfg.error_feedback
                       else torch.zeros_like(leaf))
    return (tr.tree_unflatten(treedef, out),
            tr.tree_unflatten(treedef, new_res))


def compress_flat(cfg: CompressionConfig, vec: torch.Tensor,
                  residual: Optional[torch.Tensor],
                  key: Optional[np.ndarray],
                  segments: Tuple[Tuple[int, int], ...]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flat-domain :func:`compress_tree` for the ModelBank engine.

    ``vec``/``residual`` are flattened updates, one device's (T,) or a
    batch of rows (R, T) with one host key per row (``key`` (R, 2));
    ``segments`` are the per-leaf ``(offset, size)`` boundaries of the
    bank's FlatLayout, so top-k selection and int8 scales stay per leaf
    and each row's leaf keys are ``split(key, len(segments))``, as the
    reference's per-device ``compress_flat``."""
    cfg.validate()
    if cfg.kind == "none":
        return vec, residual
    rows = vec.reshape(-1, vec.shape[-1])
    res = None if residual is None else residual.reshape(rows.shape)
    keys = (None if key is None
            else rnd.split(np.asarray(key, np.uint32).reshape(-1, 2),
                           len(segments)))
    out = torch.empty_like(rows)
    new_res = None if res is None else torch.empty_like(rows)
    for j, (off, size) in enumerate(segments):
        src = rows[:, off:off + size]
        if cfg.error_feedback and res is not None:
            src = src + res[:, off:off + size]
        sent = _compress_rows(cfg, src, None if keys is None
                              else keys[:, j])
        out[:, off:off + size] = sent
        if new_res is not None:
            if cfg.error_feedback:
                torch.sub(src, sent, out=new_res[:, off:off + size])
            else:
                new_res[:, off:off + size] = 0.0
        del src, sent
    return (out.reshape(vec.shape),
            None if new_res is None else new_res.reshape(vec.shape))


def compression_ratio(cfg: CompressionConfig) -> float:
    """Payload ratio vs uncompressed f32 (for the runtime model)."""
    return cfg.bits_per_param() / 32.0


# ---------------------------------------------------------------------------
# cold-row codecs (streaming client store, core/clientstore.py)
# ---------------------------------------------------------------------------

#: codecs a paged-out client row may be stored under. ``f32`` is
#: lossless (the default — it keeps resident-vs-streamed parity and
#: bit-identical resume exact); ``f16``/``int8`` trade round-trip error
#: for 2x/4x smaller cold rows.
COLD_CODECS = ("f32", "f16", "int8")

_COLD_DTYPE = {"f32": np.float32, "f16": np.float16, "int8": np.int8}


def cold_bits_per_param(codec: str) -> int:
    """Stored bits per parameter of one cold row (excl. int8 scales)."""
    return {"f32": 32, "f16": 16, "int8": 8}[codec]


def cold_dtype(codec: str) -> np.dtype:
    """Storage dtype of the ``q`` array for ``codec``."""
    return np.dtype(_COLD_DTYPE[codec])


def encode_cold_rows(rows: np.ndarray, codec: str,
                     segments: Tuple[Tuple[int, int], ...]
                     ) -> Dict[str, np.ndarray]:
    """Batch-encode (S, T) float32 client-state rows for the cold store.

    Host-side numpy on purpose: cold rows live off-accelerator, and the
    encode runs at round *boundaries*, not in the jitted round. Returns
    ``{"q": (S, T) codec dtype, "scale": (S, nseg) float32}`` —
    ``scale`` has width 0 for the non-affine codecs, so the pair is a
    fixed-structure checkpoint payload for every codec.

    ``int8`` quantizes per FlatLayout segment (one affine scale per
    leaf per row, ``scale = max|seg| / 127`` — the ``_int8_leaf``
    discipline) with **deterministic** ``np.rint`` rounding, so the
    absolute round-trip error is bounded by ``scale / 2`` per entry and
    re-encoding a decoded row is a fixed point."""
    assert codec in COLD_CODECS, codec
    rows = np.asarray(rows, np.float32)
    assert rows.ndim == 2, rows.shape
    S = rows.shape[0]
    if codec == "f32":
        return {"q": rows.copy(), "scale": np.zeros((S, 0), np.float32)}
    if codec == "f16":
        return {"q": rows.astype(np.float16),
                "scale": np.zeros((S, 0), np.float32)}
    q = np.empty(rows.shape, np.int8)
    scale = np.empty((S, len(segments)), np.float32)
    for j, (off, size) in enumerate(segments):
        seg = rows[:, off:off + size]
        s = (np.maximum(np.abs(seg).max(axis=1), 1e-12)
             / 127.0).astype(np.float32)
        scale[:, j] = s
        q[:, off:off + size] = np.clip(
            np.rint(seg / s[:, None]), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def decode_cold_rows(enc: Dict[str, np.ndarray], codec: str,
                     segments: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """Decode :func:`encode_cold_rows` output back to (S, T) float32."""
    assert codec in COLD_CODECS, codec
    q = np.asarray(enc["q"])
    if codec in ("f32", "f16"):
        return q.astype(np.float32)
    scale = np.asarray(enc["scale"], np.float32)
    out = np.empty(q.shape, np.float32)
    for j, (off, size) in enumerate(segments):
        out[:, off:off + size] = (q[:, off:off + size].astype(np.float32)
                                  * scale[:, j][:, None])
    return out
