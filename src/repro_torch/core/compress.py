"""Cold-row codecs of the streaming client store (port of the cold-codec
section of ``repro.core.compress``; the uplink ``compress_flat`` waits
for its slice).

Host numpy, copied verbatim: the serial streamed driver encodes and
decodes with these at round boundaries, and they are the oracle the
device codec (:mod:`repro_torch.kernels.cold_codec`) is held against
byte for byte.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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
