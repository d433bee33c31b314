"""The streamed cold-row codec on the card: encode the slab's momentum for
the cold client store, decode staged rows back into the slab.

The streaming client store (``core/clientstore.py``) keeps paged-out
rows under a cold codec (f32, f16 or int8) whose host numpy version is
``core.compress.encode_cold_rows`` / ``decode_cold_rows``. The pipelined
streamed round runs the codec on the card instead: page-in decodes the
staged encoded rows into the slab, page-out encodes the slab before the
device-to-host copy, so the link carries codec-width bytes. The codec is
the same per-FlatLayout-segment affine scheme, byte for byte: one
``scale = max(|seg|, 1e-12) / 127`` per (row, segment), round half to
even, clip to ±127; f16 is the IEEE cast and f32 the identity.

One hand-written Hopper kernel source, ``csrc/cold_codec.cu`` (built for
``sm_90a``), replaces the Pallas TPU kernels of
``repro.kernels.cold_codec`` (``_segment_absmax`` and ``_elementwise``):
each direction is one launch over all segments (two for the int8
encode: absmax, then quantize), driven by a table of column tiles that
never cross a segment boundary (:func:`tile_table`).

On a CPU tensor each wrapper takes its plain version
(:mod:`repro_torch.kernels.ref`). On a CUDA tensor it launches the
kernel or raises; nothing falls back. ``encode_launches`` and
``decode_launches`` count kernel launches (not plain-version calls, and
not the f32 identity, which launches nothing).

A row holding a NaN gets a NaN scale for that segment, as in numpy;
its q bytes are unspecified there (numpy's NaN-to-int8 cast is too).
Finite rows are byte-identical.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: codecs a cold row may be stored under (``core.compress.COLD_CODECS``)
CODECS = ("f32", "f16", "int8")
#: columns of one tile of the tiled passes (one CUDA block each)
TILE = 4096

#: kernel launches of the encode direction (two per int8 encode, one per
#: f16 encode) and of the decode direction (one per int8 or f16 decode)
encode_launches = 0
decode_launches = 0

_CODEC_DTYPE = {"f32": torch.float32, "f16": torch.float16,
                "int8": torch.int8}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = _build.load("cold_codec")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cold_encode_int8_launch.argtypes = [p, ll, ll, p, ll, i, p, p, p, p]
    lib.cold_decode_int8_launch.argtypes = [p, p, ll, ll, p, ll, i, p, p]
    lib.cold_cast_launch.argtypes = [p, p, ll, i, p]
    for fn in (lib.cold_encode_int8_launch, lib.cold_decode_int8_launch,
               lib.cold_cast_launch):
        fn.restype = ctypes.c_int
    return lib


def tile_table(segments: Sequence[Tuple[int, int]],
               tile: int = TILE) -> np.ndarray:
    """The (ntiles, 2) int64 tile table of the tiled passes: each
    segment cut into runs of at most ``tile`` columns. Column 0 is the
    start column; column 1 packs the length (bits 0-30), a flag marking
    the first tile of its segment (bit 31) and the segment index (bits
    32-63), as ``csrc/cold_codec.cu`` reads it."""
    out = []
    for j, (off, size) in enumerate(segments):
        for start in range(off, off + size, tile):
            n = min(tile, off + size - start)
            first = (1 << 31) if start == off else 0
            out.append((start, n | first | (j << 32)))
    return np.asarray(out, np.int64).reshape(-1, 2)


@functools.lru_cache(maxsize=64)
def _device_tiles(segments: Tuple[Tuple[int, int], ...],
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tile_table(segments)).to(device)


def _check(x: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"cold_codec: no kernel for device {x.device}")
    if x.dtype != dtype or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"cold_codec kernel needs a contiguous 2-D {dtype} "
                         f"{what}, got {x.dtype} {tuple(x.shape)}")


def _run(fn, *args, what: str) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"cold_codec {what} launch failed: CUDA error "
                           f"{rc}")


def _segments(segments, total: int) -> Tuple[Tuple[int, int], ...]:
    segs = tuple((int(o), int(s)) for o, s in segments)
    if sum(s for _, s in segs) != total:
        raise ValueError(f"segments {segs} do not cover {total} columns")
    return segs


def encode_rows(rows: torch.Tensor, codec: str, segments
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode (S, T) f32 rows for the cold store.

    Returns ``(q, scale)``: ``q`` is (S, T) in the codec's dtype,
    ``scale`` the (S, nseg) f32 per-segment scales (width 0 for f32 and
    f16) — the pair ``core.compress.encode_cold_rows`` returns, byte for
    byte. For f32, ``q`` is ``rows`` itself."""
    global encode_launches
    if codec not in CODECS:
        raise ValueError(f"unknown cold codec {codec!r}")
    if rows.device.type == "cpu" or codec == "f32":
        return _ref.cold_encode_ref(rows, codec, segments)
    segs = _segments(segments, rows.shape[-1])
    _check(rows, "rows", torch.float32)
    S, T = rows.shape
    lib = _library()
    q = torch.empty((S, T), dtype=_CODEC_DTYPE[codec], device=rows.device)
    if codec == "f16":
        _run(lib.cold_cast_launch, rows, q, S * T, 1, what="f16 encode")
        encode_launches += 1
        return q, torch.zeros((S, 0), dtype=torch.float32,
                              device=rows.device)
    tiles = _device_tiles(segs, rows.device)
    amax = torch.empty((S, len(segs)), dtype=torch.int32, device=rows.device)
    scale = torch.empty((S, len(segs)), dtype=torch.float32,
                        device=rows.device)
    _run(lib.cold_encode_int8_launch, rows, S, T, tiles, tiles.shape[0],
         len(segs), amax, q, scale, what="int8 encode")
    encode_launches += 2
    return q, scale


def decode_rows(q: torch.Tensor, scale: torch.Tensor, codec: str,
                segments) -> torch.Tensor:
    """Decode :func:`encode_rows` output back to (S, T) f32 (exact for
    f32, where ``q`` itself is returned; the dequantized view for f16 and
    int8). A zero ``q`` row with zero scales decodes to exact zeros — a
    never-stored client's momentum."""
    global decode_launches
    if codec not in CODECS:
        raise ValueError(f"unknown cold codec {codec!r}")
    if q.device.type == "cpu" or codec == "f32":
        return _ref.cold_decode_ref(q, scale, codec, segments)
    segs = _segments(segments, q.shape[-1])
    _check(q, "q", _CODEC_DTYPE[codec])
    S, T = q.shape
    lib = _library()
    out = torch.empty((S, T), dtype=torch.float32, device=q.device)
    if codec == "f16":
        _run(lib.cold_cast_launch, q, out, S * T, 0, what="f16 decode")
    else:
        _check(scale, "scale", torch.float32)
        if tuple(scale.shape) != (S, len(segs)):
            raise ValueError(f"scale {tuple(scale.shape)} does not match "
                             f"{S} rows of {len(segs)} segments")
        tiles = _device_tiles(segs, q.device)
        _run(lib.cold_decode_int8_launch, q, scale, S, T, tiles,
             tiles.shape[0], len(segs), out, what="int8 decode")
    decode_launches += 1
    return out
