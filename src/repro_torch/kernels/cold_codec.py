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
each direction is one launch over all segments. The int8 encode reads
each element once: it runs the tasks of :func:`encode_plan` (runs of
whole segments, or slices of a larger segment held on chip by as many
blocks at once) and needs 16-byte aligned rows. The int8 decode is
driven by a table of column tiles that never cross a segment boundary
(:func:`tile_table`). The f16 casts are one streaming pass over the
array each way, a float4 on the f32 side and 4 halves (or, where the
pointers do not line up, one) on the f16 side an access, with a scalar
head and tail that :func:`cast_plan` sizes for the two pointers'
alignments.

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
#: f32 columns of one int8-encode task: one block's shared memory
#: (``kSlice`` in ``csrc/cold_codec.cu``); a larger segment is sliced
SLICE = 57_344
#: whole segments one int8-encode task may hold (``kMaxUnits``)
MAX_UNITS = 128
#: int8-encode task kinds: the slice stays on chip between its max and
#: its codes; the max only; the codes only, read again from memory
RESIDENT, MAX_ONLY, CODES_ONLY = 0, 1, 2

#: kernel launches of the encode direction (one per int8 or f16 encode)
#: and of the decode direction (one per int8 or f16 decode)
encode_launches = 0
decode_launches = 0

_CODEC_DTYPE = {"f32": torch.float32, "f16": torch.float16,
                "int8": torch.int8}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    lib = _build.load("cold_codec")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cold_encode_int8_grid.argtypes = []
    lib.cold_encode_int8_launch.argtypes = [p, p, ll, p, p, i, i, p, p, p]
    lib.cold_decode_int8_launch.argtypes = [p, p, ll, ll, p, ll, i, p, p]
    lib.cold_cast_launch.argtypes = [p, p, ll, i, i, ll, p]
    for fn in (lib.cold_encode_int8_grid, lib.cold_encode_int8_launch,
               lib.cold_decode_int8_launch, lib.cold_cast_launch):
        fn.restype = ctypes.c_int
    return lib


def tile_table(segments: Sequence[Tuple[int, int]],
               tile: int = TILE) -> np.ndarray:
    """The (ntiles, 2) int64 tile table of the tiled passes (decode):
    each segment cut into runs of at most ``tile`` columns. Column 0 is
    the start column; column 1 packs the length (bits 0-31) and the
    segment index (bits 32-63), as ``csrc/cold_codec.cu`` reads it."""
    out = []
    for j, (off, size) in enumerate(segments):
        for start in range(off, off + size, tile):
            n = min(tile, off + size - start)
            out.append((start, n | (j << 32)))
    return np.asarray(out, np.int64).reshape(-1, 2)


def encode_plan(segments: Sequence[Tuple[int, int]], rows: int,
                max_group: int):
    """The int8 encode's tasks over ``rows`` rows of ``segments``, in
    the order the kernel's blocks take them.

    Every (row, segment) is a unit. Consecutive units of at most
    ``SLICE`` columns are packed into one task of at most ``SLICE``
    columns and ``MAX_UNITS`` units (they are adjacent in memory, across
    rows too). A larger unit is cut into ``m = ceil(size / SLICE)``
    slices of near-equal length, one group: if ``m <= max_group`` (the
    blocks of the kernel's grid) they are ``m`` RESIDENT tasks, else
    ``m`` MAX_ONLY tasks followed by ``m`` CODES_ONLY ones.

    Returns ``(tasks, units, ngroups, largest)``: ``tasks`` (ntasks, 4)
    int64 rows ``[e0, n | nunits << 32, u0 | kind << 32, gslot | gsize
    << 32]`` (first element ``row * T + column``, length, units held
    (1 for a slice), first unit, kind, group slot, slices in the group,
    1 for whole units); ``units`` (nunits, 2) int64 rows ``[e, size |
    (row * nseg + segment) << 32]``; the number of groups; the largest
    RESIDENT group (1 if none)."""
    segs = [(int(o), int(n)) for o, n in segments]
    T = sum(n for _, n in segs)
    units, tasks, pack = [], [], []
    pack_n = ngroups = 0
    largest = 1

    def flush():
        nonlocal pack, pack_n
        if pack:
            tasks.append((units[pack[0]][0], pack_n, len(pack), pack[0],
                          RESIDENT, 0, 1))
        pack, pack_n = [], 0

    for r in range(rows):
        for j, (off, size) in enumerate(segs):
            e = r * T + off
            u = len(units)
            units.append((e, size, r * len(segs) + j))
            if size <= SLICE:
                if pack_n + size > SLICE or len(pack) == MAX_UNITS:
                    flush()
                pack.append(u)
                pack_n += size
                continue
            flush()
            m = -(-size // SLICE)
            cut = [e + size * i // m for i in range(m + 1)]
            kinds = (RESIDENT,) if m <= max_group else (MAX_ONLY, CODES_ONLY)
            for kind in kinds:
                tasks += [(cut[i], cut[i + 1] - cut[i], 1, u, kind, ngroups,
                           m) for i in range(m)]
            if m <= max_group:
                largest = max(largest, m)
            ngroups += 1
    flush()
    t = np.asarray(tasks, np.int64).reshape(-1, 7)
    packed = np.stack([t[:, 0], t[:, 1] | (t[:, 2] << 32),
                       t[:, 3] | (t[:, 4] << 32), t[:, 5] | (t[:, 6] << 32)],
                      axis=1)
    un = np.asarray(units, np.int64).reshape(-1, 3)
    return (packed, np.stack([un[:, 0], un[:, 1] | (un[:, 2] << 32)],
                             axis=1), ngroups, largest)


def cast_plan(f32_addr: int, f16_addr: int, n: int) -> Tuple[int, int]:
    """The f16 casts' access plan for n elements between an f32 array at
    byte address ``f32_addr`` and an f16 array at ``f16_addr``: returns
    ``(halves, head)``. Elements ``[0, head)`` go one at a time; from
    ``head`` on, groups of 4 elements move the f32 side a float4 (16
    bytes, aligned) and the f16 side ``halves`` halves (``2 * halves``
    bytes, aligned) an access; the elements after the last whole group
    go one at a time. ``halves`` is 4 where the two element residues mod
    4 agree, else 1, as ``cold_cast_launch`` takes it."""
    if f32_addr % 4 or f16_addr % 2:
        raise ValueError(f"cold_codec cast: f32 at {f32_addr} or f16 at "
                         f"{f16_addr} is not element-aligned")
    r32, r16 = f32_addr // 4 % 4, f16_addr // 2 % 4
    return 4 if r32 == r16 else 1, min(-r32 % 4, n)


@functools.lru_cache(maxsize=64)
def _device_plan(segments: Tuple[Tuple[int, int], ...], rows: int,
                 device: torch.device):
    """:func:`encode_plan` on the card, for the kernel's grid there."""
    with torch.cuda.device(device):
        grid = _library().cold_encode_int8_grid()
    if grid < 1:
        raise RuntimeError("cold_codec: the int8 encode kernel cannot be "
                           "resident on this card")
    tasks, units, ngroups, largest = encode_plan(segments, rows, grid)
    return (torch.from_numpy(tasks).to(device),
            torch.from_numpy(units).to(device), ngroups, largest)


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


def _cast(x: torch.Tensor, out: torch.Tensor, to_half: bool) -> None:
    """One launch of the f16 cast from ``x`` into ``out`` (f32 to f16
    when ``to_half``, else back)."""
    f32, f16 = (x, out) if to_half else (out, x)
    halves, head = cast_plan(f32.data_ptr(), f16.data_ptr(), x.numel())
    _run(_library().cold_cast_launch, x, out, x.numel(), int(to_half),
         halves, head, what=f"f16 {'encode' if to_half else 'decode'}")


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
    q = torch.empty((S, T), dtype=_CODEC_DTYPE[codec], device=rows.device)
    if codec == "f16":
        _cast(rows, q, to_half=True)
        encode_launches += 1
        return q, torch.zeros((S, 0), dtype=torch.float32,
                              device=rows.device)
    if rows.data_ptr() % 16:
        raise ValueError("cold_codec int8 encode kernel needs 16-byte "
                         "aligned rows")
    tasks, units, ngroups, largest = _device_plan(segs, S, rows.device)
    scratch = torch.empty(2 * ngroups + 1, dtype=torch.int32,
                          device=rows.device)
    scale = torch.empty((S, len(segs)), dtype=torch.float32,
                        device=rows.device)
    _run(_library().cold_encode_int8_launch, rows, tasks, tasks.shape[0],
         units, scratch, ngroups, largest, q, scale, what="int8 encode")
    encode_launches += 1
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
    out = torch.empty((S, T), dtype=torch.float32, device=q.device)
    if codec == "f16":
        _cast(q, out, to_half=False)
    else:
        _check(scale, "scale", torch.float32)
        if tuple(scale.shape) != (S, len(segs)):
            raise ValueError(f"scale {tuple(scale.shape)} does not match "
                             f"{S} rows of {len(segs)} segments")
        tiles = _device_tiles(segs, q.device)
        _run(_library().cold_decode_int8_launch, q, scale, S, T, tiles,
             tiles.shape[0], len(segs), out, what="int8 decode")
    decode_launches += 1
    return out
