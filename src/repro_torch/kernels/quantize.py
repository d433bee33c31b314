"""Blocked int8 affine quantization of a flat vector (port of
``repro.kernels.quantize``).

For x (T,) f32 cut into blocks of ``block`` elements (the last one
zero-padded), each block gets ``scale = max(absmax, 1e-12) / 127`` and
its codes ``clip(round_half_even(x / scale), -127, 127)`` as int8. The
Pallas TPU kernel ``quantize_int8_blocked`` (``_kernel``) is ported as
a Hopper kernel of its own, ``csrc/quantize.cu`` (built for
``sm_90a``): one launch that reads each element once and writes its
code, one warp a block of at most :data:`WARP_BLOCK` elements (a CTA a
larger one), the short last block masked in the kernel. The wrapper
allocates exactly the codes (T,) and the scales (ceil(T/block),): no
pad copy, no memset, no slicing copy (an input that is not a contiguous
f32 vector is first converted on the card, as the plain version
converts). :func:`quantize_plan` picks the kernel's vector path (float4
loads, 4 codes a store) where the pointers and the block size allow it,
its scalar path elsewhere.

On a CPU tensor the wrapper takes its plain version
(:func:`quantize_int8_ref`, the cold codec's plain int8 encode over the
(T/block, block) rows); on a CUDA tensor it launches the kernel or
raises. ``launches`` counts calls that launched the kernel. No runtime
path of the reference calls this (only its tests do); it is ported so
that every TPU kernel has its Hopper twin.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: calls that launched the kernel (CPU calls do not count)
launches = 0
#: the largest block one warp takes (``kWarpBlock`` in
#: ``csrc/quantize.cu``); a larger block takes a CTA of 1024 threads
WARP_BLOCK = 1024


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("quantize")
    p = ctypes.c_void_p
    lib.quantize_int8_blocked_launch.argtypes = [
        p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p, p, p]
    lib.quantize_int8_blocked_launch.restype = ctypes.c_int
    return lib


def quantize_plan(x_addr: int, q_addr: int, block: int) -> Tuple[bool, bool]:
    """``(vector, per_warp)`` for x at byte address ``x_addr`` and the
    codes at ``q_addr``: the vector path (each block a run of float4
    words, its codes 4 to a store, the last block's cut word element by
    element) needs x 16-byte aligned, q 4-byte aligned and ``block % 4 ==
    0``, so that every block starts on a word; the scalar path takes one
    element a load and one code a store. A block of at most
    :data:`WARP_BLOCK` elements goes to one warp, a larger one to a
    CTA."""
    vector = x_addr % 16 == 0 and q_addr % 4 == 0 and block % 4 == 0
    return vector, block <= WARP_BLOCK


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x (T,) zero-padded to (nb, block) rows."""
    T = x.shape[0]
    nb = -(-T // block)
    pad = nb * block - T
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(nb, block)


def quantize_int8_blocked(x: torch.Tensor, *, block: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T,) f32 -> (codes (T,) int8, scales (ceil(T/block),) f32)."""
    global launches
    if x.ndim != 1:
        raise ValueError(f"quantize_int8_blocked takes a flat vector, got "
                         f"{tuple(x.shape)}")
    if block < 1:
        raise ValueError(f"quantize_int8_blocked: block {block} < 1")
    if x.device.type == "cpu":
        return quantize_int8_ref(x, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: no kernel for device {x.device}")
    # the kernel reads a contiguous f32 vector: another dtype or a strided
    # view is converted on the card first (a copy only where needed), as
    # the plain version converts
    x = x.to(torch.float32).contiguous()
    T = x.shape[0]
    codes = torch.empty(T, dtype=torch.int8, device=x.device)
    scales = torch.empty(-(-T // block), dtype=torch.float32,
                         device=x.device)
    if T == 0:
        return codes, scales
    vector, _ = quantize_plan(x.data_ptr(), codes.data_ptr(), block)
    with torch.cuda.device(x.device):
        rc = _library().quantize_int8_blocked_launch(
            x.data_ptr(), T, block, int(vector), codes.data_ptr(),
            scales.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_int8_blocked launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return codes, scales


def dequantize_int8_blocked(q: torch.Tensor, scales: torch.Tensor, *,
                            block: int = 1024) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_blocked` back to (T,) f32."""
    T = q.shape[0]
    nb = scales.shape[0]
    pad = nb * block - T
    qp = torch.cat([q, q.new_zeros(pad)]) if pad else q
    out = qp.reshape(nb, block).to(torch.float32) * scales[:, None]
    return out.reshape(-1)[:T]


def quantize_int8_ref(x: torch.Tensor, *, block: int = 1024
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quantize_int8_blocked` (on any device)."""
    T = x.shape[0]
    q, s = _ref.cold_encode_ref(
        _blocks(x.to(torch.float32), block), "int8", ((0, block),))
    return q.reshape(-1)[:T], s[:, 0]
