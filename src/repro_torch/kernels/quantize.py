"""Blocked int8 affine quantization of a flat vector (port of
``repro.kernels.quantize``).

Quantizing a flat (T,) vector per 1024-element block is the cold codec's
int8 encode over the rows of a (T/1024, 1024) single-segment layout: the
per-row scale is the per-block scale (``tests/test_kernels.py`` pins the
identity in the reference). So the Pallas TPU kernel
``quantize_int8_blocked`` (``_kernel``) is ported onto the cold codec's
Hopper kernel (``csrc/cold_codec.cu``) rather than as a kernel of its
own. The tail is zero-padded to a whole block, as the reference does.

On a CPU tensor the wrapper takes its plain version (the codec's); on a
CUDA tensor it launches the kernel or raises. ``launches`` counts calls
that launched the kernel. No runtime path of the reference calls this
(only its tests do); it is ported so that every TPU kernel has its
Hopper twin.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cold_codec
from repro_torch.kernels import ref as _ref

#: calls that launched the cold codec's kernel (CPU calls do not count)
launches = 0


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
    T = x.shape[0]
    q, s = cold_codec.encode_rows(
        _blocks(x.to(torch.float32), block).contiguous(), "int8",
        ((0, block),))
    if x.device.type == "cuda":
        launches += 1
    return q.reshape(-1)[:T], s[:, 0]


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
