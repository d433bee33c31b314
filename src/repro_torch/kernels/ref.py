"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper and the ground truth its kernel is held against on the card."""
from __future__ import annotations

import torch


def gossip_mix_ref(W: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Y: (n, T); returns WᵀY, summed in f32, in Y's dtype."""
    return (W.to(torch.float32).T @ Y.to(torch.float32)).to(Y.dtype)


def gossip_mix_rows_ref(W: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Y: (n, T); returns W @ Y (row application), summed in f32, in
    Y's dtype."""
    return (W.to(torch.float32) @ Y.to(torch.float32)).to(Y.dtype)


def _ieee_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b as one correctly rounded f32 division per element: the
    divisor is a tensor, never a Python scalar (PyTorch may multiply by
    the reciprocal of a scalar divisor on the card, which rounds
    differently)."""
    return torch.div(a, b.to(a.dtype).expand_as(a))


def cold_encode_ref(rows: torch.Tensor, codec: str, segments):
    """Plain version of ``kernels.cold_codec.encode_rows`` and the device
    twin of ``core.compress.encode_cold_rows``: per FlatLayout segment,
    ``scale = max(|seg|, 1e-12) / 127`` in f32 and
    ``q = clip(round_half_even(seg / scale), -127, 127)`` as int8; f16
    is the IEEE cast and f32 the identity. rows: (S, T) f32; returns
    ``(q (S, T) codec dtype, scale (S, nseg | 0) f32)``."""
    rows = rows.to(torch.float32)
    S = rows.shape[0]
    empty = torch.zeros((S, 0), dtype=torch.float32, device=rows.device)
    if codec == "f32":
        return rows, empty
    if codec == "f16":
        return rows.to(torch.float16), empty
    if codec != "int8":
        raise ValueError(f"unknown cold codec {codec!r}")
    q = torch.empty(rows.shape, dtype=torch.int8, device=rows.device)
    scale = torch.empty((S, len(segments)), dtype=torch.float32,
                        device=rows.device)
    floor = torch.full((), 1e-12, dtype=torch.float32, device=rows.device)
    d127 = torch.full((), 127.0, dtype=torch.float32, device=rows.device)
    for j, (off, size) in enumerate(segments):
        seg = rows[:, off:off + size]
        amax = seg.abs().amax(dim=1)
        # torch.maximum propagates NaN, as numpy's maximum does
        s = _ieee_div(torch.maximum(amax, floor), d127)
        scale[:, j] = s
        q[:, off:off + size] = torch.clamp(
            torch.round(_ieee_div(seg, s[:, None])), -127, 127).to(
                torch.int8)
    return q, scale


def cold_decode_ref(q: torch.Tensor, scale: torch.Tensor, codec: str,
                    segments) -> torch.Tensor:
    """Plain version of ``kernels.cold_codec.decode_rows``: the inverse
    of :func:`cold_encode_ref` back to (S, T) f32 (exact for f32, the
    dequantized view ``q * scale`` for int8, the IEEE widening for
    f16)."""
    if codec in ("f32", "f16"):
        return q.to(torch.float32)
    if codec != "int8":
        raise ValueError(f"unknown cold codec {codec!r}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for j, (off, size) in enumerate(segments):
        out[:, off:off + size] = (q[:, off:off + size].to(torch.float32)
                                  * scale[:, j][:, None])
    return out
