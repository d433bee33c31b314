"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper and the ground truth its kernel is held against on the card."""
from __future__ import annotations

import math

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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain version of ``kernels.flash_attention.flash_attention``: direct
    softmax attention in f32. q: (BH, Sq, D), k/v: (BH, Sk, D), kv heads
    already expanded; masked scores are -1e30. Returns q's dtype."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=q.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    s = torch.where(ok[None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def flash_attention_bshd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             q_offset: int = 0) -> torch.Tensor:
    """Plain version of ``kernels.flash_attention.flash_attention_bshd``
    (the reference's GQA adapter): q (B, Sq, H, D), k/v (B, Sk, Hkv, D);
    kv heads repeated, heads folded into the batch, back to (B, Sq, H,
    D)."""
    B, Sq, H, D = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qt = q.transpose(1, 2).reshape(B * H, Sq, D)
    kt = k.transpose(1, 2).reshape(B * H, -1, D)
    vt = v.transpose(1, 2).reshape(B * H, -1, D)
    o = flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                            q_offset=q_offset)
    return o.reshape(B, H, Sq, D).transpose(1, 2)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """Plain version of ``kernels.flash_attention.flash_attention_lse``:
    (o, lse) of the (B, S, H, D) adapter, lse the (B, H, Sq) f32
    logsumexp of the scaled scores masked to -1e30."""
    o = flash_attention_bshd_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    B, Sq, H, D = q.shape
    kf = torch.repeat_interleave(k.to(torch.float32), H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * (
        1.0 / math.sqrt(D))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=q.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    s = torch.where(ok, s, torch.full((), -1e30, device=q.device))
    return o, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            lse: torch.Tensor | None = None):
    """Plain version of the flash-attention backward
    (``kernels.flash_attention``'s ``_launch_bwd``): FlashAttention-2's
    formula written out in f32, in the (B, S, H, D) layout with GQA.
    q, o, do (B, Sq, H, D); k, v (B, Sk, Hkv, D); ``lse`` the forward's
    (B, H, Sq) logsumexp (recomputed from the scores when None). With s
    the scaled scores masked to -1e30 as the forward masks them:
    P = exp(s - lse), D = rowsum(do o), dV = Pᵀ do, dP = do vᵀ,
    dS = P (dP - D), dQ = dS k scale, dK = dSᵀ q scale; a kv head's dK
    and dV sum over its H / Hkv query heads. Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    f32 = torch.float32
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, of, gf = (t.to(f32) for t in (q, o, do))
    kf = torch.repeat_interleave(k.to(f32), G, dim=2)
    vf = torch.repeat_interleave(v.to(f32), G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=q.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    s = torch.where(ok, s, torch.full((), -1e30, device=q.device))
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.to(f32)[..., None])                # (B,H,Sq,Sk)
    delta = (gf * of).sum(-1).transpose(1, 2)                # (B,H,Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dk = dk.reshape(B, Sk, Hkv, G, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_intra_chunk_ref(x: torch.Tensor, a_t: torch.Tensor,
                        Bc: torch.Tensor, Cc: torch.Tensor,
                        dtc: torch.Tensor):
    """Plain version of ``kernels.ssd_scan.ssd_intra_chunk``. x: (BK, H,
    C, P); a_t/dtc: (BK, H, C); Bc/Cc: (BK, C, N). Returns (y_intra (BK,
    H, C, P) f32, states (BK, H, N, P) f32)."""
    f32 = torch.float32
    xf, a, Bf, Cf, dt = (t.to(f32) for t in (x, a_t, Bc, Cc, dtc))
    C = x.shape[2]
    cum = torch.cumsum(a, dim=-1)                        # (BK,H,C)
    diff = cum[..., :, None] - cum[..., None, :]         # (BK,H,C,C)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    L = torch.where(mask, torch.exp(diff), torch.zeros((), device=x.device))
    scores = torch.einsum("bin,bjn->bij", Cf, Bf)        # (BK,C,C)
    att = scores[:, None] * L * dt[..., None, :]         # (BK,H,C,C)
    y = torch.einsum("bhij,bhjp->bhip", att, xf)
    decay_end = torch.exp(cum[..., -1:] - cum)           # (BK,H,C)
    states = torch.einsum("bjn,bhjp->bhnp", Bf,
                          (decay_end * dt)[..., None] * xf)
    return y, states


def ssd_intra_states_fn_ref(xc: torch.Tensor, a_t: torch.Tensor,
                            Bc: torch.Tensor, Cc: torch.Tensor,
                            dtc: torch.Tensor):
    """Plain version of ``kernels.ssd_scan.make_intra_states_fn``'s
    adapter: xc (B,K,C,H,P), a_t (B,K,H,C), Bc/Cc (B,K,C,N), dtc
    (B,K,C,H) -> (y_intra (B,K,C,H,P), states (B,K,H,N,P)) f32."""
    B, K, C, H, P = xc.shape
    N = Bc.shape[-1]
    y, st = ssd_intra_chunk_ref(
        xc.permute(0, 1, 3, 2, 4).reshape(B * K, H, C, P),
        a_t.reshape(B * K, H, C), Bc.reshape(B * K, C, N),
        Cc.reshape(B * K, C, N),
        dtc.permute(0, 1, 3, 2).reshape(B * K, H, C))
    return (y.reshape(B, K, H, C, P).permute(0, 1, 3, 2, 4),
            st.reshape(B, K, H, N, P))


def ssd_intra_fn_ref(xc: torch.Tensor, a_t: torch.Tensor, Bc: torch.Tensor,
                     Cc: torch.Tensor, dtc: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.ssd_scan.make_intra_fn``'s adapter (the
    reference's): y_intra (B,K,C,H,P) of
    :func:`ssd_intra_states_fn_ref`."""
    return ssd_intra_states_fn_ref(xc, a_t, Bc, Cc, dtc)[0]
