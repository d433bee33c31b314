"""Core neural-net layers of the language models (port of
``repro.models.layers``): plain functions on tensors and parameter dicts.

Parameters keep the reference's layout so that its weights carry across
as leaf copies (:mod:`repro_torch.convert`): dense weights (fan_in,
fan_out), attention ``wq``/``wk``/``wv`` (d, heads, head_dim) and ``wo``
(heads, head_dim, d). The reference's logical sharding axes are the
``*_logical`` functions (``repro_torch.sharding``).

Tensor parallelism (``tp``, a ``core.collectives.ModelParallel``): a
rank holds its slice of each parameter as the resolved spec says, and a
layer reads from its parameters' shapes what is split. The MLP splits
``ff`` (column-split in, row-split out, one model-group sum); attention
splits the query heads and, where they divide, the kv heads, runs on the
rank's heads and sums ``wo``'s partial products. Where the kv heads do
not divide and the query heads do, the rank keeps every kv head and maps
each of its query heads to its global kv group. Where the query heads do
not divide either, ``cfg.attn_seq_shard`` gives each rank its share of
the query rows instead (the reference's context-parallel core). Norms
and rope stay replicated. With ``tp`` None, or nothing split, a layer
is the unsplit one, op for op. :func:`decode_attention` splits the same
way, and its cache's positions may also be split over the data axis.

On a CUDA tensor the full-sequence attention core runs the hand-written
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`); on
a CPU tensor it is the plain twin of the reference's ``attention_core``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch import flags
from repro_torch.config import ModelConfig
from repro_torch.kernels import flash_attention as _fa

Params = Dict[str, Any]
Device = Union[str, torch.device]

#: masked attention scores, as in the reference
NEG_INF = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype``/``param_dtype`` name."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def dense_init(gen: torch.Generator, fan_in: int, shape, dtype: torch.dtype,
               device: Device) -> torch.Tensor:
    """A normal draw scaled by 1/sqrt(fan_in) in f32, then cast (the
    reference's ``dense_init``; the draws come from ``gen``)."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)  # in place: one f32 copy at a time


def pad_to_multiple(n: int, m: int = 256) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, device: Device,
              lead=()) -> Params:
    """Norm parameters; ``lead`` prepends stacked layer axes."""
    p: Params = {"scale": torch.ones(tuple(lead) + (d,), dtype=_dtype(cfg),
                                     device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=_dtype(cfg),
                                device=device)
    return p


def norm_logical(cfg: ModelConfig) -> Params:
    """The logical axes of :func:`init_norm`'s parameters."""
    lg: Params = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        lg["bias"] = ("embed",)
    return lg


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). The head
    dimension splits into halves (no interleaving), as in the reference."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freq / half)
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, half)
    ang = ang[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d: int, ff: int,
             device: Device, lead=()) -> Params:
    dt = _dtype(cfg)
    lead = tuple(lead)
    if cfg.mlp_act == "relu2":  # nemotron/minitron: squared-relu, no gate
        return {"w_in": dense_init(gen, d, lead + (d, ff), dt, device),
                "w_out": dense_init(gen, ff, lead + (ff, d), dt, device)}
    if cfg.mlp_act == "gelu":  # whisper-style: single path + bias
        return {"w_in": dense_init(gen, d, lead + (d, ff), dt, device),
                "b_in": torch.zeros(lead + (ff,), dtype=dt, device=device),
                "w_out": dense_init(gen, ff, lead + (ff, d), dt, device),
                "b_out": torch.zeros(lead + (d,), dtype=dt, device=device)}
    return {"w_gate": dense_init(gen, d, lead + (d, ff), dt, device),
            "w_up": dense_init(gen, d, lead + (d, ff), dt, device),
            "w_out": dense_init(gen, ff, lead + (ff, d), dt, device)}


def mlp_logical(cfg: ModelConfig) -> Params:
    """The logical axes of :func:`init_mlp`'s parameters."""
    if cfg.mlp_act == "relu2":
        return {"w_in": ("embed", "ff"), "w_out": ("ff", "embed")}
    if cfg.mlp_act == "gelu":
        return {"w_in": ("embed", "ff"), "b_in": ("ff",),
                "w_out": ("ff", "embed"), "b_out": ("embed",)}
    return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
            "w_out": ("ff", "embed")}


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor,
              tp=None) -> torch.Tensor:
    """The MLP; under ``tp`` with ``ff`` split, on the rank's columns,
    summed over the model group (``b_out`` added after the sum)."""
    split = tp is not None and p["w_out"].shape[-2] != cfg.d_ff
    if split:
        x = tp.copy(x)
    if cfg.mlp_act == "relu2":
        y = torch.square(F.relu(x @ p["w_in"])) @ p["w_out"]
    elif cfg.mlp_act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        y = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh") @ \
            p["w_out"]
    else:
        y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_out"]
    if split:
        y = tp.reduce(y)
    return y + p["b_out"] if cfg.mlp_act == "gelu" else y


# ---------------------------------------------------------------------------
# Attention (GQA, optional bias / sliding window / cross-attention)
# ---------------------------------------------------------------------------

def padded_heads(cfg: ModelConfig) -> int:
    return max(cfg.head_pad_to, cfg.num_heads) if cfg.head_pad_to \
        else cfg.num_heads


def init_attention(gen: torch.Generator, cfg: ModelConfig, device: Device,
                   lead=()) -> Params:
    d, h, hk = cfg.d_model, padded_heads(cfg), cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg)
    lead = tuple(lead)
    p: Params = {
        "wq": dense_init(gen, d, lead + (d, h, hd), dt, device),
        "wk": dense_init(gen, d, lead + (d, hk, hd), dt, device),
        "wv": dense_init(gen, d, lead + (d, hk, hd), dt, device),
        "wo": dense_init(gen, h * hd, lead + (h, hd, d), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros(lead + (hk, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros(lead + (hk, hd), dtype=dt, device=device)
    return p


def attention_logical(cfg: ModelConfig) -> Params:
    """The logical axes of :func:`init_attention`'s parameters."""
    lg: Params = {"wq": ("embed", "heads", "head_dim"),
                  "wk": ("embed", "kv_heads", "head_dim"),
                  "wv": ("embed", "kv_heads", "head_dim"),
                  "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        lg.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                  bv=("kv_heads", "head_dim"))
    return lg


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                kv_input: Optional[torch.Tensor] = None):
    """Returns q,k,v with shapes (B,S,H,D), (B,Skv,Hkv,D), (B,Skv,Hkv,D)."""
    kv_in = x if kv_input is None else kv_input
    q = _project(x, p["wq"])
    k = _project(kv_in, p["wk"])
    v = _project(kv_in, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,H,D) by repeating kv heads (GQA)."""
    rep = num_heads // k.shape[-2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=-2)


def _band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """True where attention is allowed. q_pos (Sq,), k_pos (Sk,)."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return ok


def _promote(a: torch.Tensor, b: torch.Tensor):
    """a and b in their promoted dtype (jnp's mixed-dtype einsum)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0, q_offset: int = 0,
                   block_q: int = 1024, block_k: int = 1024
                   ) -> torch.Tensor:
    """Numerically-stable attention. q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D) ->
    (B,Sq,H,D).

    On a CUDA tensor: the flash-attention kernel, through its (B,S,H,D)
    adapter. On a CPU tensor: the reference's two branches — the dense
    softmax for Sq, Sk <= 2048 (probabilities cast to q's dtype before
    the PV product), else the online-softmax block scan. On a ``meta``
    tensor under ``flags.analysis``: the kernel's shape-only twin (the
    dry-run's); elsewhere ``meta`` raises in the kernel's wrapper."""
    if q.device.type == "meta" and flags.analysis_mode():
        return _fa.attend_shape(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    if q.device.type != "cpu":
        return _fa.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq)
    k_pos = torch.arange(Sk)
    neg = torch.full((), NEG_INF)
    if Sq <= 2048 and Sk <= 2048:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
        mask = _band_mask(q_pos, k_pos, causal=causal, window=window)
        s = torch.where(mask[None, None], s, neg)
        pr = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", pr, v)

    # --- flash-style double loop (the reference's XLA path) ---
    nq = -(-Sq // block_q)
    nk = -(-Sk // block_k)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * block_q - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * block_k - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * block_k - Sk))
    outs = []
    for qi in range(nq):
        qblk = qp[:, qi * block_q:(qi + 1) * block_q]
        qpos = q_offset + qi * block_q + torch.arange(block_q)
        m = torch.full((B, H, block_q), -math.inf)
        l = torch.zeros((B, H, block_q))
        acc = torch.zeros((B, H, block_q, D))
        for kj in range(nk):
            kblk = kp[:, kj * block_k:(kj + 1) * block_k]
            vblk = vp[:, kj * block_k:(kj + 1) * block_k]
            kpos = kj * block_k + torch.arange(block_k)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk
                             ).to(torch.float32) * scale
            valid = _band_mask(qpos, kpos, causal=causal, window=window)
            valid &= (kpos < Sk)[None, :]
            s = torch.where(valid[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pexp = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pexp.to(qblk.dtype), vblk
            ).to(torch.float32)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=2).transpose(1, 2)  # (B, nq*block_q, H, D)
    return out[:, :Sq]


def _mask_padded_heads(cfg: ModelConfig, out: torch.Tensor,
                       offset: int = 0) -> torch.Tensor:
    """Zero the outputs of padded heads, so padding is permanently inert.
    Padding is interleaved per GQA group (slot % rep_new >= rep_old
    masked) so every real head keeps its original kv-head assignment.
    ``out``'s heads are the global heads ``offset`` on (a rank's)."""
    hp = padded_heads(cfg)
    if hp == cfg.num_heads:
        return out
    rep_new = hp // cfg.num_kv_heads
    rep_old = cfg.num_heads // cfg.num_kv_heads
    heads = offset + torch.arange(out.shape[-2], device=out.device)
    mask = ((heads % rep_new) < rep_old).to(out.dtype)
    return out * mask[:, None]


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


def _rank_kv(k: torch.Tensor, offset: int, heads: int,
             rep: int) -> torch.Tensor:
    """The kv heads (B, S, Hkv, D -> B, S, h, D) that a rank's ``heads``
    query heads, the global heads ``offset`` on, attend to, where every
    rank holds all kv heads (``rep`` query heads a kv head): a slice of
    whole kv groups, the one kv head they share, or one kv head each."""
    if heads % rep == 0:
        return k[:, :, offset // rep:(offset + heads) // rep]
    if rep % heads == 0:
        return k[:, :, offset // rep:offset // rep + 1]
    idx = (offset + torch.arange(heads, device=k.device)) // rep
    return k.index_select(2, idx)


def apply_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    causal: bool = True,
                    kv_input: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, tp=None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention; under ``tp`` with the
    query heads split, on the rank's heads, ``wo``'s partial products
    summed over the model group."""
    H, Hk = padded_heads(cfg), cfg.num_kv_heads
    h, hk = p["wq"].shape[-2], p["wk"].shape[-2]
    split = tp is not None and h != H
    if tp is not None and hk != Hk and not split:
        raise ValueError(f"kv heads split ({hk} of {Hk}) but query heads "
                         f"not ({h} of {H})")
    offset = tp.index * h if split else 0
    kv_split = split and hk != Hk
    if split:
        xs = tp.copy(x)
        if kv_split:
            kv_in = xs if kv_input is None else tp.copy(kv_input)
        else:
            kv_in = x if kv_input is None else kv_input
        q, k, v = qkv_project(cfg, p, xs, kv_in)
    else:
        q, k, v = qkv_project(cfg, p, x, kv_input)
    if cfg.use_rope and kv_input is None:
        pos = positions if positions is not None else torch.arange(
            x.shape[1], device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    if split and not kv_split:
        # every rank holds all kv heads: their gradients are partial
        rep = H // Hk
        k = _rank_kv(tp.copy(k), offset, h, rep)
        v = _rank_kv(tp.copy(v), offset, h, rep)
    w = cfg.sliding_window if window is None else window
    mask = dict(causal=causal and kv_input is None,
                window=w if kv_input is None else 0)
    Sq = q.shape[1]
    if tp is not None and not split and cfg.attn_seq_shard and Sq > 1 \
            and Sq % tp.size == 0:
        # context-parallel core (the reference's q rows over the model
        # axis): this rank's rows against the whole K and V, joined by a
        # gather; every rank's q, k and v gradients are partial
        rows = Sq // tp.size
        lo = tp.index * rows
        q, k, v = tp.copy(q), tp.copy(k), tp.copy(v)
        out = tp.gather(attention_core(q[:, lo:lo + rows], k, v,
                                       q_offset=lo, **mask), 1)
    else:
        out = attention_core(q, k, v, **mask)
    out = _mask_padded_heads(cfg, out, offset)
    out = _out_project(out, p["wo"])
    return tp.reduce(out) if split else out


def decode_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, *, window: Optional[int] = None,
                     update_cache: bool = True, tp=None, sp=None):
    """Single-token decode. x: (B,1,d). caches: (B,S,Hkv,D). pos: int.

    Returns (out (B,1,d), k_cache, v_cache). The new key and value are
    written into the caches in place at ``pos`` (the reference's
    ``dynamic_update_slice`` returns new arrays); the returned caches are
    the same tensors. Plain torch on every device: one query row against
    the cache, as the reference computes it outside any kernel.

    Under ``tp`` with the query heads split, on the rank's heads, as
    :func:`apply_attention`: the caches hold the rank's kv heads where
    they divide, else every kv head (the rank writes them all and reads
    its heads' groups), and ``wo``'s partial products are summed over
    the model group. ``sp`` (``core.collectives.SequenceSplit``) splits
    the caches' positions over the data axis (``serve_specs`` where the
    batch does not divide it): the rank holds positions ``sp.index *
    S`` on, the owner of ``pos`` writes it, and the softmax's max, its
    sum and the output are reduced over the ranks holding the other
    positions."""
    H, Hk = padded_heads(cfg), cfg.num_kv_heads
    h = p["wq"].shape[-2]
    split = tp is not None and h != H
    offset = tp.index * h if split else 0
    q, k, v = qkv_project(cfg, p, x)
    if cfg.use_rope:
        pq = torch.full((x.shape[1],), pos, device=x.device)
        q = rope(q, pq, cfg.rope_theta)
        k = rope(k, pq, cfg.rope_theta)
    S = k_cache.shape[1]
    first = sp.index * S if sp is not None else 0
    at = pos - first
    if update_cache and 0 <= at < S:
        k_cache[:, at:at + k.shape[1]] = k.to(k_cache.dtype)
        v_cache[:, at:at + v.shape[1]] = v.to(v_cache.dtype)
    kc, vc = k_cache, v_cache
    if split and p["wk"].shape[-2] == Hk and kc.shape[-2] == Hk:
        # every rank holds all kv heads: its query heads' groups
        kc, vc = (_rank_kv(c, offset, h, H // Hk) for c in (kc, vc))
    kx = _expand_kv(kc, h)
    vx = _expand_kv(vc, h)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", *_promote(q, kx)
                     ).to(torch.float32) * scale
    kpos = first + torch.arange(S, device=x.device)
    ok = kpos <= pos
    w = cfg.sliding_window if window is None else window
    if w and w > 0:
        ok &= kpos > pos - w
    s = torch.where(ok[None, None, None, :], s,
                    torch.full((), NEG_INF, device=x.device))
    if sp is None:
        pr = torch.softmax(s, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", *_promote(pr, vx))
    else:
        e = torch.exp(s - sp.max(s.amax(dim=-1, keepdim=True)))
        pr = (e / sp.sum(e.sum(dim=-1, keepdim=True))).to(q.dtype)
        out = sp.sum(torch.einsum("bhqk,bkhd->bqhd", *_promote(pr, vx)))
    out = _mask_padded_heads(cfg, out, offset)
    out = _out_project(*_promote(out, p["wo"]))
    return (tp.reduce(out) if split else out), k_cache, v_cache
