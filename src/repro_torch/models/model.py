"""Language models of the port (``repro.models.model``): the ``dense``,
``moe``, ``ssm``, ``hybrid``, ``encdec`` and ``vlm`` families.

One interface for every family:
  init_model(gen, cfg, device)             -> params
  forward(cfg, params, batch, remat=)      -> (logits, aux)
  lm_loss(cfg, params, batch, remat=)      -> scalar
  init_decode_cache(cfg, batch, seq)       -> cache dict
  decode_step(cfg, params, cache, tok, pos) -> (logits, cache)

Layers are stacked on a leading axis, as in the reference's tree
(``(layers, ...)``; ``(groups, attn_every, ...)`` for the hybrid stack;
llama4-style MoE models ``{"dense": ..., "moe": ...}`` stacks of
``num_layers / 2`` pairs; the encoder-decoder ``enc_layers`` and
``dec_layers``), and applied by a Python loop over it where the
reference scans. On the card the full-sequence forward runs the
flash-attention kernel in every attention call (self, cross and the
encoder's) and the SSD kernel in every Mamba-2 block; decoding runs
neither. The ``cnn`` family is the FL path's (``models/cnn.py``) and
raises here, as in the reference.

Tensor parallelism (``tp``, a ``core.collectives.ModelParallel``, in
``forward`` and ``lm_loss``): each rank holds its slice of every
parameter (:func:`logical_axes` resolved by ``repro_torch.sharding``, cut by
``sharding.shard_tree``), and the layers split as ``models.layers``,
``models.moe`` and ``models.ssm`` say. The embedding is a vocab-split
lookup (the rank's ``padded_vocab / mp`` rows, masked, then summed over
the model group), the logits the rank's ``padded_vocab / mp`` columns
(a tied head uses its rows of ``tok_embed``), and the loss a vocab-split
cross entropy: the max, the sum of exps and the target logit each
reduced over the model group, so no rank holds the whole (tokens,
vocab) logits.

``remat=True`` recomputes each layer's activations in the backward
instead of keeping them (the reference's ``jax.checkpoint`` of its scan
body): every layer body — a hybrid group with its shared block, an
encoder or decoder layer, a llama4 layer pair — runs under
``torch.utils.checkpoint`` with ``use_reentrant=False``. The gradients
are those without it, bit for bit on the CPU.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tr
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.sharding import prepend_axis

Params = Dict[str, Any]
Device = Union[str, torch.device, None]

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) f32 [sin | cos] embeddings (whisper)."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[:, None].to(torch.float32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def padded_vocab(cfg: ModelConfig) -> int:
    return L.pad_to_multiple(cfg.vocab_size, 256)


def _layers(stacked: Params) -> list:
    """The layers of a stacked tree of dicts as a list of trees of views,
    split along the leading axis once (``unbind``): under autograd their
    gradients come back as one ``stack`` a leaf, where indexing each
    layer would add a full-size, mostly-zero gradient a layer."""
    leaves, treedef = tr.tree_flatten(stacked)
    parts = [torch.unbind(t, 0) for t in leaves]
    return [tr.tree_unflatten(treedef, [p[i] for p in parts])
            for i in range(len(parts[0]))]


def _layer(stacked: Params, *idx) -> Params:
    """The parameters of one layer of a stacked tree of dicts (views)."""
    return {k: _layer(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in stacked.items()}


def _run(remat: bool, fn, *args, **kw):
    """``fn(*args, **kw)``, its activations recomputed in the backward
    when ``remat`` (the reference's ``jax.checkpoint`` of a scan body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


# ---------------------------------------------------------------------------
# per-family blocks
# ---------------------------------------------------------------------------

def _init_dense_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    return {"attn": L.init_attention(gen, cfg, device, lead),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device, lead),
            "norm1": L.init_norm(cfg, cfg.d_model, device, lead),
            "norm2": L.init_norm(cfg, cfg.d_model, device, lead)}


def _dense_logical(cfg: ModelConfig) -> Params:
    return {"attn": L.attention_logical(cfg), "mlp": L.mlp_logical(cfg),
            "norm1": L.norm_logical(cfg), "norm2": L.norm_logical(cfg)}


def _apply_dense_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                       window: Optional[int] = None,
                       causal: bool = True, tp=None) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.apply_attention(cfg, lp["attn"], h, causal=causal,
                              window=window, tp=tp)
    h = L.apply_norm(cfg, lp["norm2"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h, tp)


def _init_moe_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    return {"attn": L.init_attention(gen, cfg, device, lead),
            "moe": M.init_moe(gen, cfg, cfg.d_model, cfg.d_ff, device, lead),
            "norm1": L.init_norm(cfg, cfg.d_model, device, lead),
            "norm2": L.init_norm(cfg, cfg.d_model, device, lead)}


def _moe_block_logical(cfg: ModelConfig) -> Params:
    return {"attn": L.attention_logical(cfg), "moe": M.moe_logical(cfg),
            "norm1": L.norm_logical(cfg), "norm2": L.norm_logical(cfg)}


def _apply_moe_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     window: Optional[int] = None, drops=None, tp=None):
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.apply_attention(cfg, lp["attn"], h, causal=True, window=window,
                              tp=tp)
    h = L.apply_norm(cfg, lp["norm2"], x)
    y, aux = M.apply_moe(cfg, lp["moe"], h, drops, tp)
    return x + y, aux


def _llama4_pair(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 drops=None, tp=None):
    """A llama4 (dense with SWA at sliding_window, MoE with full
    attention) layer pair."""
    x = _apply_dense_block(cfg, lp["dense"], x, window=cfg.sliding_window,
                           tp=tp)
    return _apply_moe_block(cfg, lp["moe"], x, window=0, drops=drops, tp=tp)


def _init_ssm_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    return {"mamba": S.init_mamba(gen, cfg, device, lead),
            "norm1": L.init_norm(cfg, cfg.d_model, device, lead)}


def _apply_ssm_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     intra_fn=None, tp=None) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    return x + S.apply_mamba(cfg, lp["mamba"], h, intra_fn=intra_fn, tp=tp)


def _init_encdec_dec_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    return {"self_attn": L.init_attention(gen, cfg, device, lead),
            "cross_attn": L.init_attention(gen, cfg, device, lead),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device, lead),
            **{f"norm{i}": L.init_norm(cfg, cfg.d_model, device, lead)
               for i in (1, 2, 3)}}


# ---------------------------------------------------------------------------
# init_model
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg: ModelConfig,
               device: Device = None) -> Params:
    """Random parameters from ``gen`` on ``device`` (None: the CUDA card;
    ``"meta"`` gives shapes without memory). Leaf shapes, dtypes and the
    tree's structure equal the reference's ``init_model``; the draws do
    not (``gen`` is not ``jax.random``)."""
    _check_family(cfg)
    device = resolve_device(device)
    V = padded_vocab(cfg)
    dt = L.torch_dtype(cfg.param_dtype)
    params: Params = {
        "tok_embed": L.dense_init(gen, cfg.d_model, (V, cfg.d_model), dt,
                                  device),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, (cfg.d_model, V),
                                         dt, device)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        params["layers"] = _init_dense_block(gen, cfg, device,
                                             (cfg.num_layers,))
        if fam == "vlm":
            params["vision_proj"] = L.dense_init(
                gen, cfg.d_model, (cfg.d_model, cfg.d_model), dt, device)
    elif fam == "moe":
        if cfg.moe_shared_expert:  # llama4-style: (dense, moe) layer pairs
            assert cfg.num_layers % 2 == 0
            half = (cfg.num_layers // 2,)
            params["layers"] = {
                "dense": _init_dense_block(gen, cfg, device, half),
                "moe": _init_moe_block(gen, cfg, device, half)}
        else:  # mixtral-style: every layer MoE
            params["layers"] = _init_moe_block(gen, cfg, device,
                                               (cfg.num_layers,))
    elif fam == "encdec":
        params["enc_layers"] = _init_dense_block(gen, cfg, device,
                                                 (cfg.encoder_layers,))
        params["dec_layers"] = _init_encdec_dec_block(gen, cfg, device,
                                                      (cfg.num_layers,))
        params["enc_final_norm"] = L.init_norm(cfg, cfg.d_model, device)
    elif fam == "ssm":
        params["layers"] = _init_ssm_block(gen, cfg, device,
                                           (cfg.num_layers,))
    else:  # hybrid: (groups, attn_every) Mamba-2 blocks + one shared block
        assert cfg.attn_every > 0 and cfg.num_layers % cfg.attn_every == 0
        groups = cfg.num_layers // cfg.attn_every
        params["layers"] = _init_ssm_block(gen, cfg, device,
                                           (groups, cfg.attn_every))
        params["shared_block"] = _init_dense_block(gen, cfg, device)
    return params


def logical_axes(cfg: ModelConfig) -> Params:
    """The logical axes of :func:`init_model`'s tree, the reference's
    ``init_model``'s second result: a tuple of names a leaf, stacked
    layer axes named ``"layers"``."""
    _check_family(cfg)

    def stacked(lg, times=1):
        for _ in range(times):
            lg = prepend_axis(lg, "layers")
        return lg
    lg: Params = {"tok_embed": ("vocab", "embed"),
                  "final_norm": L.norm_logical(cfg)}
    if not cfg.tie_embeddings:
        lg["lm_head"] = ("embed", "vocab")
    ssm = {"mamba": S.mamba_logical(), "norm1": L.norm_logical(cfg)}
    fam = cfg.family
    if fam in ("dense", "vlm"):
        lg["layers"] = stacked(_dense_logical(cfg))
        if fam == "vlm":
            lg["vision_proj"] = ("embed", "embed")
    elif fam == "moe" and cfg.moe_shared_expert:
        lg["layers"] = {"dense": stacked(_dense_logical(cfg)),
                        "moe": stacked(_moe_block_logical(cfg))}
    elif fam == "moe":
        lg["layers"] = stacked(_moe_block_logical(cfg))
    elif fam == "encdec":
        lg["enc_layers"] = stacked(_dense_logical(cfg))
        lg["dec_layers"] = stacked({
            "self_attn": L.attention_logical(cfg),
            "cross_attn": L.attention_logical(cfg),
            "mlp": L.mlp_logical(cfg),
            **{f"norm{i}": L.norm_logical(cfg) for i in (1, 2, 3)}})
        lg["enc_final_norm"] = L.norm_logical(cfg)
    elif fam == "ssm":
        lg["layers"] = stacked(ssm)
    else:  # hybrid: (groups, attn_every) blocks, as the reference names
        lg["layers"] = stacked(ssm, 2)
        lg["shared_block"] = _dense_logical(cfg)
    return lg


def param_count(params: Params) -> int:
    return sum(t.numel() for t in tr.tree_leaves(params))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _vocab_split(cfg: ModelConfig, params: Params, tp) -> bool:
    return tp is not None and \
        params["tok_embed"].shape[0] != padded_vocab(cfg)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           pos: int = 0, tp=None) -> torch.Tensor:
    """Token embeddings of (B, S) tokens at positions pos.., plus
    sinusoidal positions when the model has no rope (whisper). With the
    vocabulary split, the rank looks up the tokens in its rows and the
    model group sums the masked lookups."""
    emb = params["tok_embed"]
    if _vocab_split(cfg, params, tp):
        rows = emb.shape[0]
        local = tokens - tp.index * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], emb[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=emb.dtype, device=emb.device))
        x = tp.reduce(x.to(L.torch_dtype(cfg.dtype)))
    else:
        x = emb[tokens].to(L.torch_dtype(cfg.dtype))
    if not cfg.use_rope:
        at = torch.arange(pos, pos + tokens.shape[1], device=x.device)
        x = x + _sinusoidal(at, cfg.d_model)[None].to(x.dtype)
    return x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The logits, or with the vocabulary split the rank's columns."""
    x = L.apply_norm(cfg, params["final_norm"], x)
    head = (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    if _vocab_split(cfg, params, tp):
        x = tp.copy(x)
    return x @ head


def _tokens(batch, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=device).long()


def _encode(cfg: ModelConfig, params: Params, frames,
            remat: bool = False, tp=None) -> torch.Tensor:
    """The encoder of an encdec model: (B, encoder_seq, d) frame
    embeddings (the stub frontend's) -> normed (B, encoder_seq, d)."""
    dt = L.torch_dtype(cfg.dtype)
    enc = torch.as_tensor(frames, device=params["tok_embed"].device).to(dt)
    at = torch.arange(enc.shape[1], device=enc.device)
    enc = enc + _sinusoidal(at, cfg.d_model)[None].to(dt)
    for lp in _layers(params["enc_layers"]):
        enc = _run(remat, _apply_dense_block, cfg, lp, enc, causal=False,
                   tp=tp)
    return L.apply_norm(cfg, params["enc_final_norm"], enc)


def _apply_dec_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     enc: torch.Tensor, tp=None) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.apply_attention(cfg, lp["self_attn"], h, causal=True, tp=tp)
    h = L.apply_norm(cfg, lp["norm2"], x)
    x = x + L.apply_attention(cfg, lp["cross_attn"], h, kv_input=enc, tp=tp)
    h = L.apply_norm(cfg, lp["norm3"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h, tp)


def _hybrid_group(cfg: ModelConfig, gp: Params, shared: Params,
                  x: torch.Tensor, intra_fn=None, tp=None) -> torch.Tensor:
    """One hybrid group: its ``attn_every`` Mamba-2 blocks, then the
    shared attention block."""
    for lp in _layers(gp):
        x = _apply_ssm_block(cfg, lp, x, intra_fn=intra_fn, tp=tp)
    return _apply_dense_block(cfg, shared, x, tp=tp)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            remat: bool = False, intra_fn=None,
            drops: Optional[list] = None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, padded_vocab), aux_loss). ``batch["tokens"]``
    is (B, S) int (numpy or tensor); encdec also takes ``frames`` (B,
    encoder_seq, d) and vlm ``patch_embeds`` (B, num_patches, d), whose
    projections come before the tokens (S grows by num_patches). The run
    is on the params' device. ``drops``, a list, receives each MoE
    layer's count of dropped assignments (``models.moe``); under
    ``remat`` the backward's recomputation appends them again.
    ``remat`` recomputes each layer body's activations in the
    backward. Under ``tp`` the params are the rank's slices and the
    logits its vocabulary columns where the vocabulary is split."""
    _check_family(cfg)
    fam = cfg.family
    device = params["tok_embed"].device
    aux = torch.zeros((), dtype=torch.float32, device=device)
    if fam == "encdec":
        enc = _encode(cfg, params, batch["frames"], remat, tp)
        x = _embed(cfg, params, _tokens(batch, device), tp=tp)
        for lp in _layers(params["dec_layers"]):
            x = _run(remat, _apply_dec_block, cfg, lp, x, enc, tp=tp)
        return _logits(cfg, params, x, tp), aux

    x = _embed(cfg, params, _tokens(batch, device), tp=tp)
    if fam == "vlm":
        dt = L.torch_dtype(cfg.dtype)
        patches = torch.as_tensor(batch["patch_embeds"], device=device
                                  ).to(dt) @ params["vision_proj"]
        x = torch.cat([patches, x], dim=1)
    layers = params["layers"]
    if fam in ("dense", "vlm"):
        for lp in _layers(layers):
            x = _run(remat, _apply_dense_block, cfg, lp, x, tp=tp)
    elif fam == "moe" and cfg.moe_shared_expert:
        # llama4: (dense with SWA at sliding_window, MoE with full
        # attention) pairs
        for lp in _layers(layers):
            x, a = _run(remat, _llama4_pair, cfg, lp, x, drops, tp=tp)
            aux = aux + a
    elif fam == "moe":
        for lp in _layers(layers):
            x, a = _run(remat, _apply_moe_block, cfg, lp, x, drops=drops,
                        tp=tp)
            aux = aux + a
    elif fam == "ssm":
        for lp in _layers(layers):
            x = _run(remat, _apply_ssm_block, cfg, lp, x, intra_fn=intra_fn,
                     tp=tp)
    else:  # hybrid
        for gp in _layers(layers):
            x = _run(remat, _hybrid_group, cfg, gp, params["shared_block"],
                     x, intra_fn=intra_fn, tp=tp)
    return _logits(cfg, params, x, tp), aux


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            remat: bool = False, aux_weight: float = 0.01,
            tp=None) -> torch.Tensor:
    """Mean next-token cross entropy (f32) plus ``aux_weight`` x aux; a
    vlm model's loss is over the text positions only. ``remat`` and
    ``tp`` as in :func:`forward`: with the vocabulary split, the
    logsumexp's max, its sum of exps and the target logit are each
    reduced over the model group."""
    logits, aux = forward(cfg, params, batch, remat=remat, tp=tp)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    lf = logits.to(torch.float32)
    if not _vocab_split(cfg, params, tp):
        lse = torch.logsumexp(lf, dim=-1)
        picked = torch.gather(lf, -1, labels[..., None])[..., 0]
        return (lse - picked).mean() + aux_weight * aux
    cols = lf.shape[-1]
    m = tp.max(lf.amax(dim=-1))
    lse = m + torch.log(tp.reduce(torch.exp(lf - m[..., None]).sum(-1)))
    local = labels - tp.index * cols
    mine = (local >= 0) & (local < cols)
    picked = torch.gather(lf, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
    picked = tp.reduce(torch.where(mine, picked, torch.zeros_like(picked)))
    return (lse - picked).mean() + aux_weight * aux


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, seq: int,
                      dtype: Optional[torch.dtype] = None,
                      device: Device = None) -> Params:
    """The per-family decode cache; ``seq`` is the max KV length. Hybrid
    Mamba caches are (groups, attn_every, ...), its KV caches (groups,
    ...): one per application of the shared block. llama4-style MoE
    caches are (num_layers / 2, 2, ...): the pair's dense then MoE
    layer. Encdec adds the cross-attention caches ``xk``/``xv``,
    (layers, batch, encoder_seq, num_heads, head_dim), zero until the
    caller fills them from the encoder."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or L.torch_dtype(cfg.dtype)
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def kv(n):
        return torch.zeros((n, batch, seq, hk, hd), dtype=dt, device=device)

    fam = cfg.family
    if fam in ("dense", "vlm") or (fam == "moe"
                                   and not cfg.moe_shared_expert):
        return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers)}
    if fam == "moe":
        half = cfg.num_layers // 2
        return {n: torch.zeros((half, 2, batch, seq, hk, hd), dtype=dt,
                               device=device) for n in ("k", "v")}
    if fam == "encdec":
        x = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_heads, hd)
        return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers),
                "xk": torch.zeros(x, dtype=dt, device=device),
                "xv": torch.zeros(x, dtype=dt, device=device)}
    if fam == "ssm":
        return S.init_mamba_cache(cfg, cfg.num_layers, batch, dt, device)
    groups = cfg.num_layers // cfg.attn_every
    mc = S.init_mamba_cache(cfg, groups * cfg.attn_every, batch, dt, device)
    mc = {k: v.reshape((groups, cfg.attn_every) + v.shape[1:])
          for k, v in mc.items()}
    return {**mc, "k": kv(groups), "v": kv(groups)}


def decode_cache_logical(cfg: ModelConfig) -> Params:
    """The logical axes of :func:`init_decode_cache`'s tree, the
    reference's ``init_decode_cache``'s second result."""
    _check_family(cfg)
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    fam = cfg.family
    if fam in ("dense", "vlm") or (fam == "moe"
                                   and not cfg.moe_shared_expert):
        return {"k": kv, "v": kv}
    if fam == "moe":
        pair = ("layers", None, "batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": pair, "v": pair}
    if fam == "encdec":
        cross = ("layers", "batch", None, "heads", "head_dim")
        return {"k": kv, "v": kv, "xk": cross, "xv": cross}
    if fam == "ssm":
        return {"ssm_state": ("layers", "batch", "ssm_heads", None, "state"),
                "conv_state": ("layers", "batch", None, None)}
    return {"ssm_state": ("layers", None, "batch", "ssm_heads", None,
                          "state"),
            "conv_state": ("layers", None, "batch", None, None),
            "k": kv, "v": kv}


def _decode_ssm_block(cfg, lp, x, cache, idx):
    """One Mamba-2 block of a decode step; its cache slots are updated in
    place."""
    h = L.apply_norm(cfg, lp["norm1"], x)
    y, st, cs = S.decode_mamba(cfg, lp["mamba"], h, cache["ssm_state"][idx],
                               cache["conv_state"][idx])
    cache["ssm_state"][idx] = st
    cache["conv_state"][idx] = cs
    return x + y


def _decode_attn(cfg, lp, x, cache, idx, pos, window=None):
    """Pre-norm self-attention of a decode step (residual added); writes
    its KV slot at pos."""
    h = L.apply_norm(cfg, lp["norm1"], x)
    a, _, _ = L.decode_attention(cfg, lp["attn"], h, cache["k"][idx],
                                 cache["v"][idx], pos, window=window)
    return x + a


def _decode_dense_block(cfg, lp, x, cache, idx, pos, window=None):
    """One attention block of a decode step; writes its KV slot at pos."""
    x = _decode_attn(cfg, lp, x, cache, idx, pos, window)
    h = L.apply_norm(cfg, lp["norm2"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def _decode_moe_block(cfg, lp, x, cache, idx, pos, window=None):
    x = _decode_attn(cfg, lp, x, cache, idx, pos, window)
    h = L.apply_norm(cfg, lp["norm2"], x)
    return x + M.apply_moe(cfg, lp["moe"], h)[0]


def _decode_dec_block(cfg, lp, x, cache, i, pos):
    """One decoder block of an encdec decode step: self-attention on the
    KV cache, cross-attention on ``xk``/``xv`` at their last position,
    no cache write."""
    h = L.apply_norm(cfg, lp["norm1"], x)
    a, _, _ = L.decode_attention(cfg, lp["self_attn"], h, cache["k"][i],
                                 cache["v"][i], pos)
    x = x + a
    h = L.apply_norm(cfg, lp["norm2"], x)
    xk, xv = cache["xk"][i], cache["xv"][i]
    a, _, _ = L.decode_attention(cfg, lp["cross_attn"], h, xk, xv,
                                 xk.shape[1] - 1, update_cache=False)
    x = x + a
    h = L.apply_norm(cfg, lp["norm3"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens, pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1) int, pos: int (current length).

    Returns (logits (B, 1, V), cache). The cache is updated in place
    (the reference returns a new one); the returned dict is the same."""
    _check_family(cfg)
    device = params["tok_embed"].device
    pos = int(pos)
    x = _embed(cfg, params, torch.as_tensor(tokens, device=device).long(),
               pos)
    fam = cfg.family
    if fam == "encdec":
        for i in range(cfg.num_layers):
            x = _decode_dec_block(cfg, _layer(params["dec_layers"], i), x,
                                  cache, i, pos)
        return _logits(cfg, params, x), cache
    layers = params["layers"]
    if fam in ("dense", "vlm"):
        for i in range(cfg.num_layers):
            x = _decode_dense_block(cfg, _layer(layers, i), x, cache, (i,),
                                    pos)
    elif fam == "moe" and cfg.moe_shared_expert:
        for i in range(cfg.num_layers // 2):
            x = _decode_dense_block(cfg, _layer(layers["dense"], i), x,
                                    cache, (i, 0), pos,
                                    window=cfg.sliding_window)
            x = _decode_moe_block(cfg, _layer(layers["moe"], i), x, cache,
                                  (i, 1), pos, window=0)
    elif fam == "moe":
        for i in range(cfg.num_layers):
            x = _decode_moe_block(cfg, _layer(layers, i), x, cache, (i,),
                                  pos)
    elif fam == "ssm":
        for i in range(cfg.num_layers):
            x = _decode_ssm_block(cfg, _layer(layers, i), x, cache, (i,))
    else:  # hybrid: groups, then blocks, then the shared block
        shared = params["shared_block"]
        for g in range(cfg.num_layers // cfg.attn_every):
            for i in range(cfg.attn_every):
                x = _decode_ssm_block(cfg, _layer(layers, g, i), x, cache,
                                      (g, i))
            x = _decode_dense_block(cfg, shared, x, cache, (g,), pos)
    return _logits(cfg, params, x), cache
