"""Language models of the port (``repro.models.model`` for the ``dense``,
``ssm`` and ``hybrid`` families).

One interface for every ported family:
  init_model(gen, cfg, device)             -> params
  forward(cfg, params, batch)              -> (logits, aux)
  lm_loss(cfg, params, batch)              -> scalar
  init_decode_cache(cfg, batch, seq)       -> cache dict
  decode_step(cfg, params, cache, tok, pos) -> (logits, cache)

Layers are stacked on a leading axis, as in the reference's tree
(``(layers, ...)``; ``(groups, attn_every, ...)`` for the hybrid stack),
and applied by a Python loop over it where the reference scans. On the
card the full-sequence forward runs the flash-attention kernel in every
attention layer and the SSD kernel in every Mamba-2 block; decoding
runs neither. The ``moe``, ``encdec`` and ``vlm`` families arrive with a
later slice (ROADMAP A15) and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree as tr
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]
Device = Union[str, torch.device, None]

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port runs {PORTED_FAMILIES}; the rest is ROADMAP A15")


def padded_vocab(cfg: ModelConfig) -> int:
    return L.pad_to_multiple(cfg.vocab_size, 256)


def _layer(stacked: Params, *idx) -> Params:
    """The parameters of one layer of a stacked tree of dicts (views)."""
    return {k: _layer(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# per-family blocks
# ---------------------------------------------------------------------------

def _init_dense_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    return {"attn": L.init_attention(gen, cfg, device, lead),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device, lead),
            "norm1": L.init_norm(cfg, cfg.d_model, device, lead),
            "norm2": L.init_norm(cfg, cfg.d_model, device, lead)}


def _apply_dense_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.apply_attention(cfg, lp["attn"], h, causal=True, window=window)
    h = L.apply_norm(cfg, lp["norm2"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def _init_ssm_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    return {"mamba": S.init_mamba(gen, cfg, device, lead),
            "norm1": L.init_norm(cfg, cfg.d_model, device, lead)}


def _apply_ssm_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                     intra_fn=None) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    return x + S.apply_mamba(cfg, lp["mamba"], h, intra_fn=intra_fn)


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
    if cfg.family == "dense":
        params["layers"] = _init_dense_block(gen, cfg, device,
                                             (cfg.num_layers,))
    elif cfg.family == "ssm":
        params["layers"] = _init_ssm_block(gen, cfg, device,
                                           (cfg.num_layers,))
    else:  # hybrid: (groups, attn_every) Mamba-2 blocks + one shared block
        assert cfg.attn_every > 0 and cfg.num_layers % cfg.attn_every == 0
        groups = cfg.num_layers // cfg.attn_every
        params["layers"] = _init_ssm_block(gen, cfg, device,
                                           (groups, cfg.attn_every))
        params["shared_block"] = _init_dense_block(gen, cfg, device)
    return params


def param_count(params: Params) -> int:
    return sum(t.numel() for t in tr.tree_leaves(params))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    if not cfg.use_rope:
        raise NotImplementedError("sinusoidal positions (encdec) are "
                                  "ROADMAP A15")
    return params["tok_embed"][tokens].to(L.torch_dtype(cfg.dtype))


def _logits(cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    head = (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return x @ head


def _tokens(batch, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=device).long()


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            intra_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, padded_vocab), aux_loss). ``batch["tokens"]``
    is (B, S) int (numpy or tensor); the run is on the params' device."""
    _check_family(cfg)
    device = params["tok_embed"].device
    x = _embed(cfg, params, _tokens(batch, device))
    aux = torch.zeros((), dtype=torch.float32, device=device)
    layers = params["layers"]
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x = _apply_dense_block(cfg, _layer(layers, i), x)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _apply_ssm_block(cfg, _layer(layers, i), x,
                                 intra_fn=intra_fn)
    else:  # hybrid
        shared = params["shared_block"]
        for g in range(cfg.num_layers // cfg.attn_every):
            for i in range(cfg.attn_every):
                x = _apply_ssm_block(cfg, _layer(layers, g, i), x,
                                     intra_fn=intra_fn)
            x = _apply_dense_block(cfg, shared, x)
    return _logits(cfg, params, x), aux


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross entropy (f32) plus ``aux_weight`` x aux."""
    logits, aux = forward(cfg, params, batch)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None])[..., 0]
    return (lse - picked).mean() + aux_weight * aux


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, seq: int,
                      dtype: Optional[torch.dtype] = None,
                      device: Device = None) -> Params:
    """The per-family decode cache; ``seq`` is the max KV length. Hybrid
    Mamba caches are (groups, attn_every, ...), its KV caches (groups,
    ...): one per application of the shared block."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or L.torch_dtype(cfg.dtype)
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def kv(n):
        return torch.zeros((n, batch, seq, hk, hd), dtype=dt, device=device)

    if cfg.family == "dense":
        return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers)}
    if cfg.family == "ssm":
        return S.init_mamba_cache(cfg, cfg.num_layers, batch, dt, device)
    groups = cfg.num_layers // cfg.attn_every
    mc = S.init_mamba_cache(cfg, groups * cfg.attn_every, batch, dt, device)
    mc = {k: v.reshape((groups, cfg.attn_every) + v.shape[1:])
          for k, v in mc.items()}
    return {**mc, "k": kv(groups), "v": kv(groups)}


def _decode_ssm_block(cfg, lp, x, cache, idx):
    """One Mamba-2 block of a decode step; its cache slots are updated in
    place."""
    h = L.apply_norm(cfg, lp["norm1"], x)
    y, st, cs = S.decode_mamba(cfg, lp["mamba"], h, cache["ssm_state"][idx],
                               cache["conv_state"][idx])
    cache["ssm_state"][idx] = st
    cache["conv_state"][idx] = cs
    return x + y


def _decode_dense_block(cfg, lp, x, cache, idx, pos):
    """One attention block of a decode step; writes its KV slot at pos."""
    h = L.apply_norm(cfg, lp["norm1"], x)
    a, _, _ = L.decode_attention(cfg, lp["attn"], h, cache["k"][idx],
                                 cache["v"][idx], pos)
    x = x + a
    h = L.apply_norm(cfg, lp["norm2"], x)
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens, pos: int) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1) int, pos: int (current length).

    Returns (logits (B, 1, V), cache). The cache is updated in place
    (the reference returns a new one); the returned dict is the same."""
    _check_family(cfg)
    device = params["tok_embed"].device
    pos = int(pos)
    x = _embed(cfg, params, torch.as_tensor(tokens, device=device).long())
    layers = params["layers"]
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x = _decode_dense_block(cfg, _layer(layers, i), x, cache, (i,),
                                    pos)
    elif cfg.family == "ssm":
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
