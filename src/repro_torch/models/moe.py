"""Mixture-of-Experts layer of the port (``repro.models.moe``): top-k
routing with sort-based capacity dispatch.

The dispatch never forms the (tokens, experts, capacity) one-hot:
assignments are sorted by expert, a token's slot within its expert
comes from the sorted order, and each expert's capacity buffer is
filled from those slots. Capacity is ``tokens * k * capacity_factor /
E + 1`` rounded up to 8 (at least 8); an assignment past it goes to the
overflow slot ``E * cap``, which is thrown away, and the token gets no
output from that expert.

Capacity priority is RECENCY, as in the reference: the sort key is
``e * A + (A - 1 - i)`` over the A = tokens * k assignments, so within
an expert the newest assignments keep their slots and the oldest are
dropped when capacity binds. Whether token t is served then depends
only on the tokens after it.

The router is f32 and routes ``x`` promoted to f32. The combine gathers
each assignment's expert output back through the inverse permutation of
the sort and sums a token's k contributions: no scatter-add, so the
card's result does not depend on the order of atomic adds. The expert
FFN is a batched matrix product (``torch.matmul``), as the reference
computes it outside any kernel.

``drops``: a list that, when given, receives each call's number of
dropped assignments as a 0-d int64 tensor on x's device (no sync).

Tensor parallelism (``tp``): where the experts divide the model group a
rank holds ``E / mp`` of them (the router's columns and the expert
FFNs, ``ff`` whole), else every expert with ``ff`` split. The router's
logits are gathered to (tokens, E) in f32 before ``topk``, so every
rank routes, drops and computes the aux loss as the unsplit layer does;
a rank then fills and runs only its own experts' capacity buffers, and
the partial outputs (with a split shared expert's) are summed over the
model group. The gates' gradient is partial on each rank (only its
experts' outputs meet them) and is summed before it reaches the
routing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import _dtype, dense_init

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig, d: int, ff: int,
             device, lead=()) -> Params:
    """Router (d, E) in f32; experts (E, d, ff) / (E, ff, d) in the
    param dtype; ``lead`` prepends stacked layer axes."""
    E = cfg.num_experts
    dt = _dtype(cfg)
    lead = tuple(lead)
    p: Params = {
        "router": dense_init(gen, d, lead + (d, E), torch.float32, device),
        "w_gate": dense_init(gen, d, lead + (E, d, ff), dt, device),
        "w_up": dense_init(gen, d, lead + (E, d, ff), dt, device),
        "w_out": dense_init(gen, ff, lead + (E, ff, d), dt, device),
    }
    if cfg.moe_shared_expert:
        p["shared"] = {
            "w_gate": dense_init(gen, d, lead + (d, ff), dt, device),
            "w_up": dense_init(gen, d, lead + (d, ff), dt, device),
            "w_out": dense_init(gen, ff, lead + (ff, d), dt, device),
        }
    return p


def moe_logical(cfg: ModelConfig) -> Params:
    """The logical axes of :func:`init_moe`'s parameters."""
    lg: Params = {"router": ("embed", "experts"),
                  "w_gate": ("experts", "embed", "ff"),
                  "w_up": ("experts", "embed", "ff"),
                  "w_out": ("experts", "ff", "embed")}
    if cfg.moe_shared_expert:
        lg["shared"] = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                        "w_out": ("ff", "embed")}
    return lg


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = int(tokens * k * cfg.capacity_factor / E) + 1
    return max(8, -(-cap // 8) * 8)  # round up to 8


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
              drops: Optional[List[torch.Tensor]] = None, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y (B,S,d), aux_load_balance_loss ())."""
    B, S, d = x.shape
    if tp is not None and (p["w_gate"].shape[-3] == cfg.num_experts
                           and p["w_gate"].shape[-1] == cfg.d_ff):
        tp = None  # nothing split: the unsplit layer
    xs = x if tp is None else tp.copy(x)
    if cfg.moe_local_dispatch:
        # per-batch-row dispatch: each row has its own capacity
        y, aux = _moe_tokens_batched(cfg, p, x, xs, drops, tp)
        aux = aux.mean()
    else:
        y, aux = _moe_tokens(cfg, p, x.reshape(B * S, d),
                             xs.reshape(B * S, d), drops, tp)
        y = y.reshape(B, S, d)
    shared = None
    if cfg.moe_shared_expert:
        sp = p["shared"]
        if tp is not None and sp["w_out"].shape[-2] != cfg.d_ff:
            # its ff split (so is the layer): one sum for both
            y = y + _shared(sp, xs)
        else:
            shared = _shared(sp, x)
    if tp is not None:
        y = tp.reduce(y)
    return (y if shared is None else y + shared), aux


def _shared(sp: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared expert (llama4)."""
    hs = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
    return hs @ sp["w_out"]


def _router_input(cfg: ModelConfig, p: Params, x, xs):
    """What the router reads: the split branch's input ``xs`` where the
    router's columns are split (their logits are gathered), else x."""
    return xs if p["router"].shape[-1] != cfg.num_experts else x


def _route(cfg: ModelConfig, p: Params, x: torch.Tensor, tp=None):
    """Router probabilities (f32), top-k gates renormalised and expert
    ids, over the last axis of x (..., d). Under ``tp`` (the layer
    split) a split router's logits are gathered, and the gates' partial
    gradient is summed over the model group."""
    logits = x.to(torch.float32) @ p["router"]
    if p["router"].shape[-1] != cfg.num_experts:
        logits = tp.gather(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    if tp is not None:
        gate_vals = tp.copy(gate_vals)
    return probs, gate_vals, expert_ids


def _local_slots(p: Params, cfg: ModelConfig, e_sorted, pos_in_e, keep,
                 cap: int, tp):
    """(the rank's expert count El, the slot of each sorted assignment in
    its El * cap buffers, the overflow slot El * cap for the others, and
    which assignments it serves)."""
    E = cfg.num_experts
    El = p["w_gate"].shape[-3]
    if El == E:
        return El, torch.where(keep, e_sorted * cap + pos_in_e, E * cap), \
            keep
    e0 = tp.index * El
    mine = keep & (e_sorted >= e0) & (e_sorted < e0 + El)
    return El, torch.where(mine, (e_sorted - e0) * cap + pos_in_e,
                           El * cap), mine


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """The expert FFN on (..., E, cap, d) capacity buffers."""
    h = F.silu(xe @ p["w_gate"]) * (xe @ p["w_up"])
    return h @ p["w_out"]


def _recency_order(flat_e: torch.Tensor) -> torch.Tensor:
    """Sort order of assignments (..., A) by (expert, newest first)."""
    A = flat_e.shape[-1]
    newest = (A - 1 - torch.arange(A, device=flat_e.device))
    return torch.argsort(flat_e.long() * A + newest, dim=-1)


def _moe_tokens_batched(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        xs: torch.Tensor, drops=None, tp=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-local dispatch: x (B,S,d) -> (y (B,S,d), aux (B,)); ``xs``
    is x as the split branch's input, ``tp`` given when the layer is
    split (y is then this rank's partial output)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = x.device
    probs, gate_vals, expert_ids = _route(               # (B,S,k)
        cfg, p, _router_input(cfg, p, x, xs), tp)

    me = probs.mean(dim=1)                                  # (B,E)
    ce = torch.zeros((B, E), dtype=torch.float32, device=dev).scatter_add_(
        1, expert_ids.reshape(B, -1),
        torch.full((B, S * k), 1.0 / (S * k), device=dev))
    aux = E * (me * ce).sum(dim=-1)                         # (B,)

    A = S * k
    flat_e = expert_ids.reshape(B, A)
    flat_g = gate_vals.reshape(B, A)
    flat_tok = torch.arange(S, device=dev).repeat_interleave(k)[None] \
        .expand(B, A)
    order = _recency_order(flat_e)
    e_sorted = torch.gather(flat_e, 1, order)
    tok_sorted = torch.gather(flat_tok, 1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, e_sorted, torch.ones_like(e_sorted))
    seg_start = torch.cumsum(counts, 1) - counts
    pos_in_e = torch.arange(A, device=dev)[None] - \
        torch.gather(seg_start, 1, e_sorted)
    cap = _capacity(S, cfg)
    keep = pos_in_e < cap
    if drops is not None:
        drops.append((~keep).sum())
    El, dest, keep = _local_slots(p, cfg, e_sorted, pos_in_e, keep, cap,
                                  tp)

    # scatter only the slot map (kept slots are distinct; the dropped
    # all land on the overflow slot, which is discarded), then move the
    # activations with gathers
    slot_tok = torch.full((B, El * cap + 1), S, dtype=torch.long,
                          device=dev)
    slot_tok.scatter_(1, dest, torch.where(keep, tok_sorted, S))
    x_pad = torch.cat([xs, xs.new_zeros((B, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1, slot_tok[:, :-1, None].expand(-1, -1, d)
                      ).reshape(B, El, cap, d)
    ye = _experts(p, xe)

    got = torch.cat([ye.reshape(B, El * cap, d), ye.new_zeros((B, 1, d))],
                    dim=1)
    per_assign = torch.gather(got, 1, dest[..., None].expand(-1, -1, d)) * \
        torch.gather(flat_g, 1, order)[..., None].to(x.dtype)
    # un-sort with a gather (inverse permutation), then sum k contributions
    inv_order = torch.argsort(order, dim=1)
    per_tok = torch.gather(per_assign, 1,
                           inv_order[..., None].expand(-1, -1, d))
    return per_tok.reshape(B, S, k, d).sum(dim=2), aux


def _moe_tokens(cfg: ModelConfig, p: Params, xt: torch.Tensor,
                xs: torch.Tensor, drops=None, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global dispatch: xt (T,d) -> (y (T,d), aux ()); ``xs`` and ``tp``
    as :func:`_moe_tokens_batched`'s."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = xt.device
    probs, gate_vals, expert_ids = _route(               # (T,k)
        cfg, p, _router_input(cfg, p, xt, xs), tp)

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)                                  # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, expert_ids.reshape(-1),
        torch.full((T * k,), 1.0 / (T * k), device=dev))
    aux = E * (me * ce).sum()

    # ---- sort-based dispatch ----
    A = T * k
    flat_e = expert_ids.reshape(A)
    flat_g = gate_vals.reshape(A)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = _recency_order(flat_e)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    # position within expert = index - start-of-segment
    counts = torch.zeros((E,), dtype=torch.long, device=dev).scatter_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(A, device=dev) - seg_start[e_sorted]
    cap = _capacity(T, cfg)
    keep = pos_in_e < cap
    if drops is not None:
        drops.append((~keep).sum())
    El, dest, keep = _local_slots(p, cfg, e_sorted, pos_in_e, keep, cap,
                                  tp)

    # the dropped rows all write the overflow slot, which is discarded
    buf = xs.new_zeros((El * cap + 1, d))
    buf[dest] = xs[tok_sorted] * keep[:, None].to(xs.dtype)
    ye = _experts(p, buf[:-1].reshape(El, cap, d))          # (El,cap,d)

    # ---- combine: un-sort with the inverse permutation, sum over k ----
    got = torch.cat([ye.reshape(El * cap, d), ye.new_zeros((1, d))])
    per_assign = got[dest] * flat_g[order][:, None].to(xt.dtype)
    per_tok = per_assign[torch.argsort(order)]
    return per_tok.reshape(T, k, d).sum(dim=1), aux
