"""Minimal optimizers over parameter trees of tensors (port of
``repro.optim.optimizers``).

Each optimizer is (init_fn, update_fn):
  init_fn(params)                         -> opt_state
  update_fn(grads, opt_state, params, lr) -> (updates, new_opt_state)
Updates are *subtracted* from params by :func:`apply_updates`. State is
f32 whatever the parameters' dtype: SGD keeps ``mu`` only when its
momentum is nonzero, AdamW ``m``, ``v`` and an int32 step ``t``.

Where the reference builds new arrays, the port updates the state's
buffers and the parameters in place, with the same operations in the
same order, so the numbers are the reference's: ``mu <- momentum * mu
+ g`` is one multiply then one add, as ``momentum * v + g`` is. The
returned state holds the same tensors as the one passed in.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch import tree as tr
from repro_torch.config import TrainConfig

_F32 = torch.float32


def sgd(momentum: float = 0.9, weight_decay: float = 0.0):
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tr.tree_map(
            lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device),
            params)}

    def update(grads, state, params, lr):
        if weight_decay:
            grads = tr.tree_map(
                lambda g, p: g + weight_decay * p.to(g.dtype),
                grads, params)
        if momentum == 0.0:
            # the reference's f32 lr array promotes a bf16 g to f32
            return tr.tree_map(lambda g: lr * g.to(torch.promote_types(
                g.dtype, _F32)), grads), state
        mu = tr.tree_map(lambda v, g: v.mul_(momentum).add_(g.to(_F32)),
                         state["mu"], grads)
        return tr.tree_map(lambda v: lr * v, mu), {"mu": mu}

    return init, update


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=_F32, device=p.device)
        leaves = tr.tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {"m": tr.tree_map(z, params), "v": tr.tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tr.tree_map(
            lambda m_, g: m_.mul_(b1).add_((1 - b1) * g.to(_F32)),
            state["m"], grads)
        v = tr.tree_map(
            lambda v_, g: v_.mul_(b2).add_((1 - b2) * torch.square(
                g.to(_F32))), state["v"], grads)
        tf = t.to(_F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=t.device),
                            tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=t.device),
                            tf)

        def upd_leaf(m_, v_, p):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(_F32)
            return lr * u
        upd = tr.tree_map(upd_leaf, m, v, params)
        return upd, {"m": m, "v": v, "t": t}

    return init, update


def make_optimizer(cfg: TrainConfig):
    if cfg.optimizer == "sgd":
        return sgd(cfg.momentum, cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return adamw(weight_decay=cfg.weight_decay)
    raise ValueError(cfg.optimizer)


def make_lr_schedule(cfg: TrainConfig) -> Callable[[object], torch.Tensor]:
    """step (an int or a tensor) -> the learning rate as a 0-dim f32
    tensor on the CPU, computed in f32 as the reference's jnp schedule."""
    base = cfg.learning_rate

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).detach().to("cpu", _F32)
        if cfg.lr_schedule == "constant":
            return torch.tensor(base, dtype=_F32)
        warm = max(cfg.warmup_steps, 1)
        wfrac = torch.clamp(step / warm, max=1.0)
        if cfg.lr_schedule == "warmup_cosine":
            prog = torch.clamp((step - warm) / max(cfg.total_steps - warm, 1),
                               0.0, 1.0)
            cos = 0.5 * (1 + torch.cos(math.pi * prog))
            return base * wfrac * cos
        if cfg.lr_schedule == "cosine":
            prog = torch.clamp(step / max(cfg.total_steps, 1), 0.0, 1.0)
            return base * 0.5 * (1 + torch.cos(math.pi * prog))
        raise ValueError(cfg.lr_schedule)

    return schedule


def apply_updates(params, updates):
    """``params - updates`` in the params' dtypes, in place: the returned
    tree holds the same tensors as ``params``."""
    return tr.tree_map(lambda p, u: p.sub_(u.to(p.dtype)),
                       params, updates)
