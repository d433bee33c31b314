"""Mamba-2 (SSD, state-space duality) block in PyTorch (port of
``repro.models.ssm``). [arXiv:2405.21060]

Chunked dual form: an intra-chunk quadratic attention-like block plus an
inter-chunk linear state recurrence (a Python loop over chunks). Single
B/C group shared across heads (ngroups=1), per-head scalar A, depthwise
causal conv on (x, B, C).

The intra-chunk block goes through a hook of :func:`ssd_chunked`.
Without one, a CUDA tensor takes the hand-written kernel
(:func:`repro_torch.kernels.ssd_scan.make_intra_states_fn`), whose one
launch also gives the chunk states, and a CPU tensor the plain einsum
path of the reference. Under autograd the kernel's gradients come from
its hand-written backward (``csrc/ssd_scan_bwd.cu``, through
``kernels.ssd_scan._SSDIntraChunk``), so the ssm and hybrid families
train on the card; on the CPU autograd differentiates the einsum path.
The recurrence stays plain torch on both.

Tensor parallelism (``tp``): the reference's logical axes split ``wz``,
``wx``, ``wdt``, ``dt_bias``, ``A_log``, ``D``, ``norm_scale`` and
``wo`` by the inner dimension or its heads, and keep ``wB``, ``wC`` and
the convolution replicated. A rank convolves its own x channels and all
B/C channels, runs the SSD on its heads (B5 at H/mp heads on the card),
takes the gated RMSNorm's mean square over the whole inner dimension (a
model-group sum of its sums of squares) and sums ``wo``'s partial
products. B and C, and the convolution's x weights, are replicated
values that only split branches consume: their gradients are summed
over the model group.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.layers import Device, dense_init, torch_dtype

Params = Dict[str, Any]


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device: Device,
               lead=()) -> Params:
    """Mamba-2 block parameters; ``lead`` prepends stacked layer axes."""
    d = cfg.d_model
    inner = cfg.ssm_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    cw = cfg.ssm_conv_width
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    lead = tuple(lead)
    conv_ch = inner + 2 * N
    return {
        "wz": dense_init(gen, d, lead + (d, inner), dt, device),
        "wx": dense_init(gen, d, lead + (d, inner), dt, device),
        "wB": dense_init(gen, d, lead + (d, N), dt, device),
        "wC": dense_init(gen, d, lead + (d, N), dt, device),
        "wdt": dense_init(gen, d, lead + (d, H), dt, device),
        "dt_bias": torch.zeros(lead + (H,), dtype=f32, device=device),
        "A_log": torch.zeros(lead + (H,), dtype=f32, device=device),
        "D": torch.ones(lead + (H,), dtype=f32, device=device),
        "conv_w": dense_init(gen, cw, lead + (cw, conv_ch), dt, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=device),
        "norm_scale": torch.ones(lead + (inner,), dtype=dt, device=device),
        "wo": dense_init(gen, inner, lead + (inner, d), dt, device),
    }


def mamba_logical() -> Params:
    """The logical axes of :func:`init_mamba`'s parameters."""
    return {"wz": ("embed", "ssm_inner"), "wx": ("embed", "ssm_inner"),
            "wB": ("embed", "state"), "wC": ("embed", "state"),
            "wdt": ("embed", "ssm_heads"), "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "conv_w": ("conv", None), "conv_b": (None,),
            "norm_scale": ("ssm_inner",), "wo": ("ssm_inner", "embed")}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). Returns (y, new_state)
    where state holds the last K-1 inputs for streaming decode."""
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else xp[:, :0]
    return F.silu(y), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) (F.softplus returns x itself above
    its threshold of 20, where the two differ below f32 resolution)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., C). Returns (..., C, C) with out[i,j] = sum_{j<l<=i} a_l,
    -inf above the diagonal."""
    C = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full((), -torch.inf,
                                              device=a.device))


def _intra_plain(xc, a_t, Bc, Cc, dtc) -> torch.Tensor:
    """The reference's einsum path of the intra-chunk block (f32):
    (B,K,C,H,P) y_intra."""
    f32 = torch.float32
    scores = torch.einsum("bkin,bkjn->bkij", Cc.to(f32), Bc.to(f32))
    att = scores[:, :, None] * torch.exp(_segsum(a_t))       # (B,K,H,C,C)
    att = att * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]   # dt_j
    return torch.einsum("bkhij,bkjhp->bkihp", att, xc.to(f32))


def ssd_chunked(x: torch.Tensor, dtv: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                intra_fn=None, intra_states_fn=None):
    """SSD over a full sequence.

    x: (B,S,H,P)  dtv: (B,S,H)  A: (H,) negative  Bm/Cm: (B,S,N)
    Returns (y (B,S,H,P), final_state (B,H,P,N)).

    ``intra_fn`` overrides the intra-chunk computation, as in the
    reference: signature (xc, a_t, Bc, Cc, dtc) -> y_intra per chunk
    batch; the chunk states then come from an einsum. ``intra_states_fn``
    takes the same arguments and returns (y_intra, chunk states
    (B,K,H,N,P)). With neither, a CUDA tensor takes the kernel's
    (``make_intra_states_fn``) and a CPU tensor the plain einsum path.
    """
    f32 = torch.float32
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    K = x.shape[1] // chunk
    xc = x.reshape(Bsz, K, chunk, H, P)
    dtc = dtv.reshape(Bsz, K, chunk, H)
    Bc = Bm.reshape(Bsz, K, chunk, N)
    Cc = Cm.reshape(Bsz, K, chunk, N)
    a = dtc * A  # (B,K,C,H) negative decay logits
    a_t = a.permute(0, 1, 3, 2)  # (B,K,H,C)
    cum = torch.cumsum(a_t, dim=-1)  # (B,K,H,C)
    total = cum[..., -1]  # (B,K,H)

    # ---- intra-chunk (quadratic within chunk) and chunk-final states ----
    if intra_fn is None and intra_states_fn is None and \
            x.device.type != "cpu":
        intra_states_fn = _ssd.make_intra_states_fn()
    if intra_states_fn is not None:
        if intra_fn is not None:
            raise ValueError("ssd_chunked takes intra_fn or "
                             "intra_states_fn, not both")
        y_intra, states = intra_states_fn(xc, a_t, Bc, Cc, dtc)
    else:
        y_intra = (_intra_plain(xc, a_t, Bc, Cc, dtc) if intra_fn is None
                   else intra_fn(xc, a_t, Bc, Cc, dtc))
        decay_to_end = torch.exp(total[..., None] - cum)  # (B,K,H,C)
        w = (decay_to_end * dtc.permute(0, 1, 3, 2)).permute(0, 1, 3, 2)
        states = torch.einsum("bkjn,bkjhp->bkhnp", Bc.to(f32),
                              w[..., None] * xc.to(f32))  # (B,K,H,N,P)

    # ---- inter-chunk recurrence, on (N, P) states ----
    chunk_decay = torch.exp(total)  # (B,K,H)
    s = (torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
         if initial_state is None
         else initial_state.to(f32).transpose(-1, -2))
    prev = []
    for k in range(K):
        prev.append(s)  # the state *entering* chunk k
        s = s * chunk_decay[:, k, :, None, None] + states[:, k]
    prev_states = torch.stack(prev, dim=1)  # (B,K,H,N,P)

    y_inter = torch.einsum("bkin,bkhnp->bkihp", Cc.to(f32), prev_states) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, K * chunk, H, P)
    return y[:, :S].to(x.dtype), s.transpose(-1, -2).contiguous()


def apply_mamba(cfg: ModelConfig, p: Params, u: torch.Tensor,
                intra_fn=None, tp=None) -> torch.Tensor:
    """Full-sequence Mamba-2 block. u: (B,S,d) -> (B,S,d). Under ``tp``
    with the inner dimension split, on this rank's slice of it (its
    ``H / mp`` heads), the output summed over the model group."""
    B_, S, _ = u.shape
    inner, P, N = cfg.ssm_inner, cfg.ssm_head_dim, cfg.ssm_state
    local, H = p["wx"].shape[-1], p["wdt"].shape[-1]
    if H * P != local:
        raise ValueError(f"the inner dimension splits into {local} columns "
                         f"but the SSD heads into {H} of {P}")
    split = tp is not None and local != inner
    us = tp.copy(u) if split else u
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if split:
        # the rank's x channels; the convolution's x weights are
        # replicated and their gradient partial
        lo = tp.index * local
        conv_w = torch.cat([tp.copy(conv_w[:, :inner])[:, lo:lo + local],
                            conv_w[:, inner:]], dim=-1)
        conv_b = torch.cat([tp.copy(conv_b[:inner])[lo:lo + local],
                            conv_b[inner:]])
    z = us @ p["wz"]
    xBC = torch.cat([us @ p["wx"], u @ p["wB"], u @ p["wC"]], dim=-1)
    xBC, _ = _causal_conv(xBC, conv_w, conv_b)
    x, BC = torch.split(xBC, [local, 2 * N], dim=-1)
    # all B/C channels, replicated; only the split SSD consumes them
    Bm, Cm = torch.split(tp.copy(BC) if split else BC, [N, N], dim=-1)
    x = x.reshape(B_, S, H, P)
    dtv = _softplus((us @ p["wdt"]).to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(x, dtv, A, Bm, Cm, cfg.ssm_chunk, intra_fn=intra_fn)
    y = y + (p["D"][:, None] * x.to(torch.float32)).to(y.dtype)
    y = y.reshape(B_, S, local)
    if not split:
        return _gated_out(p, y, z, u.dtype)
    return tp.reduce(_gated_out(p, y, z, u.dtype, tp, inner))


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype, tp=None, inner: int = 0) -> torch.Tensor:
    """Gated RMSNorm (mamba2 style; the norm in f32, cast to u's dtype),
    then the output projection. Under ``tp`` ``y`` holds the rank's
    ``y.shape[-1]`` of the ``inner`` columns: the mean square is the
    model group's sum of squares over ``inner``, and the projection a
    partial product."""
    y = y * F.silu(z)
    if tp is None:
        ms = y.to(torch.float32).square().mean(dim=-1, keepdim=True)
    else:
        ms = tp.sum(y.to(torch.float32).square().sum(dim=-1, keepdim=True)
                    ) / inner
    y = (y.to(torch.float32) * torch.rsqrt(ms + 1e-5)).to(dtype)
    y = y * p["norm_scale"]
    return y @ p["wo"]


def init_mamba_cache(cfg: ModelConfig, num_layers: int, batch: int,
                     dtype: torch.dtype, device: Device) -> Dict[str, Any]:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.ssm_inner + 2 * N
    return {
        "ssm_state": torch.zeros((num_layers, batch, H, P, N),
                                 dtype=torch.float32, device=device),
        "conv_state": torch.zeros(
            (num_layers, batch, cfg.ssm_conv_width - 1, conv_ch),
            dtype=dtype, device=device),
    }


def decode_mamba(cfg: ModelConfig, p: Params, u: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """Single-token recurrent update. u: (B,1,d). ssm_state: (B,H,P,N).
    Returns (out (B,1,d), new ssm_state, new conv_state)."""
    B_ = u.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = cfg.ssm_inner
    f32 = torch.float32
    z = u @ p["wz"]
    xBC = torch.cat([u @ p["wx"], u @ p["wB"], u @ p["wC"]], dim=-1)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    x, Bm, Cm = torch.split(xBC[:, 0], [inner, N, N], dim=-1)
    x = x.reshape(B_, H, P).to(f32)
    dtv = _softplus((u[:, 0] @ p["wdt"]).to(f32) + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A)  # (B,H)
    # einsum("bn,bh,bhp->bhpn") and einsum("bn,bhpn->bhp"), written out:
    # a decode step is host-bound and einsum's path search costs more
    # than the arithmetic
    upd = (dtv[..., None] * x)[..., None] * Bm.to(f32)[:, None, None, :]
    ssm_state = ssm_state * decay[..., None, None] + upd
    y = (ssm_state @ Cm.to(f32)[:, None, :, None])[..., 0]
    y = y + p["D"][:, None] * x
    y = y.reshape(B_, 1, inner).to(u.dtype)
    return _gated_out(p, y, z, u.dtype), ssm_state, conv_state
