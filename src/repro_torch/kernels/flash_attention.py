"""Flash attention on the card: the prefill's attention core.

The full-sequence forward (``models.layers.attention_core``) runs its
attention here on a CUDA tensor: one launch of ``csrc/flash_attention.cu``
(a hand-written Hopper kernel, built for ``sm_90a``) per attention call,
an online softmax over key tiles that never forms the S x S scores.
It replaces the Pallas TPU kernel ``repro.kernels.flash_attention``
``flash_attention`` and its GQA adapter ``ops.flash_attention_bshd``.

- :func:`flash_attention` — ``(BH, S, D)`` q, k, v with kv heads already
  expanded, as the TPU kernel takes them.
- :func:`flash_attention_bshd` — the model's ``(B, S, H, D)`` layout with
  ``Hkv`` kv heads. On the card the kernel reads the layout through its
  strides and maps head h to kv head ``h // (H // Hkv)``: no repeat and
  no transpose is materialised.

Masking follows the reference: causal, a sliding ``window`` (0 = none)
and a ``q_offset`` for the query positions; masked scores are -1e30.
Inputs are f32 or bf16; sums and the softmax run in f32 and the output
has q's dtype. f32 runs on the CUDA cores. bf16 runs on the tensor cores
(``wgmma``) fed by TMA over 4-D tensor maps of the (B, S, H, D) layout,
and takes only the layouts :func:`bf16_refusal` passes: a head size that
is a multiple of 16, 16-byte aligned tensors, and strides that are
positive multiples of 8 elements on every axis longer than 1 (an
expanded, stride-0 axis is refused). Any other bf16 layout raises; no
other kernel takes it.

Training: on a CUDA tensor both wrappers go through one
``torch.autograd.Function``. Its forward launches the kernel and, when
an input requires grad, has it also write each query row's logsumexp
(f32, (B, H, Sq)); its backward launches ``csrc/flash_attention_bwd.cu``
(P recomputed from that logsumexp tile by tile, dQ by query block,
dK/dV by key block, no atomics; bf16 as the forward, TMA-fed ``wgmma``,
a kv head's query heads in one block or in groups whose partials a
third kernel sums in head order), which is the port's counterpart of
the reference's XLA autodiff of its plain attention (the TPU kernel has
no backward). The backward takes the
layouts the forward takes (bf16: :func:`bf16_refusal`); a query row with
no valid key (a window shorter than its distance past the last key) is
outside what either kernel matches. Inference calls never ask for the
logsumexp and run as before.

On a CPU tensor each wrapper takes its plain version
(:mod:`repro_torch.kernels.ref`), which autograd differentiates. On a
CUDA tensor it launches the kernel or raises; nothing falls back.
``launches`` counts forward launches and ``bwd_launches`` backward
launches (one a backward call, which is two kernels: dQ with the row
sums D_i, then dK and dV; a third sums bf16 GQA head groups), never
plain-version calls.

:func:`fwd_counts` and :func:`bwd_counts` give the bytes a call must
move and the operations it must do, from its shapes: what
``chip_smoke.py`` prices the kernels' bounds with, and what the
shape-only twin :func:`attend_shape` adds to ``kernels.twin_counts``.
The twin runs on ``meta`` tensors under ``flags.analysis`` only
(``models.layers.attention_core`` routes there; the wrappers here still
refuse ``meta``): it returns empty outputs of the kernel's shapes and
saves what the kernel's Function saves, so that the dry-run
(``launch.dryrun``) sees the program's memory and work without a card.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import kernels as _kernels
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: largest head size the kernel takes
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA forward and backward kernels; reset them to 0
#: before a run whose launches are to be read
launches = 0
bwd_launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("flash_attention")
    p = ctypes.c_void_p
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/flash_attention_bwd.cu``) with its C
    signatures."""
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = [
        p] * 11 + [ctypes.POINTER(ll), ctypes.c_int, p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_delta_floats.argtypes = [ll] * 3
    lib.flash_attention_bwd_delta_floats.restype = ll
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward kernel's library, built on first use."""
    return bind_bwd(_build.load("flash_attention_bwd"))


def bf16_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor) -> str | None:
    """Why the bf16 kernel cannot take these (B, S, H, D) tensors, or None
    when it can: its TMA tensor maps need D a multiple of 16, 16-byte
    aligned base pointers and, on every axis longer than 1, a stride that
    is a positive multiple of 8 elements (16 bytes)."""
    D = q.shape[-1]
    if D % 16:
        return f"a head size of {D} (not a multiple of 16)"
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16:
            return f"{name} at an address that is not 16-byte aligned"
        for axis in range(3):
            st = t.stride(axis)
            if t.shape[axis] > 1 and (st <= 0 or st % 8):
                return (f"{name} with stride {st} on axis {axis} (not a "
                        f"positive multiple of 8 elements)")
    return None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, q_offset: int, *more: torch.Tensor) -> None:
    """Raise on what the kernels do not take (all in (B, S, H, D)
    layout, k and v with Hkv heads)."""
    for t in (k, v, out) + more:
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and "
                             f"{t.device}")
    if q.dtype not in _DTYPE_CODE or {t.dtype for t in (k, v, out) + more
                                      } != {q.dtype}:
        raise ValueError(f"flash_attention kernel takes q, k, v of one "
                         f"dtype, f32 or bf16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out) + more):
        raise ValueError("flash_attention kernel needs a contiguous last "
                         "axis")
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if D > MAX_HEAD_DIM or H % Hkv or q_offset < 0 or B * H > 65535:
        raise ValueError(f"flash_attention kernel takes D <= "
                         f"{MAX_HEAD_DIM}, H a multiple of Hkv, q_offset "
                         f">= 0 and B*H <= 65535; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, q_offset {q_offset}")
    if q.dtype == torch.bfloat16:
        why = bf16_refusal(q, k, v, out)
        for t in more:
            why = why or bf16_refusal(t, t, t, t)
        if why is not None:
            raise ValueError(f"flash_attention: the bf16 kernel does not "
                             f"take {why}")


def _dims(q, k, causal, window, q_offset, *tensors) -> list:
    B, Sq, H, D = q.shape
    dims = [B, H, k.shape[2], Sq, k.shape[1], D, int(causal), int(window),
            int(q_offset)]
    for t in tensors:
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    return dims


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, causal: bool, window: int, q_offset: int,
            lse: torch.Tensor | None = None) -> None:
    """out = attention(q, k, v) on the card; all four in (B, S, H, D)
    layout (any strides, last axis contiguous), k and v with Hkv heads.
    ``lse``, a contiguous (B, H, Sq) f32 tensor, also receives each
    query row's logsumexp."""
    global launches
    _check(q, k, v, out, q_offset)
    dims = _dims(q, k, causal, window, q_offset, q, k, v, out)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            (ctypes.c_longlong * len(dims))(*dims), _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype})")
    launches += 1


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                causal: bool, window: int, q_offset: int):
    """(dq, dk, dv) of attention(q, k, v) on the card, from the forward's
    output ``out`` and logsumexp ``lse`` and the output's gradient
    ``dout``; all in (B, S, H, D) layout. dq is (B, Sq, H, D) and dk, dv
    (B, Sk, Hkv, D), contiguous, of q's dtype."""
    global bwd_launches
    _check(q, k, v, out, q_offset, dout)
    B, Sq, H, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    lib = _bwd_library()
    # each row's D_i (f32), or its (lse, D_i) padded to the bf16 dQ
    # kernel's blocks, at the length the library asks for
    delta = torch.empty(lib.flash_attention_bwd_delta_floats(B, H, Sq),
                        dtype=torch.float32, device=q.device)
    # bf16 with GQA: f32 dK and dV partials of groups of a kv head's
    # query heads (at most one group a head), summed in head order by
    # the third kernel
    part = None
    if q.dtype == torch.bfloat16 and H != k.shape[2]:
        part = torch.empty((2, B, k.shape[1], H, q.shape[3]),
                           dtype=torch.float32, device=q.device)
    dims = _dims(q, k, causal, window, q_offset, q, k, v, out, dout) + [
        delta.numel()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            (ctypes.c_longlong * len(dims))(*dims), _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype})")
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention on the card with the hand-written backward: (B, S, H, D)
    q and (B, Sk, Hkv, D) k, v -> contiguous (B, Sq, H, D). Its forward
    also writes the logsumexp the backward recomputes P from."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        _launch(q, k, v, out, causal, window, q_offset, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:
            dout = dout.clone()  # a fresh block is 16-byte aligned
        dq, dk, dv = _launch_bwd(q, k, v, out, dout, lse, *ctx.mask)
        return dq, dk, dv, None, None, None


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, q_offset: int) -> torch.Tensor:
    """Attention of (B, S, H, D) CUDA tensors: through the autograd
    Function (forward with the logsumexp, then the backward kernel) when
    autograd records and an input requires grad, else one forward
    launch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, window, q_offset)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D), k/v: (BH, Sk, D), kv heads pre-expanded. Returns
    (BH, Sq, D) in q's dtype."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _attend(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                   window, q_offset)[:, :, 0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """The (B, S, H, D) adapter with GQA, matching
    ``models.layers.attention_core``: q (B, Sq, H, D), k/v (B, Sk, Hkv,
    D) -> (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return _ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                             window=window,
                                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _attend(q, k, v, causal, window, q_offset)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """(o, lse) of the (B, S, H, D) adapter: the forward as the training
    path launches it, with each query row's (B, H, Sq) f32 logsumexp, so
    that the logsumexp can be held against its plain version."""
    if q.device.type == "cpu":
        return _ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                            window=window,
                                            q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, Sq, H, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, causal, window, q_offset, lse)
    return out, lse



# ---------------------------------------------------------------------------
# counts, and the shape-only twin of the dry-run
# ---------------------------------------------------------------------------

def attended_pairs(Sq: int, Sk: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    """The (query, key) pairs a mask lets through, query i at position
    ``q_offset + i``: what the attention's two products must compute."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def fwd_counts(B: int, Sq: int, Sk: int, H: int, Hkv: int, D: int,
               causal: bool, window: int = 0, q_offset: int = 0,
               itemsize: int = 2):
    """(bytes, operations) of a forward call: q and o (H heads) and k, v
    (Hkv heads) moved once at ``itemsize`` bytes; the two products over
    the attended pairs of every head."""
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D)
    flops = 2 * 2 * B * H * D * attended_pairs(Sq, Sk, causal, window,
                                               q_offset)
    return nbytes, flops


def bwd_counts(B: int, Sq: int, Sk: int, H: int, Hkv: int, D: int,
               causal: bool, window: int = 0, q_offset: int = 0,
               itemsize: int = 2):
    """(bytes, operations) of a backward call: q, o, dO and dq (H heads),
    k, v, dk and dv (Hkv heads) moved once at ``itemsize`` bytes and the
    f32 logsumexp read once; the five products over the attended
    pairs."""
    nbytes = itemsize * (4 * B * Sq * H * D + 4 * B * Sk * Hkv * D) + \
        B * H * Sq * 4
    flops = 5 * 2 * B * H * D * attended_pairs(Sq, Sk, causal, window,
                                               q_offset)
    return nbytes, flops


def _mask_counts(fn, q, k, mask):
    B, Sq, H, D = q.shape
    return fn(B, Sq, k.shape[1], H, k.shape[2], D, *mask,
              itemsize=q.element_size())


class _FlashAttentionShape(torch.autograd.Function):
    """B4 on ``meta`` tensors: the outputs' shapes and dtypes, the saved
    tensors of ``_FlashAttention`` (q, k, v, o and the f32 logsumexp),
    the backward's outputs and its bf16 GQA partials, and the kernels'
    counts; no values."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        mask = (causal, window, q_offset)
        _kernels.count_twin(*_mask_counts(fwd_counts, q, k, mask))
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        _kernels.count_twin(*_mask_counts(bwd_counts, q, k, ctx.mask))
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
        dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
        if q.dtype == torch.bfloat16 and q.shape[2] != k.shape[2]:
            # the f32 dK and dV partials of the head groups, freed on
            # return (``_launch_bwd``)
            torch.empty((2, q.shape[0], k.shape[1], q.shape[2], q.shape[3]),
                        dtype=torch.float32, device=q.device)
        return dq, dk, dv, None, None, None


def attend_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 q_offset: int = 0) -> torch.Tensor:
    """B4's shape-only twin, for ``meta`` (B, S, H, D) tensors under
    ``flags.analysis``: as :func:`flash_attention_bshd` on the card (the
    autograd Function when an input requires grad, else one forward),
    with empty outputs and the kernels' counts added to
    ``kernels.twin_counts``."""
    if q.device.type != "meta":
        raise ValueError(f"attend_shape: meta tensors only, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionShape.apply(q, k, v, causal, window, q_offset)
    _kernels.count_twin(*_mask_counts(fwd_counts, q, k,
                                      (causal, window, q_offset)))
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)
