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
(FlashAttention-2's scheme: P recomputed from that logsumexp tile by
tile, dQ by query block, dK/dV by key block and query head with the
heads' partials summed in order, no atomics), which is the
port's counterpart of the reference's XLA autodiff of its plain
attention (the TPU kernel has no backward). The backward takes the
layouts the forward takes (bf16: :func:`bf16_refusal`); a query row with
no valid key (a window shorter than its distance past the last key) is
outside what either kernel matches. Inference calls never ask for the
logsumexp and run as before.

On a CPU tensor each wrapper takes its plain version
(:mod:`repro_torch.kernels.ref`), which autograd differentiates. On a
CUDA tensor it launches the kernel or raises; nothing falls back.
``launches`` counts forward launches and ``bwd_launches`` backward
launches (one a backward call, which is two kernels: dQ with the row
sums D_i, then dK and dV; a third sums bf16 GQA heads), never
plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

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


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward kernel's library, built on first use."""
    lib = _build.load("flash_attention_bwd")
    p = ctypes.c_void_p
    lib.flash_attention_bwd_launch.argtypes = [
        p] * 11 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


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
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # bf16 with GQA: each query head's f32 dK and dV partials, summed in
    # head order by the third kernel
    part = None
    if q.dtype == torch.bfloat16 and H != k.shape[2]:
        part = torch.empty((2, B, k.shape[1], H, q.shape[3]),
                           dtype=torch.float32, device=q.device)
    dims = _dims(q, k, causal, window, q_offset, q, k, v, out, dout)
    lib = _bwd_library()
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

