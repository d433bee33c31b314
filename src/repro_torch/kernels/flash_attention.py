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

On a CPU tensor each wrapper takes its plain version
(:mod:`repro_torch.kernels.ref`). On a CUDA tensor it launches the
kernel or raises; nothing falls back. The kernel has no backward (nor
has the TPU kernel): a CUDA input that requires grad raises
NotImplementedError. ``launches`` counts kernel launches (not
plain-version calls).
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

#: launches of the CUDA kernel; reset it to 0 before a run whose
#: launches are to be read
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("flash_attention")
    p = ctypes.c_void_p
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, p]
    lib.flash_attention_launch.restype = ctypes.c_int
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, causal: bool, window: int,
            q_offset: int) -> None:
    """out = attention(q, k, v) on the card; all four in (B, S, H, D)
    layout (any strides, last axis contiguous), k and v with Hkv heads."""
    global launches
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward (nor has the TPU kernel); "
            "LM training arrives with a later slice (ROADMAP A15)")
    for t in (k, v, out):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and "
                             f"{t.device}")
    if q.dtype not in _DTYPE_CODE or {k.dtype, v.dtype, out.dtype} != \
            {q.dtype}:
        raise ValueError(f"flash_attention kernel takes q, k, v of one "
                         f"dtype, f32 or bf16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention kernel needs a contiguous last "
                         "axis")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM or H % Hkv or q_offset < 0 or B * H > 65535:
        raise ValueError(f"flash_attention kernel takes D <= "
                         f"{MAX_HEAD_DIM}, H a multiple of Hkv, q_offset "
                         f">= 0 and B*H <= 65535; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, q_offset {q_offset}")
    if q.dtype == torch.bfloat16:
        why = bf16_refusal(q, k, v, out)
        if why is not None:
            raise ValueError(f"flash_attention: the bf16 kernel does not "
                             f"take {why}")
    dims = [B, H, Hkv, Sq, Sk, D, int(causal), int(window), int(q_offset)]
    for t in (q, k, v, out):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * len(dims))(*dims), _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype})")
    launches += 1


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
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q[:, :, None], k[:, :, None], v[:, :, None], out[:, :, None],
            causal, window, q_offset)
    return out


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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, window, q_offset)
    return out
