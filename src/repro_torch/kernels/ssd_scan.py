"""The Mamba-2 SSD intra-chunk block on the card.

The full-sequence forward of every Mamba-2 block (``models.ssm.
ssd_chunked``) takes its intra-chunk block here on a CUDA tensor: one
launch of ``csrc/ssd_scan.cu`` (a hand-written Hopper kernel, built for
``sm_90a``) per call, over every (chunk, head). Per chunk, with ``cum =
cumsum(a)``:

    L[i,j]   = exp(cum_i - cum_j)            (i >= j, else 0)
    y_intra  = (C Bᵀ ∘ L ∘ dt_j) X
    state    = (B ∘ exp(cum_end - cum) ∘ dt)ᵀ X

It replaces the Pallas TPU kernel ``repro.kernels.ssd_scan``
``ssd_intra_chunk`` and its ``make_intra_fn`` adapter. The inter-chunk
recurrence stays plain torch in ``ssd_chunked``, as in the reference,
and reads the chunk states the kernel wrote.

- :func:`ssd_intra_chunk` — x (BK, H, C, P), a/dt (BK, H, C), B/C
  (BK, C, N); returns (y_intra (BK, H, C, P), states (BK, H, N, P)), f32.
- :func:`make_intra_states_fn` — the ``intra_states_fn`` hook of
  ``ssd_chunked``, what it takes on a CUDA tensor: (xc (B, K, C, H, P),
  a_t (B, K, H, C), Bc/Cc (B, K, C, N), dtc (B, K, C, H)) -> (y_intra (B,
  K, C, H, P), states (B, K, H, N, P)) f32. On the card the kernel reads
  and writes those layouts through strides (no transpose).
- :func:`make_intra_fn` — the ``intra_fn`` hook (the reference's
  adapter): the same arguments -> y_intra only; the states the kernel
  computes are dropped, as the reference's adapter drops them.

x, B and C are f32 or bf16 (one dtype); a and dt are up-cast to f32,
which is exact. bf16 runs on the tensor cores and takes only 16-byte
aligned x, B and C whose strides are multiples of 8 elements (and
writes 16-byte aligned outputs with strides that are multiples of 4,
as the wrappers allocate them); the launch of any other bf16 layout
raises. On a CPU tensor each wrapper takes its plain version
(:mod:`repro_torch.kernels.ref`). On a CUDA tensor it launches the
kernel or raises; nothing falls back. The kernel has no backward (nor
has the TPU kernel): a CUDA input that requires grad raises
NotImplementedError. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: shapes the kernel takes
CHUNKS = (64, 128, 192, 256)
STATE_SIZES = (16, 32, 64, 128)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel; reset it to 0 before a run whose
#: launches are to be read
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("ssd_scan")
    p = ctypes.c_void_p
    lib.ssd_intra_chunk_launch.argtypes = [
        p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, p]
    lib.ssd_intra_chunk_launch.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, a: torch.Tensor, Bc: torch.Tensor,
            Cc: torch.Tensor, dt: torch.Tensor, y: torch.Tensor,
            st: torch.Tensor) -> None:
    """y, st = the intra-chunk block on the card. x/y (BK, H, C, P), a/dt
    (BK, H, C), B/C (BK, C, N), st (BK, H, N, P): any strides, the last
    axis of x, B, C, y and st contiguous."""
    global launches
    if any(t.requires_grad for t in (x, a, Bc, Cc, dt)):
        raise NotImplementedError(
            "ssd_intra_chunk has no backward yet (nor has the TPU kernel), "
            "so ssm and hybrid models do not train on the card: ROADMAP "
            "A17 (B5's backward, then ssm/hybrid training)")
    for t in (a, Bc, Cc, dt, y, st):
        if t.device != x.device:
            raise ValueError(f"ssd_intra_chunk: tensors on {x.device} and "
                             f"{t.device}")
    if x.dtype not in _DTYPE_CODE or {Bc.dtype, Cc.dtype} != {x.dtype}:
        raise ValueError(f"ssd_intra_chunk kernel takes x, B, C of one "
                         f"dtype, f32 or bf16; got {x.dtype}, {Bc.dtype}, "
                         f"{Cc.dtype}")
    if any(t.dtype != torch.float32 for t in (a, dt, y, st)):
        raise ValueError("ssd_intra_chunk kernel takes a, dt, y and the "
                         "states in f32")
    if any(t.stride(-1) != 1 for t in (x, Bc, Cc, y, st)):
        raise ValueError("ssd_intra_chunk kernel needs a contiguous last "
                         "axis of x, B, C and the outputs")
    BK, H, C, P = x.shape
    N = Bc.shape[-1]
    if C not in CHUNKS or N not in STATE_SIZES or P not in HEAD_DIMS or \
            BK > 65535:
        raise ValueError(f"ssd_intra_chunk kernel takes C in {CHUNKS}, N "
                         f"in {STATE_SIZES}, P in {HEAD_DIMS} and BK <= "
                         f"65535; got x {tuple(x.shape)}, N {N}")
    dims = [BK, H, C, P, N]
    for t in (x, a, dt):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    for t in (Bc, Cc):
        dims += [t.stride(0), t.stride(1)]
    for t in (y, st):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_intra_chunk_launch(
            x.data_ptr(), a.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            dt.data_ptr(), y.data_ptr(), st.data_ptr(),
            (ctypes.c_longlong * len(dims))(*dims), _DTYPE_CODE[x.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {rc} (x {tuple(x.shape)} {x.dtype}, N "
                           f"{N}; bf16 takes only 16-byte aligned x, B "
                           f"and C with strides that are multiples of 8)")
    launches += 1


def ssd_intra_chunk(x: torch.Tensor, a_t: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, dtc: torch.Tensor):
    """x: (BK, H, C, P); a_t/dtc: (BK, H, C); Bc/Cc: (BK, C, N). Returns
    (y_intra (BK, H, C, P) f32, states (BK, H, N, P) f32)."""
    if x.device.type == "cpu":
        return _ref.ssd_intra_chunk_ref(x, a_t, Bc, Cc, dtc)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: no kernel for {x.device}")
    BK, H, C, P = x.shape
    N = Bc.shape[-1]
    y = torch.empty((BK, H, C, P), dtype=torch.float32, device=x.device)
    st = torch.empty((BK, H, N, P), dtype=torch.float32, device=x.device)
    _launch(x, a_t.float(), Bc, Cc, dtc.float(), y, st)
    return y, st


def _intra_kernel(xc, a_t, Bc, Cc, dtc):
    """The adapters' launch: the kernel reads the (B,K,C,H,P) layout and
    writes y_intra in it through strides, and the states as (B,K,H,N,P).
    """
    if xc.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: no kernel for {xc.device}")
    B, K, C, H, P = xc.shape
    N = Bc.shape[-1]
    y = torch.empty((B, K, C, H, P), dtype=torch.float32, device=xc.device)
    st = torch.empty((B, K, H, N, P), dtype=torch.float32, device=xc.device)
    _launch(xc.permute(0, 1, 3, 2, 4).reshape(B * K, H, C, P),
            a_t.reshape(B * K, H, C).float(), Bc.reshape(B * K, C, N),
            Cc.reshape(B * K, C, N),
            dtc.permute(0, 1, 3, 2).reshape(B * K, H, C).float(),
            y.view(B * K, C, H, P).transpose(1, 2), st.view(B * K, H, N, P))
    return y, st


def make_intra_states_fn():
    """Adapter for ``models.ssm.ssd_chunked``'s ``intra_states_fn`` hook:
    (xc (B,K,C,H,P), a_t (B,K,H,C), Bc (B,K,C,N), Cc, dtc (B,K,C,H))
    -> (y_intra (B,K,C,H,P), states (B,K,H,N,P)) f32, one launch."""
    def intra(xc, a_t, Bc, Cc, dtc):
        if xc.device.type == "cpu":
            return _ref.ssd_intra_states_fn_ref(xc, a_t, Bc, Cc, dtc)
        return _intra_kernel(xc, a_t, Bc, Cc, dtc)
    return intra


def make_intra_fn():
    """Adapter matching ``models.ssm.ssd_chunked``'s ``intra_fn`` hook:
    (xc (B,K,C,H,P), a_t (B,K,H,C), Bc (B,K,C,N), Cc, dtc (B,K,C,H))
    -> y_intra (B,K,C,H,P) f32."""
    def intra(xc, a_t, Bc, Cc, dtc):
        if xc.device.type == "cpu":
            return _ref.ssd_intra_fn_ref(xc, a_t, Bc, Cc, dtc)
        return _intra_kernel(xc, a_t, Bc, Cc, dtc)[0]
    return intra
