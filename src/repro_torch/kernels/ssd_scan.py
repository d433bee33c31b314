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
(:mod:`repro_torch.kernels.ref`), which autograd differentiates. On a
CUDA tensor it launches the kernel or raises; nothing falls back.

Training: on a CUDA tensor that requires grad (autograd recording) the
wrappers go through ``_SSDIntraChunk``, a ``torch.autograd.Function``
whose forward is one launch of the kernel above (saving its inputs) and
whose backward is one launch of ``csrc/ssd_scan_bwd.cu``, B5's backward
(the TPU kernel has none; the reference trains through XLA's autodiff
of its einsum path): dx in x's type and layout, da and ddt in f32, dB
and dC summed over the heads in head order (no atomics), and a states
gradient of None (``make_intra_fn`` drops the states) taken as none.
``launches`` counts forward launches and ``bwd_launches`` backward
launches (one a backward call, which is three kernels: the gradients of
a (chunk, 64-wide column tile, head group), with D = Σ_h dS summed over
the group's heads on chip; dB and dC from the groups' partials; da).

:func:`fwd_counts` and :func:`bwd_counts` give the bytes a call must
move and the operations it must do, from its shapes: what
``chip_smoke.py`` prices the kernels' bounds with, and what the
shape-only twin :func:`intra_states_shape` adds to
``kernels.twin_counts``. The twin runs on ``meta`` tensors under
``flags.analysis`` only (``models.ssm.ssd_chunked`` routes there; the
wrappers here still refuse ``meta``): it returns empty outputs of the
kernel's shapes, laid out as the adapter's, and saves what
``_SSDIntraChunk`` saves, so that the dry-run (``launch.dryrun``) sees
the program's memory and work without a card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels as _kernels
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: shapes the kernel takes
CHUNKS = (64, 128, 192, 256)
STATE_SIZES = (16, 32, 64, 128)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA forward and backward kernels; reset them to 0
#: before a run whose launches are to be read
launches = 0
bwd_launches = 0


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


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of a build of ``csrc/ssd_scan_bwd.cu`` (also a
    variant's, for ``kernel_ablations.py``)."""
    p = ctypes.c_void_p
    ll = ctypes.c_longlong
    lib.ssd_scan_bwd_workspace.argtypes = [ll, ll, ll, ll, ctypes.c_int]
    lib.ssd_scan_bwd_workspace.restype = ll
    lib.ssd_scan_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, p,
        ctypes.POINTER(ll), ctypes.c_int, p]
    lib.ssd_scan_bwd_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The backward's library, built on first use, with its C
    signatures."""
    return bind_bwd(_build.load("ssd_scan_bwd"))


def _launch(x: torch.Tensor, a: torch.Tensor, Bc: torch.Tensor,
            Cc: torch.Tensor, dt: torch.Tensor, y: torch.Tensor,
            st: torch.Tensor) -> None:
    """y, st = the intra-chunk block on the card. x/y (BK, H, C, P), a/dt
    (BK, H, C), B/C (BK, C, N), st (BK, H, N, P): any strides, the last
    axis of x, B, C, y and st contiguous."""
    global launches
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


def _new_like(x: torch.Tensor, dtype: torch.dtype, last: int):
    """An empty (BK, H, C, last) tensor of ``dtype`` laid out as x is: a
    view of (BK, C, H, last) where x is one (the model's layout), else
    contiguous."""
    BK, H, C, _ = x.shape
    if H > 1 and x.stride(1) < x.stride(2):
        return torch.empty((BK, C, H, last), dtype=dtype,
                           device=x.device).transpose(1, 2)
    return torch.empty((BK, H, C, last), dtype=dtype, device=x.device)


def _forward(x, a, Bc, Cc, dt):
    """(y, states) of one forward launch on (BK, H, C, P) CUDA views, y
    laid out as x is."""
    BK, H, C, P = x.shape
    y = _new_like(x, torch.float32, P)
    st = torch.empty((BK, H, Bc.shape[-1], P), dtype=torch.float32,
                     device=x.device)
    _launch(x, a, Bc, Cc, dt, y, st)
    return y, st


def _launch_bwd(x: torch.Tensor, a: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor, dt: torch.Tensor, dy: torch.Tensor,
                dst):
    """(dx, da, dB, dC, ddt) of the intra-chunk block on the card: B5's
    backward, one call of ``csrc/ssd_scan_bwd.cu``. x (BK, H, C, P), a/dt
    (BK, H, C) f32, B/C (BK, C, N), dy (BK, H, C, P) f32, dst (BK, H, N,
    P) f32 or None: x, a, B, C and dt as the forward's launch took them
    (``_launch`` checked them), dy and dst of any strides. dx comes back
    in x's type and layout, dB and dC in B's and C's type, da and ddt
    f32."""
    global bwd_launches
    BK, H, C, P = x.shape
    N = Bc.shape[-1]
    dy, dst = (None if t is None else t if t.stride(-1) == 1 else
               t.contiguous() for t in (dy, dst))
    dx = _new_like(x, x.dtype, P)
    da = torch.empty((BK, H, C), dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(da)
    dB = torch.empty((BK, C, N), dtype=Bc.dtype, device=x.device)
    dC = torch.empty((BK, C, N), dtype=Cc.dtype, device=x.device)
    lib = _bwd_library()
    ws = torch.empty(lib.ssd_scan_bwd_workspace(BK, H, C, N,
                                                int(dst is not None)),
                     dtype=torch.float32, device=x.device)
    dims = [BK, H, C, P, N]
    for t in (x, a, dt):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    for t in (Bc, Cc):
        dims += [t.stride(0), t.stride(1)]
    for t in (dy, dst if dst is not None else dy, dx):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_bwd_launch(
            x.data_ptr(), a.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            dt.data_ptr(), dy.data_ptr(),
            None if dst is None else dst.data_ptr(), dx.data_ptr(),
            da.data_ptr(), dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(),
            ws.data_ptr(), (ctypes.c_longlong * len(dims))(*dims),
            _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk backward launch failed: CUDA "
                           f"error {rc} (x {tuple(x.shape)} {x.dtype}, N "
                           f"{N}; bf16 takes only 16-byte aligned x with "
                           f"strides that are multiples of 8)")
    bwd_launches += 1
    return dx, da, dB, dC, ddt


class _SSDIntraChunk(torch.autograd.Function):
    """The intra-chunk block on the card with the hand-written backward:
    x (BK, H, C, P), a/dt (BK, H, C) f32, B/C (BK, C, N) -> (y_intra
    (BK, H, C, P), states (BK, H, N, P)) f32, y laid out as x is
    (``_new_like``)."""

    @staticmethod
    def forward(ctx, x, a, Bc, Cc, dt):
        y, st = _forward(x, a, Bc, Cc, dt)
        ctx.save_for_backward(x, a, Bc, Cc, dt)
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dst):
        x, a, Bc, Cc, dt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return _launch_bwd(x, a, Bc, Cc, dt, dy, dst)


def _intra_chunk(x, a, Bc, Cc, dt):
    """(y, states) of (BK, H, C, P) CUDA views: through ``_SSDIntraChunk``
    when autograd records and an input requires grad, else one forward
    launch. y is laid out as x is."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, Bc, Cc, dt)):
        return _SSDIntraChunk.apply(x, a, Bc, Cc, dt)
    return _forward(x, a, Bc, Cc, dt)


def ssd_intra_chunk(x: torch.Tensor, a_t: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, dtc: torch.Tensor):
    """x: (BK, H, C, P); a_t/dtc: (BK, H, C); Bc/Cc: (BK, C, N). Returns
    (y_intra (BK, H, C, P) f32, states (BK, H, N, P) f32)."""
    if x.device.type == "cpu":
        return _ref.ssd_intra_chunk_ref(x, a_t, Bc, Cc, dtc)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: no kernel for {x.device}")
    return _intra_chunk(x, a_t.float(), Bc, Cc, dtc.float())


def _intra_kernel(xc, a_t, Bc, Cc, dtc):
    """The adapters' launch: the kernel reads the (B,K,C,H,P) layout and
    writes y_intra in it through strides, and the states as (B,K,H,N,P).
    """
    B, K, C, H, P = xc.shape
    N = Bc.shape[-1]
    y, st = _intra_chunk(
        xc.permute(0, 1, 3, 2, 4).reshape(B * K, H, C, P),
        a_t.reshape(B * K, H, C).float(), Bc.reshape(B * K, C, N),
        Cc.reshape(B * K, C, N),
        dtc.permute(0, 1, 3, 2).reshape(B * K, H, C).float())
    return (y.transpose(1, 2).reshape(B, K, C, H, P),
            st.reshape(B, K, H, N, P))


def make_intra_states_fn():
    """Adapter for ``models.ssm.ssd_chunked``'s ``intra_states_fn`` hook:
    (xc (B,K,C,H,P), a_t (B,K,H,C), Bc (B,K,C,N), Cc, dtc (B,K,C,H))
    -> (y_intra (B,K,C,H,P), states (B,K,H,N,P)) f32, one launch."""
    def intra(xc, a_t, Bc, Cc, dtc):
        if xc.device.type == "cpu":
            return _ref.ssd_intra_states_fn_ref(xc, a_t, Bc, Cc, dtc)
        if xc.device.type != "cuda":
            raise ValueError(f"ssd_intra_chunk: no kernel for {xc.device}")
        return _intra_kernel(xc, a_t, Bc, Cc, dtc)
    return intra


def make_intra_fn():
    """Adapter matching ``models.ssm.ssd_chunked``'s ``intra_fn`` hook:
    (xc (B,K,C,H,P), a_t (B,K,H,C), Bc (B,K,C,N), Cc, dtc (B,K,C,H))
    -> y_intra (B,K,C,H,P) f32."""
    def intra(xc, a_t, Bc, Cc, dtc):
        if xc.device.type == "cpu":
            return _ref.ssd_intra_fn_ref(xc, a_t, Bc, Cc, dtc)
        if xc.device.type != "cuda":
            raise ValueError(f"ssd_intra_chunk: no kernel for {xc.device}")
        return _intra_kernel(xc, a_t, Bc, Cc, dtc)[0]
    return intra


# ---------------------------------------------------------------------------
# counts, and the shape-only twin of the dry-run
# ---------------------------------------------------------------------------

def fwd_counts(BK: int, H: int, C: int, P: int, N: int, itemsize: int = 2):
    """(bytes, operations) of a forward call: x, B and C (``itemsize``
    bytes) and a, dt (f32) read once; y and the states written once
    (f32); the products over the lower triangle, C Bᵀ once a chunk
    (shared by the heads)."""
    tri = C * (C + 1) // 2
    nbytes = (itemsize * BK * H * C * P + 2 * 4 * BK * H * C
              + 2 * itemsize * BK * C * N + 4 * BK * H * C * P
              + 4 * BK * H * N * P)
    flops = 2 * BK * (N * tri + H * P * tri + H * C * N * P)
    return nbytes, flops


def bwd_counts(BK: int, H: int, C: int, P: int, N: int, itemsize: int = 2):
    """(bytes, operations) of a backward call: x, dx (``itemsize``), dy
    (f32) and dst (f32) moved once, a, dt, da and ddt (f32), B, C, dB
    and dC (``itemsize``) once; C Bᵀ over the lower triangle once a
    chunk, dy xᵀ and Mᵀ dy over it a head, B dst and x dstᵀ a head, D B
    and Dᵀ C once a chunk."""
    tri = C * (C + 1) // 2
    nbytes = (BK * H * C * P * (2 * itemsize + 4) + BK * H * N * P * 4
              + 4 * 4 * BK * H * C + 4 * itemsize * BK * C * N)
    flops = 2 * BK * (N * tri + H * (2 * P * tri + 2 * C * N * P)
                      + 2 * N * tri)
    return nbytes, flops


def _shape_counts(fn, xc, Bc):
    B, K, C, H, P = xc.shape
    return fn(B * K, H, C, P, Bc.shape[-1], itemsize=xc.element_size())


class _SSDIntraChunkShape(torch.autograd.Function):
    """B5 on ``meta`` tensors in the adapter's layout: empty y_intra (B,
    K, C, H, P) and states (B, K, H, N, P) in f32, the inputs saved as
    ``_SSDIntraChunk`` saves them, the backward's outputs, and the
    kernels' counts; no values."""

    @staticmethod
    def forward(ctx, xc, a_t, Bc, Cc, dtc):
        _kernels.count_twin(*_shape_counts(fwd_counts, xc, Bc))
        ctx.save_for_backward(xc, a_t, Bc, Cc, dtc)
        ctx.set_materialize_grads(False)
        return _shape_outputs(xc, Bc)

    @staticmethod
    def backward(ctx, dy, dst):
        xc, a_t, Bc, Cc, dtc = ctx.saved_tensors
        _kernels.count_twin(*_shape_counts(bwd_counts, xc, Bc))
        return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                     for t in (xc, a_t, Bc, Cc, dtc))


def _shape_outputs(xc, Bc):
    B, K, C, H, P = xc.shape
    y = torch.empty((B, K, C, H, P), dtype=torch.float32, device=xc.device)
    st = torch.empty((B, K, H, Bc.shape[-1], P), dtype=torch.float32,
                     device=xc.device)
    return y, st


def intra_states_shape(xc, a_t, Bc, Cc, dtc):
    """B5's shape-only twin in ``make_intra_states_fn``'s form, for
    ``meta`` tensors under ``flags.analysis``: the autograd Function
    when an input requires grad, else one forward; empty outputs, and
    the kernels' counts added to ``kernels.twin_counts``."""
    if xc.device.type != "meta":
        raise ValueError(f"intra_states_shape: meta tensors only, got "
                         f"{xc.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xc, a_t, Bc, Cc, dtc)):
        return _SSDIntraChunkShape.apply(xc, a_t, Bc, Cc, dtc)
    _kernels.count_twin(*_shape_counts(fwd_counts, xc, Bc))
    return _shape_outputs(xc, Bc)
