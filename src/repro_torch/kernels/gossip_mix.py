"""Fused gossip mixing over the flat model bank: the CE-FedAvg boundary.

Every aggregation boundary of eq. 10/11 applies a mixing operator W over
the device axis of the bank Y, which stacks the n device models row-wise.
One pass of ``csrc/gossip_mix.cu`` (a hand-written Hopper kernel, built
for ``sm_90a``: a persistent pass whose producer warpgroup stages tiles
with ``cp.async`` while two warpgroups run TF32 ``wgmma`` products split
three ways to hold f32 accuracy) reads each column tile of the bank once
and writes it once; it replaces the Pallas TPU kernel
``repro.kernels.gossip_mix`` ``gossip_mix_flat``.

Two call conventions, as in the reference:

- :func:`gossip_mix_flat` — ``(W, Y) -> WᵀY`` with W of shape (n, k)
  (column application; W[j, i] is the weight j→i). Out of place.
- :func:`gossip_mix_rows` — ``(W, Y) -> W @ Y`` with W of shape (k, n)
  (row application: the bank's mixing boundary, and the (m, n)
  edge-model projection). When W is square the result is written over
  Y on the card; callers use the return value either way.

On a CPU tensor each wrapper takes its plain version
(:mod:`repro_torch.kernels.ref`). On a CUDA tensor it launches the
kernel or raises; nothing falls back. ``launches`` counts kernel
launches (not plain-version calls).

:class:`FlatLayout` is the concat/split plan between a parameter tree
and its flat (n, T) bank, in ``jax.tree.flatten`` order, so a port row
and a reference row are the same bytes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

#: largest n (input rows) and k (output rows) the CUDA kernel takes; the
#: shared-memory copy of W is 64 x 64 f32, hi and lo (32 KB)
MAX_ROWS = 64
#: Y dtypes the kernel takes, with their code in the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (plain-version calls on the CPU do not
#: count); reset it to 0 before a run whose launches are to be read
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature."""
    lib = _build.load("gossip_mix")
    fn = lib.gossip_mix_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def copy_bytes(ncols: int, itemsize: int, ptr: int) -> int:
    """Width of one global-to-shared copy of the kernel: the widest of
    16, 8, 4 and 2 bytes that divides a row of ``ncols`` elements of
    ``itemsize`` bytes and the address ``ptr`` (of the bank and the
    output alike), and holds whole elements. A bank row starts only as
    aligned as T allows: the FEMNIST CNN's T = 6,603,710 is 2 mod 4, so
    its f32 rows take 8-byte copies and its bf16 rows 4-byte ones; an
    odd T at bf16 takes 2 (through registers: ``cp.async`` copies at
    least 4)."""
    for width in (16, 8, 4, 2):
        if width >= itemsize and (ncols * itemsize) % width == 0 and \
                ptr % width == 0:
            return width
    raise ValueError(f"gossip_mix: no copy width fits rows of {ncols} x "
                     f"{itemsize} bytes at address {ptr}")


def _as_operator(W, device: torch.device) -> torch.Tensor:
    """W as a contiguous f32 tensor on ``device``."""
    if not isinstance(W, torch.Tensor):
        W = torch.from_numpy(np.asarray(W, np.float32))
    return W.to(device=device, dtype=torch.float32).contiguous()


def _check(Wr: torch.Tensor, Y: torch.Tensor) -> None:
    if Y.ndim != 2 or Wr.ndim != 2:
        raise ValueError(f"gossip_mix needs a 2-D W and Y, got W "
                         f"{tuple(Wr.shape)} and Y {tuple(Y.shape)}")
    if Wr.shape[1] != Y.shape[0]:
        raise ValueError(f"W {tuple(Wr.shape)} does not row-apply to Y "
                         f"{tuple(Y.shape)}")


def _launch(Wr: torch.Tensor, Y: torch.Tensor, out: torch.Tensor) -> None:
    """out = Wr @ Y on the card; ``Wr`` is the (k, n) row operator."""
    global launches
    if Y.device.type != "cuda":
        raise ValueError(f"gossip_mix: no kernel for device {Y.device}")
    if Y.dtype not in _DTYPE_CODE:
        raise ValueError(f"gossip_mix kernel takes f32 or bf16, got "
                         f"{Y.dtype}")
    if not (Y.is_contiguous() and out.is_contiguous()):
        raise ValueError("gossip_mix kernel needs contiguous Y and out")
    k, n = Wr.shape
    if n > MAX_ROWS or k > MAX_ROWS:
        raise ValueError(f"gossip_mix kernel takes at most {MAX_ROWS} "
                         f"input and output rows, got W {tuple(Wr.shape)}")
    lib = _library()
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        # the OR of the two addresses is as aligned as the less aligned
        width = copy_bytes(Y.shape[1], Y.element_size(),
                           Y.data_ptr() | out.data_ptr())
        rc = lib.gossip_mix_rows_launch(
            Wr.data_ptr(), Y.data_ptr(), out.data_ptr(), n, k, Y.shape[1],
            _DTYPE_CODE[Y.dtype], width, stream)
    if rc != 0:
        raise RuntimeError(f"gossip_mix kernel launch failed: CUDA error "
                           f"{rc} (W {tuple(Wr.shape)}, Y "
                           f"{tuple(Y.shape)} {Y.dtype})")
    launches += 1


def gossip_mix_flat(W, Y: torch.Tensor) -> torch.Tensor:
    """Y: (n, T) flattened stacked models; W: (n, k). Returns WᵀY (k, T)
    in a new tensor of Y's dtype, summed in f32."""
    Wt = _as_operator(W, Y.device)
    _check(Wt.T, Y)
    if Y.device.type == "cpu":
        return _ref.gossip_mix_ref(Wt, Y)
    Wr = Wt.T.contiguous()
    out = torch.empty((Wr.shape[0], Y.shape[1]), dtype=Y.dtype,
                      device=Y.device)
    _launch(Wr, Y, out)
    return out


def gossip_mix_rows(W, Y: torch.Tensor) -> torch.Tensor:
    """Row-apply W (k, n) to the flat bank Y (n, T): returns W @ Y.

    One streaming pass over the bank: the ModelBank mixing boundary
    (square W, written over Y on the card) and the edge-model
    projection (rectangular W, a new (k, T) tensor)."""
    Wr = _as_operator(W, Y.device)
    _check(Wr, Y)
    if Y.device.type == "cpu":
        return _ref.gossip_mix_rows_ref(Wr, Y)
    k, n = Wr.shape
    out = Y if k == n else torch.empty((k, Y.shape[1]), dtype=Y.dtype,
                                       device=Y.device)
    _launch(Wr, Y, out)
    return out


# ---------------------------------------------------------------------------
# FlatLayout: the concat/split plan between parameter trees and the bank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FlatLayout:
    """Concat/split plan between a parameter tree and its flat (n, T)
    bank: per-leaf trailing ``shapes`` (device axis excluded),
    ``dtypes``, ``offsets``/``sizes`` into the flat axis, and the tree
    structure ``treedef`` (see :mod:`repro_torch.tree`)."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total: int                            # T = sum(sizes)

    @property
    def segments(self) -> Tuple[Tuple[int, int], ...]:
        """(offset, size) per leaf."""
        return tuple(zip(self.offsets, self.sizes))

    @property
    def row_nbytes(self) -> int:
        """Bytes of one f32 bank row (one device model)."""
        return 4 * self.total

    @classmethod
    def _build(cls, tree, strip_leading: bool) -> "FlatLayout":
        leaves, treedef = tr.tree_flatten(tree)
        shapes = tuple(tuple(leaf.shape[1:] if strip_leading else leaf.shape)
                       for leaf in leaves)
        dtypes = tuple(leaf.dtype for leaf in leaves)
        sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
        offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1]))
        return cls(treedef, shapes, dtypes, offsets, sizes, int(sum(sizes)))

    @classmethod
    def for_tree(cls, tree) -> "FlatLayout":
        """Layout of a single model tree (no leading device axis)."""
        return cls._build(tree, strip_leading=False)

    @classmethod
    def for_stacked(cls, tree) -> "FlatLayout":
        """Layout of a device-stacked tree: every leaf is (n, ...)."""
        return cls._build(tree, strip_leading=True)

    def flatten_one(self, tree) -> torch.Tensor:
        """Tree -> (T,) f32 row."""
        return torch.cat([leaf.reshape(-1).to(torch.float32)
                          for leaf in tr.tree_leaves(tree)])

    def unflatten_one(self, vec: torch.Tensor):
        """(T,) -> tree of per-leaf views (original shapes and dtypes)."""
        out = [vec[o:o + s].reshape(shape).to(dt)
               for o, s, shape, dt in zip(self.offsets, self.sizes,
                                          self.shapes, self.dtypes)]
        return tr.tree_unflatten(self.treedef, out)

    def flatten_stack(self, tree) -> torch.Tensor:
        """Tree of (n, ...) leaves -> (n, T) f32 bank."""
        leaves = tr.tree_leaves(tree)
        n = leaves[0].shape[0]
        return torch.cat([leaf.reshape(n, -1).to(torch.float32)
                          for leaf in leaves], dim=1)

    def unflatten_stack(self, Y: torch.Tensor):
        """(n, T) bank -> tree of (n, ...) leaves."""
        n = Y.shape[0]
        out = [Y[:, o:o + s].reshape((n,) + shape).to(dt)
               for o, s, shape, dt in zip(self.offsets, self.sizes,
                                          self.shapes, self.dtypes)]
        return tr.tree_unflatten(self.treedef, out)


def gossip_mix_tree(W, params):
    """Row-apply W over the leading device axis of every leaf through one
    fused pass over the flattened tree (:func:`gossip_mix_rows`)."""
    layout = FlatLayout.for_stacked(params)
    return layout.unflatten_stack(
        gossip_mix_rows(W, layout.flatten_stack(params)))
