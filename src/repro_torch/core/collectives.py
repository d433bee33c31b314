"""Collectives over the flat replica axis (port of
``repro.core.collectives``).

The mesh's replica axes (``pod`` × ``data``) are ONE flattened logical
axis, the flat index ``pod_idx * data_size + data_idx`` being the rank
(:class:`repro_torch.launch.mesh.ReplicaMesh`). The reference issues
its collectives inside a ``shard_map`` body; here every rank calls the
same function on its own tensor, so each function below is a collective
call: every rank of the world makes it, in the same order.

- :func:`ppermute`: one ``batch_isend_irecv`` of the (src, dst) pairs
  that touch this rank; a rank that no pair sends to gets zeros.
- :func:`psum_groups`: an ``all_reduce`` over this rank's group of a
  partition of the ranks. Each partition's subgroups are made once per
  mesh, on first use (``new_group`` is collective: every rank makes
  every group, in the same order), and cached on the mesh.
- :func:`all_reduce`, :func:`all_gather`, :func:`gather_rows`,
  :func:`barrier`: the world sum (the sharded engine's evaluation), every
  rank's tensor on every rank (the LM trainer's dense mixing), rows to
  rank 0 (a checkpoint's save) and a barrier.

On a mesh with a model axis (the LM trainer's tensor parallelism) the
flat replica axis is the rank's *data group*: replica r's peer is the
rank holding the same model index in replica r (``mesh.rank_of``), and
the world sums and gathers above run over the data group.

The model group (the ranks of one replica) carries the split layers'
reductions: :class:`ModelParallel`, handed to the model functions as
``tp``, wraps them as autograd functions (Megatron's f and g, and a
gather along a dimension).

The transport is the mesh's backend's: under NCCL a CUDA tensor moves
as it is; under gloo, whose point-to-point ops carry host memory only, a
CUDA tensor is staged through a pinned host buffer kept on the mesh, and
the result copied back. Every call counts itself in ``mesh.traffic[op]``
(``calls``, and the payload bytes this rank ``sent`` and ``recv``), or
in ``mesh.model_traffic[op]`` for the model group: the tests hold the
traffic contract to these counts where the reference inspects the
compiled HLO.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.launch.mesh import ReplicaMesh
from repro_torch.sharding import spec_leaves


def flat_axis_size(mesh: ReplicaMesh) -> int:
    return mesh.pods * mesh.data


def flat_axis_index(mesh: ReplicaMesh) -> int:
    """Flattened replica index of this rank (``pod_idx * data_size +
    data_idx``: the global replica id of ``ReplicaGeometry``)."""
    return mesh.replica


def rotate_perm(mesh: ReplicaMesh, shift: int = 1
                ) -> Tuple[Tuple[int, int], ...]:
    """Cyclic (src, dst) pairs on the flat replica axis: after one
    application of the returned perm, rank d holds what rank
    ``(d + shift) % R`` held — the building block of the weighted-rotation
    mixes (``core.gossip.dense_mix_rows``)."""
    R = flat_axis_size(mesh)
    return tuple(((d + shift) % R, d) for d in range(R))


def _count(mesh: ReplicaMesh, op: str, sent: int, recv: int,
           group: str = "data") -> None:
    counters = mesh.model_traffic if group == "model" else mesh.traffic
    c = counters.setdefault(op, {"calls": 0, "sent": 0, "recv": 0})
    c["calls"] += 1
    c["sent"] += int(sent)
    c["recv"] += int(recv)


def _pinned(mesh: ReplicaMesh, like: torch.Tensor,
            tag: str) -> torch.Tensor:
    """The mesh's pinned host buffer for ``tag`` at ``like``'s shape and
    dtype, made on first use (staged transports only)."""
    key = (tag, tuple(like.shape), like.dtype)
    buf = mesh.staging.get(key)
    if buf is None:
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        mesh.staging[key] = buf
    return buf


def _stage(mesh: ReplicaMesh, x: torch.Tensor, tag: str) -> torch.Tensor:
    """The tensor a collective carries for ``x``: ``x`` itself, or under
    a staged transport a pinned host buffer holding a copy of it."""
    if not mesh.staged:
        return x
    return _pinned(mesh, x, tag).copy_(x)


def _recv_buffer(mesh: ReplicaMesh, like: torch.Tensor,
                 tag: str) -> torch.Tensor:
    """A buffer to receive a tensor like ``like`` into."""
    if not mesh.staged:
        return torch.empty_like(like)
    return _pinned(mesh, like, tag)


def _unstage(mesh: ReplicaMesh, buf: torch.Tensor) -> torch.Tensor:
    """``buf``'s values on the rank's device (a copy of a staged pinned
    buffer, which the next collective reuses)."""
    if not mesh.staged:
        return buf
    return buf.to(mesh.device)


def ppermute(x: torch.Tensor, mesh: ReplicaMesh,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Permute over the flat replica axis: rank ``dst`` of each (src,
    dst) pair gets rank ``src``'s ``x``; unmatched receivers get zeros.
    Sources are distinct and so are destinations (a partial
    permutation)."""
    me = flat_axis_index(mesh)
    srcs = [s for s, d in perm if d == me]
    dsts = [d for s, d in perm if s == me]
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError(f"perm {perm} is not a partial permutation")
    x = x.contiguous()
    nbytes = x.numel() * x.element_size()
    if srcs and dsts and srcs[0] == me:
        # a self pair: no transfer
        _count(mesh, "ppermute", 0, 0)
        return x.clone()
    ops = []
    if dsts:
        ops.append(dist.P2POp(dist.isend, _stage(mesh, x, "send"),
                              mesh.rank_of(dsts[0])))
    recv = None
    if srcs:
        recv = _recv_buffer(mesh, x, "recv")
        ops.append(dist.P2POp(dist.irecv, recv, mesh.rank_of(srcs[0])))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _count(mesh, "ppermute", nbytes if dsts else 0, nbytes if srcs else 0)
    if recv is None:
        return torch.zeros_like(x)
    return _unstage(mesh, recv)


def subgroup(mesh: ReplicaMesh, groups: Sequence[Sequence[int]]):
    """This rank's process group in the partition ``groups`` of the flat
    replica ids, made (for every group of the partition, on every rank)
    the first time the partition is asked for on this mesh. With a model
    axis the partition is made once a model index, over the ranks of
    that index (the rank's group holds its data-group peers)."""
    key = tuple(tuple(int(r) for r in g) for g in groups)
    pg = mesh.groups.get(key)
    if pg is None:
        if sorted(r for g in key for r in g) != list(range(
                flat_axis_size(mesh))):
            raise ValueError(f"groups {key} do not partition the "
                             f"{flat_axis_size(mesh)} replicas")
        pg, _ = dist.new_subgroups_by_enumeration(
            [[mesh.rank_of(r, m) for r in g] for m in range(mesh.model)
             for g in key], backend=mesh.backend)
        mesh.groups[key] = pg
    return pg


def psum_groups(x: torch.Tensor, mesh: ReplicaMesh,
                groups: Sequence[Sequence[int]]) -> torch.Tensor:
    """Grouped sum over the flat replica axis (flat replica ids): every
    rank gets the sum of ``x`` over its own group."""
    pg = subgroup(mesh, groups)
    buf = _stage(mesh, x.contiguous(), "psum")
    if not mesh.staged:
        buf = buf.clone()
    dist.all_reduce(buf, group=pg)
    nbytes = buf.numel() * buf.element_size()
    _count(mesh, "all_reduce", nbytes, nbytes)
    return _unstage(mesh, buf)


def all_reduce(x: torch.Tensor, mesh: ReplicaMesh) -> torch.Tensor:
    """Sum of ``x`` over the replicas (every rank of the world, or of the
    rank's data group)."""
    buf = _stage(mesh, x.contiguous(), "all_reduce")
    if not mesh.staged:
        buf = buf.clone()
    dist.all_reduce(buf, group=mesh.data_group)
    nbytes = buf.numel() * buf.element_size()
    _count(mesh, "all_reduce", nbytes, nbytes)
    return _unstage(mesh, buf)


def all_gather(x: torch.Tensor, mesh: ReplicaMesh) -> list:
    """Every replica's ``x`` (one shape and dtype on all), by replica, on
    this rank's device (over the data group). Each rank sends its tensor
    to the R - 1 others and receives theirs: (R - 1)·|x| bytes each
    way."""
    x = x.detach().contiguous()
    R = flat_axis_size(mesh)
    if R == 1:
        return [x]
    nbytes = x.numel() * x.element_size()
    if mesh.staged:
        outs = [torch.empty(x.shape, dtype=x.dtype) for _ in range(R)]
        dist.all_gather(outs, _stage(mesh, x, "all_gather"),
                        group=mesh.data_group)
        outs = [o.to(mesh.device) for o in outs]
    else:
        outs = [torch.empty_like(x) for _ in range(R)]
        dist.all_gather(outs, x, group=mesh.data_group)
    _count(mesh, "all_gather", nbytes * (R - 1), nbytes * (R - 1))
    return outs


def gather_rows(x: torch.Tensor, mesh: ReplicaMesh
                ) -> Optional[np.ndarray]:
    """Every rank's rows ``x`` stacked in rank order into rank 0's host
    memory (a host numpy array there; None on the other ranks). The
    rows travel one rank at a time, so rank 0 never holds more than the
    result and one rank's rows on its device."""
    if mesh.model != 1:
        raise ValueError("gather_rows gathers bank rows, one a rank: the "
                         "mesh must have no model axis")
    x = x.detach().contiguous()
    nbytes = x.numel() * x.element_size()
    R = flat_axis_size(mesh)
    if mesh.rank != 0:
        dist.send(_stage(mesh, x, "gather"), 0)
        _count(mesh, "gather", nbytes, 0)
        return None
    own = x.cpu().numpy()
    out = np.empty((R * own.shape[0],) + own.shape[1:], own.dtype)
    rows = own.shape[0]
    out[:rows] = own
    buf = _recv_buffer(mesh, x, "gather")
    for r in range(1, R):
        dist.recv(buf, r)
        out[r * rows:(r + 1) * rows] = buf.cpu().numpy()
    _count(mesh, "gather", 0, nbytes * (R - 1))
    return out


def barrier(mesh: ReplicaMesh) -> None:
    """Every rank waits until all have arrived (a one-element
    ``all_reduce``, which every backend carries)."""
    one = torch.ones(1, device=mesh.device)
    dist.all_reduce(_stage(mesh, one, "barrier"))



# ---------------------------------------------------------------------------
# the model group: tensor parallelism within a replica
# ---------------------------------------------------------------------------

def model_all_reduce(x: torch.Tensor, mesh: ReplicaMesh,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over the rank's model group (a new
    tensor)."""
    buf = _stage(mesh, x.contiguous(), "model_all_reduce")
    if not mesh.staged:
        buf = buf.clone()
    dist.all_reduce(buf, op=op, group=mesh.model_group)
    nbytes = buf.numel() * buf.element_size()
    _count(mesh, "all_reduce", nbytes, nbytes, "model")
    return _unstage(mesh, buf)


def model_all_gather(x: torch.Tensor, mesh: ReplicaMesh) -> list:
    """Every model rank's ``x`` (one shape and dtype on all), by model
    index, on this rank's device."""
    x = x.detach().contiguous()
    M = mesh.model
    nbytes = x.numel() * x.element_size()
    if mesh.staged:
        outs = [torch.empty(x.shape, dtype=x.dtype) for _ in range(M)]
        dist.all_gather(outs, _stage(mesh, x, "model_all_gather"),
                        group=mesh.model_group)
        outs = [o.to(mesh.device) for o in outs]
    else:
        outs = [torch.empty_like(x) for _ in range(M)]
        dist.all_gather(outs, x, group=mesh.model_group)
    _count(mesh, "all_gather", nbytes * (M - 1), nbytes * (M - 1), "model")
    return outs


class _CopyToModel(torch.autograd.Function):
    """Identity forward, model-group sum backward: the input of a split
    branch, whose gradient each rank holds only its part of (f)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce(g, ctx.tp.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Model-group sum forward, identity backward: the output of a split
    branch (partial sums) entering the replicated stream (g)."""

    @staticmethod
    def forward(ctx, x, tp):
        return model_all_reduce(x, tp.mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumInModel(torch.autograd.Function):
    """Model-group sum forward and backward: a sum of partial values
    that split branches consume (f after g)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return model_all_reduce(x, tp.mesh)

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce(g, ctx.tp.mesh), None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' slices concatenated along ``dim`` (forward); the
    rank's slice of the gradient (backward: the gathered value feeds
    replicated computation, whose gradient every rank holds whole)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return torch.cat(model_all_gather(x, tp.mesh), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.tp.index * ctx.n, ctx.n).contiguous(),
                None, None)


class ModelParallel:
    """The rank's model group as the model functions use it (their
    ``tp`` argument): its ``size`` and this rank's ``index``, and the
    split layers' reductions as autograd functions. Every rank of the
    group calls each one in the same order (forward and backward).

    - :meth:`copy` (f): identity forward, sum of the gradient backward:
      a replicated value entering a branch that each rank computes only
      its part of.
    - :meth:`reduce` (g): sum forward, identity backward: partial sums
      leaving such a branch.
    - :meth:`sum` (g then f): sum forward and backward, for partial sums
      whose consumers are split too (the gated norm's sum of squares).
    - :meth:`gather`: slices concatenated along a dimension, the rank's
      slice of the gradient backward.
    - :meth:`max`: elementwise max, no gradient."""

    def __init__(self, mesh: ReplicaMesh):
        if mesh.model < 2:
            raise ValueError("ModelParallel needs a model axis of 2 or more")
        self.mesh = mesh
        self.size = mesh.model
        self.index = mesh.model_index

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumInModel.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromModel.apply(x, self, dim % x.dim())

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return model_all_reduce(x.detach(), self.mesh, dist.ReduceOp.MAX)


def gather_tree(params, specs, mesh: ReplicaMesh):
    """A replica's whole tree from its model ranks' slices, on every rank
    of the model group: each leaf whose spec (``repro_torch.sharding``,
    one replica's) places it over ``model`` is all-gathered over the
    model group and joined along that dimension; the others are kept.
    The inverse of ``sharding.shard_tree``."""
    leaves, treedef = tr.tree_flatten(params)
    out = []
    for t, spec in zip(leaves, spec_leaves(specs)):
        dims = [d for d, e in enumerate(spec)
                if e == "model" or (isinstance(e, tuple) and "model" in e)]
        if dims and mesh.model > 1:
            t = torch.cat(model_all_gather(t, mesh), dim=dims[0])
        out.append(t)
    return tr.tree_unflatten(treedef, out)
