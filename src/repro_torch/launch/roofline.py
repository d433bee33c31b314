"""Roofline terms of a rank's program, counted on ``meta`` tensors (port of
``repro.launch.roofline``).

The reference reads its figures from XLA's compiled artifacts. The port
runs eagerly, so the dry-run (``launch.dryrun``) runs a rank's program
itself, on ``meta`` tensors in a fake world (``launch.mesh.fake_world``),
and counts it as it goes:

- :func:`count_cost`: the operations (``torch.utils.flop_counter``'s
  matrix products, plus what the kernels' shape-only twins stand for,
  ``kernels.twin_counts``), the bytes (every op that is not a view reads
  its inputs and writes its outputs once: unfused traffic, since each
  eager op goes through HBM; plus the twins' bytes) and the peak of live
  storage bytes (each storage the program holds, from its allocation to
  the last reference's release);
- :func:`collective_bytes`: the payload bytes and calls of the rank's
  collectives by group and kind, as the mesh counts them
  (``ReplicaMesh.traffic_by_group``).

The three terms of :func:`roofline_terms` price them for one NVIDIA
H100 SXM card, at NVIDIA's data-sheet rates (defaults of the keyword
arguments; the reference's constants are a TPU's and are not used):
989e12 dense bf16 FLOP/s and 3.35e12 HBM bytes/s, the card's power
limit at its 700 W maximum. The collective term prices each group at its
own link (:func:`link_rates`): the model group over NVLink (900 GB/s a
card) when it fits in one 8-card HGX node, else over one 400 Gb/s
InfiniBand port a card, the data group (which spans the pods) over that
port. These are data-sheet predictions, not measurements.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels as _kernels

#: NVIDIA H100 SXM data sheet (dense, 700 W): bf16 tensor-core FLOP/s and
#: HBM3 bytes/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: NVIDIA data-sheet link rates a card, bytes/s: NVLink 4 within an HGX
#: H100 node of NODE_CARDS cards, and one 400 Gb/s ConnectX-7 InfiniBand
#: port between nodes
NVLINK_BW = 900e9
NET_BW = 400e9 / 8
NODE_CARDS = 8


def link_rates(mesh) -> Dict[str, float]:
    """Each traffic group's link a card (bytes/s) on ``mesh`` (its
    ``model`` axis size): NVLink for a model group within one node, else
    the InfiniBand port; the data group always the port."""
    model = dict(mesh.shape).get("model", 1)
    return {"model": NVLINK_BW if model <= NODE_CARDS else NET_BW,
            "data": NET_BW}


# ---------------------------------------------------------------------------
# counting a program on meta tensors
# ---------------------------------------------------------------------------

def _tensors(args):
    """The tensors among ``args`` and in their lists and tuples."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Storage(TorchDispatchMode):
    """Bytes moved by the ops that are not views, and the peak of live
    storage bytes. A storage is keyed by its address and held by a weak
    reference (a storage's Python wrapper is made anew on every call, so
    it cannot carry a finalizer); ``total`` adds each new storage and is
    swept of released ones only when it passes ``peak``, which keeps the
    peak exact while the sweeps stay rare."""

    def __init__(self, seeds):
        super().__init__()
        self.bytes = 0
        self.live: Dict[int, tuple] = {}
        self.total = 0
        self.moves: Dict[Any, bool] = {}
        for t in seeds:
            self._track(t)
        self.seeded = self.peak = self.total

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        old = self.live.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self.total -= old[1]
        n = st.nbytes()
        self.live[key] = (StorageWeakRef(st), n)
        self.total += n

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.total -= self.live.pop(k)[1]

    def _moves(self, func) -> bool:
        """Whether ``func`` moves bytes: not a view, a collective (the
        collective term's) or an uninitialised allocation."""
        got = self.moves.get(func)
        if got is None:
            got = self.moves[func] = not (
                func.is_view or func.namespace == "c10d"
                or func.overloadpacket.__name__.startswith(
                    ("empty", "new_empty")))
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(_tensors((out,)))
        if self._moves(func):
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) + sum(
                _nbytes(t) for t in outs)
            if kwargs:
                self.bytes += sum(_nbytes(t) for t in
                                  _tensors(kwargs.values()))
        for t in outs:
            self._track(t)
        if self.total > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.total)
        return out


def _meta_key(a):
    """What an op's output shapes depend on, of one argument: a tensor's
    shape, strides, dtype and device, else the value."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_meta_key(x) for x in a)
    return a


class _SameShapes(TorchDispatchMode):
    """Runs each ``meta`` op's shape function once an input signature: an
    op that returns fresh tensors (no view, no argument written, no
    aliased return) and was seen with the same input shapes, strides,
    dtypes and other arguments gets new empty outputs of the shapes and
    strides it gave then. A rank's program repeats its layers, and
    PyTorch computes many ``meta`` shapes in Python, so this spares most
    of the dry-run's time; the modes above it see every op as before."""

    def __init__(self):
        super().__init__()
        self.fresh: Dict[Any, bool] = {}
        self.seen: Dict[Any, tuple] = {}

    def _fresh(self, func) -> bool:
        got = self.fresh.get(func)
        if got is None:
            sch = func._schema
            got = self.fresh[func] = bool(
                func.namespace == "aten" and not func.is_view and sch.returns
                and not any(a.alias_info is not None and a.alias_info.is_write
                            for a in sch.arguments)
                and all(r.alias_info is None and str(r.type) == "Tensor"
                        for r in sch.returns))
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._fresh(func):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(tuple(sorted(
                kwargs.items()))))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        got = self.seen.get(key)
        if got is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            ins = {t.untyped_storage()._cdata for t in _tensors(args)}
            if all(o.is_meta and o.untyped_storage()._cdata not in ins
                   for o in outs):
                self.seen[key] = (isinstance(out, tuple), [
                    (tuple(o.shape), o.stride(), o.dtype) for o in outs])
            return out
        many, metas = got
        outs = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                for shape, stride, dt in metas]
        return tuple(outs) if many else outs[0]


@contextlib.contextmanager
def count_cost(*args, flops: bool = True):
    """Count the work done in the block on ``meta`` tensors: yields a dict
    that is filled when the block exits with ``flops`` (matrix products
    by ``FlopCounterMode``, plus the twins'; with ``flops`` False none
    are counted, which halves the mode's cost, and the key is absent),
    ``bytes`` (the unfused traffic of every op that is not a view, plus
    the twins'), ``twin_flops`` and ``twin_bytes`` (the kernels'
    shares), ``peak_bytes`` (the most storage bytes live at once, the
    storages of ``args``' tensors included, which exist before the
    block) and ``argument_bytes`` (those storages' bytes)."""
    seeds = list(_tensors(pytree.tree_leaves(args)))
    rec: Dict[str, Any] = {}
    before = dict(_kernels.twin_counts)
    with contextlib.ExitStack() as stack:
        # below the counters, which see every op
        stack.enter_context(_SameShapes())
        fc = stack.enter_context(FlopCounterMode(display=False)) \
            if flops else None
        st = stack.enter_context(_Storage(seeds))
        yield rec
    twin_f = _kernels.twin_counts["flops"] - before["flops"]
    twin_b = _kernels.twin_counts["bytes"] - before["bytes"]
    if fc is not None:
        rec["flops"] = float(fc.get_total_flops() + twin_f)
    rec.update(bytes=float(st.bytes + twin_b), twin_flops=float(twin_f),
               twin_bytes=float(twin_b), peak_bytes=int(st.peak),
               argument_bytes=int(st.seeded))


def collective_bytes(traffic: Dict[str, Dict]) -> Dict[str, Any]:
    """The payload bytes a rank's collectives sent, from
    ``ReplicaMesh.traffic_by_group()``: by group (``bytes_by_group``),
    by kind over the groups (``bytes_by_kind``, ``counts``), by group and
    kind (``by_group``: ``{calls, bytes}``) and in all
    (``total_bytes``)."""
    by_group: Dict[str, Dict] = {}
    per_kind: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for group, ops in traffic.items():
        by_group[group] = {k: {"calls": int(v["calls"]),
                               "bytes": int(v["sent"])}
                           for k, v in ops.items()}
        for k, v in ops.items():
            per_kind[k] = per_kind.get(k, 0) + int(v["sent"])
            counts[k] = counts.get(k, 0) + int(v["calls"])
    return {"bytes_by_group": {g: sum(v["bytes"] for v in ops.values())
                               for g, ops in by_group.items()},
            "bytes_by_kind": per_kind, "counts": counts,
            "by_group": by_group, "total_bytes": sum(per_kind.values())}


# ---------------------------------------------------------------------------
# the terms
# ---------------------------------------------------------------------------

def roofline_terms(flops_dev: float, bytes_dev: float, coll_bytes_dev, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   coll_bw=NET_BW) -> Dict[str, float]:
    """The three terms of one rank, the largest its bottleneck, as the
    reference: compute = flops / peak, memory = bytes / HBM rate,
    collective = collective bytes / link rate. ``coll_bytes_dev`` is a
    number priced at ``coll_bw`` (a rate), or ``{group: bytes}`` priced
    each at ``coll_bw[group]`` (:func:`link_rates`)."""
    compute = flops_dev / peak_flops
    memory = bytes_dev / hbm_bw
    if isinstance(coll_bytes_dev, dict):
        coll = sum(b / coll_bw[g] for g, b in coll_bytes_dev.items())
    else:
        coll = coll_bytes_dev / coll_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["roofline_bound_s"] = max(compute, memory, coll)
    return terms


def _leaves(tree, keys=()):
    """(keys on the path, leaf) of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (i,))
    else:
        yield keys, tree


def model_flops(cfg, params, kind: str, tokens: int):
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), with N = active
    params for MoE (experts scaled by k/E, shared expert kept whole).
    Returns (model flops, total params, active params)."""
    expert_n = 0
    total_n = 0
    for keys, leaf in _leaves(params):
        n = leaf.numel()
        total_n += n
        if "moe" in keys and "shared" not in keys and any(
                k in ("w_gate", "w_up", "w_out") for k in keys):
            expert_n += n
    if cfg.num_experts:
        frac = cfg.experts_per_token / cfg.num_experts
        active = total_n - expert_n + expert_n * frac
    else:
        active = total_n
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens, total_n, active


def summarize(record: Dict[str, Any]) -> str:
    t = record["terms"]
    return (f"{record['arch']:26s} {record['shape']:12s} "
            f"{record['mesh']:9s} comp={t['compute_s']:9.4f}s "
            f"mem={t['memory_s']:9.4f}s coll={t['collective_s']:9.4f}s "
            f"-> {t['bottleneck']:10s} useful={record['useful_ratio']:.3f}")
