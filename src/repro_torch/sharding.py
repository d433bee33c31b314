"""Logical-axis sharding (port of ``repro.sharding``): map named
parameter and activation axes to mesh axes.

Models name every dimension of a parameter with a *logical* axis
("heads", "ff", "vocab", ...; ``models.model.logical_axes``).
:func:`resolve_specs` turns those names into specs for a mesh, falling
back to replication wherever a dimension's size does not divide the mesh
axis (40 heads on a 16-way model axis, say), so every arch places on the
production mesh. A spec is a tuple with one entry a dimension: a mesh
axis name, a tuple of names (the replica axes ``pod`` and ``data``
together), ``None`` (replicated) or ``"?"`` (unconstrained).

The mesh is abstract: anything with ``axis_names`` and a ``shape``
mapping axis names to sizes (``launch.mesh.AbstractMesh``, or a rank's
``ReplicaMesh``). No process is involved: a rank places its own slice of
each parameter by the spec (:func:`shard_tree`). The reference's
``constrain`` is a placement hint with the same math, so here it is the
identity.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tr

#: a dimension left to the compiler (the reference's P.UNCONSTRAINED)
UNCONSTRAINED = "?"

# Logical axis -> preferred mesh axis. ``None`` = always replicated.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    # parameter axes
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "layers": None,
    "state": None,
    "conv": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "patch": None,
    # activation axes
    "batch": "data",
    "seq": None,
    "kv_seq": None,
    "replica": "replica",  # rewritten to the concrete replica axes
}

Spec = Tuple[Any, ...]


def _entry(e) -> bool:
    return isinstance(e, (str, type(None))) or (
        isinstance(e, tuple) and all(isinstance(a, str) for a in e))


def is_logical(x) -> bool:
    """True for a leaf of a logical-axis or spec tree: a tuple of names,
    ``None``s and (in a spec) tuples of names."""
    return isinstance(x, tuple) and all(_entry(e) for e in x)


def replica_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry federated device replicas (pod+data if
    present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _resolve_one(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
                 mesh, rules: Dict[str, Optional[str]]) -> Spec:
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} against logical axes {logical}")
    used: set = set()
    out = []
    for size, name in zip(shape, logical):
        if name == UNCONSTRAINED:
            out.append(UNCONSTRAINED)
            continue
        axis = rules.get(name) if name else None
        if axis == "replica":
            raxes = replica_axes(mesh)
            rsize = int(np.prod([mesh.shape[a] for a in raxes]))
            if raxes and size % rsize == 0 and not (set(raxes) & used):
                out.append(tuple(raxes) if len(raxes) > 1 else raxes[0])
                used.update(raxes)
            else:
                out.append(None)
            continue
        if (axis is not None and axis in mesh.axis_names
                and axis not in used and size % mesh.shape[axis] == 0):
            out.append(axis)
            used.add(axis)
        else:
            out.append(None)
    return tuple(out)


def resolve_specs(shapes: Any, logicals: Any, mesh,
                  rules: Optional[Dict[str, Optional[str]]] = None) -> Any:
    """A tree of specs from a tree of tensors (``meta`` ones too: only
    their shapes are read) and the matching tree of logical-axis
    tuples."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sl, treedef = tr.tree_flatten(shapes)
    ll = spec_leaves(logicals)
    if len(sl) != len(ll):
        raise ValueError(f"{len(sl)} shapes against {len(ll)} logical "
                         "leaves")
    return tr.tree_unflatten(treedef, [
        _resolve_one(tuple(s.shape), tuple(lg), mesh, rules)
        for s, lg in zip(sl, ll)])


def spec_leaves(logicals) -> list:
    """The logical tuples (or specs) of a tree in flatten order: a tuple
    of names is a leaf, not a container."""
    out: list = []

    def walk(t):
        if is_logical(t):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for v in t:
                walk(v)
    walk(logicals)
    return out


def map_logical(fn, logicals: Any) -> Any:
    """``fn`` applied to every logical tuple of the tree."""
    if is_logical(logicals):
        return fn(logicals)
    if isinstance(logicals, dict):
        return {k: map_logical(fn, v) for k, v in logicals.items()}
    return type(logicals)(map_logical(fn, v) for v in logicals)


def prepend_axis(logicals: Any, name: str) -> Any:
    """Prepend a logical axis (e.g. the FL replica axis) to every leaf."""
    return map_logical(lambda lg: (name,) + tuple(lg), logicals)


def _axis_coord(mesh, entry) -> Tuple[int, int]:
    """(this rank's index, the size) along a spec entry's mesh axes (one
    name or a tuple of names, flattened in order)."""
    names = entry if isinstance(entry, tuple) else (entry,)
    coord = {"pod": mesh.pod_index, "data": mesh.data_index,
             "model": mesh.model_index}
    idx, size = 0, 1
    for a in names:
        idx = idx * mesh.shape[a] + coord[a]
        size *= mesh.shape[a]
    return idx, size


def shard_tree(params, specs, mesh):
    """This rank's slice of every leaf of a whole tree, as ``specs`` (a
    tree of ``repro_torch.sharding`` specs of the same structure) places
    it on ``mesh`` (a rank's ``ReplicaMesh``): each dimension with a mesh
    axis is cut to the rank's part along it. A leaf that is cut becomes
    a copy of its part, so the whole one can be freed; the others are
    kept as they are."""
    leaves, treedef = tr.tree_flatten(params)
    out = []
    for t, spec in zip(leaves, spec_leaves(specs)):
        cut = [(d, e) for d, e in enumerate(spec) if e not in (None, "?")]
        for dim, entry in cut:
            idx, size = _axis_coord(mesh, entry)
            n = t.shape[dim] // size
            t = t.narrow(dim, idx * n, n)
        out.append(t.clone(memory_format=torch.contiguous_format)
                   if cut else t)
    return tr.tree_unflatten(treedef, out)


def constrain(x, *logical: Optional[str], rules=None):
    """The reference's ``with_sharding_constraint`` by logical names: a
    placement hint, which changes no value, so the identity here."""
    return x
