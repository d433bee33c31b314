"""Flat-npz tree checkpointing (port of ``repro.checkpoint.ckpt``; no
external dependencies).

Keys encode the tree path (``/a/b`` for dict keys, ``/#i`` for list and
tuple items); dtypes and shapes round-trip exactly. Leaves may be numpy
arrays or torch tensors. Extension float types that numpy cannot hold
without ``ml_dtypes`` — a torch ``bfloat16`` or ``float8`` tensor, or an
``ml_dtypes`` numpy array — are stored viewed as same-width unsigned
ints and tagged with their dtype name in the archive's ``__dtypes__``
entry, exactly as the reference stores them; on load a tagged leaf comes
back as a torch tensor of that dtype with the same bits. So archives
cross between the packages both ways, and neither side needs
``ml_dtypes`` here. Saves are atomic: the archive is written to a temp
file in the destination directory and ``os.replace``d into place, so a
crash mid-save never corrupts the previous checkpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tr

#: extension dtypes by their archive tag (numpy's ``ml_dtypes`` names)
_EXT_DTYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_UINT = {1: torch.uint8, 2: torch.uint16}


class CheckpointStructureError(ValueError):
    """Raised when a checkpoint's tree paths do not match ``like``'s.

    Carries the offending key sets (``missing``, ``extra``) so drivers can
    report exactly what drifted between the saved run and the restoring
    code (a renamed layer, a dropped optimizer slot, ...)."""

    def __init__(self, missing, extra):
        self.missing = tuple(sorted(missing))
        self.extra = tuple(sorted(extra))
        super().__init__(
            "checkpoint structure mismatch: "
            f"missing from checkpoint: {list(self.missing) or '-'}; "
            f"unexpected in checkpoint: {list(self.extra) or '-'}")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in tree-flatten order (dict keys sorted)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    else:
        out[prefix] = tree
    return out


def _encode(leaf) -> tuple:
    """(storable numpy array, dtype tag or None) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for name, dt in _EXT_DTYPES.items():
            if t.dtype == dt:
                return t.view(_UINT[t.element_size()]).numpy(), name
        return t.numpy(), None
    a = np.asarray(leaf)
    if a.dtype.kind == "V":       # an ml_dtypes array
        return a.view(f"u{a.dtype.itemsize}"), a.dtype.name
    return a, None


def _decode(arr: np.ndarray, name: Optional[str]):
    if name is None:
        return arr
    if name not in _EXT_DTYPES:
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch "
                         f"equivalent here")
    return torch.from_numpy(arr).view(_EXT_DTYPES[name])


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict] = None
                    ) -> None:
    """Atomically write ``tree`` (+ json-able ``meta``) to ``path``.

    The archive lands under exactly ``path`` (no implicit ``.npz``
    suffix), via a temp file in the same directory and ``os.replace``,
    so readers always see either the old checkpoint or the new one —
    never a torn write."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    stored, tags = {}, {}
    for k, leaf in _flatten(tree).items():
        stored[k], tag = _encode(leaf)
        if tag is not None:
            tags[k] = tag
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta or {}),
                     __dtypes__=json.dumps(tags), **stored)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any = None):
    """Returns (tree, meta). If ``like`` is given, reshapes into its
    structure (raising :class:`CheckpointStructureError` naming the
    missing/extra tree paths on any mismatch), with a torch tensor where
    ``like`` holds one; otherwise returns the flat {path: leaf} dict.
    Leaves are numpy arrays of the saved dtype, except extension dtypes,
    which come back as torch tensors of that dtype, bit for bit."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        tags = (json.loads(str(z["__dtypes__"]))
                if "__dtypes__" in z.files else {})
        flat = {k: _decode(z[k], tags.get(k)) for k in z.files
                if k not in ("__meta__", "__dtypes__")}
    if like is None:
        return flat, meta
    flat_like = _flatten(like)
    if set(flat_like) != set(flat):
        raise CheckpointStructureError(
            missing=set(flat_like) - set(flat),
            extra=set(flat) - set(flat_like))
    leaves = []
    for k, ref in flat_like.items():
        v = flat[k]
        if isinstance(ref, torch.Tensor) and not isinstance(v,
                                                            torch.Tensor):
            v = torch.from_numpy(v)
        leaves.append(v)
    return tr.tree_unflatten(tr.tree_flatten(like)[1], leaves), meta
