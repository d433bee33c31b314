"""Carry weights from the JAX package's parameter trees into the port.

A reference parameter tree (nested dicts and lists of arrays, e.g.
``jax.device_get(init_femnist_cnn(key))`` or the LM tree of
``jax.device_get(init_model(key, cfg)[0])``) keeps its structure and
layout in the port — conv weights HWIO, dense weights (fan_in,
fan_out), attention weights (d, heads, head_dim), stacked layer axes —
so conversion copies leaves and nothing else.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch import tree as tr


def leaf_from_numpy(leaf, device: Union[str, torch.device] = "cpu"
                    ) -> torch.Tensor:
    """One leaf as a tensor on ``device``, same dtype and shape. A
    bfloat16 leaf (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does
    not take) crosses bit for bit as its uint16 view."""
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_from_numpy(tree, device: Union[str, torch.device] = "cpu"):
    """The same tree with every leaf a tensor on ``device`` (same dtype
    and shape as the numpy view of the leaf; bf16 leaves bit for bit)."""
    return tr.tree_map(lambda leaf: leaf_from_numpy(leaf, device), tree)


def row_from_numpy(tree, device: Union[str, torch.device] = "cpu"
                   ) -> torch.Tensor:
    """The tree as one flat f32 row in ``jax.tree.flatten`` order — the
    bytes of the reference's ``FlatLayout.flatten_one(tree)``."""
    leaves = [np.asarray(leaf, np.float32).reshape(-1)
              for leaf in tr.tree_leaves(tree)]
    return torch.from_numpy(np.concatenate(leaves)).to(device)
