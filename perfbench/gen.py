"""The one generator of the benchmark's inputs: a traffic mix's data and
a configuration's weights, both made from ``--seed``.

The same seed gives the same inputs, and every seed the same sizes. The
program and the plain reference are handed the same arrays.

- ``fl_images``: per-device shards of class-conditional Gaussian images
  (the paper's FEMNIST shapes) with Dirichlet label skew across devices,
  and a common test set;
- ``flat_weights``: one flat f32 row of a configuration's ``leaves``,
  drawn on the device in one call (N(0, 1) / sqrt(fan_in) for weights,
  zeros for biases), and its split into named leaves.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def fl_images(cfg: Dict, mix: Dict, seed: int) -> Dict[str, np.ndarray]:
    """xs (n, N, H, W, C) f32, ys (n, N) int64, test_x (E, H, W, C),
    test_y (E,): class means N(0, 1), noise ``mix["noise"]``, each
    device's labels drawn from its own Dirichlet(``mix["alpha"]``)
    proportions."""
    a = cfg["assumed"]
    n = cfg["num_clusters"] * cfg["devices_per_cluster"]
    N, E = a["samples_per_device"], a["eval_batch"]
    C = cfg["num_classes"]
    shape = tuple(cfg["image"])
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((C,) + shape, dtype=np.float32)
    props = rng.dirichlet([mix["alpha"]] * C, size=n)
    ys = np.stack([rng.choice(C, size=N, p=p) for p in props])
    xs = means[ys] + mix["noise"] * rng.standard_normal(
        ys.shape + shape, dtype=np.float32)
    test_y = rng.integers(0, C, E)
    test_x = means[test_y] + mix["noise"] * rng.standard_normal(
        (E,) + shape, dtype=np.float32)
    return {"xs": xs.astype(np.float32), "ys": ys.astype(np.int64),
            "test_x": test_x.astype(np.float32),
            "test_y": test_y.astype(np.int64)}


def leaf_layout(leaves: List[Dict]) -> List[Tuple[str, Tuple[int, ...],
                                                  int, int]]:
    """(name, shape, offset, size) of each leaf, in the file's order."""
    out, off = [], 0
    for leaf in leaves:
        shape = tuple(leaf["shape"])
        size = int(np.prod(shape))
        out.append((leaf["name"], shape, off, size))
        off += size
    return out


def flat_weights(leaves: List[Dict], seed: int,
                 device: torch.device) -> torch.Tensor:
    """One (T,) f32 row: a single draw on ``device`` from a generator
    seeded with ``seed``, each leaf scaled by 1/sqrt(its ``fan_in``),
    or zero where the leaf has none."""
    lay = leaf_layout(leaves)
    total = lay[-1][2] + lay[-1][3]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    row = torch.randn(total, generator=gen, device=device)
    for leaf, (_, _, off, size) in zip(leaves, lay):
        fan = leaf.get("fan_in")
        if fan:
            row[off:off + size].mul_(1.0 / fan ** 0.5)
        else:
            row[off:off + size].zero_()
    return row


def split_leaves(leaves: List[Dict], row: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The leaves of a flat row (views), by name."""
    return {name: row[off:off + size].view(shape)
            for name, shape, off, size in leaf_layout(leaves)}
