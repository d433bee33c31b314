"""Privacy substrates the paper claims compatibility with (§4.1), port of
``repro.core.privacy``:

- **Secure aggregation** (Bonawitz et al. [26]): pairwise additive masks
  that cancel in the intra-cluster sum, so the edge server learns only
  Σ_k x_k — possible because CE-FedAvg's W_t operators only ever consume
  sums (eq. 6/7).
- **(Local) differential privacy** ([28]–[30]): per-device L2 clipping +
  Gaussian noise on the uploaded update, with the standard Gaussian-
  mechanism accountant for a single release.

Every mask and noise draw is the reference's ``jax.random.normal`` at the
same key (:func:`repro_torch.random.normal`: the uniforms bit for bit,
``erf_inv`` within 2 ulp), drawn on the device of the update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tree as tr

#: columns of one noise draw of :func:`privatize_update_flat`: bounds the
#: draw's int32 and f32 temporaries to a few of these a row
_NOISE_COLUMNS = 1 << 22


# ---------------------------------------------------------------------------
# secure aggregation (pairwise masking)
# ---------------------------------------------------------------------------

def _pair_key(seed: int, i: int, j: int) -> np.ndarray:
    return rnd.PRNGKey(seed * 1_000_003 + i * 1009 + j)


def mask_update(tree: Any, device: int, cluster: List[int], *,
                seed: int = 0, scale: float = 1.0) -> Any:
    """Add pairwise-cancelling masks: device k adds +PRG(k,j) for j>k and
    -PRG(j,k) for j<k (within its cluster). Σ over the cluster is exact."""
    def mask_leaf(path_idx, leaf):
        m = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
        for j in cluster:
            if j == device:
                continue
            lo, hi = min(device, j), max(device, j)
            k = rnd.fold_in(_pair_key(seed, lo, hi), path_idx)
            noise = rnd.normal(k, leaf.shape, leaf.device) * scale
            m = m + noise if device < j else m - noise
        return (leaf.to(torch.float32) + m).to(leaf.dtype)
    leaves, treedef = tr.tree_flatten(tree)
    return tr.tree_unflatten(
        treedef, [mask_leaf(i, leaf) for i, leaf in enumerate(leaves)])


def masked_cluster_sum(trees: List[Any], cluster: List[int], *,
                       seed: int = 0, scale: float = 1.0) -> Any:
    """What the edge server computes: Σ of masked updates (== true Σ)."""
    masked = [tr.tree_leaves(mask_update(t, dev, cluster, seed=seed,
                                         scale=scale))
              for t, dev in zip(trees, cluster)]
    sums = [sum(leaf.to(torch.float32) for leaf in ls)
            for ls in zip(*masked)]
    return tr.tree_unflatten(tr.tree_flatten(trees[0])[1], sums)


# ---------------------------------------------------------------------------
# differential privacy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0   # sigma = noise_multiplier * clip_norm

    @property
    def enabled(self) -> bool:
        return self.noise_multiplier > 0.0


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tr.tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Any:
    n = global_norm(tree)
    factor = torch.clamp_max(max_norm / torch.clamp_min(n, 1e-12), 1.0)
    return tr.tree_map(lambda leaf: (leaf.to(torch.float32) * factor
                                     ).to(leaf.dtype), tree)


def privatize_update(tree: Any, dp: DPConfig, key: np.ndarray) -> Any:
    """Clip to clip_norm, then add N(0, (noise_multiplier*clip)^2); one
    key of ``split(key, leaves)`` a leaf."""
    clipped = clip_by_global_norm(tree, dp.clip_norm)
    if not dp.enabled:
        return clipped
    sigma = dp.noise_multiplier * dp.clip_norm
    leaves, treedef = tr.tree_flatten(clipped)
    keys = rnd.split(key, len(leaves))
    noisy = [(leaf.to(torch.float32)
              + sigma * rnd.normal(k, leaf.shape, leaf.device)
              ).to(leaf.dtype) for leaf, k in zip(leaves, keys)]
    return tr.tree_unflatten(treedef, noisy)


def privatize_update_flat(vec: torch.Tensor, dp: DPConfig,
                          key: np.ndarray) -> torch.Tensor:
    """Flat-domain :func:`privatize_update` for the ModelBank engine.

    ``vec`` is one device's (T,) flattened update, or a batch of rows
    (R, T) with one host key per row (``key`` (R, 2)). The L2 norm of a
    flat row IS the tree's global norm, so clipping matches the pytree
    path; the Gaussian noise is one (T,) draw a row instead of per-leaf
    draws — same mechanism and calibration, different pseudorandom
    stream, the reference's own. The draw is taken in column chunks."""
    v = vec.to(torch.float32)
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    factor = torch.clamp_max(dp.clip_norm / torch.clamp_min(norm, 1e-12),
                             1.0)
    clipped = v * factor
    if dp.enabled:
        sigma = dp.noise_multiplier * dp.clip_norm
        T = vec.shape[-1]
        for c0 in range(0, T, _NOISE_COLUMNS):
            c1 = min(T, c0 + _NOISE_COLUMNS)
            noise = rnd.normal(key, (c1 - c0,), vec.device, offset=c0)
            clipped[..., c0:c1] += noise.mul_(sigma)
            del noise
    return clipped.to(vec.dtype)


def gaussian_epsilon(noise_multiplier: float, delta: float = 1e-5) -> float:
    """Single-release Gaussian-mechanism bound: eps = sqrt(2 ln(1.25/δ))/σ."""
    if noise_multiplier <= 0:
        return float("inf")
    return float(np.sqrt(2.0 * np.log(1.25 / delta)) / noise_multiplier)
