"""Federated data pipeline: synthetic datasets + non-IID partitioners.

Reproduces the paper's two partition regimes (§6.1):
- device-level non-IID via Dirichlet(alpha) over label proportions [41];
- cluster-level IID / non-IID via sort-by-label sharding, where each cluster
  gets C label classes and each device within a cluster gets 2 shards.

Datasets are synthetic (no network access in this environment): Gaussian
class-conditional images whose class means make the task learnable, which is
sufficient to reproduce the paper's *relative* algorithm orderings.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------

def make_synthetic_classification(
        num_samples: int, d: int, num_classes: int, *, seed: int = 0,
        noise: float = 1.0, means_seed: int = 1234
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Class means come from ``means_seed`` (fixed) so train/test splits
    drawn with different ``seed`` values share the same task."""
    means = np.random.default_rng(means_seed).normal(
        size=(num_classes, d)) * 2.0
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_samples)
    x = means[y] + rng.normal(size=(num_samples, d)) * noise
    return x.astype(np.float32), y.astype(np.int32)


def make_synthetic_images(
        num_samples: int, hw: int, channels: int, num_classes: int, *,
        seed: int = 0, noise: float = 0.7, means_seed: int = 1234
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images, (N, H, W, C). Class means come
    from ``means_seed`` so train/test splits share the same task."""
    means = np.random.default_rng(means_seed).normal(
        size=(num_classes, hw, hw, channels)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_samples)
    x = means[y] + rng.normal(size=(num_samples, hw, hw, channels)) * noise
    return x.astype(np.float32), y.astype(np.int32)


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

def dirichlet_partition(y: np.ndarray, n_devices: int, alpha: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    """Hsu et al. [41]: per-class Dirichlet split across devices."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_per_device: List[List[int]] = [[] for _ in range(n_devices)]
    for c in classes:
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_devices)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for dev, part in enumerate(np.split(idx, cuts)):
            idx_per_device[dev].extend(part.tolist())
    return [np.asarray(sorted(ix)) for ix in idx_per_device]


def shard_by_label(y: np.ndarray, n_devices: int, shards_per_device: int = 2,
                   seed: int = 0) -> List[np.ndarray]:
    """McMahan-style pathological non-IID: sort by label, deal shards."""
    rng = np.random.default_rng(seed)
    order = np.argsort(y, kind="stable")
    shards = np.array_split(order, n_devices * shards_per_device)
    ids = rng.permutation(len(shards))
    out = []
    for d in range(n_devices):
        take = ids[d * shards_per_device:(d + 1) * shards_per_device]
        out.append(np.concatenate([shards[t] for t in take]))
    return out


def cluster_partition(y: np.ndarray, m: int, devices_per_cluster: int, *,
                      cluster_iid: bool, labels_per_cluster: int = 2,
                      seed: int = 0) -> List[np.ndarray]:
    """Paper §6.2 'Cluster IID' / 'Cluster Non-IID' (C = labels_per_cluster).

    Returns n = m * devices_per_cluster index arrays, cluster-major order.
    """
    rng = np.random.default_rng(seed)
    n_total = len(y)
    if cluster_iid:
        perm = rng.permutation(n_total)
        cluster_chunks = np.array_split(perm, m)
    else:
        order = np.argsort(y, kind="stable")
        shards = np.array_split(order, labels_per_cluster * m)
        ids = rng.permutation(len(shards))
        cluster_chunks = []
        for i in range(m):
            take = ids[i * labels_per_cluster:(i + 1) * labels_per_cluster]
            cluster_chunks.append(np.concatenate([shards[t] for t in take]))
    out: List[np.ndarray] = []
    for chunk in cluster_chunks:
        # within each cluster: sort by label, 2 shards per device (paper)
        chunk = chunk[np.argsort(y[chunk], kind="stable")]
        dev_shards = np.array_split(chunk, devices_per_cluster * 2)
        ids2 = rng.permutation(len(dev_shards))
        for d in range(devices_per_cluster):
            take = ids2[d * 2:(d + 1) * 2]
            out.append(np.concatenate([dev_shards[t] for t in take]))
    return out


def build_fl_data(x: np.ndarray, y: np.ndarray, parts: List[np.ndarray],
                  test_x: np.ndarray, test_y: np.ndarray,
                  samples_per_device: Optional[int] = None) -> Dict:
    """Stack per-device shards to (n, N, ...) with equal N (resample)."""
    n = len(parts)
    N = samples_per_device or min(len(p) for p in parts)
    N = max(N, 1)
    xs, ys = [], []
    rng = np.random.default_rng(0)
    for p in parts:
        if len(p) >= N:
            sel = p[:N]
        else:  # resample with replacement for tiny shards
            sel = rng.choice(p, size=N, replace=True) if len(p) else \
                rng.integers(0, len(y), N)
        xs.append(x[sel])
        ys.append(y[sel])
    return {
        "xs": np.stack(xs), "ys": np.stack(ys),
        "test_x": test_x, "test_y": test_y,
    }
