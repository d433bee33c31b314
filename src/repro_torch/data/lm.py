"""Synthetic language-model token streams (numpy; port of
``repro.data.lm``).

Deterministic, seeded, cheap: a mixture of per-device Markov chains so that
different federated replicas see genuinely non-identical token
distributions (the inter-/intra-cluster divergence knobs of the paper map
to how distinct the per-cluster transition matrices are).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_lm_batch(shape: Tuple[int, ...], vocab: int, *,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """Uniform random tokens (used for smoke tests / dry-run stand-ins)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, shape, dtype=np.int32)
    labels = np.roll(tokens, -1, axis=-1)
    return {"tokens": tokens, "labels": labels}


class TokenStream:
    """Per-replica Markov token stream with cluster-level skew.

    replica r in cluster c gets transition bias seeded by (c, r) so that
    intra-cluster divergence < inter-cluster divergence, mirroring the
    paper's Assumptions 5/6.
    """

    def __init__(self, vocab: int, num_replicas: int, cluster_of, *,
                 order_skew: float = 0.8, seed: int = 0):
        self.vocab = vocab
        self.R = num_replicas
        self._shift = np.empty(num_replicas, np.int64)
        # the reference seeds an rng here but draws nothing from it; its
        # shift reduces to (cluster * 7919 + replica % 3) mod vocab
        for r in range(num_replicas):
            base = (cluster_of(r) * 7919) % vocab
            self._shift[r] = (base + r % 3) % vocab
        self._step = 0

    def next_batch(self, per_replica_shape: Tuple[int, ...]
                   ) -> Dict[str, np.ndarray]:
        """Returns tokens/labels of shape (R, *per_replica_shape)."""
        self._step += 1
        rng = np.random.default_rng(self._step)
        base = rng.integers(0, self.vocab, (self.R,) + tuple(per_replica_shape),
                            dtype=np.int64)
        tokens = (base + self._shift[(...,) + (None,) * len(per_replica_shape)]
                  ) % self.vocab
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=-1)
        return {"tokens": tokens, "labels": labels}
