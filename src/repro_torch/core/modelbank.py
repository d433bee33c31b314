"""Flat ModelBank: the simulation engine's resident state as (n, T) buffers
(port of ``repro.core.modelbank``).

The paper-faithful engine materializes all n device models (eq. 10
stacks them row-wise). The bank keeps params and momentum as single
contiguous ``(n, T)`` float32 tensors on one device for the whole run;
parameter trees are views made only inside the per-device apply call
and at evaluation, and every mixing boundary is one streaming pass of
:func:`repro_torch.kernels.gossip_mix.gossip_mix_rows`. The streamed
engine wraps each round's paged-in working set as a bank of its own
(:meth:`ModelBank.from_rows`), sized by :func:`cohort_buckets`; a
compacted scenario round gathers its cohort by :func:`compact_plan`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_mix import FlatLayout, gossip_mix_rows


class ModelBank:
    """Params and momentum of all n devices as (n, T) f32 tensors.

    ``layout`` is the :class:`FlatLayout` of one device model. The
    buffers are plain attributes: the round updates them in place on the
    card and reassigns them where an operation returns a new tensor."""

    def __init__(self, layout: FlatLayout, n: int, params_row: torch.Tensor,
                 *, device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        self.layout = layout
        self.n = n
        self.params = params_row.to(dev, torch.float32)[None, :].repeat(n, 1)
        self.mom = torch.zeros((n, layout.total), dtype=torch.float32,
                               device=dev)

    @classmethod
    def from_model(cls, one_model, n: int, *,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "ModelBank":
        """Broadcast a single init model to all n rows (Algorithm 1's
        shared init)."""
        layout = FlatLayout.for_tree(one_model)
        return cls(layout, n, layout.flatten_one(one_model), device=device)

    @classmethod
    def from_rows(cls, layout: FlatLayout, params_rows, mom_rows, *,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "ModelBank":
        """Wrap host-paged (S, T) numpy rows as a hot slab bank, copied to
        ``device``: the streamed engine's per-round working set
        (``core/clientstore.py``)."""
        dev = resolve_device(device)
        params = torch.as_tensor(np.asarray(params_rows, np.float32))
        mom = torch.as_tensor(np.asarray(mom_rows, np.float32))
        S, T = params.shape
        if T != layout.total or tuple(mom.shape) != (S, T):
            raise ValueError(f"slab rows {tuple(params.shape)} / "
                             f"{tuple(mom.shape)} do not match T="
                             f"{layout.total}")
        self = cls.__new__(cls)
        self.layout = layout
        self.n = S
        self.params = params.to(dev, copy=True)
        self.mom = mom.to(dev, copy=True)
        return self

    @property
    def resident_nbytes(self) -> int:
        """Device-resident bytes of the bank's buffers."""
        return int(self.params.nbytes + self.mom.nbytes)

    def params_tree(self):
        """The (n, ...)-leaved tree view of the params (eval edge)."""
        return self.layout.unflatten_stack(self.params)

    def mean_model(self):
        """Device-average model as a tree (the global model x̄)."""
        return self.layout.unflatten_one(self.params.mean(0))

    def project(self, P):
        """Row-apply a rectangular (m, n) operator to the bank and
        materialize the m resulting models as a tree — the edge-model
        projection of eq. 11 in one streaming pass."""
        return self.layout.unflatten_stack(gossip_mix_rows(P, self.params))


# ---------------------------------------------------------------------------
# slab and cohort capacities: static bucket sizes, padded gather plans
# ---------------------------------------------------------------------------

def cohort_buckets(n: int) -> Tuple[int, ...]:
    """Static cohort capacities: powers of two up to n, plus n itself.

    A streamed round's slab is padded up to one of these, so a scenario
    whose cohort size wanders round to round sees at most
    ``len(cohort_buckets(n))`` slab shapes."""
    assert n >= 1
    out = []
    b = 1
    while b < n:
        out.append(b)
        b <<= 1
    out.append(n)
    return tuple(out)


def bucket_for(k: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket capacity >= k."""
    for b in buckets:
        if b >= k:
            return b
    raise ValueError(f"cohort {k} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    """Padded gather plan for one round's cohort.

    ``idx`` holds ``k_pad`` *distinct* device rows: the k participants
    first, then non-participants as inert padding; ``lane`` marks the
    real cohort lanes. Distinctness makes the scatter back into the bank
    (``index_copy_``) write disjoint rows — deterministic, and the
    padding lanes write back their untouched values."""
    idx: np.ndarray     # (k_pad,) int32, distinct
    lane: np.ndarray    # (k_pad,) bool
    k: int              # true cohort size
    k_pad: int          # bucket capacity


def compact_plan(mask: np.ndarray,
                 buckets: Optional[Tuple[int, ...]] = None) -> CompactPlan:
    """Build the padded cohort gather plan for a 0/1 participation mask."""
    mask = np.asarray(mask)
    n = mask.shape[0]
    if buckets is None:
        buckets = cohort_buckets(n)
    cohort = np.nonzero(mask > 0)[0]
    k = int(cohort.shape[0])
    assert k >= 1, "compact_plan needs at least one participant"
    k_pad = bucket_for(k, buckets)
    pad = k_pad - k
    if pad:
        complement = np.nonzero(mask <= 0)[0]
        cohort = np.concatenate([cohort, complement[:pad]])
    lane = np.zeros(k_pad, bool)
    lane[:k] = True
    return CompactPlan(cohort.astype(np.int32), lane, k, k_pad)
