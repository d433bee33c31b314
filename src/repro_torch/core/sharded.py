"""Device-parallel flat-bank CE-FedAvg over ``torch.distributed`` (port of
the bank half of ``repro.core.sharded``): one bank row per rank for the
whole run.

Each rank runs the same host program (plans, schedules, the key stream
are replicated, as the reference's single controller computes them
once) on its own ``(1, T)`` rows of params, momentum and EF residual;
the mixing boundaries are collectives over the flat replica axis
(``core/collectives.py``, ``core/gossip.py``), so the full ``(n, T)``
bank never sits on one device — init, rounds, evaluation and checkpoint
restore included. No kernel runs on this path, as in the reference: the
boundaries are collectives, not the gossip-mix kernel.

The reference's pytree trainer (``ShardedCEFedAvg``) waits for A15 and
its sharded streamed bank (``ShardedStreamedBank``) for ROADMAP A14's
streamed half, the first item of queue A.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import collectives as col
from repro_torch.core import gossip as gsp
from repro_torch.core import program as prg
from repro_torch.core import topology as topo
from repro_torch.core.cefedavg import FLSimulator
from repro_torch.core.groups import get_registry
from repro_torch.core.modelbank import ModelBank
from repro_torch.launch.mesh import ReplicaMesh


@dataclasses.dataclass(frozen=True)
class ReplicaGeometry:
    num_replicas: int          # R
    num_clusters: int          # M (global)
    devices_per_cluster: int
    clusters_per_pod: int
    num_pods: int

    @staticmethod
    def build(fl: FLConfig, mesh: ReplicaMesh) -> "ReplicaGeometry":
        data, pods = mesh.data, mesh.pods
        R = data * pods
        M = fl.num_clusters
        if R % M:
            raise ValueError(f"{R} replicas not divisible into {M} clusters")
        dpc = R // M
        if data % dpc:
            raise ValueError("clusters must not span pods")
        return ReplicaGeometry(R, M, dpc, data // dpc, pods)


class ShardedBankCEFedAvg(FLSimulator):
    """The :class:`FLSimulator` ModelBank engine with the ``(n, T)`` bank
    row-sharded over the ranks of a :class:`ReplicaMesh` — one bank row
    (one paper device model) per rank, for the whole run.

    - **static schedule** (no scenario, ``ce_fedavg``): every
      ``TierMix(ℓ, π)`` is the registry tier's grouped mean (one
      ``all_reduce`` over the tier group) plus, for ℓ >= 1, π rounds of
      that tier's edge-colored ``ppermute`` matchings; means dedupe
      through the ``usize`` tracker, so the fused τ∘qτ boundary stays one
      mean + one gossip pass at any depth — O(π·deg·T) neighbor bytes.
    - **scenario rounds** (masked, mobile, faulted), the non-gossip
      baselines and async events: the exact dense operators, row-applied
      by R−1 weighted rotations (:func:`repro_torch.core.gossip.
      dense_mix_rows`).

    Key schedule, batch draws (each rank draws the single-process ``(n,
    batch)`` indices and takes its row), SGD+momentum, adaptive
    ``tau_dev`` cut-offs and the upload branch (DP, then compression
    with the rank's key of ``split(key, n)`` and its EF residual row)
    are the single-process engine's, row for row. Cohort compaction is
    off (rows are pinned to ranks): a partial cohort trains mask-frozen.
    Evaluation never gathers the bank: each rank adds its row times its
    column of the projection and one ``all_reduce`` sums the (m, T) edge
    models. A run checkpoint gathers the rows to rank 0's host, which
    writes the single-process engine's file; a restore gives each rank
    its own rows (:meth:`ModelBank.load_rows`)."""

    def __init__(self, init_fn: Callable, apply_fn: Callable, fl: FLConfig,
                 data: Dict[str, object], mesh: ReplicaMesh, **kw):
        if kw.get("streaming") or kw.get("pipeline") or (
                kw.get("scenario") is not None
                and kw["scenario"].population is not None):
            raise NotImplementedError(
                "ShardedBankCEFedAvg holds enumerated rows; the sharded "
                "streamed bank is ROADMAP A14's ShardedStreamedBank")
        device = kw.pop("device", None)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        R = col.flat_axis_size(mesh)
        if fl.n != R:
            raise ValueError(f"need one bank row per replica device: "
                             f"n={fl.n}, devices={R}")
        self.mesh = mesh
        self.geo = ReplicaGeometry.build(fl, mesh)
        self.registry = get_registry(fl, mesh)
        super().__init__(init_fn, apply_fn, fl, data, device=mesh.device,
                         **kw)
        rows = self.bank.rows
        for k in ("xs", "ys"):
            self.data[k] = self.data[k][rows].clone()
        # rows are pinned to ranks: no cohort compaction; scenario rounds
        # run mask-frozen on the full (sharded) bank instead
        self._compact_enabled = False

    def _make_bank(self, one, n: int, with_residual: bool) -> ModelBank:
        return ModelBank.from_model_sharded(one, n, self.mesh,
                                            with_residual=with_residual)

    def _host_rows(self, buf: torch.Tensor) -> Optional[np.ndarray]:
        """The (n, T) rows gathered into rank 0's host memory (None on
        the other ranks)."""
        return col.gather_rows(buf, self.mesh)

    # -- the sharded round ---------------------------------------------------
    def _lower_compact(self, program):
        """Never dispatched: rows are pinned to ranks, so compaction (a
        cross-rank cohort gather) is disabled in ``__init__``."""
        raise AssertionError("ShardedBankCEFedAvg disables cohort "
                             "compaction")

    def _mixer(self, program: prg.RoundProgram,
               block_keyed: bool = False) -> Callable:
        """A block's MixGroups as collectives on this rank's rows (the
        parent's lowered rounds take the rank's rows of each draw, mask
        and ``tau_dev``):

        - on the static ``ce_fedavg`` path each ``TierMix(ℓ, π)`` is the
          registry's grouped mean plus, for ℓ >= 1 with siblings, π
          rounds of its cached gossip matchings; ``usize`` tracks the
          tier group size at which rows are already uniform (1 = not),
          so consecutive tier means dedupe into one (V idempotent,
          W_inter's leading B^T…B, and any coarser tier implying the
          finer ones); gossip at tier ℓ keeps rows node-uniform at ℓ and
          resets ``usize`` to its size;
        - otherwise (scenario, fault and baseline operators, and the
          staleness-masked operators of a ``block_keyed`` async event,
          arbitrary row-stochastic matrices the structured collectives
          cannot express) each group's dense operator by weighted
          rotations."""
        mesh, registry = self.mesh, self.registry
        if not (self.engine is None and self.fl.algorithm == "ce_fedavg"
                and not block_keyed):
            def dense(bp, mats, Y, lo=0, hi=None):
                for W in mats[lo:hi]:
                    Y = gsp.dense_mix_rows(W, Y, mesh)
                return Y
            return dense
        gsize = tuple(registry.tier(lvl).group_size
                      for lvl in range(registry.depth))

        def structured(bp, mats, Y, lo=0, hi=None):
            usize = 1
            for g in bp.groups[lo:hi]:
                for op in g.ops:
                    s = gsize[op.level]
                    if usize < s:
                        Y = registry.mean_in_body(Y, op.level)
                        usize = s
                    if (op.level >= 1
                            and registry.hier.num_siblings(op.level) > 1):
                        Y = gsp.gossip_in_body(
                            registry.gossip_schedule(op.level, op.pi),
                            mesh, Y)
                        usize = s
            return Y
        return structured

    # -- evaluation: never gathers the bank ----------------------------------
    def edge_models(self):
        """The m edge models y_t: each rank adds its rows times its
        columns of the (m, n) projection; one ``all_reduce`` sums them."""
        B = topo.assignment_matrix(self.labels, self.fl.num_clusters)
        P = torch.from_numpy(np.asarray(
            topo.masked_cluster_average(B), np.float32)[:, self.bank.rows])
        E = P.to(self.device) @ self.bank.params
        return self.layout.unflatten_stack(col.all_reduce(E, self.mesh))

    def global_model(self):
        """Device-average model x̄ (one ``all_reduce`` of the rows'
        sum)."""
        total = col.all_reduce(self.bank.params.sum(0), self.mesh)
        return self.layout.unflatten_one(total / self.sched.n)
