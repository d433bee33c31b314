"""Configuration of the port: the paper's federated-learning knobs.

Port of ``repro.config``'s :class:`FLConfig` (plain dataclasses, no
external deps). The language-model, scenario and population configs
arrive with the slices that use them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Federated learning (the paper's knobs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FLConfig:
    algorithm: str = "ce_fedavg"   # ce_fedavg | fedavg | hier_favg | local_edge | dec_local_sgd
    num_clusters: int = 4          # m
    devices_per_cluster: int = 4   # n_i (equal clusters by default)
    tau: int = 2                   # intra-cluster aggregation period
    q: int = 8                     # edge rounds per global round
    pi: int = 10                   # gossip steps per inter-cluster aggregation
    topology: str = "ring"         # ring | complete | star | torus | erdos_renyi
    er_prob: float = 0.4           # for erdos_renyi
    topology_seed: int = 0
    mixing: str = "metropolis"     # metropolis | uniform_neighbor
    # sharded-trainer mapping; all three backends support every topology:
    #   dense      paper-faithful (R,R)·(R,…) contraction (all-gather)
    #   sparse     π gossip rounds of weighted neighbor ppermute matchings
    #   ringweight exact H^π in M−1 weighted cyclic rotations
    gossip_impl: str = "dense"
    cluster_axis: str = "data"     # mesh axis along which replicas/clusters live
    # depth>2 hierarchies: branching factors root→leaf, e.g. (2, 2, 2) =
    # 2 regions × 2 edges × 2 devices. () keeps the paper's two tiers
    # (num_clusters, devices_per_cluster). When set, the last entry must
    # equal devices_per_cluster and the product of the rest num_clusters,
    # so the depth-2 projection of the hierarchy IS the existing config.
    hierarchy: Tuple[int, ...] = ()

    GOSSIP_IMPLS = ("dense", "sparse", "ringweight")

    @property
    def n(self) -> int:
        return self.num_clusters * self.devices_per_cluster

    @property
    def tiers(self) -> Tuple[int, ...]:
        """Resolved branching factors root→leaf: ``hierarchy`` when set,
        else the two-tier ``(num_clusters, devices_per_cluster)``."""
        return tuple(self.hierarchy) or (self.num_clusters,
                                         self.devices_per_cluster)

    @property
    def depth(self) -> int:
        """Number of hierarchy tiers (2 for the paper's device→edge)."""
        return len(self.tiers)

    def round_program(self, *, privatize: bool = False,
                      compress: bool = False):
        """Compile this config's τ/q/π knobs into the canonical
        :class:`repro_torch.core.program.RoundProgram` — the declarative round
        schedule every engine lowers (see ``core/program.py``)."""
        from repro_torch.core.program import canonical_program
        return canonical_program(self, privatize=privatize,
                                 compress=compress)

    def validate(self) -> None:
        assert self.algorithm in (
            "ce_fedavg", "fedavg", "hier_favg", "local_edge", "dec_local_sgd")
        assert self.tau >= 1 and self.q >= 1 and self.pi >= 1
        assert self.num_clusters >= 1 and self.devices_per_cluster >= 1
        from repro_torch.core.topology import TOPOLOGIES  # single source of truth
        assert self.topology in TOPOLOGIES, \
            f"unknown topology {self.topology!r}"
        assert self.gossip_impl in self.GOSSIP_IMPLS, \
            f"unknown gossip_impl {self.gossip_impl!r}"
        if self.topology == "torus":
            side = int(round(self.num_clusters ** 0.5))
            assert side * side == self.num_clusters, \
                "torus backhaul needs a square number of clusters"
        if self.topology == "erdos_renyi":
            assert 0.0 < self.er_prob <= 1.0, \
                f"er_prob must be in (0, 1], got {self.er_prob}"
        if self.hierarchy:
            tiers = tuple(self.hierarchy)
            assert len(tiers) >= 2, \
                f"hierarchy needs >= 2 tiers, got {tiers}"
            assert all(t >= 1 for t in tiers), \
                f"hierarchy branching factors must be >= 1: {tiers}"
            prod = 1
            for t in tiers[:-1]:
                prod *= t
            assert prod == self.num_clusters, \
                f"prod(hierarchy[:-1])={prod} != num_clusters=" \
                f"{self.num_clusters}"
            assert tiers[-1] == self.devices_per_cluster, \
                f"hierarchy[-1]={tiers[-1]} != devices_per_cluster=" \
                f"{self.devices_per_cluster}"
            if len(tiers) > 2:
                assert self.algorithm == "ce_fedavg", \
                    "depth>2 hierarchies exist for ce_fedavg only " \
                    f"(got {self.algorithm!r})"
        if self.gossip_impl in ("sparse", "ringweight"):
            # the sparse backends lower the inter-cluster operator with
            # collectives; that path exists for the gossip algorithms only
            assert self.algorithm in ("ce_fedavg", "dec_local_sgd"), \
                f"{self.gossip_impl!r} backend requires a gossip algorithm" \
                f" (ce_fedavg/dec_local_sgd), not {self.algorithm!r}"
