"""Communicator-group registry: named per-tier collective groups (port of
``repro.core.groups``).

The :class:`GroupRegistry` builds a ``(FLConfig, ReplicaMesh)``'s tier
state once and exposes it by tier name: ``device`` (intra-cluster),
``edge`` (backhaul gossip) and deeper tiers (``region``, ``tier3``, …),
each a :class:`TierGroups` with its member lists, mean and gossip
wrappers over the flat replica axis, and a cached per-tier
:class:`~repro_torch.core.gossip.GossipSchedule`. Engines query the
registry instead of recomputing group math inline.

Tier semantics (:class:`repro_torch.core.topology.Hierarchy`): a
``TierMix(level)`` averages each tier-``level`` device group, then (for
``level >= 1``) gossips among the ``num_siblings`` aggregation nodes
under each common parent — a block-diagonal mixing matrix
``kron(I, H_block)``, which the edge-colored ``GossipSchedule`` lowers
unchanged because the groups are contiguous in the flat replica
numbering.

The registry owns the tiers' process subgroups: it makes them when it
is built (``new_group`` is collective, so every rank builds its
registries in the same order) and keeps them on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np

from repro_torch.config import FLConfig
from repro_torch.core import collectives as col
from repro_torch.core import gossip as gsp
from repro_torch.core import topology as topo
from repro_torch.launch.mesh import ReplicaMesh


@dataclasses.dataclass(frozen=True)
class TierGroups:
    """One tier's communicator groups: ``members[g]`` lists the flat
    replica ids averaged together by ``TierMix(level)`` (contiguous under
    the static assignment), so ``len(members)`` groups of ``group_size``
    replicas partition the flat replica axis."""
    name: str
    level: int
    num_groups: int
    group_size: int
    members: Tuple[Tuple[int, ...], ...]


class GroupRegistry:
    """Per-(FLConfig, ReplicaMesh) registry of tiered communicator groups.

    Built once (:func:`get_registry` returns the cached instance) and
    queried everywhere: ``tier(level_or_name)`` returns the
    :class:`TierGroups`, ``mean_in_body``/``gossip_in_body`` apply the
    tier's collective to this rank's rows, ``mixing``/``operator``
    expose the dense H_ℓ and (n, n) forms, and ``gossip_schedule``
    caches the edge-colored ppermute plan per ``(level, pi, mode)``."""

    def __init__(self, fl: FLConfig, mesh: ReplicaMesh):
        fl.validate()
        self.fl = fl
        self.mesh = mesh
        self.hier = topo.Hierarchy.from_config(fl)
        R = col.flat_axis_size(mesh)
        if self.hier.n != R:
            raise ValueError(
                f"hierarchy has {self.hier.n} leaf devices but the mesh's "
                f"flat replica axis has {R}")
        tiers = []
        for lvl in range(self.hier.depth):
            ng = self.hier.num_groups(lvl)
            gs = self.hier.group_size(lvl)
            members = tuple(tuple(range(g * gs, (g + 1) * gs))
                            for g in range(ng))
            tiers.append(TierGroups(
                name=self.hier.tier_name(lvl), level=lvl,
                num_groups=ng, group_size=gs, members=members))
            if gs > 1:
                col.subgroup(mesh, members)
        self._tiers: Tuple[TierGroups, ...] = tuple(tiers)
        self._by_name: Dict[str, TierGroups] = {t.name: t for t in tiers}
        self._mixing: Dict[int, np.ndarray] = {}
        self._scheds: Dict[Tuple[int, int, str], gsp.GossipSchedule] = {}

    # -- lookup -------------------------------------------------------------
    @property
    def depth(self) -> int:
        return self.hier.depth

    def tier(self, key: Union[int, str]) -> TierGroups:
        """The tier's groups, by level (int) or name ('device', 'edge',
        'region', 'tier<ℓ>')."""
        if isinstance(key, str):
            return self._by_name[key]
        return self._tiers[key]

    # -- dense forms (host-side numpy) --------------------------------------
    def mixing(self, level: int) -> np.ndarray:
        """H_ℓ: the (num_nodes, num_nodes) block-diagonal Metropolis
        mixing matrix of tier ``level`` >= 1, cached."""
        if level not in self._mixing:
            self._mixing[level] = self.hier.mixing(
                level, self.fl.topology, self.fl.mixing, self.fl)
        return self._mixing[level]

    def operator(self, level: int, pi: int = 1) -> np.ndarray:
        """Dense (n, n) ``TierMix(level, pi)`` operator under the static
        contiguous assignment."""
        return self.hier.tier_operator(
            level, pi, self.fl.topology, self.fl.mixing, self.fl)

    def stale_operator(self, level: int, pi: int, phases, staleness: int,
                       advancing) -> np.ndarray:
        """Dense ``TierMix(level, pi)`` operator gated for one async event
        (:func:`repro_torch.core.gossip.staleness_mask`)."""
        labels = np.repeat(np.arange(self.fl.num_clusters),
                           self.fl.devices_per_cluster)
        return gsp.staleness_mask(self.operator(level, pi), labels,
                                  phases, staleness, advancing)

    def faulted_operator(self, level: int, pi: int,
                         cluster_down) -> np.ndarray:
        """Dense ``TierMix(level, pi)`` operator degraded for an
        edge-outage round (:func:`repro_torch.core.gossip.fault_gate`);
        bitwise :meth:`operator` when nothing is down."""
        labels = np.repeat(np.arange(self.fl.num_clusters),
                           self.fl.devices_per_cluster)
        return gsp.fault_gate(self.operator(level, pi), labels,
                              cluster_down)

    def gossip_schedule(self, level: int, pi: int,
                        mode: str = "rounds") -> gsp.GossipSchedule:
        """The tier's sparse ppermute plan: H_ℓ edge-colored into
        matchings over ``node_size(level)``-wide nodes; cached per
        ``(level, pi, mode)``. Block-diagonal H_ℓ colors into per-parent
        matchings that never cross parents."""
        key = (level, pi, mode)
        if key not in self._scheds:
            self._scheds[key] = gsp.GossipSchedule.build(
                self.mixing(level), pi, self.hier.node_size(level),
                mode=mode)
        return self._scheds[key]

    # -- collectives on this rank's f32 rows --------------------------------
    def mean_in_body(self, p, level: int):
        """Average this rank's f32 rows over its tier group (one grouped
        ``all_reduce`` a leaf)."""
        t = self.tier(level)
        if t.group_size == 1:
            return p
        return gsp.group_mean_in_body(self.mesh, p, t.members)

    def gossip_in_body(self, p, level: int, pi: int,
                       mode: str = "rounds"):
        """π gossip rounds among tier-``level`` sibling nodes, applied to
        this rank's f32 rows via the tier's cached schedule."""
        return gsp.gossip_in_body(
            self.gossip_schedule(level, pi, mode), self.mesh, p)

    # -- collectives on this rank's params of any dtype ---------------------
    def mean(self, params, level: int):
        """Tier mean of this rank's params (mixed in f32, cast back)."""
        if self.tier(level).group_size == 1:
            return params
        return gsp.cast_like(params,
                             self.mean_in_body(gsp.cast_f32(params), level))

    def gossip(self, params, level: int, pi: int, mode: str = "rounds"):
        """Tier gossip of this rank's params via the tier's cached
        schedule (:func:`repro_torch.core.gossip.apply_gossip`)."""
        return gsp.apply_gossip(self.gossip_schedule(level, pi, mode),
                                params, self.mesh)

    # -- introspection -------------------------------------------------------
    def describe(self) -> str:
        """Human-readable tier → group table (one line per tier)."""
        return "\n".join(
            f"level {t.level} ({t.name}): {t.num_groups} groups × "
            f"{t.group_size} replicas" for t in self._tiers)


def get_registry(fl: FLConfig, mesh: ReplicaMesh) -> GroupRegistry:
    """The registry for ``(fl, mesh)``, built once and kept on the mesh —
    shared by every engine touching the same config and mesh."""
    reg = mesh.registries.get(fl)
    if reg is None:
        reg = mesh.registries[fl] = GroupRegistry(fl, mesh)
    return reg

