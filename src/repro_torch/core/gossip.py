"""Gossip plans and their lowerings over the replica ranks (port of
``repro.core.gossip``).

- :func:`staleness_mask` gates a dense (n, n) mixing operator for one
  async bounded-staleness event (``FLSimulator.step_round_async``);
- :func:`fault_gate` gates it for edge-server outages (the scenario
  engine's ``FaultPlan``);
- :func:`color_edges` and :class:`GossipSchedule` precompute the
  replica-level permutations and weight tables that realize π
  applications of a backhaul mixing matrix H (``rounds``) or H^π in M−1
  weighted rotations (``exact``), with their traffic counts.

The device half applies a schedule to this rank's rows over
``torch.distributed`` (``core/collectives.py``): :func:`gossip_in_body`
(π rounds of weighted ``ppermute`` matchings, or H^π in M−1 weighted
rotations), :func:`group_mean_in_body` and :func:`cluster_mean_in_body`
(one grouped ``all_reduce``), :func:`dense_mix_rows` (any dense operator
in R−1 weighted rotations), and :func:`apply_gossip` and
:func:`apply_cluster_mean` on a rank's pytree of any dtype. They keep
the reference's weight tables and order of accumulation; Python loops
take the place of its ``fori_loop``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.core import collectives as col
from repro_torch.launch.mesh import ReplicaMesh


def staleness_mask(W: np.ndarray, labels: np.ndarray, phases: np.ndarray,
                   staleness: int, advancing: np.ndarray) -> np.ndarray:
    """Gate a dense (n, n) mixing operator for ONE async event.

    In bounded-staleness execution (``FLSimulator.step_round_async``) a
    mixing boundary fires per *cluster* as soon as that cluster's own
    block clears. ``advancing`` marks the clusters applying this
    boundary: every other device row becomes the identity (their models
    are frozen until their own boundary fires). ``phases`` counts blocks
    completed per cluster; advancing rows additionally drop columns of
    clusters whose phase lags (or leads) the advancing phase by more
    than ``staleness``, folding the removed mass onto the diagonal so
    rows stay stochastic — reading a neighbor within the bound is the
    whole point of async (a bounded-stale read), reading past it is
    forbidden.

    When every cluster advances at one common phase (the s = 0 barrier
    degeneracy) the operator is returned unchanged, bit for bit — what
    makes an s = 0 async round equal the barrier round."""
    labels = np.asarray(labels)
    phases = np.asarray(phases)
    adv = np.asarray(advancing, bool)
    if adv.all() and (phases == phases[0]).all():
        return np.asarray(W, np.float32)
    n = W.shape[0]
    Wm = np.array(W, np.float32, copy=True)
    p = int(phases[adv][0]) if adv.any() else 0
    keep_col = (np.abs(phases - p) <= staleness)[labels]     # (n,)
    row_adv = adv[labels]                                    # (n,)
    Wm = np.where(keep_col[None, :], Wm, 0.0)
    Wm[~row_adv] = np.eye(n, dtype=np.float32)[~row_adv]
    deficit = np.where(row_adv,
                       np.asarray(W, np.float64).sum(1) - Wm.sum(1), 0.0)
    Wm[np.arange(n), np.arange(n)] += deficit.astype(np.float32)
    return Wm


def fault_gate(W: np.ndarray, labels: np.ndarray,
               cluster_down: np.ndarray) -> np.ndarray:
    """Gate a dense (n, n) mixing operator for edge-server outages.

    ``cluster_down`` marks clusters whose edge server is dark this
    round (``FaultModel.outage windows``): their device rows become the
    identity (the cluster's models are frozen until it recovers) and
    every surviving row drops the dark clusters' columns, folding the
    removed mass onto its diagonal — exactly the
    :func:`staleness_mask` construction with the dark clusters pushed
    out of the staleness bound, so the result is row-stochastic by the
    same argument. With no cluster down the operator is returned
    unchanged, bit for bit (the fault-free parity anchor).

    Recovery needs no special casing: a cluster that comes back simply
    stops being gated and rejoins the next boundary (in async mode,
    through the existing staleness-bounded catch-up path)."""
    down = np.asarray(cluster_down, bool)
    if not down.any():
        return np.asarray(W, np.float32)
    phases = np.where(down, -1, 0)
    return staleness_mask(W, labels, phases, staleness=0,
                          advancing=~down)


def color_edges(adj: np.ndarray) -> List[Dict[int, int]]:
    """Partition the directed edge set into partial matchings.

    Greedy bipartite edge coloring: each color (matching) maps dst -> src
    with all sources distinct and all destinations distinct, so it lowers
    to one ``ppermute``. Uses at most 2·Δ−1 colors (König's bound is Δ;
    greedy is within 2×, which only affects the *number* of ppermutes, not
    the bytes moved — every directed edge appears exactly once overall).
    """
    m = adj.shape[0]
    edges = [(i, j) for i in range(m) for j in range(m)
             if i != j and adj[i, j]]
    colors: List[Dict[int, int]] = []   # dst -> src
    used_src: List[set] = []
    for (i, j) in edges:
        for k in range(len(colors)):
            if i not in used_src[k] and j not in colors[k]:
                colors[k][j] = i
                used_src[k].add(i)
                break
        else:
            colors.append({j: i})
            used_src.append({i})
    return colors


def _replica_perm(matching: Dict[int, int], dpc: int
                  ) -> Tuple[Tuple[int, int], ...]:
    """Cluster-level matching -> flat replica-level (src, dst) pairs."""
    return tuple((src * dpc + t, dst * dpc + t)
                 for dst, src in sorted(matching.items())
                 for t in range(dpc))


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """Host-precomputed permutation + weight plan for one (H, π, geometry)."""
    mode: str                         # "rounds" | "exact"
    num_clusters: int                 # M
    devices_per_cluster: int          # dpc
    pi: int
    w_self: np.ndarray                # (M,)  diag of H            [rounds]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]  # K replica perms [rounds]
    weights: np.ndarray               # (K, M) weight per dst cluster[rounds]
    h_pi: np.ndarray                  # (M, M) H^π                  [exact]
    degrees: np.ndarray               # (M,) backhaul degree per cluster

    @staticmethod
    def build(H: np.ndarray, pi: int, devices_per_cluster: int,
              mode: str = "rounds") -> "GossipSchedule":
        assert mode in ("rounds", "exact"), mode
        H = np.asarray(H, np.float64)
        M = H.shape[0]
        adj = (np.abs(H) > 1e-12) & ~np.eye(M, dtype=bool)
        assert np.allclose(H, H.T), "mixing matrix must be symmetric"
        matchings = color_edges(adj)
        K = len(matchings)
        weights = np.zeros((max(K, 1), M))
        for k, mt in enumerate(matchings):
            for dst, src in mt.items():
                weights[k, dst] = H[src, dst]
        perms = tuple(_replica_perm(mt, devices_per_cluster)
                      for mt in matchings)
        return GossipSchedule(
            mode=mode, num_clusters=M,
            devices_per_cluster=devices_per_cluster, pi=pi,
            w_self=np.diag(H).copy(), perms=perms, weights=weights,
            h_pi=np.linalg.matrix_power(H, pi),
            degrees=adj.sum(1).astype(np.int64))

    # -- traffic accounting (used by benchmarks and the runtime model) ------
    @property
    def num_matchings(self) -> int:
        return len(self.perms)

    def models_received_per_replica(self) -> int:
        """Worst-case neighbor models received by one replica per
        inter-cluster aggregation (the |θ| multiplier)."""
        if self.num_clusters == 1:
            return 0
        if self.mode == "exact":
            return self.num_clusters - 1
        return int(self.pi * self.degrees.max())

    def models_received_total(self, num_replicas: int) -> int:
        """Network-wide models moved per inter-cluster aggregation."""
        if self.num_clusters == 1:
            return 0
        dpc = self.devices_per_cluster
        if self.mode == "exact":
            return (self.num_clusters - 1) * num_replicas
        return int(self.pi * self.degrees.sum() * dpc)

    # -- reference reconstruction (tested host-side) ------------------------
    def dense_equivalent(self) -> np.ndarray:
        """The M×M cluster operator this schedule applies (for parity
        tests): H for one round of ``rounds`` mode, H^π for ``exact``."""
        M = self.num_clusters
        if self.mode == "exact":
            return self.h_pi.copy()
        op = np.diag(self.w_self)
        for k, perm_k in enumerate(self.perms):
            for src_r, dst_r in perm_k:
                src_c = src_r // self.devices_per_cluster
                dst_c = dst_r // self.devices_per_cluster
                if src_r % self.devices_per_cluster == 0:
                    op[src_c, dst_c] += self.weights[k, dst_c]
        return op


# ---------------------------------------------------------------------------
# device-side application: every rank calls these on its own rows
# ---------------------------------------------------------------------------

def gossip_in_body(sched: GossipSchedule, mesh: ReplicaMesh, p):
    """Apply the schedule to this rank's f32 rows ``p`` (a tensor or a
    pytree of them), as the reference does inside a ``shard_map`` body.

    ``rounds``: π times ``y = H[c, c]·x + Σ_k W_k[c]·recv_k(x)`` over
    the edge-colored matchings — O(π·deg·|row|) neighbor bytes, the
    bank never gathered. ``exact``: H^π in M−1 weighted rotations of the
    cluster models, accumulating ``Σ_s H^π[(c+s)%M, c]·buf``."""
    M = sched.num_clusters
    if M == 1:
        return p
    dpc = sched.devices_per_cluster
    R = col.flat_axis_size(mesh)
    assert R == M * dpc, (R, M, dpc)
    c = col.flat_axis_index(mesh) // dpc

    if sched.mode == "exact":
        h_pi = np.asarray(sched.h_pi, np.float32)
        rot = col.rotate_perm(mesh, dpc)

        def rotations(x):
            buf, acc = x, x * float(h_pi[c, c])
            for s in range(1, M):
                buf = col.ppermute(buf, mesh, rot)
                acc = acc + buf * float(h_pi[(c + s) % M, c])
            return acc
        return tr.tree_map(rotations, p)

    ws = float(np.float32(sched.w_self[c]))
    wk = np.asarray(sched.weights, np.float32)[:, c]
    q = p
    for _ in range(sched.pi):
        def leaf(xf):
            acc = xf * ws
            for k, perm_k in enumerate(sched.perms):
                acc = acc + col.ppermute(xf, mesh, perm_k) * float(wk[k])
            return acc
        q = tr.tree_map(leaf, q)
    return q


def cast_f32(params):
    """The tree's leaves in f32 (what the mixes compute in)."""
    return tr.tree_map(lambda x: x.to(torch.float32), params)


def cast_like(params, out):
    """``out``'s leaves cast back to the dtypes of ``params``'s."""
    leaves, treedef = tr.tree_flatten(params)
    return tr.tree_unflatten(treedef, [o.to(x.dtype) for x, o in
                                       zip(leaves, tr.tree_leaves(out))])


def apply_gossip(sched: GossipSchedule, params, mesh: ReplicaMesh):
    """Apply the schedule to this rank's params (any dtype: mixed in f32
    and cast back)."""
    if sched.num_clusters == 1:
        return params
    return cast_like(params, gossip_in_body(sched, mesh, cast_f32(params)))


def group_mean_in_body(mesh: ReplicaMesh, p, groups):
    """Mean of this rank's f32 rows over arbitrary equal-size replica
    groups: one grouped ``all_reduce`` a leaf. ``groups`` is a partition
    of the replica ids (e.g. a :class:`repro_torch.core.groups.
    TierGroups` member list); each group averages over its own
    members."""
    size = len(groups[0])
    if size == 1:
        return p
    inv = 1.0 / size
    return tr.tree_map(lambda x: col.psum_groups(x, mesh, groups) * inv, p)


def cluster_mean_in_body(mesh: ReplicaMesh, p, num_clusters: int,
                         devices_per_cluster: int):
    """Intra-cluster averaging of this rank's f32 rows (eq. 11's V
    restricted to them): :func:`group_mean_in_body` over the contiguous
    per-cluster partition."""
    dpc = devices_per_cluster
    if dpc == 1:
        return p
    groups = [tuple(range(c * dpc, (c + 1) * dpc))
              for c in range(num_clusters)]
    return group_mean_in_body(mesh, p, groups)


def apply_cluster_mean(params, mesh: ReplicaMesh, num_clusters: int,
                       devices_per_cluster: int):
    """Intra-cluster averaging of this rank's params (any dtype)."""
    if devices_per_cluster == 1:
        return params
    return cast_like(params, cluster_mean_in_body(
        mesh, cast_f32(params), num_clusters, devices_per_cluster))


def dense_mix_rows(W, x: torch.Tensor, mesh: ReplicaMesh) -> torch.Tensor:
    """Row-apply an ARBITRARY dense (R, R) operator to the ranks' f32
    rows without gathering the (R, T) bank: R−1 weighted cyclic
    rotations accumulate ``y_d = Σ_j W[d, j]·x_j`` on the fly (the
    masked, mobile, faulted or staleness-gated operators of a scenario
    round, and the non-gossip baselines). ``x`` is this rank's ``(1,
    T)`` row; ``W`` (a host array or a tensor) is the same on every
    rank. Traffic: (R−1)·|row| neighbor bytes a rank."""
    if isinstance(W, torch.Tensor):
        W = W.detach().cpu().numpy()
    Wf = np.asarray(W, np.float32)
    R = col.flat_axis_size(mesh)
    my = col.flat_axis_index(mesh)
    if R == 1:
        return x * float(Wf[0, 0])
    rot = col.rotate_perm(mesh, 1)
    acc, buf = x * float(Wf[my, my]), x
    for s in range(1, R):
        buf = col.ppermute(buf, mesh, rot)
        acc = acc + buf * float(Wf[my, (my + s) % R])
    return acc
