"""Edge-backhaul topologies and gossip mixing matrices (paper §3-§4).

The mixing matrix H must satisfy Assumption 4: supported on the graph,
doubly stochastic, symmetric, with spectral gap 1 - ζ > 0. We use
Metropolis–Hastings weights, which satisfy all of these for any connected
undirected graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def ring(m: int) -> np.ndarray:
    """Ring backhaul graph on m edge servers (paper §6.1 default)."""
    adj = np.zeros((m, m), bool)
    for i in range(m):
        adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = True
    if m == 1:
        adj[0, 0] = False
    return adj


def complete(m: int) -> np.ndarray:
    """Complete backhaul graph: one gossip step equals cloud averaging
    (the §4.3 reduction CE-FedAvg → Hier-FAvg)."""
    adj = np.ones((m, m), bool)
    np.fill_diagonal(adj, False)
    return adj


def star(m: int) -> np.ndarray:
    """Star backhaul: server 0 is the hub (a cloud-like bottleneck that
    still satisfies Assumption 4's connectivity)."""
    adj = np.zeros((m, m), bool)
    adj[0, 1:] = adj[1:, 0] = True
    return adj


def torus(m: int) -> np.ndarray:
    """2-D torus backhaul (degree-4 grid with wraparound), m = side²."""
    side = int(round(np.sqrt(m)))
    assert side * side == m, "torus requires a square number of nodes"
    adj = np.zeros((m, m), bool)
    for r in range(side):
        for c in range(side):
            i = r * side + c
            for j in ((r, (c + 1) % side), ((r + 1) % side, c)):
                jj = j[0] * side + j[1]
                if jj != i:
                    adj[i, jj] = adj[jj, i] = True
    return adj


def erdos_renyi(m: int, p: float, seed: int = 0) -> np.ndarray:
    """Connected ER graph (resample until connected, as in the paper's
    experiments with p in {0.2, 0.4, 0.6}).

    If 1000 samples all come out disconnected (tiny p), the last sample is
    superimposed with a ring — re-establishing the symmetric/zero-diagonal
    invariants explicitly and asserting connectivity rather than returning
    whatever the OR produced."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for _ in range(1000):
        adj = rng.random((m, m)) < p
        adj = np.triu(adj, 1)
        adj = adj | adj.T
        if _connected(adj):
            return adj
    adj = adj | ring(m)
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    assert _connected(adj), "ring fallback must be connected"
    return adj


def _connected(adj: np.ndarray) -> bool:
    m = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.nonzero(adj[i])[0]:
            if j not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == m


def connected_components(adj: np.ndarray) -> np.ndarray:
    """(m,) component label per node of a (possibly disconnected)
    adjacency — labels are 0..k-1 in order of each component's smallest
    node. Backhaul link loss (``FaultModel``) can partition the graph
    mid-run; gossip then runs per component (``mixing_matrix`` of a
    disconnected graph is block-diagonal over these labels), and the
    fault trace records the component count as the degradation signal."""
    m = adj.shape[0]
    comp = np.full(m, -1, dtype=np.int64)
    k = 0
    for s in range(m):
        if comp[s] >= 0:
            continue
        comp[s] = k
        frontier = [s]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(adj[i])[0]:
                if comp[j] < 0:
                    comp[j] = k
                    frontier.append(int(j))
        k += 1
    return comp


TOPOLOGIES = {
    "ring": lambda m, cfg=None: ring(m),
    "complete": lambda m, cfg=None: complete(m),
    "star": lambda m, cfg=None: star(m),
    "torus": lambda m, cfg=None: torus(m),
    "erdos_renyi": lambda m, cfg=None: erdos_renyi(
        m, cfg.er_prob if cfg else 0.4, cfg.topology_seed if cfg else 0),
}


def build_adjacency(name: str, m: int, cfg=None) -> np.ndarray:
    """Backhaul adjacency by name (ring/complete/star/torus/erdos_renyi),
    asserted connected so Assumption 4's spectral gap exists."""
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}")
    adj = TOPOLOGIES[name](m, cfg)
    assert _connected(adj) or m == 1, f"{name}({m}) not connected"
    return adj


# ---------------------------------------------------------------------------
# mixing matrices
# ---------------------------------------------------------------------------

def mixing_matrix(adj: np.ndarray, kind: str = "metropolis") -> np.ndarray:
    """Doubly-stochastic symmetric H supported on the graph (Assumption 4)."""
    m = adj.shape[0]
    if m == 1:
        return np.ones((1, 1))
    deg = adj.sum(1)
    H = np.zeros((m, m))
    if kind == "metropolis":
        for i in range(m):
            for j in np.nonzero(adj[i])[0]:
                H[i, j] = 1.0 / (max(deg[i], deg[j]) + 1.0)
        np.fill_diagonal(H, 1.0 - H.sum(1))
    elif kind == "uniform_neighbor":
        dmax = deg.max()
        H = adj / (dmax + 1.0)
        np.fill_diagonal(H, 1.0 - H.sum(1))
    else:
        raise ValueError(kind)
    assert np.all(H >= -1e-12)
    return H


def zeta(H: np.ndarray) -> float:
    """ζ = max(|λ2|, |λm|) — second-largest eigenvalue magnitude."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(H)))
    return float(ev[-2]) if len(ev) > 1 else 0.0


def omega1(z: float, pi: int) -> float:
    """ω₁(ζ, π) of Theorem 1 (eq. 23): inter-cluster divergence factor."""
    zp = z ** (2 * pi)
    return zp / (1.0 - zp) if zp < 1 else np.inf


def omega2(z: float, pi: int) -> float:
    """ω₂(ζ, π) of Theorem 1 (eq. 23): gossip-error amplification factor."""
    zp = z ** pi
    if zp >= 1:
        return np.inf
    return 1.0 / (1.0 - zp * zp) + 2.0 / (1.0 - zp) + zp / (1.0 - zp) ** 2


# ---------------------------------------------------------------------------
# cluster operators (paper eq. 11)
# ---------------------------------------------------------------------------

def cluster_assignment(cluster_sizes) -> np.ndarray:
    """B in {0,1}^{m x n}: B[i,k]=1 iff device k in cluster i (contiguous)."""
    m = len(cluster_sizes)
    n = int(sum(cluster_sizes))
    B = np.zeros((m, n))
    k = 0
    for i, s in enumerate(cluster_sizes):
        B[i, k:k + s] = 1.0
        k += s
    return B


def intra_cluster_operator(cluster_sizes) -> np.ndarray:
    """V = B^T diag(c) B — within-cluster averaging (n x n)."""
    B = cluster_assignment(cluster_sizes)
    c = 1.0 / np.asarray(cluster_sizes, float)
    return B.T @ np.diag(c) @ B


def inter_cluster_operator(cluster_sizes, H: np.ndarray,
                           pi: int) -> np.ndarray:
    """B^T diag(c) H^pi B — cluster averaging followed by pi gossip steps."""
    B = cluster_assignment(cluster_sizes)
    c = 1.0 / np.asarray(cluster_sizes, float)
    Hp = np.linalg.matrix_power(H, pi)
    return B.T @ np.diag(c) @ Hp @ B


# ---------------------------------------------------------------------------
# depth>2 hierarchies: tiered groups and per-tier mixing operators
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """A depth-L aggregation hierarchy as branching factors root→leaf.

    ``levels = (l_0, ..., l_{L-1})`` reads "l_0 regions × l_1 edges per
    region × ... × l_{L-1} devices per edge"; the paper's two-tier setup
    is ``(m, devices_per_cluster)``. A ``TierMix(ℓ)`` op averages each
    device group at tier ℓ and (for ℓ >= 1) gossips among sibling groups
    under their common parent, so its mixing matrix is block-diagonal —
    one backhaul graph per parent (``kron(I, H_block)``) — and tier 1 at
    depth 2 reduces exactly to the paper's edge backhaul ``InterGossip``.

    >>> h = Hierarchy((2, 2, 2))
    >>> [(lvl, h.tier_name(lvl), h.num_groups(lvl), h.group_size(lvl))
    ...  for lvl in range(h.depth)]
    [(0, 'device', 4, 2), (1, 'edge', 4, 2), (2, 'region', 2, 4)]
    """
    levels: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "levels", tuple(self.levels))
        assert len(self.levels) >= 2 and all(s >= 1 for s in self.levels), \
            f"hierarchy needs >= 2 tiers of size >= 1: {self.levels}"

    @staticmethod
    def from_config(fl) -> "Hierarchy":
        """The hierarchy of an :class:`repro_torch.config.FLConfig` (its
        ``tiers`` property — depth 2 unless ``fl.hierarchy`` is set)."""
        return Hierarchy(tuple(fl.tiers))

    @property
    def depth(self) -> int:
        """Number of tiers L; valid TierMix levels are 0..L-1."""
        return len(self.levels)

    @property
    def n(self) -> int:
        """Total leaf devices."""
        return int(np.prod(self.levels))

    @property
    def num_edges(self) -> int:
        """Leaf clusters (the paper's m) = prod(levels[:-1])."""
        return int(np.prod(self.levels[:-1]))

    def num_nodes(self, level: int) -> int:
        """Aggregation nodes at tier ``level`` >= 1 (edges at 1, the
        ``levels[0]`` top nodes at L-1)."""
        assert 1 <= level < self.depth, (level, self.depth)
        return int(np.prod(self.levels[:self.depth - level]))

    def node_size(self, level: int) -> int:
        """Leaf devices under one tier-``level`` node."""
        return self.n // self.num_nodes(level)

    def num_siblings(self, level: int) -> int:
        """Gossip-graph size at tier ``level``: children of one parent
        (all ``levels[0]`` top nodes at the topmost tier)."""
        assert 1 <= level < self.depth, (level, self.depth)
        return self.levels[self.depth - 1 - level]

    def num_parents(self, level: int) -> int:
        """Independent gossip graphs (diagonal blocks of H_ℓ)."""
        return self.num_nodes(level) // self.num_siblings(level)

    # -- the partition a TierMix(level) averages over ------------------------
    def num_groups(self, level: int) -> int:
        """Device groups averaged by ``TierMix(level)``: tier 0 averages
        per edge (same partition as tier 1's pre-gossip mean)."""
        return self.num_nodes(max(level, 1))

    def group_size(self, level: int) -> int:
        """Devices per ``TierMix(level)`` group."""
        return self.n // self.num_groups(level)

    def tier_name(self, level: int) -> str:
        """Registry name of the tier: device / edge / region / tier<ℓ>."""
        return ("device", "edge", "region")[level] if level <= 2 \
            else f"tier{level}"

    def node_of_edge(self, level: int) -> np.ndarray:
        """(num_edges,) static map edge id → tier-``level`` node id
        (contiguous nesting); composes with mobility's device→edge
        labels to give device→node labels at any tier."""
        return np.arange(self.num_edges) // (
            self.num_edges // self.num_nodes(level))

    def node_labels(self, level: int, labels) -> np.ndarray:
        """(n,) device → tier-``level`` node id under device→edge
        assignment ``labels``."""
        return self.node_of_edge(level)[np.asarray(labels, int)]

    # -- per-tier mixing -----------------------------------------------------
    def adjacency(self, level: int, topology: str = "ring",
                  cfg=None) -> np.ndarray:
        """Block-diagonal backhaul adjacency of tier ``level``: one
        ``topology`` graph over each parent's ``num_siblings`` children
        (a single graph over all nodes at depth 2 / the top tier)."""
        blk = build_adjacency(topology, self.num_siblings(level), cfg)
        reps = self.num_parents(level)
        return np.kron(np.eye(reps, dtype=bool), blk).astype(bool)

    def mixing(self, level: int, topology: str = "ring",
               kind: str = "metropolis", cfg=None) -> np.ndarray:
        """H_ℓ: Metropolis weights of the (block-diagonal) tier graph.
        Block-diagonal adjacency gives kron(I, H_block) exactly, since
        Metropolis weights depend only on within-block degrees."""
        if self.num_siblings(level) == 1:
            return np.eye(self.num_nodes(level))
        return mixing_matrix(self.adjacency(level, topology, cfg), kind)

    def tier_operator(self, level: int, pi: int = 1,
                      topology: str = "ring", kind: str = "metropolis",
                      cfg=None) -> np.ndarray:
        """Dense (n, n) operator of ``TierMix(level, pi)`` under the
        static contiguous assignment: tier 0 is the intra-cluster V,
        tier ℓ >= 1 is B_ℓ^T diag(c) H_ℓ^π B_ℓ (eq. 11 generalized to
        the tier's node partition)."""
        if level == 0:
            return intra_cluster_operator(
                [self.levels[-1]] * self.num_edges)
        sizes = [self.node_size(level)] * self.num_nodes(level)
        return inter_cluster_operator(
            sizes, self.mixing(level, topology, kind, cfg), pi)


# ---------------------------------------------------------------------------
# generalized operators: unequal / time-varying clusters + participation
# (the scenario engine, core/scenario.py, builds these per global round)
# ---------------------------------------------------------------------------

def assignment_matrix(labels, m: int) -> np.ndarray:
    """B_t ∈ {0,1}^{m×n} from per-device cluster labels.

    Generalizes :func:`cluster_assignment` to arbitrary (non-contiguous,
    unequal, possibly time-varying) membership — mobility re-draws
    ``labels`` between global rounds."""
    labels = np.asarray(labels, int)
    assert labels.ndim == 1 and (0 <= labels).all() and (labels < m).all()
    B = np.zeros((m, labels.shape[0]))
    B[labels, np.arange(labels.shape[0])] = 1.0
    return B


def masked_cluster_average(B: np.ndarray,
                           mask: Optional[np.ndarray] = None) -> np.ndarray:
    """P ∈ R^{m×n}: row i averages uniformly over the *participating*
    members of cluster i (the renormalized diag(c)·B of eq. 11).

    A cluster whose members all sat the round out falls back to the plain
    member average (its devices did not train, so this is their shared
    edge model); a cluster with no members at all gets a zero row."""
    m, n = B.shape
    w = B if mask is None else B * np.asarray(mask, float)[None, :]
    counts = w.sum(1)
    sizes = B.sum(1)
    P = np.zeros_like(B)
    for i in range(m):
        if counts[i] > 0:
            P[i] = w[i] / counts[i]
        elif sizes[i] > 0:
            P[i] = B[i] / sizes[i]
    return P


def masked_intra_operator(B: np.ndarray,
                          mask: Optional[np.ndarray] = None) -> np.ndarray:
    """V_t = B^T P — intra-cluster averaging over participating devices.

    Every member (participating or not) is synced to its cluster's
    participant average, mirroring the edge pushing y_{t} down to all
    attached devices at the aggregation boundary (Algorithm 1 line 12).
    With ``mask`` all-ones this is exactly
    :func:`intra_cluster_operator` for the same membership."""
    return B.T @ masked_cluster_average(B, mask)


def masked_inter_operator(B: np.ndarray, H: np.ndarray, pi: int,
                          mask: Optional[np.ndarray] = None) -> np.ndarray:
    """B^T H^π P — the row-stochastic generalization of eq. 11's
    B^T diag(c) H^π B to unequal clusters and partial participation.

    For equal cluster sizes diag(c) = (1/s)·I commutes with H^π, so this
    coincides exactly with :func:`inter_cluster_operator`; for unequal
    sizes the paper's written order is no longer stochastic (its rows sum
    to c_i Σ_j H^π[i,j]·n_j ≠ 1) while this one always averages each
    cluster before gossiping. Rows are renormalized so empty clusters
    (zero rows of P) shed their weight onto the remaining clusters."""
    P = masked_cluster_average(B, mask)
    W = B.T @ np.linalg.matrix_power(H, pi) @ P
    s = W.sum(1, keepdims=True)
    # every device's own cluster is nonempty and H has positive diagonal,
    # so each row keeps positive mass even if other clusters are empty
    assert (s > 1e-12).all(), "device row lost all mass (empty own cluster?)"
    return W / s


def masked_global_average(n: int,
                          mask: Optional[np.ndarray] = None) -> np.ndarray:
    """A_t: every device receives the mean over participating devices —
    cloud aggregation (FedAvg / Hier-FAvg) over the sampled cohort.
    Uniform over all devices when the mask is empty or absent."""
    if mask is None or np.asarray(mask, float).sum() == 0:
        return np.ones((n, n)) / n
    mask = np.asarray(mask, float)
    return np.tile(mask / mask.sum(), (n, 1))


def renormalize_rows(W: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Restrict W's columns to participating devices and renormalize each
    row; rows left with no support become identity (the device keeps its
    model). Used to mask decentralized gossip (dec_local_sgd), where each
    device is its own edge and an offline device neither sends nor
    receives."""
    mask = np.asarray(mask, float)
    Wm = W * mask[None, :]
    out = np.eye(W.shape[0])
    s = Wm.sum(1)
    ok = (s > 1e-12) & (mask > 0)   # offline rows stay identity too
    out[ok] = Wm[ok] / s[ok, None]
    return out
