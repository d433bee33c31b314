"""Scenario plans and virtual populations (port of the population part
of ``repro.core.scenario``, numpy).

- :class:`RoundPlan` and :func:`make_masked_w`: one round's realized
  participation and cluster assignment, and the time-varying eq. 11
  operators they induce (``topology.masked_*``);
- :class:`PopulationEngine`: per-round keyed cohort draws over a virtual
  population of clients (no per-client state), the streamed engine's
  scenario; :class:`CohortPlan` is one round of it.

Every draw is keyed by ``np.random.SeedSequence`` exactly as in the
reference, so cohorts, labels, speeds and cluster sizes are identical.
The enumerated ``ScenarioEngine``, ``FaultModel`` and the fault presets
arrive with their slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.config import FLConfig, ScenarioConfig
from repro_torch.core import topology as topo


def sample_speed_multipliers(sc: ScenarioConfig, n: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Per-device relative speeds c_k / c̄ for the scenario's distribution.

    Multipliers are positive and have mean ≈ 1, so the homogeneous
    hardware profile's ``device_flops`` stays the fleet average."""
    if sc.speed_dist == "homogeneous":
        return np.ones(n)
    if sc.speed_dist == "uniform":
        lo, hi = 1.0 - sc.speed_spread, 1.0 + sc.speed_spread
        return rng.uniform(lo, hi, n)
    if sc.speed_dist == "lognormal":
        sigma = sc.speed_spread
        return rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma, size=n)
    if sc.speed_dist == "bimodal":
        slow = rng.random(n) < sc.slow_fraction
        return np.where(slow, sc.slow_factor, 1.0)
    raise ValueError(sc.speed_dist)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One round's realized faults (see :class:`FaultModel`).

    ``cluster_down`` marks clusters whose edge server is dark this
    round; ``link_up`` is the symmetric keep-mask over the backhaul
    adjacency (``n_components`` counts the surviving graph's connected
    components — >1 means this round gossips per partition);
    ``attempts``/``timed_out`` record the straggler-timeout retry
    ladder (aborted attempts per device, and which devices were
    dropped after exhausting retries) with ``ref_mult`` the
    cohort-median speed multiplier their budgets were derived from."""
    round_index: int
    cluster_down: np.ndarray   # (m,) bool — edge server dark this round
    link_up: np.ndarray        # (m,m) bool — surviving backhaul links
    n_components: int          # components of the surviving graph
    attempts: np.ndarray       # (n,) int — aborted timeout attempts
    timed_out: np.ndarray      # (n,) bool — dropped after max_retries
    ref_mult: float            # cohort-median speed mult (budget basis)

    @property
    def any(self) -> bool:
        """True iff any fault fired this round."""
        return bool(self.cluster_down.any() or (~self.link_up).any()
                    or self.timed_out.any() or (self.attempts > 0).any())

    def trace(self) -> Tuple:
        """Hashable summary of the realized faults — what the replay
        determinism tests compare between a straight-through run and a
        killed-and-resumed one."""
        return (int(self.round_index),
                tuple(np.nonzero(self.cluster_down)[0].tolist()),
                tuple(map(tuple, np.argwhere(~self.link_up).tolist())),
                int(self.n_components),
                tuple(self.attempts.tolist()),
                tuple(np.nonzero(self.timed_out)[0].tolist()))


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One global round's realized scenario: who participates, where each
    device lives, and the mixing operators those two facts induce.

    Under fault injection ``fault`` carries the round's
    :class:`FaultPlan` (``None`` on fault-free rounds) and ``H_eff``
    the link-loss-degraded mixing matrix the operators were built from
    (``None`` when every backhaul link survived)."""
    round_index: int
    num_clusters: int         # m
    labels: np.ndarray        # (n,) cluster id per device (B_t rows)
    mask: np.ndarray          # (n,) float 0/1 participation
    W_intra: np.ndarray       # (n,n) masked/unequal intra-cluster operator
    W_inter: np.ndarray       # (n,n) masked/unequal inter-cluster operator
    fault: Optional[FaultPlan] = None
    H_eff: Optional[np.ndarray] = None  # (m,m) degraded mixing matrix

    @property
    def active(self) -> np.ndarray:
        """Boolean participation (the cohort the clock charges)."""
        return self.mask > 0

    @property
    def cohort(self) -> np.ndarray:
        """Indices of the participating devices — the rows the ModelBank
        engine gathers into its compacted (k_pad, T) batch."""
        return np.nonzero(self.mask > 0)[0]

    @property
    def cluster_sizes(self) -> np.ndarray:
        """Device count per cluster under this round's B_t."""
        return np.bincount(self.labels, minlength=self.num_clusters)


def make_masked_w(fl: FLConfig, labels: np.ndarray, mask: np.ndarray,
                  H: np.ndarray,
                  pi: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-round (W_intra, W_inter) for the algorithm under assignment
    ``labels`` and participation ``mask`` — the time-varying eq. 11.
    ``pi`` overrides the gossip depth of the inter operator (time-varying
    π_t schedules, ``core.program.InterGossip``); default ``fl.pi``.

    Reduces to :func:`repro_torch.core.cefedavg.make_w_schedule`'s operators
    when ``labels`` is the contiguous equal-cluster assignment and
    ``mask`` is all-ones."""
    n = labels.shape[0]
    pi = fl.pi if pi is None else pi
    eye = np.eye(n)
    B = topo.assignment_matrix(labels, fl.num_clusters)
    if fl.algorithm == "ce_fedavg":
        return (topo.masked_intra_operator(B, mask),
                topo.masked_inter_operator(B, H, pi, mask))
    if fl.algorithm == "hier_favg":
        return (topo.masked_intra_operator(B, mask),
                topo.masked_global_average(n, mask))
    if fl.algorithm == "fedavg":
        return eye, topo.masked_global_average(n, mask)
    if fl.algorithm == "local_edge":
        V = topo.masked_intra_operator(B, mask)
        return V, V
    if fl.algorithm == "dec_local_sgd":
        Hp = np.linalg.matrix_power(H, pi)
        return eye, topo.renormalize_rows(Hp, mask)
    raise ValueError(fl.algorithm)


# ---------------------------------------------------------------------------
# virtual populations: distribution-driven cohorts, no (n,) state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CohortPlan:
    """One streamed round's realized cohort over a virtual population.

    Unlike :class:`RoundPlan` there are no (n,)-shaped vectors: the
    population is never enumerated. ``clients`` are the sampled virtual
    client ids (home-cluster-sorted), ``labels`` their clusters for
    this round (home, unless visit mobility re-attached them) and
    ``speeds`` their keyed per-client multipliers. ``fault``/``H_eff``
    exist for interface parity with :class:`RoundPlan` (the wall-clock
    harness reads both) and are always ``None`` — fault injection is
    not supported with a virtual population."""
    round_index: int
    num_clusters: int
    clients: np.ndarray       # (k,) int64 sampled virtual client ids
    labels: np.ndarray        # (k,) cluster attachment this round
    speeds: np.ndarray        # (k,) per-client speed multipliers
    population: int           # realized total population size
    fault: Optional[FaultPlan] = None
    H_eff: Optional[np.ndarray] = None

    @property
    def mask(self) -> np.ndarray:
        """Cohort-aligned participation (every sampled client trains)."""
        return np.ones(self.clients.shape[0])

    @property
    def cohort(self) -> np.ndarray:
        """The sampled client ids (alias, mirrors ``RoundPlan``)."""
        return self.clients


class PopulationEngine:
    """Keyed per-round cohort realization of a virtual population
    (:class:`repro_torch.config.PopulationConfig` inside a ScenarioConfig).

    Stateless beyond ``round_index`` by construction: cluster sizes are
    a one-time keyed draw, and every per-round draw (cohort sampling,
    visit mobility, per-client speeds) reads a counter-based generator
    keyed by ``(seed, round, stream, entity)`` — the same discipline as
    :class:`ScenarioEngine` but on disjoint streams — so the cohort
    trace is a pure function of (config, round) and a resumed run
    replays it identically with no per-client state to checkpoint.

    Client ids are implicit: cluster c owns the contiguous id range
    ``[offsets[c], offsets[c+1])`` under the realized size prefix sums,
    so membership tests and home-cluster lookups are O(log m) searches,
    never O(n) tables. Mobility is *visit-based*: a sampled client
    re-attaches to a uniformly random other edge for the round with
    prob ``move_prob`` (it downloads and trains that edge's model —
    the device-associates-to-nearest-edge reality), then hands its
    state back through the store at page-out; home membership never
    changes, so cluster sizes stay the realized draw."""

    #: stream tags (disjoint from ScenarioEngine's and FaultModel's)
    _STREAM_SIZES = 21
    _STREAM_SAMPLING = 22
    _STREAM_MOBILITY = 23
    _STREAM_SPEED = 24

    def __init__(self, sc: ScenarioConfig, fl: FLConfig):
        sc.validate()
        fl.validate()
        assert sc.population is not None, \
            "PopulationEngine needs ScenarioConfig.population"
        assert fl.algorithm != "dec_local_sgd", \
            "dec_local_sgd enumerates one device per cluster (n == m) " \
            "— incompatible with per-cluster client distributions"
        self.sc, self.fl, self.pop = sc, fl, sc.population
        m = fl.num_clusters
        hier = topo.Hierarchy.from_config(fl)
        adj = hier.adjacency(1, fl.topology, fl)
        self.adj = np.asarray(adj, bool)
        self.H = topo.mixing_matrix(adj, fl.mixing)
        self.faults = None            # (interface parity with ScenarioEngine)
        self.labels = np.zeros(0, np.int64)   # population is not enumerated
        # one-time keyed realization of the per-cluster member counts
        sizes = np.empty(m, np.int64)
        for c in range(m):
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(sc.seed), 0, self._STREAM_SIZES, c]))
            base = float(self.pop.clients_per_cluster)
            if self.pop.size_dist == "fixed":
                s = base
            elif self.pop.size_dist == "uniform":
                s = base * rng.uniform(1.0 - self.pop.size_spread,
                                       1.0 + self.pop.size_spread)
            else:  # lognormal
                sig = self.pop.size_spread
                s = base * rng.lognormal(-0.5 * sig * sig, sig)
            sizes[c] = max(1, int(round(s)))
        self.sizes = sizes
        self.offsets = np.concatenate(
            [[0], np.cumsum(sizes)]).astype(np.int64)
        self.population = int(sizes.sum())
        kc = max(1, int(np.ceil(sc.sample_fraction
                                * self.pop.cohort_per_cluster)))
        self._k_per_cluster = kc
        #: upper bound on the streamed working set (cohort + one cold
        #: representative per cluster) — sizes the slab buckets
        self.cohort_cap = int(sum(min(kc, int(s)) for s in sizes) + m)
        #: cohort-aligned speed multipliers of the latest step() — what
        #: the wall-clock harness charges (re-assigned every round)
        self.speed_multipliers = np.ones(0)
        self.round_index = 0

    # -- keyed draws ---------------------------------------------------------
    def _round_rng(self, round_idx: int, stream: int,
                   entity: int = 0) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [int(self.sc.seed), int(round_idx), int(stream), int(entity)]))

    def home_cluster(self, ids: np.ndarray) -> np.ndarray:
        """Home cluster of each client id (prefix-sum range lookup)."""
        return (np.searchsorted(self.offsets, np.asarray(ids, np.int64),
                                side="right") - 1).astype(np.int64)

    def client_speeds(self, ids: np.ndarray) -> np.ndarray:
        """Per-client speed multipliers, keyed by client id (a client's
        hardware is its identity — redrawn rounds see the same speed)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.empty(ids.shape[0])
        for j, i in enumerate(ids):
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(self.sc.seed), 0, self._STREAM_SPEED, int(i)]))
            out[j] = sample_speed_multipliers(self.sc, 1, rng)[0]
        return out

    def representatives(self, sampled: np.ndarray) -> np.ndarray:
        """One cold (unsampled) member id per cluster — the working-set
        lane whose post-round row is read back as the cluster's synced
        reference. Fully-sampled clusters get no representative (any
        participant's synced row serves)."""
        taken = set(int(i) for i in np.asarray(sampled).reshape(-1))
        reps = []
        for c in range(self.fl.num_clusters):
            lo, hi = int(self.offsets[c]), int(self.offsets[c + 1])
            for i in range(lo, hi):
                if i not in taken:
                    reps.append(i)
                    break
        return np.asarray(reps, np.int64)

    def step(self) -> CohortPlan:
        """Advance one streamed round: per-cluster keyed cohort draw
        (``ceil(sample_fraction * cohort_per_cluster)`` members without
        replacement, thinned by dropout, at least one survivor
        overall), then keyed visit mobility over the cohort, then keyed
        per-client speeds."""
        r = self.round_index
        m = self.fl.num_clusters
        parts, first = [], None
        for c in range(m):
            rng = self._round_rng(r, self._STREAM_SAMPLING, c)
            size = int(self.sizes[c])
            kk = min(self._k_per_cluster, size)
            picks = self.offsets[c] + np.sort(
                rng.choice(size, size=kk, replace=False))
            if first is None:
                first = int(picks[0])
            kept = picks[rng.random(kk) >= self.sc.dropout_prob]
            parts.append(kept)
        clients = np.concatenate(parts).astype(np.int64)
        if clients.size == 0:
            clients = np.asarray([first], np.int64)
        labels = self.home_cluster(clients)
        if self.sc.move_prob > 0.0 and m > 1:
            home = labels.copy()
            for c in range(m):
                sel = np.nonzero(home == c)[0]
                if sel.size == 0:
                    continue
                rng = self._round_rng(r, self._STREAM_MOBILITY, c)
                moves = rng.random(sel.size) < self.sc.move_prob
                dst = rng.integers(0, m - 1, sel.size)
                dst = dst + (dst >= c)
                labels[sel[moves]] = dst[moves]
        speeds = self.client_speeds(clients)
        self.speed_multipliers = speeds
        self.round_index += 1
        return CohortPlan(r, m, clients, labels, speeds, self.population)


# ---------------------------------------------------------------------------
# named presets (the scenarios the benchmarks and CLI expose)
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, ScenarioConfig] = {
    "homogeneous": ScenarioConfig(name="homogeneous"),
    "uniform": ScenarioConfig(
        name="uniform", speed_dist="uniform", speed_spread=0.5),
    "lognormal": ScenarioConfig(
        name="lognormal", speed_dist="lognormal", speed_spread=0.6),
    "bimodal": ScenarioConfig(
        name="bimodal", speed_dist="bimodal", slow_fraction=0.25,
        slow_factor=0.2),
    "sampled": ScenarioConfig(
        name="sampled", sample_fraction=0.5, dropout_prob=0.1),
    "mobility": ScenarioConfig(
        name="mobility", speed_dist="lognormal", speed_spread=0.6,
        move_prob=0.25),
    "mobile_sampled": ScenarioConfig(
        name="mobile_sampled", speed_dist="lognormal", speed_spread=0.6,
        sample_fraction=0.8, dropout_prob=0.05, move_prob=0.25),
}


def get_scenario(name: str) -> ScenarioConfig:
    """Look up a named preset (see :data:`SCENARIOS`)."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}")
    return SCENARIOS[name]
