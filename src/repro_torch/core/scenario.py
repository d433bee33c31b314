"""Scenario engines: device heterogeneity, client sampling, mobility and
infrastructure faults (port of ``repro.core.scenario``, numpy).

- :class:`RoundPlan` and :func:`make_masked_w`: one round's realized
  participation and cluster assignment, and the time-varying eq. 11
  operators they induce (``topology.masked_*``);
- :class:`ScenarioEngine`: per-round keyed realization of an enumerated
  fleet (speed multipliers, stratified sampling with dropout, mobility)
  with an optional :class:`FaultModel` (edge outages, backhaul link
  loss, straggler timeouts; :class:`FaultPlan` is one round of it);
- :class:`PopulationEngine`: per-round keyed cohort draws over a virtual
  population of clients (no per-client state), the streamed engine's
  scenario; :class:`CohortPlan` is one round of it;
- the named presets :data:`SCENARIOS` and :data:`FAULTS`.

Every draw is keyed by ``np.random.SeedSequence`` exactly as in the
reference, so plans, fault traces, cohorts, labels, speeds and cluster
sizes are identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.config import FaultConfig, FLConfig, ScenarioConfig
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


class FaultModel:
    """Keyed per-round fault realization of a
    :class:`repro_torch.config.FaultConfig`.

    Stateless by construction: every draw reads a counter-based
    generator keyed by ``(fault seed, round, stream, entity)``, and an
    outage window active at round t is *recomputed* from the window
    starts of the last ``outage_len`` rounds rather than carried as
    state — so ``realize(t, ...)`` is a pure function of (config, t,
    cohort) and a resumed run replays the identical fault trace.

    >>> import numpy as np
    >>> from repro_torch.config import FaultConfig, FLConfig
    >>> fm = FaultModel(FaultConfig(outage_prob=0.3, outage_len=2,
    ...                             link_drop_prob=0.2, seed=7),
    ...                 FLConfig(num_clusters=4, devices_per_cluster=2))
    >>> plan = fm.realize(3, np.ones(8), np.ones(8),
    ...                   np.repeat(np.arange(4), 2))
    >>> plan.trace() == fm.realize(3, np.ones(8), np.ones(8),
    ...                            np.repeat(np.arange(4), 2)).trace()
    True
    """

    #: stream tags (disjoint from ScenarioEngine's so a shared seed
    #: still yields independent draws)
    _STREAM_OUTAGE = 11
    _STREAM_OUTAGE_LEN = 12
    _STREAM_LINK = 13

    def __init__(self, fc: FaultConfig, fl: FLConfig,
                 adj: Optional[np.ndarray] = None):
        fc.validate()
        self.fc, self.fl = fc, fl
        if adj is None:
            hier = topo.Hierarchy.from_config(fl)
            adj = hier.adjacency(1, fl.topology, fl)
        self.adj = np.asarray(adj, bool)

    def _rng(self, round_idx: int, stream: int,
             entity: int = 0) -> np.random.Generator:
        """Counter-based generator keyed by
        ``(fault seed, round, stream, entity)`` — same keying
        discipline as ``ScenarioEngine._round_rng``."""
        return np.random.default_rng(np.random.SeedSequence(
            [int(self.fc.seed), int(round_idx), int(stream), int(entity)]))

    def cluster_down(self, round_idx: int) -> np.ndarray:
        """(m,) bool: clusters inside an outage window at ``round_idx``.

        A window starting at round s (prob ``outage_prob``, keyed by
        (s, cluster)) lasts 1..``outage_len`` rounds (length keyed by
        the same s) — so membership at t only needs the keyed draws of
        rounds t-outage_len+1..t, never any carried state."""
        m = self.fl.num_clusters
        down = np.zeros(m, bool)
        if self.fc.outage_prob <= 0.0:
            return down
        for c in range(m):
            for s in range(max(0, round_idx - self.fc.outage_len + 1),
                           round_idx + 1):
                if self._rng(s, self._STREAM_OUTAGE, c).random() \
                        < self.fc.outage_prob:
                    length = int(self._rng(s, self._STREAM_OUTAGE_LEN, c)
                                 .integers(1, self.fc.outage_len + 1))
                    if s + length > round_idx:
                        down[c] = True
                        break
        return down

    def link_up(self, round_idx: int) -> np.ndarray:
        """(m,m) bool symmetric keep-mask over the backhaul adjacency:
        each undirected link drops for this round independently with
        prob ``link_drop_prob`` (keyed per (round, edge))."""
        m = self.fl.num_clusters
        up = np.ones((m, m), bool)
        if self.fc.link_drop_prob <= 0.0:
            return up
        for i in range(m):
            for j in range(i + 1, m):
                if not self.adj[i, j]:
                    continue
                if self._rng(round_idx, self._STREAM_LINK,
                             i * m + j).random() < self.fc.link_drop_prob:
                    up[i, j] = up[j, i] = False
        return up

    def timeouts(self, mask: np.ndarray, speeds: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Straggler-timeout retry ladder over the participating cohort.

        A participant's local compute scales as 1/speed; its attempt-a
        budget is ``timeout_factor * retry_backoff**a`` times the
        cohort-*median* compute. Returns ``(attempts, timed_out,
        ref_mult)``: aborted attempts per device (the smallest a whose
        budget covers it), the devices no budget covers within
        ``max_retries`` retries (dropped from the round), and the
        median multiplier the budgets were derived from. Deterministic
        given the cohort — no RNG stream needed."""
        n = speeds.shape[0]
        attempts = np.zeros(n, np.int64)
        timed_out = np.zeros(n, bool)
        active = np.asarray(mask) > 0
        if self.fc.timeout_factor <= 0.0 or not active.any():
            return attempts, timed_out, 1.0
        ref = float(np.median(speeds[active]))
        # time_d <= budget_a  <=>  ref <= F * backoff^a * speed_d
        need = ref / (self.fc.timeout_factor * np.maximum(speeds, 1e-12))
        for a in range(self.fc.max_retries + 1):
            covered = need <= self.fc.retry_backoff ** a
            if a == 0:
                pending = active & ~covered
            else:
                attempts[pending] += 1
                pending = pending & ~covered
        timed_out = pending
        attempts[timed_out] += 1  # the final, also-aborted attempt
        return attempts, timed_out, ref

    def realize(self, round_idx: int, mask: np.ndarray,
                speeds: np.ndarray, labels: np.ndarray) -> FaultPlan:
        """The round's full :class:`FaultPlan`: outage windows, link
        survival (+ component count of the surviving graph) and the
        timeout ladder over the cohort that outages left standing."""
        down = self.cluster_down(round_idx)
        up = self.link_up(round_idx)
        ncomp = int(topo.connected_components(self.adj & up).max()) + 1
        cohort = np.asarray(mask) * (~down[np.asarray(labels)])
        attempts, timed_out, ref = self.timeouts(cohort, speeds)
        return FaultPlan(round_idx, down, up, ncomp, attempts,
                         timed_out, ref)


class ScenarioEngine:
    """Stateful per-round realization of a :class:`ScenarioConfig`.

    Deterministic given ``sc.seed``: two engines with the same config
    produce the same speed draw, cohort sequence and mobility trace, so
    different algorithms can be compared under identical conditions.

    Every per-round draw is *keyed*, not sequential: mobility and
    sampling read counter-based generators seeded by
    ``(seed, round_idx, stream, cluster_id)`` (:meth:`_round_rng`), so
    a round's realized randomness never depends on how many draws any
    other round — or any other cluster — consumed before it. That is
    what keeps async bounded-staleness execution (clusters advancing
    out of lockstep, ``FLSimulator.step_round_async``) on exactly the
    same cohort/mobility trace as the barrier run."""

    #: stream tags for :meth:`_round_rng` (distinct per draw purpose)
    _STREAM_MOBILITY = 1
    _STREAM_SAMPLING = 2

    def __init__(self, sc: ScenarioConfig, fl: FLConfig):
        sc.validate()
        fl.validate()
        self.sc, self.fl = sc, fl
        # one-time draws only (the per-device speed multipliers); every
        # per-round draw goes through the keyed _round_rng streams
        self.rng = np.random.default_rng(sc.seed)
        self.labels = np.repeat(np.arange(fl.num_clusters),
                                fl.devices_per_cluster)
        # tier-1 backhaul graph, block-diagonal under a depth>2 hierarchy
        # (same construction as cefedavg.make_w_schedule)
        hier = topo.Hierarchy.from_config(fl)
        adj = hier.adjacency(1, fl.topology, fl)
        self.adj = np.asarray(adj, bool)
        self.H = topo.mixing_matrix(adj, fl.mixing)
        self.speed_multipliers = sample_speed_multipliers(sc, fl.n, self.rng)
        self.faults = (FaultModel(sc.faults, fl, self.adj)
                       if sc.faults is not None and not sc.faults.trivial
                       else None)
        self.round_index = 0

    # -- per-round draws -----------------------------------------------------
    def _round_rng(self, round_idx: int, stream: int,
                   cluster: int = 0) -> np.random.Generator:
        """Counter-based generator keyed by
        ``(seed, round_idx, stream, cluster)``: the same (round,
        cluster) always sees the same randomness regardless of draw
        order, interleaving, or extra draws elsewhere."""
        return np.random.default_rng(np.random.SeedSequence(
            [int(self.sc.seed), int(round_idx), int(stream), int(cluster)]))

    def _step_mobility(self) -> None:
        """Re-associate each device w.p. ``move_prob`` to a uniform other
        edge. A move that would empty the source cluster is skipped: an
        edge with no attached devices has no model to gossip, and the
        operator algebra (and the paper's B_t) assume nonempty clusters.

        Draws are keyed per (round, source cluster) and applied in fixed
        cluster order, so the re-drawn B_t is identical whether the
        engine is driven by a barrier or an async round."""
        m = self.fl.num_clusters
        if self.sc.move_prob <= 0.0 or m < 2:
            return
        labels = self.labels.copy()
        sizes = np.bincount(labels, minlength=m)
        for c in range(m):
            members = np.nonzero(self.labels == c)[0]
            if members.size == 0:
                continue
            rng = self._round_rng(self.round_index, self._STREAM_MOBILITY, c)
            moves = rng.random(members.size) < self.sc.move_prob
            dsts = rng.integers(0, m - 1, members.size)
            for k, moved, dst in zip(members, moves, dsts):
                if not moved or sizes[labels[k]] <= 1:
                    continue
                dst = int(dst)
                if dst >= labels[k]:
                    dst += 1
                sizes[labels[k]] -= 1
                sizes[dst] += 1
                labels[k] = dst
        self.labels = labels

    def _draw_mask(self) -> np.ndarray:
        """Per-cluster stratified cohort: each cluster samples
        ⌈fraction·|cluster|⌉ of its members, thinned by straggler
        dropout, from a generator keyed by (round, cluster). Reduces to
        the global ⌈fraction·n⌉ cardinality for equal clusters, and
        guarantees at least one surviving device overall (pathological
        dropout keeps the first sampled device)."""
        n = self.fl.n
        mask = np.zeros(n)
        first = None
        for c in range(self.fl.num_clusters):
            members = np.nonzero(self.labels == c)[0]
            if members.size == 0:
                continue
            rng = self._round_rng(self.round_index, self._STREAM_SAMPLING, c)
            k = max(1, int(np.ceil(self.sc.sample_fraction * members.size)))
            cohort = members[rng.choice(members.size, size=k, replace=False)]
            if first is None:
                first = int(cohort[0])
            kept = cohort[rng.random(k) >= self.sc.dropout_prob]
            mask[kept] = 1.0
        if mask.sum() == 0:
            mask[first] = 1.0  # pathological dropout: keep one device
        return mask

    def step(self) -> RoundPlan:
        """Advance one global round: mobility, then sampling, then
        faults (outages silence whole clusters, link loss degrades the
        round's mixing matrix, timeouts drop stragglers), then the
        induced (W_intra, W_inter). Fault degradation never raises: a
        fully-dark round simply yields an all-zero cohort and identity
        mixing."""
        self._step_mobility()
        mask = self._draw_mask()
        fault, H_eff = None, None
        H_t = self.H
        if self.faults is not None:
            fault = self.faults.realize(self.round_index, mask,
                                        self.speed_multipliers, self.labels)
            # dark clusters train nothing; exhausted stragglers drop out
            mask = (mask * (~fault.cluster_down[self.labels])
                    * (~fault.timed_out))
            if not fault.link_up.all():
                # re-weight over the surviving (maybe partitioned) graph;
                # mixing_matrix of a disconnected graph is block-diagonal,
                # i.e. per-component gossip
                H_eff = topo.mixing_matrix(self.adj & fault.link_up,
                                           self.fl.mixing)
                H_t = H_eff
        W_intra, W_inter = make_masked_w(self.fl, self.labels, mask, H_t)
        plan = RoundPlan(self.round_index, self.fl.num_clusters,
                         self.labels.copy(), mask, W_intra, W_inter,
                         fault=fault, H_eff=H_eff)
        self.round_index += 1
        return plan

    def active_speeds(self, plan: RoundPlan) -> np.ndarray:
        """Speed multipliers of the plan's participating devices.

        Convenience accessor for external analyses; the wall-clock
        harness itself passes the full ``speed_multipliers`` vector plus
        the plan's mask to ``EventClock.charge_program``, which needs
        per-device alignment with adaptive ``tau_dev`` cutoffs."""
        return self.speed_multipliers[plan.active]


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


#: fault presets (docs/FAULT_MODEL.md): attach to any ScenarioConfig via
#: ``dataclasses.replace(sc, faults=get_faults("outage"))``
FAULTS: Dict[str, FaultConfig] = {
    "outage": FaultConfig(outage_prob=0.08, outage_len=2),
    "flaky_links": FaultConfig(link_drop_prob=0.15),
    "stragglers": FaultConfig(timeout_factor=1.5, max_retries=2,
                              retry_backoff=1.5),
    "chaos": FaultConfig(outage_prob=0.05, outage_len=2,
                         link_drop_prob=0.1, timeout_factor=1.5,
                         max_retries=2, retry_backoff=1.5),
}


def get_faults(name: str) -> FaultConfig:
    """Look up a named fault preset (see :data:`FAULTS`)."""
    if name not in FAULTS:
        raise ValueError(
            f"unknown fault preset {name!r}; choose from {sorted(FAULTS)}")
    return FAULTS[name]
