"""RoundProgram IR — one declarative round schedule, lowered by the
engines (port of ``repro.core.program``).

A :class:`RoundProgram` is a validated sequence of ops: ``LocalSteps``
(τ SGD+momentum steps), ``Privatize``/``Compress`` (upload transforms),
``IntraMix`` (the intra-cluster operator V), ``InterGossip`` (eq. 11's
B^T diag(c) H^π B with the op's own π), ``TierMix`` (deeper hierarchy
tiers) and the plan-level directives ``MaskRenorm``/``FaultGate``.
:func:`canonical_program` compiles an :class:`repro_torch.config.FLConfig`'s
τ/q/π knobs into the canonical program; engines consume it through
:func:`lowering_plan` (blocks plus mixing groups, with fusion of adjacent
mixes) and :func:`block_runs`, and the matrices of one concrete round
come from :func:`resolve_matrices`, in the order the lowered round
consumes them. :func:`block_programs` splits a program into its blocks
(the unit an async event replays), and :func:`make_schedule` builds the
named non-canonical schedules (:data:`SCHEDULES`): adaptive per-cluster
τ_k, time-varying π_t, and their online/feedback variants.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.config import FLConfig

# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalSteps:
    """``tau`` local SGD+momentum steps; ``lr_scale`` multiplies the
    engine's learning rate for this op only. ``adaptive=True`` makes the
    op read a per-device step cutoff (``RoundProgram.tau_dev``, values in
    [1, tau]) at run time: device k applies only its first ``tau_dev[k]``
    steps and is frozen for the rest — the trip count (and therefore the
    compiled trace) stays ``tau``, so a schedule can re-draw the cutoffs
    every round without recompiling."""
    tau: int
    lr_scale: float = 1.0
    adaptive: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class TierMix:
    """Apply hierarchy tier ``level``'s mixing operator: average each
    tier group, then (for ``level >= 1``) run ``pi`` gossip steps of
    that tier's block-diagonal backhaul mixing among sibling groups
    (``topology.Hierarchy``). ``TierMix(0)`` is the intra-cluster V and
    ``TierMix(1, π)`` the paper's B^T diag(c) H^π B — :class:`IntraMix`
    and :class:`InterGossip` are sugar for exactly those two, and
    compare/hash equal to them, so depth-2 programs are unchanged.
    Levels >= 2 (region, ...) need an ``FLConfig.hierarchy`` of matching
    depth; the engines validate that at resolve time."""
    level: int
    pi: int = 1

    def __eq__(self, other):
        return (isinstance(other, TierMix)
                and (self.level, self.pi) == (other.level, other.pi))

    def __hash__(self):
        return hash(("TierMix", self.level, self.pi))


class IntraMix(TierMix):
    """Apply the intra-cluster averaging operator V (eq. 11) — sugar
    for ``TierMix(0)``."""

    def __init__(self):
        super().__init__(0, 1)

    def __repr__(self):
        return "IntraMix()"


class InterGossip(TierMix):
    """Apply the inter-cluster operator built with THIS op's ``pi``
    gossip steps (eq. 11's B^T diag(c) H^π B) — sugar for
    ``TierMix(1, pi)``."""

    def __init__(self, pi: int):
        super().__init__(1, pi)

    def __repr__(self):
        return f"InterGossip(pi={self.pi})"


@dataclasses.dataclass(frozen=True)
class Compress:
    """Compress (+ error-feedback) the device delta before upload."""


@dataclasses.dataclass(frozen=True)
class Privatize:
    """DP-transform (clip + noise) the device delta before upload."""


@dataclasses.dataclass(frozen=True)
class MaskRenorm:
    """Plan-level directive: build this round's operators renormalized
    over the participation mask (``scenario.make_masked_w``)."""


@dataclasses.dataclass(frozen=True)
class FaultGate:
    """Plan-level directive: gate this round's operators for the plan's
    realized faults (``gossip.fault_gate``) — dark clusters' device
    rows become the identity and their columns' mass folds onto each
    surviving row's diagonal, so every resolved operator stays
    row-stochastic under edge-server outages. Applied per *op* operator
    before any fusion, so fused and unfused lowerings stay in bitwise
    parity. A no-op on fault-free rounds (and in engines without a
    fault model)."""


MixOp = TierMix
Op = Union[LocalSteps, TierMix, Compress, Privatize, MaskRenorm, FaultGate]


# ---------------------------------------------------------------------------
# blocks — the normal form every lowering consumes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block:
    """One unit of local work plus the mixing boundary that closes it."""
    local: LocalSteps
    privatize: bool
    compress: bool
    mixes: Tuple[MixOp, ...]

    @property
    def upload(self) -> bool:
        """True when the block takes the delta/upload path (the mixing
        operator applies to the transformed delta, not the params)."""
        return self.privatize or self.compress


@dataclasses.dataclass(frozen=True)
class RoundProgram:
    """A validated sequence of round ops (the IR).

    ``ops`` is the structural identity: it is what lowerings compile and
    what the per-engine jit caches key on (``signature``). ``tau_dev`` is
    a *runtime binding* — the per-device step cutoffs an ``adaptive``
    ``LocalSteps`` op reads — deliberately excluded from equality/hash so
    re-drawing it each round never recompiles."""
    ops: Tuple[Op, ...]
    tau_dev: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "ops", tuple(self.ops))
        self.validate()

    # -- structure -----------------------------------------------------------
    @property
    def signature(self) -> Tuple[Op, ...]:
        """Hashable structural identity (compile-cache key)."""
        return self.ops

    @property
    def mask_renorm(self) -> bool:
        return any(isinstance(o, MaskRenorm) for o in self.ops)

    @property
    def fault_gate(self) -> bool:
        """True when the program asks for per-round fault gating of its
        operators (see :class:`FaultGate`)."""
        return any(isinstance(o, FaultGate) for o in self.ops)

    @property
    def has_upload(self) -> bool:
        return any(isinstance(o, (Compress, Privatize)) for o in self.ops)

    @property
    def adaptive(self) -> bool:
        return any(isinstance(o, LocalSteps) and o.adaptive
                   for o in self.ops)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks())

    def blocks(self) -> Tuple[Block, ...]:
        """Parse ``ops`` into the block normal form (cached)."""
        cached = getattr(self, "_blocks", None)
        if cached is None:
            cached = _parse_blocks(self.ops)
            object.__setattr__(self, "_blocks", cached)
        return cached

    def validate(self) -> None:
        """Raise ValueError unless the op sequence parses into blocks."""
        blocks = self.blocks()
        if not blocks:
            raise ValueError("a RoundProgram needs at least one "
                             "LocalSteps block")
        for b in blocks:
            if b.local.tau < 1:
                raise ValueError(f"LocalSteps.tau must be >= 1: {b.local}")
            if b.local.lr_scale <= 0.0:
                raise ValueError(f"lr_scale must be > 0: {b.local}")
            for m in b.mixes:
                if m.level < 0:
                    raise ValueError(f"TierMix.level must be >= 0: {m}")
                if m.level >= 1 and m.pi < 1:
                    raise ValueError(
                        f"gossip tiers' pi must be >= 1: {m}")
        if self.tau_dev is not None:
            td = np.asarray(self.tau_dev)
            if td.ndim != 1 or not np.issubdtype(td.dtype, np.integer):
                raise ValueError("tau_dev must be a 1-D integer array")
            taus = [b.local.tau for b in blocks if b.local.adaptive]
            if taus and (td.min() < 1 or td.max() > max(taus)):
                raise ValueError(
                    f"tau_dev values must lie in [1, {max(taus)}], got "
                    f"[{td.min()}, {td.max()}]")
        if self.adaptive and self.tau_dev is None:
            raise ValueError("adaptive LocalSteps need a tau_dev binding "
                             "(RoundProgram(..., tau_dev=...))")

    def bind(self, tau_dev: Optional[np.ndarray]) -> "RoundProgram":
        """Same structure, new per-device cutoffs (no recompile)."""
        return dataclasses.replace(self, tau_dev=tau_dev)


def block_programs(program: RoundProgram) -> Tuple[RoundProgram, ...]:
    """Split a program into one single-block program per block, in block
    order — the unit of work an async bounded-staleness round executes
    per cluster event (``FLSimulator.step_round_async``).

    Each piece keeps the parent's ``MaskRenorm`` directive and, for
    adaptive blocks, a ``tau_dev`` binding clipped to that block's τ (the
    per-block effective cutoff, so validation and execution match the
    parent program's semantics block for block). Identical blocks share
    a signature, so lowering the pieces reuses one compiled round per
    distinct block."""
    prefix: Tuple[Op, ...] = ((MaskRenorm(),) if program.mask_renorm
                              else ())
    if program.fault_gate:
        prefix = prefix + (FaultGate(),)
    out: List[RoundProgram] = []
    for b in program.blocks():
        ops: List[Op] = [b.local]
        if b.privatize:
            ops.append(Privatize())
        if b.compress:
            ops.append(Compress())
        ops.extend(b.mixes)
        td = None
        if b.local.adaptive and program.tau_dev is not None:
            td = np.minimum(np.asarray(program.tau_dev),
                            b.local.tau).astype(np.int32)
        out.append(RoundProgram(prefix + tuple(ops), tau_dev=td))
    return tuple(out)


def _parse_blocks(ops: Sequence[Op]) -> Tuple[Block, ...]:
    blocks: List[Block] = []
    i, N = 0, len(ops)
    while i < N:
        op = ops[i]
        if isinstance(op, (MaskRenorm, FaultGate)):
            i += 1
            continue
        if not isinstance(op, LocalSteps):
            raise ValueError(
                f"op {i} ({op}) must start a block with LocalSteps")
        local = op
        i += 1
        privatize = compress = False
        if i < N and isinstance(ops[i], Privatize):
            privatize, i = True, i + 1
        if i < N and isinstance(ops[i], Compress):
            compress, i = True, i + 1
        if i < N and isinstance(ops[i], Privatize):
            raise ValueError("Privatize must precede Compress (the upload "
                             "applies DP before compression)")
        mixes: List[MixOp] = []
        while i < N and isinstance(ops[i], TierMix):
            mixes.append(ops[i])
            i += 1
        if not mixes:
            raise ValueError(
                f"LocalSteps at op {i - 1} has no closing mixing boundary "
                f"(IntraMix/InterGossip/TierMix)")
        blocks.append(Block(local, privatize, compress, tuple(mixes)))
    return tuple(blocks)


# ---------------------------------------------------------------------------
# canonical program — FLConfig's τ/q/π knobs, compiled
# ---------------------------------------------------------------------------

def canonical_program(fl: FLConfig, *, privatize: bool = False,
                      compress: bool = False,
                      faults: bool = False) -> RoundProgram:
    """The static schedule of Algorithm 1 as a program: q blocks of
    (τ local steps → [Privatize → Compress →] IntraMix), the last block
    also closed by ``InterGossip(fl.pi)`` — exactly the boundary
    placement of eq. 11, so lowering this program reproduces the
    pre-IR engines' trajectories. A depth-L ``fl.hierarchy`` appends one
    ``TierMix(ℓ, fl.pi)`` per deeper tier to the final boundary
    (:func:`hierarchical_program` with default repeats). ``faults``
    prepends a :class:`FaultGate` directive (fault-injecting
    scenarios)."""
    return hierarchical_program(fl, privatize=privatize, compress=compress,
                                faults=faults)


def hierarchical_program(fl: FLConfig, qs=None, pis=None, *,
                         privatize: bool = False,
                         compress: bool = False,
                         faults: bool = False) -> RoundProgram:
    """The canonical schedule generalized to a depth-L hierarchy.

    The tier-ℓ superblock is ``qs[ℓ-1]`` repetitions of the tier-(ℓ-1)
    superblock closed by ``TierMix(ℓ, pis[ℓ-1])``; tier 0's unit is the
    usual (τ local steps → [upload →] IntraMix) block. Defaults:
    ``qs = (fl.q, 1, 1, ...)`` and ``pis = (fl.pi,) * (L-1)``, so depth
    2 reduces exactly to the pre-hierarchy canonical program."""
    L = fl.depth
    qs = ((fl.q,) + (1,) * (L - 2)) if qs is None else tuple(qs)
    pis = ((fl.pi,) * (L - 1)) if pis is None else tuple(pis)
    assert len(qs) == L - 1 and len(pis) == L - 1, (qs, pis, L)
    block: List[Op] = [LocalSteps(fl.tau)]
    if privatize:
        block.append(Privatize())
    if compress:
        block.append(Compress())
    block.append(IntraMix())
    unit: List[Op] = []
    for _ in range(qs[0]):
        unit.extend(block)
    unit.append(InterGossip(pis[0]))
    for lvl in range(2, L):
        rep: List[Op] = []
        for _ in range(qs[lvl - 1]):
            rep.extend(unit)
        rep.append(TierMix(lvl, pis[lvl - 1]))
        unit = rep
    prefix: List[Op] = [MaskRenorm()]
    if faults:
        prefix.append(FaultGate())
    return RoundProgram(tuple(prefix + unit))


# ---------------------------------------------------------------------------
# lowering plan: mixing groups (+ engine fusion policy) and scan runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MixGroup:
    """Mix ops an engine applies as ONE pass: a fused group's matrices
    multiply into a single operator at resolve time (the ModelBank
    engines' single-pass ``W_inter @ W_intra`` boundary); an unfused
    group holds exactly one op (the legacy engine's sequential form)."""
    ops: Tuple[MixOp, ...]


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A block with its mixes grouped under an engine's fusion policy.
    On the upload path the first mix stays its own group — it applies to
    the transformed *delta*, which cannot fold into the later mixes."""
    local: LocalSteps
    privatize: bool
    compress: bool
    upload: bool
    groups: Tuple[MixGroup, ...]


def lowering_plan(program: RoundProgram, *,
                  fuse: bool) -> Tuple[BlockPlan, ...]:
    """Group each block's mixes for an engine: ``fuse=True`` folds
    adjacent plain mixes into one streaming pass (flat/compact/sharded
    banks); ``fuse=False`` keeps one group per op (legacy pytree)."""
    plans: List[BlockPlan] = []
    for b in program.blocks():
        if b.upload:
            head = [MixGroup((b.mixes[0],))]
            rest = b.mixes[1:]
            if rest:
                if fuse:
                    head.append(MixGroup(tuple(rest)))
                else:
                    head.extend(MixGroup((m,)) for m in rest)
            groups = tuple(head)
        elif fuse:
            groups = (MixGroup(tuple(b.mixes)),)
        else:
            groups = tuple(MixGroup((m,)) for m in b.mixes)
        plans.append(BlockPlan(b.local, b.privatize, b.compress, b.upload,
                               groups))
    return tuple(plans)


def block_runs(plans: Sequence[BlockPlan]
               ) -> Tuple[Tuple[BlockPlan, int], ...]:
    """Maximal runs of identical consecutive block plans. A run of
    length L shares one set of resolved matrices and one block-key
    split (the canonical program's q-1 identical edge rounds)."""
    runs: List[List] = []
    for bp in plans:
        if runs and runs[-1][0] == bp:
            runs[-1][1] += 1
        else:
            runs.append([bp, 1])
    return tuple((bp, c) for bp, c in runs)


def resolve_matrices(plans: Sequence[BlockPlan], W_intra: np.ndarray,
                     inter_of_pi: Callable[[int], np.ndarray],
                     tier_of: Optional[Callable[[TierMix], np.ndarray]] = None
                     ) -> Tuple[np.ndarray, ...]:
    """The concrete mixing matrices one round's lowered function
    consumes, in consumption order: one matrix per MixGroup per *run*
    (identical consecutive blocks share their groups' matrices). A fused
    group's ops compose right-to-left — ops applied o1 then o2 become
    the single operator M2 @ M1. ``tier_of`` resolves mixes above the
    backhaul (``TierMix(level >= 2)``); the base tiers keep their
    dedicated resolvers so depth-2 callers need not pass it."""
    mats: List[np.ndarray] = []
    for bp, _count in block_runs(plans):
        for g in bp.groups:
            M = None
            for op in g.ops:
                if op.level == 0:
                    Mi = W_intra
                elif op.level == 1:
                    Mi = inter_of_pi(op.pi)
                elif tier_of is None:
                    raise ValueError(
                        f"TierMix(level={op.level}) needs a tier_of resolver")
                else:
                    Mi = tier_of(op)
                M = Mi if M is None else Mi @ M
            mats.append(np.asarray(M, np.float32))
    return tuple(mats)


class RoundArgs(NamedTuple):
    """Runtime operands of a lowered round: the resolved mixing matrices
    (``resolve_matrices`` order, as f32 tensors on the bank's device)
    and, for adaptive programs, the (n,) per-device step cutoffs."""
    mats: Tuple
    tau_dev: Optional[object] = None


# ---------------------------------------------------------------------------
# schedules — ScheduleFn hook + the named non-canonical schedules
# ---------------------------------------------------------------------------

#: ``(round_idx, RoundPlan | None) -> RoundProgram`` — called once per
#: global round, BEFORE the round runs, with the realized scenario plan
#: (mobility/sampling) for that round; returns the program to execute.
ScheduleFn = Callable[[int, Optional[object]], RoundProgram]

SCHEDULES = ("static", "adaptive_tau", "pi_decay", "adaptive_tau_online",
             "pi_feedback")


def edge_disagreement(sim) -> float:
    """Mean pairwise L2 distance between the current edge (cluster)
    models of a simulator — the observable a feedback schedule adapts
    gossip depth from. 0.0 when fewer than two clusters."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(sim.edge_models())
    X = np.concatenate(
        [leaf.detach().cpu().numpy().reshape(leaf.shape[0], -1)
         for leaf in leaves], axis=1)
    m = X.shape[0]
    if m < 2:
        return 0.0
    diffs = X[:, None, :] - X[None, :, :]
    d = np.sqrt((diffs * diffs).sum(-1))
    iu = np.triu_indices(m, 1)
    return float(d[iu].mean())


class OnlineSpeedEstimator:
    """EMA of realized per-device compute rates, fed by the EventClock.

    ``observe`` takes the step counts and wall-clock compute times a
    round actually charged and folds rate = steps/time into a per-device
    EMA; devices outside the cohort keep their last estimate. The EMA is
    kept in *raw* rate units (not per-round normalized) so observations
    of different partial cohorts across rounds stay comparable —
    :func:`adaptive_tau_map` only consumes the ratios exposed by
    ``multipliers``."""

    def __init__(self, n: int, beta: float = 0.5):
        self.n = int(n)
        self.beta = float(beta)
        self._rate = np.full(self.n, np.nan)

    def observe(self, steps: np.ndarray, times: np.ndarray,
                mask: Optional[np.ndarray] = None) -> None:
        steps = np.asarray(steps, float)
        times = np.asarray(times, float)
        sel = (steps > 0) & (times > 0)
        if mask is not None:
            sel &= np.asarray(mask) > 0
        if not sel.any():
            return
        rate = steps[sel] / times[sel]
        prev = self._rate[sel]
        self._rate[sel] = np.where(
            np.isnan(prev), rate, (1.0 - self.beta) * prev + self.beta * rate)

    @property
    def ready(self) -> bool:
        return bool(np.isfinite(self._rate).any())

    @property
    def multipliers(self) -> np.ndarray:
        r = self._rate
        if not np.isfinite(r).any():
            return np.ones(self.n)
        return np.where(np.isfinite(r), r / np.nanmean(r), 1.0)


def adaptive_tau_map(tau: int, labels: np.ndarray, mask: np.ndarray,
                     multipliers: np.ndarray, num_clusters: int,
                     tau_floor: int = 1) -> np.ndarray:
    """Per-device step cutoffs for the adaptive-τ_k schedule.

    Cluster k's cutoff scales the base τ by the speed of its slowest
    *participating* device relative to the fastest cluster's slowest
    device: τ_k = clip(round(τ · c_k / max_j c_j), tau_floor, τ). The
    round's compute time — the EventClock's max-over-participants
    τ_k·C/c_d rule — then collapses from τ/min_d c_d to ≈ τ/max_k c_k:
    a slow cluster no longer paces everyone, it just trains less.
    """
    mult = np.asarray(multipliers, float)
    c = np.full(num_clusters, np.nan)
    for k in range(num_clusters):
        sel = (labels == k) & (mask > 0)
        if sel.any():
            c[k] = mult[sel].min()
    ref = np.nanmax(c) if np.isfinite(c).any() else 1.0
    tau_k = np.where(np.isfinite(c),
                     np.clip(np.round(tau * c / ref), tau_floor, tau),
                     tau)
    return tau_k[labels].astype(np.int32)


def make_schedule(name: str, fl: FLConfig, *, engine=None,
                  speeds: Optional[np.ndarray] = None,
                  privatize: bool = False, compress: bool = False,
                  faults: bool = False, sim=None,
                  tau_floor: int = 1, decay_round: int = 5,
                  pi_late: Optional[int] = None,
                  pi_floor: int = 1,
                  ema_beta: float = 0.5) -> ScheduleFn:
    """Build a named :data:`ScheduleFn`.

    - ``static``: the canonical program every round (the paper).
    - ``adaptive_tau``: per-cluster τ_k cutoffs from device speeds
      (``speeds`` multipliers, or ``engine.speed_multipliers`` of an
      attached :class:`repro_torch.core.scenario.ScenarioEngine`); re-drawn
      every round from that round's realized cohort and assignment, so
      it tracks mobility. Homogeneous speeds reduce to static.
    - ``pi_decay``: time-varying π_t — the full ``fl.pi`` gossip depth
      while ``round_idx < decay_round`` (consensus matters early), then
      ``pi_late`` (default max(1, fl.pi // 5)) to shed backhaul time
      once the edge models agree.
    - ``adaptive_tau_online``: adaptive τ_k, but driven by *online*
      per-device rate estimates (an :class:`OnlineSpeedEstimator` EMA
      fed by the EventClock's realized compute times) instead of oracle
      scenario speeds. Round 0 runs the full τ; once observations
      arrive the cutoffs converge to the oracle schedule's. The
      estimator is exposed as ``schedule_fn.estimator`` so the wall
      clock driver can feed it.
    - ``pi_feedback``: time-varying π_t driven by *observed* edge-model
      disagreement (:func:`edge_disagreement` of the attached ``sim``,
      EMA-smoothed): π_t = clip(ceil(π · D_t/D_1), pi_floor, π), so
      gossip depth decays exactly as fast as the edge models actually
      agree — the closed-loop counterpart of ``pi_decay``'s open-loop
      round threshold. Round 0 (no observation yet) runs the full π;
      ``schedule_fn.state`` holds the EMA/reference (checkpointed by
      ``RunCheckpoint``), ``schedule_fn.pi_trace`` the realized depths.

    ``faults=True`` compiles every produced program with the
    :class:`FaultGate` plan-level directive (fault-injecting
    scenarios).
    """
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {name!r}; choose from {SCHEDULES}")
    canonical = canonical_program(fl, privatize=privatize,
                                  compress=compress, faults=faults)
    if name == "static":
        return lambda r, plan: canonical

    if name in ("adaptive_tau", "adaptive_tau_online"):
        template = RoundProgram(
            tuple(dataclasses.replace(o, adaptive=True)
                  if isinstance(o, LocalSteps) else o
                  for o in canonical.ops),
            tau_dev=np.full(fl.n, fl.tau, np.int32))
        base_labels = np.repeat(np.arange(fl.num_clusters),
                                fl.devices_per_cluster)
        full_tau = np.full(fl.n, fl.tau, np.int32)

        if name == "adaptive_tau":
            mult = None
            if speeds is not None:
                mult = np.asarray(speeds, float)
            elif engine is not None:
                mult = np.asarray(engine.speed_multipliers, float)
            if mult is None:
                mult = np.ones(fl.n)

            def adaptive(r, plan):
                labels = plan.labels if plan is not None else base_labels
                mask = plan.mask if plan is not None else np.ones(fl.n)
                return template.bind(adaptive_tau_map(
                    fl.tau, labels, mask, mult, fl.num_clusters, tau_floor))
            return adaptive

        est = OnlineSpeedEstimator(fl.n, ema_beta)

        def online(r, plan):
            if not est.ready:
                return template.bind(full_tau)
            labels = plan.labels if plan is not None else base_labels
            mask = plan.mask if plan is not None else np.ones(fl.n)
            return template.bind(adaptive_tau_map(
                fl.tau, labels, mask, est.multipliers, fl.num_clusters,
                tau_floor))
        online.estimator = est
        return online

    if name == "pi_feedback":
        at_pi: Dict[int, RoundProgram] = {fl.pi: canonical}

        def _program_at(pi: int) -> RoundProgram:
            if pi not in at_pi:
                at_pi[pi] = RoundProgram(tuple(
                    InterGossip(pi) if isinstance(o, InterGossip) else o
                    for o in canonical.ops))
            return at_pi[pi]

        state = {"ref": np.nan, "ema": np.nan}

        def feedback(r, plan):
            if sim is None or r == 0:
                return canonical
            d = edge_disagreement(sim)
            if not np.isfinite(state["ema"]):
                state["ema"] = d
            else:
                state["ema"] = ((1.0 - ema_beta) * state["ema"]
                                + ema_beta * d)
            if not np.isfinite(state["ref"]) or state["ref"] <= 0.0:
                # first observation anchors the reference disagreement
                state["ref"] = state["ema"]
                feedback.pi_trace.append(fl.pi)
                return canonical
            frac = min(1.0, state["ema"] / state["ref"])
            pi_r = int(np.clip(int(np.ceil(fl.pi * frac)),
                               pi_floor, fl.pi))
            feedback.pi_trace.append(pi_r)
            return _program_at(pi_r)
        feedback.state = state
        feedback.pi_trace = []
        return feedback

    lo_pi = max(1, fl.pi // 5) if pi_late is None else pi_late
    late = RoundProgram(tuple(
        InterGossip(lo_pi) if isinstance(o, InterGossip) else o
        for o in canonical.ops))

    def decay(r, plan):
        return canonical if r < decay_round else late
    return decay
