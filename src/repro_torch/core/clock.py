"""Event clock: wall-clock time-to-accuracy accounting (paper §6, Figs. 5–6)
(port of ``repro.core.clock``).

``FLSimulator`` measures accuracy per *round*; the paper's headline claim
is accuracy per *second*. :class:`EventClock` converts rounds to seconds
by charging each global round

    max over participating devices of  qτ·C/c_k      (compute, eq. 8)
  + the algorithm's communication terms               (RuntimeModel.comm_time)

and :func:`run_wall_clock` couples a (scenario-aware) simulator to that
clock, emitting ``(wall_time, acc)`` curves and :func:`time_to_accuracy`.
Rounds are charged *per op* of their
:class:`repro_torch.core.program.RoundProgram`
(:func:`program_compute_time`, :func:`program_comm_time`): adaptive
``tau_dev`` cutoffs shorten the compute term, and the canonical program
reproduces ``charge_round`` to the last term. A streamed round is also
charged its client paging (:func:`paging_comm_time`), a faulted round
its straggler retry ladder (:func:`fault_compute_penalty`), and an
async bounded-staleness round the makespan of its per-cluster timeline
(:func:`async_program_timeline`, carried across rounds). The loop feeds
an online schedule's speed estimator the step counts and compute
seconds it charged. Checkpoints arrive with a later slice.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.runckpt import RunCheckpoint
from repro_torch.config import FLConfig
from repro_torch.core import program as prg
from repro_torch.core import topology as topo
from repro_torch.core.runtime import RuntimeModel


def program_compute_time(rt: RuntimeModel, program: prg.RoundProgram,
                         speeds: Optional[Sequence[float]] = None,
                         mask: Optional[np.ndarray] = None) -> float:
    """Compute seconds of one programmed round: per ``LocalSteps`` op,
    max over participating devices of steps_d·C/c_d — where steps_d is
    the op's τ, or the device's ``tau_dev`` cutoff when adaptive.

    ``speeds`` are per-device FLOP/s aligned with ``mask`` (the full
    fleet vector); None means the RuntimeModel's homogeneous default.
    The canonical program reduces to ``rt.compute_time(q·τ, ·)``."""
    C = rt.wl.flops_per_step
    total = 0.0
    tau_dev = program.tau_dev
    for b in program.blocks():
        op = b.local
        if op.adaptive and tau_dev is not None:
            # cutoffs are bounded by the max adaptive tau across blocks;
            # THIS block executes at most its own op.tau steps
            steps = np.minimum(np.asarray(tau_dev, float), float(op.tau))
        else:
            steps = np.full(1 if speeds is None else len(speeds),
                            float(op.tau))
        if speeds is None:
            if rt.speeds:
                c = np.asarray(rt.speeds, float)[:len(steps)] \
                    if len(steps) > 1 else np.array([min(rt.speeds)])
            else:
                c = np.full(steps.shape, rt.hw.device_flops)
        else:
            c = np.asarray(speeds, float)
        if mask is not None and len(steps) == len(mask):
            active = np.asarray(mask) > 0
            if active.any():
                steps, c = steps[active], c[active]
        total += float(np.max(steps * C / c))
    return total


def program_device_steps(program: prg.RoundProgram, n: int) -> np.ndarray:
    """(n,) local SGD steps each device executes in one round of
    ``program``: Σ over blocks of the block's τ, respecting per-device
    ``tau_dev`` cutoffs of adaptive blocks — the step counts the online
    speed estimator pairs with realized compute times."""
    steps = np.zeros(n)
    tau_dev = program.tau_dev
    for b in program.blocks():
        op = b.local
        if op.adaptive and tau_dev is not None:
            steps += np.minimum(np.asarray(tau_dev, float), float(op.tau))
        else:
            steps += float(op.tau)
    return steps


def program_device_times(rt: RuntimeModel, program: prg.RoundProgram,
                         speeds: np.ndarray) -> np.ndarray:
    """(n,) compute seconds each device spends in one round of
    ``program`` at per-device FLOP/s ``speeds`` — what an EventClock
    observes per device (steps_d·C/c_d)."""
    return (program_device_steps(program, len(speeds))
            * rt.wl.flops_per_step / np.asarray(speeds, float))


def fault_compute_penalty(rt: RuntimeModel, program: prg.RoundProgram,
                          fc, fault, speeds: Optional[np.ndarray] = None,
                          mask: Optional[np.ndarray] = None) -> float:
    """Extra compute seconds the straggler-timeout retry ladder costs a
    round beyond its max-over-survivors charge.

    ``fault`` is the round's realized ``scenario.FaultPlan`` and ``fc``
    the ``config.FaultConfig`` that produced it. A device that needed
    ``a`` aborted attempts waited through budgets
    ``timeout_factor · retry_backoff^i · t_ref`` for i < a (t_ref being
    the cohort-median device's compute this round), then — if it
    survived — ran its own compute; a dropped device pays only the
    exhausted ladder. The penalty is how far the slowest such ladder
    extends past the surviving cohort's ordinary max-over-participants
    charge; 0.0 when no attempt was aborted (the fault-free bitwise
    anchor)."""
    if fault is None or fc is None or not (fault.attempts > 0).any():
        return 0.0
    C = rt.wl.flops_per_step
    n = len(fault.attempts)
    c = (np.asarray(speeds, float) if speeds is not None
         else np.full(n, rt.hw.device_flops))
    steps = program_device_steps(program, n)
    ladder = np.asarray(fault.attempts, float)
    hit = ladder > 0
    # the budget basis: the cohort-median device's round compute
    t_ref = (float(np.median(steps[hit])) * C
             / (float(fault.ref_mult) * rt.hw.device_flops))
    geo = np.array([
        sum(fc.timeout_factor * fc.retry_backoff ** i
            for i in range(int(a))) for a in fault.attempts[hit]])
    own = np.where(fault.timed_out[hit], 0.0, steps[hit] * C / c[hit])
    worst = float(np.max(geo * t_ref + own))
    # compare against what charge_program already charged: the ordinary
    # max-over-participants compute of this round's surviving cohort
    base = program_compute_time(rt, program, speeds, mask)
    return max(0.0, worst - base)


def program_comm_time(rt: RuntimeModel, algorithm: str,
                      program: prg.RoundProgram,
                      uplink_ratio: float = 1.0) -> float:
    """Communication seconds of one programmed round, priced per mixing
    op with the §6.1 per-algorithm adaptation (a mix is classified by
    its tier: level 0 = IntraMix, level >= 1 = inter-tier gossip):

    - ``ce_fedavg``: every TierMix(0) is a device→edge upload
      (W_u/b_d2e); every TierMix(ℓ>=1, π) is π exchanges over tier ℓ's
      links (π·W/tier_bandwidth(ℓ) — b_e2e for the backhaul,
      ``b_tiers`` overrides above it).
    - ``hier_favg``: an InterGossip is a device→cloud upload (W/b_d2c)
      that *replaces* the coincident intra upload in its block.
    - ``fedavg``: IntraMix is the identity (free); InterGossip is the
      cloud upload (W_u/b_d2c).
    - ``local_edge``: IntraMix uploads to the edge; InterGossip is V
      again — covered by the same upload (free).
    - ``dec_local_sgd``: no edges; InterGossip(π) costs π·W/b_e2e.

    The canonical program reduces to ``rt.comm_time(algorithm, q, π)``.
    """
    return float(sum(block_comm_times(rt, algorithm, program,
                                      uplink_ratio)))


def block_comm_times(rt: RuntimeModel, algorithm: str,
                     program: prg.RoundProgram,
                     uplink_ratio: float = 1.0) -> List[float]:
    """Per-block communication seconds — the same §6.1 pricing that
    :func:`program_comm_time` sums, kept as a list so the async timeline
    (:func:`async_program_timeline`) can charge each block's boundary on
    its own cluster's timeline instead of once per barrier."""
    hw = rt.hw
    W = rt.wl.model_bits(hw)
    Wu = W * uplink_ratio
    out: List[float] = []
    for b in program.blocks():
        n_intra = sum(m.level == 0 for m in b.mixes)
        inters = [m for m in b.mixes if m.level >= 1]
        if algorithm == "ce_fedavg":
            t = n_intra * Wu / hw.b_d2e
            t += sum(m.pi * W / hw.tier_bandwidth(m.level)
                     for m in inters)
        elif algorithm == "hier_favg":
            # cloud hop carries the full model (uncompressed), matching
            # RuntimeModel.comm_time's (q-1)·Wu/b_d2e + W/b_d2c
            charged = max(0, n_intra - len(inters)) if inters else n_intra
            t = charged * Wu / hw.b_d2e + len(inters) * W / hw.b_d2c
        elif algorithm == "fedavg":
            t = len(inters) * Wu / hw.b_d2c
        elif algorithm == "local_edge":
            t = n_intra * Wu / hw.b_d2e
        elif algorithm == "dec_local_sgd":
            t = sum(m.pi for m in inters) * W / hw.b_e2e
        else:
            raise ValueError(algorithm)
        out.append(float(t))
    return out


def paging_comm_time(rt: RuntimeModel, rows_in: int, rows_out: int,
                     bits_per_row: int) -> float:
    """Communication seconds of one streamed round's client paging
    (``core/clientstore.py``): every paged-in row is a device→edge
    *download* of the client's model and every paged-out row the
    matching upload, both over the d2e link — the attach/detach traffic
    a virtual-population round adds on top of its program's §6.1 terms.
    Cold-codec compression (``PopulationConfig.codec``) shrinks
    ``bits_per_row`` and therefore this charge."""
    return float((int(rows_in) + int(rows_out)) * int(bits_per_row)
                 / rt.hw.b_d2e)


# ---------------------------------------------------------------------------
# async bounded-staleness timelines
# ---------------------------------------------------------------------------

def async_adjacency(fl: FLConfig) -> np.ndarray:
    """(m, m) boolean cluster-dependency graph of the async wait rule.

    Cluster i's block-``b`` boundary must wait on cluster j's phase
    exactly when j's model can reach i through that boundary:
    ``local_edge`` never crosses edges (identity); ``fedavg`` /
    ``hier_favg`` aggregate globally (complete); ``ce_fedavg`` /
    ``dec_local_sgd`` read backhaul neighbors (tier-1 adjacency ∪ self).
    Depth>2 hierarchies are treated conservatively as complete — a
    ``TierMix(ℓ>=2)`` spans sibling groups of edges."""
    m = fl.num_clusters
    eye = np.eye(m, dtype=bool)
    if fl.algorithm == "local_edge":
        return eye
    hier = topo.Hierarchy.from_config(fl)
    if fl.algorithm in ("fedavg", "hier_favg") or hier.depth > 2:
        return np.ones((m, m), dtype=bool)
    adj = np.asarray(hier.adjacency(1, fl.topology, fl)) > 0
    return adj | eye


class AsyncEvent(NamedTuple):
    """One async phase advance: at ``time``, the ``clusters`` listed
    apply block ``block``'s mixing boundary together (equal completion
    times coalesce into one event — at s=0 every block is exactly one
    all-cluster event, the barrier degeneracy)."""
    time: float
    block: int
    clusters: Tuple[int, ...]


def _cluster_block_compute(rt: RuntimeModel, program: prg.RoundProgram,
                           speeds, mask, labels: np.ndarray,
                           m: int) -> np.ndarray:
    """(m, B) per-cluster compute seconds: per block, max over the
    cluster's *active* devices of steps_d·C/c_d, 0 when the whole
    cluster dropped out (it still phase-advances — see
    :func:`async_program_timeline`)."""
    C = rt.wl.flops_per_step
    n = len(labels)
    if speeds is None:
        if rt.speeds and len(rt.speeds) == n:
            speeds = np.asarray(rt.speeds, float)
        else:
            speeds = np.full(n, rt.hw.device_flops)
    speeds = np.asarray(speeds, float)
    active = (np.ones(n, dtype=bool) if mask is None
              else np.asarray(mask) > 0)
    blocks = program.blocks()
    comp = np.zeros((m, len(blocks)))
    tau_dev = program.tau_dev
    for bi, b in enumerate(blocks):
        op = b.local
        if op.adaptive and tau_dev is not None:
            steps = np.minimum(np.asarray(tau_dev, float), float(op.tau))
        else:
            steps = np.full(n, float(op.tau))
        tvec = steps * C / speeds
        for c in range(m):
            sel = active & (labels == c)
            comp[c, bi] = float(tvec[sel].max()) if sel.any() else 0.0
    return comp


def async_program_timeline(rt: RuntimeModel, fl: FLConfig,
                           program: prg.RoundProgram,
                           speeds=None, mask=None, labels=None,
                           staleness: int = 0,
                           uplink_ratio: float = 1.0,
                           carry: Optional[Dict[str, object]] = None
                           ) -> Dict[str, object]:
    """Per-cluster event timeline of one async bounded-staleness round.

    Each cluster advances through the program's blocks on its own
    timeline: block b starts when the cluster's own block b−1 completed
    AND every dependency neighbor (:func:`async_adjacency`) has cleared
    block b−s, so a boundary only ever reads models at most ``s`` blocks
    stale. ``staleness == 0`` is the global barrier: every block is one
    all-cluster event and the makespan telescopes to the barrier sum
    Σ_b (max_c comp + comm). For s ≥ 1 the makespan is never larger
    than the barrier's (each start time is bounded by the barrier's, by
    induction over blocks) — fast clusters hide stragglers' compute.

    ``carry`` couples consecutive rounds into ONE continuous block
    sequence — the source of async's wall-clock win, since within a
    single common-start round the slowest cluster's serial chain equals
    the barrier sum whenever per-cluster compute is block-constant. It
    holds the previous round's per-cluster end times (``"T_end"``) and
    last ``s`` completion columns (``"cols"``), so block b < s of this
    round waits on neighbors' block B−s+b of the PREVIOUS round instead
    of a global round barrier: clusters flow through the round boundary
    bounded-stale the whole way, and the per-round bottleneck cluster
    (sampling/mobility re-draw it every round) no longer paces everyone
    else. ``staleness == 0`` still barriers at ``T_end.max()``.

    Returns ``{"T", "start", "comp", "comm", "events", "makespan",
    "adjacency", "carry_out"}`` where ``T``/``start``/``comp`` are
    (m, B) arrays, ``comm`` is (B,), ``events`` is the
    (time, block)-sorted :class:`AsyncEvent` list the executor replays,
    ``makespan`` is the absolute max end time, and ``carry_out`` feeds
    the next round."""
    m = fl.num_clusters
    if labels is None:
        labels = np.repeat(np.arange(m), fl.devices_per_cluster)
    labels = np.asarray(labels)
    blocks = program.blocks()
    B = len(blocks)
    comm = np.asarray(block_comm_times(rt, fl.algorithm, program,
                                       uplink_ratio))
    comp = _cluster_block_compute(rt, program, speeds, mask, labels, m)
    adj = async_adjacency(fl)
    # a block only couples clusters when its boundary actually crosses
    # them: intra-only blocks (every mix at level 0) impose no
    # cross-cluster wait — their operators are cluster-block-diagonal,
    # so neighbors' phases are irrelevant until the next gossip block
    eye_m = np.eye(m, dtype=bool)
    block_adj = [adj if any(mx.level >= 1 for mx in blk.mixes) else eye_m
                 for blk in blocks]
    s = int(staleness)
    if carry is not None:
        t0 = np.asarray(carry["T_end"], float)
        cols = [np.asarray(c, float) for c in carry.get("cols", [])]
    else:
        t0 = np.zeros(m)
        cols = []
    T = np.zeros((m, B))
    start = np.zeros((m, B))
    for b in range(B):
        prev = T[:, b - 1] if b else t0
        if s == 0:
            start[:, b] = prev.max()
            T[:, b] = (start[:, b] + comp[:, b] + comm[b]).max()
        else:
            if b - s >= 0:
                ref = T[:, b - s]
            else:
                # reach back into the previous round's trailing columns
                gi = len(cols) + b - s
                ref = cols[gi] if 0 <= gi < len(cols) else None
            if ref is None:
                wait = np.zeros(m)
            else:
                ab = block_adj[b]
                wait = np.array([ref[ab[i]].max() for i in range(m)])
            start[:, b] = np.maximum(prev, wait)
            T[:, b] = start[:, b] + comp[:, b] + comm[b]
    events: List[AsyncEvent] = []
    for b in range(B):
        for t in np.unique(T[:, b]):
            cl = tuple(int(c) for c in np.nonzero(T[:, b] == t)[0])
            events.append(AsyncEvent(float(t), b, cl))
    # (time, block) ascending: simultaneous completions apply the
    # earlier block first, which is what bounds the realized phase gap
    # by s even under zero-compute ties
    events.sort(key=lambda e: (e.time, e.block))
    cols_out = (cols + [T[:, b].copy() for b in range(B)])[-max(s, 1):]
    return {"T": T, "start": start, "comp": comp, "comm": comm,
            "events": events, "makespan": float(T[:, -1].max()),
            "adjacency": adj,
            "carry_out": {"T_end": T[:, -1].copy(), "cols": cols_out}}


class EventClock:
    """Accumulates simulated wall time, one global round at a time."""

    def __init__(self, rt: RuntimeModel, fl: FLConfig):
        self.rt, self.fl = rt, fl
        self.now = 0.0
        # per-cluster async timeline carried across charge_program_async
        # rounds (None until the first async charge)
        self._async_carry: Optional[Dict[str, object]] = None

    def charge_round(self, speeds: Optional[Sequence[float]] = None,
                     uplink_ratio: float = 1.0) -> float:
        """Advance the clock by one global round of ``fl.algorithm``.

        ``speeds`` are the FLOP/s of the devices that participated this
        round (the max_k rule runs over them only); omitted means the
        RuntimeModel's homogeneous/default speeds. Returns the new time.
        """
        fl = self.fl
        comp = self.rt.compute_time(fl.q * fl.tau, speeds)
        comm = self.rt.comm_time(fl.algorithm, fl.q, fl.pi, uplink_ratio)
        self.now += comp + comm
        return self.now

    def charge_program(self, program: prg.RoundProgram,
                       speeds: Optional[Sequence[float]] = None,
                       mask: Optional[np.ndarray] = None,
                       uplink_ratio: float = 1.0) -> float:
        """Advance the clock by one round of ``program`` — the per-op
        cost hook: each op is priced individually, so non-canonical
        schedules (adaptive τ_k, time-varying π_t) are charged what
        they actually execute. ``speeds`` here is the FULL per-device
        FLOP/s vector (``mask`` selects the participants), unlike
        ``charge_round``'s participant subset."""
        self.now += (program_compute_time(self.rt, program, speeds, mask)
                     + program_comm_time(self.rt, self.fl.algorithm,
                                         program, uplink_ratio))
        return self.now

    def charge_program_async(self, program: prg.RoundProgram,
                             speeds: Optional[Sequence[float]] = None,
                             mask: Optional[np.ndarray] = None,
                             uplink_ratio: float = 1.0, *,
                             staleness: int,
                             labels: Optional[np.ndarray] = None) -> float:
        """Advance the clock by one *async* round of ``program``: the
        per-cluster timeline (:func:`async_program_timeline`) is carried
        ACROSS rounds, so fast clusters flow through round boundaries
        and the clock reads the max cluster end time instead of summing
        max-over-participants barriers. At ``staleness == 0`` this
        delegates to :meth:`charge_program` — exactly equal, not merely
        close (the barrier degeneracy)."""
        if staleness == 0:
            self._async_carry = None
            return self.charge_program(program, speeds, mask,
                                       uplink_ratio)
        if self._async_carry is None:
            self._async_carry = {
                "T_end": np.full(self.fl.num_clusters, self.now),
                "cols": []}
        tl = async_program_timeline(self.rt, self.fl, program, speeds,
                                    mask, labels, staleness,
                                    uplink_ratio,
                                    carry=self._async_carry)
        self._async_carry = tl["carry_out"]
        self.now = float(tl["makespan"])
        return self.now


def run_wall_clock(sim, rt: RuntimeModel, rounds: int, *,
                   eval_every: int = 1, eval_batch: int = 512,
                   uplink_ratio: float = 1.0,
                   async_staleness: Optional[int] = None,
                   ckpt_dir: Optional[str] = None,
                   ckpt_every: int = 0,
                   resume: bool = False
                   ) -> Dict[str, List[float]]:
    """Drive ``sim`` (an FLSimulator) for ``rounds`` global rounds under
    the event clock, returning a history dict with ``round``,
    ``wall_time``, ``acc``, ``loss`` and ``participants`` columns.

    Every round is charged its program per op. Without a scenario the
    full fleet runs at the RuntimeModel's own speeds; with one the
    round's plan paces it (the scenario's speed multipliers × the
    profile's ``device_flops``, masked to the cohort), a faulted round
    adds its retry ladder (:func:`fault_compute_penalty`; outages and
    link loss are already inside the plan's cohort and operators) and a
    streamed round adds its client paging over the d2e link
    (:func:`paging_comm_time`).

    ``async_staleness`` switches the loop to bounded-staleness
    execution: rounds run through ``sim.step_round_async`` and are
    charged the overlapped timeline's makespan
    (:meth:`EventClock.charge_program_async`); 0 reproduces the barrier
    loop exactly. An online schedule's estimator
    (``sim._schedule_fn.estimator``) is fed each round's per-device
    step counts and compute seconds.

    Besides the *simulated* wall clock, the history records the
    simulator's own host seconds per eval window, split into ``page_s``
    (host time spent paging the streamed client store: fetch, stage,
    drain, commit — deltas of the sim's ``_page_seconds``; 0 for the
    resident bank) and ``compute_s`` (the rest of the window, until its
    rounds have finished on the device, taken before the window's
    evaluation); ``eval_s`` is the evaluation's own host seconds (for a
    pipelined streamed sim it includes landing the in-flight page-out,
    which every store reader waits for).

    ``ckpt_dir`` + ``ckpt_every`` make the loop crash-consistent: every
    k-th round the full run state (bank buffers with the EF residual or
    the streamed store, key, scenario cursor, async carries, clock,
    schedule state, this history) is written atomically by
    :class:`repro_torch.checkpoint.runckpt.RunCheckpoint`; ``resume=True``
    restores the checkpoint there (if any) and continues from its round,
    bit for bit the uninterrupted run (the host-seconds columns aside)."""
    clock = EventClock(rt, sim.fl)
    on_card = sim.device.type == "cuda"
    hist: Dict[str, List[float]] = {
        "round": [], "wall_time": [], "acc": [], "loss": [],
        "participants": [], "page_s": [], "compute_s": [], "eval_s": []}
    rc = None if ckpt_dir is None else RunCheckpoint(ckpt_dir)
    start_round = 0
    if rc is not None and resume and rc.exists():
        meta = rc.restore(sim, clock=clock, hist=hist,
                          staleness=async_staleness)
        start_round = int(meta["round"])
    window_t0 = time.perf_counter()
    page0 = sim._page_seconds
    for r in range(start_round, rounds):
        if async_staleness is None:
            plan = sim.step_round()
        else:
            plan = sim.step_round_async(async_staleness, rt,
                                        uplink_ratio=uplink_ratio)
        program = sim.last_program
        if plan is not None:
            fleet = (np.asarray(sim.engine.speed_multipliers, float)
                     * rt.hw.device_flops)
            participants = int(plan.mask.sum())
            mask = plan.mask
        else:
            fleet, mask = None, None
            participants = sim.fl.n
        if async_staleness is None:
            t = clock.charge_program(program, fleet, mask, uplink_ratio)
        else:
            t = clock.charge_program_async(
                program, fleet, mask, uplink_ratio,
                staleness=async_staleness,
                labels=None if plan is None else plan.labels)
        # streamed rounds page client state through the edge: charge the
        # page-in/page-out rows as d2e traffic
        paging = sim.last_paging
        if paging is not None:
            clock.now += paging_comm_time(rt, paging["rows_in"],
                                          paging["rows_out"],
                                          paging["bits_per_row"])
            t = clock.now
        # straggler faults: price the retry ladder of timed-out devices
        # on top of the cohort's compute charge
        fault = getattr(plan, "fault", None)
        if fault is not None:
            pen = fault_compute_penalty(rt, program, sim.engine.sc.faults,
                                        fault, speeds=fleet, mask=mask)
            if pen > 0.0:
                clock.now += pen
                t = clock.now
        # online-schedule feedback: the realized per-device step counts
        # and compute seconds of this round
        est = getattr(sim._schedule_fn, "estimator", None)
        if est is not None:
            fleet_v = (fleet if fleet is not None
                       else np.full(sim.fl.n, rt.hw.device_flops))
            steps = program_device_steps(program, sim.fl.n)
            est.observe(steps, steps * rt.wl.flops_per_step / fleet_v,
                        mask)
        if (r + 1) % eval_every == 0:
            if on_card:
                # the rounds were only enqueued: wait for them to run
                torch.cuda.synchronize(sim.device)
            wall = time.perf_counter() - window_t0
            page_s = sim._page_seconds - page0
            eval_t0 = time.perf_counter()
            acc, loss = sim.evaluate(eval_batch)
            hist["eval_s"].append(time.perf_counter() - eval_t0)
            hist["round"].append(r + 1)
            hist["wall_time"].append(t)
            hist["acc"].append(acc)
            hist["loss"].append(loss)
            hist["participants"].append(participants)
            hist["page_s"].append(page_s)
            hist["compute_s"].append(max(wall - page_s, 0.0))
            window_t0 = time.perf_counter()
            page0 = sim._page_seconds
        if rc is not None and ckpt_every and (r + 1) % ckpt_every == 0:
            rc.save(sim, round_idx=r + 1, clock=clock, hist=hist,
                    staleness=async_staleness)
    return hist


def time_to_accuracy(hist: Dict[str, List[float]],
                     target: float) -> Optional[float]:
    """First wall-clock time at which the evaluated accuracy reached
    ``target``, or None if the curve never got there."""
    for t, a in zip(hist["wall_time"], hist["acc"]):
        if a >= target:
            return float(t)
    return None


def summarize(hist: Dict[str, List[float]], target: float) -> str:
    """One-line human summary of a wall-clock curve."""
    tta = time_to_accuracy(hist, target)
    final = hist["acc"][-1] if hist["acc"] else float("nan")
    total = hist["wall_time"][-1] if hist["wall_time"] else 0.0
    reach = "never" if tta is None else f"{tta:,.0f}s"
    return (f"final_acc={final:.3f} total={total:,.0f}s "
            f"time_to_{target:.0%}={reach}")
