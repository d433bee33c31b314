"""Event clock: wall-clock time-to-accuracy accounting (paper §6, Figs. 5–6)
(port of ``repro.core.clock``: barrier rounds, static or over a virtual
population).

``FLSimulator`` measures accuracy per *round*; the paper's headline claim
is accuracy per *second*. :class:`EventClock` converts rounds to seconds
by charging each global round

    max over participating devices of  qτ·C/c_k      (compute, eq. 8)
  + the algorithm's communication terms               (RuntimeModel.comm_time)

and :func:`run_wall_clock` couples a simulator to that clock, emitting
``(wall_time, acc)`` curves and :func:`time_to_accuracy`. Rounds are
charged *per op* of their :class:`repro_torch.core.program.RoundProgram`
(:func:`program_compute_time`, :func:`program_comm_time`); the canonical
program reproduces ``charge_round`` to the last term; a streamed round
is also charged its client paging (:func:`paging_comm_time`).
Enumerated scenarios, fault penalties, async timelines and checkpoints
arrive with later slices.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import program as prg
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
    :func:`program_comm_time` sums, one entry per block."""
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


class EventClock:
    """Accumulates simulated wall time, one global round at a time."""

    def __init__(self, rt: RuntimeModel, fl: FLConfig):
        self.rt, self.fl = rt, fl
        self.now = 0.0

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


def run_wall_clock(sim, rt: RuntimeModel, rounds: int, *,
                   eval_every: int = 1, eval_batch: int = 512,
                   uplink_ratio: float = 1.0) -> Dict[str, List[float]]:
    """Drive ``sim`` (an FLSimulator) for ``rounds`` global rounds under
    the event clock, returning a history dict with ``round``,
    ``wall_time``, ``acc``, ``loss`` and ``participants`` columns.

    Every round is charged its program per op. Without a scenario the
    full fleet runs at the RuntimeModel's own speeds; with a population
    the round's plan paces it (its cohort's keyed speed multipliers ×
    the profile's ``device_flops``) and a streamed round adds its client
    paging over the d2e link (:func:`paging_comm_time`).

    Besides the *simulated* wall clock, the history records the
    simulator's own host seconds per eval window, split into ``page_s``
    (host time spent paging the streamed client store: fetch, stage,
    drain, commit — deltas of the sim's ``_page_seconds``; 0 for the
    resident bank) and ``compute_s`` (the rest of the window, until its
    rounds have finished on the device, taken before the window's
    evaluation); ``eval_s`` is the evaluation's own host seconds (for a
    pipelined streamed sim it includes landing the in-flight page-out,
    which every store reader waits for)."""
    clock = EventClock(rt, sim.fl)
    on_card = sim.device.type == "cuda"
    hist: Dict[str, List[float]] = {
        "round": [], "wall_time": [], "acc": [], "loss": [],
        "participants": [], "page_s": [], "compute_s": [], "eval_s": []}
    window_t0 = time.perf_counter()
    page0 = sim._page_seconds
    for r in range(rounds):
        plan = sim.step_round()
        if plan is not None:
            fleet = (np.asarray(sim.engine.speed_multipliers, float)
                     * rt.hw.device_flops)
            participants = int(plan.mask.sum())
            t = clock.charge_program(sim.last_program, fleet, plan.mask,
                                     uplink_ratio)
        else:
            participants = sim.fl.n
            t = clock.charge_program(sim.last_program, None, None,
                                     uplink_ratio)
        # streamed rounds page client state through the edge: charge the
        # page-in/page-out rows as d2e traffic
        paging = sim.last_paging
        if paging is not None:
            clock.now += paging_comm_time(rt, paging["rows_in"],
                                          paging["rows_out"],
                                          paging["bits_per_row"])
            t = clock.now
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
