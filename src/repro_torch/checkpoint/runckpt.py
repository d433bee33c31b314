"""Whole-run crash-consistent checkpointing: :class:`RunCheckpoint` (port of
``repro.checkpoint.runckpt``).

``checkpoint/ckpt.py`` persists a single tree; a *run* is more than its
parameters — killing a long wall-clock simulation mid-flight loses the
key stream's position, the scenario cursor (mobility labels + round
index), the async clock's cross-round timeline carry, the accuracy
history, any adaptive-schedule state and the uplink's error-feedback
residual. RunCheckpoint captures ALL of that as one fixed-structure tree
and writes it through the atomic ``save_checkpoint`` (temp file +
``os.replace``), so a reader always sees either the previous complete
checkpoint or the new one.

Restore is bit-identical: every per-round draw of the simulator is keyed
by ``(seed, round, stream, entity)`` (scenario cohorts, mobility,
faults) or threaded through the saved key (minibatches, DP noise,
stochastic rounding), so a run killed at round k and resumed replays
rounds k..R exactly as the uninterrupted run would have.

The tree has the reference's paths and dtypes (the key a (2,) uint32
array, the bank's (n, T) f32 buffers, the streamed store's encoded
snapshot, the legacy engine's params, momentum and residual trees), so a
checkpoint written by either package restores into the other's
simulator of the same configuration. A sharded engine
(``core/sharded.py``) writes the same file: its ranks gather their rows,
or their cold-store shards, into rank 0's host memory and rank 0
writes; on restore every rank reads the file and keeps its own rows or
its own shard.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core import collectives as col
from repro_torch.core.clientstore import SNAPSHOT_KEYS


def _capture(sim, round_idx: int, clock, hist, staleness: Optional[int],
             paths_only: bool = False) -> Dict[str, Any]:
    """The full run state as one fixed-structure tree.

    The structure is a function of the sim's *configuration* only
    (bank or streamed engine, residual on/off, scenario attached,
    schedule kind), never of how far the run has progressed — so a
    freshly constructed sim yields the exact ``like`` tree that
    ``load_checkpoint`` validates a saved run against. History columns
    are single arrays (their length lives in the data, not the tree) and
    the async clock carry is zero-padded to ``(k, m)`` with an explicit
    ``ncols`` count. ``paths_only`` (the ``like`` tree of a restore, whose
    paths alone are checked) copies no model state to the host and
    gathers nothing."""
    m = sim.fl.num_clusters
    n = sim.fl.n
    state: Dict[str, Any] = {
        "round": np.int64(round_idx),
        "sim_round": np.int64(sim.round_index),
        "key": np.asarray(sim.key, np.uint32),
        "labels": np.asarray(sim.labels, np.int64),
        "phases": np.asarray(sim._async_phases, np.int64),
    }
    empty = (lambda t: np.empty(0, np.float32))
    if sim.bank is not None:
        host = empty if paths_only else sim._host_rows
        bank = {"params": host(sim.bank.params),
                "mom": host(sim.bank.mom)}
        if sim.bank.residual is not None:
            bank["residual"] = host(sim.bank.residual)
        state["bank"] = bank
    elif sim.store is not None:
        # streamed engine: the cold store IS the model state — cluster
        # references plus the encoded momentum rows (stored encoded, so a
        # round trip reproduces the same cold bytes under every codec),
        # and the last-sync label tracker. A pipelined driver's in-flight
        # page-out lands first, making the store round-complete.
        state["store"] = ({k: np.empty(0) for k in SNAPSHOT_KEYS}
                          if paths_only else sim._store_snapshot())
        state["page_labels"] = np.asarray(sim._page_labels, np.int64)
    else:
        # the legacy pytree engine: its trees as they are
        host = empty if paths_only else (
            lambda t: t.detach().cpu().numpy())
        state["params"] = tr.tree_map(host, sim._params)
        state["mom"] = tr.tree_map(host, sim._mom)
        if sim._residual is not None:
            state["residual"] = tr.tree_map(host, sim._residual)
    if sim.engine is not None:
        state["engine"] = {
            "labels": np.asarray(sim.engine.labels, np.int64),
            "round": np.int64(sim.engine.round_index)}
    # adaptive-schedule state under fixed keys whatever the schedule:
    # pi_feedback's EMA anchor and the online speed estimator's
    # per-device rate EMA (NaN-filled when absent)
    fn = sim._schedule_fn
    fb = getattr(fn, "state", None)
    est = getattr(fn, "estimator", None)
    state["sched"] = {
        "ref": np.float64(fb["ref"] if fb is not None else np.nan),
        "ema": np.float64(fb["ema"] if fb is not None else np.nan),
        "rate": (np.asarray(est._rate, np.float64) if est is not None
                 else np.full(n, np.nan))}
    if clock is not None:
        k = max(int(staleness or 0), 1)
        carry = clock._async_carry
        t_end = np.zeros(m)
        cols = np.zeros((k, m))
        ncols = 0
        if carry is not None:
            t_end = np.asarray(carry["T_end"], float)
            live_cols = [np.asarray(c, float) for c in carry["cols"]]
            ncols = len(live_cols)
            if ncols:
                cols[:ncols] = np.stack(live_cols)
        state["clock"] = {
            "now": np.float64(clock.now), "T_end": t_end, "cols": cols,
            "ncols": np.int64(ncols), "live": np.int64(carry is not None)}
    if hist is not None:
        state["hist"] = {c: np.asarray(v, np.float64)
                         for c, v in hist.items()}
    return state


def _assign(sim, state: Dict[str, Any], clock, hist) -> None:
    """Write a restored state tree back into the live objects."""
    if sim.bank is not None:
        b = state["bank"]
        sim.bank.load_rows(b["params"], b["mom"], b.get("residual"))
    elif sim.store is not None:
        sim._load_store(state["store"])
        sim._page_labels = np.asarray(state["page_labels"], np.int64)
        # drop the pipelined driver's in-flight state: the device
        # references re-seed from the restored store at the next round
        sim._pipe = None
    else:
        def dev(a):
            return torch.from_numpy(np.array(a)).to(sim.device)
        sim._params = tr.tree_map(dev, state["params"])
        sim._mom = tr.tree_map(dev, state["mom"])
        if "residual" in state:
            sim._residual = tr.tree_map(dev, state["residual"])
    sim.key = np.asarray(state["key"], np.uint32)
    sim.labels = np.asarray(state["labels"], np.int64)
    sim.round_index = int(state["sim_round"])
    sim._async_phases = np.asarray(state["phases"], np.int64)
    if sim.engine is not None:
        sim.engine.labels = np.asarray(state["engine"]["labels"],
                                       np.int64)
        sim.engine.round_index = int(state["engine"]["round"])
    fn = sim._schedule_fn
    fb = getattr(fn, "state", None)
    if fb is not None:
        fb["ref"] = float(state["sched"]["ref"])
        fb["ema"] = float(state["sched"]["ema"])
    est = getattr(fn, "estimator", None)
    if est is not None:
        est._rate = np.asarray(state["sched"]["rate"], float)
    if clock is not None and "clock" in state:
        ck = state["clock"]
        clock.now = float(ck["now"])
        if int(ck["live"]):
            ncols = int(ck["ncols"])
            clock._async_carry = {
                "T_end": np.asarray(ck["T_end"], float),
                "cols": [np.asarray(ck["cols"][i], float)
                         for i in range(ncols)]}
        else:
            clock._async_carry = None
        # the sim's own async timeline carry is the clock's (both replay
        # the same per-cluster timeline each round); without it the first
        # resumed round would order its events from a cold timeline
        carry = clock._async_carry
        sim._async_carry = None if carry is None else {
            "T_end": carry["T_end"].copy(),
            "cols": [c.copy() for c in carry["cols"]]}
    if hist is not None and "hist" in state:
        for c, col in state["hist"].items():
            vals = [float(v) for v in np.asarray(col)]
            if c in ("round", "participants"):
                vals = [int(v) for v in vals]
            hist[c][:] = vals


class RunCheckpoint:
    """Atomic single-file run checkpoint under ``<dir>/run.npz``.

    ``save`` captures the sim + clock + history into one tree and writes
    it crash-consistently; ``restore`` validates the archive against a
    freshly constructed sim's structure (raising
    :class:`repro_torch.checkpoint.ckpt.CheckpointStructureError` naming
    any drifted tree paths) and writes every piece back in place.
    Returns the checkpoint meta, whose ``"round"`` is the next round to
    run."""

    FILENAME = "run.npz"

    def __init__(self, dirpath: str):
        self.dir = str(dirpath)
        self.path = os.path.join(self.dir, self.FILENAME)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, sim, *, round_idx: int, clock=None, hist=None,
             staleness: Optional[int] = None) -> None:
        """Write the run state; a sharded sim's ranks all call this, rank
        0 writes, and every rank returns once the file is complete."""
        state = _capture(sim, round_idx, clock, hist, staleness)
        mesh = getattr(sim, "mesh", None)
        if mesh is None or mesh.rank == 0:
            save_checkpoint(self.path, state, meta={
                "round": int(round_idx),
                "staleness": (None if staleness is None
                              else int(staleness)),
                "engine": ("bank" if sim.bank is not None else
                           "streamed" if sim.store is not None
                           else "legacy")})
        if mesh is not None:
            col.barrier(mesh)

    def restore(self, sim, *, clock=None, hist=None,
                staleness: Optional[int] = None) -> Dict[str, Any]:
        like = _capture(sim, 0, clock, hist, staleness, paths_only=True)
        state, meta = load_checkpoint(self.path, like=like)
        _assign(sim, state, clock, hist)
        meta["round"] = int(state["round"])
        return meta
