"""CE-FedAvg (Algorithm 1) — operator algebra + the simulation engine
(port of ``repro.core.cefedavg``, the resident-bank path).

The paper's update rule (eq. 10):  X_{t+1} = (X_t − η G_t) W_t, with
W_t ∈ {I, V, B^T diag(c) H^π B} depending on the iteration (eq. 11).
``make_w_schedule`` builds those operators for CE-FedAvg and for every
baseline (Table 1 / §4.3 special cases); ``FLSimulator`` runs the literal
matrix form with all n device models materialized in a flat (n, T)
:class:`repro_torch.core.modelbank.ModelBank` on one device.

One round executes the canonical
:class:`repro_torch.core.program.RoundProgram`: per block, τ local
SGD+momentum steps on every row (per-row gradients by
``torch.func.vmap(torch.func.grad(...))``), then one streaming pass of
the gossip kernel per MixGroup — the coincident τ/qτ boundary arrives
pre-fused as ``W_inter @ W_intra``. Batches are drawn from the
reference's own key stream (:mod:`repro_torch.random`), one round's
indices at a time on the host, so the port sees the reference's batches.
Scenarios, compaction, schedules, upload transforms and the streamed
engines wait for later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import random as rnd
from repro_torch import tree as tr
from repro_torch.config import FLConfig
from repro_torch.core import program as prg
from repro_torch.core import topology as topo
from repro_torch.core.modelbank import ModelBank
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.models.cnn import accuracy, softmax_xent


@dataclass
class WSchedule:
    """Mixing operators applied at iteration boundaries (eq. 11)."""
    W_intra: np.ndarray      # applied when (t+1) % tau == 0 (and not inter)
    W_inter: np.ndarray      # applied when (t+1) % (q*tau) == 0
    H: np.ndarray            # m x m backhaul mixing matrix
    zeta: float
    cluster_sizes: List[int]
    adj: np.ndarray          # m x m backhaul adjacency (bool)

    @property
    def n(self) -> int:
        return self.W_intra.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """Backhaul degree of each cluster (traffic accounting)."""
        return self.adj.sum(1).astype(np.int64)


def make_w_schedule(fl: FLConfig) -> WSchedule:
    """Static mixing schedule (eq. 11 / Table 1): W_intra applied at
    τ-boundaries, W_inter at qτ-boundaries, specialized per algorithm via
    the §4.3 reductions (Hier-FAvg, FedAvg, Local-Edge, dec. local SGD).
    Assumes equal clusters and full participation."""
    fl.validate()
    m, n = fl.num_clusters, fl.n
    sizes = [fl.devices_per_cluster] * m
    V = topo.intra_cluster_operator(sizes)
    A = np.ones((n, n)) / n
    eye = np.eye(n)
    hier = topo.Hierarchy.from_config(fl)
    adj = hier.adjacency(1, fl.topology, fl)
    H = topo.mixing_matrix(adj, fl.mixing)
    if fl.algorithm == "ce_fedavg":
        W_intra, W_inter = V, topo.inter_cluster_operator(sizes, H, fl.pi)
    elif fl.algorithm == "hier_favg":
        W_intra, W_inter = V, A
    elif fl.algorithm == "fedavg":
        W_intra, W_inter = eye, A
    elif fl.algorithm == "local_edge":
        W_intra, W_inter = V, V
    elif fl.algorithm == "dec_local_sgd":
        # n == m: every device is its own cluster, neighbors gossip
        assert fl.devices_per_cluster == 1, "dec_local_sgd requires n == m"
        W_intra = eye
        W_inter = np.linalg.matrix_power(H, fl.pi)
    else:
        raise ValueError(fl.algorithm)
    return WSchedule(W_intra, W_inter, H, topo.zeta(H), sizes, adj)


def mix(W, params):
    """Apply a mixing operator over the leading device axis of every leaf:
    x_k ← Σ_j W[k,j]·x_j (row application), summed in f32."""
    def one(leaf):
        Wt = torch.as_tensor(np.asarray(W, np.float32), device=leaf.device)
        out = torch.tensordot(Wt, leaf.to(torch.float32), dims=([1], [0]))
        return out.to(leaf.dtype)
    return tr.tree_map(one, params)


class FLSimulator:
    """Runs Algorithm 1 with n materialized device models in a flat bank.

    init_fn(generator) -> params tree (the port's ``models.cnn`` init
          functions, or a tree converted from the reference's init by
          :mod:`repro_torch.convert` for parity runs);
    apply_fn(params, x) -> logits.
    data: dict with xs (n, N, ...), ys (n, N) — per-device training
          shards; test_x, test_y — the common test set (numpy arrays or
          tensors; moved to ``device`` once).
    device: where the bank lives and every round runs; None means the
          CUDA card, and raises without one (pass "cpu" to run there).
    """

    def __init__(self, init_fn: Callable, apply_fn: Callable, fl: FLConfig,
                 data: Dict[str, object], *, lr: float = 0.05,
                 momentum: float = 0.9, batch_size: int = 50, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.fl = fl
        self.apply_fn = apply_fn
        self.sched = make_w_schedule(fl)
        n = self.sched.n
        self.data = {
            k: torch.as_tensor(np.asarray(v)).to(self.device)
            for k, v in data.items()}
        for k in ("ys", "test_y"):
            self.data[k] = self.data[k].long()
        if self.data["xs"].shape[0] != n:
            raise ValueError(f"data holds {self.data['xs'].shape[0]} device "
                             f"shards for n={n} devices")
        self.lr, self.momentum, self.batch = lr, momentum, batch_size
        # current cluster assignment B_t (static in this engine)
        self.labels = np.repeat(np.arange(fl.num_clusters),
                                fl.devices_per_cluster)
        # Algorithm 1 initializes every device from its edge model y_{0,0};
        # one shared init (common FL practice) keeps params cluster-uniform
        one = init_fn(torch.Generator().manual_seed(seed))
        self.bank = ModelBank.from_model(one, n, device=self.device)
        self.layout = self.bank.layout
        self._canonical = prg.canonical_program(fl)
        self._hier = topo.Hierarchy.from_config(fl)
        self.round_index = 0
        self.last_program: Optional[prg.RoundProgram] = None
        self._lowered: Dict = {}       # program signature -> round fn
        self._static_mats: Dict = {}   # program signature -> device mats
        self.key = rnd.PRNGKey(seed + 1)

        # per-row gradients, taken with respect to the bank's leaf views:
        # a gradient through the flat row would materialize a zero-filled
        # (n, T) gradient per leaf and sum them
        self._grad_rows = vmap(grad(self._loss))

    # -- state as trees ------------------------------------------------------
    @property
    def params(self):
        """Device-stacked model tree (views of the flat bank)."""
        return self.bank.params_tree()

    @property
    def mom(self):
        """Device-stacked momentum tree (views of the flat bank)."""
        return self.layout.unflatten_stack(self.bank.mom)

    # -- loss ----------------------------------------------------------------
    def _loss(self, p, x, y):
        return softmax_xent(self.apply_fn(p, x), y)

    # -- one round -----------------------------------------------------------
    def _round_indices(self, key: np.ndarray, runs) -> torch.Tensor:
        """Batch indices of every local step of one round, (steps, n,
        batch), drawn on the host from the reference's key schedule —
        the round key split per block, each block key split per local
        step, ``randint(step_key, (n, batch), 0, N)`` — and moved to the
        device in one copy."""
        n, N = self.sched.n, self.data["xs"].shape[1]
        nblocks = sum(count for _, count in runs)
        bkeys = rnd.split(key, nblocks)
        draws = []
        ki = 0
        for bp, count in runs:
            for _ in range(count):
                for skey in rnd.split(bkeys[ki], bp.local.tau):
                    draws.append(rnd.randint(skey, (n, self.batch), 0, N))
                ki += 1
        return torch.from_numpy(np.stack(draws).astype(np.int64)).to(
            self.device)

    def _local_step(self, Y: torch.Tensor, M: torch.Tensor,
                    idx: torch.Tensor, lr: float) -> None:
        """One SGD+momentum step of every row, in place:
        M ← μM + G;  Y ← Y − lr·M.

        The reference's jitted round donated these buffers to XLA, which
        fused the update; here the bank is updated in place for the same
        effect (one resident copy of Y and M)."""
        n = Y.shape[0]
        rows = torch.arange(n, device=Y.device)[:, None]
        xb = self.data["xs"][rows, idx]
        yb = self.data["ys"][rows, idx]
        grads = self._grad_rows(self.layout.unflatten_stack(Y), xb, yb)
        M.mul_(self.momentum)
        for (o, s), g in zip(self.layout.segments, tr.tree_leaves(grads)):
            M[:, o:o + s].add_(g.reshape(n, s))
        Y.sub_(M, alpha=lr)

    def _resolve_args(self, program: prg.RoundProgram) -> prg.RoundArgs:
        """Runtime operands of one round of ``program``: its mixing
        matrices (``resolve_matrices`` order) as f32 tensors on the
        bank's device, cached per program structure."""
        ck = program.signature
        mats = self._static_mats.get(ck)
        if mats is None:
            def inter_of_pi(pi: int) -> np.ndarray:
                if pi != self.fl.pi:
                    raise NotImplementedError(
                        "gossip depths other than fl.pi arrive with the "
                        "schedules of a later slice")
                return self.sched.W_inter

            def tier_of(op: prg.TierMix) -> np.ndarray:
                return self._hier.tier_operator(
                    op.level, op.pi, self.fl.topology, self.fl.mixing,
                    self.fl)
            plans = prg.lowering_plan(program, fuse=True)
            mats = tuple(
                torch.from_numpy(m).to(self.device)
                for m in prg.resolve_matrices(plans, self.sched.W_intra,
                                              inter_of_pi, tier_of))
            self._static_mats[ck] = mats
        return prg.RoundArgs(mats)

    def _lower_flat(self, program: prg.RoundProgram) -> Callable:
        """Lower a plain RoundProgram to the flat global round
        ``global_round(Y, M, key, args) -> Y``: all state stays (n, T);
        each block runs τ local steps, then one streaming pass
        (``gossip_mix_rows``) of each MixGroup's fused operator — for the
        canonical program the final τ-boundary coincides with the
        qτ-boundary and arrives pre-fused as ``W_inter @ W_intra``. M is
        updated in place; the returned Y is the bank's params (the same
        tensor on the card, where the square mix writes in place)."""
        if program.has_upload or program.adaptive:
            raise NotImplementedError(
                "upload and adaptive programs arrive with a later slice")
        runs = prg.block_runs(prg.lowering_plan(program, fuse=True))

        def global_round(Y, M, key, args):
            idx = self._round_indices(key, runs)
            mi = step = 0
            for bp, count in runs:
                gm = args.mats[mi:mi + len(bp.groups)]
                mi += len(bp.groups)
                lr = self.lr * bp.local.lr_scale
                for _ in range(count):
                    for _ in range(bp.local.tau):
                        self._local_step(Y, M, idx[step], lr)
                        step += 1
                    for W in gm:
                        Y = gossip_mix_rows(W, Y)
            return Y
        return global_round

    def step_round(self) -> None:
        """Advance ONE global round of the canonical program (q blocks of
        τ local steps, each closed by its mixing boundary);
        ``last_program`` records the program for the event clock."""
        program = self._canonical
        self.round_index += 1
        self.last_program = program
        fn = self._lowered.get(program.signature)
        if fn is None:
            fn = self._lower_flat(program)
            self._lowered[program.signature] = fn
        keys = rnd.split(self.key)
        self.key, k = keys[0], keys[1]
        b = self.bank
        b.params = fn(b.params, b.mom, k, self._resolve_args(program))

    def run(self, rounds: int, eval_every: int = 1,
            eval_batch: int = 512) -> Dict[str, List[float]]:
        """``rounds`` rounds, evaluating every ``eval_every``."""
        hist: Dict[str, List[float]] = {"round": [], "acc": [], "loss": []}
        for r in range(rounds):
            self.step_round()
            if (r + 1) % eval_every == 0:
                acc, loss = self.evaluate(eval_batch)
                hist["round"].append(r + 1)
                hist["acc"].append(acc)
                hist["loss"].append(loss)
        return hist

    # -- evaluation ----------------------------------------------------------
    def edge_models(self):
        """Cluster-averaged (edge) models y_t — what the paper evaluates:
        the (m, n) projection streams the flat bank once."""
        B = topo.assignment_matrix(self.labels, self.fl.num_clusters)
        return self.bank.project(topo.masked_cluster_average(B))

    def global_model(self):
        """Device-average model x̄ as a single tree."""
        return self.bank.mean_model()

    @torch.no_grad()
    def evaluate(self, eval_batch: int = 512) -> Tuple[float, float]:
        """Mean test accuracy and loss of the m edge models on the common
        test set."""
        em = self.edge_models()
        tx = self.data["test_x"][:eval_batch]
        ty = self.data["test_y"][:eval_batch]

        def one(p):
            logits = self.apply_fn(p, tx)
            return accuracy(logits, ty), softmax_xent(logits, ty)
        accs, losses = vmap(one)(em)
        return float(accs.mean()), float(losses.mean())
