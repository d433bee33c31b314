"""CE-FedAvg (Algorithm 1) — operator algebra + the simulation engine
(port of ``repro.core.cefedavg``: the resident-bank path and the
streamed virtual-population path).

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

The streamed engine (``streaming=True``, implied by a scenario with a
``PopulationConfig``) keeps no resident (n, T) bank: client state lives
in a :class:`repro_torch.core.clientstore.ClientStore` and each round
pages its working set (cohort + one cold representative per cluster)
into a hot (S, T) slab. ``pipeline=True`` overlaps that paging with
compute: the cold codec runs on the card
(:mod:`repro_torch.kernels.cold_codec`), the cluster references stay on
the card, round t's page-out copies back on a side stream while round
t+1 is staged and its encoded rows copied in. Enumerated scenarios
(``ScenarioEngine``), compaction, schedules, upload transforms and the
sharded streamed bank wait for later slices.
"""
from __future__ import annotations

import time
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
from repro_torch.core.clientstore import ClientStore
from repro_torch.core.modelbank import ModelBank, bucket_for, cohort_buckets
from repro_torch.core.scenario import (PopulationEngine, RoundPlan,
                                       make_masked_w)
from repro_torch.device import resolve_device
from repro_torch.kernels import cold_codec
from repro_torch.kernels.gossip_mix import FlatLayout, gossip_mix_rows
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


class _PinnedPair:
    """Two pinned host buffers of one shape and dtype, used in turn, so a
    copy into or out of one may still be in flight while the other is
    filled; :meth:`take` waits for the copy that last used the buffer it
    hands out (``events[i]``, set by the caller)."""

    def __init__(self, shape, dtype):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                     for _ in range(2)]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def take(self) -> Tuple[int, torch.Tensor]:
        i, self.turn = self.turn, self.turn ^ 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        return i, self.bufs[i]


class FLSimulator:
    """Runs Algorithm 1 over a flat bank of device models.

    init_fn(generator) -> params tree (the port's ``models.cnn`` init
          functions, or a tree converted from the reference's init by
          :mod:`repro_torch.convert` for parity runs);
    apply_fn(params, x) -> logits.
    data: dict with xs (n, N, ...), ys (n, N) — per-device training
          shards; test_x, test_y — the common test set (numpy arrays or
          tensors; moved to ``device`` once).
    scenario: optional ``config.ScenarioConfig`` with a
          ``PopulationConfig``: a virtual population whose keyed cohort
          draws (:class:`repro_torch.core.scenario.PopulationEngine`)
          pick each round's trainers; implies ``streaming``. Each
          cohort client trains on data shard ``client_id % n``.
    streaming: True pages client state through a
          :class:`repro_torch.core.clientstore.ClientStore` instead of a
          resident (n, T) bank; only each round's working set (cohort +
          one cold representative per cluster) is on the device, as
          the hot slab. At enumerated n it reproduces the resident
          trajectory to float tolerance.
    codec: cold-row codec of the store ("f32", "f16", "int8"); a
          population's ``PopulationConfig.codec`` wins.
    pipeline: True overlaps streamed paging with compute: the cold codec
          runs on the device, the cluster references stay there, round
          t's page-out copies back while round t+1 is staged. Bitwise
          the serial streamed driver at f32 (to codec tolerance at f16
          and int8); requires streaming.
    device: where the bank or slab lives and every round runs; None
          means the CUDA card, and raises without one (pass "cpu" to run
          there).
    """

    def __init__(self, init_fn: Callable, apply_fn: Callable, fl: FLConfig,
                 data: Dict[str, object], *, lr: float = 0.05,
                 momentum: float = 0.9, batch_size: int = 50, seed: int = 0,
                 scenario=None, streaming: bool = False, codec: str = "f32",
                 pipeline: bool = False,
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
        # a virtual population swaps in the keyed cohort engine and
        # forces the streamed engine
        self.engine: Optional[PopulationEngine] = None
        self.pop: Optional[PopulationEngine] = None
        if scenario is not None:
            if scenario.population is None:
                raise NotImplementedError(
                    "enumerated scenarios (ScenarioEngine) arrive with a "
                    "later slice; only virtual populations run here")
            self.engine = self.pop = PopulationEngine(scenario, fl)
            streaming = True
        # current cluster assignment B_t (static without a scenario)
        self.labels = np.repeat(np.arange(fl.num_clusters),
                                fl.devices_per_cluster)
        # Algorithm 1 initializes every device from its edge model y_{0,0};
        # one shared init (common FL practice) keeps params cluster-uniform
        one = init_fn(torch.Generator().manual_seed(seed))
        self.layout = FlatLayout.for_tree(one)
        self.bank: Optional[ModelBank] = None
        self.store: Optional[ClientStore] = None
        self._streamed = bool(streaming)
        if self._streamed:
            if fl.algorithm == "dec_local_sgd":
                raise ValueError("dec_local_sgd ties devices to clusters "
                                 "(n == m): no cold rows to stream")
            if self.pop is not None:
                codec = scenario.population.codec
            self.store = ClientStore(
                self.layout, fl.num_clusters,
                self.layout.flatten_one(one).detach().cpu().numpy(),
                codec=codec)
            # slab capacity: the cohort cap plus one representative per
            # cluster, padded up to power-of-two buckets
            cap = (self.engine.cohort_cap if self.pop is not None
                   else n + fl.num_clusters)
            self._buckets = cohort_buckets(cap)
            # a cold client's params are its cluster's reference at its
            # last sync: each enumerated device's label as of the previous
            # round's trailing boundary (constant until enumerated
            # scenarios move devices)
            self._page_labels = self.labels.copy()
            self._pipe: Optional[Dict] = None
        else:
            self.bank = ModelBank.from_model(one, n, device=self.device)
        self._pipeline = bool(pipeline)
        if self._pipeline and not self._streamed:
            raise ValueError("pipeline=True overlaps paging with compute: "
                             "it needs the streamed engine (streaming=True "
                             "or a population scenario)")
        # cumulative host seconds spent paging (staging, fetch, commit,
        # drain); clock.run_wall_clock reads deltas of it as page_s
        self._page_seconds = 0.0
        self.last_bucket = n   # slab rows used by the latest round
        self._peak_slab = 0
        # the latest streamed round's paging (rows in/out, bits a row),
        # which the event clock charges; None for the resident bank
        self.last_paging: Optional[Dict[str, int]] = None
        self._canonical = prg.canonical_program(fl)
        self._hier = topo.Hierarchy.from_config(fl)
        self.round_index = 0
        self.last_program: Optional[prg.RoundProgram] = None
        self._lowered: Dict = {}       # (kind, signature) -> round fn
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
        if self.bank is None:
            raise AttributeError(
                "the streamed engine keeps no resident per-client params: "
                "read sim.store.cluster_params or edge_models()")
        return self.bank.params_tree()

    @property
    def mom(self):
        """Device-stacked momentum tree (views of the flat bank)."""
        if self.bank is None:
            raise AttributeError(
                "the streamed engine keeps no resident momentum: cold rows "
                "live in sim.store")
        return self.layout.unflatten_stack(self.bank.mom)

    @property
    def peak_slab_bytes(self) -> int:
        """Largest hot slab (params + momentum) a streamed round held — the
        O(cohort) resident bound; 0 for the resident engine."""
        return self._peak_slab

    # -- loss ----------------------------------------------------------------
    def _loss(self, p, x, y):
        return softmax_xent(self.apply_fn(p, x), y)

    # -- one round -----------------------------------------------------------
    @staticmethod
    def _step_keys(key: np.ndarray, runs) -> np.ndarray:
        """(steps, 2) keys of every local step of one round, from the
        reference's schedule: the round key split per block, each block
        key split per local step."""
        nblocks = sum(count for _, count in runs)
        bkeys = rnd.split(key, nblocks)
        out = []
        ki = 0
        for bp, count in runs:
            for _ in range(count):
                out.append(rnd.split(bkeys[ki], bp.local.tau))
                ki += 1
        return np.concatenate(out)

    def _local_step(self, Y: torch.Tensor, M: torch.Tensor,
                    xs: torch.Tensor, ys: torch.Tensor, idx: torch.Tensor,
                    lr: float) -> None:
        """One SGD+momentum step of every row of Y (row i trains on
        ``xs[i]``, ``ys[i]`` at batch indices ``idx[i]``), in place:
        M ← μM + G;  Y ← Y − lr·M.

        The reference's jitted round donated these buffers to XLA, which
        fused the update; here the bank is updated in place for the same
        effect (one resident copy of Y and M)."""
        n = Y.shape[0]
        rows = torch.arange(n, device=Y.device)[:, None]
        xb = xs[rows, idx]
        yb = ys[rows, idx]
        grads = self._grad_rows(self.layout.unflatten_stack(Y), xb, yb)
        M.mul_(self.momentum)
        for (o, s), g in zip(self.layout.segments, tr.tree_leaves(grads)):
            M[:, o:o + s].add_(g.reshape(n, s))
        Y.sub_(M, alpha=lr)

    def _run_blocks(self, Y, M, xs, ys, idx, runs, args, k: int):
        """The blocks of one lowered round: τ local steps of the first
        ``k`` rows (the trainers; the other rows stay frozen, as the
        reference's ``where`` keeps them), then one streaming pass of each
        MixGroup's operator over all rows. Returns Y (the same tensor on
        the card, where the square mix writes in place)."""
        mi = step = 0
        for bp, count in runs:
            gm = args.mats[mi:mi + len(bp.groups)]
            mi += len(bp.groups)
            lr = self.lr * bp.local.lr_scale
            for _ in range(count):
                for _ in range(bp.local.tau):
                    if k:
                        self._local_step(Y[:k], M[:k], xs, ys, idx[step],
                                         lr)
                    step += 1
                for W in gm:
                    Y = gossip_mix_rows(W, Y)
        return Y

    def _resolve_args(self, program: prg.RoundProgram,
                      plan: Optional[RoundPlan] = None) -> prg.RoundArgs:
        """Runtime operands of one round of ``program``: its mixing
        matrices (``resolve_matrices`` order) as f32 tensors on the
        device. Static rounds (``plan`` None) cache them per program
        structure; a plan's round takes its masked, renormalized
        operators (a population has no faults, so no operator is
        gated)."""
        plans = prg.lowering_plan(program, fuse=True)
        if plan is None:
            ck = program.signature
            mats = self._static_mats.get(ck)
            if mats is None:
                def inter_of_pi(pi: int) -> np.ndarray:
                    if pi != self.fl.pi:
                        raise NotImplementedError(
                            "gossip depths other than fl.pi arrive with "
                            "the schedules of a later slice")
                    return self.sched.W_inter

                def tier_of(op: prg.TierMix) -> np.ndarray:
                    return self._hier.tier_operator(
                        op.level, op.pi, self.fl.topology, self.fl.mixing,
                        self.fl)
                mats = tuple(
                    torch.from_numpy(m).to(self.device)
                    for m in prg.resolve_matrices(plans, self.sched.W_intra,
                                                  inter_of_pi, tier_of))
                self._static_mats[ck] = mats
            return prg.RoundArgs(mats)
        if not program.mask_renorm:
            raise ValueError("plan rounds need mask-renormalized operators: "
                             "unrenormalized rows weight absent members")
        H = self._backhaul()

        def inter_of_pi(pi: int) -> np.ndarray:
            if pi == self.fl.pi:
                return plan.W_inter
            return make_masked_w(self.fl, plan.labels, plan.mask, H,
                                 pi=pi)[1]

        def tier_of(op: prg.TierMix) -> np.ndarray:
            hier = self._hier
            B = topo.assignment_matrix(
                hier.node_labels(op.level, plan.labels),
                hier.num_nodes(op.level))
            H_l = hier.mixing(op.level, self.fl.topology, self.fl.mixing,
                              self.fl)
            return topo.masked_inter_operator(B, H_l, op.pi, plan.mask)
        return prg.RoundArgs(tuple(
            torch.from_numpy(m).to(self.device)
            for m in prg.resolve_matrices(plans, plan.W_intra, inter_of_pi,
                                          tier_of)))

    def _backhaul(self) -> np.ndarray:
        """The m x m backhaul mixing matrix (a population has no link
        faults, so it is the static one)."""
        return self.engine.H if self.engine is not None else self.sched.H

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
        n, N = self.sched.n, self.data["xs"].shape[1]

        def global_round(Y, M, key, args):
            # every step's batch indices in one host draw and one copy
            idx = rnd.randint(self._step_keys(key, runs), (n, self.batch),
                              0, N)
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            return self._run_blocks(Y, M, self.data["xs"], self.data["ys"],
                                    idx, runs, args, n)
        return global_round

    def _lower_streamed(self, program: prg.RoundProgram,
                        per_client: bool = False) -> Callable:
        """Lower a plain RoundProgram to the streamed working-set round
        ``streamed_round(Y, M, key, didx, cids, k, args) -> Y``: all
        state is the hot (S, T) slab, the operators arrive restricted to
        the working set, ``didx`` maps each lane to its data shard,
        ``cids`` holds its client id, and the first ``k`` lanes are the
        trainers (cold representatives and padding only mix).
        ``per_client`` draws each trainer's batch from the step key
        folded with its client id (virtual populations); otherwise the
        enumerated-n draw is gathered by ``didx`` (the resident round's
        batches)."""
        if program.has_upload or program.adaptive:
            raise NotImplementedError(
                "streamed rounds run plain programs (no upload transforms, "
                "no adaptive steps)")
        plans = prg.lowering_plan(program, fuse=True)
        if not plans[-1].groups:
            raise ValueError(
                "streamed rounds need a trailing mixing boundary (page-out "
                "reads cluster-synced rows back as the references)")
        runs = prg.block_runs(plans)
        n, N = self.sched.n, self.data["xs"].shape[1]

        def streamed_round(Y, M, key, didx, cids, k, args):
            skeys = self._step_keys(key, runs)
            if per_client:
                # (steps, k) keys in one vectorized fold_in, then every
                # trainer's batch of every step in one randint
                idx = rnd.randint(rnd.fold_in(skeys[:, None, :], cids[:k]),
                                  (self.batch,), 0, N)
            else:
                idx = rnd.randint(skeys, (n, self.batch), 0, N)[:, didx[:k]]
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            sel = torch.from_numpy(np.asarray(didx[:k], np.int64)).to(
                self.device)
            return self._run_blocks(Y, M, self.data["xs"][sel],
                                    self.data["ys"][sel], idx, runs, args, k)
        return streamed_round

    def _get_round(self, kind: str, program: prg.RoundProgram) -> Callable:
        """The lowering of ``program`` for one engine kind ("flat",
        "streamed", "streamed_pop"), built once per program structure."""
        ck = (kind, program.signature)
        fn = self._lowered.get(ck)
        if fn is None:
            if kind == "flat":
                fn = self._lower_flat(program)
            else:
                fn = self._lower_streamed(program,
                                          per_client=kind == "streamed_pop")
            self._lowered[ck] = fn
        return fn

    def _next_key(self) -> np.ndarray:
        keys = rnd.split(self.key)
        self.key = keys[0]
        return keys[1]

    def step_round(self) -> Optional[RoundPlan]:
        """Advance ONE global round of the canonical program (q blocks of
        τ local steps, each closed by its mixing boundary);
        ``last_program`` records the program for the event clock.
        Returns the round's plan (a ``CohortPlan`` with a population),
        or None without a scenario."""
        if self._streamed:
            if self._pipeline:
                return self._step_round_streamed_pipelined()
            return self._step_round_streamed()
        program = self._canonical
        self.round_index += 1
        self.last_program = program
        fn = self._get_round("flat", program)
        k = self._next_key()
        b = self.bank
        b.params = fn(b.params, b.mom, k, self._resolve_args(program))
        return None

    # -- streamed rounds -----------------------------------------------------
    def _begin_streamed(self):
        """Draw the round's plan and program (shared by both streamed
        drivers)."""
        plan = self.engine.step() if self.engine is not None else None
        r = self.round_index
        self.round_index += 1
        program = self._canonical
        self.last_program = program
        return plan, r, program

    def _slab_args(self, program: prg.RoundProgram, ws: Dict,
                   r: int) -> prg.RoundArgs:
        """The round's operators restricted to the working set (exact:
        every masked operator row reads participant columns only and is
        a function of the row's cluster label)."""
        W_i, W_e = make_masked_w(self.fl, ws["ws_labels"], ws["mask_slab"],
                                 self._backhaul())
        splan = RoundPlan(r, self.fl.num_clusters, ws["ws_labels"],
                          ws["mask_slab"], W_i, W_e)
        return self._resolve_args(program, splan)

    def _finish_streamed(self, S: int, k: int) -> None:
        self.last_bucket = S
        self._peak_slab = max(self._peak_slab, 2 * 4 * S * self.layout.total)
        # paging = device<->edge traffic: each trainer downloads its row
        # and uploads it back (references live at the edge already)
        self.last_paging = {"rows_in": k, "rows_out": k,
                            "bits_per_row": self.store.bits_per_row}

    def _step_round_streamed(self) -> Optional[RoundPlan]:
        """One serial streamed global round: page the working set in on
        the host (params from each lane's cluster reference, momentum
        decoded by the host codec for the trainers, zeros on first
        touch), run the slab-restricted program, page out (each
        cluster's synced lane becomes its reference; the trainers'
        momentum is re-encoded). The pipelined driver's oracle."""
        st = self.store
        m = self.fl.num_clusters
        plan, r, program = self._begin_streamed()
        ws = self._working_set(plan)
        k, S = ws["k"], ws["S"]
        clients, ws_labels = ws["clients"], ws["ws_labels"]
        args = self._slab_args(program, ws, r)
        t0 = time.perf_counter()
        params_rows = st.cluster_params[ws["src_labels"]]
        mom_rows = np.zeros((S, self.layout.total), np.float32)
        if k:
            mom_rows[:k] = st.fetch(clients[:k])
        slab = ModelBank.from_rows(self.layout, params_rows, mom_rows,
                                   device=self.device)
        del params_rows, mom_rows
        self._page_seconds += time.perf_counter() - t0
        fn = self._get_round(
            "streamed_pop" if self.pop is not None else "streamed", program)
        Y = fn(slab.params, slab.mom, self._next_key(), ws["didx"], clients,
               k, args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        Yh = Y.cpu().numpy()
        Mh = slab.mom[:k].cpu().numpy()
        # page-out: the last lane of each cluster (representatives win
        # over participants by position) carries the synced reference
        ref_lane = np.full(m, -1, np.int64)
        ref_lane[ws_labels] = np.arange(S)
        refs = st.cluster_params.copy()
        for c in range(m):
            if ref_lane[c] >= 0:
                refs[c] = Yh[ref_lane[c]]
        st.update_clusters(refs)
        if k:
            st.commit(clients[:k], Mh)
        self._page_seconds += time.perf_counter() - t0
        self._finish_streamed(S, k)
        return plan

    def _working_set(self, plan) -> Dict:
        """One streamed round's working set from its plan — shared by the
        serial and pipelined drivers (identical assembly is half of their
        bit-identity)."""
        m = self.fl.num_clusters
        if self.pop is not None:
            # virtual population: cohort ids from the keyed engine, one
            # cold representative per (not fully sampled) cluster; a
            # lane's data shard is its id mod the enumerated shard count
            cohort = np.asarray(plan.clients, np.int64)
            reps = self.engine.representatives(cohort)
            clients = np.concatenate([cohort, reps])
            ws_labels = np.concatenate(
                [np.asarray(plan.labels, np.int64),
                 self.engine.home_cluster(reps)])
            src_labels = ws_labels
            didx = clients % self.data["xs"].shape[0]
        else:
            # enumerated n without a scenario: every device trains, so
            # the working set is the whole fleet and has no cold lanes
            cohort = clients = np.arange(self.sched.n, dtype=np.int64)
            ws_labels = self.labels
            src_labels = self._page_labels
            didx = clients
        k = int(cohort.shape[0])
        S_raw = int(clients.shape[0])
        S = bucket_for(S_raw, self._buckets)
        pad = S - S_raw
        if pad:
            # padding duplicates lane 0 wholesale (client id, labels, data
            # shard) as a frozen extra cold member of lane 0's cluster,
            # whose post-round row is that cluster's synced value
            clients = np.concatenate([clients, np.repeat(clients[:1], pad)])
            ws_labels = np.concatenate(
                [ws_labels, np.repeat(ws_labels[:1], pad)])
            src_labels = np.concatenate(
                [src_labels, np.repeat(src_labels[:1], pad)])
            didx = np.concatenate([didx, np.repeat(didx[:1], pad)])
        lane = np.zeros(S, bool)
        lane[:k] = True
        return {"cohort": cohort, "clients": clients,
                "ws_labels": ws_labels, "src_labels": src_labels,
                "didx": didx, "k": k, "S": S, "lane": lane,
                "mask_slab": lane.astype(float)}

    # -- overlapped streamed driver ------------------------------------------
    def _peek_plan(self):
        """The NEXT round's plan without advancing the engine: every
        engine draw is keyed by (seed, round, stream, entity), and
        ``step()`` only reassigns ``round_index`` / ``labels`` /
        ``speed_multipliers``, so saving those, stepping and restoring
        them leaves the engine as it was."""
        eng = self.engine
        if eng is None:
            return None
        saved = [(a, getattr(eng, a))
                 for a in ("round_index", "labels", "speed_multipliers")]
        try:
            plan = eng.step()
        finally:
            for a, v in saved:
                setattr(eng, a, v)
        return plan

    @staticmethod
    def _plans_match(a, b) -> bool:
        """Prefetch invariant: the peeked plan equals the real one."""
        if a is None or b is None:
            return a is b
        for f in ("clients", "labels", "mask"):
            va, vb = getattr(a, f, None), getattr(b, f, None)
            if (va is None) != (vb is None):
                return False
            if va is not None and not np.array_equal(np.asarray(va),
                                                     np.asarray(vb)):
                return False
        return True

    def _pipe_state(self) -> Dict:
        if self._pipe is None:
            cuda = self.device.type == "cuda"
            self._pipe = {
                "refs": torch.tensor(self.store.cluster_params,
                                     device=self.device),
                "pending": None, "staged": None, "prev": None,
                # host<->device copies run on their own stream, beside
                # the round's compute
                "copy": torch.cuda.Stream(self.device) if cuda else None,
                "pinned": {}}
        return self._pipe

    def _pinned(self, tag: str, shape, dtype) -> _PinnedPair:
        pinned = self._pipe["pinned"]
        key = (tag, tuple(shape), dtype)
        if key not in pinned:
            pinned[key] = _PinnedPair(shape, dtype)
        return pinned[key]

    def _upload(self, tag: str, rows: np.ndarray, S: int):
        """(S, ...) device tensor of ``rows`` followed by zero rows, and
        the event its copy records (None on the CPU). On the card the
        rows go through a pinned buffer and are copied on the copy
        stream; the buffer is reused two stagings later, after that
        copy's event."""
        k = rows.shape[0]
        dtype = torch.from_numpy(rows[:0]).dtype
        shape = (S,) + rows.shape[1:]
        p = self._pipe
        if p["copy"] is None or 0 in shape:
            out = torch.zeros(shape, dtype=dtype, device=self.device)
            out[:k] = torch.from_numpy(np.ascontiguousarray(rows))
            return out, None
        ring = self._pinned(tag, shape, dtype)
        i, buf = ring.take()
        host = buf.numpy()
        host[:k] = rows
        host[k:] = 0
        with torch.cuda.stream(p["copy"]):
            out = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(p["copy"])
        ring.events[i] = ev
        return out, ev

    def _download(self, tensors: Dict[str, torch.Tensor]) -> Dict:
        """Start copying ``tensors`` to the host: on the card into pinned
        buffers on the copy stream, after the compute stream's work so
        far, with an ``event`` to wait on; on the CPU the tensors
        themselves (no later step writes them). The device tensors stay
        referenced in the result until the drain has waited on the
        event, so the allocator cannot hand their memory out mid-copy."""
        p = self._pipe
        if p["copy"] is None:
            return dict(tensors, event=None)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        out: Dict = {"device": tensors}
        with torch.cuda.stream(p["copy"]):
            p["copy"].wait_event(ready)
            used = []
            for name, t in tensors.items():
                ring = self._pinned("out_" + name, t.shape, t.dtype)
                i, buf = ring.take()
                buf.copy_(t, non_blocking=True)
                out[name] = buf
                used.append((ring, i))
            ev = torch.cuda.Event()
            ev.record(p["copy"])
        for ring, i in used:
            ring.events[i] = ev
        out["event"] = ev
        return out

    def _stage_pipelined(self, plan, r: int) -> Dict:
        """Stage round ``r``'s page-in: assemble its working set, gather
        the cohort's *encoded* cold rows (commits up to r-2; the r-1
        delta arrives by device-side forwarding) and start their copy to
        the device — all while round r-1 computes."""
        ws = self._working_set(plan)
        qc, sc = self.store.fetch_encoded(ws["cohort"])
        # representative and padding lanes page in zero momentum: zero q
        # and zero scale decode to exact zeros under every codec
        ws["q"], ev_q = self._upload("in_q", qc, ws["S"])
        ws["s"], ev_s = self._upload("in_s", sc, ws["S"])
        ws["h2d"] = [e for e in (ev_q, ev_s) if e is not None]
        ws["plan"], ws["r"] = plan, r
        return ws

    def _drain_pipeline(self) -> None:
        """Land the in-flight page-out in the host store: wait for its
        copy, commit its encoded momentum and mirror the cluster
        references. Called by the next round (overlapped by that round's
        compute) and by every store reader, so observable host state is
        always round-complete."""
        p = self._pipe
        if not p or p["pending"] is None:
            return
        pend, p["pending"] = p["pending"], None
        if pend["event"] is not None:
            pend["event"].synchronize()
        st = self.store
        st.update_clusters(pend["refs"].numpy())
        k = pend["k"]
        if k:
            st.commit_encoded(pend["cohort"], pend["q"].numpy()[:k],
                              pend["s"].numpy()[:k])

    def _step_round_streamed_pipelined(self) -> Optional[RoundPlan]:
        """One overlapped streamed round.

        Per round t the host only drains round t-1's encoded page-out
        and stages round t+1's page-in from the peeked plan, both while
        round t computes on the card. The cluster references live on the
        device across rounds, and the momentum crosses the link at codec
        width both ways. When round t+1 is staged the store holds commits
        up to t-1, so clients sampled in both t and t+1 get their newest
        momentum forwarded on the device from round t's encoded page-out
        — exactly the missing delta."""
        m = self.fl.num_clusters
        codec, segs = self.store.codec, self.layout.segments
        p = self._pipe_state()
        plan, r, program = self._begin_streamed()
        staged, p["staged"] = p["staged"], None
        if staged is not None:
            if staged["r"] != r or not self._plans_match(staged["plan"],
                                                         plan):
                raise RuntimeError(
                    "prefetched plan diverged from the engine's real draw "
                    "(engine state was perturbed between rounds)")
            ws = staged
        else:
            # cold start (first round): stage now
            t0 = time.perf_counter()
            ws = self._stage_pipelined(plan, r)
            self._page_seconds += time.perf_counter() - t0
        k, S = ws["k"], ws["S"]
        args = self._slab_args(program, ws, r)
        q_in, s_in = ws["q"], ws["s"]
        if ws["h2d"]:
            stream = torch.cuda.current_stream(self.device)
            for ev in ws["h2d"]:
                stream.wait_event(ev)
            # made on the copy stream, used and freed on this one
            q_in.record_stream(stream)
            s_in.record_stream(stream)
        # pre, on the device: forward the rows of the previous cohort
        # sampled again now (their commit is still in flight), take
        # params from the resident references, decode the momentum
        prev = p["prev"]
        if prev is not None:
            _, si, di = np.intersect1d(prev["cohort"], ws["cohort"],
                                       assume_unique=True,
                                       return_indices=True)
            if si.size:
                src = torch.from_numpy(si.astype(np.int64)).to(self.device)
                dst = torch.from_numpy(di.astype(np.int64)).to(self.device)
                q_in[dst] = prev["q"][src]
                s_in[dst] = prev["s"][src]
        Y0 = p["refs"][torch.from_numpy(
            np.asarray(ws["src_labels"], np.int64)).to(self.device)]
        M = cold_codec.decode_rows(q_in, s_in, codec, segs)
        fn = self._get_round(
            "streamed_pop" if self.pop is not None else "streamed", program)
        Y = fn(Y0, M, self._next_key(), ws["didx"], ws["clients"], k, args)
        # post, on the device: fold each cluster's synced lane into the
        # references, encode the slab's momentum; the copy back starts
        # now and lands at the next drain
        ref_lane = np.full(m, -1, np.int64)
        ref_lane[ws["ws_labels"]] = np.arange(S)
        upd = np.nonzero(ref_lane >= 0)[0]
        refs_new = p["refs"].clone()
        refs_new[torch.from_numpy(upd).to(self.device)] = Y[
            torch.from_numpy(ref_lane[upd]).to(self.device)]
        q_out, s_out = cold_codec.encode_rows(M, codec, segs)
        p["refs"] = refs_new
        pending = dict(self._download({"q": q_out, "s": s_out,
                                       "refs": refs_new}),
                       cohort=ws["cohort"], k=k)
        # drain round r-1 (its copy overlapped round r's dispatch) and only
        # then stage r+1, so staging sees commits up to r-1 and the
        # forwarding delta is exactly cohort r
        t0 = time.perf_counter()
        self._drain_pipeline()
        p["pending"] = pending
        p["prev"] = {"cohort": ws["cohort"], "q": q_out, "s": s_out}
        p["staged"] = self._stage_pipelined(self._peek_plan(), r + 1)
        self._page_seconds += time.perf_counter() - t0
        self._finish_streamed(S, k)
        return plan

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
        the (m, n) projection streams the flat bank once. In the streamed
        engine the store's per-cluster references ARE y_t (the in-flight
        round's land first)."""
        if self._streamed:
            self._drain_pipeline()
            return self.layout.unflatten_stack(torch.tensor(
                self.store.cluster_params, device=self.device))
        B = topo.assignment_matrix(self.labels, self.fl.num_clusters)
        return self.bank.project(topo.masked_cluster_average(B))

    def global_model(self):
        """Device-average model x̄ as a single tree."""
        if self._streamed:
            self._drain_pipeline()
            # end-of-round rows are cluster-uniform, so the device average
            # is the cluster-size-weighted reference average
            sizes = (self.pop.sizes.astype(np.float64)
                     if self.pop is not None
                     else np.bincount(self.labels,
                                      minlength=self.fl.num_clusters)
                     .astype(np.float64))
            w = sizes / sizes.sum()
            row = (np.asarray(self.store.cluster_params, np.float64)
                   * w[:, None]).sum(0).astype(np.float32)
            return self.layout.unflatten_one(
                torch.from_numpy(row).to(self.device))
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
