"""CE-FedAvg (Algorithm 1) — operator algebra + the simulation engine
(port of ``repro.core.cefedavg``: the resident-bank path and the
streamed virtual-population path).

The paper's update rule (eq. 10):  X_{t+1} = (X_t − η G_t) W_t, with
W_t ∈ {I, V, B^T diag(c) H^π B} depending on the iteration (eq. 11).
``make_w_schedule`` builds those operators for CE-FedAvg and for every
baseline (Table 1 / §4.3 special cases); ``FLSimulator`` runs the literal
matrix form with all n device models materialized in a flat (n, T)
:class:`repro_torch.core.modelbank.ModelBank` on one device.

One round executes a :class:`repro_torch.core.program.RoundProgram` —
the canonical one compiled from fl's τ/q/π, or what a ``schedule=``
hook returns for the round (adaptive per-cluster τ_k cut-offs,
time-varying π_t): per block, τ local SGD+momentum steps on every
participating row (per-row gradients by
``torch.func.vmap(torch.func.grad(...))``; masked rows and rows past
their ``tau_dev`` cut-off stay frozen), then one streaming pass of the
gossip kernel per MixGroup — the coincident τ/qτ boundary arrives
pre-fused as ``W_inter @ W_intra``. Batches are drawn from the
reference's own key stream (:mod:`repro_torch.random`), one round's
indices at a time on the host, so the port sees the reference's batches.

An enumerated scenario (:class:`repro_torch.core.scenario.ScenarioEngine`)
re-draws each round's participation, cluster assignment and faults; a
partial cohort trains on a compacted (k_pad, T) gather of its rows
(:func:`repro_torch.core.modelbank.compact_plan`) while every mixing
boundary still streams the whole bank, and every operator is fault-gated
before fusion. ``step_round_async`` replays a round's blocks as
per-cluster events under a staleness bound
(:func:`repro_torch.core.clock.async_program_timeline`,
:func:`repro_torch.core.gossip.staleness_mask`).

The streamed engine (``streaming=True``, implied by a scenario with a
``PopulationConfig``) keeps no resident (n, T) bank: client state lives
in a :class:`repro_torch.core.clientstore.ClientStore` and each round
pages its working set (cohort + one cold representative per cluster)
into a hot (S, T) slab. ``pipeline=True`` overlaps that paging with
compute: the cold codec runs on the card
(:mod:`repro_torch.kernels.cold_codec`), the cluster references stay on
the card, round t's page-out copies back on a side stream while round
t+1 is staged and its encoded rows copied in.

With ``compression=`` or ``dp=`` the canonical program uploads: each
block's device deltas are privatized (:mod:`repro_torch.core.privacy`)
and compressed with error feedback (:mod:`repro_torch.core.compress`,
the residual a third (n, T) buffer of the bank) before the first mix,
on the flat and legacy paths — compacted, streamed and async rounds
reject upload programs, as the reference's do.

``bank=False`` runs the legacy pytree engine (the reference's
``_lower_legacy``): params, momentum and the EF residual are trees of
(n, ...) leaves, every mix op is its own per-leaf ``mix`` contraction
(``fuse=False``), and masked or adaptive devices are frozen by
``where``. It runs no kernel; the reference keeps it as the bank
engine's bit-faithful oracle.

The streamed slab's placement, page-in, page-out and mixing are methods
(``_slab_lanes``, ``_page_in_momentum``, ``_fetch_encoded``,
``_forward_encoded``, ``_ref_rows``, ``_page_out_momentum``,
``_encode_slab``, ``_drain_pipeline``, ``_mixer``) that
:class:`repro_torch.core.sharded.ShardedStreamedBank` overrides to hold
a contiguous block of each round's lanes on each rank; ``store_shards``
and ``min_bucket`` give the single-process engine that engine's store
partition and slab buckets.
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
from repro_torch.core import clock as clk
from repro_torch.core import compress as cmp
from repro_torch.core import gossip as gsp
from repro_torch.core import privacy as prv
from repro_torch.core import program as prg
from repro_torch.core import topology as topo
from repro_torch.core.clientstore import ClientStore
from repro_torch.core.modelbank import (ModelBank, bucket_for,
                                        cohort_buckets, compact_plan)
from repro_torch.core.scenario import (PopulationEngine, RoundPlan,
                                       ScenarioEngine, make_masked_w)
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
    x_k ← Σ_j W[k,j]·x_j (row application), summed in f32. ``W`` is a
    host array or a tensor; a rectangular (m, n) W maps n device models
    to m."""
    def one(leaf):
        Wt = (W if isinstance(W, torch.Tensor)
              else torch.from_numpy(np.asarray(W, np.float32)))
        Wt = Wt.to(device=leaf.device, dtype=torch.float32)
        out = torch.tensordot(Wt, leaf.to(torch.float32), dims=([1], [0]))
        return out.to(leaf.dtype)
    return tr.tree_map(one, params)


def _row(tree, i: int):
    """Device ``i``'s tree of a device-stacked tree."""
    return tr.tree_map(lambda leaf: leaf[i], tree)


def _stack_trees(trees):
    """Stack per-device trees on a new leading axis."""
    return tr.tree_map(lambda *leaves: torch.stack(leaves), *trees)


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
    scenario: optional ``config.ScenarioConfig``. Without a
          ``PopulationConfig`` it runs over the n enumerated devices
          (:class:`repro_torch.core.scenario.ScenarioEngine`: per-round
          sampling, dropout, mobility, speeds and, with ``faults``,
          outages, link loss and straggler timeouts). With one, a
          virtual population whose keyed cohort draws
          (:class:`repro_torch.core.scenario.PopulationEngine`) pick
          each round's trainers; that implies ``streaming``, and each
          cohort client trains on data shard ``client_id % n``.
    schedule: optional round schedule — a name from
          ``program.SCHEDULES``, a ``program.ScheduleFn`` or a fixed
          ``program.RoundProgram``; None runs the canonical program
          compiled from fl's τ/q/π. Not with a virtual population.
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
    compression: optional ``compress.CompressionConfig``: devices upload
          compressed deltas (with error feedback, a residual row each).
    dp: optional ``privacy.DPConfig``: devices clip and noise their
          deltas before upload (before compression).
    bank: True (default) runs the flat ModelBank engine; False the
          legacy pytree engine (per-leaf mixing, ``where``-frozen steps).
          ``params``, ``mom`` and ``residual`` read and write as trees in
          both.
    store_shards: cold-store shards (``client_id % store_shards``
          routing) of the streamed engine.
    min_bucket: every streamed slab bucket is a multiple of it (the
          sharded streamed bank's rank count).
    device: where the bank or slab lives and every round runs; None
          means the CUDA card, and raises without one (pass "cpu" to run
          there).
    """

    def __init__(self, init_fn: Callable, apply_fn: Callable, fl: FLConfig,
                 data: Dict[str, object], *, lr: float = 0.05,
                 momentum: float = 0.9, batch_size: int = 50, seed: int = 0,
                 compression: Optional[cmp.CompressionConfig] = None,
                 dp: Optional[prv.DPConfig] = None,
                 scenario=None, schedule=None, bank: bool = True,
                 streaming: bool = False, codec: str = "f32",
                 store_shards: int = 1, min_bucket: int = 1,
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
        self.compression, self.dp = compression, dp
        # an enumerated scenario re-draws each round's plan; a virtual
        # population swaps in the keyed cohort engine and forces the
        # streamed engine
        self.engine: Optional[Union[ScenarioEngine, PopulationEngine]] = None
        self.pop: Optional[PopulationEngine] = None
        if scenario is not None and scenario.population is not None:
            self.engine = self.pop = PopulationEngine(scenario, fl)
            streaming = True
        elif scenario is not None:
            self.engine = ScenarioEngine(scenario, fl)
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
        with_residual = (compression is not None
                         and compression.error_feedback)
        if self._streamed:
            if not bank:
                raise ValueError("the streaming client store is a bank "
                                 "engine (bank=True)")
            if compression is not None or dp is not None:
                raise ValueError("streamed rounds run plain programs (no "
                                 "upload transforms)")
            if fl.algorithm == "dec_local_sgd":
                raise ValueError("dec_local_sgd ties devices to clusters "
                                 "(n == m): no cold rows to stream")
            if self.pop is not None:
                codec = scenario.population.codec
            self.store = ClientStore(
                self.layout, fl.num_clusters,
                self.layout.flatten_one(one).detach().cpu().numpy(),
                codec=codec, num_shards=store_shards)
            # slab capacity: the cohort cap plus one representative per
            # cluster, padded up to power-of-two buckets; min_bucket keeps
            # every bucket divisible by the sharded engine's rank count
            cap = (self.engine.cohort_cap if self.pop is not None
                   else n + fl.num_clusters)
            cap = -(-max(cap, min_bucket) // min_bucket) * min_bucket
            self._buckets = tuple(b for b in cohort_buckets(cap)
                                  if b % min_bucket == 0)
            # a cold client's params are its cluster's reference at its
            # last sync: each enumerated device's label as of the previous
            # round's trailing boundary (constant until enumerated
            # scenarios move devices)
            self._page_labels = self.labels.copy()
            self._pipe: Optional[Dict] = None
        elif bank:
            self.bank = self._make_bank(one, n, with_residual=with_residual)
            self._buckets = cohort_buckets(n)
        else:
            # the legacy pytree engine: every leaf stacked n times
            self._params = tr.tree_map(
                lambda leaf: leaf.detach().to(self.device).expand(
                    (n,) + tuple(leaf.shape)).clone(), one)
            self._mom = tr.tree_map(torch.zeros_like, self._params)
            self._residual = (tr.tree_map(torch.zeros_like, self._params)
                              if with_residual else None)
            self._buckets = cohort_buckets(n)
        # a partial cohort trains on a compacted (k_pad, T) gather of its
        # rows; False keeps it on the mask-frozen full bank
        self._compact_enabled = True
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
        # every round lowers a RoundProgram: the canonical one (with the
        # FaultGate directive under a fault-injecting scenario), or what
        # the schedule hook picks for the round
        faulted = self.engine is not None and self.engine.faults is not None
        upload = dict(privatize=dp is not None,
                      compress=compression is not None)
        self._canonical = prg.canonical_program(fl, faults=faulted,
                                                **upload)
        self._schedule_fn: Optional[prg.ScheduleFn] = None
        if isinstance(schedule, str):
            self._schedule_fn = prg.make_schedule(
                schedule, fl, engine=self.engine, faults=faulted, sim=self,
                **upload)
        elif isinstance(schedule, prg.RoundProgram):
            def _fixed(r, plan, _program=schedule):
                return _program
            self._schedule_fn = _fixed
        elif schedule is not None:
            self._schedule_fn = schedule
        if self.pop is not None and schedule is not None:
            raise ValueError("round schedules need enumerated devices "
                             "(tau_dev and speed vectors are per device): "
                             "not with a virtual population")
        self._hier = topo.Hierarchy.from_config(fl)
        self.round_index = 0
        self.last_program: Optional[prg.RoundProgram] = None
        self._lowered: Dict = {}       # (kind, signature) -> round fn
        self._static_mats: Dict = {}   # program signature -> device mats
        self._inter_static: Dict = {fl.pi: self.sched.W_inter}
        self._tier_static: Dict = {}   # depth>2 tiers: H_l, operators
        self._static_labels = self.labels.copy()
        # async bounded-staleness state: the per-cluster timeline carried
        # across rounds, the cumulative phases, the latest round's record
        self._async_carry: Optional[Dict] = None
        self._async_phases = np.zeros(fl.num_clusters, dtype=int)
        self.last_async: Optional[Dict] = None
        self.key = rnd.PRNGKey(seed + 1)

        # per-row gradients, taken with respect to the bank's leaf views:
        # a gradient through the flat row would materialize a zero-filled
        # (n, T) gradient per leaf and sum them
        self._grad_rows = vmap(grad(self._loss))

    def _make_bank(self, one, n: int, with_residual: bool) -> ModelBank:
        """The resident bank: every row broadcast from the shared init
        ``one`` on this sim's device."""
        return ModelBank.from_model(one, n, device=self.device,
                                    with_residual=with_residual)

    def _host_rows(self, buf: torch.Tensor) -> np.ndarray:
        """A bank buffer as the host (n, T) array a run checkpoint
        stores."""
        return buf.detach().cpu().numpy()

    # -- state as trees ------------------------------------------------------
    def _no_resident_rows(self, what: str):
        if self._streamed:
            raise AttributeError(
                f"the streamed engine keeps no resident per-client {what}: "
                "read sim.store.cluster_params or edge_models(); cold rows "
                "live in sim.store")

    @property
    def params(self):
        """Device-stacked model tree: views of the flat bank, or the legacy
        engine's own tree."""
        self._no_resident_rows("params")
        if self.bank is None:
            return self._params
        return self.bank.params_tree()

    @params.setter
    def params(self, tree):
        self._no_resident_rows("params")
        if self.bank is None:
            self._params = tree
        else:
            self.bank.params = self.layout.flatten_stack(tree).to(
                self.device)

    @property
    def mom(self):
        """Device-stacked momentum tree (see ``params``)."""
        self._no_resident_rows("momentum")
        if self.bank is None:
            return self._mom
        return self.layout.unflatten_stack(self.bank.mom)

    @mom.setter
    def mom(self, tree):
        self._no_resident_rows("momentum")
        if self.bank is None:
            self._mom = tree
        else:
            self.bank.mom = self.layout.flatten_stack(tree).to(self.device)

    @property
    def residual(self):
        """Error-feedback residual tree, or None when compression with
        error feedback is off (and in the streamed engine, whose rounds
        reject upload programs)."""
        if self._streamed:
            return None
        if self.bank is None:
            return self._residual
        if self.bank.residual is None:
            return None
        return self.layout.unflatten_stack(self.bank.residual)

    @residual.setter
    def residual(self, tree):
        if self.bank is None:
            self._residual = tree
        else:
            self.bank.residual = (
                None if tree is None
                else self.layout.flatten_stack(tree).to(self.device))

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
    def _block_keys(key: np.ndarray, runs, block_keyed: bool = False
                    ) -> np.ndarray:
        """(blocks, 2) keys of one round's blocks: the round key split per
        block; ``block_keyed`` (one-block programs of an async event)
        takes ``key`` as the block key itself."""
        nblocks = sum(count for _, count in runs)
        return key[None] if block_keyed else rnd.split(key, nblocks)

    @classmethod
    def _step_keys(cls, key: np.ndarray, runs, block_keyed: bool = False
                   ) -> np.ndarray:
        """(steps, 2) keys of every local step of one round, from the
        reference's schedule: each block key (:meth:`_block_keys`) split
        per local step."""
        bkeys = cls._block_keys(key, runs, block_keyed)
        out = []
        ki = 0
        for bp, count in runs:
            for _ in range(count):
                out.append(rnd.split(bkeys[ki], bp.local.tau))
                ki += 1
        return np.concatenate(out)

    def _local_step(self, Y: torch.Tensor, M: torch.Tensor,
                    xs: torch.Tensor, ys: torch.Tensor, idx: torch.Tensor,
                    lr: float, act: Optional[np.ndarray] = None) -> None:
        """One SGD+momentum step of the rows of Y whose ``act`` entry is
        set (None: every row; row i trains on ``xs[i]``, ``ys[i]`` at
        batch indices ``idx[i]``), in place:
        M ← μM + G;  Y ← Y − lr·M, and the other rows keep their values —
        the reference's ``where(act, μM + G, M)`` / ``where(act, Y − lr·M,
        Y)``. With every row set it runs on Y and M themselves, with no
        gather; otherwise on a gather of the set rows, written back.

        The reference's jitted round donated these buffers to XLA, which
        fused the update; here the bank is updated in place for the same
        effect (one resident copy of Y and M)."""
        if act is not None and not act.all():
            if not act.any():
                return
            sel = torch.from_numpy(np.nonzero(act)[0]).to(Y.device)
            Ya, Ma = Y[sel], M[sel]
            self._sgd_step(Ya, Ma, xs[sel], ys[sel], idx[sel], lr)
            Y.index_copy_(0, sel, Ya)
            M.index_copy_(0, sel, Ma)
            return
        self._sgd_step(Y, M, xs, ys, idx, lr)

    def _sgd_step(self, Y, M, xs, ys, idx, lr: float) -> None:
        n = Y.shape[0]
        rows = torch.arange(n, device=Y.device)[:, None]
        grads = self._grad_rows(self.layout.unflatten_stack(Y),
                                xs[rows, idx], ys[rows, idx])
        M.mul_(self.momentum)
        for (o, s), g in zip(self.layout.segments, tr.tree_leaves(grads)):
            M[:, o:o + s].add_(g.reshape(n, s))
        del grads
        Y.sub_(M, alpha=lr)

    def _train_block(self, Y, M, xs, ys, idx, step: int, op: prg.LocalSteps,
                     k: int, act: Optional[np.ndarray],
                     tau_rows: Optional[np.ndarray]) -> int:
        """τ local steps of one block on the first ``k`` rows of Y (the
        trainers; the other rows stay frozen), restricted to the rows
        whose ``act`` is set and, for an adaptive op, to the rows whose
        step index lies below their ``tau_rows`` cut-off (the
        reference's ``act & (s < tau_dev)``). Returns the next step's
        index into ``idx``."""
        lr = self.lr * op.lr_scale
        for s in range(op.tau):
            a = act
            if op.adaptive and tau_rows is not None:
                cut = np.asarray(tau_rows[:k]) > s
                a = cut if a is None else a & cut
            if k:
                self._local_step(Y[:k], M[:k], xs, ys, idx[step], lr, a)
            step += 1
        return step

    def _run_blocks(self, Y, M, xs, ys, idx, runs, args, k: int,
                    mix: Callable, act: Optional[np.ndarray] = None,
                    tau_rows: Optional[np.ndarray] = None,
                    bkeys: Optional[np.ndarray] = None,
                    R: Optional[torch.Tensor] = None):
        """The blocks of one lowered round: τ local steps of the trainers
        (:meth:`_train_block`), then one streaming pass of each
        MixGroup's operator over all rows. An upload block (which needs
        the round's block keys ``bkeys``) mixes the uploaded deltas
        instead: Y0 + W₀·upload(Y - Y0), then its remaining groups; the
        EF residual ``R`` is updated in place. ``mix`` applies a block's
        groups (:meth:`_mixer`). Returns Y (the same tensor on the card
        for a plain program, where the square mix writes in place)."""
        mi = step = ki = 0
        for bp, count in runs:
            gm = args.mats[mi:mi + len(bp.groups)]
            mi += len(bp.groups)
            for _ in range(count):
                Y0 = Y.clone() if bp.upload else None
                step = self._train_block(Y, M, xs, ys, idx, step, bp.local,
                                         k, act, tau_rows)
                if bp.upload:
                    delta = self._upload_deltas(Y.sub_(Y0), R,
                                                rnd.fold_in(bkeys[ki], 7),
                                                bp)
                    Y = mix(bp, gm, delta, 0, 1).add_(Y0)
                    del delta, Y0
                    Y = mix(bp, gm, Y, 1)
                else:
                    Y = mix(bp, gm, Y)
                ki += 1
        return Y

    def _mixer(self, program: prg.RoundProgram,
               block_keyed: bool = False) -> Callable:
        """How a lowering of ``program`` applies a block's MixGroups
        ``lo:hi`` to the rows Y, ``mix(bp, mats, Y, lo=0, hi=None)``: one
        streaming ``gossip_mix_rows`` pass of each group's resolved
        operator ``mats[j]`` (the sharded engine lowers them to
        collectives)."""
        def mix(bp, mats, Y, lo=0, hi=None):
            for W in mats[lo:hi]:
                Y = gossip_mix_rows(W, Y)
            return Y
        return mix

    def _upload_deltas(self, delta: torch.Tensor,
                       R: Optional[torch.Tensor], key: np.ndarray,
                       bp: prg.BlockPlan) -> torch.Tensor:
        """The devices' uploads of one block: DP (keys ``split(key, n)``),
        then compression (keys ``split(fold_in(key, 1), n)``), row-wise
        with the reference's per-device and per-leaf key schedule.
        Returns the uploaded deltas; the EF residual ``R`` is updated in
        place. The rows are the bank's ``rows`` of the n devices, and
        take those devices' keys."""
        n, rows = self.sched.n, self.bank.rows
        dp, comp = self.dp, self.compression
        if bp.privatize and dp is not None and dp.enabled:
            delta = prv.privatize_update_flat(delta, dp,
                                              rnd.split(key, n)[rows])
        if bp.compress and comp is not None and comp.kind != "none":
            delta, R_new = cmp.compress_flat(
                comp, delta, R, rnd.split(rnd.fold_in(key, 1), n)[rows],
                self.layout.segments)
            if R is not None:
                R.copy_(R_new)
        return delta

    # -- operators of one round ----------------------------------------------
    def _scenario_h(self, plan=None) -> np.ndarray:
        """The round's backhaul mixing matrix: the plan's link-loss
        degraded one (FaultModel), else the scenario's or the static."""
        if plan is not None and plan.H_eff is not None:
            return plan.H_eff
        return self.engine.H if self.engine is not None else self.sched.H

    def _inter_operator(self, pi: int, plan, renorm: bool) -> np.ndarray:
        """The (n, n) inter-cluster operator at gossip depth ``pi`` for
        this round — the static schedule's W_inter when possible, else
        the (masked) time-varying eq. 11 form at the requested depth,
        built over the plan's surviving backhaul under link faults."""
        if plan is None:
            W = self._inter_static.get(pi)
            if W is None:
                W = make_masked_w(self.fl, self._static_labels,
                                  np.ones(self.sched.n), self.sched.H,
                                  pi=pi)[1]
                self._inter_static[pi] = W
            return W
        if renorm:
            if pi == self.fl.pi:
                return plan.W_inter
            return make_masked_w(self.fl, plan.labels, plan.mask,
                                 self._scenario_h(plan), pi=pi)[1]
        return make_masked_w(self.fl, plan.labels,
                             np.ones(plan.labels.shape[0]),
                             self._scenario_h(plan), pi=pi)[1]

    def _tier_operator(self, op: prg.TierMix, plan, renorm: bool
                       ) -> np.ndarray:
        """The (n, n) dense operator of any ``TierMix`` this round: levels
        0 and 1 through the intra/inter resolvers (with the masked
        scenario forms), deeper tiers B_ℓ^T diag(c) H_ℓ^π B_ℓ from the
        hierarchy — cached per (level, pi) for static rounds, recomposed
        from the plan's labels lifted to tier-ℓ nodes otherwise."""
        hier = self._hier
        if not (0 <= op.level < hier.depth):
            raise ValueError(
                f"TierMix level {op.level} outside hierarchy of depth "
                f"{hier.depth} (tiers {hier.levels})")
        if op.level == 0:
            if plan is None:
                return self.sched.W_intra
            if renorm:
                return plan.W_intra
            return make_masked_w(self.fl, plan.labels,
                                 np.ones(plan.labels.shape[0]),
                                 self._scenario_h(plan))[0]
        if op.level == 1:
            return self._inter_operator(op.pi, plan, renorm)
        ck = ("H", op.level)
        H_l = self._tier_static.get(ck)
        if H_l is None:
            H_l = hier.mixing(op.level, self.fl.topology, self.fl.mixing,
                              self.fl)
            self._tier_static[ck] = H_l
        if plan is None:
            key = (op.level, op.pi)
            W = self._tier_static.get(key)
            if W is None:
                W = hier.tier_operator(op.level, op.pi, self.fl.topology,
                                       self.fl.mixing, self.fl)
                self._tier_static[key] = W
            return W
        B = topo.assignment_matrix(
            hier.node_labels(op.level, plan.labels),
            hier.num_nodes(op.level))
        return topo.masked_inter_operator(
            B, H_l, op.pi, plan.mask if renorm else None)

    def _fault_gate(self, program: prg.RoundProgram, plan) -> Callable:
        """Per-op operator gate for the plan's realized faults: under a
        ``FaultGate`` directive with dark clusters, every resolved
        operator gets :func:`repro_torch.core.gossip.fault_gate` applied
        *before* any fusion (gate(A)·gate(B) is what the fused boundary
        executes). Identity otherwise."""
        if (program.fault_gate and plan is not None
                and plan.fault is not None
                and plan.fault.cluster_down.any()):
            down = plan.fault.cluster_down
            labels = plan.labels
            return lambda W: gsp.fault_gate(W, labels, down)
        return lambda W: W

    def _resolve_mats(self, program: prg.RoundProgram, plan,
                      fuse: bool = True) -> Tuple[np.ndarray, ...]:
        """The round's mixing matrices on the host, in ``resolve_matrices``
        order: fault-gated, masked and renormalized (or not) as the
        program's directives ask; one a fused MixGroup, or one a mix op
        where ``fuse`` is False (the legacy engine)."""
        plans = prg.lowering_plan(program, fuse=fuse)
        renorm = program.mask_renorm
        if plan is None:
            return prg.resolve_matrices(
                plans, self.sched.W_intra,
                lambda pi: self._inter_operator(pi, None, renorm),
                tier_of=lambda op: self._tier_operator(op, None, renorm))
        gate = self._fault_gate(program, plan)
        return prg.resolve_matrices(
            plans, gate(self._tier_operator(prg.IntraMix(), plan, renorm)),
            lambda pi: gate(self._inter_operator(pi, plan, renorm)),
            tier_of=lambda op: gate(self._tier_operator(op, plan, renorm)))

    def _resolve_args(self, program: prg.RoundProgram, plan=None,
                      fuse: bool = True) -> prg.RoundArgs:
        """Runtime operands of one round of ``program``: its mixing
        matrices as f32 tensors on the device (static rounds cache them
        per program structure and ``fuse``) and, for an adaptive program,
        its per-device step cut-offs (host array)."""
        if plan is None:
            ck = (fuse, program.signature)
            mats = self._static_mats.get(ck)
            if mats is None:
                mats = tuple(torch.from_numpy(m).to(self.device)
                             for m in self._resolve_mats(program, None,
                                                         fuse))
                self._static_mats[ck] = mats
        else:
            mats = tuple(torch.from_numpy(m).to(self.device)
                         for m in self._resolve_mats(program, plan, fuse))
        tau_dev = (np.asarray(program.tau_dev, np.int32)
                   if program.adaptive else None)
        return prg.RoundArgs(mats, tau_dev)

    # -- lowerings -----------------------------------------------------------
    def _lower_legacy(self, program: prg.RoundProgram) -> Callable:
        """Lower a RoundProgram to the legacy pytree round
        ``legacy_round(params, mom, residual, key, args, mask) -> (params,
        mom, residual)`` (``fuse=False``: one per-leaf :func:`mix`
        contraction a mix op, the paper-literal sequential form). Every
        step draws all n devices' batches and gradients; a device whose
        ``mask`` entry is unset (and, for an adaptive op, past its
        ``tau_dev`` cut-off) keeps its params and momentum (``where``).
        An upload block mixes the devices' deltas, privatized (keys
        ``split(k, n)``) then compressed with error feedback (keys
        ``split(fold_in(k, 1), n)``), device by device as the reference's
        vmaps, with ``k = fold_in(block key, 7)``. Trees are replaced, not
        updated in place."""
        runs = prg.block_runs(prg.lowering_plan(program, fuse=False))
        n, N = self.sched.n, self.data["xs"].shape[1]
        xs, ys = self.data["xs"], self.data["ys"]
        comp, dp = self.compression, self.dp
        rows = torch.arange(n, device=self.device)[:, None]

        def bcast(act, leaf):
            return act.reshape((-1,) + (1,) * (leaf.ndim - 1))

        def train_block(params, mom, idx, step, op, act, tau_dev):
            lr = self.lr * op.lr_scale
            for s in range(op.tau):
                stepact = act & (tau_dev > s) if op.adaptive else act
                ix = idx[step]
                grads = self._grad_rows(params, xs[rows, ix], ys[rows, ix])
                mom = tr.tree_map(
                    lambda v, g: torch.where(bcast(stepact, v),
                                             self.momentum * v + g, v),
                    mom, grads)
                params = tr.tree_map(
                    lambda p, v: torch.where(bcast(stepact, p), p - lr * v,
                                             p), params, mom)
                step += 1
            return params, mom, step

        def upload(delta, residual, key, bp):
            if bp.privatize and dp is not None and dp.enabled:
                keys = rnd.split(key, n)
                delta = _stack_trees([
                    prv.privatize_update(_row(delta, i), dp, keys[i])
                    for i in range(n)])
            if bp.compress and comp is not None and comp.kind != "none":
                keys = rnd.split(rnd.fold_in(key, 1), n)
                sent = [cmp.compress_tree(
                    comp, _row(delta, i),
                    None if residual is None else _row(residual, i), keys[i])
                    for i in range(n)]
                delta = _stack_trees([d for d, _ in sent])
                if residual is not None:
                    residual = _stack_trees([r for _, r in sent])
            return delta, residual

        def legacy_round(params, mom, residual, key, args, mask=None):
            idx = rnd.randint(self._step_keys(key, runs), (n, self.batch),
                              0, N)
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            act = torch.from_numpy(
                np.ones(n, bool) if mask is None
                else np.asarray(mask) > 0.5).to(self.device)
            tau_dev = (None if args.tau_dev is None else torch.from_numpy(
                np.asarray(args.tau_dev, np.int64)).to(self.device))
            bkeys = self._block_keys(key, runs)
            mi = step = ki = 0
            for bp, count in runs:
                gm = args.mats[mi:mi + len(bp.groups)]
                mi += len(bp.groups)
                for _ in range(count):
                    params0 = params
                    params, mom, step = train_block(params, mom, idx, step,
                                                    bp.local, act, tau_dev)
                    if bp.upload:
                        delta = tr.tree_map(torch.sub, params, params0)
                        delta, residual = upload(
                            delta, residual, rnd.fold_in(bkeys[ki], 7), bp)
                        params = tr.tree_map(torch.add, params0,
                                             mix(gm[0], delta))
                        gm_rest = gm[1:]
                    else:
                        gm_rest = gm
                    for W in gm_rest:
                        params = mix(W, params)
                    ki += 1
            return params, mom, residual
        return legacy_round

    def _lower_flat(self, program: prg.RoundProgram,
                    block_keyed: bool = False) -> Callable:
        """Lower a RoundProgram to the flat global round
        ``global_round(Y, M, key, args, mask, R) -> Y``: all state stays
        (n, T); each block runs τ local steps of the rows whose ``mask``
        entry is set (None: all), then one streaming pass
        (``gossip_mix_rows``) of each MixGroup's fused operator — for the
        canonical program the final τ-boundary coincides with the
        qτ-boundary and arrives pre-fused as ``W_inter @ W_intra`` (the
        upload path keeps the first mix separate, where the fold is
        invalid: it mixes the uploaded deltas). M and the EF residual R
        are updated in place; the returned Y is the bank's params (the
        same tensor on the card for a plain program, where the square mix
        writes in place). ``block_keyed`` lowers a one-block program that
        takes the passed key as its block key (an async event replays
        one block with the barrier's key of that block)."""
        runs = prg.block_runs(prg.lowering_plan(program, fuse=True))
        if block_keyed and sum(c for _, c in runs) != 1:
            raise ValueError("block_keyed lowers one-block programs")
        n, N = self.sched.n, self.data["xs"].shape[1]
        rows = self.bank.rows
        mix = self._mixer(program, block_keyed)

        def global_round(Y, M, key, args, mask=None, R=None):
            # every step's batch indices in one host draw and one copy;
            # the bank's rows take theirs (all n but on a sharded rank)
            idx = rnd.randint(self._step_keys(key, runs, block_keyed),
                              (n, self.batch), 0, N)[:, rows]
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            act = None if mask is None else (np.asarray(mask) > 0.5)[rows]
            tau_rows = (None if args.tau_dev is None
                        else np.asarray(args.tau_dev)[rows])
            bkeys = (self._block_keys(key, runs, block_keyed)
                     if program.has_upload else None)
            return self._run_blocks(Y, M, self.data["xs"], self.data["ys"],
                                    idx, runs, args, Y.shape[0], mix, act,
                                    tau_rows, bkeys, R)
        return global_round

    def _lower_compact(self, program: prg.RoundProgram) -> Callable:
        """Lower a plain RoundProgram to the compacted scenario round
        ``compact_round(Y, M, key, cp, args) -> Y``: per block the
        ``k_pad`` rows of ``cp.idx`` (cohort first, distinct padding
        rows after) are gathered into a dense slab, its first ``k`` rows
        train (the padding lanes stay frozen, as the reference's ``lane``
        mask keeps them) and the slab is written back with
        ``index_copy_``; the mixing boundaries then stream the FULL bank,
        since masked operators move every device's row. Gathering
        ``k_pad`` rather than ``k`` rows keeps the allocator on the few
        bucket sizes. The cohort sees the batches of the full path: the
        (steps, n, batch) draw is taken at ``idx[:, cp.idx]``."""
        if program.has_upload:
            raise NotImplementedError(
                "compacted rounds are for plain programs only")
        runs = prg.block_runs(prg.lowering_plan(program, fuse=True))
        n, N = self.sched.n, self.data["xs"].shape[1]

        def compact_round(Y, M, key, cp, args):
            k = cp.k
            rows = cp.idx.astype(np.int64)
            idx = rnd.randint(self._step_keys(key, runs), (n, self.batch),
                              0, N)[:, rows[:k]]
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            sel = torch.from_numpy(rows).to(self.device)
            xs, ys = self.data["xs"][sel[:k]], self.data["ys"][sel[:k]]
            tau_rows = (None if args.tau_dev is None
                        else args.tau_dev[rows])
            Mc = M[sel]
            mi = step = 0
            for bp, count in runs:
                gm = args.mats[mi:mi + len(bp.groups)]
                mi += len(bp.groups)
                for _ in range(count):
                    P = Y[sel]
                    step = self._train_block(P, Mc, xs, ys, idx, step,
                                             bp.local, k, None, tau_rows)
                    Y.index_copy_(0, sel, P)
                    del P
                    for W in gm:
                        Y = gossip_mix_rows(W, Y)
            M.index_copy_(0, sel, Mc)
            return Y
        return compact_round

    def _lower_streamed(self, program: prg.RoundProgram,
                        per_client: bool = False) -> Callable:
        """Lower a plain RoundProgram to the streamed working-set round
        ``streamed_round(Y, M, key, didx, cids, k, args) -> Y``: all
        state is the hot (S, T) slab, the operators arrive restricted to
        the working set, ``didx`` maps each lane to its data shard,
        ``cids`` holds its client id, and the first ``k`` lanes are the
        trainers (cold representatives and padding only mix; an adaptive
        program's cut-offs are read per lane at ``tau_dev[didx]``).
        ``per_client`` draws each trainer's batch from the step key
        folded with its client id (virtual populations); otherwise the
        enumerated-n draw is gathered by ``didx`` (the resident round's
        batches)."""
        if program.has_upload:
            raise NotImplementedError(
                "streamed rounds run plain programs (no upload transforms)")
        plans = prg.lowering_plan(program, fuse=True)
        if not plans[-1].groups:
            raise ValueError(
                "streamed rounds need a trailing mixing boundary (page-out "
                "reads cluster-synced rows back as the references)")
        runs = prg.block_runs(plans)
        n, N = self.sched.n, self.data["xs"].shape[1]
        mix = self._mixer(program)

        def streamed_round(Y, M, key, didx, cids, k, args):
            # this process's lanes of the slab (all of them here; a rank's
            # block in the sharded streamed bank) and its trainers
            lanes = self._slab_lanes(len(didx))
            kk = max(0, min(k, lanes.stop) - lanes.start)
            mine = slice(lanes.start, lanes.start + kk)
            skeys = self._step_keys(key, runs)
            if not kk:
                idx = np.zeros((len(skeys), 0, self.batch), np.int64)
            elif per_client:
                # (steps, kk) keys in one vectorized fold_in, then every
                # trainer's batch of every step in one randint
                idx = rnd.randint(rnd.fold_in(skeys[:, None, :],
                                              cids[mine]),
                                  (self.batch,), 0, N)
            else:
                idx = rnd.randint(skeys, (n, self.batch), 0, N)[:, didx[mine]]
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            sel = torch.from_numpy(np.asarray(didx[mine], np.int64)).to(
                self.device)
            tau_rows = (None if args.tau_dev is None
                        else args.tau_dev[np.asarray(didx, np.int64)[lanes]])
            return self._run_blocks(Y, M, self.data["xs"][sel],
                                    self.data["ys"][sel], idx, runs, args, kk,
                                    mix, tau_rows=tau_rows)
        return streamed_round

    def _get_round(self, kind: str, program: prg.RoundProgram) -> Callable:
        """The lowering of ``program`` for one engine kind ("legacy",
        "flat", "flat_block", "compact", "streamed", "streamed_pop"),
        built once per program structure."""
        ck = (kind, program.signature)
        fn = self._lowered.get(ck)
        if fn is None:
            if kind == "legacy":
                fn = self._lower_legacy(program)
            elif kind in ("flat", "flat_block"):
                fn = self._lower_flat(program,
                                      block_keyed=kind == "flat_block")
            elif kind == "compact":
                fn = self._lower_compact(program)
            else:
                fn = self._lower_streamed(program,
                                          per_client=kind == "streamed_pop")
            self._lowered[ck] = fn
        return fn

    @property
    def _round(self) -> Callable:
        """The canonical program's legacy round (tests and debugging)."""
        return self._get_round("legacy", self._canonical)

    def _next_key(self) -> np.ndarray:
        keys = rnd.split(self.key)
        self.key = keys[0]
        return keys[1]

    def _begin_round(self):
        """Draw the round's plan (moving ``labels`` with an enumerated
        scenario) and pick its program: the schedule hook's, or the
        canonical one; ``last_program`` records it for the event
        clock."""
        plan = self.engine.step() if self.engine is not None else None
        if plan is not None and self.pop is None and not self._streamed:
            self.labels = plan.labels
        r = self.round_index
        self.round_index += 1
        program = (self._schedule_fn(r, plan)
                   if self._schedule_fn is not None else self._canonical)
        self.last_program = program
        return plan, r, program

    def step_round(self) -> Optional[RoundPlan]:
        """Advance ONE global round.

        With a scenario attached, first realizes the round's plan
        (mobility re-draws B_t, sampling draws the cohort, faults gate
        clusters and links); the schedule hook (or the canonical
        program) then decides the round's RoundProgram, whose resolved
        operators feed its lowering. A partial cohort of a plain program
        trains on the compacted gather (``last_bucket`` records its
        capacity); a fully dark fault round (empty cohort) runs the flat
        round, whose zero mask freezes training and whose fault-gated
        operators are the identity. Returns the round's plan (a
        ``CohortPlan`` with a population), or None without a
        scenario."""
        if self._streamed:
            if self._pipeline:
                return self._step_round_streamed_pipelined()
            return self._step_round_streamed()
        plan, _, program = self._begin_round()
        mask = None if plan is None else plan.mask
        if self.bank is None:
            args = self._resolve_args(program, plan, fuse=False)
            fn = self._get_round("legacy", program)
            self._params, self._mom, self._residual = fn(
                self._params, self._mom, self._residual, self._next_key(),
                args, mask)
            return plan
        args = self._resolve_args(program, plan)
        key = self._next_key()
        b = self.bank
        k_active = b.n if mask is None else int(np.sum(mask > 0.5))
        if (not program.has_upload and 0 < k_active < b.n
                and self._compact_enabled):
            cp = compact_plan(mask, self._buckets)
            self.last_bucket = cp.k_pad
            fn = self._get_round("compact", program)
            b.params = fn(b.params, b.mom, key, cp, args)
            return plan
        self.last_bucket = b.n
        fn = self._get_round("flat", program)
        b.params = fn(b.params, b.mom, key, args, mask, b.residual)
        return plan

    def step_round_async(self, staleness: int, rt, *,
                         uplink_ratio: float = 1.0) -> Optional[RoundPlan]:
        """Advance ONE global round in async bounded-staleness mode.

        The round's blocks execute as a per-cluster *event sequence*:
        :func:`repro_torch.core.clock.async_program_timeline` schedules
        when each cluster clears each block under the wait rule (own
        previous block done AND every dependency neighbor within
        ``staleness`` blocks), and each event replays that block for its
        advancing clusters only — local steps masked to their devices,
        then the block's fused operator gated by
        :func:`repro_torch.core.gossip.staleness_mask`, one
        ``gossip_mix_rows`` pass, so a boundary never reads a model more
        than ``staleness`` blocks away. At ``staleness == 0`` every event
        advances all clusters in lockstep with the unmodified operator
        and the barrier's block keys: the flat barrier round, bit for
        bit.

        ``rt`` is the :class:`repro_torch.core.runtime.RuntimeModel`
        whose pricing orders the events (the model state depends only on
        the event order). Plain programs on the resident bank only.
        Records ``last_async``: the timeline, the staleness bound, the
        cumulative per-cluster phases and a per-event trace (phases
        before the advance, realized cross-cluster gossip edges)."""
        if self._streamed:
            raise ValueError(
                "async bounded-staleness execution needs resident rows "
                "(blocks replay against the full bank, not a paged slab)")
        if self.bank is None:
            raise ValueError("async bounded-staleness execution needs a "
                             "bank engine (bank=True)")
        plan, _, program = self._begin_round()
        if program.has_upload:
            raise NotImplementedError(
                "async mode supports plain programs only (no upload/EF "
                "state)")
        mask = None if plan is None else plan.mask
        m = self.fl.num_clusters
        fleet = (None if self.engine is None
                 else np.asarray(self.engine.speed_multipliers, float)
                 * rt.hw.device_flops)
        # the per-cluster timeline is carried across rounds, as the event
        # clock carries it; s=0 is a pure barrier and forgets it
        carry = None if staleness == 0 else self._async_carry
        tl = clk.async_program_timeline(
            rt, self.fl, program, fleet, mask, self.labels, staleness,
            uplink_ratio, carry=carry)
        self._async_carry = None if staleness == 0 else tl["carry_out"]
        bprogs = prg.block_programs(program)
        nblocks = len(bprogs)
        base = [(self._resolve_mats(bp, plan),
                 np.asarray(bp.tau_dev, np.int32) if bp.adaptive else None)
                for bp in bprogs]
        cohort = (np.ones(self.sched.n) if mask is None
                  else np.asarray(mask, float))
        # host-side split == the barrier round's split of its key
        bkeys = rnd.split(self._next_key(), nblocks)
        b = self.bank
        self.last_bucket = b.n
        phases = np.zeros(m, dtype=int)
        trace: List[Dict] = []
        for ev in tl["events"]:
            adv = np.zeros(m, dtype=bool)
            adv[list(ev.clusters)] = True
            if not (phases[adv] == ev.block).all():
                raise RuntimeError("async event found its clusters at "
                                   "another phase than its block")
            mats, tau_dev = base[ev.block]
            if len(mats) != 1:
                raise RuntimeError("a fused plain block has one MixGroup")
            Wm = gsp.staleness_mask(mats[0], self.labels, phases,
                                    staleness, adv)
            args = prg.RoundArgs((torch.from_numpy(Wm).to(self.device),),
                                 tau_dev)
            fn = self._get_round("flat_block", bprogs[ev.block])
            b.params = fn(b.params, b.mom, bkeys[ev.block], args,
                          cohort * adv[self.labels])
            cross = (Wm != 0) & (self.labels[:, None]
                                 != self.labels[None, :])
            ii, jj = np.nonzero(cross)
            edges = sorted({(int(a), int(c)) for a, c in
                            zip(self.labels[ii], self.labels[jj])})
            trace.append({"time": ev.time, "block": ev.block,
                          "clusters": ev.clusters,
                          "phases": phases.copy(), "edges": edges})
            phases[adv] += 1
        if not (phases == nblocks).all():
            raise RuntimeError("async round left clusters mid-phase")
        self._async_phases = self._async_phases + phases
        self.last_async = {"timeline": tl, "trace": trace,
                           "staleness": int(staleness),
                           "phases": self._async_phases.copy()}
        return plan

    # -- streamed rounds -----------------------------------------------------
    def _check_streamed_program(self, program: prg.RoundProgram) -> None:
        if program.has_upload:
            raise NotImplementedError(
                "streamed rounds reject upload programs (EF residual and "
                "DP noise are per-device state the store does not page)")
        if not program.mask_renorm:
            raise ValueError("streamed rounds need mask-renormalized "
                             "operators: unrenormalized rows weight absent "
                             "cold members")

    def _slab_args(self, program: prg.RoundProgram, ws: Dict,
                   r: int, plan) -> prg.RoundArgs:
        """The round's operators restricted to the working set (exact:
        every masked operator row reads participant columns only and is
        a function of the row's cluster label), built over the plan's
        surviving backhaul and fault-gated by the plan's dark
        clusters."""
        W_i, W_e = make_masked_w(self.fl, ws["ws_labels"], ws["mask_slab"],
                                 self._scenario_h(plan))
        splan = RoundPlan(r, self.fl.num_clusters, ws["ws_labels"],
                          ws["mask_slab"], W_i, W_e, fault=ws["fault"],
                          H_eff=ws["h_eff"])
        return self._resolve_args(program, splan)

    def _finish_streamed(self, S: int, k: int) -> None:
        self.last_bucket = S
        self._peak_slab = max(self._peak_slab, 2 * 4 * S * self.layout.total)
        # paging = device<->edge traffic: each trainer downloads its row
        # and uploads it back (references live at the edge already)
        self.last_paging = {"rows_in": k, "rows_out": k,
                            "bits_per_row": self.store.bits_per_row}

    # -- the slab's placement, page-in and page-out (the sharded streamed
    # -- bank overrides these) ------------------------------------------------
    def _slab_lanes(self, S: int) -> slice:
        """The lanes of an S-lane slab this process holds: all of them (a
        rank of the sharded streamed bank holds a contiguous block)."""
        return slice(0, S)

    def _page_in_momentum(self, ws: Dict) -> np.ndarray:
        """(k_own, T) f32 momentum of this process's trainer lanes, decoded
        by the host codec (zeros on first touch)."""
        return self.store.fetch(ws["clients"][:ws["k"]])

    def _page_out_momentum(self, ws: Dict, rows: np.ndarray) -> None:
        """Encode and store the trainer lanes' momentum ``rows``."""
        if ws["k"]:
            self.store.commit(ws["clients"][:ws["k"]], rows)

    def _ref_lanes(self, ws: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """(clusters, lanes): each cluster whose reference this round
        updates (one with a lane, not fault-dark) and its synced lane —
        the cluster's last lane (representatives win over participants
        by position)."""
        ref_lane = np.full(self.fl.num_clusters, -1, np.int64)
        ref_lane[ws["ws_labels"]] = np.arange(ws["S"])
        upd = np.nonzero((ref_lane >= 0) & ~self._dark_clusters(ws))[0]
        return upd, ref_lane[upd]

    def _ref_rows(self, ws: Dict, Y):
        """(clusters, rows): the synced rows of this process's lanes
        ``Y`` (a host array or a device tensor) that become the updated
        clusters' references, in cluster order."""
        upd, lanes = self._ref_lanes(ws)
        if isinstance(Y, torch.Tensor):
            return upd, Y[torch.from_numpy(lanes).to(Y.device)]
        return upd, Y[lanes]

    def _step_round_streamed(self) -> Optional[RoundPlan]:
        """One serial streamed global round: page the working set in on
        the host (params from each lane's cluster reference at its last
        sync, momentum decoded by the host codec for the trainers, zeros
        on first touch), run the slab-restricted program, page out (each
        cluster's synced lane becomes its reference, except a fault-dark
        cluster's, whose gated rows never mixed and which keeps a stale
        reference; the trainers' momentum is re-encoded). The pipelined
        driver's oracle."""
        st = self.store
        plan, r, program = self._begin_round()
        self._check_streamed_program(program)
        ws = self._working_set(plan)
        if self.pop is None:
            self.labels = ws["labels_now"]
        k, S, ko = ws["k"], ws["S"], ws["k_own"]
        args = self._slab_args(program, ws, r, plan)
        t0 = time.perf_counter()
        params_rows = st.cluster_params[ws["src_labels"][ws["lanes"]]]
        mom_rows = np.zeros(params_rows.shape, np.float32)
        mom_rows[:ko] = self._page_in_momentum(ws)
        slab = ModelBank.from_rows(self.layout, params_rows, mom_rows,
                                   device=self.device)
        del params_rows, mom_rows
        self._page_seconds += time.perf_counter() - t0
        fn = self._get_round(
            "streamed_pop" if self.pop is not None else "streamed", program)
        Y = fn(slab.params, slab.mom, self._next_key(), ws["didx"],
               ws["clients"], k, args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        Yh = Y.cpu().numpy()
        Mh = slab.mom[:ko].cpu().numpy()
        refs = st.cluster_params.copy()
        upd, rows = self._ref_rows(ws, Yh)
        refs[upd] = np.asarray(rows)
        st.update_clusters(refs)
        self._page_out_momentum(ws, Mh)
        self._page_seconds += time.perf_counter() - t0
        if self.pop is None:
            # the next round's page-in reads the reference of the cluster
            # a device sat in NOW: the trailing boundary synced every row
            self._page_labels = self.labels.copy()
        self._finish_streamed(S, k)
        return plan

    def _dark_clusters(self, ws: Dict) -> np.ndarray:
        """(m,) bool: the working set's fault-dark clusters (their
        references stay stale at page-out)."""
        fault = ws["fault"]
        if fault is None:
            return np.zeros(self.fl.num_clusters, bool)
        return np.asarray(fault.cluster_down, bool)

    def _working_set(self, plan) -> Dict:
        """One streamed round's working set from its plan — shared by the
        serial and pipelined drivers (identical assembly is half of their
        bit-identity). Reads ``_page_labels`` at enumerated n, so the
        pipelined prefetch calls it after the previous round set them."""
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
            labels_now, h_eff = None, None
        else:
            # enumerated n: the plan's cohort (everyone without a
            # scenario) plus the first cold member of each cluster as its
            # representative
            if plan is not None:
                labels_now = np.asarray(plan.labels, np.int64)
                mask = np.asarray(plan.mask)
                h_eff = plan.H_eff
            else:
                labels_now = self.labels
                mask = np.ones(self.sched.n)
                h_eff = None
            cold = mask <= 0
            cohort = np.nonzero(~cold)[0].astype(np.int64)
            reps = np.asarray(
                [np.nonzero(cold & (labels_now == c))[0][0]
                 for c in range(m)
                 if (cold & (labels_now == c)).any()], np.int64)
            clients = np.concatenate([cohort, reps])
            ws_labels = labels_now[clients]
            src_labels = self._page_labels[clients]
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
        # this process's lanes and, among them, its trainers
        lanes = self._slab_lanes(S)
        return {"cohort": cohort, "clients": clients,
                "ws_labels": ws_labels, "src_labels": src_labels,
                "didx": didx, "k": k, "S": S, "lane": lane,
                "lanes": lanes,
                "k_own": max(0, min(k, lanes.stop) - lanes.start),
                "mask_slab": lane.astype(float),
                "labels_now": labels_now, "h_eff": h_eff,
                "fault": getattr(plan, "fault", None)}

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

    def _fetch_encoded(self, ws: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """The *encoded* cold rows (q, scale) of this process's trainer
        lanes, from the host store."""
        return self.store.fetch_encoded(ws["cohort"])

    def _forward_encoded(self, prev: Dict, ws: Dict, q_in: torch.Tensor,
                         s_in: torch.Tensor) -> None:
        """Overwrite the staged rows of the clients the previous round
        sampled too (their commit is still in flight) with that round's
        encoded page-out, on the device."""
        _, si, di = np.intersect1d(prev["cohort"], ws["cohort"],
                                   assume_unique=True, return_indices=True)
        if si.size:
            src = torch.from_numpy(si.astype(np.int64)).to(self.device)
            dst = torch.from_numpy(di.astype(np.int64)).to(self.device)
            q_in[dst] = prev["q"][src]
            s_in[dst] = prev["s"][src]

    def _decode_slab(self, ws: Dict, q_in: torch.Tensor,
                     s_in: torch.Tensor) -> torch.Tensor:
        """The slab's momentum, decoded on the device (zero rows decode to
        exact zeros)."""
        return cold_codec.decode_rows(q_in, s_in, self.store.codec,
                                      self.layout.segments)

    def _encode_slab(self, ws: Dict, M: torch.Tensor):
        """The momentum rows page-out commits, encoded on the device: the
        whole slab (its first k rows are committed)."""
        return cold_codec.encode_rows(M, self.store.codec,
                                      self.layout.segments)

    def _stage_pipelined(self, plan, r: int) -> Dict:
        """Stage round ``r``'s page-in: assemble its working set, gather
        the cohort's *encoded* cold rows (commits up to r-2; the r-1
        delta arrives by device-side forwarding) and start their copy to
        the device — all while round r-1 computes."""
        ws = self._working_set(plan)
        qc, sc = self._fetch_encoded(ws)
        # representative and padding lanes page in zero momentum: zero q
        # and zero scale decode to exact zeros under every codec
        rows = ws["lanes"].stop - ws["lanes"].start
        ws["q"], ev_q = self._upload("in_q", qc, rows)
        ws["s"], ev_s = self._upload("in_s", sc, rows)
        ws["h2d"] = [e for e in (ev_q, ev_s) if e is not None]
        ws["plan"], ws["r"] = plan, r
        return ws

    def _store_snapshot(self) -> Dict[str, np.ndarray]:
        """The cold store's round-complete snapshot (a run checkpoint's
        ``store``; the in-flight page-out lands first)."""
        self._drain_pipeline()
        return self.store.snapshot()

    def _load_store(self, snap: Dict[str, np.ndarray]) -> None:
        """Restore the cold store from a snapshot."""
        self.store.load(snap)

    def _land_refs(self) -> None:
        """Make the host store's cluster references round-complete (what
        evaluation reads)."""
        self._drain_pipeline()

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
        p = self._pipe_state()
        plan, r, program = self._begin_round()
        self._check_streamed_program(program)
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
        if self.pop is None:
            # before the next round's staging reads them (serial order)
            self.labels = ws["labels_now"]
            self._page_labels = ws["labels_now"].copy()
        k, S = ws["k"], ws["S"]
        args = self._slab_args(program, ws, r, plan)
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
        if p["prev"] is not None:
            self._forward_encoded(p["prev"], ws, q_in, s_in)
        Y0 = p["refs"][torch.from_numpy(np.asarray(
            ws["src_labels"][ws["lanes"]], np.int64)).to(self.device)]
        M = self._decode_slab(ws, q_in, s_in)
        fn = self._get_round(
            "streamed_pop" if self.pop is not None else "streamed", program)
        Y = fn(Y0, M, self._next_key(), ws["didx"], ws["clients"], k, args)
        # post, on the device: fold each cluster's synced lane into the
        # references (a fault-dark cluster keeps its stale one), encode
        # the momentum; the copy back starts now and lands at the next
        # drain
        upd, rows = self._ref_rows(ws, Y)
        refs_new = p["refs"].clone()
        if upd.size:
            refs_new[torch.from_numpy(upd).to(self.device)] = rows
        enc = self._encode_slab(ws, M)
        p["refs"] = refs_new
        out = {"refs": refs_new}
        if enc is not None:
            out.update(q=enc[0], s=enc[1])
        pending = dict(self._download(out), cohort=ws["cohort"], k=k, S=S)
        # drain round r-1 (its copy overlapped round r's dispatch) and only
        # then stage r+1, so staging sees commits up to r-1 and the
        # forwarding delta is exactly cohort r
        t0 = time.perf_counter()
        self._drain_pipeline()
        p["pending"] = pending
        p["prev"] = {"cohort": ws["cohort"], "S": S,
                     "q": None if enc is None else enc[0],
                     "s": None if enc is None else enc[1]}
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
            self._land_refs()
            return self.layout.unflatten_stack(torch.tensor(
                self.store.cluster_params, device=self.device))
        B = topo.assignment_matrix(self.labels, self.fl.num_clusters)
        P = topo.masked_cluster_average(B)
        if self.bank is None:
            # mix() row-applies, so the rectangular (m, n) average maps
            # the n device models straight to the m edge models
            return mix(P, self._params)
        return self.bank.project(P)

    def global_model(self):
        """Device-average model x̄ as a single tree."""
        if self._streamed:
            self._land_refs()
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
        if self.bank is None:
            return tr.tree_map(lambda leaf: leaf.mean(0), self._params)
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
