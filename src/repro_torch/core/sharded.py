"""CE-FedAvg over ``torch.distributed``, one process a replica (port of
``repro.core.sharded``): the device-parallel flat-bank engine and the
LM trainer with stacked replica pytrees.

:class:`ShardedBankCEFedAvg` (the bank half): one bank row per rank for
the whole run. Each rank runs the same host program (plans, schedules,
the key stream are replicated, as the reference's single controller
computes them once) on its own ``(1, T)`` rows of params, momentum and
EF residual; the mixing boundaries are collectives over the flat replica
axis (``core/collectives.py``, ``core/gossip.py``), so the full ``(n,
T)`` bank never sits on one device — init, rounds, evaluation and
checkpoint restore included. No kernel runs on this path, as in the
reference: the boundaries are collectives, not the gossip-mix kernel.

:class:`ShardedCEFedAvg` (the pytree half): the federated LM trainer.
The reference stacks R replicas of the model on a leading axis sharded
over the mesh's ``data`` (× ``pod``) axis and places every parameter by
its resolved spec, the ``model`` axis tensor-parallel within a replica.
Here a replica is the model group of ``mesh.model`` ranks: each rank
holds its slice of its replica's parameter tree and optimizer state, as
the resolved specs say (``_build_specs``, ``repro_torch.sharding``),
the split layers reduce over the model group (``models``, with
``core.collectives.ModelParallel``), and the round's boundaries are
collectives over the rank's data group (mixing is elementwise, so each
shard mixes with the same shard of the other replicas). JAX's remaining
sharding glue (``_opt_specs``, ``microbatch_specs``, ``batch_specs``,
``in_shardings``, ``out_shardings``) has no counterpart: a round takes
the reference's ``(q, tau, R, B, ...)`` batch and the rank slices its
own replica ``r`` from axis 2.

:class:`ShardedStreamedBank` (the streamed half): the streamed
client-store engine with each round's ``(S, T)`` hot slab split over the
ranks in contiguous blocks of S/R lanes, and the cold store partitioned
``client_id % R``, one shard a rank. Its slab is the single-process
engine's lane for lane (the same working set, buckets divisible by R);
each mixing boundary is one launch of the gossip-mix kernel on the
rank's rectangular operator block (an ``(S, T)`` partial) and one
``reduce_scatter``, and page-in, page-out and the reference broadcast
move encoded rows between ranks with ``exchange_rows``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch import tree as tr
from repro_torch.config import ExperimentConfig, FLConfig
from repro_torch.core import collectives as col
from repro_torch.core import gossip as gsp
from repro_torch.core import program as prg
from repro_torch.core import topology as topo
from repro_torch.core.cefedavg import FLSimulator, make_w_schedule
from repro_torch.core.clientstore import merge_snapshots, split_snapshot
from repro_torch.core.compress import (cold_dtype, decode_cold_rows,
                                       encode_cold_rows)
from repro_torch.core.groups import get_registry
from repro_torch.core.modelbank import ModelBank
from repro_torch.kernels import cold_codec
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.launch.mesh import ReplicaMesh
from repro_torch.models import model as mdl
from repro_torch.optim import apply_updates, make_lr_schedule, make_optimizer


@dataclasses.dataclass(frozen=True)
class ReplicaGeometry:
    num_replicas: int          # R
    num_clusters: int          # M (global)
    devices_per_cluster: int
    clusters_per_pod: int
    num_pods: int

    @staticmethod
    def build(fl: FLConfig, mesh: ReplicaMesh) -> "ReplicaGeometry":
        data, pods = mesh.data, mesh.pods
        R = data * pods
        M = fl.num_clusters
        if R % M:
            raise ValueError(f"{R} replicas not divisible into {M} clusters")
        dpc = R // M
        if data % dpc:
            raise ValueError("clusters must not span pods")
        return ReplicaGeometry(R, M, dpc, data // dpc, pods)

    def cluster_of(self, r: int) -> int:
        return r // self.devices_per_cluster


# ---------------------------------------------------------------------------
# abstract init (no allocation: meta tensors)
# ---------------------------------------------------------------------------

def abstract_model(model_cfg):
    """One replica's parameter tree as ``meta`` tensors (shapes and
    dtypes, no memory); the logical axes are ``models.model.
    logical_axes``."""
    return mdl.init_model(torch.Generator(), model_cfg, "meta")


def stacked_abstract(model_cfg, R: int):
    """:func:`abstract_model` with a leading replica axis of size R."""
    return tr.tree_map(
        lambda t: torch.empty((R,) + tuple(t.shape), dtype=t.dtype,
                              device="meta"), abstract_model(model_cfg))


def stacked_logical(model_cfg):
    """The logical axes of :func:`stacked_abstract`'s tree: each leaf's
    with ``"replica"`` in front."""
    return sh.prepend_axis(mdl.logical_axes(model_cfg), "replica")


def replica_seed(seed: int, r: int) -> int:
    """The seed of replica r's generator, mixed from (seed, r)."""
    return int(np.random.SeedSequence([seed, r]).generate_state(
        1, np.uint64)[0])


# ---------------------------------------------------------------------------
# the LM trainer
# ---------------------------------------------------------------------------

class ShardedCEFedAvg:
    """The federated LM trainer of one rank: its replica's step functions
    and the round's mixing boundaries over the mesh.

    One ``global_round`` = q edge rounds of (τ local SGD steps + intra-
    cluster averaging) followed by the inter-cluster mixing — eq. (10)/
    (11), as the reference. The aggregation backends:

    - ``dense`` (the paper's operators): ``mix`` over the replica axis.
      Each leaf is all-gathered in its own dtype and contracted with this
      rank's row of W in f32, then cast back: O(R·|leaf|) bytes a rank,
      as the reference's all-gathers.
    - ``sparse``: the group registry's grouped mean for V and π rounds of
      neighbour ``ppermute`` matchings for H (``core/groups.py``).
    - ``ringweight``: the exact H^π in M−1 weighted cyclic rotations.
    ``fedavg`` has no intra-cluster boundary.

    On a mesh with a model axis (``launch.mesh.make_replica_mesh``) a
    replica spans ``mesh.model`` ranks: ``init_fn`` cuts each rank's
    slice from the replica's whole tree, the loss runs with ``self.tp``
    (``core.collectives.ModelParallel``), the boundaries above run over
    the rank's data group on its slices, and :meth:`global_model`
    gathers the slices back into the whole tree.

    Every rank must build the trainer, and call each boundary, in the
    same order (the collectives of ``core/collectives.py``)."""

    def __init__(self, exp: ExperimentConfig, mesh: ReplicaMesh,
                 loss_fn: Optional[Callable] = None):
        self.exp = exp
        self.mesh = mesh
        self.device = mesh.device
        self.geo = ReplicaGeometry.build(exp.fl, mesh)
        self.replica = mesh.replica
        self.fl = dataclasses.replace(
            exp.fl, devices_per_cluster=self.geo.devices_per_cluster)
        self.sched = make_w_schedule(self.fl)
        self.model_cfg = exp.model
        # the rank's model group; None without a model axis (the model
        # functions' unsplit path)
        self.tp = col.ModelParallel(mesh) if mesh.model > 1 else None
        self.loss_fn = loss_fn or (
            lambda p, b: mdl.lm_loss(self.model_cfg, p, b,
                                     remat=exp.train.remat, tp=self.tp))
        self.opt_init, self.opt_update = make_optimizer(exp.train)
        self.lr_fn = make_lr_schedule(exp.train)
        impl = exp.fl.gossip_impl
        # communicator groups: built once per (fl, mesh) and queried for
        # every tiered collective (means, gossip schedules)
        self.registry = get_registry(self.fl, mesh)
        self.gossip_schedule: Optional[gsp.GossipSchedule] = None
        if impl in ("sparse", "ringweight") and \
                self.fl.algorithm in ("ce_fedavg", "dec_local_sgd"):
            self.gossip_schedule = self.registry.gossip_schedule(
                1, self.fl.pi,
                mode="exact" if impl == "ringweight" else "rounds")
        self._build_specs()

    # -- specs ---------------------------------------------------------------
    def _build_specs(self):
        """The replica-stacked specs of the reference's trainer
        (``param_specs``, over the mesh's replica and model axes) and one
        replica's, without the replica axis (``replica_specs``: what a
        rank cuts its slice by)."""
        R = self.geo.num_replicas
        self.param_shapes = abstract_model(self.model_cfg)
        self.param_specs = sh.resolve_specs(
            stacked_abstract(self.model_cfg, R),
            stacked_logical(self.model_cfg), self.mesh)
        self.replica_specs = tr.tree_unflatten(
            tr.tree_flatten(self.param_shapes)[1],
            [spec[1:] for spec in sh.spec_leaves(self.param_specs)])

    def shard(self, params):
        """This rank's slice of a whole replica tree (``replica_specs``)."""
        return sh.shard_tree(params, self.replica_specs, self.mesh)

    def gather(self, params):
        """The whole replica tree from its model ranks' slices, on every
        rank of the model group."""
        return col.gather_tree(params, self.replica_specs, self.mesh)

    # -- init ----------------------------------------------------------------
    def init_fn(self) -> Callable:
        """``init(seed) -> (params, opt)``: this rank's slice of its
        replica, drawn whole on its device from a generator seeded from
        (seed, replica) — so every rank of a model group draws the same
        tree, the mp 1 tree of that seed — then cut to the rank's slice,
        and its optimizer state."""
        def init(seed: int = 0):
            gen = torch.Generator(self.device).manual_seed(
                replica_seed(seed, self.replica))
            params = mdl.init_model(gen, self.model_cfg, self.device)
            if self.tp is not None:
                params = self.shard(params)
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()  # the whole tree's blocks
            return params, self.opt_init(params)
        return init

    # -- mixing --------------------------------------------------------------
    def _mix(self, W, params):
        """x_r <- sum_j W[r, j] x_j over the replica axis (the rank's data
        group), summed in f32 and cast back (the reference's ``mix``)."""
        w = np.asarray(W, np.float32)[self.replica]

        def leaf(x):
            acc = None
            for j, part in enumerate(col.all_gather(x, self.mesh)):
                term = part.to(torch.float32) * float(w[j])
                acc = term if acc is None else acc.add_(term)
            return acc.to(x.dtype)
        return tr.tree_map(leaf, params)

    @torch.no_grad()
    def _intra(self, params):
        if self.fl.algorithm == "fedavg":
            return params  # cloud FedAvg: no intra-cluster boundary
        if self.exp.fl.gossip_impl in ("sparse", "ringweight"):
            return self.registry.mean(params, 0)
        return self._mix(self.sched.W_intra, params)

    @torch.no_grad()
    def _inter(self, params):
        if self.gossip_schedule is not None:
            params = self.registry.mean(params, 0)
            impl = self.exp.fl.gossip_impl
            return self.registry.gossip(
                params, 1, self.fl.pi,
                mode="exact" if impl == "ringweight" else "rounds")
        return self._mix(self.sched.W_inter, params)

    # -- the steps -----------------------------------------------------------
    def _on_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's replica of a ``(q, tau, R, B, ...)`` batch, on its
        device."""
        r = self.replica
        return {k: (v[:, :, r] if isinstance(v, torch.Tensor) else
                    torch.from_numpy(np.ascontiguousarray(v[:, :, r]))
                    ).to(self.device) for k, v in batch.items()}

    def make_local_step(self) -> Callable:
        """``fn(params, opt, mb, step) -> (params, opt, loss, step + 1)``:
        one local SGD step of this rank's replica on its microbatch
        ``mb`` (``(B, ...)`` leaves); no mixing. Params and optimizer
        state are updated in place; ``loss`` is a 0-dim tensor on the
        device."""
        loss_fn = self.loss_fn

        def local_step(params, opt, mb, step):
            leaves, treedef = tr.tree_flatten(params)
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = loss_fn(tr.tree_unflatten(treedef, live), mb)
            grads = torch.autograd.grad(loss, live)
            del live
            with torch.no_grad():
                upd, opt = self.opt_update(
                    tr.tree_unflatten(treedef, list(grads)), opt, params,
                    self.lr_fn(step))
                del grads
                params = apply_updates(params, upd)
            return params, opt, loss.detach(), step + 1
        return local_step

    def make_intra_fn(self) -> Callable:
        return lambda params: self._intra(params)

    def make_inter_fn(self) -> Callable:
        return lambda params: self._inter(params)

    def make_global_round(self) -> Callable:
        """``fn(params, opt, batch, step) -> (params, opt, metrics,
        step)``. ``batch``: dict of arrays with leading ``(q, tau, R,
        ...)`` dims (this rank takes replica r). ``metrics["loss"]`` is
        the mean over replicas and local steps (one ``all_reduce``), a
        float on every rank (NaN on ``meta`` tensors)."""
        fl = self.fl
        local_step = self.make_local_step()

        def global_round(params, opt, batch, step):
            mine = self._on_device(batch)
            losses = []
            for qi in range(fl.q):
                for ti in range(fl.tau):
                    mb = {k: v[qi, ti] for k, v in mine.items()}
                    params, opt, loss, step = local_step(params, opt, mb,
                                                         step)
                    losses.append(loss)
                params = self._intra(params)
            params = self._inter(params)
            mean = torch.stack(losses).to(torch.float32).mean()
            total = col.all_reduce(mean.reshape(1), self.mesh)
            # a round on meta tensors (the dry-run's) has no values
            loss = (math.nan if total.is_meta
                    else float(total[0]) / self.geo.num_replicas)
            return params, opt, {"loss": loss}, step
        return global_round

    def global_model(self, params):
        """The replicas' average in f32 (the gossip consensus model the
        reference checkpoints), whole, on every rank: one ``all_reduce`` a
        leaf over the data group, then the model ranks' slices
        gathered."""
        R = self.geo.num_replicas
        with torch.no_grad():
            avg = tr.tree_map(
                lambda x: col.all_reduce(x.to(torch.float32), self.mesh) / R,
                params)
            return self.gather(avg) if self.tp is not None else avg


# ---------------------------------------------------------------------------
# serving (non-FL: global/edge model)
# ---------------------------------------------------------------------------

def make_prefill_fn(model_cfg, tp=None):
    """``prefill(params, batch) -> logits``; under ``tp`` (a rank's
    ``ModelParallel``) on the rank's slices of the params."""
    def prefill(params, batch):
        logits, _ = mdl.forward(model_cfg, params, batch, tp=tp)
        return logits
    return prefill


def make_decode_fn(model_cfg, tp=None, sp=None):
    """``decode(params, cache, tokens, pos) -> (logits, cache)``; under
    ``tp`` on the rank's slices of the params and its part of the cache
    (:func:`serve_specs`), ``sp`` splitting the cache's positions over
    the data axis (``models.model.decode_step``)."""
    def decode(params, cache, tokens, pos):
        return mdl.decode_step(model_cfg, params, cache, tokens, pos, tp=tp,
                               sp=sp)
    return decode


def serve_specs(model_cfg, mesh, batch: int, seq: int):
    """(param shapes, param specs, cache shapes, cache specs) of one model
    served on ``mesh`` (an abstract one: ``launch.mesh.make_mesh``); the
    decode cache's batch goes over ``data`` where it divides, else its
    kv sequence does. Shapes are ``meta`` tensors."""
    shapes = abstract_model(model_cfg)
    pspecs = sh.resolve_specs(shapes, mdl.logical_axes(model_cfg), mesh)
    cache_shapes = mdl.init_decode_cache(model_cfg, batch, seq,
                                         device="meta")
    rules = dict(sh.DEFAULT_RULES)
    if batch % mesh.shape["data"] != 0:
        rules["batch"] = None
        rules["kv_seq"] = "data"
    cspecs = sh.resolve_specs(cache_shapes,
                              mdl.decode_cache_logical(model_cfg), mesh,
                              rules)
    return shapes, pspecs, cache_shapes, cspecs


class ShardedBankCEFedAvg(FLSimulator):
    """The :class:`FLSimulator` ModelBank engine with the ``(n, T)`` bank
    row-sharded over the ranks of a :class:`ReplicaMesh` — one bank row
    (one paper device model) per rank, for the whole run.

    - **static schedule** (no scenario, ``ce_fedavg``): every
      ``TierMix(ℓ, π)`` is the registry tier's grouped mean (one
      ``all_reduce`` over the tier group) plus, for ℓ >= 1, π rounds of
      that tier's edge-colored ``ppermute`` matchings; means dedupe
      through the ``usize`` tracker, so the fused τ∘qτ boundary stays one
      mean + one gossip pass at any depth — O(π·deg·T) neighbor bytes.
    - **scenario rounds** (masked, mobile, faulted), the non-gossip
      baselines and async events: the exact dense operators, row-applied
      by R−1 weighted rotations (:func:`repro_torch.core.gossip.
      dense_mix_rows`).

    Key schedule, batch draws (each rank draws the single-process ``(n,
    batch)`` indices and takes its row), SGD+momentum, adaptive
    ``tau_dev`` cut-offs and the upload branch (DP, then compression
    with the rank's key of ``split(key, n)`` and its EF residual row)
    are the single-process engine's, row for row. Cohort compaction is
    off (rows are pinned to ranks): a partial cohort trains mask-frozen.
    Evaluation never gathers the bank: each rank adds its row times its
    column of the projection and one ``all_reduce`` sums the (m, T) edge
    models. A run checkpoint gathers the rows to rank 0's host, which
    writes the single-process engine's file; a restore gives each rank
    its own rows (:meth:`ModelBank.load_rows`)."""

    def __init__(self, init_fn: Callable, apply_fn: Callable, fl: FLConfig,
                 data: Dict[str, object], mesh: ReplicaMesh, **kw):
        if kw.get("streaming") or kw.get("pipeline") or (
                kw.get("scenario") is not None
                and kw["scenario"].population is not None):
            raise ValueError(
                "ShardedBankCEFedAvg holds enumerated rows, one a rank; "
                "stream a virtual population with ShardedStreamedBank")
        device = kw.pop("device", None)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        R = col.flat_axis_size(mesh)
        if fl.n != R:
            raise ValueError(f"need one bank row per replica device: "
                             f"n={fl.n}, devices={R}")
        self.mesh = mesh
        self.geo = ReplicaGeometry.build(fl, mesh)
        self.registry = get_registry(fl, mesh)
        super().__init__(init_fn, apply_fn, fl, data, device=mesh.device,
                         **kw)
        rows = self.bank.rows
        for k in ("xs", "ys"):
            self.data[k] = self.data[k][rows].clone()
        # rows are pinned to ranks: no cohort compaction; scenario rounds
        # run mask-frozen on the full (sharded) bank instead
        self._compact_enabled = False

    def _make_bank(self, one, n: int, with_residual: bool) -> ModelBank:
        return ModelBank.from_model_sharded(one, n, self.mesh,
                                            with_residual=with_residual)

    def _host_rows(self, buf: torch.Tensor) -> Optional[np.ndarray]:
        """The (n, T) rows gathered into rank 0's host memory (None on
        the other ranks)."""
        return col.gather_rows(buf, self.mesh)

    # -- the sharded round ---------------------------------------------------
    def _lower_compact(self, program):
        """Never dispatched: rows are pinned to ranks, so compaction (a
        cross-rank cohort gather) is disabled in ``__init__``."""
        raise AssertionError("ShardedBankCEFedAvg disables cohort "
                             "compaction")

    def _mixer(self, program: prg.RoundProgram,
               block_keyed: bool = False) -> Callable:
        """A block's MixGroups as collectives on this rank's rows (the
        parent's lowered rounds take the rank's rows of each draw, mask
        and ``tau_dev``):

        - on the static ``ce_fedavg`` path each ``TierMix(ℓ, π)`` is the
          registry's grouped mean plus, for ℓ >= 1 with siblings, π
          rounds of its cached gossip matchings; ``usize`` tracks the
          tier group size at which rows are already uniform (1 = not),
          so consecutive tier means dedupe into one (V idempotent,
          W_inter's leading B^T…B, and any coarser tier implying the
          finer ones); gossip at tier ℓ keeps rows node-uniform at ℓ and
          resets ``usize`` to its size;
        - otherwise (scenario, fault and baseline operators, and the
          staleness-masked operators of a ``block_keyed`` async event,
          arbitrary row-stochastic matrices the structured collectives
          cannot express) each group's dense operator by weighted
          rotations."""
        mesh, registry = self.mesh, self.registry
        if not (self.engine is None and self.fl.algorithm == "ce_fedavg"
                and not block_keyed):
            def dense(bp, mats, Y, lo=0, hi=None):
                for W in mats[lo:hi]:
                    Y = gsp.dense_mix_rows(W, Y, mesh)
                return Y
            return dense
        gsize = tuple(registry.tier(lvl).group_size
                      for lvl in range(registry.depth))

        def structured(bp, mats, Y, lo=0, hi=None):
            usize = 1
            for g in bp.groups[lo:hi]:
                for op in g.ops:
                    s = gsize[op.level]
                    if usize < s:
                        Y = registry.mean_in_body(Y, op.level)
                        usize = s
                    if (op.level >= 1
                            and registry.hier.num_siblings(op.level) > 1):
                        Y = gsp.gossip_in_body(
                            registry.gossip_schedule(op.level, op.pi),
                            mesh, Y)
                        usize = s
            return Y
        return structured

    # -- evaluation: never gathers the bank ----------------------------------
    def edge_models(self):
        """The m edge models y_t: each rank adds its rows times its
        columns of the (m, n) projection; one ``all_reduce`` sums them."""
        B = topo.assignment_matrix(self.labels, self.fl.num_clusters)
        P = torch.from_numpy(np.asarray(
            topo.masked_cluster_average(B), np.float32)[:, self.bank.rows])
        E = P.to(self.device) @ self.bank.params
        return self.layout.unflatten_stack(col.all_reduce(E, self.mesh))

    def global_model(self):
        """Device-average model x̄ (one ``all_reduce`` of the rows'
        sum)."""
        total = col.all_reduce(self.bank.params.sum(0), self.mesh)
        return self.layout.unflatten_one(total / self.sched.n)


# ---------------------------------------------------------------------------
# the sharded streamed bank: each round's hot slab split over the ranks
# ---------------------------------------------------------------------------

_TORCH_DTYPE = {np.dtype(np.int8): torch.int8,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.float32): torch.float32}


class ShardedStreamedBank(FLSimulator):
    """The streamed client-store engine with each round's hot slab split
    over the ranks of a :class:`ReplicaMesh`: rank r holds the lanes
    ``[r·S/R, (r+1)·S/R)`` of the round's ``(S, T)`` slab, and the cold
    store shard of the clients with ``client_id % R == r``.

    The slab is the single-process engine's (``store_shards=R,
    min_bucket=R``): the same working set in the same lane order, every
    bucket divisible by R. Every rank runs the same host program (plans,
    working sets, operators and keys are replicated), so each knows who
    holds every row and every exchange is one collective:

    - **page-in**: each cohort client's *encoded* row leaves its owner's
      shard for its lane's rank (:func:`repro_torch.core.collectives.
      exchange_rows`), which decodes it: the host codec in the serial
      driver, the card codec (B2) in the pipelined one, where the rows of
      clients the previous round sampled too are forwarded from that
      round's encoded page-out, across ranks where the lane moved;
    - **mixing**: at each boundary a rank launches the gossip-mix kernel
      (B1) on its column block of the operator, ``W[:, lanes] ·
      Y_lanes``, an ``(S, T)`` partial, and a ``reduce_scatter`` returns
      its rows of the sum — exact for every operator the slab round
      receives, masked and fault-gated ones included;
    - **page-out**: a lane's rank encodes its trainers' momentum and the
      encoded rows go back to their owners, and the rank holding each
      updated cluster's last lane sends that reference to every rank
      (one ``exchange_rows``), so every rank keeps the ``(m, T)``
      references and evaluation reads them with no collective.

    ``last_bucket``, ``last_paging`` and ``peak_slab_bytes`` report the
    whole slab, as the reference; ``peak_rank_slab_bytes`` a rank's.
    Only the order of the boundary sums (and the trainers' vmap) differs
    from the single-process engine; a world of one is that engine, bit
    for bit. Run checkpoints gather the ranks' shards into the
    single-process file on rank 0; a restore keeps each rank's shard.
    Needs a population scenario and a model axis of 1."""

    def __init__(self, init_fn: Callable, apply_fn: Callable, fl: FLConfig,
                 data: Dict[str, object], mesh: ReplicaMesh, **kw):
        if not kw.pop("bank", True):
            raise ValueError("ShardedStreamedBank is a bank engine")
        scenario = kw.get("scenario")
        if scenario is None or scenario.population is None:
            raise ValueError("ShardedStreamedBank streams a virtual "
                             "population (ScenarioConfig.population)")
        if mesh.model != 1:
            raise ValueError("slab rows are not tensor-parallel (the model "
                             "axis must be 1)")
        device = kw.pop("device", None)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.R = col.flat_axis_size(mesh)
        super().__init__(init_fn, apply_fn, fl, data, device=mesh.device,
                         store_shards=self.R, min_bucket=self.R, **kw)
        self._peak_rank_slab = 0
        T = self.layout.total
        self._q_dtype = _TORCH_DTYPE[cold_dtype(self.store.codec)]
        self._q_bytes = T * torch.empty(0, dtype=self._q_dtype).element_size()
        self._row_bytes = self._q_bytes + 4 * self.store._sw

    @property
    def peak_rank_slab_bytes(self) -> int:
        """Largest block of the hot slab (params + momentum) one rank
        held."""
        return self._peak_rank_slab

    # -- placement -----------------------------------------------------------
    def _slab_lanes(self, S: int) -> slice:
        r = S // self.R
        return slice(self.mesh.replica * r, (self.mesh.replica + 1) * r)

    def _lane_rank(self, lanes, S: int) -> np.ndarray:
        return np.asarray(lanes, np.int64) // (S // self.R)

    def _owner(self, clients) -> np.ndarray:
        return np.asarray(clients, np.int64) % self.R

    def _finish_streamed(self, S: int, k: int) -> None:
        super()._finish_streamed(S, k)
        self._peak_rank_slab = max(self._peak_rank_slab,
                                   2 * 4 * (S // self.R) * self.layout.total)

    # -- moving rows between ranks -------------------------------------------
    def _route(self, src, dst, rows: Callable):
        """Move items ``i`` from rank ``src[i]`` to rank ``dst[i]`` (host
        arrays, the same on every rank). ``rows(ix)`` gives this rank's
        outgoing rows of the items ``ix`` (a tensor, one row an item, in
        that order). Returns the items that arrive here and their rows,
        in item order, on the outgoing rows' device: one
        ``exchange_rows``, or none when no item changes rank."""
        me = self.mesh.replica
        src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
        out_ix = np.nonzero(src == me)[0]
        out_ix = out_ix[np.argsort(dst[out_ix], kind="stable")]
        in_ix = np.nonzero(dst == me)[0]
        in_ix = in_ix[np.argsort(src[in_ix], kind="stable")]
        x = rows(out_ix)
        if (src != dst).any():
            x = col.exchange_rows(x, np.bincount(dst[out_ix],
                                                 minlength=self.R),
                                  np.bincount(src[in_ix], minlength=self.R),
                                  self.mesh)
        order = np.argsort(in_ix, kind="stable")
        return in_ix[order], x[torch.from_numpy(order).to(x.device)]

    def _pack(self, q, scale) -> torch.Tensor:
        """Encoded rows (codes, scales) as one byte row each; None gives
        no rows."""
        if q is None or not len(q):
            return torch.empty((0, self._row_bytes), dtype=torch.uint8,
                               device="cpu" if q is None else
                               torch.as_tensor(q).device)
        q = torch.as_tensor(q).contiguous().view(torch.uint8)
        if not self.store._sw:
            return q   # f32 and f16 codes carry no scales
        return torch.cat([q, torch.as_tensor(scale).to(q.device)
                          .contiguous().view(torch.uint8)], 1)

    def _unpack(self, buf: torch.Tensor):
        """(codes, scales) of :meth:`_pack`'s byte rows."""
        if not buf.shape[0]:
            return (torch.empty((0, self.layout.total), dtype=self._q_dtype,
                                device=buf.device),
                    torch.empty((0, self.store._sw), device=buf.device))
        # fresh copies: a view of one row keeps its byte offset, which the
        # wider dtypes' views need aligned
        fresh = torch.contiguous_format
        q = buf[:, :self._q_bytes].clone(memory_format=fresh).view(
            self._q_dtype)
        if not self.store._sw:
            return q, torch.zeros((buf.shape[0], 0), device=buf.device)
        return q, buf[:, self._q_bytes:].clone(memory_format=fresh).view(
            torch.float32)

    def _fetch_lanes(self, ws: Dict):
        """The encoded rows of this rank's trainer lanes, in lane order,
        from their owners' shards (one exchange)."""
        k = ws["k"]
        clients = ws["clients"][:k]
        _, buf = self._route(
            self._owner(clients), self._lane_rank(np.arange(k), ws["S"]),
            lambda ix: self._pack(*self.store.fetch_encoded(clients[ix])))
        return self._unpack(buf)

    def _commit_lanes(self, S: int, clients: np.ndarray, q, scale) -> None:
        """Page-out: the encoded rows ``q``/``scale`` of this rank's
        trainer lanes (lanes 0..k-1 of an S-lane slab hold ``clients``)
        go to their owners, which store them (one exchange)."""
        k = clients.shape[0]
        lo = self._slab_lanes(S).start
        ix, buf = self._route(
            self._lane_rank(np.arange(k), S), self._owner(clients),
            lambda ix: self._pack(None if q is None else q[ix - lo],
                                  None if q is None else scale[ix - lo]))
        if ix.size:
            qq, ss = self._unpack(buf.cpu())
            self.store.commit_encoded(clients[ix], qq.numpy(), ss.numpy())

    # -- the serial driver's page-in and page-out ----------------------------
    def _page_in_momentum(self, ws: Dict) -> np.ndarray:
        q, s = self._fetch_lanes(ws)
        return decode_cold_rows({"q": q.numpy(), "scale": s.numpy()},
                                self.store.codec, self.layout.segments)

    def _page_out_momentum(self, ws: Dict, rows: np.ndarray) -> None:
        if not ws["k"]:
            return
        enc = encode_cold_rows(rows, self.store.codec, self.layout.segments)
        self._commit_lanes(ws["S"], ws["clients"][:ws["k"]], enc["q"],
                           enc["scale"])

    def _ref_rows(self, ws: Dict, Y):
        """Every updated cluster's synced row, on every rank: its holder
        sends it to the R - 1 others (one exchange)."""
        upd, lanes = self._ref_lanes(ws)
        R, lo = self.R, ws["lanes"].start
        Yt = Y if isinstance(Y, torch.Tensor) else torch.from_numpy(Y)
        holder = self._lane_rank(lanes, ws["S"])
        _, rows = self._route(
            np.repeat(holder, R), np.tile(np.arange(R), len(upd)),
            lambda ix: Yt[torch.from_numpy(lanes[ix // R] - lo).to(
                Yt.device)])
        return upd, (rows if isinstance(Y, torch.Tensor) else rows.numpy())

    # -- the pipelined driver's ----------------------------------------------
    def _fetch_encoded(self, ws: Dict):
        q, s = self._fetch_lanes(ws)
        return q.numpy(), s.numpy()

    def _forward_encoded(self, prev: Dict, ws: Dict, q_in: torch.Tensor,
                         s_in: torch.Tensor) -> None:
        """The previous round's encoded rows of the clients sampled again
        go from their old lane's rank to their new one's."""
        _, si, di = np.intersect1d(prev["cohort"], ws["cohort"],
                                   assume_unique=True, return_indices=True)
        if not si.size:
            return
        lo = self._slab_lanes(prev["S"]).start
        q, s = prev["q"], prev["s"]

        def rows(ix):
            if q is None:
                return self._pack(None, None)
            sel = torch.from_numpy(si[ix] - lo).to(q.device)
            return self._pack(q[sel], s[sel])
        ix, buf = self._route(self._lane_rank(si, prev["S"]),
                              self._lane_rank(di, ws["S"]), rows)
        if ix.size:
            qq, ss = self._unpack(buf)
            dst = torch.from_numpy(di[ix] - ws["lanes"].start).to(
                self.device)
            q_in[dst] = qq.to(self.device)
            s_in[dst] = ss.to(self.device)

    def _decode_slab(self, ws: Dict, q_in: torch.Tensor,
                     s_in: torch.Tensor) -> torch.Tensor:
        if ws["k_own"]:
            return super()._decode_slab(ws, q_in, s_in)
        # no trainer here: the lanes' momentum is zero
        return torch.zeros(q_in.shape, dtype=torch.float32,
                           device=self.device)

    def _encode_slab(self, ws: Dict, M: torch.Tensor):
        ko = ws["k_own"]
        if not ko:
            return None
        return cold_codec.encode_rows(M[:ko], self.store.codec,
                                      self.layout.segments)

    def _land_refs(self) -> None:
        """Mirror the in-flight round's references into the host store
        (no collective: every rank holds them); its momentum commits at
        the next drain."""
        p = self._pipe
        if not p or p["pending"] is None or p["pending"].get("landed"):
            return
        pend = p["pending"]
        if pend["event"] is not None:
            pend["event"].synchronize()
        self.store.update_clusters(pend["refs"].numpy())
        pend["landed"] = True

    def _drain_pipeline(self) -> None:
        p = self._pipe
        if not p or p["pending"] is None:
            return
        self._land_refs()
        pend, p["pending"] = p["pending"], None
        if pend["k"]:
            self._commit_lanes(pend["S"], pend["cohort"], pend.get("q"),
                               pend.get("s"))

    # -- mixing: B1 on the rank's operator block, then a reduce-scatter ------
    def _mixer(self, program: prg.RoundProgram,
               block_keyed: bool = False) -> Callable:
        mesh = self.mesh

        def mix(bp, mats, Y, lo=0, hi=None):
            for W in mats[lo:hi]:
                lanes = self._slab_lanes(W.shape[0])
                Y = col.reduce_scatter(gossip_mix_rows(W[:, lanes], Y), mesh)
            return Y
        return mix

    # -- checkpoints: the ranks' shards in the single-process file -----------
    def _store_snapshot(self) -> Dict[str, np.ndarray]:
        """The merged snapshot of every rank's shard on rank 0 (the
        single-process engine's ``store``); this rank's own elsewhere."""
        self._drain_pipeline()
        mine = self.store.snapshot()
        counts = np.asarray([int(c.item()) for c in col.all_gather(
            torch.tensor([mine["ids"].size], device=self.device),
            self.mesh)], np.int64)
        off = int(counts[:self.mesh.replica].sum())

        def rows(ix):
            packed = torch.cat([torch.from_numpy(mine["ids"]).view(-1, 1)
                                .view(torch.uint8),
                                self._pack(mine["mom_q"],
                                           mine["mom_scale"])], 1)
            return packed[torch.from_numpy(ix - off)]
        _, buf = self._route(np.repeat(np.arange(self.R), counts),
                             np.zeros(int(counts.sum()), np.int64), rows)
        if self.mesh.rank != 0:
            return mine
        ids = buf[:, :8].clone(memory_format=torch.contiguous_format).view(
            torch.int64)[:, 0].numpy()
        q, s = self._unpack(buf[:, 8:])
        return merge_snapshots([{"cluster": mine["cluster"], "ids": ids,
                                 "mom_q": q.numpy(),
                                 "mom_scale": s.numpy()}])

    def _load_store(self, snap: Dict[str, np.ndarray]) -> None:
        self.store.load(split_snapshot(snap, self.R, self.mesh.replica))
