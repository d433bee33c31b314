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

The sharded streamed bank (``ShardedStreamedBank``) waits for ROADMAP
A14's streamed half.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.core.groups import get_registry
from repro_torch.core.modelbank import ModelBank
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
        float on every rank."""
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
            return params, opt, {"loss": float(total[0]) /
                                 self.geo.num_replicas}, step
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

def make_prefill_fn(model_cfg):
    def prefill(params, batch):
        logits, _ = mdl.forward(model_cfg, params, batch)
        return logits
    return prefill


def make_decode_fn(model_cfg):
    def decode(params, cache, tokens, pos):
        return mdl.decode_step(model_cfg, params, cache, tokens, pos)
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
            raise NotImplementedError(
                "ShardedBankCEFedAvg holds enumerated rows; the sharded "
                "streamed bank is ROADMAP A14's ShardedStreamedBank")
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
