"""The port's training launcher (``repro.launch.train``'s three
engines).

``--engine pytree`` (the default) runs the federated LM trainer
(``core.sharded.ShardedCEFedAvg``) on ``--arch`` (qwen2-0.5b by
default; ``--reduced`` for the smoke-scale model): ``--data-parallel``
replicas, one a rank, ``--clusters`` clusters (default max(1, dp // 2)),
tau local SGD steps with momentum 0.9, q edge rounds and pi gossip steps
a round on the reference's synthetic federated token stream
(``data.lm.TokenStream``), the loss a round on rank 0; ``--ckpt`` saves
the replicas' average on rank 0. ``--gossip`` picks the mixing backend
(dense, sparse, ringweight). ``--model-parallel M`` splits each replica
over M ranks (tensor parallelism: ``launch.mesh.make_replica_mesh``), so a
world is ``--data-parallel`` x M ranks; ``--ckpt`` then saves the
gathered replica average, the file of M = 1. A world of one runs in
this process.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --rounds 2 --data-parallel 8 --dist-backend gloo \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --data-parallel 2 --model-parallel 2 --dist-backend gloo \
      --device cpu

``--engine bank`` runs the device-parallel flat-bank engine
(``core.sharded.ShardedBankCEFedAvg``): one (1, T) bank row per rank on
the reference's synthetic federated classification task (an MLP 16-32-8
on class Gaussians), logging the edge models' accuracy and loss a
round.

Under torchrun a process joins the world from the environment;
otherwise the launcher spawns ``--data-parallel`` local ranks. The backend
is NCCL with one card a rank by default; ``--dist-backend gloo`` lets
ranks share a card, or run on the CPU with ``--device cpu``:

  torchrun --nproc-per-node 8 -m repro_torch.launch.train --engine bank \
      --data-parallel 8
  PYTHONPATH=src python -m repro_torch.launch.train --engine bank \
      --data-parallel 8 --dist-backend gloo [--device cpu]

``--population N`` streams a virtual population of N clients through the
cold client store (``core/clientstore.py``) on one device: only each
round's cohort (plus one representative lane per cluster) is resident;
``--pipeline`` overlaps the paging with compute, the cold codec on the
card. Its task is the same MLP over 16 enumerated data shards (client id
mod 16):

  PYTHONPATH=src python -m repro_torch.launch.train --population 10000 \
      --cohort 8 --codec int8 --pipeline --rounds 5 --ckpt-dir ckpt

All run on the CUDA card unless ``--device`` says otherwise.
``--ckpt-dir`` writes the bank or population run's state atomically
every ``--ckpt-every`` rounds and ``--resume`` continues from it, bit
for bit the uninterrupted run. The sharded streamed bank
(``--population`` with ``--data-parallel > 1``) waits for ROADMAP A14's
streamed half, ``ShardedStreamedBank``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.checkpoint.runckpt import RunCheckpoint
from repro_torch.config import (ExperimentConfig, FLConfig,
                                PopulationConfig, TrainConfig)
from repro_torch.configs import ARCHS, get_model_config
from repro_torch.core.program import SCHEDULES
from repro_torch.core.scenario import FAULTS, SCENARIOS
from repro_torch.core.topology import TOPOLOGIES
from repro_torch.data.federated import (build_fl_data, dirichlet_partition,
                                        make_synthetic_classification)
from repro_torch.launch import mesh as lm
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("pytree", "bank"), default="pytree",
                    help="pytree: the LM trainer, one replica's parameter "
                         "tree a rank; bank: device-parallel flat (n, T) "
                         "ModelBank rows, one a rank")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b",
                    help="the LM of --engine pytree")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model (CPU-friendly)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="ranks: LM replicas (pytree) or bank rows (bank)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks a replica (tensor parallelism, pytree "
                         "engine); the bank and population engines keep 1")
    ap.add_argument("--clusters", type=int, default=0)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--pi", type=int, default=4)
    ap.add_argument("--gossip", choices=FLConfig.GOSSIP_IMPLS,
                    default="dense",
                    help="the pytree engine's mixing backend; the bank "
                         "engine always lowers its boundaries to means and "
                         "ppermute matchings or weighted rotations")
    ap.add_argument("--topology", default="ring", choices=sorted(TOPOLOGIES))
    ap.add_argument("--er-prob", type=float, default=0.4)
    ap.add_argument("--algorithm", default="ce_fedavg")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128,
                    help="tokens a sequence (pytree engine)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--ckpt", default="",
                    help="save the final global model here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; one a rank "
                         "under NCCL)")
    ap.add_argument("--dist-backend", choices=lm.BACKENDS, default="nccl",
                    help="the ranks' collectives: nccl (one card a rank) or "
                         "gloo (ranks may share a card, or run on the CPU; "
                         "tensors staged through host memory)")
    ap.add_argument("--schedule", choices=SCHEDULES, default="static",
                    help="round schedule (bank engine): static is the "
                         "paper's fixed tau/q/pi; adaptive_tau gives slow "
                         "clusters fewer local steps; pi_decay runs deep "
                         "gossip early, sparse late")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="",
                    help="named wall-clock scenario: device heterogeneity, "
                         "client sampling, mobility (the population's base "
                         "scenario, default 'sampled')")
    ap.add_argument("--faults", choices=sorted(FAULTS), default="",
                    help="named fault preset (bank engine): edge outages, "
                         "backhaul link loss, straggler timeouts")
    ap.add_argument("--async-staleness", type=int, default=-1, metavar="S",
                    help="bounded-staleness async rounds (bank engine); 0 "
                         "is the global barrier, -1 (default) disables "
                         "async execution")
    ap.add_argument("--hierarchy", default="",
                    help="depth>2 tier preset (bank engine): comma-"
                         "separated branching factors root->leaf, e.g. "
                         "'2,2,2'; overrides --clusters/--data-parallel")
    ap.add_argument("--population", type=int, default=0, metavar="N",
                    help="stream a virtual population of N clients through "
                         "the cold client store")
    ap.add_argument("--cohort", type=int, default=8, metavar="K",
                    help="sampled clients per cluster per round with "
                         "--population (before sample_fraction and "
                         "dropout)")
    ap.add_argument("--codec", choices=("f32", "f16", "int8"),
                    default="f32",
                    help="cold-row codec (--population): f32 lossless, "
                         "f16/int8 trade round-trip error for 2x/4x "
                         "smaller cold rows")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap paging with compute (--population): the "
                         "codec runs on the card")
    ap.add_argument("--ckpt-dir", default="",
                    help="crash-consistent run checkpoint directory: the "
                         "full run state written atomically every "
                         "--ckpt-every rounds")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="rounds between run checkpoints (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in --ckpt-dir "
                         "(bit-identical to the uninterrupted run)")
    return ap


def main(argv=None):
    """Parse and run. Returns the population sim; for ``--engine bank`` and
    ``--engine pytree`` what each rank's run function returned (one dict
    under torchrun or for a pytree world of one, a list by rank for
    spawned ranks)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.population:
        if (args.schedule != "static" or args.hierarchy or args.faults
                or args.async_staleness >= 0):
            ap.error("--population supports --scenario/--ckpt-dir/--resume/"
                     "--pipeline only (no schedules, hierarchies, faults or "
                     "async rounds over a virtual population)")
    elif args.pipeline:
        ap.error("--pipeline overlaps the streamed engine's paging; it "
                 "requires --population")
    elif args.engine != "bank" and (args.schedule != "static"
                                    or args.scenario or args.hierarchy
                                    or args.async_staleness >= 0
                                    or args.faults or args.ckpt_dir
                                    or args.resume):
        ap.error("--schedule/--scenario/--hierarchy/--async-staleness/"
                 "--faults/--ckpt-dir/--resume require --engine bank")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    if args.model_parallel < 1:
        ap.error("--model-parallel must be 1 or more")
    if args.population:
        if args.model_parallel != 1:
            raise ValueError("slab rows are not tensor-parallel; use "
                             "--model-parallel 1")
        if args.data_parallel > 1:
            raise NotImplementedError(
                "the sharded streamed bank (--population with "
                "--data-parallel > 1) is not ported yet: ROADMAP A14, "
                "ShardedStreamedBank")
        return run_population_engine(args)
    if args.engine == "bank" and args.model_parallel != 1:
        raise ValueError("bank rows are not tensor-parallel; use "
                         "--model-parallel 1")
    run = run_bank_engine if args.engine == "bank" else run_pytree_engine
    n = (_bank_ranks(args) if args.engine == "bank"
         else args.data_parallel * args.model_parallel)
    if lm.under_torchrun():
        lm.initialize_multihost(backend=args.dist_backend,
                                device=args.device)
        try:
            return run(args)
        finally:
            dist.destroy_process_group()
    # validate the rank device here, before any rank starts
    lm.rank_device(args.dist_backend, args.device)
    if n == 1 and args.engine == "pytree":
        with lm.single_rank_world(args.dist_backend, args.device):
            return run(args)
    return lm.run_local_ranks(run, n, args=(args,),
                              backend=args.dist_backend, device=args.device)


def lm_experiment(args) -> ExperimentConfig:
    """The pytree engine's experiment from the launcher's flags (SGD with
    momentum 0.9 at ``--lr``, as the reference's launcher)."""
    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dp = args.data_parallel
    m = args.clusters or max(1, dp // 2)
    return ExperimentConfig(
        model=cfg,
        fl=FLConfig(algorithm=args.algorithm, num_clusters=m,
                    devices_per_cluster=max(dp // m, 1), tau=args.tau,
                    q=args.q, pi=args.pi, topology=args.topology,
                    er_prob=args.er_prob, gossip_impl=args.gossip),
        train=TrainConfig(optimizer="sgd", learning_rate=args.lr,
                          momentum=0.9))


def lm_round_batch(stream, cfg, q: int, tau: int, batch: int, seq: int
                   ) -> dict:
    """One round's ``(q, tau, R, B, S)`` batch: q·tau distinct microbatches
    of the stream, one a local step, plus zero frames (encdec) or patch
    embeddings (vlm) of the config's dtype, as the reference's launcher
    feeds them."""
    R = stream.R
    nb = stream.next_batch((q * tau, batch, seq))
    out = {k: np.moveaxis(v, 0, 1).reshape(q, tau, R, batch, seq)
           for k, v in nb.items()}
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    if cfg.family == "encdec":
        out["frames"] = torch.zeros(
            (1, 1, 1, batch, cfg.encoder_seq, cfg.d_model), dtype=dt
        ).expand(q, tau, R, -1, -1, -1)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros(
            (1, 1, 1, batch, cfg.num_patches, cfg.d_model), dtype=dt
        ).expand(q, tau, R, -1, -1, -1)
    return out


def run_pytree_engine(args) -> dict:
    """One rank of ``--engine pytree``: ``ShardedCEFedAvg`` on the
    initialised world (``--data-parallel`` replicas of
    ``--model-parallel`` ranks), ``--rounds`` rounds on the synthetic
    federated token stream, the loss a round logged on rank 0. Returns
    this rank's history (round loss and seconds), its collectives'
    traffic (over the data group; ``model_traffic`` over the model
    group) and its peak device memory (None on the CPU)."""
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.data.lm import TokenStream
    from repro_torch.models.model import param_count

    exp = lm_experiment(args)
    cfg = exp.model
    mesh = lm.make_replica_mesh(args.data_parallel,
                                model=args.model_parallel,
                                device=args.device)
    tr = ShardedCEFedAvg(exp, mesh)
    R = tr.geo.num_replicas
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    stream = TokenStream(cfg.vocab_size, R, tr.geo.cluster_of)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    params, opt = tr.init_fn()(0)
    log(f"pytree engine: {args.arch}{' (reduced)' if args.reduced else ''}"
        f", {param_count(params) / 1e6:.1f}M "
        f"params a rank, R={R} replicas of {mesh.model} rank(s) in "
        f"{exp.fl.num_clusters} "
        f"clusters, gossip={args.gossip}, device={mesh.device} "
        f"({mesh.transport})", flush=True)
    round_fn = tr.make_global_round()
    step = 0
    hist = {"round": [], "loss": [], "seconds": []}
    for r in range(args.rounds):
        t0 = time.perf_counter()
        batch = lm_round_batch(stream, cfg, exp.fl.q, exp.fl.tau,
                               args.batch, args.seq)
        params, opt, metrics, step = round_fn(params, opt, batch, step)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        sec = time.perf_counter() - t0
        hist["round"].append(r)
        hist["loss"].append(metrics["loss"])
        hist["seconds"].append(sec)
        log(f"round {r}: loss={metrics['loss']:.4f} ({sec:.1f}s)",
            flush=True)
    if args.ckpt:
        gm = tr.global_model(params)
        if mesh.rank == 0:
            save_checkpoint(args.ckpt, gm, {"arch": args.arch,
                                            "rounds": args.rounds})
            log(f"saved global model to {args.ckpt}")
    return {"rank": mesh.rank, "hist": hist,
            "traffic": {k: dict(v) for k, v in mesh.traffic.items()},
            "model_traffic": {k: dict(v)
                              for k, v in mesh.model_traffic.items()},
            "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if cuda else None)}


def _bank_ranks(args) -> int:
    if args.hierarchy:
        return int(np.prod([int(s) for s in args.hierarchy.split(",")]))
    return args.data_parallel


def _classification_data(n: int):
    x, y = make_synthetic_classification(1600, 16, 8, seed=0, noise=2.5)
    tx, ty = make_synthetic_classification(400, 16, 8, seed=1, noise=2.5)
    parts = dirichlet_partition(y, n, alpha=0.3, seed=0)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def _init_mlp(gen):
    return init_mlp_classifier(gen, 16, 32, 8)


def run_bank_engine(args) -> dict:
    """One rank of ``--engine bank``: ``ShardedBankCEFedAvg`` over the
    initialised world through ``run_wall_clock`` (which checkpoints and
    resumes), logging on rank 0 the edge models' accuracy and loss a
    round with the transport. Returns this rank's history, its final
    params row (host) and its collectives' traffic."""
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.runtime import compute_bound_runtime_model
    from repro_torch.core.scenario import get_faults, get_scenario
    from repro_torch.core.sharded import ShardedBankCEFedAvg

    n = _bank_ranks(args)
    if args.hierarchy:
        tiers = tuple(int(s) for s in args.hierarchy.split(","))
        m = int(np.prod(tiers[:-1]))
        fl = FLConfig(algorithm=args.algorithm, num_clusters=m,
                      devices_per_cluster=tiers[-1], tau=args.tau, q=args.q,
                      pi=args.pi, topology=args.topology,
                      er_prob=args.er_prob, hierarchy=tiers)
    else:
        m = args.clusters or max(1, n // 2)
        if n % m:
            raise ValueError(f"{n} devices not divisible into {m} clusters")
        fl = FLConfig(algorithm=args.algorithm, num_clusters=m,
                      devices_per_cluster=n // m, tau=args.tau, q=args.q,
                      pi=args.pi, topology=args.topology,
                      er_prob=args.er_prob)
    mesh = lm.make_replica_mesh(n, device=args.device)
    scenario = get_scenario(args.scenario) if args.scenario else None
    if args.faults:
        # faults ride on the scenario engine; without a named scenario
        # they attach to the homogeneous baseline
        scenario = dataclasses.replace(
            scenario or get_scenario("homogeneous"),
            faults=get_faults(args.faults))
    schedule = None if args.schedule == "static" else args.schedule
    sim = ShardedBankCEFedAvg(_init_mlp, apply_mlp_classifier, fl,
                              _classification_data(n), mesh, lr=args.lr,
                              batch_size=args.batch, seed=0,
                              scenario=scenario, schedule=schedule)
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    use_async = args.async_staleness >= 0
    log(f"bank engine: n={n} rows x T={sim.layout.total} "
        f"({sim.layout.total * 4} B/row), m={m} clusters, "
        f"mesh={mesh.shape}, transport={mesh.transport}, "
        f"device={mesh.device}, schedule={args.schedule}"
        + (f", scenario={args.scenario}" if args.scenario else "")
        + (f", faults={args.faults}" if args.faults else "")
        + (f", async_staleness={args.async_staleness}" if use_async
           else ""), flush=True)
    if args.resume and RunCheckpoint(args.ckpt_dir).exists():
        log(f"resuming from {RunCheckpoint(args.ckpt_dir).path}")
    # rounds run under the event clock, whose checkpoints carry the
    # async timeline too: a resumed async run replays its events exactly
    t0 = time.perf_counter()
    hist = run_wall_clock(
        sim, compute_bound_runtime_model(), args.rounds, eval_batch=256,
        async_staleness=args.async_staleness if use_async else None,
        ckpt_dir=args.ckpt_dir or None,
        ckpt_every=max(args.ckpt_every, 1) if args.ckpt_dir else 0,
        resume=args.resume)
    seconds = time.perf_counter() - t0
    for i, r in enumerate(hist["round"]):
        log(f"round {r - 1}: acc={hist['acc'][i]:.3f} "
            f"loss={hist['loss'][i]:.4f} simulated "
            f"{hist['wall_time'][i]:.1f}s, host "
            f"{hist['compute_s'][i] + hist['eval_s'][i]:.2f}s "
            f"({mesh.transport})", flush=True)
    if use_async and sim.last_async is not None:
        tl = sim.last_async["timeline"]
        log(f"last round: events={len(tl['events'])} "
            f"makespan={tl['makespan']:.1f}s")
    log(f"{len(hist['round'])} rounds in {seconds:.2f}s on {mesh.device} "
        f"({mesh.transport})")
    if args.ckpt:
        gm = sim.global_model()
        if mesh.rank == 0:
            save_checkpoint(args.ckpt, gm, {"engine": "bank",
                                            "rounds": args.rounds})
            log(f"saved global model to {args.ckpt}")
    return {"rank": mesh.rank, "hist": hist,
            "row": sim.bank.params.detach().cpu().numpy(),
            "traffic": {k: dict(v) for k, v in mesh.traffic.items()}}


def run_population_engine(args):
    """The streamed client-store engine over a virtual population of
    ``--population`` clients on one device."""
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.clientstore import resident_slab_nbytes
    from repro_torch.core.scenario import get_scenario

    m = args.clusters or 4
    # enumerated *data shards* (client_id mod n picks one) — a small
    # constant; the population itself is never enumerated
    n = m * 4
    fl = FLConfig(algorithm=args.algorithm, num_clusters=m,
                  devices_per_cluster=n // m, tau=args.tau, q=args.q,
                  pi=args.pi, topology=args.topology, er_prob=args.er_prob)
    scenario = dataclasses.replace(
        get_scenario(args.scenario or "sampled"),
        population=PopulationConfig(
            clients_per_cluster=max(1, -(-args.population // m)),
            cohort_per_cluster=args.cohort, codec=args.codec))
    sim = FLSimulator(_init_mlp, apply_mlp_classifier, fl,
                      _classification_data(n), lr=args.lr,
                      batch_size=args.batch, seed=0, scenario=scenario,
                      pipeline=args.pipeline, device=args.device)
    eng = sim.engine
    cap = max(sim._buckets)
    print(f"population engine: N={eng.population} virtual clients over "
          f"m={m} clusters (codec={args.codec}, pipeline={args.pipeline}, "
          f"{sim.device}), slab cap {cap} rows x T={sim.layout.total} = "
          f"{resident_slab_nbytes(cap, sim.layout.total)} B resident",
          flush=True)
    rc = RunCheckpoint(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.resume and rc.exists():
        start = rc.restore(sim)["round"]
        print(f"resumed from {rc.path} at round {start}")
    for r in range(start, args.rounds):
        t0 = time.time()
        plan = sim.step_round()
        acc, loss = sim.evaluate(256)
        print(f"round {r}: acc={acc:.3f} loss={loss:.4f} "
              f"cohort={plan.clients.shape[0]} slab={sim.last_bucket} rows "
              f"store={sim.store.nbytes / 1e6:.2f}MB "
              f"({time.time() - t0:.1f}s)", flush=True)
        if rc is not None and (r + 1) % max(args.ckpt_every, 1) == 0:
            rc.save(sim, round_idx=r + 1)
    print(f"peak resident slab: {sim.peak_slab_bytes} B (population "
          f"{eng.population}, cold store {sim.store.nbytes / 1e6:.2f}MB "
          f"host)")
    if args.ckpt:
        save_checkpoint(args.ckpt, sim.global_model(),
                        {"engine": "streamed", "rounds": args.rounds})
        print(f"saved global model to {args.ckpt}")
    return sim


if __name__ == "__main__":
    main()
