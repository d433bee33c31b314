"""Streamed virtual-population training driver of the port (the
``--population`` path of ``repro.launch.train``).

Streams a virtual population of ``--population`` clients through the
cold client store (``core/clientstore.py``): only each round's cohort
(plus one representative lane per cluster) is resident on the device;
cold state pages through the compressed host store. ``--pipeline``
overlaps that paging with compute, with the cold codec on the card. The
task is the reference's: an MLP 16-32-8 on synthetic class Gaussians,
16 enumerated data shards (client id mod 16). Runs on the CUDA card
unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --population 10000 \\
      --cohort 8 --codec int8 --pipeline --rounds 5

The sharded streamed bank (``--data-parallel > 1``) and run checkpoints
(``--ckpt-dir``) arrive with later slices and raise here.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.config import FLConfig, PopulationConfig
from repro_torch.core.cefedavg import FLSimulator
from repro_torch.core.clientstore import resident_slab_nbytes
from repro_torch.core.scenario import SCENARIOS, get_scenario
from repro_torch.core.topology import TOPOLOGIES
from repro_torch.data.federated import (build_fl_data, dirichlet_partition,
                                        make_synthetic_classification)
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier


def main(argv=None) -> FLSimulator:
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, required=True, metavar="N",
                    help="stream a virtual population of N clients through "
                         "the cold client store")
    ap.add_argument("--cohort", type=int, default=8, metavar="K",
                    help="sampled clients per cluster per round (before "
                         "sample_fraction and dropout)")
    ap.add_argument("--codec", choices=("f32", "f16", "int8"),
                    default="f32",
                    help="cold-row codec: f32 lossless, f16/int8 trade "
                         "round-trip error for 2x/4x smaller cold rows")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap paging with compute: round t's page-out "
                         "drains and round t+1's cohort is staged while "
                         "round t runs; the codec runs on the card")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="",
                    help="base scenario of the population (default "
                         "'sampled')")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clusters", type=int, default=0)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--pi", type=int, default=4)
    ap.add_argument("--topology", default="ring", choices=sorted(TOPOLOGIES))
    ap.add_argument("--er-prob", type=float, default=0.4)
    ap.add_argument("--algorithm", default="ce_fedavg")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="row-shard the slab over R cards (not ported yet)")
    ap.add_argument("--ckpt-dir", default="",
                    help="run checkpoint directory (not ported yet)")
    args = ap.parse_args(argv)
    if args.data_parallel > 1:
        raise NotImplementedError(
            "the sharded streamed bank (--data-parallel > 1) arrives with "
            "slice 4 of the port")
    if args.ckpt_dir:
        raise NotImplementedError(
            "run checkpoints (--ckpt-dir) arrive with slice 3 of the port")

    m = args.clusters or 4
    # enumerated *data shards* (client_id mod n picks one) — a small
    # constant; the population itself is never enumerated
    n = m * 4
    fl = FLConfig(algorithm=args.algorithm, num_clusters=m,
                  devices_per_cluster=n // m, tau=args.tau, q=args.q,
                  pi=args.pi, topology=args.topology, er_prob=args.er_prob)
    x, y = make_synthetic_classification(1600, 16, 8, seed=0, noise=2.5)
    tx, ty = make_synthetic_classification(400, 16, 8, seed=1, noise=2.5)
    parts = dirichlet_partition(y, n, alpha=0.3, seed=0)
    data = build_fl_data(x, y, parts, tx, ty, samples_per_device=64)
    scenario = dataclasses.replace(
        get_scenario(args.scenario or "sampled"),
        population=PopulationConfig(
            clients_per_cluster=max(1, -(-args.population // m)),
            cohort_per_cluster=args.cohort, codec=args.codec))

    def init(gen):
        return init_mlp_classifier(gen, 16, 32, 8)
    sim = FLSimulator(init, apply_mlp_classifier, fl, data, lr=args.lr,
                      batch_size=args.batch, seed=0, scenario=scenario,
                      pipeline=args.pipeline, device=args.device)
    eng = sim.engine
    cap = max(sim._buckets)
    print(f"population engine: N={eng.population} virtual clients over "
          f"m={m} clusters (codec={args.codec}, pipeline={args.pipeline}, "
          f"{sim.device}), slab cap {cap} rows x T={sim.layout.total} = "
          f"{resident_slab_nbytes(cap, sim.layout.total)} B resident",
          flush=True)
    for r in range(args.rounds):
        t0 = time.time()
        plan = sim.step_round()
        acc, loss = sim.evaluate(256)
        print(f"round {r}: acc={acc:.3f} loss={loss:.4f} "
              f"cohort={plan.clients.shape[0]} slab={sim.last_bucket} rows "
              f"store={sim.store.nbytes / 1e6:.2f}MB "
              f"({time.time() - t0:.1f}s)", flush=True)
    print(f"peak resident slab: {sim.peak_slab_bytes} B (population "
          f"{eng.population}, cold store {sim.store.nbytes / 1e6:.2f}MB "
          f"host)")
    return sim


if __name__ == "__main__":
    main()
