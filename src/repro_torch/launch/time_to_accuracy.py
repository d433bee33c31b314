"""Wall-clock time-to-accuracy CLI of the port: algorithms × scenarios
(paper §6).

Couples the port's ``FLSimulator`` to its event clock
(``repro_torch.core.clock``) under named heterogeneity, mobility and
sampling scenarios (``repro_torch.core.scenario.SCENARIOS``) and reports,
for every (scenario, algorithm) pair, the simulated seconds to a target
accuracy under the paper's §6.1 hardware profile. Runs on the CUDA card
unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.time_to_accuracy \\
      --scenarios homogeneous lognormal mobility \\
      --algorithms ce_fedavg hier_favg fedavg --target 0.75 --rounds 20

``--model femnist_cnn`` trains the paper's FEMNIST CNN on synthetic
28×28 images; the default MLP surrogate keeps the same partitioners and
algorithm orderings at laptop cost.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.config import FLConfig
from repro_torch.core.cefedavg import FLSimulator
from repro_torch.core.clock import run_wall_clock, time_to_accuracy
from repro_torch.core.runtime import paper_runtime_model
from repro_torch.core.scenario import SCENARIOS, get_scenario
from repro_torch.data.federated import (build_fl_data, dirichlet_partition,
                                        make_synthetic_classification,
                                        make_synthetic_images)
from repro_torch.models.cnn import (apply_femnist_cnn, apply_mlp_classifier,
                                    init_femnist_cnn, init_mlp_classifier)

MLP_DIM, MLP_CLASSES = 16, 8


def build_sim(fl: FLConfig, model: str, *, noise: float, alpha: float,
              lr: float, seed: int, device=None,
              scenario=None) -> FLSimulator:
    """The federated task of ``model``: the MLP surrogate on class
    Gaussians, or the FEMNIST CNN on synthetic 62-class images."""
    if model == "femnist_cnn":
        x, y = make_synthetic_images(2048, 28, 1, 62, seed=seed)
        tx, ty = make_synthetic_images(512, 28, 1, 62, seed=seed + 1)
        init, apply = init_femnist_cnn, apply_femnist_cnn
    else:
        x, y = make_synthetic_classification(1600, MLP_DIM, MLP_CLASSES,
                                             seed=seed, noise=noise)
        tx, ty = make_synthetic_classification(400, MLP_DIM, MLP_CLASSES,
                                               seed=seed + 1, noise=noise)

        def init(gen):
            return init_mlp_classifier(gen, MLP_DIM, 32, MLP_CLASSES)
        apply = apply_mlp_classifier
    parts = dirichlet_partition(y, fl.n, alpha, seed)
    data = build_fl_data(x, y, parts, tx, ty, 64)
    return FLSimulator(init, apply, fl, data, lr=lr, batch_size=16,
                       seed=seed, scenario=scenario, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithms", nargs="+",
                    default=["ce_fedavg", "hier_favg", "fedavg"])
    ap.add_argument("--scenarios", nargs="+", choices=sorted(SCENARIOS),
                    default=["homogeneous", "lognormal", "mobility"])
    ap.add_argument("--model", choices=("mlp", "femnist_cnn"),
                    default="mlp")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--target", type=float, default=0.75)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--dpc", type=int, default=4)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--pi", type=int, default=10)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--noise", type=float, default=3.0)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rt = paper_runtime_model()                  # paper §6.1 constants
    print(f"{'scenario':14s} {'algorithm':13s} {'final_acc':>9s} "
          f"{'rounds@T':>8s} {'wall@T':>12s}")
    results = {}
    for sname in args.scenarios:
        sc = dataclasses.replace(get_scenario(sname), seed=args.seed)
        for algo in args.algorithms:
            fl = FLConfig(algorithm=algo, num_clusters=args.clusters,
                          devices_per_cluster=args.dpc, tau=args.tau,
                          q=args.q, pi=args.pi, topology=args.topology)
            sim = build_sim(fl, args.model, noise=args.noise,
                            alpha=args.alpha, lr=args.lr, seed=args.seed,
                            device=args.device, scenario=sc)
            hist = run_wall_clock(sim, rt, args.rounds)
            tta = time_to_accuracy(hist, args.target)
            rounds_at = next((r for r, a in zip(hist["round"], hist["acc"])
                              if a >= args.target), None)
            results[(sname, algo)] = tta
            print(f"{sname:14s} {algo:13s} {hist['acc'][-1]:9.3f} "
                  f"{'-' if rounds_at is None else rounds_at:>8} "
                  f"{'never' if tta is None else f'{tta:,.0f}s':>12}")
    for sname in args.scenarios:
        ce = results.get((sname, "ce_fedavg"))
        others = {a: results.get((sname, a)) for a in args.algorithms
                  if a != "ce_fedavg"}
        if ce is not None and others and all(v is not None
                                             for v in others.values()):
            beat = ", ".join(f"{(1 - ce / v) * 100:.0f}% vs {a}"
                             for a, v in others.items())
            print(f"[{sname}] CE-FedAvg reaches {args.target:.0%} faster: "
                  f"{beat}")
    return results


if __name__ == "__main__":
    main()
