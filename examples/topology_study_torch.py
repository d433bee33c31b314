"""Ablation driver of the PyTorch port: how backhaul topology and gossip
steps interact (paper Fig. 6 + Theorem 1's Ω terms), on the port's
simulation engine — plus what each topology costs the sharded engine's
gossip lowerings (bytes a round by lowering, from the same
``GossipSchedule`` the sharded bank engine runs).

The twin of ``examples/topology_study.py`` on ``src/repro_torch``: the
same table, the accuracy column from the port's engine on the card.

  PYTHONPATH=src python examples/topology_study_torch.py            # card
  PYTHONPATH=src python examples/topology_study_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core.cefedavg import (FLSimulator,  # noqa: E402
                                       make_w_schedule)
from repro_torch.core.gossip import GossipSchedule  # noqa: E402
from repro_torch.core.runtime import gossip_traffic_per_round  # noqa: E402
from repro_torch.core.topology import omega1, omega2  # noqa: E402
from repro_torch.data.federated import (build_fl_data,  # noqa: E402
                                        dirichlet_partition,
                                        make_synthetic_classification)
from repro_torch.models.cnn import (apply_mlp_classifier,  # noqa: E402
                                    init_mlp_classifier)

MODEL_BITS = 6_603_710 * 32.0      # the paper's FEMNIST CNN, fp32
STUDY = (("ring", 1), ("ring", 10), ("erdos_renyi", 1), ("complete", 1))


def main(rounds: int = 6, device=None):
    """One row a (topology, π) of ``STUDY``; returns the rows as dicts.
    ``device`` None means the CUDA card."""
    acc_col = f"acc@{rounds}"
    print(f"{'topology':12s} {'pi':>3s} {'zeta':>6s} {'Omega1':>8s} "
          f"{'Omega2':>8s} {acc_col:>6s} {'sparse_MB':>9s} "
          f"{'exact_MB':>8s} {'dense_MB':>8s}")
    rows = []
    for topo, pi in STUDY:
        fl = FLConfig(num_clusters=8, devices_per_cluster=2, tau=2, q=2,
                      pi=pi, topology=topo, er_prob=0.4)
        sched = make_w_schedule(fl)
        x, y = make_synthetic_classification(1600, 16, 8, seed=0)
        tx, ty = make_synthetic_classification(400, 16, 8, seed=1)
        parts = dirichlet_partition(y, fl.n, 0.5, seed=2)
        data = build_fl_data(x, y, parts, tx, ty, 64)
        sim = FLSimulator(lambda g: init_mlp_classifier(g, 16, 32, 8),
                          apply_mlp_classifier, fl, data, lr=0.1,
                          batch_size=16, device=device)
        hist = sim.run(rounds)
        z = sched.zeta
        # what this backhaul costs each gossip lowering per round
        mb = {}
        for impl in ("sparse", "ringweight", "dense"):
            tr = gossip_traffic_per_round(
                impl, num_clusters=fl.num_clusters,
                devices_per_cluster=fl.devices_per_cluster, pi=pi,
                degrees=sched.degrees, model_bits=MODEL_BITS)
            mb[impl] = tr["total_bits"] / 8e6
        gs = GossipSchedule.build(sched.H, pi, fl.devices_per_cluster)
        assert gs.models_received_total(fl.n) * MODEL_BITS / 8e6 == \
            mb["sparse"]
        row = {"topology": topo, "pi": pi, "zeta": z,
               "omega1": omega1(z, pi), "omega2": omega2(z, pi),
               "acc": hist["acc"][-1], "sparse_MB": mb["sparse"],
               "exact_MB": mb["ringweight"], "dense_MB": mb["dense"]}
        rows.append(row)
        print(f"{topo:12s} {pi:3d} {z:6.3f} {row['omega1']:8.3f} "
              f"{row['omega2']:8.3f} {row['acc']:6.3f} "
              f"{mb['sparse']:9.0f} {mb['ringweight']:8.0f} "
              f"{mb['dense']:8.0f}")
    print("\nsmaller zeta / larger pi => smaller Omega terms => tighter "
          "Theorem-1 bound (and empirically faster convergence); the MB "
          "columns are per-global-round backhaul traffic of each gossip "
          "lowering on that topology.")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    main(rounds=args.rounds, device=args.device)
