"""Quickstart of the PyTorch port: CE-FedAvg (Algorithm 1) on a synthetic
federated task, on the CUDA card.

The twin of ``examples/quickstart.py`` on ``src/repro_torch``: 16
devices, 4 edge servers on a ring backhaul, under the wall-clock event
clock, reporting time-to-accuracy under the paper's §6.1 network model
for CE-FedAvg and the three baselines. Every mixing boundary runs the
port's hand-written gossip-mix kernel.

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core.cefedavg import FLSimulator  # noqa: E402
from repro_torch.core.clock import (run_wall_clock,  # noqa: E402
                                    time_to_accuracy)
from repro_torch.core.runtime import paper_runtime_model  # noqa: E402
from repro_torch.data.federated import (build_fl_data,  # noqa: E402
                                        dirichlet_partition,
                                        make_synthetic_classification)
from repro_torch.models.cnn import (apply_mlp_classifier,  # noqa: E402
                                    init_mlp_classifier)


def main(rounds: int = 8, target: float = 0.9, device=None):
    """``rounds``/``target`` are exposed so a smoke test can run one
    round; ``device`` None means the CUDA card."""
    print("=== CFEL quickstart (PyTorch): 16 devices, 4 edge servers, "
          "ring backhaul")
    results = {}
    rt = paper_runtime_model()
    for algo, m, dpc in [("ce_fedavg", 4, 4), ("hier_favg", 4, 4),
                         ("fedavg", 1, 16), ("local_edge", 4, 4)]:
        fl = FLConfig(algorithm=algo, num_clusters=m,
                      devices_per_cluster=dpc, tau=2, q=4, pi=10,
                      topology="ring")
        x, y = make_synthetic_classification(1600, 16, 8, seed=0)
        tx, ty = make_synthetic_classification(400, 16, 8, seed=1)
        parts = dirichlet_partition(y, fl.n, 0.5, seed=2)
        data = build_fl_data(x, y, parts, tx, ty, 64)
        sim = FLSimulator(lambda g: init_mlp_classifier(g, 16, 32, 8),
                          apply_mlp_classifier, fl, data, lr=0.1,
                          batch_size=16, device=device)
        hist = run_wall_clock(sim, rt, rounds)
        tta = time_to_accuracy(hist, target)
        results[algo] = tta
        print(f"  {algo:13s} final_acc={hist['acc'][-1]:.3f} "
              f"round={hist['wall_time'][0]:7.1f}s "
              f"time_to_{target:.0%}="
              f"{'never' if tta is None else f'{tta:,.0f}s'}")
    ce, fa = results["ce_fedavg"], results["fedavg"]
    if ce and fa:
        print(f"\nCE-FedAvg reaches {target:.0%} in "
              f"{(1 - ce / fa) * 100:.1f}% less time than cloud FedAvg "
              f"(paper reports ~62.5% less on FEMNIST)")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    main(rounds=args.rounds, device=args.device)
