"""Ablation of the PyTorch port: uplink compression and local DP ×
CE-FedAvg (paper §2 composability), on the CUDA card.

The twin of ``examples/compressed_federated.py`` on ``src/repro_torch``:
CE-FedAvg with exact, int8 and top-k (5%) uplinks and with local DP,
reporting final accuracy and the eq. (8) round time with the compressed
payload — the compression/convergence trade the paper cites [8], [24],
[25]. Every mixing boundary runs the port's gossip-mix kernel; the
stochastic rounding and DP noise are drawn on the card.

  PYTHONPATH=src python examples/compressed_federated_torch.py
  PYTHONPATH=src python examples/compressed_federated_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core.cefedavg import FLSimulator  # noqa: E402
from repro_torch.core.compress import (CompressionConfig,  # noqa: E402
                                       compression_ratio)
from repro_torch.core.privacy import DPConfig, gaussian_epsilon  # noqa: E402
from repro_torch.core.runtime import (HardwareProfile,  # noqa: E402
                                      RuntimeModel, WorkloadProfile)
from repro_torch.data.federated import (build_fl_data,  # noqa: E402
                                        dirichlet_partition,
                                        make_synthetic_classification)
from repro_torch.models.cnn import (apply_mlp_classifier,  # noqa: E402
                                    init_mlp_classifier)


def run(compression=None, dp=None, rounds=8, device=None):
    fl = FLConfig(num_clusters=4, devices_per_cluster=4, tau=2, q=4, pi=10,
                  topology="ring")
    x, y = make_synthetic_classification(1600, 16, 8, seed=0)
    tx, ty = make_synthetic_classification(400, 16, 8, seed=1)
    parts = dirichlet_partition(y, fl.n, 0.5, 2)
    data = build_fl_data(x, y, parts, tx, ty, 64)
    sim = FLSimulator(lambda g: init_mlp_classifier(g, 16, 32, 8),
                      apply_mlp_classifier, fl, data, lr=0.1,
                      batch_size=16, compression=compression, dp=dp,
                      device=device)
    hist = sim.run(rounds)
    rt = RuntimeModel(HardwareProfile(),
                      WorkloadProfile(6_603_710, 13.3e6 * 50 * 3))
    ratio = compression_ratio(compression) if compression else 1.0
    t = rt.round_time("ce_fedavg", fl.tau, fl.q, fl.pi, uplink_ratio=ratio)
    return hist["acc"][-1], t


def main(rounds: int = 8, device=None):
    """``rounds`` is exposed so a smoke test can run one round;
    ``device`` None means the CUDA card."""
    print(f"{'variant':24s} {'final_acc':>9s} {'round_s':>9s} {'notes'}")
    acc, t = run(rounds=rounds, device=device)
    print(f"{'exact (f32 uplink)':24s} {acc:9.3f} {t:9.1f}")
    acc, t = run(CompressionConfig('int8'), rounds=rounds, device=device)
    print(f"{'int8 uplink (4x)':24s} {acc:9.3f} {t:9.1f}")
    acc, t = run(CompressionConfig('topk', topk_frac=0.05), rounds=rounds,
                 device=device)
    print(f"{'topk 5% + err-feedback':24s} {acc:9.3f} {t:9.1f}")
    dp = DPConfig(clip_norm=1.0, noise_multiplier=0.5)
    acc, t = run(dp=dp, rounds=rounds, device=device)
    print(f"{'local DP (sigma=0.5)':24s} {acc:9.3f} {t:9.1f} "
          f"eps~{gaussian_epsilon(0.5):.1f} per release")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    main(rounds=args.rounds, device=args.device)
