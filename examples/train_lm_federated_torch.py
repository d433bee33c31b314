"""End-to-end example of the PyTorch port: federated training of a
~100M-param qwen2-style LM with the port's sharded CE-FedAvg trainer
(``repro_torch.core.sharded.ShardedCEFedAvg``, one replica in a world of
one rank), for a few hundred local steps. Twin of
``examples/train_lm_federated.py``; on the CUDA card unless ``--device``
says otherwise.

  PYTHONPATH=src python examples/train_lm_federated_torch.py [--rounds 25]
  PYTHONPATH=src python examples/train_lm_federated_torch.py --smoke \\
      --device cpu
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.config import (ExperimentConfig, FLConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.configs import get_model_config  # noqa: E402
from repro_torch.core.sharded import ShardedCEFedAvg  # noqa: E402
from repro_torch.data.lm import learnable_lm_batch  # noqa: E402
from repro_torch.launch.mesh import single_rank_world  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=50)  # 200 local steps
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + 2 rounds (the example smoke test)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # ~100M-param config: qwen2-0.5b family at modest width/depth
    cfg = dataclasses.replace(
        get_model_config("qwen2-0.5b"),
        num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=3072, head_dim=64, vocab_size=32000,
        dtype="float32", param_dtype="float32")
    if args.smoke:
        cfg = get_model_config("qwen2-0.5b").reduced()
        args.rounds, args.seq, args.batch = 2, 32, 2
    exp = ExperimentConfig(
        model=cfg,
        fl=FLConfig(num_clusters=1, devices_per_cluster=1, tau=args.tau,
                    q=args.q, pi=2, topology="ring"),
        train=TrainConfig(optimizer="adamw", learning_rate=1e-3))
    losses = []
    with single_rank_world("gloo", args.device) as mesh:
        tr = ShardedCEFedAvg(exp, mesh)
        n_params = sum(t.numel() for t in tree_leaves(tr.param_shapes))
        print(f"model: {n_params / 1e6:.1f}M params (one replica a rank, "
              f"{tr.geo.num_replicas} replica(s)) on {mesh.device}")
        params, opt = tr.init_fn()(0)
        round_fn = tr.make_global_round()
        step = 0
        t0 = time.time()
        for r in range(args.rounds):
            batch = learnable_lm_batch(
                (args.q, args.tau, tr.geo.num_replicas, args.batch,
                 args.seq), cfg.vocab_size, seed=r)
            params, opt, metrics, step = round_fn(params, opt, batch, step)
            losses.append(metrics["loss"])
            if r % 5 == 0 or r == args.rounds - 1:
                print(f"round {r:3d} (local step {step:4d}): "
                      f"loss={metrics['loss']:.4f} [{time.time() - t0:.0f}s]",
                      flush=True)
    print("done — loss should fall well below ln(V) =",
          f"{np.log(cfg.vocab_size):.2f}")
    return losses


if __name__ == "__main__":
    main()
