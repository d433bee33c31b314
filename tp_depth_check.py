#!/usr/bin/env python3
"""mixtral-8x7b cut to 2 of its 32 layers, trained from one seed at one
model rank and at two, on one NVIDIA GPU: whether the held-out loss
moves the same way under tensor parallelism as without it.

  python3 tp_depth_check.py

Runs ``chip_smoke.py``'s phase 7f mixtral row (``LM_TP_RUNS``: 1 x 8192
tokens a step, the launcher's defaults, 2 rounds from the seed-0 init)
at 2 layers, first at dp 1 x mp 1 (one gloo rank), then at dp 1 x mp 2
(two gloo ranks sharing the card), and logs each run's round losses,
round seconds (max over ranks), peak device memory by rank and the
held-out batch's loss before and after. It asserts only that both runs
finish with finite losses; whether the held-out loss falls is what it
reports. The last line is a JSON object of those losses and the card's
name and power limit. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import math
import sys

import torch

import chip_smoke as cs

LAYERS = 2


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_depth_check: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    from repro_torch.launch import mesh as lm
    cs.phase_build()
    card = cs.card_line()
    row = next(r for r in cs.LM_TP_RUNS if r[1] == "mixtral-8x7b")
    out = {}
    for mp in (1, 2):
        run = (f"mixtral-8x7b dp 1 x mp {mp}, {LAYERS} layers",
               row[1], 1, mp, LAYERS) + row[5:]
        res = [r[0] for r in lm.run_local_ranks(
            cs._tp_rank, mp, args=([("train", run)],), backend="gloo",
            device="cuda", timeout_s=900)]
        first = res[0]
        losses = [h["loss"] for h in first["hist"]]
        secs = [max(x["hist"][r]["seconds"] for x in res)
                for r in range(len(losses))]
        peaks = [max(h["peak"] for h in x["hist"]) / 1e9 for x in res]
        cs.log(f"[tp_depth] {run[0]} ({first['params']:,} params a rank): "
               f"round loss {' -> '.join(f'{v:.4f}' for v in losses)}, "
               f"round s {', '.join(f'{s:.3f}' for s in secs)} (max over "
               f"ranks), peak by rank {', '.join(f'{p:.2f}' for p in peaks)}"
               f" GB; held-out {first['before']:.4f} -> "
               f"{first['after']:.4f}; {card}")
        assert all(math.isfinite(v) for v in losses + [first["after"]])
        assert all(x["before"] == first["before"] and
                   x["after"] == first["after"] for x in res)
        out[f"mp{mp}"] = {"round_loss": losses, "before": first["before"],
                          "after": first["after"]}
    cs.log(card)
    print(json.dumps({"layers": LAYERS, "runs": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
