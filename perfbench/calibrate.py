"""The readings that a cell's limits are set from, on the card at the
cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--controls tf32] [--faults half_batch no_mix] [--out FILE]

For each seed: the program's first steps (the driver's set-up, as a run
makes them) against the plain reference (the lower readings); with
``--controls``, the reference computed in each precision named (the
configuration's ``control`` among them) put in the program's place;
with ``--faults``, the reference with each fault planted. One JSON line
a seed on standard output (and appended to ``--out``), with the
harness's own verdict (``compare.verdict`` under the cell's limits) on
the program and on each control and fault. The benchmark's
own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=(),
                    help="precisions of the reference put in the program's "
                         "place (the configuration's control, and others)")
    ap.add_argument("--faults", nargs="*", default=())
    ap.add_argument("--out")
    ap.add_argument("--raw", action="store_true",
                    help="keep every reading (by leaf) beside the gaps")
    args = ap.parse_args(argv)

    import torch

    from perfbench import compare, registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    lim = registry.limits(cell["name"])
    steps = lim["steps"]

    def verdict(gaps):
        """The harness's own verdict on these gaps under the cell's
        limits: a run's ``correct``."""
        return compare.verdict([(k, float(gaps.get(k, float("inf"))), v)
                                for k, v in lim["limits"].items()])

    drv = registry.driver(cfg["driver"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        st = drv.setup(cfg, mix, seed, dev, steps)
        prog = st["prog"]
        drv.release(st)
        t1 = time.perf_counter()
        ref = drv.reference(cfg, mix, seed, dev, steps)
        t2 = time.perf_counter()
        line = {"workload": cell["name"], "seed": seed,
                "program_s": t1 - t0, "reference_s": t2 - t1,
                "lower": drv.gaps(prog, ref),
                "correct": verdict(drv.gaps(prog, ref)),
                "loss": {"program": prog["loss"], "reference": ref["loss"]}}
        if args.raw:
            line["raw"] = {"program": prog, "reference": ref}
        for p in args.controls:
            got = drv.reference(cfg, mix, seed, dev, steps, precision=p)
            line.setdefault("controls", {})[p] = g = drv.gaps(got, ref)
            line.setdefault("correct_under", {})[p] = verdict(g)
            if args.raw:
                line["raw"][p] = got
        for f in args.faults:
            got = drv.reference(cfg, mix, seed, dev, steps, fault=f)
            line.setdefault("faults", {})[f] = g = drv.gaps(got, ref)
            line.setdefault("correct_under", {})[f] = verdict(g)
            if args.raw:
                line["raw"][f] = got
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
