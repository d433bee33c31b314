"""Sets of runs of one cell, and the spreads that its bounds are set from.

    python3 perfbench/measure.py run --workload <cell> --seeds 1 2 3 4 5 6 \
        --sets 2 [--trace-seeds 7 8 9] [--seconds S] --out FILE
    python3 perfbench/measure.py spread FILE [FILE ...]

``run`` runs ``perfbench/run.py`` once a seed, one process after
another, every set over the same seeds, then the traced runs, and
appends one JSON line a run to ``--out``: the cell, the set (0 for a
traced run), the seed, the exit code and the run's last line.

``spread`` reads such lines and prints, for each cell and end-to-end
metric, each set's median and spread (the distance between the first
and third quartiles of ``statistics.quantiles(values, n=4)``, as a share
of the median) and range (lowest to highest run, as a share of the
median), the same over all the sets' runs together, and the bound five
times the widest spread gives (never under 1%, never over 25%), beside
the bound ``BENCHMARK.json`` holds.
"""
import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(args) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    plan = [(s + 1, seed, 0) for s in range(args.sets) for seed in args.seeds]
    plan += [(0, seed, 1) for seed in args.trace_seeds]
    worst = 0
    for set_no, seed, trace in plan:
        cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", str(trace)]
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"workload": args.workload, "set": set_no, "seed": seed,
               "trace": trace, "rc": p.returncode, "result": result,
               "stderr_tail": p.stderr[-1500:]}
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("set", "seed", "trace", "rc")}
                         | {"correct": (result or {}).get("correct"),
                            "metrics": {k: v["value"] for k, v in
                                        (result or {}).get("metrics",
                                                           {}).items()}}),
              flush=True)
        worst = worst or p.returncode
    return worst


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def full_range(values) -> float:
    """The distance between the lowest and the highest run, as a share
    of the median."""
    return (max(values) - min(values)) / statistics.median(values)


def _spread(args) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bounds = {m["name"]: m["bound"] for m in bench["end_to_end"]}
    runs = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for path in args.files:
        for line in open(path):
            rec = json.loads(line)
            if rec["trace"] or not rec["result"] or rec["rc"]:
                continue
            for name, m in rec["result"]["metrics"].items():
                runs[rec["workload"]][name][rec["set"]].append(m["value"])
    for cell, metrics in sorted(runs.items()):
        for name, sets in sorted(metrics.items()):
            parts, widest = [], 0.0
            for s, vals in sorted(sets.items()):
                sp = spread(vals) if len(vals) >= 2 else float("nan")
                widest = max(widest, sp)
                parts.append(f"set {s}: median {statistics.median(vals)!r} "
                             f"spread {sp!r} range {full_range(vals)!r} "
                             f"(n={len(vals)})")
            every = [v for vals in sets.values() for v in vals]
            if len(sets) > 1 and len(every) >= 2:
                parts.append(f"all runs: spread {spread(every)!r} range "
                             f"{full_range(every)!r} (n={len(every)})")
            proposed = min(0.25, max(0.01, 5 * widest))
            print(f"{cell} {name}: " + "; ".join(parts)
                  + f"; 5 x widest {proposed!r}; bound now "
                  f"{bounds.get(name)!r}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("run")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--sets", type=int, default=2)
    r.add_argument("--trace-seeds", type=int, nargs="*", default=())
    r.add_argument("--seconds", type=int)
    r.add_argument("--out", required=True)
    s = sub.add_parser("spread")
    s.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    return _run(args) if args.what == "run" else _spread(args)


if __name__ == "__main__":
    sys.exit(main())
