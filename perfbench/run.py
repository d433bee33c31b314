"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, limits, driver and metric readers are files
under ``perfbench/`` found by name (``registry.py``). The run:

1. set-up: makes the cell's data and weights from ``--seed``, builds
   the program's object and drives it through the first steps that the
   reference follows (compiling and warming up every shape the window
   uses); ``setup_s`` runs from the start of this process to the end of
   set-up;
2. with ``--trace 1``, a few steps under ``torch.profiler`` (the traced
   window), with the mix's spans recorded around calls into the program;
3. the window: whole steps until ``--seconds`` have passed, each ended
   in a synchronize;
4. the device's peak memory, then the program's state is released and
   the plain reference decides ``correct``;
5. the last line of standard output is one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device`` and, last,
   ``checks``: each number compared with its limit. The same numbers
   are the last lines of standard error.

It exits non-zero and prints no result without a CUDA device, or if
JAX or the JAX package ``repro`` was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(ctx)``
    returns a number, or None where it finds nothing to read)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _profile_steps(drv, st, k: int, spans: dict) -> dict:
    """``k`` steps under the profiler, with ``spans`` timed: the device's
    events, the host's operations, the counters and spans over them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench.spans import CallTimers
    timers = CallTimers(spans)
    c0 = drv.counters(st)
    records = []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(k):
                t = time.perf_counter()
                rec = drv.step(st)
                rec["seconds"] = time.perf_counter() - t
                records.append(rec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        span_s = timers.seconds()
    finally:
        timers.close()
    c1 = drv.counters(st)
    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and t > s:
                dev.append((e.name, s, t))
        elif not e.is_user_annotation:
            host.append((e.name, s, t))
    from perfbench import window as W
    lo = min([s for _, s, _ in host + dev], default=0.0)
    span = (lo, lo + wall)
    return {"kernels": dev, "host": host, "span": span, "window_s": wall,
            "busy_s": W.busy_union((s, e) for _, s, e in dev),
            "steps": records,
            "counters": {k2: c1[k2] - c0.get(k2, 0) for k2 in c1},
            "spans": span_s}


def run(argv=None, *, device=None) -> int:
    """One run; returns the exit code. ``device`` other than the CUDA
    card is for the tests, which drive the harness on the CPU."""
    args = _parse(argv)
    import torch

    from perfbench import compare, registry
    from perfbench import window as W

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("perfbench: no CUDA device: this benchmark measures the "
                  "card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: {cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} here", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    lim = registry.limits(cell["name"])
    drv = registry.driver(cfg["driver"])

    t_setup = time.perf_counter()
    st = drv.setup(cfg, mix, args.seed, device, lim["steps"])
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    parts = {"start_and_imports": t_setup - T_START, **st.get("setup_parts",
                                                               {})}

    trace = None
    if args.trace:
        trace = _profile_steps(drv, st, mix["trace_steps"],
                               mix.get("spans", {}))

    steps = []
    w0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        rec = drv.step(st)
        rec["seconds"] = time.perf_counter() - t
        steps.append(rec)
        if time.perf_counter() - w0 >= args.seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    ctx = Context(cfg=cfg, mix=mix, cell=cell, steps=steps,
                  window_s=window_s, setup_s=setup_s, peak_bytes=peak,
                  trace=trace)
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, section, cell["name"]):
        v = registry.metric(m["name"]).read(ctx)
        if v is None:
            if section == "end_to_end" and on_card:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing in {cell['name']}")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    drv.release(st)
    got = drv.readings(st)
    rows = [(name, float(got.get(name, math.inf)), float(limit))
            for name, limit in lim["limits"].items()]
    correct = compare.verdict(rows)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else device.type),
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(steps),
           "failed": sum(1 for s in steps if not s["ok"]),
           "metrics": metrics, "device": dev_info}
    if trace is not None:
        dev_info["busy_s"] = trace["busy_s"]
        dev_info["window_s"] = trace["window_s"]
        out["breakdown"] = {
            "device_ops": W.device_ops(trace["kernels"]),
            "idle_gaps": W.idle_gaps(trace["kernels"], trace["host"],
                                     trace["span"])}
    out["checks"] = {name: {"value": v, "limit": lim_}
                     for name, v, lim_ in rows}
    print(f"perfbench: {cell['name']} seed {args.seed}: {len(steps)} steps "
          f"in {window_s:.3f} s after {setup_s:.3f} s of set-up ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f"); reference {st.get('reference_s', float('nan')):.3f} s",
          file=sys.stderr)
    for name, v, lim_ in rows:
        print(f"check {name} {v!r} limit {lim_!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


def main() -> int:
    try:
        return run()
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
