"""The dry-run and roofline tables from the JSON records that
``repro_torch.launch.dryrun`` writes (port of ``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]

``dryrun_table`` is the reference's, cell for cell, so that either
package's report reads either package's records alike. The advice of
``roofline_table`` names what moves each term on an NVIDIA H100.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

ARCH_ORDER = ["whisper-medium", "zamba2-2.7b", "qwen2.5-14b", "mamba2-2.7b",
              "pixtral-12b", "qwen2-0.5b", "minitron-8b", "mixtral-8x7b",
              "mistral-large-123b", "llama4-maverick-400b-a17b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_b(x: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}PB"


def load(dirname: str, mesh: str, suffix: str = "") -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirname, f"*_{mesh}{suffix}.json"))):
        base = os.path.basename(p)[:-5]
        tag = base.split(f"_{mesh}")[1]
        if tag != suffix:
            continue
        with open(p) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (ARCH_ORDER.index(r["arch"]),
                             SHAPE_ORDER.index(r["shape"])))
    return recs


def roofline_table(recs: List[Dict]) -> str:
    out = ["| arch | shape | compute | memory | collective | bottleneck | "
           "useful (6N·D/counted) | what moves the dominant term |",
           "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "terms" not in r:
            continue
        t = r["terms"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"**{t['bottleneck']}** | {r['useful_ratio']:.3f} | "
            f"{advice(r)} |")
    return "\n".join(out)


def advice(r: Dict) -> str:
    t = r["terms"]
    arch = r["arch"]
    heads_bad = arch in ("qwen2.5-14b", "qwen2-0.5b",
                         "llama4-maverick-400b-a17b")
    if t["bottleneck"] == "memory":
        if r["kind"] == "train":
            return ("fuse the eager glue (norms, rope, casts) into the "
                    "kernels' shared-memory tiles; remat trades HBM "
                    "traffic for tensor-core work")
        return "KV-cache layout: shard kv_seq, fuse logits gather"
    if t["bottleneck"] == "collective":
        if r["kind"] == "train":
            return ("sparse ppermute gossip over InfiniBand instead of "
                    "dense all-gathers; keep the model group in one "
                    "NVLink node")
        return "reduce TP all-reduces: fuse qkv/out projections"
    if heads_bad and r["kind"] != "decode":
        return "14/40 heads not divisible by 16: pad heads or context-par."
    return ("tensor-core-aligned tiles (wgmma); overlap NVLink and "
            "InfiniBand collectives with compute")


def dryrun_table(recs: List[Dict]) -> str:
    out = ["| arch | shape | mesh | per-dev peak mem | HLO flops/dev | "
           "coll bytes/dev | compile |",
           "|---|---|---|---|---|---|---|"]
    for r in recs:
        mem = r.get("memory", {}).get("peak_bytes_per_device")
        prod = r.get("production", {})
        flops = r.get("flops_per_device") or prod.get("flops", 0)
        coll = (r.get("collective_bytes_per_device")
                if "collective_bytes_per_device" in r
                else prod.get("coll_bytes", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{_fmt_b(mem) if mem else 'n/a'} | "
            f"{flops:.3g} | "
            f"{_fmt_b(coll)} | "
            f"{prod.get('compile_s', '?')}s |")
    return "\n".join(out)


def meshes_table(single: List[Dict], multi: List[Dict]) -> str:
    """One row a combination with both production meshes' figures in
    each cell (16x16 / 2x16x16): the bottleneck, the three terms,
    ``useful_ratio`` and the peak bytes a device."""
    def pair(a, b, fmt):
        return f"{fmt(a)} / {fmt(b)}"

    def gb(r):
        return f"{r['memory']['peak_bytes_per_device'] / 1e9:.1f}"

    out = ["| arch | shape | bottleneck | compute | memory | collective | "
           "useful | peak GB a device |", "|---|---|---|---|---|---|---|---|"]
    other = {(r["arch"], r["shape"]): r for r in multi}
    for a in single:
        b = other.get((a["arch"], a["shape"]))
        if b is None or "terms" not in a or "terms" not in b:
            continue
        ta, tb = a["terms"], b["terms"]
        out.append(
            f"| {a['arch']} | {a['shape']} | "
            f"{pair(ta, tb, lambda t: t['bottleneck'])} | "
            + " | ".join(pair(ta[k], tb[k], _fmt_s) for k in
                         ("compute_s", "memory_s", "collective_s"))
            + f" | {pair(a, b, lambda r: f'{r['useful_ratio']:.3f}')} | "
            f"{pair(a, b, gb)} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--table", choices=("roofline", "dryrun", "meshes"),
                    default="roofline",
                    help="meshes: both production meshes side by side")
    args = ap.parse_args()
    recs = load(args.dir, args.mesh, args.suffix)
    if args.table == "roofline":
        print(roofline_table(recs))
    elif args.table == "dryrun":
        print(dryrun_table(recs))
    else:
        print(meshes_table(load(args.dir, "16x16", args.suffix),
                           load(args.dir, "2x16x16", args.suffix)))


if __name__ == "__main__":
    main()
