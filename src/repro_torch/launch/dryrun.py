"""Dry-run of a rank's program on a mesh the port has never run on (port
of ``repro.launch.dryrun``): every (arch × input shape × mesh)
combination, priced for the NVIDIA H100.

The reference lowers and compiles each combination on 512 forced host
devices and reads XLA's cost and memory analyses. The port runs eagerly,
so it runs the program itself: in a fake world of ``mesh.size`` ranks
(``launch.mesh.fake_world``: one process, no peer), as one rank, on
``meta`` tensors (shapes and dtypes, no memory), with ``flags.analysis``
on so that the flash-attention and SSD kernels' dispatch takes their
shape-only twins. The code is the port's own: the real
``ShardedCEFedAvg``, ``make_prefill_fn`` and ``make_decode_fn`` with the
rank's slices of the parameters (``core.sharded``'s specs), its
collectives counting their traffic on the rank's mesh.

- **Production**: the whole ``make_global_round()`` (train), prefill or
  decode step runs once (``launch.roofline.count_cost``): the proof that
  the port's code runs at the rank's shapes, and
  ``memory.peak_bytes_per_device`` (the most storage bytes live at
  once) and ``argument_bytes`` (params, optimizer state, the rank's
  batch, the decode cache). Its host seconds are ``production.meta_s``.
- **Analysis**: one local step, ``make_intra_fn`` and ``make_inter_fn``
  are each counted once and combined as one round: q·τ steps, q intra
  boundaries and one inter boundary. A prefill or decode step is its
  one production run. Every layer runs (the port's layer loop is
  Python), so nothing is fitted over depth.
- **Which rank**: rank 0; where the model ranks' shards are uneven
  (padded heads, kv heads that every rank holds, query heads whose kv
  groups straddle ranks) also the last model rank, and the record
  keeps the larger figures.

The terms are ``launch.roofline.roofline_terms`` at NVIDIA H100 SXM
data-sheet rates, each traffic group at its own link: predictions, not
measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--gossip sparse]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import flags
from repro_torch import sharding as sh
from repro_torch.config import INPUT_SHAPES, ExperimentConfig, ShapeConfig
from repro_torch.configs import ARCHS, applicable_shapes, get_experiment
from repro_torch.core import collectives as col
from repro_torch.core.sharded import (ShardedCEFedAvg, abstract_model,
                                      make_decode_fn, make_prefill_fn,
                                      serve_specs)
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model as mdl
from repro_torch.models.layers import padded_heads

_COSTS = ("flops", "bytes", "coll_bytes")


def counted_ranks(cfg, mesh) -> tuple:
    """The ranks whose programs the dry-run runs: rank 0, and the last
    model rank where the model ranks' attention shards differ (padded
    heads; split query heads over kv heads that every rank holds, whose
    groups the ranks' heads may straddle)."""
    mp = dict(mesh.shape).get("model", 1)
    if mp == 1 or not cfg.num_heads:
        return (0,)
    H = padded_heads(cfg)
    uneven = H != cfg.num_heads or (H % mp == 0
                                    and cfg.num_kv_heads % mp != 0)
    return (0, mp - 1) if uneven else (0,)


def _cost(rec: Dict[str, Any], traffic: Dict) -> Dict[str, Any]:
    coll = rf.collective_bytes(traffic)
    return {"flops": rec.get("flops"), "bytes": rec["bytes"],
            "coll_bytes": float(coll["total_bytes"]),
            "twin_flops": rec["twin_flops"], "twin_bytes": rec["twin_bytes"],
            "coll": coll}


def _memory(rec: Dict[str, Any]) -> Dict[str, int]:
    return {"argument_bytes": rec["argument_bytes"],
            "peak_bytes_per_device": rec["peak_bytes"]}


def _rank_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A (q, tau, R, B, ...) batch cut to replica 0 (the counted ranks'
    replica): the bytes a rank's round moves to its device."""
    return {k: torch.empty(v.shape[:2] + (1,) + v.shape[3:], dtype=v.dtype,
                           device="meta") for k, v in batch.items()}


def count_train(exp: ExperimentConfig, mesh, shape: ShapeConfig, *,
                rank: int = 0, production: bool = True,
                analysis: bool = True,
                production_flops: bool = True) -> Dict[str, Any]:
    """One rank's training figures on the abstract ``mesh``: a round of
    ``shape.global_batch`` rows (split over the replicas) of
    ``shape.seq_len`` positions. ``production``: the round run once
    (``memory``, ``traffic`` by group as the mesh counts it, ``meta_s``
    its host seconds); ``analysis``: a local step and the two mixing
    boundaries counted once each (``components``, with the round's
    ``flops``, ``bytes`` and collective bytes by group).
    ``production_flops`` False leaves the production run's FLOPs
    uncounted (a third of its host time)."""
    out: Dict[str, Any] = {}
    with fake_world(mesh, rank) as rmesh:
        trn = ShardedCEFedAvg(exp, rmesh)
        if trn.replica != 0:
            raise ValueError("the dry-run counts ranks of replica 0")
        params = trn.shard(trn.param_shapes)
        opt = trn.opt_init(params)
        batch = _rank_batch(sp.train_batch_shapes(
            exp, shape, trn.geo.num_replicas))
        with flags.analysis():
            if production:
                rmesh.reset_traffic()
                t0 = time.perf_counter()
                with rf.count_cost(params, opt, batch,
                                   flops=production_flops) as rec:
                    trn.make_global_round()(params, opt, batch, 0)
                out["meta_s"] = time.perf_counter() - t0
                out["memory"] = _memory(rec)
                out["production"] = _cost(rec, rmesh.traffic_by_group())
            if analysis:
                mb = {k: v[0, 0, 0] for k, v in batch.items()}
                parts = {}
                for name, fn, args in (
                        ("local_step", trn.make_local_step(),
                         (params, opt, mb, 0)),
                        ("intra_mix", trn.make_intra_fn(), (params,)),
                        ("inter_mix", trn.make_inter_fn(), (params,))):
                    rmesh.reset_traffic()
                    with rf.count_cost(*args) as rec:
                        fn(*args)
                    parts[name] = _cost(rec, rmesh.traffic_by_group())
                out["components"] = parts
    if analysis:
        q, tau = exp.fl.q, exp.fl.tau
        times = {"local_step": q * tau, "intra_mix": q, "inter_mix": 1}
        parts = out["components"]
        for k in _COSTS + ("twin_flops", "twin_bytes"):
            out[k] = sum(n * parts[c][k] for c, n in times.items())
        out["coll_by_group"] = {
            g: sum(n * parts[c]["coll"]["bytes_by_group"].get(g, 0)
                   for c, n in times.items()) for g in ("data", "model")}
    return out


def _serve_batch(batch: Dict[str, torch.Tensor], data: int):
    """A prefill batch cut to a rank: rows over ``data`` where they
    divide it (the reference's ``P("data", ...)``)."""
    B = next(iter(batch.values())).shape[0]
    b = B // data if B % data == 0 else B
    return {k: torch.empty((b,) + v.shape[1:], dtype=v.dtype,
                           device="meta") for k, v in batch.items()}


def count_serve(cfg, mesh, shape: ShapeConfig, *,
                rank: int = 0) -> Dict[str, Any]:
    """One rank's prefill or decode step on the abstract ``mesh``, run
    once: ``memory``, ``meta_s`` and its costs (``flops``, ``bytes``,
    collective bytes by group). The parameters are placed as
    ``resolve_specs`` places them over the whole mesh (no replica axis),
    a prefill's rows over ``data``, and a decode cache as
    ``serve_specs`` places it (its positions over ``data`` where the
    batch does not divide it: ``core.collectives.SequenceSplit``)."""
    B, S = shape.global_batch, shape.seq_len
    with fake_world(mesh, rank) as rmesh:
        tp = col.ModelParallel(rmesh) if rmesh.model > 1 else None
        data = rmesh.data
        if shape.kind == "prefill":
            shapes = abstract_model(cfg)
            params = sh.shard_tree(shapes, sh.resolve_specs(
                shapes, mdl.logical_axes(cfg), mesh), rmesh)
            args = (params, _serve_batch(sp.prefill_batch_shapes(cfg, shape),
                                         data))
            fn = make_prefill_fn(cfg, tp)
        else:
            pshapes, pspecs, cshapes, cspecs = serve_specs(cfg, mesh, B, S)
            params = sh.shard_tree(pshapes, pspecs, rmesh)
            cache = sh.shard_tree(cshapes, cspecs, rmesh)
            split = B % data == 0
            seq = None if split else col.SequenceSplit(rmesh)
            tokens = torch.empty((B // data if split else B, 1),
                                 dtype=torch.int32, device="meta")
            args = (params, cache, tokens, S - 1)
            fn = make_decode_fn(cfg, tp, seq)
        rmesh.reset_traffic()
        t0 = time.perf_counter()
        with flags.analysis(), torch.no_grad(), \
                rf.count_cost(*args) as rec:
            fn(*args)
        secs = time.perf_counter() - t0
        cost = _cost(rec, rmesh.traffic_by_group())
    return {"meta_s": secs, "memory": _memory(rec), "production": cost,
            **{k: cost[k] for k in _COSTS + ("twin_flops", "twin_bytes")},
            "coll_by_group": cost["coll"]["bytes_by_group"]}


def _larger(figs: list) -> Dict[str, Any]:
    """The counted ranks' figures, each the largest over the ranks (the
    production run's costs and traffic are rank 0's)."""
    out = dict(figs[0])
    for f in figs[1:]:
        for k in _COSTS + ("twin_flops", "twin_bytes"):
            if k in f:
                out[k] = max(out[k], f[k])
        if "coll_by_group" in f:
            out["coll_by_group"] = {
                g: max(b, f["coll_by_group"].get(g, 0))
                for g, b in out["coll_by_group"].items()}
        if "memory" in f:
            out["memory"] = {k: max(v, f["memory"][k])
                             for k, v in out["memory"].items()}
    return out


# ---------------------------------------------------------------------------
# per-combination run
# ---------------------------------------------------------------------------

def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                gossip: str = "dense", algorithm: str = "ce_fedavg",
                remat: bool = False, fl_overrides: Dict[str, Any] = None,
                skip_production: bool = False,
                skip_analysis: bool = False,
                model_overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """The reference's record of one combination, from the port's own
    programs on ``meta`` tensors (see the module's docstring)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    exp = get_experiment(arch, multi_pod=multi_pod)
    exp = exp.replace(fl=dataclasses.replace(
        exp.fl, gossip_impl=gossip, algorithm=algorithm,
        **(fl_overrides or {})))
    if remat:
        exp = exp.replace(train=dataclasses.replace(exp.train, remat=True))
    if model_overrides:
        exp = exp.replace(model=dataclasses.replace(exp.model,
                                                    **model_overrides))
    shape = INPUT_SHAPES[shape_name]
    cfg = exp.model
    size = 1
    for n in mesh.sizes:
        size *= n
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "algorithm": algorithm, "gossip": gossip,
        "remat": remat, "num_devices": size,
    }
    if shape.kind == "train":
        tokens = exp.fl.q * exp.fl.tau * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch
    record["tokens_per_call"] = tokens
    ranks = counted_ranks(cfg, mesh)
    record["ranks"] = list(ranks)
    if shape.kind == "train":
        if skip_production and skip_analysis:
            figs = [{}]
        else:
            figs = [count_train(exp, mesh, shape, rank=r,
                                production=not skip_production,
                                analysis=not skip_analysis,
                                production_flops=skip_analysis)
                    for r in ranks]
    else:
        figs = [count_serve(cfg, mesh, shape, rank=r) for r in ranks]
    fig = _larger(figs)
    if not skip_production:
        record["memory"] = fig["memory"]
        prod = fig["production"]
        record["production"] = {
            "meta_s": round(sum(f["meta_s"] for f in figs), 2),
            "bytes": prod["bytes"], "coll_bytes": prod["coll_bytes"]}
        if prod["flops"] is not None:
            record["production"]["flops"] = prod["flops"]
        record["traffic"] = prod["coll"]["by_group"]
    mf, total_n, active_n = rf.model_flops(
        cfg, abstract_model(cfg), "train" if shape.kind == "train"
        else "infer", tokens)
    record.update({"model_flops": mf, "params_total": int(total_n),
                   "params_active": int(active_n)})
    if skip_analysis:
        record["analysis"] = "skipped"
        return record
    if shape.kind == "train":
        comps = fig["components"]
        record["components"] = {
            **{c: {k: comps[c][k] for k in _COSTS} for c in comps},
            "inter_coll_by_kind": comps["inter_mix"]["coll"]["bytes_by_kind"],
            "step_coll_by_kind": comps["local_step"]["coll"]["bytes_by_kind"],
        }
    else:
        record["components"] = {
            "coll_by_kind": fig["production"]["coll"]["bytes_by_kind"]}
    flops, bytes_ = fig["flops"], fig["bytes"]
    coll = fig["coll_by_group"]
    terms = rf.roofline_terms(flops, bytes_, coll,
                              coll_bw=rf.link_rates(mesh))
    record.update({
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "collective_bytes_per_device": float(sum(coll.values())),
        "collective_bytes_by_group": coll,
        "kernel_twins": {"flops": fig["twin_flops"],
                         "bytes": fig["twin_bytes"]},
        "terms": terms,
        "useful_ratio": mf / max(flops * size, 1.0),
    })
    return record


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--gossip", choices=("dense", "sparse", "ringweight"),
                    default="dense")
    ap.add_argument("--algorithm", default="ce_fedavg")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--skip-production", action="store_true")
    ap.add_argument("--skip-analysis", action="store_true")
    ap.add_argument("--attn-seq-shard", action="store_true")
    ap.add_argument("--head-pad", type=int, default=0)
    ap.add_argument("--moe-local", action="store_true")
    ap.add_argument("--swa", type=int, default=0,
                    help="serve with a sliding window (dense-arch long-"
                         "context variant)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for arch in ARCHS:
            for shape in applicable_shapes(arch):
                combos.append((arch, shape))
    elif args.arch and args.shape:
        combos.append((args.arch, args.shape))
    else:
        ap.error("--arch and --shape, or --all")
    overrides = (({"attn_seq_shard": True} if args.attn_seq_shard else {})
                 | ({"head_pad_to": args.head_pad} if args.head_pad else {})
                 | ({"moe_local_dispatch": True} if args.moe_local else {})
                 | ({"sliding_window": args.swa} if args.swa else {}))
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.time()
    for arch, shape in combos:
        name = f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}"
        if args.gossip != "dense":
            name += f"_{args.gossip}"
        if args.algorithm != "ce_fedavg":
            name += f"_{args.algorithm}"
        if args.remat:
            name += "_remat"
        if args.tag:
            name += f"_{args.tag}"
        t0 = time.time()
        try:
            rec = lower_combo(arch, shape, multi_pod=args.multi_pod,
                              gossip=args.gossip, algorithm=args.algorithm,
                              remat=args.remat,
                              skip_production=args.skip_production,
                              skip_analysis=args.skip_analysis,
                              model_overrides=overrides or None)
            rec["wall_s"] = round(time.time() - t0, 1)
            with open(os.path.join(args.out, name + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if "terms" in rec:
                print(rf.summarize(rec), f"[{rec['wall_s']}s]", flush=True)
            else:
                peak = rec.get("memory", {}).get("peak_bytes_per_device",
                                                 "?")
                print(f"{name} ran OK (analysis skipped) mem={peak} "
                      f"[{rec['wall_s']}s]", flush=True)
        except Exception as e:
            failures.append((name, repr(e)))
            print(f"{name} FAILED: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for n, e in failures:
            print(" ", n, e)
        raise SystemExit(1)
    print(f"\nall {len(combos)} combinations ran on meta tensors OK "
          f"({time.time() - t_all:.1f} host s)")


if __name__ == "__main__":
    main()
