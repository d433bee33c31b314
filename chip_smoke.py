#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. build      — compile every CUDA kernel source from
                 ``src/repro_torch/kernels/csrc`` for sm_90a and print
                 the card's name and power limit.
2. kernels    — hold each kernel against its plain PyTorch version on
                 the card, then time kernel, plain version and (where
                 one exists) one library call:
                 ``gossip_mix`` at the reference sweep shapes (in place
                 and out, f32 and bf16) and at the main path's shapes;
                 the cold codec (int8 and f16, encode and decode) at the
                 reference's codec rows and at the streamed slab's
                 (64, 6,603,710) FEMNIST-CNN shape, bit for bit, plus 8
                 full-width rows against the host numpy codec; the
                 blocked int8 quantizer on the codec's kernel.
3. main       — the paper's FEMNIST experiment (``configs/femnist_cnn``:
                 64 devices, 8 edge servers on a ring, tau=2, q=8, pi=10)
                 with the LEAF CNN at full width (6,603,710 params), two
                 rounds through ``run_wall_clock``; checks finite losses,
                 kernel launch counts and cluster-synced bank rows. Round
                 1 runs under the allocator's memory history (what is
                 live at its peak), round 2 under the profiler (device
                 time by kernel and the device's busy share).
4. population — the same configuration streamed over a virtual
                 population of 10,000 clients (cohort 7 a cluster, int8
                 cold store, visit mobility 0.25): three pipelined rounds
                 (slab 56 + 8 = 64 rows) through ``run_wall_clock``, the
                 last under the profiler; checks finite losses, the slab,
                 the kernels' launch counts and finite stored scales;
                 then the serial driver (host codec) on the same
                 configuration, whose global model must agree within the
                 int8 tolerance.
5. parity     — the quickstart configuration for one round, and the small
                 population configuration of the CPU tests (f32,
                 pipelined) for two, on the card and on the CPU; they
                 must agree (TF32 off).

The line before the last two is ``{"kernels": [...]}``; the card's
``name, power.limit`` (from nvidia-smi) follows, and the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s and FP32 FLOP/s
#: on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: kernel tolerances (the reference's own, tests/test_kernels.py)
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
#: card against CPU after one quickstart round (observed 1.2e-7 on params,
#: 2.0e-6 on momentum: f32 sums in different orders)
PARITY_ATOL = 1e-5
SWEEP = ((8, 5000), (16, 4096), (64, 1000), (4, 123))
FEMNIST_T = 6_603_710
#: the reference's codec rows (tests/test_kernels.py): irregular segments
CODEC_SEGMENTS = ((0, 100), (100, 37), (137, 263))
#: the streamed slab of the population phase: 56 cohort + 8 representatives
SLAB_ROWS = 64
#: serial (host codec) against pipelined (card codec) at int8: the
#: reference's own bound (tests/test_clientstore.py)
INT8_ATOL = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def max_err(out: torch.Tensor, exp: torch.Tensor, tol: float,
            what: str) -> float:
    """Max abs difference; raises unless |out-exp| <= tol + tol*|exp|."""
    o, e = out.float(), exp.float()
    diff = (o - e).abs()
    err = float(diff.max())
    bad = int((diff > tol + tol * e.abs()).sum())
    if bad or not math.isfinite(err):
        raise AssertionError(f"{what}: {bad} elements over tolerance {tol}"
                             f" (max abs diff {err:.3e})")
    return err


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

KERNEL_SOURCES = ("gossip_mix", "cold_codec")


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = [_build.compile_library(name) for name in KERNEL_SOURCES]
    for name, path in zip(KERNEL_SOURCES, paths):
        log(f"[build] {name}: {os.path.relpath(path, ROOT)}")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(paths)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _stochastic(rng, k: int, n: int, axis: int) -> np.ndarray:
    W = rng.uniform(size=(k, n))
    return (W / W.sum(axis, keepdims=True)).astype(np.float32)


def phase_kernels(dev: torch.device) -> dict:
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    for n, T in SWEEP:
        for dtype, tol in TOL.items():
            Y = torch.from_numpy(rng.standard_normal((n, T)).astype(
                np.float32)).to(dev, dtype)
            Wc = torch.from_numpy(_stochastic(rng, n, n, 0)).to(dev)
            e1 = max_err(gm.gossip_mix_flat(Wc, Y), ref.gossip_mix_ref(Wc, Y),
                         tol, f"flat {n}x{T} {dtype}")
            Wr = torch.from_numpy(_stochastic(rng, n, n, 1)).to(dev)
            exp = ref.gossip_mix_rows_ref(Wr, Y)
            Yi = Y.clone()
            got = gm.gossip_mix_rows(Wr, Yi)
            assert got.data_ptr() == Yi.data_ptr(), "square W not in place"
            e2 = max_err(got, exp, tol, f"rows in place {n}x{T} {dtype}")
            log(f"[kernels] gossip_mix n={n} T={T} {str(dtype)[6:]}: "
                f"flat max_abs_err={e1:.3e} rows-in-place "
                f"max_abs_err={e2:.3e} (tol {tol})")

    # the main path's shapes: the (64, 64) boundary in place, and the
    # (8, 64) edge-model projection
    n, m, T = 64, 8, FEMNIST_T
    tol = TOL[torch.float32]
    Y = torch.randn((n, T), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    Wr = torch.from_numpy(_stochastic(rng, n, n, 1)).to(dev)
    P = torch.from_numpy(_stochastic(rng, m, n, 1)).to(dev)
    exp = ref.gossip_mix_rows_ref(Wr, Y)
    err_sq = max_err(gm.gossip_mix_flat(Wr.T, Y), exp, tol,
                     "flat 64x64 main shape")
    Yi = Y.clone()
    err_in = max_err(gm.gossip_mix_rows(Wr, Yi), exp, tol,
                     "rows in place 64x64 main shape")
    del Yi, exp
    err_p = max_err(gm.gossip_mix_rows(P, Y), ref.gossip_mix_rows_ref(P, Y),
                    tol, "projection 8x64 main shape")
    log(f"[kernels] gossip_mix main shapes T={T}: 64x64 flat "
        f"{err_sq:.3e}, 64x64 in place {err_in:.3e}, 8x64 projection "
        f"{err_p:.3e} (tol {tol})")

    # times: the in-place boundary (8 launches a round) and the
    # projection (1 a evaluation)
    ms = time_ms(lambda: gm.gossip_mix_rows(Wr, Y))
    plain_ms = time_ms(lambda: ref.gossip_mix_rows_ref(Wr, Y))
    library_ms = time_ms(lambda: torch.matmul(Wr, Y))
    p_ms = time_ms(lambda: gm.gossip_mix_rows(P, Y))
    p_plain = time_ms(lambda: ref.gossip_mix_rows_ref(P, Y))
    p_lib = time_ms(lambda: torch.matmul(P, Y))

    def bound(k):
        nbytes = 4 * (k * n + n * T + k * T)
        flops = 2 * k * n * T
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")
    b_ms, b_by = bound(n)
    pb_ms, pb_by = bound(m)
    log(f"[kernels] gossip_mix 64x64 in place: {ms:.4f} ms (plain "
        f"{plain_ms:.4f}, torch.matmul {library_ms:.4f}, bound {b_ms:.4f} "
        f"by {b_by})")
    log(f"[kernels] gossip_mix 8x64 projection: {p_ms:.4f} ms (plain "
        f"{p_plain:.4f}, torch.matmul {p_lib:.4f}, bound {pb_ms:.4f} by "
        f"{pb_by})")
    del Y
    torch.cuda.empty_cache()
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix.py:50",
            "launches": 0, "max_abs_err": max(err_sq, err_in, err_p),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a tensor, for bit-for-bit comparisons."""
    return t.view({torch.float32: torch.int32, torch.float16: torch.int16,
                   torch.int8: torch.int8}[t.dtype])


def _same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Raises unless ``a`` and ``b`` hold the same bits; returns their max
    abs difference (0.0, or NaN where both hold the same NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} against "
                             f"{b.dtype} {tuple(b.shape)}")
    bad = int((_bits(a) != _bits(b)).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} elements differ in their bits")
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


def _codec_rows(dev: torch.device) -> torch.Tensor:
    """The reference's codec rows: 13 x 400, an all-zero row (the 1e-12
    scale floor) and a near-zero segment."""
    rng = np.random.default_rng(7)
    rows = (rng.standard_normal((13, 400)) * 3).astype(np.float32)
    rows[2] = 0.0
    rows[5, :100] = 1e-9
    return torch.from_numpy(rows).to(dev)


def _check_codec(rows: torch.Tensor, codec: str, segments, what: str):
    """Kernel encode and decode against their plain versions, bit for
    bit; returns the kernel's (q, scale) and the max abs differences of
    the encode and of the decode."""
    from repro_torch.kernels import cold_codec as cc
    from repro_torch.kernels import ref
    q, s = cc.encode_rows(rows, codec, segments)
    q_ref, s_ref = ref.cold_encode_ref(rows, codec, segments)
    enc_err = max(_same_bits(q, q_ref, f"{what} {codec} encode q"),
                  _same_bits(s, s_ref, f"{what} {codec} encode scale"))
    dec_err = _same_bits(cc.decode_rows(q, s, codec, segments),
                         ref.cold_decode_ref(q, s, codec, segments),
                         f"{what} {codec} decode")
    return q, s, enc_err, dec_err


def phase_codec(dev: torch.device):
    """The cold codec and the blocked quantizer against their plain
    versions, bit for bit, at the reference's codec rows and at the
    population phase's slab; times at the slab's shape. Returns the
    JSON entries of the int8 encode and decode (the main path's)."""
    from repro_torch.core import compress
    from repro_torch.kernels import cold_codec as cc
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels.gossip_mix import FlatLayout
    from repro_torch.models.cnn import init_femnist_cnn
    rows = _codec_rows(dev)
    for codec in ("f16", "int8"):
        q, s, _, _ = _check_codec(rows, codec, CODEC_SEGMENTS, "codec rows")
        host = compress.encode_cold_rows(rows.cpu().numpy(), codec,
                                         CODEC_SEGMENTS)
        assert np.array_equal(q.cpu().numpy(), host["q"]) and \
            np.array_equal(s.cpu().numpy(), host["scale"]), \
            f"codec rows {codec}: the card differs from the host codec"
    log(f"[kernels] cold_codec 13x400 (3 irregular segments, zero row, "
        f"near-zero segment): f16 and int8 encode/decode bit-equal to "
        f"the plain version and the host codec")

    # the streamed slab: 64 rows of the FEMNIST CNN's 8 segments, each
    # segment at its own magnitude
    segs = FlatLayout.for_tree(
        init_femnist_cnn(torch.Generator().manual_seed(0))).segments
    S, T = SLAB_ROWS, FEMNIST_T
    assert segs[-1][0] + segs[-1][1] == T, segs
    gen = torch.Generator(dev).manual_seed(1)
    X = torch.randn((S, T), device=dev, generator=gen)
    for j, (o, n) in enumerate(segs):
        X[:, o:o + n] *= 10.0 ** (j % 4 - 2)
    X[3] = 0.0
    out = {}
    for codec in ("f16", "int8"):
        q, s, enc_err, dec_err = _check_codec(X, codec, segs,
                                              f"slab {S}x{T}")
        host = compress.encode_cold_rows(X[:8].cpu().numpy(), codec, segs)
        assert np.array_equal(q[:8].cpu().numpy(), host["q"]) and \
            np.array_equal(s[:8].cpu().numpy(), host["scale"]), \
            f"slab {codec}: 8 rows differ from the host codec"
        nseg = s.shape[1]
        width = q.element_size()
        enc_bytes = 4 * S * T + width * S * T + 4 * S * nseg
        dec_bytes = width * S * T + 4 * S * nseg + 4 * S * T
        # FP32 work a element: |x|, max, divide, round, two clamps to
        # encode (one cast for f16); one multiply to decode
        enc_ops = (6 if codec == "int8" else 1) * S * T
        dec_ops = S * T
        times = {
            "encode": (time_ms(lambda: cc.encode_rows(X, codec, segs)),
                       time_ms(lambda: ref.cold_encode_ref(X, codec, segs),
                               reps=5),
                       enc_bytes, enc_ops, enc_err),
            "decode": (time_ms(lambda: cc.decode_rows(q, s, codec, segs)),
                       time_ms(lambda: ref.cold_decode_ref(q, s, codec,
                                                           segs), reps=5),
                       dec_bytes, dec_ops, dec_err)}
        for direction, (ms, plain_ms, nbytes, ops, err) in times.items():
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            tf = ops / FP32_FLOPS * 1e3
            b_ms, b_by = (tb, "bytes") if tb >= tf else (tf, "operations")
            log(f"[kernels] cold_codec {codec} {direction} {S}x{T}: "
                f"{ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.4f} by "
                f"{b_by}: {nbytes / 1e9:.3f} GB; no single library call "
                f"computes it); bit-equal to the plain version, 8 rows to "
                f"the host codec")
            out[(codec, direction)] = {
                "name": f"cold_codec_{direction}",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/cold_codec.cu",
                "replaces": ("src/repro/kernels/cold_codec.py:109" if
                             direction == "encode" else
                             "src/repro/kernels/cold_codec.py:125"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}
        del q, s

    # B3: the blocked quantizer on the codec's kernel, over one slab row
    x = X[0].clone()
    codes, scales = qz.quantize_int8_blocked(x)
    pc, ps = qz.quantize_int8_ref(x)
    _same_bits(codes, pc, "quantize_int8_blocked codes")
    _same_bits(scales, ps, "quantize_int8_blocked scales")
    ms = time_ms(lambda: qz.quantize_int8_blocked(x))
    plain_ms = time_ms(lambda: qz.quantize_int8_ref(x))
    nb = scales.shape[0]
    b_ms = (4 * T + T + 4 * nb) / HBM_BYTES_PER_S * 1e3
    log(f"[kernels] quantize_int8_blocked T={T} (block 1024): {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, bound {b_ms:.4f} by bytes); bit-equal to "
        f"the plain version")
    del X, x
    torch.cuda.empty_cache()
    return out[("int8", "encode")], out[("int8", "decode")]


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def femnist_data(fl):
    from repro_torch.data.federated import (build_fl_data,
                                            dirichlet_partition,
                                            make_synthetic_images)
    x, y = make_synthetic_images(2048, 28, 1, 62, seed=0)
    tx, ty = make_synthetic_images(512, 28, 1, 62, seed=1)
    parts = dirichlet_partition(y, fl.n, 0.3, 0)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def device_breakdown(prof, wall_s: float, top: int = 10,
                     tag: str = "main") -> None:
    """Device time of a profiled window by kernel, and the device's busy
    share of the window's wall time: the union of the kernels' intervals
    (kernels on several streams may overlap, so their sum can exceed
    it)."""
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.time_range.elapsed_us() > 0]
    if not kernels:
        log(f"[{tag}] profiler recorded no device time: breakdown not "
            "measured")
        return
    busy_us, end = 0.0, -math.inf
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name: dict = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), c + 1)
    sum_us = sum(t for t, _ in by_name.values())
    streams = len({k.device_resource_id for k in kernels})
    log(f"[{tag}] profiled round: {len(kernels)} kernels on {streams} "
        f"stream(s), kernel time {sum_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms of {wall_s * 1e3:.2f} ms wall "
        f"({100 * busy_us / 1e6 / wall_s:.1f}% busy, under the profiler); "
        f"top kernels:")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                               )[:top]:
        log(f"[{tag}]   {t / 1e3:9.3f} ms {100 * t / sum_us:5.1f}% "
            f"x{c:<5d} {name[:110]}")


def _site(frames) -> str:
    """Where a block was allocated (frames run innermost first): the
    innermost frame of the repo, the autograd node when the block was
    made in a backward (which runs on the engine's device thread, with no
    Python frame), and the innermost ATen function."""
    def first(pred):
        return next((f for f in frames if pred(f)), None)
    ours = first(lambda f: "repro_torch" in f["filename"]
                 or f["filename"].endswith("chip_smoke.py"))
    node = first(lambda f: "autograd::generated::" in f["name"])
    aten = first(lambda f: "at::native::" in f["name"]
                 or "at::_ops::" in f["name"])
    parts = []
    if ours:
        parts.append(f"{os.path.basename(ours['filename'])}:{ours['line']} "
                     f"{ours['name']}")
    parts += [f["name"].split("(")[0][:60] for f in (node, aten) if f]
    return " > ".join(parts) or "unknown"


def peak_breakdown(snap: dict, dev: torch.device, base: int,
                   top: int = 8) -> None:
    """The blocks live at the allocator's peak, from a memory-history
    snapshot: replay the trace's allocs and frees (``allocated_bytes``
    falls at ``free_requested``), find the point of most bytes, and group
    the blocks live there by allocation site. ``base`` is what was
    allocated before the history started."""
    trace = snap["device_traces"][dev.index]

    def replay(stop=None):
        live, cur, peak, at = {}, base, base, -1
        for i, e in enumerate(trace[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
                if cur > peak:
                    peak, at = cur, i
            elif e["action"] == "free_requested" and e["addr"] in live:
                cur -= live.pop(e["addr"])["size"]
        return live, peak, at
    _, peak, at = replay()
    live, _, _ = replay(at + 1)
    groups = defaultdict(lambda: [0, 0])
    for e in live.values():
        g = groups[(_site(e.get("frames", [])), e["size"])]
        g[0] += e["size"]
        g[1] += 1
    log(f"[main] allocator peak over set-up and round 1 {peak / 1e9:.2f} GB"
        f" ({base / 1e9:.2f} GB allocated before the history); live at the "
        f"peak, by site:")
    for (site, size), (total, count) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[main]   {total / 1e9:6.3f} GB = {count:4d} x "
            f"{size / 1e6:9.3f} MB  {site[:150]}")


def phase_main(dev: torch.device, rounds: int = 2) -> int:
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    fl = cfg.FL
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    # C++ frames name the autograd node and ATen function of each block;
    # dladdr is the quickest of torch's symbol resolvers
    os.environ.setdefault("TORCH_SYMBOLIZE_MODE", "dladdr")
    torch.cuda.memory._record_memory_history(stacks="all",
                                             max_entries=2_000_000)
    sim = FLSimulator(init_femnist_cnn, apply_femnist_cnn, fl,
                      femnist_data(fl), lr=0.1, batch_size=16, seed=0,
                      device=dev)
    T = sim.layout.total
    assert T == cfg.PARAMS, f"FEMNIST CNN has {T} params, not {cfg.PARAMS}"
    log(f"[main] FEMNIST CNN T={T}, n={fl.n}, clusters="
        f"{fl.num_clusters}, tau={fl.tau} q={fl.q} pi={fl.pi}; bank "
        f"{sim.bank.resident_nbytes / 1e9:.2f} GB (params + momentum)")
    rt = paper_runtime_model()
    torch.cuda.synchronize()
    gm.launches = 0
    wall = 0.0
    peaks = []
    for r in range(rounds):
        # round 1 runs under the memory history (the allocator's peak);
        # the last (steady) round under the profiler: device time by
        # kernel and the device's busy share of the round
        last = r == rounds - 1
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) if last
                else contextlib.nullcontext())
        torch.cuda.reset_peak_memory_stats(dev)
        with prof:
            t0 = time.perf_counter()
            hist = run_wall_clock(sim, rt, 1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated(dev))
        if r == 0:
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            peak_breakdown(snap, dev, base)
            del snap
        if last:
            device_breakdown(prof, dt)
        wall += hist["wall_time"][-1]
        loss, acc = hist["loss"][-1], hist["acc"][-1]
        Y = sim.bank.params.view(fl.num_clusters, fl.devices_per_cluster, T)
        spread = float((Y - Y[:, :1]).abs().max())
        log(f"[main] round {r + 1}: {dt:.3f} s on the card (step + eval), "
            f"loss={loss:.4f} acc={acc:.4f} simulated_wall={wall:,.1f} s, "
            f"max in-cluster row spread={spread:.2e}")
        assert math.isfinite(loss), f"round {r + 1}: loss {loss}"
        assert spread <= 1e-6, f"round {r + 1}: cluster rows differ by " \
            f"{spread}"
    launches = gm.launches
    want = rounds * fl.q + rounds
    log(f"[main] gossip_mix launches={launches} (want rounds*q + evals = "
        f"{want}); peak device memory by round "
        f"{', '.join(f'{p / 1e9:.2f}' for p in peaks)} GB")
    assert launches == want, f"gossip_mix launched {launches}, not {want}"
    del sim
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4: the streamed population at full width
# ---------------------------------------------------------------------------

def _global_row(sim) -> np.ndarray:
    return sim.layout.flatten_one(sim.global_model()).cpu().numpy()


def phase_population(dev: torch.device, rounds: int = 3):
    """Returns the launches of gossip_mix and of the codec's encode and
    decode on the pipelined population path."""
    from repro_torch.config import PopulationConfig, ScenarioConfig
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.kernels import cold_codec as cc
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    fl = cfg.FL
    scenario = ScenarioConfig(
        sample_fraction=1.0, dropout_prob=0.0, move_prob=0.25, seed=7,
        population=PopulationConfig(clients_per_cluster=1250,
                                    cohort_per_cluster=7, codec="int8"))
    data = femnist_data(fl)
    rt = paper_runtime_model()
    results = {}
    for pipeline in (True, False):
        name = "pipelined" if pipeline else "serial"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sim = FLSimulator(init_femnist_cnn, apply_femnist_cnn, fl, data,
                          lr=0.1, batch_size=16, seed=0,
                          scenario=scenario, pipeline=pipeline, device=dev)
        T = sim.layout.total
        if pipeline:
            log(f"[population] FEMNIST CNN T={T}: N={sim.engine.population}"
                f" virtual clients in {fl.num_clusters} clusters, cohort "
                f"cap {sim.engine.cohort_cap}, codec "
                f"{sim.store.codec}, data shards {fl.n}")
        gm.launches = cc.encode_launches = cc.decode_launches = 0
        times, wall = [], 0.0
        for r in range(rounds):
            last = pipeline and r == rounds - 1
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) if last
                    else contextlib.nullcontext())
            with prof:
                t0 = time.perf_counter()
                hist = run_wall_clock(sim, rt, 1)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if last:
                device_breakdown(prof, dt, tag="population")
            times.append(dt)
            wall += hist["wall_time"][-1]
            loss = hist["loss"][-1]
            log(f"[population] {name} round {r + 1}: {dt:.3f} s (step + "
                f"eval), page_s={hist['page_s'][-1]:.3f} compute_s="
                f"{hist['compute_s'][-1]:.3f} eval_s="
                f"{hist['eval_s'][-1]:.3f}, loss={loss:.4f} "
                f"acc={hist['acc'][-1]:.4f} participants="
                f"{hist['participants'][-1]} simulated_wall={wall:,.1f} s")
            assert math.isfinite(loss), f"{name} round {r + 1}: loss {loss}"
        launches = (gm.launches, cc.encode_launches, cc.decode_launches)
        snap = sim.store.snapshot()
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[population] {name}: slab {sim.last_bucket} rows, peak slab "
            f"{sim.peak_slab_bytes / 1e9:.3f} GB, peak device memory "
            f"{peak / 1e9:.2f} GB, host store {sim.store.nbytes / 1e9:.3f} "
            f"GB ({sim.store.num_stored} stored clients), process peak RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f}"
            f" GB; launches gossip_mix={launches[0]} cold_codec encode="
            f"{launches[1]} decode={launches[2]}")
        assert sim.last_bucket == SLAB_ROWS, sim.last_bucket
        assert sim.peak_slab_bytes == 2 * 4 * SLAB_ROWS * T
        assert np.isfinite(snap["mom_scale"]).all(), \
            f"{name}: a stored scale row is not finite"
        assert snap["ids"].size == sim.store.num_stored > 0
        # streamed evaluation reads the references: no projection launch
        assert launches[0] == rounds * fl.q, launches
        if pipeline:
            # a decode in pre and an int8 encode (absmax + quantize) in
            # post, every round
            assert launches[1:] == (2 * rounds, rounds), launches
        else:
            assert launches[1:] == (0, 0), launches
        results[name] = (_global_row(sim), times, launches)
        del sim, snap
        torch.cuda.empty_cache()
    diff = float(np.abs(results["pipelined"][0]
                        - results["serial"][0]).max())
    log(f"[population] serial (host codec) vs pipelined (card codec) global "
        f"model after {rounds} rounds: max abs diff {diff:.3e} (atol "
        f"{INT8_ATOL}); round times pipelined "
        f"{', '.join(f'{t:.3f}' for t in results['pipelined'][1])} s, "
        f"serial {', '.join(f'{t:.3f}' for t in results['serial'][1])} s")
    assert diff <= INT8_ATOL, "serial and pipelined drivers disagree"
    return results["pipelined"][2]


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU
# ---------------------------------------------------------------------------

def phase_parity(dev: torch.device) -> None:
    from repro_torch.config import FLConfig
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.data.federated import (build_fl_data,
                                            dirichlet_partition,
                                            make_synthetic_classification)
    from repro_torch.models.cnn import (apply_mlp_classifier,
                                        init_mlp_classifier)
    fl = FLConfig(algorithm="ce_fedavg", num_clusters=4,
                  devices_per_cluster=4, tau=2, q=4, pi=10,
                  topology="ring")
    x, y = make_synthetic_classification(1600, 16, 8, seed=0)
    tx, ty = make_synthetic_classification(400, 16, 8, seed=1)
    data = build_fl_data(x, y, dirichlet_partition(y, fl.n, 0.5, seed=2),
                         tx, ty, 64)
    init = init_mlp_classifier(torch.Generator().manual_seed(0), 16, 32, 8)
    banks = {}
    for where in (dev, torch.device("cpu")):
        sim = FLSimulator(lambda g: init, apply_mlp_classifier, fl, data,
                          lr=0.1, batch_size=16, device=where)
        sim.step_round()
        banks[where.type] = (sim.bank.params.cpu(), sim.bank.mom.cpu())
    ep = float((banks["cuda"][0] - banks["cpu"][0]).abs().max())
    em = float((banks["cuda"][1] - banks["cpu"][1]).abs().max())
    log(f"[parity] quickstart ce_fedavg, 1 round: card vs CPU max abs diff "
        f"params {ep:.3e}, momentum {em:.3e} (atol {PARITY_ATOL})")
    assert ep <= PARITY_ATOL and em <= PARITY_ATOL, \
        "card and CPU banks disagree"

    # the small population of the CPU tests, pipelined at f32
    from repro_torch.config import PopulationConfig, ScenarioConfig
    pfl = FLConfig(algorithm="ce_fedavg", num_clusters=4,
                   devices_per_cluster=4, tau=2, q=2, pi=2, topology="ring")
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    pdata = build_fl_data(x, y, dirichlet_partition(y, pfl.n, 0.5, seed=5),
                          tx, ty, 64)
    scenario = ScenarioConfig(
        name="mobile", sample_fraction=0.5, dropout_prob=0.1,
        move_prob=0.25, seed=7,
        population=PopulationConfig(clients_per_cluster=100,
                                    cohort_per_cluster=3, codec="f32"))
    pinit = init_mlp_classifier(torch.Generator().manual_seed(1), 16, 32, 4)
    out = {}
    for where in (dev, torch.device("cpu")):
        sim = FLSimulator(lambda g: pinit, apply_mlp_classifier, pfl, pdata,
                          lr=0.1, batch_size=16, seed=1,
                          scenario=scenario, pipeline=True, device=where)
        for _ in range(2):
            sim.step_round()
        out[where.type] = (_global_row(sim), sim.store.snapshot())
    (gc, sc), (gh, sh) = out["cuda"], out["cpu"]
    assert np.array_equal(sc["ids"], sh["ids"])
    eg = float(np.abs(gc - gh).max())
    es = max(float(np.abs(sc[k] - sh[k]).max()) for k in ("cluster",
                                                          "mom_q"))
    log(f"[parity] population of 400 (f32, pipelined), 2 rounds: card vs "
        f"CPU max abs diff global model {eg:.3e}, store {es:.3e} (atol "
        f"{PARITY_ATOL}; {sc['ids'].size} stored clients on both)")
    assert eg <= PARITY_ATOL and es <= PARITY_ATOL, \
        "card and CPU population runs disagree"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this smoke run "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    entry = phase_kernels(dev)
    encode, decode = phase_codec(dev)
    entry["launches"] = phase_main(dev)
    gossip_pop, encode["launches"], decode["launches"] = \
        phase_population(dev)
    log(f"[done] gossip_mix launches: main path {entry['launches']}, "
        f"population path {gossip_pop}")
    phase_parity(dev)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry, encode, decode]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
