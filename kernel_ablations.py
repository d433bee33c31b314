#!/usr/bin/env python3
"""What each part of the port's gossip-mix (B1), flash-attention (B4),
SSD intra-chunk (B5, and its backward), int8 cold-encode and f16 cast
(B2) kernels costs, on one NVIDIA GPU.

  python3 kernel_ablations.py [KIND ...]

(KIND: a key of the JSON line, such as "f16 casts"; all of them by
default.)

Builds variants of ``src/repro_torch/kernels/csrc/gossip_mix.cu``,
``flash_attention.cu``, ``flash_attention_bwd.cu``, ``ssd_scan.cu``,
``ssd_scan_bwd.cu`` and ``cold_codec.cu`` with one part of the work
taken out (by text substitution of the committed sources, into a
scratch build directory
under ``src/repro_torch/kernels/_build/``), and times each at the main
path's shapes beside the committed kernel, CUDA events, median of 20:

- B1, the 64 x 64 in-place boundary and the 8 x 64 projection at the
  FEMNIST CNN's T = 6,603,710 (f32): without the tensor-core products,
  without the stores, without both (the loads alone); beside PyTorch's
  copy of the bank and of the same rows two columns in (rows 8 bytes off
  16-byte alignment, as the bank's odd rows are);
- B4 at the Zamba2-2.7B prefill shape (2, 4096, 32 x 80, bf16, causal):
  without the softmax (probabilities left as raw scores), without the
  second (lo) P V pass, without Q K^T;
- B4's backward at the qwen2-0.5b training shape (4, 2048, 14/2 x 64,
  bf16, causal), through its wrapper, by its device time (the
  profiler's kernel time over 10 calls, as ``chip_smoke.py`` times it):
  with one dK/dV block a kv head (its 7 query heads in turn, no head
  sum) in place of one a query head, and without the head sum;
- B5's backward at mamba2-2.7b's training shape (32 chunks of 256, 80
  heads of 64, state 128, bf16), through its wrapper, by its device time
  and each of its three kernels': without adding dS into D's sum over
  the heads, without the M^T dy products, without the dy x^T and B C^T
  products, without the elementwise terms, and with all of these and
  the hi/lo split of the tiles cut (the loads, barriers and stores
  alone); without the tile copies (the stages keep stale data: the
  compute alone); with twice the head groups (half the heads a block,
  twice D's partials); and with the grid's other order (the column tiles
  of a (chunk, head group) side by side, for dy's reuse in L2, in place
  of the longest column tiles first);
- B2's f16 casts at the streamed slab (64, 6,603,710), both ways: with
  a grid of 8 blocks an SM striding the array in place of a block for
  every 256 groups, and with streaming cache hints (``__ldcs`` /
  ``__stcs``) on the aligned path; the committed kernel also with its
  f16 side one half an access (the width its plan falls back to at row
  views, here on aligned pointers); beside ``Tensor.to`` both ways.

A variant computes wrong results by design and is only timed; the
committed kernel is checked against its plain version first. A
substitution that no longer matches the source stops the run. The last
line is a JSON object of the times (ms) and the card's name and power
limit. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

GOSSIP_CUTS = {
    "no products": [(
        "          if constexpr (kSplitY)\n"
        "            Tf32Mma<N>::rs(acc, al[ks], w_desc(w_hi + off));\n"
        "          Tf32Mma<N>::rs(acc, ah[ks], w_desc(w_lo + off));\n"
        "          Tf32Mma<N>::rs(acc, ah[ks], w_desc(w_hi + off));\n",
        "          (void)off;\n")],
    "no stores": [(
        "      store_rows<T, BYTES>(out, stg, k, ncols, tile * kC + 64 * c, t);\n",
        "")],
}
GOSSIP_CUTS["loads only"] = GOSSIP_CUTS["no products"] + \
    GOSSIP_CUTS["no stores"]

ATTENTION_CUTS = {
    "no softmax": [(
        "      sm.run(sc, (kt_begin + it) * kTmaBK, corr);\n",
        "      corr[0] = corr[1] = 1.f;\n")],
    "no lo pass of P V": [(
        "    Wgmma<16 * DK>::rs(o, plo[k16], dv);\n", "")],
    "no Q K^T": [(
        "      issue_qk<DK>(sc, q_box, k_box + s * DK * kBox);\n",
        "#pragma unroll\n      for (int i = 0; i < kNS; ++i) sc[i] = 0.f;\n")],
}

ATTENTION_BWD_CUTS = {
    "one dK/dV block a kv head, no head sum": [(
        "constexpr int kBlocksPerSm = 4;",
        "constexpr int kBlocksPerSm = 0;")],
    "no head sum": [(
        "  flash_attention_bwd_sum_heads<<<",
        "  if (a.B < 0) flash_attention_bwd_sum_heads<<<")],
}

SSD_CUTS = {
    "no y stores": [(
        "      store_rows<P>(acc, stage, yb + (int64_t)(16 * sa) * g.y_sc,",
        "      if (g.BK < 0) store_rows<P>(acc, stage, yb + (int64_t)(16 * sa) "
        "* g.y_sc,"), (
        "      store_rows<P>(acc, stage, yb + (int64_t)(16 * sb) * g.y_sc,",
        "      if (g.BK < 0) store_rows<P>(acc, stage, yb + (int64_t)(16 * sb) "
        "* g.y_sc,")],
    "no states pass": [(
        "    for (int strip = kParts == 1 ? warp : warp % NK; strip < NK;\n",
        "    for (int strip = kParts == 1 ? warp : warp % NK; strip < NK && "
        "g.BK < 0;\n")],
    "no C B^T": [(
        "              mma_bf16(gq[b], af, bf[0], bf[1]);\n"
        "              mma_bf16(gq[b] + 4, af, bf[2], bf[3]);\n",
        "              (void)af;\n              (void)bf;\n")],
}
SSD_CUTS["no lo products of y"] = [(
    "#pragma unroll\n  for (int pp = 0; pp < PN / 2; ++pp) {\n"
    "    mma_bf16(acc[2 * pp], lo, b[pp][0], b[pp][1]);\n"
    "    mma_bf16(acc[2 * pp + 1], lo, b[pp][2], b[pp][3]);\n  }\n",
    "  (void)lo;\n")]
SSD_CUTS["no exps of L"] = [(
    "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));\n",
    "  y = x;\n")]
SSD_CUTS["loads only"] = SSD_CUTS["no states pass"] + [(
    "    if (has_y) {\n      float* yb",
    "    if (has_y && g.BK < 0) {\n      float* yb"), (
    "      if (has_y) {\n#pragma unroll\n        for (int b = 0; b < kMaxBlocks;",
    "      if (has_y && g.BK < 0) {\n#pragma unroll\n        for (int b = 0; "
    "b < kMaxBlocks;")]

SSD_BWD_CUTS = {
    "no D accumulation over heads": [(
        "    if (!first) {\n      const float4 o = dpos[nb * 128 + t];",
        "    if (N < 0) {\n      const float4 o = dpos[nb * 128 + t];"), (
        "    dpos[nb * 128 + t] = d;\n",
        "    if (N < 0) dpos[nb * 128 + t] = d;\n")],
    "no dx products": [(
        "      issue_dx<P>(hs.dx, mh, ml, hi, lo);\n",
        "      if (g.BK < 0) issue_dx<P>(hs.dx, mh, ml, hi, lo);\n")],
    "no G/S products": [(
        "      issue_g<P>(acc, xt, hi, lo);\n",
        "#pragma unroll\n      for (int i = 0; i < kNS; ++i) acc[i] = 0.f;\n"), (
        "      for (int kb = 0; kb < NB; ++kb)\n        Wgmma<kT>::ss(sreg[q],",
        "      for (int kb = 0; kb < NB && g.BK < 0; ++kb)\n"
        "        Wgmma<kT>::ss(sreg[q],")],
    "no elementwise terms": [(
        "      if (p >= nr)\n        elementwise<kVirtual>(",
        "      if (g.BK >= 0) {\n      } else if (p >= nr)\n"
        "        elementwise<kVirtual>(")],
}
SSD_BWD_CUTS["the column tiles of a (chunk, group) together"] = [(
    "  const int per = g.BK * g.groups;\n  jt = b / per;\n"
    "  const int rest = b - jt * per;\n",
    "  jt = b % g.ntj;\n  const int rest = b / g.ntj;\n")]
SSD_BWD_CUTS["no tile loads (the compute alone)"] = [(
    "      wait_bar(bar_full + 8 * s, (n / SW) & 1);\n",
    "      if (g.BK < 0) wait_bar(bar_full + 8 * s, (n / SW) & 1);\n"), (
    "  auto load_tile = [&](int n) {\n",
    "  auto load_tile = [&](int n) {\n    if (g.BK >= 0) return;\n")]
SSD_BWD_CUTS["twice the head groups"] = [(
    "constexpr int kTargetBlocks = 528;", "constexpr int kTargetBlocks = 1056;")]
SSD_BWD_CUTS["loads only"] = [(
    "      split_tile<P>(sm + L::kRing",
    "      if (g.BK < 0) split_tile<P>(sm + L::kRing")] + [
    cut for name in SSD_BWD_CUTS for cut in SSD_BWD_CUTS[name]
    if name in ("no dx products", "no G/S products", "no elementwise terms")]

ENCODE_CUTS = {
    "absmax pass alone": [(
        "    const bool codes = k.kind != kMaxOnly;\n",
        "    const bool codes = k.kind != kMaxOnly && ntasks < 0;\n")],
    "quantize pass alone": [(
        "    if (k.kind != kCodesOnly) {\n      // the inside words",
        "    if (k.kind != kCodesOnly && ntasks < 0) {\n      // the inside "
        "words"), (
        "  if ((d[2] >> 32) != kCodesOnly) {\n",
        "  if ((d[2] >> 32) != kCodesOnly && ntasks < 0) {\n")],
}

#: the f16 casts: the grid of a block for every 256 groups against one of
#: 8 blocks an SM that strides the array (the H100's 132 SMs); plain
#: loads and stores against streaming cache hints (the aligned path)
CAST_CUTS = {
    "a grid of 8 blocks an SM, striding the array": [(
        "  blocks = blocks < 1 ? 1 : blocks > 0x7fffffffLL ? 0x7fffffffLL : "
        "blocks;\n",
        "  blocks = blocks < 1 ? 1 : blocks > 132 * 8 ? 132 * 8 : blocks;\n")],
    "streaming cache hints": [
        ("      const float4 v = x4[g];\n",
         "      const float4 v = __ldcs(x4 + g);\n"),
        ("        *reinterpret_cast<uint2*>(h) = make_uint2(lo, hi);\n",
         "        __stcs(reinterpret_cast<uint2*>(h), make_uint2(lo, hi));\n"),
        ("        const uint2 v = *reinterpret_cast<const uint2*>(h);\n",
         "        const uint2 v = __ldcs(reinterpret_cast<const uint2*>(h));\n"),
        ("      x4[g] = make_float4(",
         "      __stcs(x4 + g, make_float4("),
        ("                          half_at(hi, 1));\n",
         "                          half_at(hi, 1)));\n")],
}


def build(name: str, source: str, cuts) -> ctypes.CDLL:
    """``source`` with ``cuts`` applied, compiled into its own library."""
    text = open(os.path.join(_build.CSRC, source)).read()
    for old, new in cuts:
        if old not in text:
            raise RuntimeError(f"{name}: the substitution no longer matches "
                               f"{source}: {old[:60]!r}")
        text = text.replace(old, new)
    out = _build.BUILD / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(text)
    lib = out / f"lib{name}.so"
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(str(lib))


def gossip(libs, dev) -> dict:
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import ref
    n, T = 64, cs.FEMNIST_T
    rng = np.random.default_rng(0)
    Y = torch.randn((n, T), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    W = torch.from_numpy(cs._stochastic(rng, n, n, 1)).to(dev)
    P = torch.from_numpy(cs._stochastic(rng, 8, n, 1)).to(dev)
    proj = torch.empty((8, T), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        fn = lib.gossip_mix_rows_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(Wm, Yin, dst, k, fn=fn):
            rc = fn(Wm.data_ptr(), Yin.data_ptr(), dst.data_ptr(), n, k, T,
                    0, gm.copy_bytes(T, 4, Yin.data_ptr() | dst.data_ptr()),
                    stream)
            if rc:
                raise RuntimeError(f"gossip_mix {name}: CUDA error {rc}")
        if name == "kernel":
            Yi = Y.clone()
            run(W, Yi, Yi, n)
            cs.max_err(Yi, ref.gossip_mix_rows_ref(W, Y), cs.TOL[
                torch.float32], "gossip_mix 64x64 in place")
            del Yi
        Yt = Y.clone()
        out[name] = {"64x64 in place": cs.time_ms(lambda: run(W, Yt, Yt, n)),
                     "8x64 projection": cs.time_ms(
                         lambda: run(P, Yt, proj, 8))}
        del Yt
    Y2 = torch.empty_like(Y)
    out["torch copy"] = {
        "bank": cs.time_ms(lambda: Y2.copy_(Y)),
        "rows 2 columns in": cs.time_ms(
            lambda: Y2[:, 2:].copy_(Y[:, 2:]))}
    return out


def attention(libs, dev) -> dict:
    from repro_torch.kernels import ref
    B, S, H, D = cs.LM_BATCH, cs.LM_SEQ, 32, 80
    gen = torch.Generator(dev).manual_seed(11)
    q, k, v = (torch.randn((B, S, H, D), device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    o = torch.empty_like(q)
    dims = [B, H, H, S, S, D, 1, 0, 0]
    for t in (q, k, v, o):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    cdims = (ctypes.c_longlong * len(dims))(*dims)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, cdims, 1, stream)
            if rc:
                raise RuntimeError(f"flash_attention {name}: CUDA error {rc}")
        if name == "kernel":
            run()
            cs.max_err(o, ref.flash_attention_bshd_ref(q, k, v, causal=True),
                       cs.FA_PATH_ATOL, "flash_attention prefill shape",
                       rtol=cs.FA_PATH_RTOL)
        out[name] = cs.time_ms(run)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out["scaled_dot_product_attention"] = cs.time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
    return out


def attention_bwd(libs, dev) -> dict:
    """B4's backward through its wrapper at the qwen2-0.5b training shape
    (4, 2048, 14/2, 64, bf16, causal), on the forward's o and logsumexp,
    each variant's library in place of the committed one."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, S, H, Hkv, D = cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ, 14, 2, 64
    gen = torch.Generator(dev).manual_seed(13)
    q, do = (torch.randn((B, S, H, D), device=dev, generator=gen
                         ).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), device=dev, generator=gen
                        ).to(torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    committed = fa._bwd_library
    out = {}
    try:
        for name, lib in libs.items():
            fa._bwd_library = lambda lib=fa.bind_bwd(lib): lib

            def run():
                return fa._launch_bwd(q, k, v, o, do, lse, True, 0, 0)
            if name == "kernel":
                o_ref, _ = ref.flash_attention_lse_ref(q, k, v, causal=True)
                for a, b in zip(run(), ref.flash_attention_bwd_ref(
                        q, k, v, o_ref, do, causal=True)):
                    cs._rel_err(a, b, cs.FA_BWD_TOL[torch.bfloat16],
                                "flash_attention_bwd training shape")
                del o_ref
            out[name] = cs.device_ms(run)[0]
    finally:
        fa._bwd_library = committed
    return out


def ssd(libs, dev) -> dict:
    from repro_torch.kernels import ref
    BK, H, C, P, N = cs.LM_BATCH * cs.LM_SEQ // 256, 80, 256, 64, 64
    gen = torch.Generator(dev).manual_seed(12)
    x, a, Bm, Cm, d = cs._ssd_inputs(gen, dev, BK, H, C, P, N,
                                     torch.bfloat16)
    y = torch.empty((BK, H, C, P), device=dev)
    st = torch.empty((BK, H, N, P), device=dev)
    dims = [BK, H, C, P, N]
    for t in (x, a, d):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    for t in (Bm, Cm):
        dims += [t.stride(0), t.stride(1)]
    for t in (y, st):
        dims += [t.stride(0), t.stride(1), t.stride(2)]
    cdims = (ctypes.c_longlong * len(dims))(*dims)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        fn = lib.ssd_intra_chunk_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn):
            rc = fn(x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    d.data_ptr(), y.data_ptr(), st.data_ptr(), cdims, 1,
                    stream)
            if rc:
                raise RuntimeError(f"ssd_intra_chunk {name}: CUDA error {rc}")
        if name == "kernel":
            run()
            for o, e, what in zip((y, st), ref.ssd_intra_chunk_ref(
                    x, a, Bm, Cm, d), ("y", "states")):
                cs.max_err(o, e, cs.SSD_PATH_TOL, f"ssd_intra_chunk {what}")
        out[name] = cs.time_ms(run)
    return out


def ssd_bwd(libs, dev) -> dict:
    """B5's backward through its wrapper at mamba2-2.7b's training shape
    (32 chunks of 256, 80 heads of 64, state 128, bf16), each variant's
    library in place of the committed one: the call's device time and,
    beside it, each of its three kernels' (``ssd_scan_bwd_tiles``,
    ``_dbdc``, ``_da``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    Bsz, K, C, H, P, N = cs.SSD_BWD_TRAIN_PATHS["mamba2-2.7b"]
    BK = Bsz * K
    gen = torch.Generator(dev).manual_seed(14)
    x, a, Bm, Cm, d = cs._ssd_inputs(gen, dev, BK, H, C, P, N,
                                     torch.bfloat16)
    dy = torch.randn((BK, H, C, P), device=dev, generator=gen)
    dst = torch.randn((BK, H, N, P), device=dev, generator=gen)
    committed = ss._bwd_library
    out = {}
    try:
        for name, lib in libs.items():
            ss._bwd_library = lambda lib=ss.bind_bwd(lib): lib

            def run():
                return ss._launch_bwd(x, a, Bm, Cm, d, dy, dst)
            if name == "kernel":
                cs._ssd_bwd_close(run(), ref.ssd_intra_chunk_bwd_ref(
                    x, a, Bm, Cm, d, dy, dst), torch.bfloat16,
                    "ssd_scan_bwd training shape")
            ms, by_kernel = cs.device_ms(run)
            out[name] = ms
            for kernel in ("tiles", "dbdc", "da"):
                out[f"{name}, {kernel}"] = sum(
                    t for k, t in by_kernel.items()
                    if cs._short_name(k) == f"ssd_scan_bwd_{kernel}")
    finally:
        ss._bwd_library = committed
    return out


def encode(libs, dev) -> dict:
    from repro_torch.kernels import cold_codec as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels.gossip_mix import FlatLayout
    from repro_torch.models.cnn import init_femnist_cnn
    segs = tuple(FlatLayout.for_tree(
        init_femnist_cnn(torch.Generator().manual_seed(0))).segments)
    S, T = cs.SLAB_ROWS, cs.FEMNIST_T
    X = torch.randn((S, T), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    q = torch.empty((S, T), dtype=torch.int8, device=dev)
    scale = torch.empty((S, len(segs)), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        p = ctypes.c_void_p
        lib.cold_encode_int8_grid.restype = ctypes.c_int
        tasks, units, ngroups, largest = (
            torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
            for a in cc.encode_plan(segs, S, lib.cold_encode_int8_grid()))
        scratch = torch.empty(2 * ngroups + 1, dtype=torch.int32, device=dev)
        fn = lib.cold_encode_int8_launch
        fn.argtypes = [p, p, ctypes.c_longlong, p, p, ctypes.c_int,
                       ctypes.c_int, p, p, p]
        fn.restype = ctypes.c_int

        def run(fn=fn, tasks=tasks, units=units, scratch=scratch,
                ngroups=ngroups, largest=largest):
            rc = fn(X.data_ptr(), tasks.data_ptr(), tasks.shape[0],
                    units.data_ptr(), scratch.data_ptr(), ngroups, largest,
                    q.data_ptr(), scale.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"int8 encode {name}: CUDA error {rc}")
        if name == "kernel":
            run()
            q_ref, s_ref = ref.cold_encode_ref(X, "int8", segs)
            cs._same_bits(q, q_ref, "int8 encode q")
            cs._same_bits(scale, s_ref, "int8 encode scale")
            del q_ref, s_ref
        out[name] = cs.time_ms(run)
    out["torch copy of the slab"] = cs.time_ms(
        lambda: torch.empty_like(X).copy_(X))
    return out


def casts(libs, dev) -> dict:
    """The f16 casts at the slab, both ways; the committed kernel also at
    the one-half f16 access its plan falls back to (on aligned pointers,
    so only the access width differs); beside Tensor.to."""
    S, T = cs.SLAB_ROWS, cs.FEMNIST_T
    X = torch.randn((S, T), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    q = X.to(torch.float16)
    H, F = torch.empty_like(q), torch.empty_like(X)
    stream = torch.cuda.current_stream().cuda_stream
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    out = {}
    for name, lib in libs.items():
        fn = lib.cold_cast_launch
        fn.argtypes = [p, p, ll, i, i, ll, p]
        fn.restype = ctypes.c_int
        for halves in (4, 1) if name == "kernel" else (4,):
            def run(src, dst, to_half, fn=fn, halves=halves):
                rc = fn(src.data_ptr(), dst.data_ptr(), src.numel(),
                        to_half, halves, 0, stream)
                if rc:
                    raise RuntimeError(f"f16 cast {name}: CUDA error {rc}")
            run(X, H, 1)
            run(q, F, 0)
            cs._same_bits(H, q, f"f16 encode {name} {halves}")
            cs._same_bits(F, q.to(torch.float32),
                          f"f16 decode {name} {halves}")
            label = name if halves == 4 else (
                f"{name}, one half an f16 access")
            out[f"encode, {label}"] = cs.time_ms(lambda: run(X, H, 1))
            out[f"decode, {label}"] = cs.time_ms(lambda: run(q, F, 0))
    out["Tensor.to(torch.float16)"] = cs.time_ms(
        lambda: X.to(torch.float16))
    out["Tensor.to(torch.float32)"] = cs.time_ms(
        lambda: q.to(torch.float32))
    return out


#: (kind, source, cuts, timing function) of each kernel
KERNELS = (("gossip_mix", "gossip_mix.cu", GOSSIP_CUTS, gossip),
           ("flash_attention", "flash_attention.cu", ATTENTION_CUTS,
            attention),
           ("flash_attention_bwd", "flash_attention_bwd.cu",
            ATTENTION_BWD_CUTS, attention_bwd),
           ("ssd_intra_chunk", "ssd_scan.cu", SSD_CUTS, ssd),
           ("ssd_scan_bwd", "ssd_scan_bwd.cu", SSD_BWD_CUTS, ssd_bwd),
           ("int8 encode", "cold_codec.cu", ENCODE_CUTS, encode),
           ("f16 casts", "cold_codec.cu", CAST_CUTS, casts))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kinds = sys.argv[1:] or [kind for kind, _, _, _ in KERNELS]
    unknown = set(kinds) - {kind for kind, _, _, _ in KERNELS}
    if unknown:
        print(f"kernel_ablations: no kernel kind {sorted(unknown)}",
              file=sys.stderr)
        return 2
    kernels = [k for k in KERNELS if k[0] in kinds]
    jobs = [(kind, name, source, cuts_)
            for kind, source, cuts, _ in kernels
            for name, cuts_ in [("kernel", [])] + list(cuts.items())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(
            lambda j: build(re.sub(r"[^A-Za-z0-9]+", "_",
                                   f"{j[0]}_{j[1]}"), j[2], j[3]), jobs))
    libs = {kind: {} for kind, _, _, _ in kernels}
    for (kind, name, _, _), lib in zip(jobs, built):
        libs[kind][name] = lib
    result = {}
    for kind, _, _, timing in kernels:
        result[kind] = timing(libs[kind], dev)
        torch.cuda.empty_cache()
        for name, t in result[kind].items():
            print(f"[ablations] {kind} {name}: {t}", flush=True)
    result["card"] = cs.card_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
