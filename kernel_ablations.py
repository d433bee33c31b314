#!/usr/bin/env python3
"""What each part of the port's gossip-mix (B1), flash-attention (B4),
SSD intra-chunk (B5) and int8 cold-encode (B2) kernels costs, on one
NVIDIA GPU.

  python3 kernel_ablations.py

Builds variants of ``src/repro_torch/kernels/csrc/gossip_mix.cu``,
``flash_attention.cu``, ``ssd_scan.cu`` and ``cold_codec.cu`` with one part of the work taken out (by text
substitution of the committed sources, into a scratch build directory
under ``src/repro_torch/kernels/_build/``), and times each at the main
path's shapes beside the committed kernel, CUDA events, median of 20:

- B1, the 64 x 64 in-place boundary and the 8 x 64 projection at the
  FEMNIST CNN's T = 6,603,710 (f32): without the tensor-core products,
  without the stores, without both (the loads alone); beside PyTorch's
  copy of the bank and of the same rows two columns in (rows 8 bytes off
  16-byte alignment, as the bank's odd rows are);
- B4 at the Zamba2-2.7B prefill shape (2, 4096, 32 x 80, bf16, causal):
  without the softmax (probabilities left as raw scores), without the
  second (lo) P V pass, without Q K^T.

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


#: (kind, source, cuts, timing function) of each kernel
KERNELS = (("gossip_mix", "gossip_mix.cu", GOSSIP_CUTS, gossip),
           ("flash_attention", "flash_attention.cu", ATTENTION_CUTS,
            attention),
           ("ssd_intra_chunk", "ssd_scan.cu", SSD_CUTS, ssd),
           ("int8 encode", "cold_codec.cu", ENCODE_CUTS, encode))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    jobs = [(kind, name, source, cuts_)
            for kind, source, cuts, _ in KERNELS
            for name, cuts_ in [("kernel", [])] + list(cuts.items())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(
            lambda j: build(re.sub(r"[^A-Za-z0-9]+", "_",
                                   f"{j[0]}_{j[1]}"), j[2], j[3]), jobs))
    libs = {kind: {} for kind, _, _, _ in KERNELS}
    for (kind, name, _, _), lib in zip(jobs, built):
        libs[kind][name] = lib
    result = {}
    for kind, _, _, timing in KERNELS:
        result[kind] = timing(libs[kind], dev)
        torch.cuda.empty_cache()
        for name, t in result[kind].items():
            print(f"[ablations] {kind} {name}: {t}", flush=True)
    result["card"] = cs.card_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
