#!/usr/bin/env python3
"""What each part of the port's gossip-mix (B1) and flash-attention (B4)
kernels costs, on one NVIDIA GPU.

  python3 kernel_ablations.py

Builds variants of ``src/repro_torch/kernels/csrc/gossip_mix.cu`` and
``flash_attention.cu`` with one part of the work taken out (by text
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    cdims, 1, stream)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    jobs = [("gossip_mix", "kernel", "gossip_mix.cu", [])]
    jobs += [("gossip_mix", name, "gossip_mix.cu", cuts)
             for name, cuts in GOSSIP_CUTS.items()]
    jobs += [("flash_attention", "kernel", "flash_attention.cu", [])]
    jobs += [("flash_attention", name, "flash_attention.cu", cuts)
             for name, cuts in ATTENTION_CUTS.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(
            lambda j: build(f"{j[0]}_{j[1]}".replace(" ", "_").replace(
                "^", ""), j[2], j[3]), jobs))
    libs = {"gossip_mix": {}, "flash_attention": {}}
    for (kind, name, _, _), lib in zip(jobs, built):
        libs[kind][name] = lib
    result = {"gossip_mix": gossip(libs["gossip_mix"], dev)}
    torch.cuda.empty_cache()
    result["flash_attention"] = attention(libs["flash_attention"], dev)
    for kind, times in result.items():
        for name, t in times.items():
            print(f"[ablations] {kind} {name}: {t}", flush=True)
    result["card"] = cs.card_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
