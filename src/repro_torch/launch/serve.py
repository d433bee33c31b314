"""Batched serving driver of the port (``repro.launch.serve``): prefill a
batch of prompts, then decode tokens greedily with the per-family KV/SSM
cache. Runs on the CUDA card unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --reduced --device cpu

Every arch of ``repro_torch.configs`` serves. As in the reference, the
prompt fills the cache through decode steps (one token at a time), so
neither kernel of the full-sequence forward runs here, and an
encoder-decoder model (whisper-medium) decodes against the zero
cross-attention cache that ``init_decode_cache`` makes. Weights are
random, from seed 0; everything runs under ``torch.inference_mode()``.
``--num-layers N`` cuts the depth at full width, for a model one card
cannot hold (mixtral-8x7b's experts are 93 GB in bf16; llama4-maverick
counts its (dense, MoE) pairs as 2 layers each).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_model_config
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the (decoder) depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.prompt_len + args.decode_tokens > args.max_seq:
        ap.error("--prompt-len + --decode-tokens exceeds --max-seq")

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    with torch.inference_mode():
        gen = torch.Generator(device).manual_seed(0)
        params = mdl.init_model(gen, cfg, device)
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
        cache = mdl.init_decode_cache(cfg, args.batch, args.max_seq,
                                      device=device)
        _sync(device)

        t0 = time.perf_counter()
        logits = None
        for i in range(args.prompt_len):
            logits, cache = mdl.decode_step(cfg, params, cache,
                                            prompts[:, i:i + 1], i)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        toks = logits[:, -1].argmax(-1)[:, None]
        out = [toks]
        t0 = time.perf_counter()
        for i in range(args.decode_tokens):
            logits, cache = mdl.decode_step(cfg, params, cache, toks,
                                            args.prompt_len + i)
            toks = logits[:, -1].argmax(-1)[:, None]
            out.append(toks)
        _sync(device)
        t_decode = time.perf_counter() - t0
        gen_ids = torch.cat(out, dim=1).cpu()

    tok_s = args.decode_tokens * args.batch / max(t_decode, 1e-9)
    prefill_tok_s = args.prompt_len * args.batch / max(t_prefill, 1e-9)
    print(f"arch={cfg.name} layers={cfg.num_layers} batch={args.batch} "
          f"device={device}")
    print(f"prefill: {args.prompt_len} steps in {t_prefill:.2f}s "
          f"({prefill_tok_s:.1f} tok/s)")
    print(f"decode:  {args.decode_tokens} tokens in {t_decode:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print("sample token ids:", gen_ids[0, :16].tolist())
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "prefill_tok_s": prefill_tok_s, "decode_tok_s": tok_s,
            "tokens": gen_ids, "finite": bool(torch.isfinite(
                logits.float()).all())}


if __name__ == "__main__":
    main()
