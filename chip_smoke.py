#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. build      — compile every CUDA kernel source from
                 ``src/repro_torch/kernels/csrc`` for sm_90a and print
                 the card's name and power limit, then ptxas's
                 registers, shared memory and spills for every kernel
                 instantiation of every source (and any ptxas warning).
2. kernels    — hold each kernel against its plain PyTorch version on
                 the card, then time kernel, plain version and (where
                 one exists) one library call:
                 ``gossip_mix`` at the reference sweep shapes (in place
                 and out, f32 and bf16), at n = 64 with T at 0, 1, 2 and
                 3 mod 4 (in place, 8 bytes off an aligned address, and
                 the 8 x 64 projection; f32 and bf16), and at the main
                 path's shapes;
                 the cold codec (int8 and f16, encode and decode) at the
                 reference's codec rows and at the streamed slab's
                 (64, 6,603,710) FEMNIST-CNN shape, bit for bit, plus 8
                 full-width rows against the host numpy codec; int8
                 rows with segments at the encode's one-block threshold,
                 one past it, and one too wide for the grid to hold on
                 chip; the blocked int8 quantizer on the codec's kernel.
                 Then flash attention (B4) over the reference's sweep,
                 at D = 80 through the GQA adapter (strided views of one
                 fused projection, ragged Sq and Sk, a window, a
                 q_offset), its refusal of the bf16 layouts its tensor
                 maps cannot describe (D = 72, a 2-byte offset, a
                 stride-0 axis), and at the Zamba2 prefill shape (2 x
                 4096 tokens, 32 heads of 80, bf16, causal), and
                 the SSD intra-chunk block (B5, both outputs) over the
                 reference's sweep, its refusal of a misaligned bf16 x,
                 and at the prefill shape (32 chunks of 256, 80 heads,
                 P = N = 64), also through both adapters of ``ssd_chunked``
                 (y only; y and the chunk states) in the model's strided
                 layout; each timed beside its plain
                 version (and B4 beside one
                 ``scaled_dot_product_attention`` call). B4 also at the
                 seven attention shapes of the MoE, encoder-decoder and
                 VLM prefills (FA_FAMILY_PATHS), with its bound over the
                 pairs the mask lets through. B4's backward
                 (``csrc/flash_attention_bwd.cu``) against
                 ``flash_attention_bwd_ref``, driven as training drives it
                 (``torch.autograd.grad`` through ``flash_attention_bshd``),
                 the forward's logsumexp first held against
                 ``flash_attention_lse_ref`` (atol = rtol 1e-5) and the
                 plain backward given the plain forward's o and no
                 logsumexp: f32 over the reference's sweep (atol = rtol
                 1e-4), f32 and bf16 through the GQA adapter (q_offset,
                 window, non-causal, D = 80 strided views with ragged Sq
                 and Sk; bf16 within 2e-2 of each gradient's largest
                 entry), and bf16 at qwen2-0.5b's training shape (4 x
                 2048, 14 / 2 heads of 64, causal), two runs bit for bit
                 (no atomics), timed beside the plain version and the
                 SDPA backward, and its device time by kernel; then
                 bf16 at the seven FA_FAMILY_PATHS shapes (D = 128,
                 windows, non-causal, cross; the plain version a batch
                 row's kv group at a time where its scores pass 8 GB)
                 and at the training shapes of 7d and 7f they lack
                 (FA_BWD_TRAIN_PATHS; 7f's rank shapes also in f32 and
                 the forward's output, FA_TP_PATHS, and the reduced
                 rounds' in f32, FA_TP_REDUCED), each timed beside the
                 SDPA backward. B5's backward (``csrc/ssd_scan_bwd.cu``,
                 phase 2d) through ``torch.autograd.grad`` of
                 ``ssd_intra_chunk`` against ``ssd_intra_chunk_bwd_ref``
                 over SSD_BWD_SWEEP (C 64-256, N 16-128, P 32-128, the
                 reduced configs' (64, 16, 64), one head group to a
                 group a head), f32 and bf16, with and without a states
                 gradient (f32 within 1e-4, bf16 2e-2 of each gradient's
                 largest entry), then bf16 at phase 7e's two training
                 shapes and 7f's rank shape of 40 heads (forward and
                 backward, bf16 and f32; the reduced rounds' in f32),
                 also through ``make_intra_states_fn`` in the
                 model's strided layout, two runs bit for bit, timed by
                 kernel beside its bound and its plain version (no
                 library call computes it), its workspace logged (at
                 most 0.1 GB at mamba2-2.7b's shape, asserted). The
                 backwards run through ``torch.autograd.grad`` and are
                 timed by the profiler's device time (``device_ms``).
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
5. scenario   — the same FEMNIST configuration under ``mobile_sampled``
                 with ``chaos`` faults (seeds 7 and 3, 3 rounds, whose
                 keyed fault trace holds a dark cluster, a dropped link
                 and a timed-out device: asserted before the run),
                 through ``run_wall_clock``: per round the card seconds,
                 the cohort k, its bucket k_pad and the path (compacted
                 or flat), the dark clusters, loss, accuracy and peak
                 memory; gossip_mix launches equal the lowering plans'
                 mixing groups plus one projection an evaluation, and the
                 rows of every live cluster agree within 1e-6 after the
                 trailing boundary; the last round under the profiler.
6. async      — the same configuration over a ``lognormal`` fleet, two
                 bounded-staleness rounds at s = 2 (events, card seconds,
                 one gossip_mix launch an event, every realized edge
                 within the bound, the simulated makespan beside the
                 barrier's), then one s = 0 round against the barrier
                 round with compaction off: bit for bit on the card.
7. lm         — Zamba2-2.7B at full width (2,422,670,240 params, bf16,
                 random weights from a seeded generator on the card): one
                 prefill forward of 2 x 4096 tokens (9 B4 and 54 B5
                 launches, finite logits), a second under the profiler
                 (device time by kernel), then the port's serve driver at
                 the reference's defaults (batch 4, prompt 32, 16 decoded
                 tokens, max-seq 256).
7b. lm_families — mixtral-8x7b (8 of its 32 layers), llama4-maverick
                 (1 of its 24 (dense, MoE) pairs), whisper-medium and
                 pixtral-12b at full width (bf16, seeded generator on
                 the card), one at a time: a prefill forward (B4
                 launches as the config counts, finite logits, each MoE
                 layer's dropped assignments, peak memory), a second
                 under the profiler (B4, GEMMs, the rest; device busy
                 share), then the serve driver at the reference's
                 defaults.
7c. lm_train — federated LM training (``core/sharded.py``
                 ``ShardedCEFedAvg``) of qwen2-0.5b at full width and
                 depth (494,147,456 bf16 params, seeded generator on the
                 card): (a) one rank, 3 rounds of the launcher's defaults
                 (tau 2, q 2, pi 4, SGD momentum 0.9 at lr 0.05) at 4 x
                 2048 on the example's learnable stream: seconds, local-
                 step tokens a second, loss and peak a round; B4 forward
                 and backward launches, 24 + 24 a local step (asserted);
                 the loss of a held-out batch must fall; one local step
                 under the profiler (B4 forward, backward: every kernel
                 named flash_attention_bwd_*, GEMMs, the rest, busy
                 share).
                 (b) 4 gloo ranks sharing the card, one full-width
                 replica each in 2 clusters x 2, one dense and one
                 ringweight round at 2 x 1024: round seconds (max over
                 ranks), a rank's bytes by collective, peak by rank. (c)
                 2 of the 24 layers at full width in f32: one round on
                 the card against the CPU within 1e-4 (TF32 off).
7d. lm_train_families — the same trainer and launcher defaults for
                 whisper-medium (whole, 2 x (1500 frames + 448 tokens)),
                 mixtral-8x7b (3 of 32 layers, 1 x 8192, window 4096)
                 and pixtral-12b (12 of 40 layers, 1 x (1024 patches +
                 3072 tokens)) at full width, bf16 from a seeded
                 generator on the card (the cuts: LM_TRAIN_FAMILIES),
                 one replica in a world of one, 2 rounds each: params
                 (asserted) and GB after init, that the launcher's
                 expanded frames and patches reach the model dense,
                 seconds, local-step positions a second, loss and peak
                 a round, a held-out batch's loss before and after
                 (must fall), mixtral's dropped assignments a MoE layer
                 in the first step, B4 forward and backward launches a
                 local step (72 + 72, 3 + 3, 12 + 12: asserted) at no
                 shape phase 2c did not check (asserted), what is live
                 at the allocator's peak of the first round and of a
                 local step (mixtral, pixtral), one profiled local step
                 by part. Then one f32 round on the card against
                 the CPU within 1e-4 (TF32 off) for whisper-medium at
                 full width and 2 + 2 layers and for the reduced
                 mixtral, llama4-maverick and pixtral, B4's launches
                 asserted (none on the CPU).
7e. lm_train_ssm — the same trainer and defaults, remat on, for
                 mamba2-2.7b (all 64 layers, 2,832,074,240 params, 4 x
                 2048 tokens a step) and zamba2-2.7b (all 54 layers, 9
                 groups of 6 Mamba-2 blocks and the shared attention
                 block, 2 x 4096) at full width, bf16 from a seeded
                 generator on the card, 2 rounds each: params
                 (asserted), seconds, local-step tokens a second, loss
                 and peak a round, a held-out loss that must fall, B5's
                 forward and backward launches (2 + 1 a Mamba-2 block
                 and step) and zamba2's B4 launches (2 + 1 a group) at
                 shapes 2c checked (asserted), one profiled step by part
                 (glue, GEMMs, B4, B5, each backward); a bf16 step at
                 reduced depth with and without remat, bit for bit; one
                 f32 round of each reduced config on the card against
                 the CPU within 1e-4.
7f. lm_train_tp — tensor parallelism within a replica
                 (``--model-parallel``) over gloo ranks sharing the
                 card: qwen2-0.5b whole at dp 2 x mp 2 (4 ranks, 2 x
                 1024) beside dp 2 x mp 1 from the same seed,
                 zamba2-2.7b whole at mp 2 (remat, 1 x 4096) and
                 mixtral-8x7b at 3 of 32 layers at mp 2 (1 x 8192), 2
                 rounds each at the launcher's defaults: params a rank,
                 round seconds (max over ranks), a rank's bytes by group
                 (model, data) and collective, peak by rank, B4's and
                 B5's launches a step (asserted), every launch at a
                 shape phases 2c and 2d held in its dtype (asserted), a
                 held-out loss that must fall; then one reduced f32
                 round of every family at dp 2 x mp 2 against dp 2 x mp
                 1 on the card within 1e-4 (TF32 off). The round times
                 are gloo's through host memory, not NCCL's.
8. lm decode  — the same model in f32: the kernel forward's logits over
                 2 x 512 tokens against 512 decode steps (no kernel),
                 within the reference's atol = rtol = 0.05; then the
                 reduced mixtral, llama4 and whisper likewise over 2 x
                 128 tokens (MoE capacity never binding: 0 drops).
9. upload     — the FEMNIST configuration at full width with uploading
                 devices, two rounds each of int8 (stochastic rounding)
                 with error feedback, top-k 5% with error feedback and
                 local DP (clip 1.0, sigma 0.5), through
                 ``run_wall_clock``: per round the card seconds, the
                 card seconds of the random draws and of the
                 compression (or clipping and noise) on lines of their
                 own, gossip_mix launches (the upload plan's 9 mixing
                 groups plus one projection an evaluation), loss,
                 accuracy, peak memory and the residual's norm; finite
                 losses and cluster-synced rows after the trailing
                 boundary for int8 and top-k. The DP rounds diverge by
                 construction at this width (noise norm sigma * sqrt(T)
                 against a clip of 1): their losses are reported, and the
                 DP transform is held to its mechanism on a full-width
                 (64, T) update (rows clipped to the bound, noise of mean
                 0 and std sigma, a different draw a row).
10. resume    — kill and resume at full width, bit for bit (cuDNN
                 deterministic): the resident int8+EF run, 3 rounds
                 against 2 + save + fresh sim + restore + 1 (params,
                 momentum, residual, history), and the pipelined
                 population of 10,000 with an int8 store likewise
                 (global model, store bytes, history); each checkpoint's
                 size on disk and its save and restore seconds (written
                 to a temporary directory, removed afterwards).
10b. sharded  — the device-parallel bank engine (``core/sharded.py``):
                 8 rank processes of one gloo world share the card, each
                 holding one full-width FEMNIST-CNN bank row (the
                 configuration's tau, q, pi on a ring, its fleet cut to 4
                 clusters x 2 devices, lr 0.01; a last static round at
                 the configuration's lr 0.1 shows both engines diverge
                 there), cuDNN deterministic in every engine: one block
                 (static, and under ``mobile_sampled`` with ``chaos``
                 faults), 2 static rounds, 2 under ``mobile_sampled`` +
                 ``chaos``, 1 depth-3 (2, 2, 2) round and 1 async round
                 at s = 2. Every round within 2e-4 of the single-process
                 engine on the card from the same seeds, taking its SGD
                 steps one row at a time and summing each boundary in
                 the sharded lowering's order, as the ranks do; one
                 block also of the engine as it stands, whose gap over
                 whole rounds is printed beside its two causes (its
                 n-row vmap against one row at a time, B1 against the
                 lowering's order of sums). Every boundary lowering
                 within 2e-4 of B1 on the same rows; per round the
                 seconds (max over ranks: gloo on one card, rows staged
                 through host memory, not a multi-card speed) and a
                 rank's bytes by collective; each rank's peak memory;
                 (1, T) rows on every rank, no gather in the static and
                 depth-3 rounds, no kernel launch.
                 Every phase starts by collecting the earlier phases'
                 garbage and printing what is still allocated.
11. parity    — the quickstart configuration for one round, the small
                 population configuration of the CPU tests (f32,
                 pipelined) for two; at its geometry a compacted
                 scenario with chaos faults, the enumerated streamed
                 engine pipelined under outages, an ``adaptive_tau``
                 schedule, two async rounds at s = 2, one int8+EF upload
                 round (within the int8 tolerance) and one DP round; the
                 device threefry bits against the host's at (64, 2^20 +
                 3), bit for bit; and the reduced Zamba2, mixtral,
                 llama4, whisper and pixtral forwards (f32; kernels on
                 the card, plain on the CPU), on the card and on the
                 CPU; they must agree (TF32 off).

The line before the last two is ``{"kernels": [...]}``; the card's
``name, power.limit`` (from nvidia-smi) follows, and the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
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

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, FP32 FLOP/s
#: on the CUDA cores, and bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: kernel tolerances (the reference's own, tests/test_kernels.py)
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
#: card against CPU after one quickstart round (observed 1.2e-7 on params,
#: 2.0e-6 on momentum: f32 sums in different orders)
PARITY_ATOL = 1e-5
SWEEP = ((8, 5000), (16, 4096), (64, 1000), (4, 123))
#: bank widths at 0, 1, 2 and 3 mod 4
RESIDUE_T = (200_000, 200_001, 200_002, 200_003)
FEMNIST_T = 6_603_710
#: the reference's codec rows (tests/test_kernels.py): irregular segments
CODEC_SEGMENTS = ((0, 100), (100, 37), (137, 263))
#: the streamed slab of the population phase: 56 cohort + 8 representatives
SLAB_ROWS = 64
#: flash attention against its plain version: the reference's own sweep
#: and tolerances (tests/test_kernels.py, absolute)
FA_SWEEP = ((4, 256, 256, 64), (2, 200, 200, 64), (2, 128, 384, 128),
            (1, 512, 512, 64), (3, 130, 257, 128))
FA_MASKS = ((True, 0), (False, 0), (True, 100))
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: at the prefill shape both sides read the same bf16 inputs and sum in
#: f32 (the kernel holds p to about 2^-16), then round the output to bf16:
#: they may differ by one bf16 step of the output's size, 2^-7 of it
FA_PATH_ATOL, FA_PATH_RTOL = 1e-3, 2.0 ** -7
#: SSD intra-chunk block: the reference's sweep and tolerances (absolute
#: and relative, both outputs); at the prefill shape both sides read the
#: same bf16 inputs and sum in f32, so only the order of the sums differs
SSD_SWEEP = ((4, 3, 128, 64, 32), (2, 5, 256, 64, 128), (1, 2, 128, 128, 64))
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.15}
SSD_PATH_TOL = 1e-3
#: the Zamba2-2.7B prefill of the lm phase, and its parameter count
LM_BATCH, LM_SEQ = 2, 4096
ZAMBA2_PARAMS = 2_422_670_240
#: prefill forward against decode steps at f32: the reference's own bound
#: for that property (tests/test_models.py)
DECODE_TOL = 0.05
DECODE_SEQ = 512
#: reduced Zamba2 forward, card (kernels) against CPU (plain) at f32:
#: sums in other orders over 4 Mamba-2 blocks and 2 attention layers
LM_PARITY_TOL = 1e-4
#: B4's backward: f32 within 1e-4 (atol = rtol) of its plain version over
#: the reference's sweep; bf16 within 2e-2 of each gradient's largest
#: entry (P and dS rounded to bf16 before their second product)
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the name every kernel of B4's backward starts with
#: (csrc/flash_attention_bwd.cu), which the step profile files them by
BWD_KERNEL_PREFIX = "flash_attention_bwd_"
#: B4's backward at the FA_FAMILY_PATHS shapes: a check whose plain
#: version's f32 scores (B x H x Sq x Sk) would pass this many bytes
#: runs on batch 1 and one kv head's query heads
FA_BWD_CHECK_BYTES = 8e9
#: B4's forward logsumexp (f32 for either input type; the scores are f32
#: sums of exact products) against its plain version, atol = rtol
FA_LSE_TOL = 1e-5
#: the federated LM training phase: qwen2-0.5b at full width and depth
#: (configs/qwen2_0p5b.py), the launcher's defaults (tau 2, q 2, pi 4,
#: SGD momentum 0.9 at lr 0.05) on the example's learnable stream
LM_TRAIN_ARCH = "qwen2-0.5b"
LM_TRAIN_PARAMS = 494_147_456
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_ROUNDS = 4, 2048, 3
#: (b): gloo ranks sharing the card, one full-width replica each, in 2
#: clusters x 2, one round a backend
LM_TRAIN_RANKS, LM_TRAIN_RANK_BATCH, LM_TRAIN_RANK_SEQ = 4, 2, 1024
#: (c): card against CPU, 2 of the 24 layers at full width in f32
LM_TRAIN_PARITY_LAYERS, LM_TRAIN_PARITY_SEQ = 2, 256
#: phase 7d: federated training of the MoE, encoder-decoder and VLM
#: families at full width (bf16, seeded generator on the card), one
#: replica in a world of one at the launcher's defaults: arch -> (layers
#: run, None for all; batch; text tokens a row; params, asserted).
#: A local step peaks at the SGD update, 12 bytes a parameter (bf16
#: params and grads, f32 mu and the f32 update tree ``lr * mu``):
#: whisper-medium is whole (9.7 GB), and mixtral-8x7b (1,451,270,144
#: params a layer, 262,148,096 outside) is cut to 3 of 32 layers (55.4
#: GB; 4 would need 72.8). A round peaks higher (what is live at both
#: peaks, the phase prints): 64.7 GB for mixtral, and 72.8 GB for
#: pixtral-12b at 14 layers (272,640,000 params a layer, 1,368,396,800
#: outside; 62.2 GB at the update), whose second round then ran out of
#: memory with 11.7 GiB cached in pieces too small for the update's 2.5
#: GiB embedding leaf. So pixtral is cut to 12 of 40 layers, 55.7 GB at
#: the update, where mixtral's 55.4 GB trained with room (PERF.md
#: section 4)
LM_TRAIN_FAMILIES = {
    "whisper-medium": (None, 2, 448, 811_569_152),
    "mixtral-8x7b": (3, 1, 8192, 3 * 1_451_270_144 + 262_148_096),
    "pixtral-12b": (12, 1, 3072, 12 * 272_640_000 + 1_368_396_800),
}
LM_TRAIN_FAMILY_ROUNDS = 2
#: (c) card against CPU in f32, one round each: arch -> (layers at full
#: width (encdec: encoder and decoder), None for the reduced config;
#: batch; text tokens a row). whisper at full width and 2 + 2 layers; at
#: full width the others' f32 state would pass 20 GB of host memory, so
#: they run reduced (llama4's reduced window of 64 binds at 128 tokens)
LM_TRAIN_FAMILY_PARITY = {
    "whisper-medium": (2, 1, 256),
    "mixtral-8x7b": (None, 2, 128),
    "llama4-maverick-400b-a17b": (None, 2, 128),
    "pixtral-12b": (None, 2, 120),
}
#: the MoE, encoder-decoder and VLM prefills at full width: arch ->
#: (layers run, None for all; batch; text tokens). mixtral's 32 layers
#: of experts (93 GB in bf16) and llama4-maverick's 24 (dense, MoE)
#: pairs (32.2 GB of experts a pair) are cut to what one card holds;
#: whisper-medium and pixtral-12b run whole (pixtral: 1024 patches +
#: 3072 tokens = 4096 positions)
LM_FAMILIES = {
    "mixtral-8x7b": (8, 1, 8192),
    "llama4-maverick-400b-a17b": (2, 2, 4096),
    "whisper-medium": (None, 2, 448),
    "pixtral-12b": (None, 2, 3072),
}
#: B4 at those prefills' shapes: (what, B, Sq, Sk, H, Hkv, D, causal,
#: window)
FA_FAMILY_PATHS = (
    ("mixtral-8x7b", 1, 8192, 8192, 32, 8, 128, True, 4096),
    ("llama4 dense, window 8192", 2, 4096, 4096, 40, 8, 128, True, 8192),
    ("llama4 MoE layer", 2, 4096, 4096, 40, 8, 128, True, 0),
    ("whisper encoder", 2, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper decoder", 2, 448, 448, 16, 16, 64, True, 0),
    ("whisper cross", 2, 448, 1500, 16, 16, 64, False, 0),
    ("pixtral-12b", 2, 4096, 4096, 32, 8, 128, True, 0),
)
#: B4's backward also at the shapes phase 7d trains at that
#: FA_FAMILY_PATHS lacks (7d asserts it launches no other): pixtral-12b
#: trains at batch 1, where the backward takes another launch than at
#: batch 2 (``heads_per_block`` in csrc/flash_attention_bwd.cu: one
#: query head a dK/dV block, the f32 partials of a kv head's four summed
#: by the third kernel)
#: phase 7f's tensor-parallel training attends at each rank's heads:
#: qwen2-0.5b's 14 / 2 split to 7 / 1 (and its dp 2 x mp 1 world beside
#: it at 2 x 1024), zamba2-2.7b's shared block 32 / 32 to 16 / 16 and
#: mixtral-8x7b's 32 / 8 to 16 / 4; held in bf16 and f32, the forward's
#: output too (``_fa_tp_paths``)
FA_TP_PATHS = (
    ("qwen2-0.5b mp 2", 2, 1024, 1024, 7, 1, 64, True, 0),
    ("qwen2-0.5b mp 1 at 2 x 1024", 2, 1024, 1024, 14, 2, 64, True, 0),
    ("zamba2-2.7b mp 2", 1, 4096, 4096, 16, 16, 80, True, 0),
    ("mixtral-8x7b mp 2", 1, 8192, 8192, 16, 4, 128, True, 4096),
)
FA_BWD_TRAIN_PATHS = (
    ("pixtral-12b training", 1, 4096, 4096, 32, 8, 128, True, 0),
    ("zamba2-2.7b training", 2, 4096, 4096, 32, 32, 80, True, 0),
) + FA_TP_PATHS
#: B5's backward (csrc/ssd_scan_bwd.cu) against its plain version: f32
#: within 1e-4 (rtol, and atol 1e-4 of each gradient's largest entry:
#: both sides sum in f32 in other orders, and da, a reverse cumulative
#: sum of differences, has entries near 0 beside entries of hundreds);
#: bf16 within 2e-2 of each gradient's largest entry (dx, dB and dC are
#: rounded to bf16 on both sides from f32 sums in other orders)
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the sweep (BK, H, C, P, N): the forward's, the kernel's other C, N
#: and P, and the reduced configs' (64, 16, 64); then the head groups of
#: the tiles kernel (``head_groups`` in csrc/ssd_scan_bwd.cu: the fewest
#: that leave 528 blocks): one group of two heads (132 chunks of 4
#: column tiles), and four uneven groups of 1, 2, 2 and 2 heads (33
#: chunks); the shapes above take a group a head, the training shapes 5
#: groups of 16
SSD_BWD_SWEEP = SSD_SWEEP + ((2, 4, 64, 64, 16), (2, 4, 192, 32, 32),
                             (1, 3, 256, 128, 128), (3, 2, 64, 32, 64),
                             (132, 2, 256, 64, 16), (33, 7, 256, 32, 64))
#: the workspace B5's backward may take at mamba2-2.7b's training shape
SSD_BWD_MAX_WORKSPACE = 0.1e9
#: the shapes phase 7e trains at: (B, K, C, H, P, N) of each arch
SSD_BWD_TRAIN_PATHS = {"mamba2-2.7b": (4, 8, 256, 80, 64, 128),
                       "zamba2-2.7b": (2, 16, 256, 80, 64, 64),
                       # phase 7f: the rank's 40 of 80 heads at 1 x
                       # 4096, in 9 uneven head groups (4 and 5 heads)
                       "zamba2-2.7b mp 2": (1, 16, 256, 40, 64, 64)}
#: phase 7f's reduced f32 rounds (B = 2, 128 positions a row) at mp 1
#: and mp 2: B4 at (B, Sq, Sk, causal, window) for each (H, Hkv) of the
#: reduced configs' 4 / 2 heads of 64 and a rank's 2 / 1 (the dense,
#: MoE, hybrid and VLM self-attention; the whisper encoder's 32 frames,
#: its decoder and cross attention; mixtral's and llama4's reduced
#: window of 64), and B5 at (BK, H, C, P, N) for the 8 and 4 SSD heads
#: (2 chunks of 64 a row); held in f32 (``_fa_tp_paths``,
#: ``_ssd_tp_paths``)
LM_TP_PARITY_B, LM_TP_PARITY_S = 2, 128
FA_TP_REDUCED = tuple(
    (f"reduced {h}/{hk} heads", LM_TP_PARITY_B, sq, sk, h, hk, 64, causal,
     window)
    for h, hk in ((4, 2), (2, 1))
    for sq, sk, causal, window in ((128, 128, True, 0), (128, 128, True, 64),
                                   (32, 32, False, 0), (128, 32, False, 0)))
SSD_TP_REDUCED = tuple((LM_TP_PARITY_B * 2, h, 64, 64, 16) for h in (8, 4))
#: the name every kernel of B5's backward starts with
SSD_BWD_KERNEL_PREFIX = "ssd_scan_bwd_"
#: phase 7e: federated training of the ssm and hybrid families at full
#: width and depth (bf16, seeded generator on the card), one replica in a
#: world of one at the launcher's defaults, remat on: arch -> (batch,
#: tokens a row, params, asserted). A step peaks at the SGD update, 12
#: bytes a parameter (34.0 and 29.1 GB), and without remat the saved
#: activations of 64 (54) layers at 8,192 tokens a step would pass the
#: card; with it a layer's own are live only inside its recomputation
LM_TRAIN_SSM = {
    "mamba2-2.7b": (4, 2048, 2_832_074_240),
    "zamba2-2.7b": (2, 4096, ZAMBA2_PARAMS),
}
LM_TRAIN_SSM_ROUNDS = 2
#: the remat check: layers of a bf16 step at full width, with and
#: without remat (zamba2: one group of 6 Mamba-2 blocks and the shared
#: attention block)
LM_TRAIN_SSM_REMAT_LAYERS = {"mamba2-2.7b": 2, "zamba2-2.7b": 6}
#: phase 7f: tensor parallelism within a replica (``--model-parallel``),
#: gloo ranks sharing the card: (what, arch, data, model, layers run
#: (None for all), batch, tokens a row, remat). qwen2-0.5b whole at 7c
#: (b)'s 2 x 1024 (4 ranks: 7c (a)'s 4 x 2048 would not leave memory for
#: 4), beside dp 2 x mp 1 from the same seed; zamba2-2.7b whole with
#: remat at 1 x 4096 (each rank moves every layer's activations through
#: host memory twice a step); mixtral-8x7b at 3 of 32 layers, 1 x 8192,
#: phase 7d's cut: 12 bytes a parameter at the update over (262,148,096
#: + 3 x 1,451,270,144) / 2 params a rank is 27.7 GB a rank, and a round
#: peaks at about 14 (a mixed bf16 tree more: 22.2 GB a rank at 2 layers
#: on an H100 80GB HBM3 at 700 W), 32 GB a rank, 65 GB for both. At 2
#: layers the held-out loss rose there (10.8930 -> 10.9040); at 3 it is
#: phase 7d's model from the same seed
LM_TP_RUNS = (
    ("qwen2-0.5b dp 2 x mp 2", "qwen2-0.5b", 2, 2, None, 2, 1024, False),
    ("qwen2-0.5b dp 2 x mp 1", "qwen2-0.5b", 2, 1, None, 2, 1024, False),
    ("zamba2-2.7b dp 1 x mp 2", "zamba2-2.7b", 1, 2, None, 1, 4096, True),
    ("mixtral-8x7b dp 1 x mp 2", "mixtral-8x7b", 1, 2, 3, 1, 8192, False),
)
LM_TP_ROUNDS = 2
#: qwen2-0.5b at dp 2 x mp 2 against dp 2 x mp 1 from the same seed
#: (bf16): round and held-out losses within this. The split layers sum
#: bf16 partial products (each rounded to 2^-8 of its size) in another
#: order, so the two runs drift apart; a round moves the loss by about
#: 0.13, and the held-out losses differed by 4e-4 (final run, PR 25)
LM_TP_BF16_TOL = 1e-2
#: the reduced f32 round of every family at dp 2 x mp 2 against mp 1 on
#: the card (B = LM_TP_PARITY_B, LM_TP_PARITY_S positions a row)
LM_TP_PARITY = ("qwen2-0.5b", "mixtral-8x7b", "llama4-maverick-400b-a17b",
                "mamba2-2.7b", "zamba2-2.7b", "whisper-medium",
                "pixtral-12b")
#: the reduced families' decode against prefill: tokens a row (past the
#: reduced sliding window of 64)
FAMILY_DECODE_SEQ = 128
#: serial (host codec) against pipelined (card codec) at int8: the
#: reference's own bound (tests/test_clientstore.py)
INT8_ATOL = 5e-3
#: the scenario phase: seeds and rounds whose keyed fault trace holds a
#: dark cluster, a dropped link and a timed-out device (asserted)
SCENARIO_SEED, SCENARIO_FAULT_SEED, SCENARIO_ROUNDS = 7, 3, 3
ASYNC_STALENESS = 2
#: the sharded phase: configs/femnist_cnn.py's tau = 2, q = 8, pi = 10 on
#: a ring, its fleet cut to 4 clusters x 2 devices, one rank process a
#: bank row (one card cannot host 64 rank processes); (name, FLConfig
#: changes, rounds, options) of each run
SHARDED_RANKS = 8
SHARDED_RUNS = (
    ("one fused block", {}, 1, {"block": True}),
    ("one fused block, mobile_sampled + chaos", {}, 1, {
        "block": True, "scenario": "mobile_sampled", "faults": "chaos"}),
    ("static", {}, 2, {}),
    ("mobile_sampled + chaos", {}, 2, {"scenario": "mobile_sampled",
                                       "faults": "chaos"}),
    ("depth 3 (2, 2, 2)", {"hierarchy": (2, 2, 2)}, 1, {}),
    ("async s=2", {}, 1, {"scenario": "lognormal", "staleness": 2}),
    ("static at the configuration's lr 0.1", {}, 1, {"lr": 0.1}),
)
#: sharded rows against the single-process engine: the reference's own
#: bound for its sharded engine (tests/test_sharded_bank.py)
SHARDED_ATOL = 2e-4
#: at 2 devices a cluster the CNN's local steps diverge at the
#: configuration's lr 0.1 (the last run of SHARDED_RUNS shows it in both
#: engines); the other sharded runs train at 0.01
SHARDED_LR = 0.01
#: the dense operator the sharded phase's weighted rotations are held to
#: B1 with (a seeded row-stochastic 8 x 8)
PROBE_W = (lambda w: (w / w.sum(1, keepdims=True)).astype(np.float32))(
    np.random.default_rng(19).random((SHARDED_RANKS, SHARDED_RANKS)))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase_start(dev: torch.device, name: str) -> None:
    """Release what earlier phases left for the cyclic collector (a
    simulator is a reference cycle: its lowered rounds and vmapped loss
    hold it, so ``del sim`` alone frees no bank) and print what is still
    allocated on the card as the phase starts."""
    import gc
    before = torch.cuda.memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{name}] start: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
        f"allocated on the card ({before / 1e9:.2f} GB before collecting "
        f"the earlier phases' garbage)")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls (CUDA
    events)."""
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


def device_ms(fn, reps: int = 10, warmup: int = 2) -> tuple:
    """The card's time for one call of ``fn``: the profiler's device time
    of every kernel, copy and fill that ``reps`` calls launch, over
    ``reps`` (no host time, so a call whose host work outlasts its
    kernels is not charged for it); and that time by kernel name."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_kernel[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    if not by_kernel:
        raise AssertionError("the profiler recorded no device time")
    return sum(by_kernel.values()), dict(by_kernel)


def max_err(out: torch.Tensor, exp: torch.Tensor, tol: float,
            what: str, rtol: float | None = None) -> float:
    """Max abs difference; raises unless |out-exp| <= tol + rtol*|exp|
    (``rtol`` defaults to ``tol``; 0 makes the bound absolute)."""
    rtol = tol if rtol is None else rtol
    o, e = out.float(), exp.float()
    diff = (o - e).abs()
    err = float(diff.max())
    bad = int((diff > tol + rtol * e.abs()).sum())
    if bad or not math.isfinite(err):
        raise AssertionError(f"{what}: {bad} elements over atol {tol}, "
                             f"rtol {rtol} (max abs diff {err:.3e})")
    return err


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

KERNEL_SOURCES = ("gossip_mix", "cold_codec", "flash_attention",
                  "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def phase_build() -> None:
    """Every kernel source compiled at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = list(pool.map(_build.compile_library, KERNEL_SOURCES))
    for name, path in zip(KERNEL_SOURCES, paths):
        # ptxas -v: one "Used N registers" line per instantiation, after
        # its "N bytes spill stores" line
        text = _build.BUILD_LOGS.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"[build] {name}: {os.path.relpath(path, ROOT)}; "
            f"{len(regs)} kernel instantiation(s), registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{sum(1 for b in spills if b)} with spill stores (at most "
            f"{max(spills, default=0)} bytes)")
    log(f"[build] {len(paths)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")
    for name in PTXAS_DETAIL:
        for line in ptxas_report(_build.BUILD_LOGS.get(name, "")):
            log(f"[build] {name}: {line}")


#: sources whose ptxas report is printed per kernel instantiation
PTXAS_DETAIL = ("gossip_mix", "flash_attention", "flash_attention_bwd",
                "ssd_scan", "ssd_scan_bwd", "cold_codec")


def _demangle(name: str) -> str:
    """A kernel's C++ name with its template arguments (c++filt where
    the toolchain has it), without the anonymous namespace and the
    parameter list."""
    try:
        name = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, timeout=10).stdout.strip() or name
    except (OSError, subprocess.SubprocessError):
        pass
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def ptxas_report(text: str) -> list:
    """One line per kernel instantiation of a ptxas -v log: registers,
    shared memory, stack and spills; then ptxas's warnings (a setmaxnreg
    it ignored, wgmma it serialised)."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1)}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_st"], cur["spill_ld"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(
                f"{_demangle(cur['name'])}: {m.group(1)} registers, "
                f"{smem.group(1) if smem else 0} bytes static smem, stack "
                f"{cur.get('stack', '?')} B, spill stores "
                f"{cur.get('spill_st', '?')} B, loads "
                f"{cur.get('spill_ld', '?')} B")
            cur = None
    out += [ln.strip() for ln in text.splitlines()
            if "warning" in ln.lower()]
    return out


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

    # every residue of T mod 4 at n = 64 (the copy width follows T's
    # alignment: the paper models' T are 2 mod 4), in place and as the
    # (8, 64) projection, and a bank 8 bytes past an aligned address
    worst = {dt: 0.0 for dt in TOL}
    for T in RESIDUE_T:
        for dtype, tol in TOL.items():
            Y = torch.from_numpy(rng.standard_normal((64, T)).astype(
                np.float32)).to(dev, dtype)
            Wr = torch.from_numpy(_stochastic(rng, 64, 64, 1)).to(dev)
            P = torch.from_numpy(_stochastic(rng, 8, 64, 1)).to(dev)
            exp, pexp = (ref.gossip_mix_rows_ref(Wr, Y),
                         ref.gossip_mix_rows_ref(P, Y))
            worst[dtype] = max(worst[dtype], max_err(
                gm.gossip_mix_rows(P, Y), pexp, tol,
                f"projection 8x64 T={T} {dtype}"))
            Yi = Y.clone()
            got = gm.gossip_mix_rows(Wr, Yi)
            assert got.data_ptr() == Yi.data_ptr(), "square W not in place"
            worst[dtype] = max(worst[dtype], max_err(
                got, exp, tol, f"rows in place 64x64 T={T} {dtype}"))
            # the same bank one f32 (two bf16) past an aligned address
            Ys = torch.empty(64 * T + 2, dtype=dtype, device=dev)[2:]
            Ys.copy_(Y.flatten())
            Ys = Ys.view(64, T)
            worst[dtype] = max(worst[dtype], max_err(
                gm.gossip_mix_rows(Wr, Ys), exp, tol,
                f"rows in place 64x64 T={T} {dtype}, offset bank"))
    log(f"[kernels] gossip_mix n=64 at T mod 4 = 0..3 (T "
        f"{', '.join(map(str, RESIDUE_T))}), in place, offset and 8x64 "
        f"projection: max abs err f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol {TOL[torch.float32]}, "
        f"{TOL[torch.bfloat16]}); copy widths "
        f"{[gm.copy_bytes(T, 4, 0) for T in RESIDUE_T]} B (f32), "
        f"{[gm.copy_bytes(T, 2, 0) for T in RESIDUE_T]} B (bf16)")

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
            "launches": 0,
            "max_abs_err": max(err_sq, err_in, err_p, *worst.values()),
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

    # int8 rows whose segments sit at the encode's one-block threshold
    # (one block), one past it (two slices held at once), and one segment
    # too wide for the grid to hold on chip (two rounds: maxima, codes)
    edge = ((0, 7), (7, cc.SLICE), (7 + cc.SLICE, cc.SLICE + 1),
            (8 + 2 * cc.SLICE, 5))
    E = torch.randn((5, sum(n for _, n in edge)), device=dev, generator=gen)
    E[2, 7:7 + cc.SLICE] = 0.0
    q, s, _, _ = _check_codec(E, "int8", edge, "threshold rows")
    host = compress.encode_cold_rows(E.cpu().numpy(), "int8", edge)
    assert np.array_equal(q.cpu().numpy(), host["q"]) and \
        np.array_equal(s.cpu().numpy(), host["scale"]), \
        "threshold rows: the card differs from the host codec"
    wide = cc._library().cold_encode_int8_grid() * cc.SLICE + 1
    W = torch.randn((2, wide), device=dev, generator=gen)
    _check_codec(W, "int8", ((0, wide),), "rows of one wide segment")
    log(f"[kernels] cold_codec int8 with segments of {cc.SLICE} (one "
        f"block) and {cc.SLICE + 1} columns (two slices on chip), and of "
        f"{wide:,} columns (two rounds): bit-equal to the plain version "
        f"and the host codec")
    del E, W, q, s

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
    log(f"[{tag}] profiled window: {len(kernels)} kernels on {streams} "
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
                   top: int = 8, tag: str = "main",
                   what: str = "set-up and round 1") -> None:
    """The blocks live at the allocator's peak, from a memory-history
    snapshot: replay the trace's allocs and frees (``allocated_bytes``
    falls at ``free_requested``), find the point of most bytes, and group
    the blocks live there by allocation site. ``base`` is what was
    allocated before the history started (``what`` the span it
    recorded)."""
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
    log(f"[{tag}] allocator peak over {what} {peak / 1e9:.2f} GB"
        f" ({base / 1e9:.2f} GB allocated before the history); live at the "
        f"peak, by site:")
    for (site, size), (total, count) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[{tag}]   {total / 1e9:6.3f} GB = {count:4d} x "
            f"{size / 1e6:9.3f} MB  {site[:150]}")


def _start_memory_history(dev: torch.device) -> int:
    """Start the allocator's memory history with every frame (C++ frames
    name the autograd node and ATen function of each block; dladdr is
    the quickest of torch's symbol resolvers). Returns what is allocated
    before it."""
    os.environ.setdefault("TORCH_SYMBOLIZE_MODE", "dladdr")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(stacks="all",
                                             max_entries=2_000_000)
    return base


def _stop_memory_history() -> dict:
    """The history's snapshot; stops recording."""
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    return snap


def phase_main(dev: torch.device, rounds: int = 2) -> int:
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    fl = cfg.FL
    base = _start_memory_history(dev)
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
            snap = _stop_memory_history()
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
            # a decode in pre and an int8 encode (one launch) in post,
            # every round
            assert launches[1:] == (rounds, rounds), launches
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
# phase 5: enumerated scenarios with faults at full width
# ---------------------------------------------------------------------------

def _femnist_sim(dev, **kw):
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    return FLSimulator(init_femnist_cnn, apply_femnist_cnn, cfg.FL,
                       femnist_data(cfg.FL), lr=0.1, batch_size=16, seed=0,
                       device=dev, **kw)


def _fault_coverage(plans) -> tuple:
    """Dark clusters, dropped backhaul links and timed-out devices over a
    run's plans."""
    dark = sum(int(p.fault.cluster_down.sum()) for p in plans)
    links = sum(int((~p.fault.link_up).sum()) // 2 for p in plans)
    timed = sum(int(p.fault.timed_out.sum()) for p in plans)
    return dark, links, timed


def phase_scenario(dev: torch.device, rounds: int = SCENARIO_ROUNDS) -> int:
    """The FEMNIST experiment at full width under ``mobile_sampled`` with
    ``chaos`` faults, through ``run_wall_clock``: partial cohorts train on
    the compacted gather, dark clusters are gated out of every boundary.
    Returns gossip_mix's launches on this path."""
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core import program as prg
    from repro_torch.core import scenario as scn
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.kernels import gossip_mix as gm
    fl = cfg.FL
    scenario = dataclasses.replace(
        scn.get_scenario("mobile_sampled"), seed=SCENARIO_SEED,
        faults=dataclasses.replace(scn.get_faults("chaos"),
                                   seed=SCENARIO_FAULT_SEED))
    # the fault trace is keyed: a twin engine computes it on the host
    # before the run, and the run must see every fault class
    twin = scn.ScenarioEngine(scenario, fl)
    plans = [twin.step() for _ in range(rounds)]
    dark, links, timed = _fault_coverage(plans)
    log(f"[scenario] FEMNIST CNN n={fl.n} under mobile_sampled (seed "
        f"{SCENARIO_SEED}) with chaos faults (seed {SCENARIO_FAULT_SEED}), "
        f"{rounds} rounds: the keyed trace holds {dark} dark cluster-rounds, "
        f"{links} dropped links, {timed} timed-out devices")
    assert dark >= 1 and links >= 1 and timed >= 1, \
        "pick rounds and seeds whose fault trace covers every fault class"
    torch.cuda.synchronize()
    sim = _femnist_sim(dev, scenario=scenario)
    T = sim.layout.total
    rt = paper_runtime_model()
    gm.launches = 0
    want, wall = 0, 0.0
    for r, plan in enumerate(plans):
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
        peak = torch.cuda.max_memory_allocated(dev)
        if last:
            device_breakdown(prof, dt, tag="scenario")
        assert np.array_equal(sim.labels, plan.labels), \
            "the run's plan is not the keyed trace's"
        k = int(plan.mask.sum())
        path = "compact" if 0 < k < fl.n else "flat"
        want += sum(len(bp.groups) for bp in
                    prg.lowering_plan(sim.last_program, fuse=True)) + 1
        down = plan.fault.cluster_down
        Y = sim.bank.params
        spread = 0.0
        for c in np.nonzero(~down)[0]:
            rows = torch.from_numpy(np.nonzero(plan.labels == c)[0]).to(dev)
            Yc = Y[rows]
            spread = max(spread, float((Yc - Yc[:1]).abs().max()))
        wall += hist["wall_time"][-1]
        loss, acc = hist["loss"][-1], hist["acc"][-1]
        log(f"[scenario] round {r + 1}: {dt:.3f} s on the card (step + "
            f"eval), k={k} k_pad={sim.last_bucket} path={path}, dark "
            f"clusters {np.nonzero(down)[0].tolist()}, dropped links "
            f"{int((~plan.fault.link_up).sum()) // 2}, timed out "
            f"{int(plan.fault.timed_out.sum())}, loss={loss:.4f} "
            f"acc={acc:.4f} simulated_wall={wall:,.1f} s, "
            f"peak device memory {peak / 1e9:.2f} GB, max in-cluster row "
            f"spread (live clusters)={spread:.2e}")
        assert math.isfinite(loss), f"round {r + 1}: loss {loss}"
        assert spread <= 1e-6, f"round {r + 1}: live cluster rows differ " \
            f"by {spread}"
        assert sim.last_bucket == (fl.n if path == "flat" else
                                   next(b for b in sim._buckets if b >= k))
    launches = gm.launches
    log(f"[scenario] gossip_mix launches={launches} (the lowering plans' "
        f"mixing groups + one projection an evaluation = {want}); bank "
        f"{T} columns")
    assert launches == want, f"gossip_mix launched {launches}, not {want}"
    del sim
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: bounded-staleness async rounds at full width
# ---------------------------------------------------------------------------

def phase_async(dev: torch.device, rounds: int = 2) -> int:
    """Two async rounds at staleness 2 over a lognormal fleet, then one
    s=0 round against the barrier round, bit for bit. Returns
    gossip_mix's launches in the async rounds."""
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core import scenario as scn
    from repro_torch.core.clock import EventClock
    from repro_torch.core.runtime import compute_bound_runtime_model
    from repro_torch.kernels import gossip_mix as gm
    fl = cfg.FL
    scenario = dataclasses.replace(scn.get_scenario("lognormal"), seed=7)
    rt = compute_bound_runtime_model()
    torch.cuda.synchronize()
    sim = _femnist_sim(dev, scenario=scenario)
    barrier = EventClock(rt, fl)
    gm.launches = 0
    total = 0
    for r in range(rounds):
        n0 = gm.launches
        t0 = time.perf_counter()
        plan = sim.step_round_async(ASYNC_STALENESS, rt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ev = sim.last_async["trace"]
        got = gm.launches - n0
        total += got
        fleet = np.asarray(sim.engine.speed_multipliers) * rt.hw.device_flops
        b = barrier.charge_program(sim.last_program, fleet, plan.mask)
        for e in ev:
            ph = np.asarray(e["phases"])
            assert all(abs(int(ph[i]) - int(ph[j])) <= ASYNC_STALENESS
                       for i, j in e["edges"]), "an edge broke the bound"
        acc, loss = sim.evaluate()
        log(f"[async] round {r + 1} (staleness {ASYNC_STALENESS}): "
            f"{len(ev)} events, {dt:.3f} s on the card (step), gossip_mix "
            f"launches {got}; simulated makespan "
            f"{sim.last_async['timeline']['makespan']:,.1f} s against the "
            f"barrier's {b:,.1f} s; loss={loss:.4f} acc={acc:.4f}")
        assert got == len(ev), f"{got} launches for {len(ev)} events"
        assert math.isfinite(loss)
    del sim
    torch.cuda.empty_cache()
    # s=0 is the barrier: the same launches on the same rows, so on the
    # card too the banks agree bit for bit (cuDNN held to deterministic
    # algorithms for the comparison)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        banks = []
        for run in ("barrier", "async"):
            sim = _femnist_sim(dev, scenario=scenario)
            sim._compact_enabled = False
            t0 = time.perf_counter()
            if run == "barrier":
                sim.step_round()
            else:
                sim.step_round_async(0, rt)
            torch.cuda.synchronize()
            log(f"[async] s=0 check, {run} round: "
                f"{time.perf_counter() - t0:.3f} s on the card")
            banks.append((sim.bank.params.clone(), sim.bank.mom.clone()))
            del sim
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    same = (torch.equal(banks[0][0], banks[1][0])
            and torch.equal(banks[0][1], banks[1][1]))
    diff = max(float((a - b).abs().max()) for a, b in zip(*banks))
    log(f"[async] s=0 round against the barrier round (compaction off), "
        f"full width: bitwise equal={same} (max abs diff {diff:.3e})")
    assert same, "async s=0 and the barrier differ on the card"
    del banks
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 9: the upload path at full width
# ---------------------------------------------------------------------------

#: the upload phase: int8 (stochastic rounding) with error feedback, top-k
#: 5% with error feedback, and local DP at clip 1.0, sigma = 0.5
UPLOADS = (("int8+EF", dict(kind="int8"), None),
           ("topk 5%+EF", dict(kind="topk", topk_frac=0.05), None),
           ("DP clip 1.0 sigma 0.5", None,
            dict(clip_norm=1.0, noise_multiplier=0.5)))


class _UploadTimers:
    """Card seconds of the upload's draws (``random.uniform``/``normal``,
    outermost call only: ``normal`` calls ``uniform``) and of its
    transforms (``compress_flat``, ``privatize_update_flat``), from CUDA
    events recorded around each call and read once the round has
    synchronized; the transforms' seconds exclude the draws they make."""

    def __init__(self):
        from repro_torch import random as rnd
        from repro_torch.core import compress as cmp
        from repro_torch.core import privacy as prv
        self.spans = {"draws": [], "transforms": []}
        self._depth = 0
        self._patched = []
        for mod, name, kind in ((rnd, "uniform", "draws"),
                                (rnd, "normal", "draws"),
                                (cmp, "compress_flat", "transforms"),
                                (prv, "privatize_update_flat",
                                 "transforms")):
            orig = getattr(mod, name)
            self._patched.append((mod, name, orig))
            setattr(mod, name, self._wrap(orig, kind))

    def _wrap(self, fn, kind):
        def timed(*args, **kw):
            outer = kind == "transforms" or self._depth == 0
            if kind == "draws":
                self._depth += 1
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                return fn(*args, **kw)
            finally:
                b.record()
                if kind == "draws":
                    self._depth -= 1
                if outer:
                    self.spans[kind].append((a, b))
        return timed

    def take(self):
        """(draw seconds, transform seconds without the draws) since the
        last take; the caller has synchronized."""
        sec = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
               for k, v in self.spans.items()}
        self.spans = {k: [] for k in self.spans}
        return sec["draws"], sec["transforms"] - sec["draws"]

    def close(self):
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)


def _cluster_spread(sim) -> float:
    fl = sim.fl
    Y = sim.bank.params.view(fl.num_clusters, fl.devices_per_cluster, -1)
    return float((Y - Y[:, :1]).abs().max())


def phase_upload(dev: torch.device, rounds: int = 2) -> int:
    """The FEMNIST experiment at full width with uploading devices: two
    rounds each of int8+EF, top-k 5%+EF and local DP through
    ``run_wall_clock``. Returns gossip_mix's launches on this path."""
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core import program as prg
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.core.privacy import DPConfig
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.kernels import gossip_mix as gm
    fl = cfg.FL
    rt = paper_runtime_model()
    total = 0
    for name, comp, dp in UPLOADS:
        torch.cuda.synchronize()
        sim = _femnist_sim(
            dev, compression=None if comp is None
            else CompressionConfig(**comp),
            dp=None if dp is None else DPConfig(**dp))
        plan_groups = sum(len(bp.groups) for bp in
                          prg.lowering_plan(sim._canonical, fuse=True))
        log(f"[upload] {name}: bank {sim.bank.resident_nbytes / 1e9:.2f} GB"
            f" (params, momentum{', EF residual' if comp else ''}); the "
            f"upload plan mixes {plan_groups} times a round")
        assert plan_groups == fl.q + 1, plan_groups
        timers = _UploadTimers()
        try:
            for r in range(rounds):
                torch.cuda.reset_peak_memory_stats(dev)
                n0 = gm.launches
                t0 = time.perf_counter()
                hist = run_wall_clock(sim, rt, 1)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                draw_s, transform_s = timers.take()
                got = gm.launches - n0
                total += got
                loss, acc = hist["loss"][-1], hist["acc"][-1]
                res = (float(torch.linalg.vector_norm(sim.bank.residual))
                       if sim.bank.residual is not None else 0.0)
                spread = _cluster_spread(sim)
                log(f"[upload] {name} round {r + 1}: {dt:.3f} s on the card"
                    f" (step + eval), loss={loss:.4f} acc={acc:.4f}, "
                    f"gossip_mix launches {got} (plan {plan_groups} + 1 "
                    f"eval), peak device memory "
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
                    f"residual norm {res:.4e}, max in-cluster row spread "
                    f"{spread:.2e}")
                log(f"[upload] {name} round {r + 1}: draws {draw_s:.3f} s "
                    f"on the card")
                log(f"[upload] {name} round {r + 1}: "
                    f"{'compression' if comp else 'clip + noise'} "
                    f"{transform_s:.3f} s on the card (without its draws)")
                assert got == plan_groups + 1, (got, plan_groups)
                assert (comp is None) == (sim.bank.residual is None)
                if comp is not None:
                    assert math.isfinite(loss), f"{name}: loss {loss}"
                    assert spread <= 1e-6, f"{name}: cluster rows differ " \
                        f"by {spread}"
                    assert res > 0 and math.isfinite(res)
        finally:
            timers.close()
        del sim
        torch.cuda.empty_cache()
        if dp is not None:
            _check_dp_transform(dev, fl.n, DPConfig(**dp))
    return total


def _check_dp_transform(dev: torch.device, n: int, dp) -> None:
    """Local DP at this width adds N(0, sigma^2) to each of T = 6.6e6
    coordinates of an update clipped to norm ``clip_norm``: a noise norm
    of sigma * sqrt(T), about 1,285 at sigma 0.5 against a clip of 1, so
    the DP rounds above diverge by construction (their losses are
    reported, not held finite). What the port must deliver is the
    mechanism, checked here at the full width on the card: every row
    clipped to the bound, and noise of mean 0 and std sigma, a different
    draw for each row."""
    from repro_torch import random as rnd
    from repro_torch.core.privacy import DPConfig, privatize_update_flat
    g = torch.Generator(device=dev).manual_seed(0)
    delta = torch.randn((n, FEMNIST_T), generator=g, device=dev).mul_(1e-3)
    keys = rnd.split(rnd.PRNGKey(3), n)
    clipped = privatize_update_flat(delta, DPConfig(dp.clip_norm, 0.0),
                                    keys)
    noise = privatize_update_flat(delta, dp, keys).sub_(clipped)
    norms = torch.linalg.vector_norm(clipped, dim=1)
    sigma = dp.noise_multiplier * dp.clip_norm
    mean, std = float(noise.mean()), float(noise.std())
    tail = float((noise.abs() > 1.96 * sigma).float().mean())
    same = bool(torch.equal(noise[0], noise[1]))
    log(f"[upload] DP transform at ({n}, {FEMNIST_T}): clipped row norms "
        f"{float(norms.min()):.6f}..{float(norms.max()):.6f} (bound "
        f"{dp.clip_norm}), noise mean {mean:.2e} std {std:.6f} (sigma "
        f"{sigma}), beyond 1.96 sigma {tail:.5f} (0.04999 for a normal), "
        f"rows drawn alike {same}")
    assert float(norms.max()) <= dp.clip_norm * (1 + 1e-5)
    assert abs(mean) < 2e-4 and abs(std - sigma) < 1e-3 * sigma
    assert abs(tail - 0.0499958) < 1e-3 and not same
    del delta, clipped, noise
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: kill and resume at full width
# ---------------------------------------------------------------------------

class _CheckpointTimers:
    """Host seconds of every ``RunCheckpoint.save``/``restore``."""

    def __init__(self):
        from repro_torch.checkpoint.runckpt import RunCheckpoint
        self.cls = RunCheckpoint
        self.orig = (RunCheckpoint.save, RunCheckpoint.restore)
        self.seconds = {"save": [], "restore": []}
        for name, fn in zip(("save", "restore"), self.orig):
            setattr(RunCheckpoint, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(rc, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(rc, *args, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)
        return timed

    def close(self):
        self.cls.save, self.cls.restore = self.orig


def _replayable(hist) -> dict:
    return {k: v for k, v in hist.items()
            if k not in ("page_s", "compute_s", "eval_s")}


def _kill_and_resume(what, make, rounds, kill_at, state, timers):
    """``rounds`` rounds of a fresh sim through ``run_wall_clock``, then
    ``kill_at`` rounds of another with a checkpoint at its end, and a
    third restored from it running the rest; ``state`` reads what must
    be equal bit for bit. Returns the checkpoint's size in bytes and the
    killed run's launch counts."""
    import tempfile
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.runtime import paper_runtime_model
    from repro_torch.kernels import cold_codec as cc
    rt = paper_runtime_model()
    sim = make()
    full = run_wall_clock(sim, rt, rounds)
    want = state(sim)
    del sim
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-resume-") as d:
        cc.encode_launches = cc.decode_launches = 0
        sim = make()
        run_wall_clock(sim, rt, kill_at, ckpt_dir=d, ckpt_every=kill_at)
        size = os.path.getsize(os.path.join(d, "run.npz"))
        del sim
        torch.cuda.empty_cache()
        sim = make()
        got = run_wall_clock(sim, rt, rounds, ckpt_dir=d,
                             ckpt_every=rounds + 1, resume=True)
        launches = (cc.encode_launches, cc.decode_launches)
        have = state(sim)
        del sim
        torch.cuda.empty_cache()
    same_hist = _replayable(full) == _replayable(got)
    same = [torch.equal(a, b) if isinstance(a, torch.Tensor)
            else np.array_equal(a, b) for a, b in zip(want, have)]
    diff = max(float((a - b).abs().max()) if isinstance(a, torch.Tensor)
               else float(np.abs(a.astype(np.float64)
                                 - b.astype(np.float64)).max())
               for a, b in zip(want, have))
    log(f"[resume] {what}: {rounds} rounds against {kill_at} + save + "
        f"fresh sim + restore + {rounds - kill_at}: state bitwise equal "
        f"{all(same)} (max abs diff {diff:.3e}), history equal {same_hist};"
        f" checkpoint {size / 1e9:.3f} GB on disk, save "
        f"{timers.seconds['save'][-1]:.2f} s, restore "
        f"{timers.seconds['restore'][-1]:.2f} s")
    assert all(same) and same_hist, f"{what}: resume is not bit-identical"
    return size, launches


def phase_resume(dev: torch.device):
    """Kill-and-resume on the card at full width, bit for bit (cuDNN held
    to deterministic algorithms): the resident int8+EF run and the
    pipelined population run. Returns the codec's (encode, decode)
    launches in the killed population run."""
    from repro_torch.config import PopulationConfig, ScenarioConfig
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    fl = cfg.FL
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    timers = _CheckpointTimers()
    try:
        def resident():
            return _femnist_sim(dev, compression=CompressionConfig("int8"))

        def bank(sim):
            b = sim.bank
            return [b.params.clone(), b.mom.clone(), b.residual.clone()]
        _kill_and_resume("resident int8+EF (params, momentum, residual)",
                         resident, 3, 2, bank, timers)
        scenario = ScenarioConfig(
            sample_fraction=1.0, dropout_prob=0.0, move_prob=0.25, seed=7,
            population=PopulationConfig(clients_per_cluster=1250,
                                        cohort_per_cluster=7, codec="int8"))
        data = femnist_data(fl)

        def population():
            return FLSimulator(init_femnist_cnn, apply_femnist_cnn, fl,
                               data, lr=0.1, batch_size=16, seed=0,
                               scenario=scenario, pipeline=True, device=dev)

        def store(sim):
            snap = sim.store.snapshot()
            return [_global_row(sim)] + [snap[k] for k in sorted(snap)]
        _, launches = _kill_and_resume(
            "pipelined population of 10,000, int8 store (global model, "
            "store bytes)", population, 3, 2, store, timers)
    finally:
        timers.close()
        torch.backends.cudnn.deterministic = det
    log(f"[resume] cold_codec launches in the killed and resumed population "
        f"runs (3 rounds): encode {launches[0]}, decode {launches[1]}")
    assert launches == (3, 3), launches
    return launches



# ---------------------------------------------------------------------------
# phase 10b: the device-parallel bank engine, 8 gloo ranks on the card
# ---------------------------------------------------------------------------

def _sharded_config(fl_changes: dict, opt: dict):
    """(FLConfig, simulator kwargs) of one sharded run; ``block`` runs
    the canonical program's last block alone (τ local steps and the
    fused τ∘qτ boundary)."""
    from repro_torch.configs import femnist_cnn as cfg
    from repro_torch.core import program as prg
    from repro_torch.core import scenario as scn
    changes = dict(num_clusters=4, devices_per_cluster=2, **fl_changes)
    fl = dataclasses.replace(cfg.FL, **changes)
    kw = {}
    if "scenario" in opt:
        kw["scenario"] = scn.get_scenario(opt["scenario"])
    if "faults" in opt:
        kw["scenario"] = dataclasses.replace(
            kw["scenario"], faults=scn.get_faults(opt["faults"]))
    if opt.get("block"):
        kw["schedule"] = prg.block_programs(prg.canonical_program(
            fl, faults="faults" in opt))[-1]
    return fl, kw


def _run_rounds(sim, rounds: int, opt: dict, rt, after=None) -> None:
    for r in range(rounds):
        if "staleness" in opt:
            sim.step_round_async(opt["staleness"], rt)
        else:
            sim.step_round()
        if after is not None:
            after(r)


def _boundary_probe(sim, Y: torch.Tensor, structured: bool):
    """This rank's rows ``Y`` through the sharded lowerings of a mixing
    boundary: each gossip tier's grouped mean and gossip matchings
    (structured runs), or the weighted rotations of a seeded dense
    operator (``PROBE_W``); the parent holds them against B1 on the
    stacked rows."""
    from repro_torch.core import gossip as gsp
    reg = sim.registry
    if not structured:
        return {"dense": gsp.dense_mix_rows(PROBE_W, Y, sim.mesh).cpu()
                .numpy()}
    return {lvl: reg.gossip_in_body(reg.mean_in_body(Y, lvl), lvl,
                                    sim.fl.pi).cpu().numpy()
            for lvl in range(1, reg.depth)}


def _sharded_rank(runs) -> list:
    """One rank of the sharded phase: every run of ``runs`` on this
    rank's bank row of the full-width FEMNIST CNN, cuDNN held to
    deterministic algorithms. Returns, a run, the rank's rows after each
    round, buffer shapes, per-round seconds (synchronized) and traffic
    by op, its peak device memory, gossip_mix launches and the boundary
    probe of its final row."""
    import gc
    from repro_torch.core.runtime import compute_bound_runtime_model
    from repro_torch.core.sharded import ShardedBankCEFedAvg
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_replica_mesh(SHARDED_RANKS, device="cuda")
    dev = mesh.device
    rt = compute_bound_runtime_model()
    out = []
    for name, fl_changes, rounds, opt in runs:
        fl, kw = _sharded_config(fl_changes, opt)
        sim = ShardedBankCEFedAvg(init_femnist_cnn, apply_femnist_cnn, fl,
                                  femnist_data(fl), mesh,
                                  lr=opt.get("lr", SHARDED_LR),
                                  batch_size=16, seed=0, **kw)
        b = sim.bank
        shapes = [tuple(t.shape) for t in (b.params, b.mom, b.residual)
                  if t is not None]
        per_round = []
        t0 = [0.0]

        def after(_r):
            torch.cuda.synchronize(dev)
            per_round.append({
                "seconds": time.perf_counter() - t0[0],
                "traffic": {k: dict(v) for k, v in mesh.traffic.items()},
                "params": sim.bank.params.cpu().numpy()})
            mesh.reset_traffic()
            t0[0] = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gm.launches = 0
        mesh.reset_traffic()
        t0[0] = time.perf_counter()
        _run_rounds(sim, rounds, opt, rt, after)
        launches = gm.launches
        peak = torch.cuda.max_memory_allocated(dev)
        acc, loss = sim.evaluate()
        probe = _boundary_probe(sim, sim.bank.params,
                                structured="scenario" not in opt)
        out.append({"name": name, "T": sim.layout.total, "shapes": shapes,
                    "rounds": per_round, "launches": launches, "peak": peak,
                    "acc": acc, "loss": loss, "probe": probe,
                    "operators": {lvl: sim.registry.operator(lvl, fl.pi)
                                  for lvl in range(1, sim.registry.depth)},
                    "transport": mesh.transport})
        del sim, b
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _one_row_at_a_time(sim) -> None:
    """Make ``sim`` take each SGD step one row at a time, on a fresh (1,
    T) copy of the row through the same vmapped gradient, as a rank of
    the sharded engine takes it. The engine's n-row vmap hands cuDNN one
    grouped convolution (and cuBLAS batched GEMMs), whose sums run in
    another order than n convolutions of one row."""
    step = sim._sgd_step

    def one_at_a_time(Y, M, xs, ys, idx, lr):
        for i in range(Y.shape[0]):
            y, m = Y[i:i + 1].clone(), M[i:i + 1].clone()
            step(y, m, xs[i:i + 1], ys[i:i + 1], idx[i:i + 1], lr)
            Y[i:i + 1].copy_(y)
            M[i:i + 1].copy_(m)
    sim._sgd_step = one_at_a_time


def _lowering_order_mixing(sim) -> None:
    """Make ``sim`` mix its stacked rows as the sharded engine's ranks
    mix theirs, sum for sum: the same operators (the registry's tier
    means and gossip matchings on the static ``ce_fedavg`` path, each
    dense operator's weighted rotations otherwise), each row's terms
    added in the order its rank adds them. B1 and ``torch.matmul`` sum
    the same products in other orders. Like the ranks, whose rows are
    pinned, it trains a partial cohort mask-frozen, not compacted."""
    from repro_torch.core import gossip as gsp
    from repro_torch.core import topology as topo
    fl, n = sim.fl, sim.sched.n
    hier = topo.Hierarchy.from_config(fl)
    me = torch.arange(n)
    scheds = {}

    def rotations(W, Y):
        """``dense_mix_rows``: rank d starts from W[d, d]·x_d and adds
        W[d, (d+s) % n]·x_{(d+s) % n} for s = 1 .. n-1."""
        Wt = torch.as_tensor(np.asarray(
            W.cpu() if isinstance(W, torch.Tensor) else W, np.float32))
        acc = Y * Wt[me, me][:, None].to(Y.device)
        for s in range(1, n):
            src = (me + s) % n
            acc = acc + Y[src.to(Y.device)] * Wt[me, src][:, None].to(
                Y.device)
        return acc

    def mean(Y, level):
        """``group_mean_in_body``: each group's rows summed in rank order
        (what gloo's sum of a pair gives either rank), times 1/size."""
        size = hier.group_size(level)
        G = Y.view(n // size, size, -1)
        tot = G[:, 0]
        for j in range(1, size):
            tot = tot + G[:, j]
        return (tot * (1.0 / size)).repeat_interleave(size, 0)

    def gossip(Y, level, pi):
        """``gossip_in_body`` (rounds): π times w_self·x plus each
        matching's received row times its weight, in matching order."""
        key = (level, pi)
        if key not in scheds:
            scheds[key] = gsp.GossipSchedule.build(
                hier.mixing(level, fl.topology, fl.mixing, fl), pi,
                hier.node_size(level))
        sc = scheds[key]
        c = me // sc.devices_per_cluster
        ws = torch.from_numpy(sc.w_self.astype(np.float32))[c][:, None]
        wk = torch.from_numpy(np.asarray(sc.weights, np.float32))[:, c]
        ws, wk = ws.to(Y.device), wk.to(Y.device)
        for _ in range(sc.pi):
            acc = Y * ws
            for k, perm in enumerate(sc.perms):
                recv = torch.zeros_like(Y)
                recv[[d for _, d in perm]] = Y[[s for s, _ in perm]]
                acc = acc + recv * wk[k][:, None]
            Y = acc
        return Y

    def mixer(program, block_keyed=False):
        if not (sim.engine is None and fl.algorithm == "ce_fedavg"
                and not block_keyed):
            def dense(bp, mats, Y, lo=0, hi=None):
                for W in mats[lo:hi]:
                    Y = rotations(W, Y)
                return Y
            return dense

        def structured(bp, mats, Y, lo=0, hi=None):
            usize = 1   # ShardedBankCEFedAvg._mixer's dedupe of means
            for g in bp.groups[lo:hi]:
                for op in g.ops:
                    size = hier.group_size(op.level)
                    if usize < size:
                        Y = mean(Y, op.level) if size > 1 else Y
                        usize = size
                    if op.level >= 1 and hier.num_siblings(op.level) > 1:
                        Y = gossip(Y, op.level, op.pi)
                        usize = size
            return Y
        return structured
    sim._mixer = mixer
    sim._compact_enabled = False


def _single_rounds(dev, fl_changes, rounds, opt, rt, one_row: bool = False,
                   lowering_order: bool = False):
    """The single-process engine's params after each round of one run,
    on the card from the phase's seeds (each SGD step one row at a time
    where ``one_row``; each boundary summed in the sharded lowering's
    order where ``lowering_order``), and its loss at the end."""
    import gc
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.models.cnn import apply_femnist_cnn, init_femnist_cnn
    fl, kw = _sharded_config(fl_changes, opt)
    sim = FLSimulator(init_femnist_cnn, apply_femnist_cnn, fl,
                      femnist_data(fl), lr=opt.get("lr", SHARDED_LR),
                      batch_size=16, seed=0, device=dev, **kw)
    if one_row:
        _one_row_at_a_time(sim)
    if lowering_order:
        _lowering_order_mixing(sim)
    rows = []
    _run_rounds(sim, rounds, opt, rt,
                lambda r: rows.append(sim.bank.params.cpu().numpy()))
    loss = sim.evaluate()[1]
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return rows, loss


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    """Max abs difference; inf where exactly one side is not finite, 0
    where both are not finite in the same places and agree elsewhere."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    if (fa != fb).any():
        return math.inf
    return float(np.abs(a[fa] - b[fb]).max(initial=0.0))


def phase_sharded(dev: torch.device) -> None:
    """The device-parallel bank engine (``ShardedBankCEFedAvg``) at the
    FEMNIST CNN's full width: 8 rank processes of one gloo world share
    the card, each holding one bank row, for each run of
    ``SHARDED_RUNS``, cuDNN held to deterministic algorithms in every
    engine. Every round's rows are held within ``SHARDED_ATOL`` to the
    single-process engine from the same seeds taking its SGD steps one
    row at a time and summing each boundary in the sharded lowering's
    order, as the ranks do; one block (the first two runs) also to the
    engine as it stands. The gap to that engine is printed beside its
    two causes, each measured in the single-process engine alone: the
    n-row vmap against one row at a time (one grouped convolution sums
    in another order than n convolutions of one row) and B1 against the
    lowering's order of sums, both amplified by the CNN's local steps.
    Each boundary lowering (the grouped means and gossip matchings of
    every tier, the weighted rotations of a dense operator) is held to
    B1 on the same full-width rows."""
    from repro_torch.core.runtime import compute_bound_runtime_model
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.launch.mesh import run_local_ranks
    rt = compute_bound_runtime_model()
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        single = {}
        for name, fl_changes, rounds, opt in SHARDED_RUNS:
            t0 = time.perf_counter()
            eng, loss = _single_rounds(dev, fl_changes, rounds, opt, rt)
            again, _ = _single_rounds(dev, fl_changes, rounds, opt, rt)
            one, _ = _single_rounds(dev, fl_changes, rounds, opt, rt,
                                    one_row=True)
            wit, wloss = _single_rounds(dev, fl_changes, rounds, opt, rt,
                                        one_row=True, lowering_order=True)
            causes = [(_gap(e, a), _gap(e, o), _gap(o, w)) for e, a, o, w
                      in zip(eng, again, one, wit)]
            single[name] = (eng, wit, causes)
            log(f"[sharded] {name}: the single-process engine, {rounds} "
                f"round(s) of n = {SHARDED_RANKS} on the card at lr "
                f"{opt.get('lr', SHARDED_LR)}, cuDNN deterministic, four "
                f"times in {time.perf_counter() - t0:.3f} s; loss "
                f"{loss:.4f} (one row at a time, in the lowering's order "
                f"of sums {wloss:.4f}); by round, two runs apart "
                f"{', '.join(f'{c[0]:.3e}' for c in causes)}, the n-row "
                f"vmap against one row at a time "
                f"{', '.join(f'{c[1]:.3e}' for c in causes)}, then B1 "
                f"against the lowering's order of sums "
                f"{', '.join(f'{c[2]:.3e}' for c in causes)}")
        log(f"[sharded] {SHARDED_RANKS} rank processes of one gloo world "
            f"on this one card, one full-width FEMNIST-CNN bank row each "
            f"(configs/femnist_cnn.py's tau, q, pi on a ring, batch 16, lr "
            f"{SHARDED_LR} but where a run says; its 64 devices cut to 4 "
            f"clusters x 2: one card cannot host 64 rank processes)")
        t0 = time.perf_counter()
        ranks = run_local_ranks(_sharded_rank, SHARDED_RANKS,
                                args=(SHARDED_RUNS,), backend="gloo",
                                device="cuda", timeout_s=900)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    log(f"[sharded] world of {SHARDED_RANKS} ranks: "
        f"{time.perf_counter() - t0:.1f} s from spawn to the last result")
    bad = []
    for i, (name, _, rounds, opt) in enumerate(SHARDED_RUNS):
        res = [r[i] for r in ranks]
        T = res[0]["T"]
        assert T == FEMNIST_T, T
        for r in res:
            assert r["shapes"] and all(s == (1, T) for s in r["shapes"]), \
                (name, r["shapes"])
        eng, wit, causes = single[name]
        for k in range(rounds):
            secs = max(r["rounds"][k]["seconds"] for r in res)
            rows = np.concatenate([r["rounds"][k]["params"] for r in res])
            gap_w, gap_e = _gap(rows, wit[k]), _gap(rows, eng[k])
            traffic = [r["rounds"][k]["traffic"] for r in res]
            ops = sorted({op for t in traffic for op in t})

            def most(op, what):
                return max(t[op][what] for t in traffic)
            by_op = "; ".join(
                f"{op} x{most(op, 'calls')} sent "
                f"{most(op, 'sent') / 1e6:.1f} MB recv "
                f"{most(op, 'recv') / 1e6:.1f} MB" for op in ops)
            held = f" (atol {SHARDED_ATOL})" if opt.get("block") else ""
            log(f"[sharded] {name} round {k + 1}: {secs:.3f} s (max over "
                f"ranks; gloo on one card, not a multi-card speed), "
                f"transport {res[0]['transport']}; a rank's traffic (max "
                f"over ranks): {by_op}; finite rows "
                f"{bool(np.isfinite(rows).all())}; rows against the "
                f"single-process engine one row at a time in the "
                f"lowering's order of sums {gap_w:.3e} (atol "
                f"{SHARDED_ATOL}), against the engine as it stands "
                f"{gap_e:.3e}{held} (its causes above: {causes[k][1]:.3e} and "
                f"{causes[k][2]:.3e})")
            if not gap_w <= SHARDED_ATOL:
                bad.append((name, k + 1, "in the lowering's order", gap_w))
            if opt.get("block") and not gap_e <= SHARDED_ATOL:
                bad.append((name, k + 1, "the engine as it stands", gap_e))
            if "scenario" not in opt and any(
                    op in ("gather", "all_gather") for op in ops):
                bad.append((name, k + 1, "gathered", ops))
        # the boundary lowerings against B1 on the same full-width rows
        Y = torch.from_numpy(np.concatenate(
            [r["rounds"][-1]["params"] for r in res])).to(dev)
        errs = []
        for key in res[0]["probe"]:
            W = PROBE_W if key == "dense" else res[0]["operators"][key]
            exp = gm.gossip_mix_rows(
                torch.from_numpy(np.asarray(W, np.float32)).to(dev),
                Y.clone()).cpu().numpy()
            got = np.concatenate([r["probe"][key] for r in res])
            errs.append(_gap(got, exp))
            what = ("weighted rotations of a dense operator"
                    if key == "dense" else f"tier {key} grouped mean + "
                    "gossip")
            log(f"[sharded] {name}: boundary lowering {what} against B1 on "
                f"the 8 full-width rows: max abs err {errs[-1]:.3e} (atol "
                f"{SHARDED_ATOL})")
        del Y
        peaks = ", ".join(f"{r['peak'] / 1e9:.3f}" for r in res)
        log(f"[sharded] {name}: rows (1, {T}) on every rank; loss "
            f"{res[0]['loss']:.4f} acc {res[0]['acc']:.4f}; peak device "
            f"memory by rank {peaks} GB; gossip_mix launches in the ranks "
            f"{sum(r['launches'] for r in res)} (collectives carry every "
            f"boundary)")
        if not max(errs) <= SHARDED_ATOL:
            bad.append((name, "boundary lowerings", errs))
        if "lr" not in opt and not math.isfinite(res[0]["loss"]):
            bad.append((name, "loss", res[0]["loss"]))
        assert sum(r["launches"] for r in res) == 0
    del ranks, single
    torch.cuda.empty_cache()
    assert not bad, bad


# ---------------------------------------------------------------------------
# phase 11: the card against the CPU
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
    _parity_scenarios(dev, pfl, pdata, pinit)
    _parity_upload(dev, pfl, pdata, pinit)
    _parity_lm(dev)
    _parity_lm_families(dev)


def _card_vs_cpu(dev: torch.device, what: str, build, run, read,
                 atol: float = PARITY_ATOL) -> None:
    """Build, run and read one small simulation on the card and on the
    CPU; every array ``read`` returns must agree within ``atol``."""
    out = {}
    for where in (dev, torch.device("cpu")):
        sim = build(where)
        note = run(sim)
        out[where.type] = [np.asarray(a, np.float32) for a in read(sim)]
    err = max(float(np.abs(a - b).max())
              for a, b in zip(out["cuda"], out["cpu"]))
    log(f"[parity] {what}: card vs CPU max abs diff {err:.3e} (atol "
        f"{atol}){note}")
    assert err <= atol, f"card and CPU disagree: {what}"


def _parity_scenarios(dev: torch.device, fl, data, init) -> None:
    """The paths this slice adds, at the small population's geometry
    (MLP 16-32-4, 4 clusters of 4): a compacted faulted scenario, the
    enumerated streamed engine pipelined under outages, an adaptive_tau
    schedule and an s=2 async round."""
    from repro_torch.core import scenario as scn
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.runtime import compute_bound_runtime_model
    from repro_torch.models.cnn import apply_mlp_classifier

    def scenario(name, faults=None):
        return dataclasses.replace(
            scn.get_scenario(name), seed=7,
            faults=None if faults is None else scn.get_faults(faults))

    def sim_of(**kw):
        return lambda where: FLSimulator(
            lambda g: init, apply_mlp_classifier, fl, data, lr=0.1,
            batch_size=16, seed=1, device=where, **kw)

    def bank(sim):
        return sim.bank.params.cpu().numpy(), sim.bank.mom.cpu().numpy()

    def rounds(k):
        def run(sim):
            buckets = []
            for _ in range(k):
                sim.step_round()
                buckets.append(sim.last_bucket)
            return f"; slab/cohort rows by round {buckets}"
        return run

    _card_vs_cpu(dev, "compacted scenario (sampled, chaos faults), 3 "
                 "rounds, bank", sim_of(scenario=scenario("sampled",
                                                           "chaos")),
                 rounds(3), bank)

    def streamed(sim):
        ids = sim.store.snapshot()["ids"]
        return (_global_row(sim), sim.store.cluster_params,
                sim.store.fetch(ids))
    _card_vs_cpu(dev, "enumerated streamed engine (sampled, outage faults, "
                 "f32, pipelined), 3 rounds, global model and store",
                 sim_of(scenario=scenario("sampled", "outage"),
                        streaming=True, pipeline=True),
                 rounds(3), streamed)
    _card_vs_cpu(dev, "adaptive_tau schedule (bimodal), 2 rounds, bank",
                 sim_of(scenario=scenario("bimodal"),
                        schedule="adaptive_tau"), rounds(2), bank)
    rt = compute_bound_runtime_model()

    def async_rounds(sim):
        events = []
        for _ in range(2):
            sim.step_round_async(2, rt)
            events.append(len(sim.last_async["trace"]))
        return f"; events by round {events}"
    _card_vs_cpu(dev, "async rounds at staleness 2 (lognormal), 2 rounds, "
                 "bank", sim_of(scenario=scenario("lognormal")),
                 async_rounds, bank)


def _parity_upload(dev: torch.device, fl, data, init) -> None:
    """The upload path at the small population's geometry: one int8+EF
    round (within the int8 tolerance: a floor may flip on a last-ulp
    difference of its input) and one DP round (1e-5), card against CPU;
    then the device threefry bits against the host numpy path, bit for
    bit, at (64, 2^20 + 3)."""
    from repro_torch import random as rnd
    from repro_torch.core.cefedavg import FLSimulator
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.core.privacy import DPConfig
    from repro_torch.models.cnn import apply_mlp_classifier

    def sim_of(**kw):
        return lambda where: FLSimulator(
            lambda g: init, apply_mlp_classifier, fl, data, lr=0.1,
            batch_size=16, seed=1, device=where, **kw)

    def one_round(sim):
        sim.step_round()
        return ""

    def bank(sim):
        b = sim.bank
        return [t.cpu().numpy() for t in (b.params, b.mom, b.residual)
                if t is not None]
    _card_vs_cpu(dev, "int8+EF upload, 1 round, bank and residual",
                 sim_of(compression=CompressionConfig("int8")), one_round,
                 bank, atol=INT8_ATOL)
    _card_vs_cpu(dev, "local DP upload (clip 1.0, sigma 0.5), 1 round, bank",
                 sim_of(dp=DPConfig(clip_norm=1.0, noise_multiplier=0.5)),
                 one_round, bank)
    keys = rnd.split(rnd.PRNGKey(17), 64)
    shape = (2**20 + 3,)
    t0 = time.perf_counter()
    host = rnd.random_bits(keys, shape)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = rnd.device_bits(keys, shape, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    bad = int((card.cpu().numpy().view(np.uint32) != host).sum())
    log(f"[parity] threefry bits at (64, 2^20 + 3): card vs host numpy "
        f"{bad} of {host.size} words differ ({card_s:.3f} s on the card "
        f"with its first launches, {host_s:.2f} s on the host)")
    assert bad == 0, "device bits differ from the host stream"
    u = rnd.uniform(keys, shape, dev).cpu().numpy().view(np.uint32)
    exp = ((host >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1)
    assert np.array_equal(u, exp.view(np.uint32)), \
        "device uniforms differ from the host's"


def _parity_lm(dev: torch.device) -> None:
    """The reduced Zamba2 (2 groups of 2 Mamba-2 blocks, GQA 4/2 heads,
    chunk 64) over 2 x 300 tokens: the card's forward (both kernels)
    against the CPU's (plain versions), same weights, f32."""
    from repro_torch.configs import get_model_config
    from repro_torch.data.lm import synthetic_lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import model as mdl
    from repro_torch import tree as tr
    cfg = get_model_config("zamba2-2.7b").reduced(num_layers=4)
    params = mdl.init_model(torch.Generator().manual_seed(5), cfg, "cpu")
    batch = synthetic_lm_batch((2, 300), cfg.vocab_size, seed=5)
    with torch.inference_mode():
        host, _ = mdl.forward(cfg, params, batch)
        on_card = tr.tree_map(lambda t: t.to(dev), params)
        fa.launches = ss.launches = 0
        card, _ = mdl.forward(cfg, on_card, batch)
        launches = (fa.launches, ss.launches)
    err = max_err(card.cpu(), host, LM_PARITY_TOL,
                  "reduced zamba2 forward, card vs CPU")
    log(f"[parity] reduced zamba2-2.7b (4 layers, 2 x 300 tokens, f32): card "
        f"(flash_attention x{launches[0]}, ssd_intra_chunk x{launches[1]}) "
        f"vs CPU (plain) logits max abs diff {err:.3e} (atol = rtol = "
        f"{LM_PARITY_TOL})")
    assert launches == (2, 4), launches


# ---------------------------------------------------------------------------
# phase 2b: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def _bound(nbytes: float, flops: float, peak: float):
    """The least time (ms) for ``nbytes`` of traffic and ``flops`` at
    ``peak``, and which of the two sets it."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _refused(fn, what: str, counter=None) -> None:
    """Raises unless ``fn()`` raises the wrapper's refusal (its layout
    check, or the launcher's error) and launches nothing: a bf16 layout
    that the tensor-core kernel cannot take runs nowhere else.
    ``counter`` reads the wrapper's launch count."""
    before = counter() if counter else None
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        if "launch failed" not in str(e) and "does not take" not in str(e):
            raise
    else:
        raise AssertionError(f"{what}: launched, want it refused")
    if counter and counter() != before:
        raise AssertionError(f"{what}: refused, but counted a launch")


def phase_flash_attention(dev: torch.device) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(dev).manual_seed(11)
    worst = {dt: 0.0 for dt in FA_TOL}
    for BH, Sq, Sk, D in FA_SWEEP:
        for causal, window in FA_MASKS:
            for dt, tol in FA_TOL.items():
                q, k, v = (torch.randn((BH, S, D), device=dev, generator=gen
                                       ).to(dt) for S in (Sq, Sk, Sk))
                worst[dt] = max(worst[dt], max_err(
                    fa.flash_attention(q, k, v, causal=causal,
                                       window=window),
                    ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window), tol,
                    f"flash_attention {BH}x{Sq}x{Sk}x{D} causal={causal} "
                    f"window={window} {dt}", rtol=0))
    # GQA through the (B, S, H, D) adapter, with a q_offset
    for dt, tol in FA_TOL.items():
        q = torch.randn((2, 192, 8, 64), device=dev, generator=gen).to(dt)
        k, v = (torch.randn((2, 256, 2, 64), device=dev, generator=gen
                            ).to(dt) for _ in range(2))
        for causal, window, off in ((True, 0, 64), (True, 40, 0),
                                    (False, 0, 0)):
            worst[dt] = max(worst[dt], max_err(
                fa.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window, q_offset=off),
                ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                             window=window, q_offset=off),
                tol, f"flash_attention_bshd GQA 8/2 causal={causal} "
                f"window={window} q_offset={off} {dt}", rtol=0))
    log(f"[kernels] flash_attention sweep (5 shapes x 3 masks x f32/bf16, "
        f"GQA adapter): max abs err f32 {worst[torch.float32]:.3e} (tol "
        f"{FA_TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} (tol "
        f"{FA_TOL[torch.bfloat16]})")
    # the Zamba2 head size through the GQA adapter: ragged Sq and Sk (not
    # multiples of the 128-row block or the 128-key tile), a window, a
    # q_offset, and q, k, v as views of one fused projection (strided)
    for dt, tol in FA_TOL.items():
        fused = torch.randn((2, 328, 12, 80), device=dev, generator=gen
                            ).to(dt)
        k, v = fused[:, :, 8:10], fused[:, :, 10:]
        for Sq, causal, window, off in ((200, True, 0, 128),
                                        (200, True, 96, 64),
                                        (328, True, 0, 0),
                                        (70, False, 0, 0)):
            q = fused[:, :Sq, :8]
            worst[dt] = max(worst[dt], max_err(
                fa.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window, q_offset=off),
                ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                             window=window, q_offset=off),
                tol, f"flash_attention_bshd D=80 GQA 8/2 Sq={Sq} Sk=328 "
                f"causal={causal} window={window} q_offset={off} {dt}",
                rtol=0))
    log(f"[kernels] flash_attention D=80 through the GQA adapter (strided "
        f"views, ragged Sq 200/70 and Sk 328, window 96, q_offset 64/128): "
        f"max abs err so far f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e}")
    count = lambda: fa.launches  # noqa: E731
    q = torch.randn((1, 64, 2, 72), device=dev, generator=gen).to(
        torch.bfloat16)
    _refused(lambda: fa.flash_attention_bshd(q, q, q), "flash_attention "
             "bf16 D=72", count)
    q = torch.randn(64 * 64 + 1, device=dev, generator=gen).to(
        torch.bfloat16)[1:].view(1, 64, 1, 64)
    _refused(lambda: fa.flash_attention_bshd(q, q, q), "flash_attention "
             "bf16 at a 2-byte offset", count)
    q = torch.randn((2, 64, 2, 64), device=dev, generator=gen).to(
        torch.bfloat16)
    kx = q[:1].expand(2, 64, 2, 64)
    _refused(lambda: fa.flash_attention_bshd(q, kx, kx), "flash_attention "
             "bf16 with an expanded (stride-0) batch axis", count)
    log("[kernels] flash_attention refuses bf16 at D=72, at a 2-byte "
        "offset and with a stride-0 axis (the TMA kernel's maps cannot "
        "describe them; no other bf16 kernel)")

    # the prefill's shape, in the model's (B, S, H, D) layout
    B, S, H, D = LM_BATCH, LM_SEQ, 32, 80
    q, k, v = (torch.randn((B, S, H, D), device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    err = max_err(out, ref.flash_attention_bshd_ref(q, k, v, causal=True),
                  FA_PATH_ATOL, "flash_attention at the prefill shape",
                  rtol=FA_PATH_RTOL)
    del out
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fa.flash_attention_bshd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.flash_attention_bshd_ref(
        q, k, v, causal=True), reps=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True))
    # q, k, v read once and o written once; the causal band's two
    # products (S(S+1)/2 score entries a head) on the bf16 tensor cores
    nbytes = 4 * B * S * H * D * 2
    flops = 2 * 2 * B * H * D * S * (S + 1) / 2
    b_ms, b_by = _bound(nbytes, flops, BF16_FLOPS)
    log(f"[kernels] flash_attention prefill shape (B={B}, S={S}, H={H}, "
        f"D={D}, bf16, causal): max abs err {err:.3e} (atol "
        f"{FA_PATH_ATOL}, rtol {FA_PATH_RTOL}); {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"scaled_dot_product_attention {library_ms:.4f}, bound {b_ms:.4f} "
        f"by {b_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"achieved {flops / ms / 1e9:.1f} TFLOP/s)")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    err = max(err, _fa_family_paths(dev, gen))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "launches": 0,
            "max_abs_err": max(err, *worst.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def _attended_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a mask lets through (q_offset 0): what the
    attention's two products must compute."""
    i = np.arange(Sq)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq)
    assert causal or not window, "a window without the causal band"
    return int(np.maximum(hi - lo + 1, 0).sum())


def _fa_family_paths(dev: torch.device, gen: torch.Generator) -> float:
    """B4 at the shapes of the MoE, encoder-decoder and VLM prefills
    (bf16, the model's (B, S, H, D) layout with Hkv kv heads) against its
    plain version, timed beside it and beside one
    ``scaled_dot_product_attention`` call on the kv heads expanded
    (outside the timing; the window as a boolean mask). Returns the worst
    error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = 0.0
    for what, B, Sq, Sk, H, Hkv, D, causal, window in (FA_FAMILY_PATHS
                                                       + FA_TP_PATHS):
        q = torch.randn((B, Sq, H, D), device=dev, generator=gen).to(
            torch.bfloat16)
        k, v = (torch.randn((B, Sk, Hkv, D), device=dev, generator=gen
                            ).to(torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, window=window)
        err = max_err(fa.flash_attention_bshd(q, k, v, **kw),
                      ref.flash_attention_bshd_ref(q, k, v, **kw),
                      FA_PATH_ATOL, f"flash_attention at the {what} shape",
                      rtol=FA_PATH_RTOL)
        worst = max(worst, err)
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fa.flash_attention_bshd(q, k, v, **kw))
        plain_ms = time_ms(lambda: ref.flash_attention_bshd_ref(q, k, v,
                                                                **kw),
                           reps=3, warmup=1)
        torch.cuda.empty_cache()
        qh = q.transpose(1, 2).contiguous()
        kh, vh = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        if window:
            diff = torch.arange(Sq, device=dev)[:, None] - torch.arange(
                Sk, device=dev)[None]
            mask = (diff >= 0) & (diff < window)
            lib = lambda: sdpa(qh, kh, vh, attn_mask=mask)  # noqa: E731
        else:
            lib = lambda: sdpa(qh, kh, vh, is_causal=causal)  # noqa: E731
        library_ms = time_ms(lib)
        pairs = _attended_pairs(Sq, Sk, causal, window)
        nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D)
        flops = 2 * 2 * B * H * D * pairs
        b_ms, b_by = _bound(nbytes, flops, BF16_FLOPS)
        log(f"[kernels] flash_attention {what} (B={B}, Sq={Sq}, Sk={Sk}, "
            f"H/Hkv={H}/{Hkv}, D={D}, causal={causal}, window={window}, "
            f"bf16): max abs err {err:.3e} (atol {FA_PATH_ATOL}, rtol "
            f"{FA_PATH_RTOL}); {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"scaled_dot_product_attention {library_ms:.4f}, bound "
            f"{b_ms:.4f} by {b_by}: {flops / 1e9:.1f} GFLOP over "
            f"{pairs:,} attended pairs a head, {nbytes / 1e6:.1f} MB; "
            f"achieved {flops / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return worst


def _ssd_inputs(gen, dev, BK, H, C, P, N, dt):
    """The reference sweep's inputs: x, B, C normal; a = -|n|/10 and dt =
    |n|/10 (f32 at the prefill shape, as the model gives them)."""
    x = torch.randn((BK, H, C, P), device=dev, generator=gen).to(dt)
    a = -torch.randn((BK, H, C), device=dev, generator=gen).abs() * 0.1
    Bm, Cm = (torch.randn((BK, C, N), device=dev, generator=gen).to(dt)
              for _ in range(2))
    d = torch.randn((BK, H, C), device=dev, generator=gen).abs() * 0.1
    return x, a, Bm, Cm, d


def _ssd_fwd_bound(BK: int, H: int, C: int, P: int, N: int):
    """B5's least time at a bf16 shape: x, a, dt, B, C read once; y and
    the states written once (f32); the products over the lower
    triangle, C Bᵀ once a chunk (shared by the heads), on the bf16
    tensor cores. Returns (ms, by, bytes, flops)."""
    tri = C * (C + 1) / 2
    nbytes = (2 * BK * H * C * P + 2 * 4 * BK * H * C + 2 * 2 * BK * C * N
              + 4 * BK * H * C * P + 4 * BK * H * N * P)
    flops = 2 * BK * (N * tri + H * P * tri + H * C * N * P)
    return (*_bound(nbytes, flops, BF16_FLOPS), nbytes, flops)


def phase_ssd_scan(dev: torch.device) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(dev).manual_seed(12)
    worst = {dt: 0.0 for dt in SSD_TOL}
    for shape in SSD_SWEEP:
        for dt, tol in SSD_TOL.items():
            x, a, Bm, Cm, d = _ssd_inputs(gen, dev, *shape, dt)
            if dt == torch.bfloat16:  # the sweep's a and dt are bf16 too
                a, d = a.to(dt), d.to(dt)
            got, exp = ss.ssd_intra_chunk(x, a, Bm, Cm, d), \
                ref.ssd_intra_chunk_ref(x, a, Bm, Cm, d)
            for o, e, what in zip(got, exp, ("y", "states")):
                worst[dt] = max(worst[dt], max_err(
                    o, e, tol, f"ssd_intra_chunk {shape} {dt} {what}"))
    log(f"[kernels] ssd_intra_chunk sweep (3 shapes x f32/bf16, y and "
        f"states): max abs err f32 {worst[torch.float32]:.3e} (tol "
        f"{SSD_TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} (tol "
        f"{SSD_TOL[torch.bfloat16]})")
    x, a, Bm, Cm, d = _ssd_inputs(gen, dev, 1, 2, 64, 64, 16, torch.bfloat16)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    xs.copy_(x.flatten())
    _refused(lambda: ss.ssd_intra_chunk(xs.view(x.shape), a, Bm, Cm, d),
             "ssd_intra_chunk bf16 x at a 2-byte offset")
    log("[kernels] ssd_intra_chunk refuses bf16 x at a 2-byte offset (no "
        "CUDA-core bf16 kernel)")

    # the prefill's shape: both outputs, then y through the adapter in the
    # model's strided layout (x, B, C views of one conv output)
    Bsz, K, C, H, P, N = LM_BATCH, LM_SEQ // 256, 256, 80, 64, 64
    BK = Bsz * K
    x, a, Bm, Cm, d = _ssd_inputs(gen, dev, BK, H, C, P, N, torch.bfloat16)
    got, exp = ss.ssd_intra_chunk(x, a, Bm, Cm, d), \
        ref.ssd_intra_chunk_ref(x, a, Bm, Cm, d)
    err = max(max_err(o, e, SSD_PATH_TOL, f"ssd_intra_chunk prefill {what}")
              for o, e, what in zip(got, exp, ("y", "states")))
    del got, exp
    xBC = torch.randn((Bsz, K * C, H * P + 2 * N), device=dev, generator=gen
                      ).to(torch.bfloat16)
    xv, Bv, Cv = torch.split(xBC, [H * P, N, N], dim=-1)
    xc = xv.reshape(Bsz, K, C, H, P)
    dtc = torch.randn((Bsz, K, C, H), device=dev, generator=gen).abs() * 0.1
    a_t = (-dtc).permute(0, 1, 3, 2)
    args = (xc, a_t, Bv.reshape(Bsz, K, C, N), Cv.reshape(Bsz, K, C, N), dtc)
    err = max(err, max_err(ss.make_intra_fn()(*args),
                           ref.ssd_intra_fn_ref(*args), SSD_PATH_TOL,
                           "ssd_intra_chunk y adapter, prefill layout"))
    got, exp = ss.make_intra_states_fn()(*args), \
        ref.ssd_intra_states_fn_ref(*args)
    err = max(err, *(max_err(o, e, SSD_PATH_TOL,
                             f"ssd_intra_chunk states adapter {what}, "
                             f"prefill layout")
                     for o, e, what in zip(got, exp, ("y", "states"))))
    del xBC, xv, Bv, Cv, xc, dtc, a_t, args, got, exp
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ss.ssd_intra_chunk(x, a, Bm, Cm, d))
    plain_ms = time_ms(lambda: ref.ssd_intra_chunk_ref(x, a, Bm, Cm, d),
                       reps=5)
    b_ms, b_by, nbytes, flops = _ssd_fwd_bound(BK, H, C, P, N)
    log(f"[kernels] ssd_intra_chunk prefill shape (BK={BK}, H={H}, C={C}, "
        f"P={P}, N={N}; x/B/C bf16, a/dt f32): max abs err {err:.3e} (tol "
        f"{SSD_PATH_TOL}, y, states and both strided adapters); {ms:.4f} ms "
        f"(the earlier kernel, one block a chunk and head: 0.362 on an H100 "
        f"80GB HBM3 at 700 W; plain {plain_ms:.4f}, bound {b_ms:.4f} by "
        f"{b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP; no single "
        f"library call computes it)")
    del x, a, Bm, Cm, d
    torch.cuda.empty_cache()
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:50",
            "launches": 0, "max_abs_err": max(err, *worst.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 7: Zamba2-2.7B at full width
# ---------------------------------------------------------------------------

def _lm_breakdown(prof, wall_s: float, tag: str = "lm") -> None:
    """The profiled forward's device time: the two kernels and the GEMMs
    by name, then the top kernels."""
    device_breakdown(prof, wall_s, top=12, tag=tag)
    sums = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        name = e.name.lower()
        key = ("flash_attention (B4)" if "flash_attention" in name
               else "ssd_intra_chunk (B5)" if "ssd_intra_chunk" in name
               else "GEMMs (cuBLAS)" if ("gemm" in name or "nvjet" in name
                                         or "xmma" in name
                                         or "cutlass" in name)
               else "other")
        sums[key][0] += e.time_range.elapsed_us() / 1e3
        sums[key][1] += 1
    log(f"[{tag}] forward device time by part: " + ", ".join(
        f"{k} {t:.2f} ms x{c}" for k, (t, c) in sorted(
            sums.items(), key=lambda kv: -kv[1][0])))


def phase_lm(dev: torch.device):
    """Returns the launches of flash_attention and ssd_intra_chunk in the
    prefill forward."""
    from repro_torch.configs import get_model_config
    from repro_torch.data.lm import synthetic_lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl
    cfg = get_model_config("zamba2-2.7b")
    batch = synthetic_lm_batch((LM_BATCH, LM_SEQ), cfg.vocab_size, seed=0)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = mdl.init_model(torch.Generator(dev).manual_seed(0), cfg,
                                dev)
        torch.cuda.synchronize()
        n = mdl.param_count(params)
        log(f"[lm] zamba2-2.7b: {n:,} params ({cfg.param_dtype}, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card) "
            f"in {time.perf_counter() - t0:.2f} s; prefill {LM_BATCH} x "
            f"{LM_SEQ} tokens")
        assert n == ZAMBA2_PARAMS, n
        torch.cuda.reset_peak_memory_stats(dev)
        fa.launches = ss.launches = 0
        t0 = time.perf_counter()
        logits, _ = mdl.forward(cfg, params, batch)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = (fa.launches, ss.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mdl.forward(cfg, params, batch)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
    log(f"[lm] prefill forward: {first:.3f} s (first), {second:.3f} s "
        f"(second, under the profiler); logits {shape} finite={finite}; "
        f"launches flash_attention={launches[0]} (want 9) "
        f"ssd_intra_chunk={launches[1]} (want 54); peak device memory "
        f"{peak / 1e9:.2f} GB")
    assert finite and shape == (LM_BATCH, LM_SEQ, 32000), shape
    assert launches == (9, 54), launches
    _lm_breakdown(prof, second)
    del params, prof
    torch.cuda.empty_cache()

    out = serve.main(["--arch", "zamba2-2.7b", "--device", str(dev)])
    log(f"[lm] serve (batch 4, prompt 32, 16 decoded tokens, max-seq 256): "
        f"prefill {out['prefill_s']:.3f} s ({out['prefill_tok_s']:.1f} "
        f"tok/s), decode {out['decode_s']:.3f} s "
        f"({out['decode_tok_s']:.1f} tok/s), finite={out['finite']}")
    assert out["finite"] and tuple(out["tokens"].shape) == (4, 17)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the MoE, encoder-decoder and VLM families at full width
# ---------------------------------------------------------------------------

def _family_batch(cfg, B: int, S: int, dev, seed: int) -> dict:
    """Tokens and labels (B, S), and encdec frames or vlm patch
    embeddings as seeded normals x 0.02 (the reference's
    ``_reduced_batch``), made on ``dev``."""
    from repro_torch.data.lm import synthetic_lm_batch
    batch = synthetic_lm_batch((B, S), cfg.vocab_size, seed=seed)
    gen = torch.Generator(dev).manual_seed(seed)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      device=dev, generator=gen) * 0.02
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.num_patches, cfg.d_model), device=dev,
            generator=gen) * 0.02
    return batch


def _attention_calls(cfg) -> int:
    """Attention calls a forward of ``cfg`` makes: B4's launches a
    forward, and a local step's each way. whisper's encoder self,
    decoder self and cross attention; one a layer otherwise (llama4
    counts a pair as 2 layers)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _moe_layers(cfg) -> int:
    """MoE layers in a forward of ``cfg`` (llama4: one a pair)."""
    if cfg.family != "moe":
        return 0
    return cfg.num_layers // (2 if cfg.moe_shared_expert else 1)


def phase_lm_families(dev: torch.device) -> int:
    """mixtral-8x7b, llama4-maverick, whisper-medium and pixtral-12b at
    full width (bf16, seeded generator on the card, depth cut where one
    card cannot hold the model): one prefill forward (B4 launches as in
    ``_attention_calls``, each MoE layer's dropped assignments, finite
    logits, peak memory), a second under the profiler, then the serve
    driver at the reference's defaults. Returns the B4 launches of the
    four prefills."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl
    total = 0
    for arch, (layers, B, S) in LM_FAMILIES.items():
        cfg = get_model_config(arch)
        cut = layers is not None and layers != cfg.num_layers
        if cut:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        want = _attention_calls(cfg)
        tag = f"lm_families {arch}"
        with torch.inference_mode():
            batch = _family_batch(cfg, B, S, dev, seed=0)
            t0 = time.perf_counter()
            params = mdl.init_model(torch.Generator(dev).manual_seed(0),
                                    cfg, dev)
            torch.cuda.synchronize()
            log(f"[{tag}] {mdl.param_count(params):,} params "
                f"({cfg.family}, {cfg.num_layers} layers"
                f"{' (cut)' if cut else ''}, {cfg.param_dtype}, "
                f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the "
                f"card) in {time.perf_counter() - t0:.2f} s; prefill {B} x "
                f"{S} tokens" + (f" + {cfg.num_patches} patches"
                                 if cfg.family == "vlm" else "")
                + (f", {cfg.encoder_seq} frames" if cfg.family == "encdec"
                   else ""))
            torch.cuda.reset_peak_memory_stats(dev)
            fa.launches = 0
            drops = []
            t0 = time.perf_counter()
            logits, aux = mdl.forward(cfg, params, batch, drops=drops)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            launches = fa.launches
            peak = torch.cuda.max_memory_allocated(dev)
            finite = bool(torch.isfinite(logits).all())
            shape = tuple(logits.shape)
            dropped = [int(d) for d in drops]
            del logits
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                mdl.forward(cfg, params, batch)
                torch.cuda.synchronize()
                second = time.perf_counter() - t0
        S_out = S + (cfg.num_patches if cfg.family == "vlm" else 0)
        assigned = B * S * cfg.experts_per_token
        log(f"[{tag}] prefill forward: {first:.3f} s (first), "
            f"{second:.3f} s (second, under the profiler); logits {shape} "
            f"finite={finite}; flash_attention launches {launches} (want "
            f"{want}); peak device memory {peak / 1e9:.2f} GB"
            + (f"; aux {float(aux):.4f}; dropped assignments a MoE layer "
               f"{dropped} of {assigned:,}" if cfg.family == "moe" else ""))
        assert finite and shape == (B, S_out, mdl.padded_vocab(cfg)), shape
        assert launches == want, (arch, launches)
        assert len(dropped) == _moe_layers(cfg), (arch, dropped)
        _lm_breakdown(prof, second, tag=tag)
        total += launches
        del params, prof, batch
        torch.cuda.empty_cache()

        out = serve.main(["--arch", arch, "--device", str(dev)]
                         + (["--num-layers", str(layers)] if cut else []))
        log(f"[{tag}] serve (batch 4, prompt 32, 16 decoded tokens, "
            f"max-seq 256{f', {layers} layers' if cut else ''}): prefill "
            f"{out['prefill_s']:.3f} s ({out['prefill_tok_s']:.1f} "
            f"tok/s), decode {out['decode_s']:.3f} s "
            f"({out['decode_tok_s']:.1f} tok/s), finite={out['finite']}")
        assert out["finite"] and tuple(out["tokens"].shape) == (4, 17)
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 8: prefill (kernels) against decode steps (no kernel), f32
# ---------------------------------------------------------------------------

def phase_lm_decode(dev: torch.device) -> None:
    import dataclasses
    from repro_torch.configs import get_model_config
    from repro_torch.data.lm import synthetic_lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import model as mdl
    cfg = dataclasses.replace(get_model_config("zamba2-2.7b"),
                              dtype="float32", param_dtype="float32")
    toks = synthetic_lm_batch((LM_BATCH, DECODE_SEQ), cfg.vocab_size,
                              seed=1)["tokens"]
    with torch.inference_mode():
        params = mdl.init_model(torch.Generator(dev).manual_seed(1), cfg,
                                dev)
        fa.launches = ss.launches = 0
        t0 = time.perf_counter()
        full, _ = mdl.forward(cfg, params, {"tokens": toks})
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        fwd_launches = (fa.launches, ss.launches)
        cache = mdl.init_decode_cache(cfg, LM_BATCH, DECODE_SEQ, device=dev)
        tt = torch.from_numpy(toks).to(dev)
        dec = torch.empty_like(full)
        t0 = time.perf_counter()
        for i in range(DECODE_SEQ):
            lg, cache = mdl.decode_step(cfg, params, cache, tt[:, i:i + 1], i)
            dec[:, i] = lg[:, 0]
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    diff = (dec - full).abs()
    err = float(diff.max())
    bad = int((diff > DECODE_TOL + DECODE_TOL * full.abs()).sum())
    log(f"[lm decode] zamba2-2.7b f32, {LM_BATCH} x {DECODE_SEQ} tokens: "
        f"forward {t_fwd:.3f} s (flash_attention x{fwd_launches[0]}, "
        f"ssd_intra_chunk x{fwd_launches[1]}), {DECODE_SEQ} decode steps "
        f"{t_dec:.3f} s (no kernel launch: {fa.launches - fwd_launches[0]}, "
        f"{ss.launches - fwd_launches[1]}); logits max abs diff {err:.3e}, "
        f"{bad} over atol = rtol = {DECODE_TOL}")
    assert fwd_launches == (9, 54), fwd_launches
    assert (fa.launches, ss.launches) == fwd_launches, \
        "a decode step launched a kernel"
    assert bad == 0 and math.isfinite(err), "prefill and decode disagree"
    del params, cache, full, dec
    torch.cuda.empty_cache()


def _fill_cross_caches(cfg, params, frames, cache) -> None:
    """An encdec decode cache's xk/xv from the encoder output, as the
    reference's tests/test_models.py fills them (its serve driver
    decodes against zeros)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as mdl
    enc = mdl._encode(cfg, params, frames)
    ks, vs = zip(*(L.qkv_project(cfg, mdl._layer(params["dec_layers"], i)[
        "cross_attn"], enc, enc)[1:] for i in range(cfg.num_layers)))
    cache["xk"], cache["xv"] = torch.stack(ks), torch.stack(vs)


def phase_lm_decode_families(dev: torch.device) -> None:
    """mixtral, llama4 and whisper reduced, in f32 on the card: the
    kernel forward's logits over 2 x FAMILY_DECODE_SEQ tokens against as
    many decode steps (no kernel), within DECODE_TOL. The property holds
    only where no assignment is dropped (a decode step never drops), so
    MoE runs at capacity_factor E / k, more than T slots an expert:
    asserted 0 drops."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as mdl
    for arch in ("mixtral-8x7b", "llama4-maverick-400b-a17b",
                 "whisper-medium"):
        cfg = get_model_config(arch).reduced()
        if cfg.family == "moe":
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
        B, S = LM_BATCH, FAMILY_DECODE_SEQ
        with torch.inference_mode():
            batch = _family_batch(cfg, B, S, dev, seed=2)
            params = mdl.init_model(torch.Generator(dev).manual_seed(2),
                                    cfg, dev)
            fa.launches = 0
            drops = []
            full, _ = mdl.forward(cfg, params, batch, drops=drops)
            fwd_launches = fa.launches
            cache = mdl.init_decode_cache(cfg, B, S, device=dev)
            if cfg.family == "encdec":
                _fill_cross_caches(cfg, params, batch["frames"], cache)
            tt = torch.from_numpy(batch["tokens"]).to(dev)
            dec = torch.empty_like(full)
            fa.launches = 0
            for i in range(S):
                lg, cache = mdl.decode_step(cfg, params, cache,
                                            tt[:, i:i + 1], i)
                dec[:, i] = lg[:, 0]
            dec_launches = fa.launches
        diff = (dec - full).abs()
        err = float(diff.max())
        bad = int((diff > DECODE_TOL + DECODE_TOL * full.abs()).sum())
        dropped = [int(d) for d in drops]
        log(f"[lm decode] {arch} reduced ({cfg.family}, f32, "
            f"{cfg.num_layers} layers, window {cfg.sliding_window}), {B} x "
            f"{S} tokens: forward (flash_attention x{fwd_launches}) "
            f"against {S} decode steps (flash_attention x{dec_launches}); "
            f"logits max abs diff {err:.3e}, {bad} over atol = rtol = "
            f"{DECODE_TOL}; dropped assignments {dropped}")
        assert fwd_launches > 0 and dec_launches == 0
        assert len(dropped) == _moe_layers(cfg) and not any(dropped)
        assert bad == 0 and math.isfinite(err), \
            f"{arch}: prefill and decode disagree"
        del params, cache, full, dec
    torch.cuda.empty_cache()


def _parity_lm_families(dev: torch.device) -> None:
    """The reduced mixtral, llama4, whisper and pixtral (f32, the CPU
    tests' configs) over 2 x 96 positions: the card's forward (B4)
    against the CPU's (plain), same weights."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as mdl
    from repro_torch import tree as tr
    for arch, want in (("mixtral-8x7b", 2), ("llama4-maverick-400b-a17b", 2),
                       ("whisper-medium", 6), ("pixtral-12b", 2)):
        cfg = get_model_config(arch).reduced()
        S = 96 - (cfg.num_patches if cfg.family == "vlm" else 0)
        cpu = torch.device("cpu")
        batch = _family_batch(cfg, 2, S, cpu, seed=5)
        params = mdl.init_model(torch.Generator().manual_seed(5), cfg, "cpu")
        with torch.inference_mode():
            host, host_aux = mdl.forward(cfg, params, batch)
            on_card = tr.tree_map(lambda t: t.to(dev), params)
            fa.launches = 0
            card, card_aux = mdl.forward(
                cfg, on_card, {k: torch.as_tensor(v).to(dev)
                               for k, v in batch.items()})
            launches = fa.launches
        err = max_err(card.cpu(), host, LM_PARITY_TOL,
                      f"reduced {arch} forward, card vs CPU")
        aerr = abs(float(card_aux) - float(host_aux))
        log(f"[parity] reduced {arch} ({cfg.family}, {cfg.num_layers} "
            f"layers, 2 x 96 positions, f32): card (flash_attention "
            f"x{launches}) vs CPU (plain) logits max abs diff {err:.3e}, aux "
            f"{aerr:.3e} (atol = rtol = {LM_PARITY_TOL})")
        assert launches == want, (arch, launches)
        assert aerr <= LM_PARITY_TOL, (arch, aerr)


# ---------------------------------------------------------------------------
# phase 2c: B4's backward against its plain version
# ---------------------------------------------------------------------------

def _rel_err(out, exp, rel: float, what: str) -> float:
    """max |out - exp| over max |exp|; raises above ``rel``."""
    o, e = out.float(), exp.float()
    err = float((o - e).abs().max())
    scale = float(e.abs().max())
    if not math.isfinite(err) or err > rel * scale:
        raise AssertionError(f"{what}: max abs diff {err:.3e} over "
                             f"{rel} x max |ref| {scale:.3e}")
    return err / max(scale, 1e-30)


def _attend_grad(fa, q, k, v, do, mask):
    """(dq, dk, dv) as training takes them: ``torch.autograd.grad``
    through ``flash_attention_bshd`` (``_FlashAttention``: the forward
    kernel writing the logsumexp, then the backward kernel) on leaves
    that share q, k and v's storage and strides."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_bshd(*leaves, **mask)
    return torch.autograd.grad(out, leaves, do)


def _bwd_check(fa, ref, q, k, v, do, mask, dt, what,
               sliced: bool = False) -> float:
    """B4 as training runs it against the plain versions on the same q,
    k, v and dO. The forward's logsumexp against ``flash_attention_lse_ref``
    (atol = rtol = FA_LSE_TOL); then the gradients through autograd
    against ``flash_attention_bwd_ref`` given the plain forward's output
    and no logsumexp, so that it recomputes P from the true one and a
    wrong logsumexp cannot move both sides together: f32 elementwise
    within FA_BWD_TOL (atol = rtol), bf16 within FA_BWD_TOL of each
    gradient's largest entry. ``sliced``: the kernels run on the whole
    shape and the plain versions on each batch row's kv groups in turn
    (one kv head and its query heads), each slice held on its own.
    Returns the logsumexp's max abs error and the gradients' worst (abs
    for f32, relative for bf16)."""
    _, lse = fa.flash_attention_lse(q, k, v, **mask)
    got = _attend_grad(fa, q, k, v, do, mask)
    B, Hkv = k.shape[0], k.shape[2]
    G = q.shape[2] // Hkv
    parts = ([(slice(b, b + 1), slice(g * G, (g + 1) * G), slice(g, g + 1))
              for b in range(B) for g in range(Hkv)] if sliced
             else [(slice(None),) * 3])
    lse_err = worst = 0.0
    for bs, hs, gs in parts:
        qs, dos = q[bs, :, hs], do[bs, :, hs]
        ks, vs = k[bs, :, gs], v[bs, :, gs]
        o_ref, lse_ref = ref.flash_attention_lse_ref(qs, ks, vs, **mask)
        lse_err = max(lse_err, max_err(lse[bs, hs], lse_ref, FA_LSE_TOL,
                                       f"{what} logsumexp"))
        exp = ref.flash_attention_bwd_ref(qs, ks, vs, o_ref, dos, **mask)
        mine = (got[0][bs, :, hs], got[1][bs, :, gs], got[2][bs, :, gs])
        for name, a, b in zip(("dq", "dk", "dv"), mine, exp):
            assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape)
            if dt == torch.float32:
                worst = max(worst, max_err(a, b, FA_BWD_TOL[dt],
                                           f"{what} {name}"))
            else:
                worst = max(worst, _rel_err(a, b, FA_BWD_TOL[dt],
                                            f"{what} {name}"))
        del o_ref, lse_ref, exp
    return lse_err, worst


def phase_flash_attention_bwd(dev: torch.device) -> dict:
    """B4's backward (``csrc/flash_attention_bwd.cu``) through autograd
    against ``flash_attention_bwd_ref`` on the same inputs, after the
    forward's logsumexp against ``flash_attention_lse_ref``
    (``_bwd_check``): f32 over the reference's sweep and its masks, both
    types through the GQA adapter (a q_offset, a window, non-causal;
    D = 80 views of one fused projection with ragged Sq and Sk), bf16
    at the training shape (qwen2-0.5b's 4 x 2048 tokens, 14 / 2 heads
    of 64, causal), timed beside its plain version and the SDPA
    backward (``device_ms``, by kernel), then bf16 at the MoE,
    encoder-decoder and VLM shapes (``_fa_bwd_family_paths``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(13)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dt)

    worst = {dt: 0.0 for dt in FA_BWD_TOL}
    lse_worst = 0.0

    def check(q, k, v, do, mask, dt, what):
        nonlocal lse_worst
        lse_err, err = _bwd_check(fa, ref, q, k, v, do, mask, dt, what)
        lse_worst = max(lse_worst, lse_err)
        worst[dt] = max(worst[dt], err)

    for BH, Sq, Sk, D in FA_SWEEP:
        for causal, window in FA_MASKS:
            q, do = rnd(BH, Sq, 1, D), rnd(BH, Sq, 1, D)
            k, v = rnd(BH, Sk, 1, D), rnd(BH, Sk, 1, D)
            check(q, k, v, do, dict(causal=causal, window=window),
                  torch.float32, f"flash_attention_bwd {BH}x{Sq}x{Sk}x{D} "
                  f"causal={causal} window={window} f32")
    for dt in FA_BWD_TOL:
        q, do = rnd(2, 192, 8, 64, dt=dt), rnd(2, 192, 8, 64, dt=dt)
        k, v = rnd(2, 256, 2, 64, dt=dt), rnd(2, 256, 2, 64, dt=dt)
        for causal, window, off in ((True, 0, 64), (True, 40, 0),
                                    (False, 0, 0)):
            check(q, k, v, do, dict(causal=causal, window=window,
                                    q_offset=off), dt,
                  f"flash_attention_bwd GQA 8/2 causal={causal} "
                  f"window={window} q_offset={off} {dt}")
        fused = rnd(2, 328, 12, 80, dt=dt)
        k, v = fused[:, :, 8:10], fused[:, :, 10:]
        for Sq, causal, window, off in ((200, True, 0, 128),
                                        (200, True, 96, 64),
                                        (70, False, 0, 0)):
            q, do = fused[:, :Sq, :8], rnd(2, Sq, 8, 80, dt=dt)
            check(q, k, v, do, dict(causal=causal, window=window,
                                    q_offset=off), dt,
                  f"flash_attention_bwd D=80 GQA 8/2 Sq={Sq} Sk=328 "
                  f"causal={causal} window={window} q_offset={off} {dt}")
    log(f"[kernels] flash_attention_bwd sweep (5 shapes x 3 masks f32; GQA "
        f"8/2 with q_offset 64, window 40, non-causal; D=80 strided views, "
        f"ragged Sq 200/70, Sk 328; f32 and bf16): forward logsumexp max "
        f"abs err {lse_worst:.3e} (atol = rtol {FA_LSE_TOL}); gradients "
        f"max err f32 "
        f"{worst[torch.float32]:.3e} abs (atol = rtol "
        f"{FA_BWD_TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} "
        f"of the largest gradient (tol {FA_BWD_TOL[torch.bfloat16]})")

    cfg_h, cfg_hkv, D = 14, 2, 64
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    q, do = (rnd(B, S, cfg_h, D, dt=torch.bfloat16) for _ in range(2))
    k, v = (rnd(B, S, cfg_hkv, D, dt=torch.bfloat16) for _ in range(2))
    mask = dict(causal=True)
    lse_err, err = _bwd_check(fa, ref, q, k, v, do, mask, torch.bfloat16,
                              "flash_attention_bwd at the training shape")
    runs = []
    # run-to-run spread: the kernels sum in one fixed order (no atomics)
    for _ in range(2):
        runs.append(torch.cat([t.float().reshape(-1) for t in
                               _attend_grad(fa, q, k, v, do, mask)]))
    spread = float((runs[0] - runs[1]).abs().max())
    del runs
    # the backward through autograd as training runs it (one recorded
    # forward, its graph kept across the timed calls), and SDPA's the
    # same way: each side's device time by the profiler (ms, library_ms),
    # and each call's time with its host work (CUDA events) beside it
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    og = fa.flash_attention_bshd(qg, kg, vg, **mask)
    bwd = lambda: torch.autograd.grad(og, (qg, kg, vg), do,  # noqa: E731
                                      retain_graph=True)
    ms, by_kernel = device_ms(bwd)
    autograd_ms = time_ms(bwd)
    log("[kernels] flash_attention_bwd training shape, device time a call "
        "by kernel: " + ", ".join(f"{_short_name(n)} {t:.4f} ms"
                                  for n, t in by_kernel.items()))
    o, lse = ref.flash_attention_lse_ref(q, k, v, **mask)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, do, lse=lse, **mask), reps=3)
    del og, o, lse
    torch.cuda.empty_cache()
    sdpa_bwd = _sdpa_bwd(q, k, v, do, mask)
    library_ms, _ = device_ms(sdpa_bwd)
    library_autograd_ms = time_ms(sdpa_bwd)
    del sdpa_bwd
    # q, k, v, o, dO and lse read once, dq, dk, dv written once (q, o,
    # dO and dq of H heads, k, v, dk and dv of Hkv); the five
    # products of the causal band (S(S+1)/2 scores a head) in bf16
    nbytes = (4 * B * S * cfg_h * D + 4 * B * S * cfg_hkv * D) * 2 + \
        B * cfg_h * S * 4
    flops = 5 * 2 * B * cfg_h * D * S * (S + 1) / 2
    b_ms, b_by = _bound(nbytes, flops, BF16_FLOPS)
    log(f"[kernels] flash_attention_bwd training shape (B={B}, S={S}, "
        f"H={cfg_h}/{cfg_hkv}, D={D}, bf16, causal): forward logsumexp max "
        f"abs err {lse_err:.3e} (atol = rtol {FA_LSE_TOL}); gradients "
        f"max err {err:.3e} of "
        f"the largest gradient (tol {FA_BWD_TOL[torch.bfloat16]}), "
        f"run-to-run spread {spread:.3e} (no atomics); device time "
        f"{ms:.4f} ms through autograd (plain {plain_ms:.4f}, SDPA "
        f"backward on the expanded kv heads {library_ms:.4f}, bound "
        f"{b_ms:.4f} by {b_by}: {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; achieved {flops / ms / 1e9:.1f} TFLOP/s); "
        f"a call with its host work (CUDA events) {autograd_ms:.4f}, "
        f"SDPA's {library_autograd_ms:.4f}")
    assert spread == 0.0, spread
    del q, k, v, do, qg, kg, vg
    torch.cuda.empty_cache()
    err = max(err, _fa_bwd_family_paths(dev, gen))
    worst[torch.float32] = max(worst[torch.float32], _fa_tp_paths(dev, gen))
    log(f"[kernels] flash_attention_bwd phase: {time.perf_counter() - t0:.1f} "
        f"s")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:191",
            "launches": 0,
            "max_abs_err": max(err, *worst.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def _short_name(kernel: str) -> str:
    """A profiled kernel's function name, without its namespace, template
    arguments and parameters."""
    m = re.search(r"[A-Za-z_]\w*(?=[<(])", kernel)
    return m[0] if m else kernel


def _sdpa_bwd(q, k, v, do, mask):
    """SDPA's backward through autograd on (B, S, H, D) q, k, v and dO, the
    kv heads expanded to q's (outside what is timed), the window as a
    boolean mask: a function of no arguments, its forward recorded once
    and its graph kept across calls."""
    G = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_(True)
    kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for t in (k, v))
    if mask.get("window"):
        diff = torch.arange(q.shape[1], device=q.device)[:, None] - \
            torch.arange(k.shape[1], device=q.device)[None]
        oh = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=(diff >= 0) & (diff < mask["window"]))
    else:
        oh = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=mask["causal"])
    doh = do.transpose(1, 2)
    return lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                       retain_graph=True)


def _fa_bwd_family_paths(dev: torch.device, gen: torch.Generator) -> float:
    """B4's backward in bf16 through autograd at the FA_FAMILY_PATHS
    shapes (D = 128 with GQA 32/8 and 40/8, windows 4096 and 8192, the
    non-causal whisper encoder, 448 queries across 1500 frames) and at
    FA_BWD_TRAIN_PATHS (pixtral-12b's training batch of 1): held
    against ``flash_attention_bwd_ref`` by ``_bwd_check`` (the plain
    version on each batch row's kv groups in turn where its f32 scores
    would pass FA_BWD_CHECK_BYTES), then its device time through
    autograd at the full shape beside SDPA's backward's
    (``_sdpa_bwd``). Returns the worst relative error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    worst = 0.0
    for what, B, Sq, Sk, H, Hkv, D, causal, window in (
            FA_FAMILY_PATHS + FA_BWD_TRAIN_PATHS):
        q, do = (torch.randn((B, Sq, H, D), device=dev, generator=gen
                             ).to(bf) for _ in range(2))
        k, v = (torch.randn((B, Sk, Hkv, D), device=dev, generator=gen
                            ).to(bf) for _ in range(2))
        mask = dict(causal=causal, window=window)
        cut = B * H * Sq * Sk * 4 > FA_BWD_CHECK_BYTES
        _, err = _bwd_check(fa, ref, q, k, v, do, mask, bf,
                            f"flash_attention_bwd at the {what} shape",
                            sliced=cut)
        worst = max(worst, err)
        torch.cuda.empty_cache()
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        og = fa.flash_attention_bshd(qg, kg, vg, **mask)
        ms, _ = device_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), do, retain_graph=True))
        del qg, kg, vg, og
        sdpa_bwd = _sdpa_bwd(q, k, v, do, mask)
        library_ms, _ = device_ms(sdpa_bwd)
        del sdpa_bwd
        pairs = _attended_pairs(Sq, Sk, causal, window)
        nbytes = (4 * B * Sq * H * D + 4 * B * Sk * Hkv * D) * 2 + \
            B * H * Sq * 4
        flops = 5 * 2 * B * H * D * pairs
        b_ms, b_by = _bound(nbytes, flops, BF16_FLOPS)
        log(f"[kernels] flash_attention_bwd {what} (B={B}, Sq={Sq}, "
            f"Sk={Sk}, H/Hkv={H}/{Hkv}, D={D}, causal={causal}, "
            f"window={window}, bf16): gradients max err {err:.3e} of the "
            f"largest gradient (tol {FA_BWD_TOL[bf]}"
            f"{', the plain version a kv group at a time' if cut else ''}); "
            f"device time {ms:.4f} ms (SDPA backward on the expanded kv "
            f"heads "
            f"{library_ms:.4f}, bound {b_ms:.4f} by {b_by}: "
            f"{flops / 1e9:.1f} GFLOP over {pairs:,} attended pairs a "
            f"head, {nbytes / 1e6:.1f} MB; achieved "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v, do
        torch.cuda.empty_cache()
    return worst


def _fa_tp_paths(dev: torch.device, gen: torch.Generator) -> float:
    """B4 in f32 at the shapes phase 7f launches it at in f32 or bf16
    (FA_TP_PATHS, whose bf16 forward and backward ``_fa_family_paths`` and
    ``_fa_bwd_family_paths`` hold, and FA_TP_REDUCED): the forward's
    output and logsumexp and the gradients through autograd against the
    plain versions (``_bwd_check``, the plain version a kv group at a
    time where its scores pass FA_BWD_CHECK_BYTES), f32 within
    FA_BWD_TOL (atol = rtol). Returns the worst gradient error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    worst = out_worst = 0.0
    f32 = torch.float32
    for what, B, Sq, Sk, H, Hkv, D, causal, window in (FA_TP_PATHS
                                                       + FA_TP_REDUCED):
        q, do = (torch.randn((B, Sq, H, D), device=dev, generator=gen)
                 for _ in range(2))
        k, v = (torch.randn((B, Sk, Hkv, D), device=dev, generator=gen)
                for _ in range(2))
        mask = dict(causal=causal, window=window)
        cut = B * H * Sq * Sk * 4 > FA_BWD_CHECK_BYTES / 4
        o = fa.flash_attention_bshd(q, k, v, **mask)
        G = H // Hkv
        for b in range(B):
            for g in range(Hkv if cut else 1):
                hs = slice(g * G, (g + 1) * G) if cut else slice(None)
                gs = slice(g, g + 1) if cut else slice(None)
                exp, _ = ref.flash_attention_lse_ref(
                    q[b:b + 1, :, hs], k[b:b + 1, :, gs], v[b:b + 1, :, gs],
                    **mask)
                out_worst = max(out_worst, max_err(
                    o[b:b + 1, :, hs], exp, FA_TOL[f32],
                    f"flash_attention f32 output at the {what} shape"))
                del exp
        del o
        _, err = _bwd_check(fa, ref, q, k, v, do, mask, f32,
                            f"flash_attention_bwd f32 at the {what} shape",
                            sliced=cut)
        worst = max(worst, err)
        del q, k, v, do
        torch.cuda.empty_cache()
    log(f"[kernels] flash_attention f32 at phase 7f's shapes ("
        f"{len(FA_TP_PATHS)} full-width rank shapes: qwen2-0.5b 7/1 and "
        f"14/2 at 2 x 1024, zamba2-2.7b 16/16 of 80 at 1 x 4096, "
        f"mixtral-8x7b 16/4 of 128 at 1 x 8192 window 4096; "
        f"{len(FA_TP_REDUCED)} reduced): output max abs err "
        f"{out_worst:.3e} (atol = rtol {FA_TOL[f32]}), gradients "
        f"{worst:.3e} (atol = rtol {FA_BWD_TOL[f32]})")
    return worst


# ---------------------------------------------------------------------------
# phase 2d: B5's backward against its plain version
# ---------------------------------------------------------------------------

SSD_GRADS = ("dx", "da", "dB", "dC", "ddt")


def _ssd_grad(ss, x, a, Bm, Cm, d, dy, dst):
    """(dx, da, dB, dC, ddt) as training takes them: ``torch.autograd.grad``
    through ``ssd_intra_chunk`` (``_SSDIntraChunk``: the forward kernel,
    then the backward kernel) on leaves that share the inputs' storage
    and strides; with ``dst`` None only y is differentiated (the states
    get no gradient)."""
    leaves = [t.detach().requires_grad_(True) for t in (x, a, Bm, Cm, d)]
    y, st = ss.ssd_intra_chunk(*leaves)
    if dst is None:
        return torch.autograd.grad(y, leaves, dy)
    return torch.autograd.grad((y, st), leaves, (dy, dst))


def _ssd_bwd_close(got, exp, dt, what) -> float:
    """Each gradient against its plain version (SSD_BWD_TOL; see there);
    returns the worst error over the largest entry."""
    worst = 0.0
    for name, a, b in zip(SSD_GRADS, got, exp):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape)
        if dt == torch.float32:
            scale = float(b.abs().max())
            err = max_err(a, b, SSD_BWD_TOL[dt] * scale, f"{what} {name}",
                          rtol=SSD_BWD_TOL[dt])
            worst = max(worst, err / max(scale, 1e-30))
        else:
            worst = max(worst, _rel_err(a, b, SSD_BWD_TOL[dt],
                                        f"{what} {name}"))
    return worst


def _ssd_bwd_bound(BK: int, H: int, C: int, P: int, N: int):
    """B5's backward's least time at a bf16 shape: x, dy, dst, a, dt, B
    and C read once, dx, da, ddt, dB and dC written once; C Bᵀ over the
    lower triangle once a chunk, dy xᵀ and Mᵀ dy over it a head, B dst
    and x dstᵀ a head, D B and Dᵀ C once a chunk, on the bf16 tensor
    cores. Returns (ms, by, bytes, flops)."""
    tri = C * (C + 1) / 2
    nbytes = (BK * H * C * P * (2 + 4 + 2) + BK * H * N * P * 4
              + 4 * 4 * BK * H * C + 4 * 2 * BK * C * N)
    flops = 2 * BK * (N * tri + H * (2 * P * tri + 2 * C * N * P)
                      + 2 * N * tri)
    return (*_bound(nbytes, flops, BF16_FLOPS), nbytes, flops)


def _ssd_tp_paths(dev: torch.device, gen: torch.Generator) -> float:
    """B5 forward (y and states) and backward at the shapes phase 7f
    launches it at: zamba2-2.7b's 40-head rank shape in bf16 (forward
    within SSD_PATH_TOL; its backward ``phase_ssd_scan_bwd`` holds with
    the training shapes) and f32, and the reduced configs' (SSD_TP_REDUCED)
    in f32 (forward within SSD_TOL, gradients within SSD_BWD_TOL).
    Returns the worst gradient error over the largest entry."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    Bsz, K, C, H, P, N = SSD_BWD_TRAIN_PATHS["zamba2-2.7b mp 2"]
    rows = [((Bsz * K, H, C, P, N), dt)
            for dt in (torch.bfloat16, torch.float32)]
    rows += [(shape, torch.float32) for shape in SSD_TP_REDUCED]
    worst = fwd = 0.0
    for shape, dt in rows:
        x, a, Bm, Cm, d = _ssd_inputs(gen, dev, *shape, dt)
        tol = SSD_PATH_TOL if dt == torch.bfloat16 else SSD_TOL[dt]
        got, exp = ss.ssd_intra_chunk(x, a, Bm, Cm, d), \
            ref.ssd_intra_chunk_ref(x, a, Bm, Cm, d)
        fwd = max(fwd, *(max_err(o, e, tol, f"ssd_intra_chunk {shape} {dt} "
                                 f"{what}")
                         for o, e, what in zip(got, exp, ("y", "states"))))
        if dt == torch.bfloat16:
            ms = time_ms(lambda: ss.ssd_intra_chunk(x, a, Bm, Cm, d))
            plain_ms = time_ms(lambda: ref.ssd_intra_chunk_ref(
                x, a, Bm, Cm, d), reps=5)
            b_ms, b_by, nbytes, flops = _ssd_fwd_bound(*shape)
            log(f"[kernels] ssd_intra_chunk at zamba2-2.7b's rank shape "
                f"{shape} (bf16): {ms:.4f} ms (plain {plain_ms:.4f}, bound "
                f"{b_ms:.4f} by {b_by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP; {b_ms / ms:.1%} of the bound)")
        if dt == torch.float32:
            BK, H_, C_, P_, N_ = shape
            dy = torch.randn((BK, H_, C_, P_), device=dev, generator=gen)
            dst = torch.randn((BK, H_, N_, P_), device=dev, generator=gen)
            worst = max(worst, _ssd_bwd_close(
                _ssd_grad(ss, x, a, Bm, Cm, d, dy, dst),
                ref.ssd_intra_chunk_bwd_ref(x, a, Bm, Cm, d, dy, dst), dt,
                f"ssd_scan_bwd {shape} f32"))
        del x, a, Bm, Cm, d, got, exp
        torch.cuda.empty_cache()
    log(f"[kernels] ssd_intra_chunk and ssd_scan_bwd at phase 7f's shapes "
        f"(zamba2-2.7b's rank of 40 heads, (BK, H, C, P, N) = "
        f"{rows[0][0]}, bf16 and f32; reduced {SSD_TP_REDUCED} f32): "
        f"forward max abs err {fwd:.3e} (bf16 {SSD_PATH_TOL}, f32 "
        f"{SSD_TOL[torch.float32]}), f32 gradients {worst:.3e} of the "
        f"largest (tol {SSD_BWD_TOL[torch.float32]})")
    return worst


def _ssd_adapter_check(ss, ref, dev, gen, Bsz, K, C, H, P, N, what):
    """B5 through ``make_intra_states_fn`` as the model calls it: x, B, C
    views of one (B, K C, H P + 2 N) conv output, a_t = -dt permuted,
    bf16; the gradients of the conv output and of dt (autograd through
    the views) against the plain backward on the same views, mapped back
    the same way. Returns the worst error over the largest entry."""
    bf = torch.bfloat16
    BK = Bsz * K
    xBC = torch.randn((Bsz, K * C, H * P + 2 * N), device=dev,
                      generator=gen).to(bf).requires_grad_(True)
    dtc = (torch.randn((Bsz, K, C, H), device=dev, generator=gen).abs()
           * 0.1).requires_grad_(True)
    gy = torch.randn((Bsz, K, C, H, P), device=dev, generator=gen)
    gs = torch.randn((Bsz, K, H, N, P), device=dev, generator=gen)
    xv, Bv, Cv = torch.split(xBC, [H * P, N, N], dim=-1)
    args = (xv.reshape(Bsz, K, C, H, P), (-dtc).permute(0, 1, 3, 2),
            Bv.reshape(Bsz, K, C, N), Cv.reshape(Bsz, K, C, N), dtc)
    y, st = ss.make_intra_states_fn()(*args)
    got = torch.autograd.grad((y, st), (xBC, dtc), (gy, gs))
    del y, st
    with torch.no_grad():
        xc, a_t, Bc, Cc, _ = args
        dx, da, dB, dC, ddt = ref.ssd_intra_chunk_bwd_ref(
            xc.permute(0, 1, 3, 2, 4).reshape(BK, H, C, P),
            a_t.reshape(BK, H, C), Bc.reshape(BK, C, N),
            Cc.reshape(BK, C, N), dtc.permute(0, 1, 3, 2).reshape(BK, H, C),
            gy.permute(0, 1, 3, 2, 4).reshape(BK, H, C, P),
            gs.reshape(BK, H, N, P))
        back = lambda t: t.reshape(Bsz, K, H, C).permute(0, 1, 3, 2)  # noqa: E731
        exp_x = torch.cat([dx.reshape(Bsz, K, H, C, P).permute(
            0, 1, 3, 2, 4).reshape(Bsz, K * C, H * P),
            dB.reshape(Bsz, K * C, N), dC.reshape(Bsz, K * C, N)], dim=-1)
        exp_dt = back(ddt) - back(da)
    return max(_rel_err(got[0], exp_x, SSD_BWD_TOL[bf],
                        f"{what} conv output"),
               _rel_err(got[1], exp_dt, SSD_BWD_TOL[bf], f"{what} dt"))


def phase_ssd_scan_bwd(dev: torch.device) -> dict:
    """B5's backward (``csrc/ssd_scan_bwd.cu``) through autograd against
    ``ssd_intra_chunk_bwd_ref`` on the same inputs (``_ssd_bwd_close``):
    over SSD_BWD_SWEEP in f32 and bf16, with a states gradient and
    without; at phase 7e's two training shapes in bf16 through
    ``ssd_intra_chunk`` and through ``make_intra_states_fn`` in the
    model's strided layout (``_ssd_adapter_check``), two runs bit for bit
    (no atomics); each training shape timed by the profiler's device
    time through ``autograd.grad`` (by kernel), beside its bound and the
    plain version's time, and its workspace (SSD_BWD_MAX_WORKSPACE at
    mamba2-2.7b's shape). No one PyTorch call computes this function
    (library_ms None)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(14)
    worst = {dt: 0.0 for dt in SSD_BWD_TOL}
    for shape in SSD_BWD_SWEEP:
        for dt in SSD_BWD_TOL:
            x, a, Bm, Cm, d = _ssd_inputs(gen, dev, *shape, dt)
            BK, H, C, P, N = shape
            dy = torch.randn((BK, H, C, P), device=dev, generator=gen)
            dst = torch.randn((BK, H, N, P), device=dev, generator=gen)
            for states in (dst, None):
                got = _ssd_grad(ss, x, a, Bm, Cm, d, dy, states)
                exp = ref.ssd_intra_chunk_bwd_ref(x, a, Bm, Cm, d, dy,
                                                  states)
                worst[dt] = max(worst[dt], _ssd_bwd_close(
                    got, exp, dt, f"ssd_scan_bwd {shape} {dt} "
                    f"{'with' if states is not None else 'without'} a "
                    f"states gradient"))
    log(f"[kernels] ssd_scan_bwd sweep ({len(SSD_BWD_SWEEP)} shapes: C "
        f"64-256, N 16-128, P 32-128, one head group to a group a head; "
        f"f32 and bf16, with and without a states gradient): max err over "
        f"the largest gradient f32 "
        f"{worst[torch.float32]:.3e} (tol {SSD_BWD_TOL[torch.float32]}, "
        f"rtol and atol of the largest), bf16 {worst[torch.bfloat16]:.3e} "
        f"(tol {SSD_BWD_TOL[torch.bfloat16]})")

    out = None
    for arch, (Bsz, K, C, H, P, N) in SSD_BWD_TRAIN_PATHS.items():
        BK = Bsz * K
        err = _ssd_adapter_check(ss, ref, dev, gen, Bsz, K, C, H, P, N,
                                 f"ssd_scan_bwd {arch} adapter")
        torch.cuda.empty_cache()
        x, a, Bm, Cm, d = _ssd_inputs(gen, dev, BK, H, C, P, N,
                                      torch.bfloat16)
        dy = torch.randn((BK, H, C, P), device=dev, generator=gen)
        dst = torch.randn((BK, H, N, P), device=dev, generator=gen)
        got = _ssd_grad(ss, x, a, Bm, Cm, d, dy, dst)
        exp = ref.ssd_intra_chunk_bwd_ref(x, a, Bm, Cm, d, dy, dst)
        err = max(err, _ssd_bwd_close(got, exp, torch.bfloat16,
                                      f"ssd_scan_bwd {arch} training shape"))
        del exp
        torch.cuda.empty_cache()
        again = _ssd_grad(ss, x, a, Bm, Cm, d, dy, dst)
        spread = max(float((p.float() - q.float()).abs().max())
                     for p, q in zip(got, again))
        del got, again
        leaves = [t.detach().requires_grad_(True) for t in (x, a, Bm, Cm, d)]
        y, st = ss.ssd_intra_chunk(*leaves)
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            (y, st), leaves, (dy, dst), retain_graph=True)
        ms, by_kernel = device_ms(bwd)
        autograd_ms = time_ms(bwd)
        del y, st, leaves
        plain_ms = time_ms(lambda: ref.ssd_intra_chunk_bwd_ref(
            x, a, Bm, Cm, d, dy, dst), reps=3)
        torch.cuda.empty_cache()
        b_ms, b_by, nbytes, flops = _ssd_bwd_bound(BK, H, C, P, N)
        ws = 4 * ss._bwd_library().ssd_scan_bwd_workspace(BK, H, C, N, 1)
        log(f"[kernels] ssd_scan_bwd {arch} training shape, device time a "
            f"call by kernel: " + ", ".join(
                f"{_short_name(n)} {t:.4f} ms" for n, t in by_kernel.items())
            + f"; workspace {ws / 1e6:.1f} MB")
        if arch == "mamba2-2.7b":
            assert ws <= SSD_BWD_MAX_WORKSPACE, ws
        log(f"[kernels] ssd_scan_bwd {arch} training shape (BK={BK}, H={H}, "
            f"C={C}, P={P}, N={N}; x/B/C bf16, a/dt/dy/dst f32): gradients "
            f"max err {err:.3e} of the largest gradient (tol "
            f"{SSD_BWD_TOL[torch.bfloat16]}; also through the strided "
            f"adapter), run-to-run spread {spread:.3e} (no atomics); "
            f"device time {ms:.4f} ms through autograd (plain {plain_ms:.4f}, "
            f"bound {b_ms:.4f} by {b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.1f} GFLOP; {b_ms / ms:.1%} of the bound; no "
            f"single library call computes it); a call with its host work "
            f"(CUDA events) {autograd_ms:.4f}")
        assert spread == 0.0, spread
        if out is None:  # the JSON line's numbers: mamba2-2.7b's shape
            out = {"name": "ssd_scan_bwd", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                   "replaces": "src/repro/models/ssm.py:116",
                   "launches": 0,
                   "max_abs_err": max(err, *worst.values()), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
        else:
            out["max_abs_err"] = max(out["max_abs_err"], err)
        del x, a, Bm, Cm, d, dy, dst
        torch.cuda.empty_cache()
    out["max_abs_err"] = max(out["max_abs_err"], _ssd_tp_paths(dev, gen))
    log(f"[kernels] ssd_scan_bwd phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 7c: federated LM training at full width
# ---------------------------------------------------------------------------

def _lm_train_args(extra):
    """The launcher's flags: its defaults plus ``extra``."""
    from repro_torch.launch import train
    return train._parser().parse_args(["--arch", LM_TRAIN_ARCH] + extra)


def _train_breakdown(prof, wall_s: float, tag: str) -> None:
    """A profiled local step's device time: B4's and B5's forward and
    backward (where the step runs them), the GEMMs and the rest (the
    glue), and the device's busy share."""
    device_breakdown(prof, wall_s, top=8, tag=tag)
    sums = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        name = e.name.lower()
        key = ("B4 backward" if BWD_KERNEL_PREFIX in name
               else "B4 forward" if "flash_attention" in name
               else "B5 backward" if SSD_BWD_KERNEL_PREFIX in name
               else "B5 forward" if "ssd_intra_chunk" in name
               else "GEMMs (cuBLAS)" if ("gemm" in name or "nvjet" in name
                                         or "xmma" in name
                                         or "cutlass" in name)
               else "other")
        sums[key][0] += e.time_range.elapsed_us() / 1e3
        sums[key][1] += 1
    log(f"[{tag}] local step device time by part: " + ", ".join(
        f"{k} {t:.2f} ms x{c}" for k, (t, c) in sorted(
            sums.items(), key=lambda kv: -kv[1][0])))


def _lm_train_rank(flag_sets) -> list:
    """One gloo rank of (b): ``run_pytree_engine`` once a flag set."""
    from repro_torch.launch import train
    out = []
    for flags in flag_sets:
        res = train.run_pytree_engine(_lm_train_args(flags))
        out.append(res)
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _train_parity(dev: torch.device, exp, batch):
    """One global round of ``exp`` (f32) in a world of one on the card
    and on the CPU from the same seeded init (``Generator`` seed 3, on
    the CPU) and ``batch``: the params' max abs difference, then (loss,
    seconds, (B4 forward, backward launches)) on the card and on the
    CPU."""
    from repro_torch import tree as tr
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as lm
    from repro_torch.models import model as mdl
    init = mdl.init_model(torch.Generator().manual_seed(3), exp.model, "cpu")
    out = {}
    for where in (dev, torch.device("cpu")):
        with lm.single_rank_world("gloo", where) as mesh:
            trn = ShardedCEFedAvg(exp, mesh)
            params = tr.tree_map(lambda t: t.to(where), init)
            opt = trn.opt_init(params)
            fa.launches = fa.bwd_launches = 0
            t0 = time.perf_counter()
            params, opt, metrics, _ = trn.make_global_round()(
                params, opt, batch, 0)
            out[where.type] = (tr.tree_map(lambda t: t.cpu(), params),
                               (metrics["loss"], time.perf_counter() - t0,
                                (fa.launches, fa.bwd_launches)))
    (pc, card), (ph, host) = out["cuda"], out["cpu"]
    err = max(float((a - b).abs().max()) for a, b in
              zip(tr.tree_leaves(pc), tr.tree_leaves(ph)))
    return err, card, host


def phase_lm_train(dev: torch.device):
    """Returns B4's forward and backward launches in (a)."""
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.data.lm import learnable_lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import train
    from repro_torch.models import model as mdl

    # (a) one rank: 3 rounds of the launcher's defaults at 4 x 2048
    args = _lm_train_args(["--batch", str(LM_TRAIN_BATCH), "--seq",
                           str(LM_TRAIN_SEQ), "--dist-backend", "gloo"])
    exp = train.lm_experiment(args)
    fl, cfg = exp.fl, exp.model
    tokens = fl.q * fl.tau * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    held = {k: torch.from_numpy(v[0, 0, 0]).to(dev) for k, v in
            learnable_lm_batch((1, 1, 1, LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                               cfg.vocab_size, seed=1000).items()}

    def held_out(params) -> float:
        """The loss on one batch the rounds never see (no grad)."""
        with torch.no_grad():
            return float(mdl.lm_loss(cfg, params, held))

    with lm.single_rank_world("gloo", dev) as mesh:
        trn = ShardedCEFedAvg(exp, mesh)
        t0 = time.perf_counter()
        params, opt = trn.init_fn()(0)
        torch.cuda.synchronize()
        n = mdl.param_count(params)
        log(f"[lm_train] {LM_TRAIN_ARCH}: {n:,} params ({cfg.param_dtype}, "
            f"{cfg.num_layers} layers, d_model {cfg.d_model}, heads "
            f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim}, vocab "
            f"{cfg.vocab_size}), SGD momentum {exp.train.momentum} at lr "
            f"{exp.train.learning_rate}; {torch.cuda.memory_allocated(dev) / 1e9:.2f} "
            f"GB on the card after init ({time.perf_counter() - t0:.2f} s); "
            f"tau {fl.tau}, q {fl.q}, pi {fl.pi}, one replica in a world of "
            f"one, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens a local step")
        assert n == LM_TRAIN_PARAMS, n
        before = held_out(params)
        round_fn = trn.make_global_round()
        step, losses = 0, []
        fa.launches = fa.bwd_launches = 0
        for r in range(LM_TRAIN_ROUNDS):
            batch = learnable_lm_batch((fl.q, fl.tau, 1, LM_TRAIN_BATCH,
                                        LM_TRAIN_SEQ), cfg.vocab_size,
                                       seed=r)
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics, step = round_fn(params, opt, batch, step)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            losses.append(metrics["loss"])
            log(f"[lm_train] round {r}: {sec:.3f} s, {tokens / sec:,.0f} "
                f"local-step tokens/s, loss {metrics['loss']:.4f}, peak "
                f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        launches = (fa.launches, fa.bwd_launches)
        after = held_out(params)
        steps = fl.q * fl.tau * LM_TRAIN_ROUNDS
        log(f"[lm_train] {steps} local steps: flash_attention launches "
            f"{launches[0]}, flash_attention_bwd {launches[1]} (want "
            f"{cfg.num_layers} + {cfg.num_layers} a step); round loss "
            f"{' -> '.join(f'{x:.4f}' for x in losses)}, held-out batch "
            f"{before:.4f} -> {after:.4f} (ln V = "
            f"{math.log(cfg.vocab_size):.2f})")
        assert launches == (cfg.num_layers * steps,) * 2, launches
        assert all(math.isfinite(x) for x in losses), losses
        assert after < before, (before, after)

        # one local step under the profiler
        local = trn.make_local_step()
        params, opt, _, step = local(params, opt, held, step)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, _, step = local(params, opt, held, step)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log(f"[lm_train] one local step under the profiler: {wall:.3f} s "
            f"({LM_TRAIN_BATCH * LM_TRAIN_SEQ / wall:,.0f} tokens/s)")
        _train_breakdown(prof, wall, "lm_train")
        del params, opt, prof, trn, round_fn, local
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    # (b) LM_TRAIN_RANKS gloo ranks on this card, 2 clusters x 2
    flags = ["--data-parallel", str(LM_TRAIN_RANKS), "--clusters", "2",
             "--batch", str(LM_TRAIN_RANK_BATCH), "--seq",
             str(LM_TRAIN_RANK_SEQ), "--rounds", "1", "--dist-backend",
             "gloo"]
    t0 = time.perf_counter()
    ranks = lm.run_local_ranks(
        _lm_train_rank, LM_TRAIN_RANKS,
        args=([flags + ["--gossip", g] for g in ("dense", "ringweight")],),
        backend="gloo", device="cuda", timeout_s=600)
    log(f"[lm_train] {LM_TRAIN_RANKS} gloo ranks on this one card, one "
        f"full-width replica each (2 clusters x 2, {LM_TRAIN_RANK_BATCH} x "
        f"{LM_TRAIN_RANK_SEQ} tokens a local step): "
        f"{time.perf_counter() - t0:.1f} s from spawn to the last result; "
        f"gloo carries the replicas through host memory, so these times "
        f"say nothing of NCCL across cards")
    for i, g in enumerate(("dense", "ringweight")):
        res = [r[i] for r in ranks]
        secs = max(x["hist"]["seconds"][0] for x in res)
        loss = res[0]["hist"]["loss"][0]
        assert all(x["hist"]["loss"][0] == loss for x in res)
        assert math.isfinite(loss), loss
        ops = sorted({op for x in res for op in x["traffic"]})
        by_op = "; ".join(
            f"{op} x{max(x['traffic'][op]['calls'] for x in res)} sent "
            f"{max(x['traffic'][op]['sent'] for x in res) / 1e6:.1f} MB recv "
            f"{max(x['traffic'][op]['recv'] for x in res) / 1e6:.1f} MB"
            for op in ops)
        peaks = ", ".join("not measured" if x["peak_bytes"] is None
                          else f"{x['peak_bytes'] / 1e9:.2f}" for x in res)
        log(f"[lm_train] {g} round: {secs:.3f} s (max over ranks), loss "
            f"{loss:.4f}; a rank's bytes by collective: {by_op}; peak "
            f"device memory by rank {peaks} GB")

    # (c) card against CPU: 2 layers at full width in f32, one round
    pcfg = dataclasses.replace(cfg, num_layers=LM_TRAIN_PARITY_LAYERS,
                               dtype="float32", param_dtype="float32")
    batch = learnable_lm_batch((fl.q, fl.tau, 1, 1, LM_TRAIN_PARITY_SEQ),
                               pcfg.vocab_size, seed=7)
    err, (lc, sc, nc), (lh, sh, nh) = _train_parity(
        dev, dataclasses.replace(exp, model=pcfg), batch)
    log(f"[lm_train] parity: {LM_TRAIN_PARITY_LAYERS} of {cfg.num_layers} "
        f"layers at full width in f32, one round of 1 x "
        f"{LM_TRAIN_PARITY_SEQ} tokens a step: card ({sc:.2f} s; B4 "
        f"forward x{nc[0]}, backward x{nc[1]}) vs CPU ({sh:.2f} s, plain, "
        f"x{nh[0]}) params max abs diff {err:.3e}, loss {lc:.6f} vs "
        f"{lh:.6f} (atol {LM_PARITY_TOL}, TF32 off)")
    assert err <= LM_PARITY_TOL and abs(lc - lh) <= LM_PARITY_TOL
    steps = fl.q * fl.tau
    assert nc == (LM_TRAIN_PARITY_LAYERS * steps,) * 2 and nh == (0, 0), \
        (nc, nh)
    return launches


# ---------------------------------------------------------------------------
# phase 7d: federated training of the MoE, encoder-decoder and VLM
# families at full width
# ---------------------------------------------------------------------------

def _extra_input(cfg) -> tuple:
    """The batch key and length of the positions a family feeds besides
    its tokens: encdec frames, vlm patch embeddings; (None, 0)
    otherwise."""
    return {"encdec": ("frames", cfg.encoder_seq),
            "vlm": ("patch_embeds", cfg.num_patches)}.get(cfg.family,
                                                         (None, 0))


def _train_family_batch(cfg, lead, S: int, dev, seed: int) -> dict:
    """Tokens and labels ``lead + (S,)`` of the reference example's
    learnable stream, plus encdec frames or vlm patch embeddings (seeded
    normals x 0.02 in the config's dtype, made on ``dev``)."""
    from repro_torch.data.lm import learnable_lm_batch
    batch = learnable_lm_batch(tuple(lead) + (S,), cfg.vocab_size,
                               seed=seed)
    key, n = _extra_input(cfg)
    if key is not None:
        gen = torch.Generator(dev).manual_seed(seed)
        batch[key] = (torch.randn(tuple(lead) + (n, cfg.d_model),
                                  device=dev, generator=gen) * 0.02
                      ).to(getattr(torch, cfg.dtype))
    return batch


def phase_lm_train_families(dev: torch.device) -> tuple:
    """Federated training (``ShardedCEFedAvg``, one replica in a world of
    one, the launcher's defaults: tau 2, q 2, pi 4, SGD momentum 0.9 at
    lr 0.05) of whisper-medium (whole: 24 + 24 layers, 2 x (1500 frames
    + 448 tokens) a local step), mixtral-8x7b (3 of 32 layers, 1 x 8192:
    the 4096 window binds) and pixtral-12b (12 of 40 layers, 1 x (1024
    patches + 3072 tokens)) at full width, bf16 from a seeded generator
    on the card, on the example's learnable stream; the cuts and why
    are LM_TRAIN_FAMILIES'. For each: params (asserted) and GB after
    init;
    that the launcher's expanded frames or patches reach the model
    dense; 2 rounds (the first warms up): seconds, local-step tokens
    (positions) a second, loss, peak; a held-out batch's loss before and
    after; mixtral's dropped assignments a MoE layer in the first step;
    B4's forward and backward launches a local step (asserted against
    the config), at shapes phase 2c held the backward at (asserted:
    FA_FAMILY_PATHS, FA_BWD_TRAIN_PATHS); the held-out loss must fall;
    for the cut archs, what is live at the allocator's peak of the first
    (warm-up) round and of the warm-up step before the profiled one (the
    memory history); one profiled local step by part. Then (c) one f32
    round on the card against the CPU (LM_TRAIN_FAMILY_PARITY) within
    LM_PARITY_TOL, B4's launches asserted (none on the CPU). Returns
    B4's forward and backward launches of the bf16 rounds."""
    import gc
    from repro_torch.configs import get_model_config
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.data.lm import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import train
    from repro_torch.models import model as mdl

    checked = {row[1:] for row in FA_FAMILY_PATHS + FA_BWD_TRAIN_PATHS}
    orig_bshd = fa.flash_attention_bshd
    total = [0, 0]
    for arch, (layers, B, S, want_n) in LM_TRAIN_FAMILIES.items():
        tag = f"lm_train_families {arch}"
        args = train._parser().parse_args(
            ["--arch", arch, "--batch", str(B), "--seq", str(S),
             "--dist-backend", "gloo"])
        exp = train.lm_experiment(args)
        cut = layers is not None
        if cut:
            exp = dataclasses.replace(exp, model=dataclasses.replace(
                exp.model, num_layers=layers))
        fl, cfg = exp.fl, exp.model
        key, extra = _extra_input(cfg)
        steps = fl.q * fl.tau
        positions = steps * B * (S + extra)
        calls = _attention_calls(cfg)
        held = {k: torch.as_tensor(v).to(dev) for k, v in
                _train_family_batch(cfg, (B,), S, dev, seed=1000).items()}

        def held_out(params) -> float:
            """The loss on one batch the rounds never see (no grad)."""
            with torch.no_grad():
                return float(mdl.lm_loss(cfg, params, held))

        with lm.single_rank_world("gloo", dev) as mesh:
            trn = ShardedCEFedAvg(exp, mesh)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt = trn.init_fn()(0)
            torch.cuda.synchronize()
            n = mdl.param_count(params)
            log(f"[{tag}] {n:,} params ({cfg.family}, {cfg.param_dtype}, "
                + (f"{cfg.encoder_layers} encoder + " if key == "frames"
                   else "")
                + f"{cfg.num_layers} layers{' (cut)' if cut else ''}, "
                f"d_model {cfg.d_model}, heads {cfg.num_heads}/"
                f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, vocab "
                f"{cfg.vocab_size}); "
                f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the "
                f"card after init ({time.perf_counter() - t0:.2f} s, peak "
                f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB); "
                f"tau {fl.tau}, q {fl.q}, pi {fl.pi}, SGD momentum "
                f"{exp.train.momentum} at lr {exp.train.learning_rate}; "
                f"{B} x ({f'{extra} + ' if extra else ''}{S}) positions "
                f"a local step")
            assert n == want_n, (arch, n)
            if key is not None:
                # the launcher's zero frames / patches are expanded views
                # (stride 0): they reach the model as dense tensors
                fed = trn._on_device(train.lm_round_batch(
                    TokenStream(cfg.vocab_size, 1, trn.geo.cluster_of),
                    cfg, fl.q, fl.tau, B, S))[key]
                assert fed.is_contiguous() and 0 not in fed.stride(), \
                    fed.stride()
                del fed
            before = held_out(params)
            batches = [_train_family_batch(cfg, (fl.q, fl.tau, 1, B), S,
                                           dev, seed=r)
                       for r in range(LM_TRAIN_FAMILY_ROUNDS)]
            dropped = []
            if cfg.family == "moe":
                # the first local step's routing: its microbatch through
                # the params it starts from
                drops = []
                with torch.no_grad():
                    mb = {k: v[0, 0] for k, v in
                          trn._on_device(batches[0]).items()}
                    mdl.forward(cfg, params, mb, drops=drops)
                dropped = [int(d) for d in drops]
                del mb
                assert len(dropped) == _moe_layers(cfg), dropped
            round_fn = trn.make_global_round()
            step, losses = 0, []
            # the shapes B4 attends at in training (a forward that
            # records the graph runs the backward at the same shapes)
            shapes = set()

            def spy(q, k, v, causal=True, window=0, q_offset=0):
                if q.requires_grad or k.requires_grad or v.requires_grad:
                    shapes.add((q.shape[0], q.shape[1], k.shape[1],
                                q.shape[2], k.shape[2], q.shape[3], causal,
                                window, q_offset))
                return orig_bshd(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
            fa.launches = fa.bwd_launches = 0
            for r, batch in enumerate(batches):
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                # the cut archs, whose depth memory sets: the first
                # (warm-up) round under the allocator's memory history
                hist = cut and r == 0
                if hist:
                    base = _start_memory_history(dev)
                fa.flash_attention_bshd = spy if r == 0 else orig_bshd
                try:
                    t0 = time.perf_counter()
                    params, opt, metrics, step = round_fn(params, opt,
                                                          batch, step)
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                finally:
                    fa.flash_attention_bshd = orig_bshd
                    snap = _stop_memory_history() if hist else None
                losses.append(metrics["loss"])
                log(f"[{tag}] round {r}: {sec:.3f} s"
                    f"{' (under the memory history)' if hist else ''}, "
                    f"{positions / sec:,.0f} local-step positions/s, loss "
                    f"{metrics['loss']:.4f}, peak device memory "
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
                    f"({torch.cuda.max_memory_reserved(dev) / 1e9:.2f} GB "
                    f"reserved)")
                if hist:
                    peak_breakdown(snap, dev, base, tag=tag, what="round 0")
                    del snap
            launches = (fa.launches, fa.bwd_launches)
            after = held_out(params)
            n_steps = steps * LM_TRAIN_FAMILY_ROUNDS
            log(f"[{tag}] {n_steps} local steps: flash_attention launches "
                f"{launches[0]}, flash_attention_bwd {launches[1]} (want "
                f"{calls} + {calls} a step); round loss "
                f"{' -> '.join(f'{x:.4f}' for x in losses)}, held-out "
                f"batch {before:.4f} -> {after:.4f} (ln V = "
                f"{math.log(cfg.vocab_size):.2f})"
                + (f"; dropped assignments a MoE layer in the first step "
                   f"{dropped} of {B * S * cfg.experts_per_token:,}"
                   if dropped else ""))
            log(f"[{tag}] B4 training shapes (B, Sq, Sk, H, Hkv, D, causal, "
                f"window, q_offset): {sorted(shapes)}; phase 2c held the "
                f"backward at each: "
                f"{all(x[:-1] in checked and x[-1] == 0 for x in shapes)}")
            assert launches == (calls * n_steps,) * 2, launches
            assert all(math.isfinite(x) for x in losses + [before, after])
            assert after < before, (arch, before, after)
            assert shapes and all(x[:-1] in checked and x[-1] == 0
                                  for x in shapes), sorted(shapes)
            total[0] += launches[0]
            total[1] += launches[1]

            # one local step under the profiler, after a warm-up step
            # (for the cut archs under the memory history: a step's peak
            # against the round's)
            local = trn.make_local_step()
            torch.cuda.reset_peak_memory_stats(dev)
            base = _start_memory_history(dev) if cut else 0
            try:
                params, opt, _, step = local(params, opt, held, step)
                torch.cuda.synchronize()
            finally:
                snap = _stop_memory_history() if cut else None
            if cut:
                peak_breakdown(snap, dev, base, tag=tag,
                               what="a local step")
                del snap
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, _, step = local(params, opt, held, step)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log(f"[{tag}] one local step under the profiler: {wall:.3f} s "
                f"({B * (S + extra) / wall:,.0f} positions/s)")
            _train_breakdown(prof, wall, tag)
            del params, opt, prof, trn, round_fn, local, batches, held
        gc.collect()
        torch.cuda.empty_cache()

    # (c) card against CPU in f32, one round each
    for arch, (layers, B, S) in LM_TRAIN_FAMILY_PARITY.items():
        cfg = get_model_config(arch)
        if layers is None:
            cfg, what = cfg.reduced(), "reduced"
        else:
            cfg = dataclasses.replace(
                cfg, num_layers=layers, encoder_layers=layers,
                dtype="float32", param_dtype="float32")
            what = f"{layers} + {layers} layers at full width"
        exp = train.lm_experiment(train._parser().parse_args(
            ["--arch", arch, "--dist-backend", "gloo"]))
        exp = dataclasses.replace(exp, model=cfg)
        fl = exp.fl
        batch = _train_family_batch(cfg, (fl.q, fl.tau, 1, B), S,
                                    torch.device("cpu"), seed=7)
        err, (lc, sc, nc), (lh, sh, nh) = _train_parity(dev, exp, batch)
        log(f"[lm_train_families] parity: {arch} ({what}, f32), one round "
            f"of {B} x {S} tokens a step: card ({sc:.2f} s; B4 forward "
            f"x{nc[0]}, backward x{nc[1]}) vs CPU ({sh:.2f} s, plain, "
            f"x{nh[0]}) params max abs diff {err:.3e}, loss {lc:.6f} vs "
            f"{lh:.6f} (atol {LM_PARITY_TOL}, TF32 off)")
        assert err <= LM_PARITY_TOL and abs(lc - lh) <= LM_PARITY_TOL, arch
        want = _attention_calls(cfg) * fl.q * fl.tau
        assert nc == (want, want) and nh == (0, 0), (arch, nc, nh)
    return tuple(total)



# ---------------------------------------------------------------------------
# phase 7e: federated training of the ssm and hybrid families at full
# width and depth
# ---------------------------------------------------------------------------

def _remat_bitwise(dev: torch.device, cfg, B: int, S: int) -> bool:
    """One bf16 step's loss and gradients of ``cfg`` (seeded init on the
    card) with remat and without: equal bit for bit. Under PyTorch's
    deterministic algorithms (warnings only): the embedding's gradient
    is an accumulating ``index_put_``, whose order is not fixed
    otherwise (on the CPU two runs without remat differed there)."""
    from repro_torch import tree as tr
    from repro_torch.models import model as mdl
    params = mdl.init_model(torch.Generator(dev).manual_seed(5), cfg, dev)
    leaves, treedef = tr.tree_flatten(params)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             _train_family_batch(cfg, (B,), S, dev, seed=11).items()}

    def grads(remat: bool):
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = mdl.lm_loss(cfg, tr.tree_unflatten(treedef, live), batch,
                           remat=remat)
        return loss.detach(), torch.autograd.grad(loss, live)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        l0, g0 = grads(False)
        l1, g1 = grads(True)
    finally:
        torch.use_deterministic_algorithms(was)
    return torch.equal(l0, l1) and all(torch.equal(a, b)
                                       for a, b in zip(g0, g1))


def phase_lm_train_ssm(dev: torch.device) -> tuple:
    """Federated training (``ShardedCEFedAvg``, one replica in a world of
    one, the launcher's defaults: tau 2, q 2, pi 4, SGD momentum 0.9 at
    lr 0.05) of mamba2-2.7b (all 64 layers, 4 x 2048 tokens a local
    step) and zamba2-2.7b (all 54 layers: 9 groups of 6 Mamba-2 blocks
    and the shared attention block, 2 x 4096) at full width, bf16 from a
    seeded generator on the card, remat on (LM_TRAIN_SSM says why), on
    the example's learnable stream, 2 rounds each: params (asserted) and
    GB after init, round seconds, local-step tokens a second, loss and
    peak; a held-out batch's loss before and after (must fall); B5's
    forward and backward launches (2 + 1 a Mamba-2 block and local step:
    the forward and remat's recomputation, then the backward) and
    zamba2's B4 launches (2 + 1 a group) asserted from the config, B4 at
    shapes phase 2c held its backward at (asserted); one profiled local
    step by part. Then a bf16 step at reduced depth with and without
    remat, bit for bit (LM_TRAIN_SSM_REMAT_LAYERS), and one f32 round of
    each reduced config on the card against the CPU within
    LM_PARITY_TOL, launches asserted. Returns the launches (B4 forward,
    B4 backward, B5 forward, B5 backward) of the bf16 rounds."""
    import gc
    from repro_torch.configs import get_model_config
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import train
    from repro_torch.models import model as mdl

    def experiment(arch, cfg=None, extra=()):
        exp = train.lm_experiment(train._parser().parse_args(
            ["--arch", arch, "--dist-backend", "gloo", *extra]))
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, remat=True))
        return exp if cfg is None else dataclasses.replace(exp, model=cfg)

    def blocks(cfg) -> tuple:
        """(Mamba-2 blocks, attention calls) of a forward."""
        return cfg.num_layers, (cfg.num_layers // cfg.attn_every
                                if cfg.family == "hybrid" else 0)

    checked = {row[1:] for row in FA_FAMILY_PATHS + FA_BWD_TRAIN_PATHS}
    orig_bshd = fa.flash_attention_bshd
    total = [0, 0, 0, 0]
    for arch, (B, S, want_n) in LM_TRAIN_SSM.items():
        tag = f"lm_train_ssm {arch}"
        exp = experiment(arch, extra=("--batch", str(B), "--seq", str(S)))
        fl, cfg = exp.fl, exp.model
        steps = fl.q * fl.tau
        tokens = steps * B * S
        n_ssd, n_attn = blocks(cfg)
        held = {k: torch.as_tensor(v).to(dev) for k, v in
                _train_family_batch(cfg, (B,), S, dev, seed=1000).items()}

        def held_out(params) -> float:
            """The loss on one batch the rounds never see (no grad)."""
            with torch.no_grad():
                return float(mdl.lm_loss(cfg, params, held))

        with lm.single_rank_world("gloo", dev) as mesh:
            trn = ShardedCEFedAvg(exp, mesh)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt = trn.init_fn()(0)
            torch.cuda.synchronize()
            n = mdl.param_count(params)
            log(f"[{tag}] {n:,} params ({cfg.family}, {cfg.param_dtype}, "
                f"{cfg.num_layers} layers"
                + (f" in groups of {cfg.attn_every} + the shared attention "
                   f"block (heads {cfg.num_heads} of {cfg.resolved_head_dim})"
                   if n_attn else "")
                + f", d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
                f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}); "
                f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the "
                f"card after init ({time.perf_counter() - t0:.2f} s); tau "
                f"{fl.tau}, q {fl.q}, pi {fl.pi}, SGD momentum "
                f"{exp.train.momentum} at lr {exp.train.learning_rate}, "
                f"remat; {B} x {S} tokens a local step")
            assert n == want_n, (arch, n)
            before = held_out(params)
            batches = [_train_family_batch(cfg, (fl.q, fl.tau, 1, B), S,
                                           dev, seed=r)
                       for r in range(LM_TRAIN_SSM_ROUNDS)]
            round_fn = trn.make_global_round()
            step, losses = 0, []
            shapes = set()

            def spy(q, k, v, causal=True, window=0, q_offset=0):
                if q.requires_grad or k.requires_grad or v.requires_grad:
                    shapes.add((q.shape[0], q.shape[1], k.shape[1],
                                q.shape[2], k.shape[2], q.shape[3], causal,
                                window, q_offset))
                return orig_bshd(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
            fa.launches = fa.bwd_launches = 0
            ss.launches = ss.bwd_launches = 0
            for r, batch in enumerate(batches):
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                fa.flash_attention_bshd = spy if r == 0 else orig_bshd
                try:
                    t0 = time.perf_counter()
                    params, opt, metrics, step = round_fn(params, opt,
                                                          batch, step)
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                finally:
                    fa.flash_attention_bshd = orig_bshd
                losses.append(metrics["loss"])
                log(f"[{tag}] round {r}: {sec:.3f} s, {tokens / sec:,.0f} "
                    f"local-step tokens/s, loss {metrics['loss']:.4f}, peak "
                    f"device memory "
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
                    f"({torch.cuda.max_memory_reserved(dev) / 1e9:.2f} GB "
                    f"reserved)")
            launches = (fa.launches, fa.bwd_launches, ss.launches,
                        ss.bwd_launches)
            after = held_out(params)
            n_steps = steps * LM_TRAIN_SSM_ROUNDS
            want = (2 * n_attn * n_steps, n_attn * n_steps,
                    2 * n_ssd * n_steps, n_ssd * n_steps)
            log(f"[{tag}] {n_steps} local steps: launches B4 forward "
                f"{launches[0]}, backward {launches[1]}, B5 forward "
                f"{launches[2]}, backward {launches[3]} (want {want}: 2 + 1 "
                f"a block and step under remat); round loss "
                f"{' -> '.join(f'{x:.4f}' for x in losses)}, held-out batch "
                f"{before:.4f} -> {after:.4f} (ln V = "
                f"{math.log(cfg.vocab_size):.2f})")
            if n_attn:
                log(f"[{tag}] B4 training shapes (B, Sq, Sk, H, Hkv, D, "
                    f"causal, window, q_offset): {sorted(shapes)}; phase 2c "
                    f"held the backward at each: "
                    f"{all(x[:-1] in checked and x[-1] == 0 for x in shapes)}")
                assert shapes and all(x[:-1] in checked and x[-1] == 0
                                      for x in shapes), sorted(shapes)
            assert launches == want, (launches, want)
            assert all(math.isfinite(x) for x in losses + [before, after])
            assert after < before, (arch, before, after)
            for i in range(4):
                total[i] += launches[i]

            # one local step under the profiler, after a warm-up step
            local = trn.make_local_step()
            torch.cuda.reset_peak_memory_stats(dev)
            params, opt, _, step = local(params, opt, held, step)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, _, step = local(params, opt, held, step)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log(f"[{tag}] one local step under the profiler: {wall:.3f} s "
                f"({B * S / wall:,.0f} tokens/s), peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
            _train_breakdown(prof, wall, tag)
            del params, opt, prof, trn, round_fn, local, batches, held
        gc.collect()
        torch.cuda.empty_cache()

        layers = LM_TRAIN_SSM_REMAT_LAYERS[arch]
        t0 = time.perf_counter()
        same = _remat_bitwise(dev, dataclasses.replace(cfg,
                                                       num_layers=layers),
                              B, S)
        log(f"[{tag}] remat: {layers} of {cfg.num_layers} layers at full "
            f"width, one bf16 step of {B} x {S} tokens with and without "
            f"remat: loss and gradients equal bit for bit: {same} "
            f"({time.perf_counter() - t0:.1f} s)")
        assert same, arch
        gc.collect()
        torch.cuda.empty_cache()

    # card against CPU in f32: one round of each reduced config
    for arch in LM_TRAIN_SSM:
        cfg = get_model_config(arch).reduced()
        exp = experiment(arch, cfg)
        fl = exp.fl
        batch = _train_family_batch(cfg, (fl.q, fl.tau, 1, 2), 128,
                                    torch.device("cpu"), seed=7)
        ss.launches = ss.bwd_launches = 0
        err, (lc, sc, nc), (lh, sh, nh) = _train_parity(dev, exp, batch)
        nss = (ss.launches, ss.bwd_launches)
        n_ssd, n_attn = blocks(cfg)
        steps = fl.q * fl.tau
        log(f"[lm_train_ssm] parity: {arch} (reduced: {cfg.num_layers} "
            f"layers, d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
            f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}; f32, remat), one round of 2 x 128 tokens a "
            f"step: card ({sc:.2f} s; B5 forward x{nss[0]}, backward "
            f"x{nss[1]}; B4 x{nc[0]}, x{nc[1]}) vs CPU ({sh:.2f} s, plain) "
            f"params max abs diff {err:.3e}, loss {lc:.6f} vs {lh:.6f} "
            f"(atol {LM_PARITY_TOL}, TF32 off)")
        assert err <= LM_PARITY_TOL and abs(lc - lh) <= LM_PARITY_TOL, arch
        assert nss == (2 * n_ssd * steps, n_ssd * steps), (arch, nss)
        assert nc == (2 * n_attn * steps, n_attn * steps) and \
            nh == (0, 0), (arch, nc, nh)
    return tuple(total)

# ---------------------------------------------------------------------------
# phase 7f: tensor parallelism within a replica
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _launch_shapes():
    """Record the shapes of every B4 launch ((B, Sq, Sk, H, Hkv, D,
    causal, window, q_offset), dtype) and B5 launch ((BK, H, C, P, N),
    dtype) in the block, forward and backward alike (a backward runs at
    its forward's shape)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    fa_shapes, ssd_shapes = set(), set()
    orig_fa, orig_ss = fa.flash_attention_bshd, ss._intra_chunk

    def fa_spy(q, k, v, causal=True, window=0, q_offset=0):
        fa_shapes.add(((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                        k.shape[2], q.shape[3], causal, window, q_offset),
                       str(q.dtype)))
        return orig_fa(q, k, v, causal=causal, window=window,
                       q_offset=q_offset)

    def ss_spy(x, a, Bc, Cc, dt):
        ssd_shapes.add((tuple(x.shape) + (Bc.shape[-1],), str(x.dtype)))
        return orig_ss(x, a, Bc, Cc, dt)
    fa.flash_attention_bshd, ss._intra_chunk = fa_spy, ss_spy
    try:
        yield fa_shapes, ssd_shapes
    finally:
        fa.flash_attention_bshd, ss._intra_chunk = orig_fa, orig_ss


def _tp_experiment(arch: str, dp: int, mp: int, extra=()):
    from repro_torch.launch import train
    return train.lm_experiment(train._parser().parse_args(
        ["--arch", arch, "--data-parallel", str(dp), "--model-parallel",
         str(mp), "--dist-backend", "gloo", *extra]))


def _tp_train(run) -> dict:
    """One rank of a LM_TP_RUNS row: the trainer on a (data, model) rank
    mesh, LM_TP_ROUNDS rounds at full width: params (the rank's and the
    replica's whole count), init seconds, per round seconds, loss, peak
    device memory and the bytes of each collective by group; B4's and
    B5's forward and backward launches; the held-out loss before and
    after; the launch shapes."""
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import mesh as lm
    from repro_torch.models import model as mdl
    what, arch, dp, mp, layers, B, S, remat = run
    exp = _tp_experiment(arch, dp, mp, ("--batch", str(B), "--seq", str(S)))
    if layers is not None:
        exp = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, num_layers=layers))
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, remat=remat))
    fl, cfg = exp.fl, exp.model
    mesh = lm.make_replica_mesh(dp, model=mp)
    dev = mesh.device
    trn = ShardedCEFedAvg(exp, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt = trn.init_fn()(0)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    held = {k: torch.as_tensor(v).to(dev) for k, v in
            _train_family_batch(cfg, (B,), S, dev, seed=1000).items()}

    def held_out() -> float:
        with torch.no_grad():
            return float(mdl.lm_loss(cfg, params, held, tp=trn.tp))
    before = held_out()
    batches = [_train_family_batch(cfg, (fl.q, fl.tau, dp, B), S, dev,
                                   seed=r) for r in range(LM_TP_ROUNDS)]
    round_fn = trn.make_global_round()
    step, hist = 0, []
    fa.launches = fa.bwd_launches = ss.launches = ss.bwd_launches = 0
    with _launch_shapes() as (fa_shapes, ssd_shapes):
        for batch in batches:
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.empty_cache()
            torch.cuda.synchronize(dev)
            mesh.reset_traffic()
            t0 = time.perf_counter()
            params, opt, metrics, step = round_fn(params, opt, batch, step)
            torch.cuda.synchronize(dev)
            hist.append({"seconds": time.perf_counter() - t0,
                         "loss": metrics["loss"],
                         "peak": torch.cuda.max_memory_allocated(dev),
                         "traffic": mesh.traffic_by_group()})
        launches = (fa.launches, fa.bwd_launches, ss.launches,
                    ss.bwd_launches)
        after = held_out()
    return {"what": what, "rank": mesh.rank, "replica": mesh.replica,
            "model_index": mesh.model_index,
            "params": mdl.param_count(params),
            "whole": mdl.param_count(trn.param_shapes), "init_s": init_s,
            "init_peak": init_peak, "hist": hist, "launches": launches,
            "steps": fl.q * fl.tau * LM_TP_ROUNDS, "before": before,
            "after": after, "fa": fa_shapes, "ssd": ssd_shapes,
            "cfg": cfg, "remat": remat}


def _tp_parity(arch: str, dp: int, mp: int) -> dict:
    """One rank of a reduced f32 round of ``arch`` at dp x mp from the
    seed-0 init (every model rank draws its replica's whole tree, then
    cuts its slice): the round's loss, the replica's whole params
    (gathered; model rank 0 returns them) and the launch shapes."""
    from repro_torch import tree as tr
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.launch import mesh as lm
    exp = _tp_experiment(arch, dp, mp, ("--reduced",))
    fl, cfg = exp.fl, exp.model
    mesh = lm.make_replica_mesh(dp, model=mp)
    trn = ShardedCEFedAvg(exp, mesh)
    params, opt = trn.init_fn()(0)
    extra = _extra_input(cfg)[1] if cfg.family == "vlm" else 0
    batch = _train_family_batch(cfg, (fl.q, fl.tau, dp, LM_TP_PARITY_B),
                                LM_TP_PARITY_S - extra, torch.device("cpu"),
                                seed=7)
    with _launch_shapes() as (fa_shapes, ssd_shapes):
        params, opt, metrics, _ = trn.make_global_round()(params, opt,
                                                          batch, 0)
    whole = trn.gather(params)
    return {"replica": mesh.replica, "loss": metrics["loss"],
            "params": ([t.cpu().numpy() for t in tr.tree_leaves(whole)]
                       if mesh.model_index == 0 else None),
            "fa": fa_shapes, "ssd": ssd_shapes}


def _tp_rank(jobs) -> list:
    """One gloo rank of phase 7f: ``("train", LM_TP_RUNS row)`` and
    ``("parity", arch, dp, mp)`` jobs in turn (TF32 off)."""
    import gc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for kind, *a in jobs:
        out.append(_tp_train(*a) if kind == "train" else _tp_parity(*a))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_report(res: list, checked: set) -> tuple:
    """Log one LM_TP_RUNS row's ranks and assert its checks; returns its
    launches summed over the ranks."""
    first = res[0]
    what, cfg = first["what"], first["cfg"]
    tag = f"lm_train_tp {what}"
    steps = first["steps"]
    n_attn = {"hybrid": cfg.num_layers // max(cfg.attn_every, 1),
              "ssm": 0}.get(cfg.family, cfg.num_layers)
    n_ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    remat = 2 if first["remat"] else 1
    want = (remat * n_attn * steps, n_attn * steps, remat * n_ssd * steps,
            n_ssd * steps)
    log(f"[{tag}] {len(res)} gloo ranks on this one card: params a rank "
        f"{', '.join(f'{x['params']:,}' for x in res)} (the replica "
        f"{first['whole']:,}; {cfg.num_layers} layers"
        f"{', remat' if remat == 2 else ''}); init "
        f"{max(x['init_s'] for x in res):.2f} s, its peak by rank "
        + ", ".join(f"{x['init_peak'] / 1e9:.2f}" for x in res)
        + " GB")
    for r in range(LM_TP_ROUNDS):
        secs = max(x["hist"][r]["seconds"] for x in res)
        loss = first["hist"][r]["loss"]
        assert all(x["hist"][r]["loss"] == loss for x in res), what
        parts = []
        for group in ("model", "data"):
            ops = sorted({op for x in res
                          for op in x["hist"][r]["traffic"][group]})
            for op in ops:
                got = [x["hist"][r]["traffic"][group].get(op, {})
                       for x in res]
                calls = max(c.get("calls", 0) for c in got)
                sent = max(c.get("sent", 0) for c in got)
                parts.append(f"{group} {op} x{calls} {sent / 1e6:.1f} MB")
        log(f"[{tag}] round {r}: {secs:.3f} s (max over ranks), loss "
            f"{loss:.4f}; a rank's bytes sent by group and collective: "
            f"{'; '.join(parts) or 'none'}; peak device memory by rank "
            + ", ".join(f"{x['hist'][r]['peak'] / 1e9:.2f}" for x in res)
            + " GB")
    launches = tuple(sum(x["launches"][i] for x in res) for i in range(4))
    fa_shapes = set().union(*(x["fa"] for x in res))
    ssd_shapes = set().union(*(x["ssd"] for x in res))
    log(f"[{tag}] {steps} local steps a rank: launches a rank B4 forward "
        f"{first['launches'][0]}, backward {first['launches'][1]}, B5 "
        f"forward {first['launches'][2]}, backward {first['launches'][3]} "
        f"(want {want}); held-out batch {first['before']:.4f} -> "
        f"{first['after']:.4f}; launch shapes B4 {sorted(fa_shapes)}, B5 "
        f"{sorted(ssd_shapes)}")
    assert all(x["launches"] == want for x in res), want
    assert all(math.isfinite(x["hist"][r]["loss"]) for x in res
               for r in range(LM_TP_ROUNDS))
    assert first["after"] < first["before"], (what, first["before"],
                                              first["after"])
    assert (fa_shapes | ssd_shapes) <= checked, sorted(
        (fa_shapes | ssd_shapes) - checked)
    return launches


def phase_lm_train_tp(dev: torch.device) -> tuple:
    """Tensor parallelism within a replica (``--model-parallel``): the
    trainer over gloo ranks that share the card (so the rounds move
    through host memory and say nothing of NCCL across cards). A world
    of 4 ranks runs qwen2-0.5b whole at dp 2 x mp 2, then the reduced f32
    round of every family (LM_TP_PARITY) at dp 2 x mp 2; a world of 2
    runs qwen2-0.5b at dp 2 x mp 1 from the same seed, zamba2-2.7b
    whole at mp 2 with remat, mixtral-8x7b at 3 of 32 layers at mp 2
    (LM_TP_RUNS says why), then the reduced rounds at mp 1. Each
    full-width run logs and asserts (``_tp_report``); qwen2's losses at
    mp 2 within LM_TP_BF16_TOL of mp 1 (asserted); every B4 and B5
    launch shape was held against its plain version in phases 2c and 2d
    (asserted); the reduced rounds at mp 2 within LM_PARITY_TOL of mp 1
    (TF32 off). Returns the full-width runs' launches (B4 forward and
    backward, B5 forward and backward) over all ranks."""
    from repro_torch.launch import mesh as lm
    t0 = time.perf_counter()
    bf, f32 = str(torch.bfloat16), str(torch.float32)
    zb, zk, zc, zh, zp, zn = SSD_BWD_TRAIN_PATHS["zamba2-2.7b mp 2"]
    checked = ({(row[1:] + (0,), bf) for row in FA_FAMILY_PATHS
                + FA_BWD_TRAIN_PATHS}
               | {(row[1:] + (0,), f32) for row in FA_TP_PATHS
                  + FA_TP_REDUCED}
               | {((B * K, H, C, P, N), bf)
                  for B, K, C, H, P, N in SSD_BWD_TRAIN_PATHS.values()}
               | {((zb * zk, zh, zc, zp, zn), f32)}
               | {(shape, f32) for shape in SSD_TP_REDUCED})
    log(f"[lm_train_tp] this process's peak RSS so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB")
    w4 = lm.run_local_ranks(
        _tp_rank, 4, args=([("train", LM_TP_RUNS[0])]
                           + [("parity", a, 2, 2) for a in LM_TP_PARITY],),
        backend="gloo", device="cuda", timeout_s=900)
    t4 = time.perf_counter() - t0
    w2 = lm.run_local_ranks(
        _tp_rank, 2, args=([("train", run) for run in LM_TP_RUNS[1:]]
                           + [("parity", a, 2, 1) for a in LM_TP_PARITY],),
        backend="gloo", device="cuda", timeout_s=900)
    log(f"[lm_train_tp] a world of 4 gloo ranks on this card "
        f"{t4:.1f} s from spawn to the last result, a world of 2 "
        f"{time.perf_counter() - t0 - t4:.1f} s")
    total = [0, 0, 0, 0]
    runs = [[r[0] for r in w4]] + [[r[i] for r in w2]
                                   for i in range(len(LM_TP_RUNS) - 1)]
    for res in runs:
        for i, n in enumerate(_tp_report(res, checked)):
            total[i] += n
    tp, dp = runs[0][0], runs[1][0]
    log(f"[lm_train_tp] qwen2-0.5b dp 2 x mp 2 against dp 2 x mp 1 from the "
        f"same seed (bf16): round loss "
        f"{' -> '.join(f'{h['loss']:.4f}' for h in tp['hist'])} against "
        f"{' -> '.join(f'{h['loss']:.4f}' for h in dp['hist'])}, held-out "
        f"{tp['before']:.4f} -> {tp['after']:.4f} against "
        f"{dp['before']:.4f} -> {dp['after']:.4f} (atol {LM_TP_BF16_TOL})")
    gaps = [abs(a["loss"] - b["loss"]) for a, b in zip(tp["hist"],
                                                      dp["hist"])]
    gaps += [abs(tp[k] - dp[k]) for k in ("before", "after")]
    assert max(gaps) <= LM_TP_BF16_TOL, gaps
    # the reduced f32 rounds: mp 2 against mp 1, replica by replica
    base = len(LM_TP_RUNS) - 1
    worst = 0.0
    for i, arch in enumerate(LM_TP_PARITY):
        got = {r[1 + i]["replica"]: r[1 + i] for r in w4
               if r[1 + i]["params"] is not None}
        want = {r[base + i]["replica"]: r[base + i] for r in w2}
        assert sorted(got) == sorted(want) == [0, 1], arch
        err = max(float(np.abs(a - b).max()) for rep in (0, 1)
                  for a, b in zip(got[rep]["params"], want[rep]["params"]))
        dl = abs(got[0]["loss"] - want[0]["loss"])
        shapes = set().union(*(r[1 + i]["fa"] | r[1 + i]["ssd"] for r in w4),
                             *(r[base + i]["fa"] | r[base + i]["ssd"]
                               for r in w2))
        log(f"[lm_train_tp] parity: {arch} reduced (f32), one round of "
            f"{LM_TP_PARITY_B} x {LM_TP_PARITY_S} positions a step, dp 2 x "
            f"mp 2 against dp 2 x mp 1 on the card: params max abs diff "
            f"{err:.3e}, loss {got[0]['loss']:.6f} vs {want[0]['loss']:.6f} "
            f"(atol {LM_PARITY_TOL}, TF32 off); launch shapes checked: "
            f"{shapes <= checked}")
        assert err <= LM_PARITY_TOL and dl <= LM_PARITY_TOL, (arch, err, dl)
        assert shapes <= checked, (arch, sorted(shapes - checked))
        worst = max(worst, err)
    log(f"[lm_train_tp] phase: {time.perf_counter() - t0:.1f} s")
    return tuple(total)


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
    phase_start(dev, "kernels")
    entry = phase_kernels(dev)
    encode, decode = phase_codec(dev)
    attn = phase_flash_attention(dev)
    attn_bwd = phase_flash_attention_bwd(dev)
    ssd = phase_ssd_scan(dev)
    ssd_bwd = phase_ssd_scan_bwd(dev)
    phase_start(dev, "main")
    entry["launches"] = phase_main(dev)
    phase_start(dev, "population")
    gossip_pop, encode["launches"], decode["launches"] = \
        phase_population(dev)
    phase_start(dev, "scenario")
    gossip_scn = phase_scenario(dev)
    phase_start(dev, "async")
    gossip_async = phase_async(dev)
    phase_start(dev, "upload")
    gossip_upload = phase_upload(dev)
    phase_start(dev, "resume")
    resume_codec = phase_resume(dev)
    log(f"[done] gossip_mix launches: main path {entry['launches']}, "
        f"population path {gossip_pop}, scenario path {gossip_scn}, "
        f"async path {gossip_async}, upload path {gossip_upload}; "
        f"cold_codec encode/decode on the resume path {resume_codec}")
    phase_start(dev, "sharded")
    phase_sharded(dev)
    phase_start(dev, "lm")
    attn["launches"], ssd["launches"] = phase_lm(dev)
    phase_start(dev, "lm_families")
    family_attn = phase_lm_families(dev)
    phase_start(dev, "lm_train")
    train_attn, attn_bwd["launches"] = phase_lm_train(dev)
    phase_start(dev, "lm_train_families")
    fam_train_attn, fam_train_bwd = phase_lm_train_families(dev)
    phase_start(dev, "lm_train_ssm")
    ssm_attn, ssm_attn_bwd, ssm_ssd, ssd_bwd["launches"] = \
        phase_lm_train_ssm(dev)
    phase_start(dev, "lm_train_tp")
    tp_attn, tp_attn_bwd, tp_ssd, tp_ssd_bwd = phase_lm_train_tp(dev)
    log(f"[done] flash_attention launches: zamba2-2.7b prefill "
        f"{attn['launches']}, the four family prefills {family_attn}, "
        f"qwen2-0.5b training {train_attn}, the three families' training "
        f"{fam_train_attn}, zamba2-2.7b training {ssm_attn}; "
        f"flash_attention_bwd launches in training "
        f"{attn_bwd['launches']} (qwen2-0.5b) + {fam_train_bwd} (the "
        f"families) + {ssm_attn_bwd} (zamba2-2.7b); ssd_intra_chunk "
        f"launches: zamba2-2.7b prefill {ssd['launches']}, mamba2-2.7b "
        f"and zamba2-2.7b training {ssm_ssd}; ssd_scan_bwd launches in "
        f"training {ssd_bwd['launches']}; tensor-parallel training (all "
        f"ranks) B4 {tp_attn} + {tp_attn_bwd}, B5 {tp_ssd} + {tp_ssd_bwd}")
    attn["launches"] += (family_attn + train_attn + fam_train_attn + ssm_attn
                         + tp_attn)
    attn_bwd["launches"] += fam_train_bwd + ssm_attn_bwd + tp_attn_bwd
    ssd["launches"] += ssm_ssd + tp_ssd
    ssd_bwd["launches"] += tp_ssd_bwd
    phase_start(dev, "lm decode")
    phase_lm_decode(dev)
    phase_lm_decode_families(dev)
    phase_start(dev, "parity")
    phase_parity(dev)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry, encode, decode, attn, attn_bwd,
                                  ssd, ssd_bwd]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
