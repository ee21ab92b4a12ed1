#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each, each with ``elapsed_s``, the seconds since the
script started; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   (``-Xptxas=-v``: registers and spills; for the mlstm kernels and its
   backward's also their registers and spills by kernel, the shared memory
   of the two forward kernels and of the backward's tiles kernel, and how
   many state-kernel clusters the card holds;
   for every flash kernel of the 3xTF32 route (f32, bf16 at hd 16/32), the
   wgmma backward's and every hd-192 instantiation of the wgmma forward and
   decode their registers, spills and dynamic shared memory);
3. kernel checks: each CUDA kernel against its plain PyTorch version on
   the card at smollm-360m's shapes (tolerance f32 2e-5, bf16 2e-2), plus
   flash at qwen2-72b's attention width (hd 128, G = 8) and at
   nemotron-4-340b's (96 heads over 8, hd 192, bf16 and f32), decode over
   one 8192-key request and at nemotron's width (B=4, ragged kv_len, bf16
   and f32), flash at mixtral-8x7b's attention width (32 heads over 8, hd
   128, B=1 S=8192, the 4096 window) and mixtral-8x22b's (48 over 8) in
   bf16, decode at both (B=4 S=4096, kv_len 4096/1/2000/4096, bf16), and
   mixtral-8x7b's attention at the shapes phase 15 drives: flash at B=2
   S=512 (bf16, window 4096) and B=2 S=96 (f32, window 48), decode at B=2
   over a cache of 32 (bf16, kv_len 31: serving's last step) and of 48
   (f32, kv_len 48: the wrapped ring), and jamba-1.5-large's attention at
   the shapes phase 16 drives (64 heads over 8, hd 128): flash at B=2
   S=512 causal (bf16) and B=2 S=64 causal (f32), decode at B=2 over a
   cache of 32 (bf16, kv_len 31) and of 64 (f32, kv_len 64), and
   whisper-large-v3's at the shapes phase 17 drives (20 heads over 20, hd
   64), bf16 and f32: flash non-causal over its 1500 encoder frames,
   cross-attention flash at Sq = 512, 37 and 1 against Skv = 1500 (no
   mask), and decode over a cross cache of 1500 (kv_len 1500, G = 1),
   these also within ``WHISPER_RMS_TOL`` of the reference's rms; the
   decoder's causal self-attention (G = 1) at B=2 S=512 (bf16) and S=64
   (f32), decode over a cache of 32 (bf16, kv_len 31) and of 64 (f32);
   llama3-405b's (128 heads over 8, G = 16, hd 128, bf16): flash at B=1
   S=2048 causal and decode at phase 12's last serving step (B=2, a cache
   of 48, kv_len 47); AdamW (``csrc/adamw.cu``) over phase 20's mixtral-8x7b
   leaves (1 layer, bf16 parameters) with bf16 and with fp32 gradients: the
   expert stack alone against its plain version (the norm within 1e-6,
   fp32 outputs within ``ADAMW_F32_ULPS`` ulps, bf16 parameters within one
   ulp; ``torch._fused_adamw_`` in fp32 as the yardstick), and all 13
   leaves, the kernels alone, each beside its byte bound, two calls equal to
   the bit;
   timed with CUDA events (median of 30, L2 flushed before each run)
   beside the plain version,
   ``torch.nn.functional.scaled_dot_product_attention`` as a yardstick
   only (its ratio recorded), and the card's bound for the same work (the
   flash rows of the 3xTF32 route at its rate, a third of the TF32 rate,
   with the fp32-FMA bound beside it); for the attention kernels and SDPA
   also the kernels' own device time from ``torch.profiler``
   (``kernel_ms``: the call without its launch gaps);
   the rows' log-sum-exp the forward writes for the backward against
   ``ref.flash_attention_lse_ref`` (abs 1e-4); every decode case also with
   its rows' log-sum-exp asked for (what the sequence-parallel decode
   merges by): the same output, the lse against the plain version's
   (f32 2e-5, bf16 2e-2), -inf exactly where kv_len is 0;
4. forward: full-width smollm-360m in bf16 at B=2, S=512; logits finite,
   one flash launch per layer;
5. decode vs forward: full width over 64 positions, f32 weights
   (rel < 1e-3) and bf16 weights (rel < 5e-2: bf16 keeps 8 bits of
   mantissa and its rounding differs between a 1-token and a 64-token
   matmul, through 32 layers);
6. serve: ``repro_torch.launch.serve`` through the copied WUKONG engine,
   full width, 4 requests x batch 4, prompt 32, gen 32; then the same
   serving on a reduced f32 model on the card and on the CPU must give
   the same greedy tokens;
7. decode step profile: host ms per full-width serving step (batch 4),
   and from a ``torch.profiler`` trace (after a traced warm-up) its device
   ms, kernel launches and top kernels;
8. the same for xlstm-350m (alternating mLSTM / sLSTM blocks): the
   ``mlstm_chunk`` kernels (scores, then state; 3xTF32 tensor-core
   products) against their plain version (atol 5e-5, rtol 5e-4, f32) at
   the full-width shape, at a ragged S with a random initial state (final
   C and n checked too) and at hd 64, timed like the attention kernels
   (``ms``, ``kernel_ms``) beside two bounds: the route's, 3xTF32 at a
   third of the 495 TFLOP/s TF32 rate, and fp32 FMAs at 67; full-width bf16
   forward at B=2, S=512 with one kernel launch per mLSTM layer, and the
   share of a forward spent in the sLSTM time loops; decode against
   forward over 64 positions, f32 rel < 1e-3 and bf16 rel < 0.15 for
   each of three weight seeds (see ``XLSTM_BF16_TOL``); serving
   through the engine at the shape of phase 6; greedy tokens of a reduced
   f32 model equal on the card and the CPU; the decode step profile;
9. train: full-width smollm-360m in bf16 at B=4, S=512, 8 steps on one
   fixed batch (lr 5e-3, no weight decay, warmup 1) as tasks of the copied
   WUKONG engine (``runtime.orchestrator``) with injected failures
   (``TRAIN_FAULTS``: every failure recoverable, some step tasks re-run);
   the loss finite and falling; under the config's ``remat`` two flash
   forward launches (the forward and its recomputation) and one flash
   backward launch per layer and step run; host seconds per step,
   tokens/s and peak device memory;
10. train_reference: a reduced f32 smollm (H=6 K=2, G=3), 3 steps on the
    card and on the CPU from the same weights and batches: loss within
    1e-4 each step, parameters within 2e-3;
11. train_step_profile: one full-width training step's host ms, and from
    a ``torch.profiler`` trace its device ms, busy share, kernel launches,
    top kernels and the shares of the flash forward and backward kernels;
    the peak device memory above the state it starts from of one step and
    of its loss and gradients alone (before AdamW), with and without
    ``remat``;
12. the wide configs (``WIDE_CONFIGS``, ``run_wide``), each at full width
    with its depth cut, weights made on the card from a seed: nemotron-4-340b
    (d_model 18432, 96 heads over 8, hd 192, d_ff 73728, vocab 256000,
    squared ReLU, untied embeddings; 2 layers bf16 = 32.7 GB, 1 in f32),
    llama3-405b (d_model 16384, 128 heads over 8: G = 16, d_ff 53248, vocab
    128256; 2 layers = 21.2 GB, 1 in f32), qwen2-72b (d_model 8192, 64 heads
    over 8, d_ff 29568, vocab 152064, the only attention with q/k/v biases;
    4 layers = 12.0 GB, 1 in f32), chameleon-34b (d_model 8192, 64 over 8,
    d_ff 22016, vocab 65536; 4 layers = 7.7 GB) and mixtral-8x22b (d_model
    6144, 48 heads over 8, 8 experts top 2 of d_ff 16384, window 4096; 2
    layers = 10.8 GB): ``<prefix>_forward`` at B=1, S=512 with one flash
    launch per layer; ``<prefix>_decode_vs_forward`` over 64 positions (rel
    < 5e-2, as smollm's; mixtral-8x22b at its drop-free capacity over the
    positions whose routing agrees, ``MIXTRAL_BF16_FLIP_SHARE`` flipped at
    most), and in f32 at 1 layer (rel < 1e-3: qwen2's bias and llama3's G =
    16 on the 3xTF32 route at the tight limit); ``<prefix>_serve`` through
    the engine, 2 requests x batch 2, prompt 32, gen 16 (``launch.serve``;
    mixtral-8x22b ``launch.serve_lm.run`` with its injected failures); host
    seconds and tokens/s, the weights' GB and the card on every record.
13. apps: the paper's workloads as DAGs of the copied engine (default
    ``EngineConfig``: virtual clock, no simulated compute) through
    ``repro_torch.launch.apps``: first each app at ``tests/test_apps.py``'s
    size on the card and on the CPU, with identical ``charged_ms`` /
    ``kv_stats``; then on the card GEMM n = 10240 in 2048 blocks, TSQR SVD
    of 4194304 x 128 in 32 blocks with U, randomized SVD (rank 5 + 5) of
    n = 50000 in 8 blocks with and without ideal storage, SVC on 8388608
    x 32 in 64 blocks for 4 iterations; each against its float64
    reference on the card within ``launch.apps``'s stated limits, with
    host seconds of a first and a second run, device ms and busy share
    (``torch.profiler``, a third run, which also gives the engine's share
    of host time: the time outside the outermost torch calls),
    ``charged_ms`` and KV bytes; the ideal-storage run writes fewer KV
    bytes and gives the same singular values; the port's kernels launch
    no time (the payloads are cuBLAS / cuSOLVER calls); last the copied
    orchestrator over 20 jobs of its default mix gives identical reports
    on the card and on the CPU.
14. xLSTM training: ``xlstm_train``, full-width xlstm-350m in bf16 at B=2,
    S=512 under ``remat``, its depth cut to ``XLSTM_TRAIN_LAYERS``, 4 steps on one fixed batch as tasks of the
    engine with injected failures (``XLSTM_TRAIN_FAULTS``), the loss finite
    and falling, two ``mlstm_chunk`` forward launches and one backward
    launch per mLSTM layer and step run; ``xlstm_train_reference``, a
    reduced f32 xLSTM (ragged last chunk) 3 steps on the card and on the
    CPU, loss 1e-4 and params 2e-3; ``xlstm_train_step_profile``, at full
    width with the depth cut to one superblock (``XLSTM_PROFILE_LAYERS``),
    a step's host and device time, busy share, launches, top kernels, the
    sLSTM loop's share (its forward calls timed in the step, its backward
    timed on one layer at the same shape) and the peak memory of a step
    and of its loss and gradients, with and without ``remat``.
15. mixtral: mixtral-8x7b at full width (d_model 4096, 32 heads over 8, hd
    128, d_ff 14336, 8 experts top 2, vocab 32000, window 4096, rope theta
    1e6, untied head), its depth cut from 32 layers to 4 in bf16 (12.1 GB
    of weights made on the card from a seed): ``mixtral_forward`` at B=2,
    S=512, one flash launch per layer, with the share of top-2 assignments
    the config's capacity factor 1.25 drops (counted through
    ``layers.moe_route``); ``mixtral_decode_vs_forward`` over 64 positions
    at a drop-free capacity factor (E/k = 4.0: cap = group), bf16 at 4
    layers (see ``MIXTRAL_BF16_FLIP_SHARE``) and f32 at 2 layers (rel <
    1e-3), then f32 with the window cut to 48 over 96 positions, so that
    the decode cache's ring wraps (rel < 1e-3); ``mixtral_serve``,
    ``launch.serve_lm``'s requests through the engine at full width (4
    requests x batch 2, prompt 16, gen 16, the example's injected
    failures), tokens in the vocabulary, at least 4 x 4 x 31 decode
    launches; ``mixtral_serve_reference``, a reduced f32 mixtral with a
    window of 8 (the ring wraps) serving the same greedy tokens on the card
    and the CPU; ``mixtral_decode_step_profile`` at batch 2.
16. jamba: jamba-1.5-large at full width (d_model 8192, d_inner 16384,
    state N 16, conv 4, 64 heads over 8, hd 128, d_ff 24576, vocab 65536,
    untied head), its depth cut from 72 layers to one superblock of 8 (7
    mamba, 1 attention, MoE top 2 on 4) and its experts from 16 to 8 in
    bf16 (51.8 GB of weights) and to 4 in f32 (65.0 GB), weights made on
    the card from a seed on a card that holds nothing else:
    ``jamba_forward`` at B=2, S=512 (two chunks of the mamba scan), one
    flash launch, the dropped share at capacity factor 1.25, and one mamba
    layer's kernel launches and device time at that shape and at one
    decode step (``torch.profiler``); ``jamba_decode_vs_forward`` over 64
    positions at a drop-free capacity factor (E/k), bf16 (see
    ``JAMBA_BF16_TOL``) and f32 (rel < 1e-3); ``jamba_serve``,
    ``launch.serve_lm``'s requests through the engine (4 x batch 2, prompt
    16, gen 16, the example's injected failures); ``jamba_serve_reference``
    and ``jamba_train_reference``, reduced f32 jamba on the card and the
    CPU (greedy tokens equal; 3 train steps, loss 1e-4, params 2e-3);
    ``jamba_decode_step_profile`` at batch 2 beside two memory bounds: the
    weights but the embedding, read once a step (the padded dispatch reads
    every expert), and the same with only the experts the step's tokens
    chose (counted through ``layers.moe_route``).
17. whisper: whisper-large-v3 at full width and full depth (d_model 1280,
    20 heads over 20, hd 64, d_ff 5120 GELU, vocab 51866, 32 encoder and 32
    decoder layers, 1500 frames; 3.29 GB in bf16, 6.57 GB in f32), weights
    made on the card from a seed on a card that holds nothing else, frame
    embeddings drawn from a seed (the config's frontend is a stub):
    ``whisper_forward`` at B=2, S=512, 96 flash launches (the encoder's,
    the decoder's causal self-attention and cross-attention, 32 each), its
    operations and bound, device time, launches and top kernels
    (``torch.profiler``) and peak memory; ``whisper_decode_vs_forward``
    over 64 positions with the cross cache filled by
    ``model.prefill_cross``, bf16 (rel < ``WHISPER_BF16_TOL``) and f32 (rel
    < 1e-3), 64 decode launches a step (self and cross per layer);
    ``whisper_serve``, ``launch.serve_lm``'s requests through the engine (4
    x batch 2, prompt 16, gen 16, the example's injected failures), with
    the encoder prefill's seconds; ``whisper_serve_reference``, reduced f32
    whisper serving the same greedy tokens on the card and the CPU;
    ``whisper_decode_step_profile`` at batch 2 beside its byte bound: every
    decoder weight but cross-attention's wk and wv, the head, and the
    cross caches, read once a step.
18. whisper training: phase 17's model (32 + 32 layers, bf16, full width)
    at B=4 and the decoder's published 448 tokens, on a card that holds
    nothing else: ``whisper_train``, 3 AdamW steps on one fixed
    ``synthetic_batch`` (tokens and frames) as tasks of the engine with no
    injected failure (the engine keeps every step run's 16.45 GB state), the
    loss finite and falling, per step run 192 flash forward launches (the
    encoder's, the decoder's self- and cross-attention, each twice under
    ``remat``) and 96 backward launches, host seconds per step, tokens/s and
    peak memory; ``whisper_train_reference``, reduced f32 whisper 3 steps on
    the card and the CPU (loss 1e-4, params 2e-3); and
    ``whisper_train_step_profile``, as phase 11's, beside the step's bound:
    three forwards' operations (``whisper_forward_flops``) and a fourth for
    the recomputation under ``remat``, and the state read and written once.
19. the dry run (``repro_torch.launch.dryrun``): (a) ``--all
    --both-meshes`` as a process of its own, every one of the 34 (arch x
    shape) cells ``ok``, a line per cell with the argument bytes per device
    on the 1x1, 16x16 and 2x16x16 meshes, the traced peak, whether it fits
    one H100 and its FLOPs, and a line per cell and production mesh with one
    device's sharded trace: its peak, whether it fits, its FLOPs and its
    collectives' bytes and count (``dryrun``); meanwhile (b) every case of phase 3
    through its kernel op on the card and on fake CUDA tensors, the fake
    outputs' shapes, dtypes and strides those of the kernel's and the op's
    FLOP formula the case's bound operations (``dryrun_fake_kernels``), and
    the cells that fit one H100 at their full shape traced on fake CUDA
    tensors: xlstm-350m's decode_32k and long_500k, and smollm-360m's
    train_4k at the least power of two of microbatches whose trace fits;
    then (c) each of them run once on the card (``dryrun_card_cell``): the
    bytes the arguments requested equal to the argument bytes (what the
    allocator holds for them beside), FlopCounterMode's count the trace's
    exactly, the kernel
    launches its kernel calls, and the measured peak within ``PEAK_BAND``
    of the traced one. smollm's cell launches the flash forward and
    backward (``dryrun_launches`` in the kernels line). Last (d), smollm's
    train cell at 32 microbatches stepped as plain tensors and then as
    DTensors placed by the rules on the card's world-of-one NCCL 1x1 mesh
    (``dryrun_sharded_card_cell``): every output equal to the bit, the same
    kernel launches through the sharded entries (``sharded_launches`` in the
    kernels line), no collective.
20. mixtral training: mixtral-8x7b at full width, 1 of its 32 layers
    (1.713 B parameters; a state of 17.13 GB with AdamW's fp32 moments), bf16
    under ``remat``, B=4 S=512, on a card that holds nothing else:
    ``mixtral_train``, the workflow's peak reckoned from the config's shapes
    first (``train_peak_reckoning``), then 3 AdamW steps through the engine
    if the reckoning leaves ``TRAIN_PEAK_MARGIN_GIB`` of the card, else 2, no
    injected failure; the loss finite and falling, 2 flash forward launches
    and 1 backward per step run, the measured peak within 5 % of the
    reckoning, the dropped share of the forward's assignments, and no routing
    that differs between the forward and its recomputation;
    ``mixtral_train_bitwise``, one step run twice on one state: parameters,
    moments and loss equal to the bit and the state left as it was;
    ``mixtral_train_reference``, reduced f32 mixtral 3 steps on the card and
    the CPU (loss 1e-4, params 2e-3); ``mixtral_train_step_profile``, as
    phase 11's, with the expert products' forward and backward taken apart
    (``expert_gemms``) and the step's bound: the operations of the kept
    assignments, attention and the head (``moe_train_flops``; the layers once
    more for ``remat``), and the state read and written once.

Phase 3 also checks the flash backward (bf16 at hd 64/128/192 on
``csrc/flash_attention_bwd_wgmma.cu``, the rest on
``csrc/flash_attention_bwd.cu``), fed the log-sum-exp the forward kernel
wrote, at smollm's shapes (the first case at the train phase's B=4,
S=512), qwen2-72b's width, nemotron's (bf16 at S=2048, f32 at S=512),
mixtral-8x7b's (bf16 at S=8192 with the window of 4096) and whisper's
training shapes (B=4, 20 heads over 20, hd 64): the encoder's non-causal
S=1500 and cross-attention at Sq=448 over Skv=1500 in bf16 and f32,
cross-attention at Sq=37 and the decoder's causal S=448 (G = 1) in bf16,
llama3-405b's width (B=1 S=2048, G = 16, bf16) and phase 20's training
shape (mixtral-8x7b, B=4 S=512, the 4096 window, bf16),
per gradient, twice: elementwise against its fp32 formulas on the same
inputs with D from the same forward output (the kernel's arithmetic),
|err| <= tol·(|ref| + rms(ref)) with tol bf16 1e-2 (about one bf16 ulp) and
f32 1e-4; and against autograd of the plain version, max abs error <=
tol x max(1, max|ref|), tol f32 1e-4 and bf16 3e-2 (the plain version
rounds its bf16 products to bf16); and a second call must give the same
bits. Phase 3 also checks the ``mlstm_chunk`` backward
(``csrc/mlstm_chunk_bwd.cu``, 3xTF32 ``mma.sync``), fed the chunk states and row
normalisers the forward saved (which must leave the forward's output as it
was, to the bit), at xLSTM's training shape with and without an initial
state and final-state gradients, at hd 32 and 64 and a ragged S: per
gradient elementwise |err| <= 1e-4·(|ref| + rms(ref)) against its plain
version ``ref.mlstm_chunk_bwd_ref`` in float64 and in fp32 (the f32 flash
backward's rule), two calls with the same bits; its bound counts 10·hd
FLOPs per causal pair of a chunk (q·kᵀ, g·vᵀ, dS·k, dSᵀ·q, Pᵀ·g), 8·hd² per
position (g·C_jᵀ, v·dC'ᵀ, k·dC', the state gradient) and 2·hd² per (b, h,
chunk) (Σ C_j ⊙ dC') at the route's rate, 3xTF32 (the fp32 FMA bound
beside it), against the inputs (q, k, v, y, dy, the gates, the saved
states and normalisers, the final-state gradients) read and the gradients
written once; no single PyTorch call computes it (``library_ms`` null).
Each mLSTM record carries a SHA-256 digest of the forward's outputs (and
of the states it saves for the backward): equal digests from two trees
mean equal bits. The flash backward's bound counts
10·hd FLOPs per visible (query, key) pair and query
head (the five products q·kᵀ, dO·vᵀ, pᵀ·dO, dsᵀ·q, ds·k) and q, o, dO, dq
over Sq·H and k, v, dk, dv over Skv·K moved once; its library yardstick is
the profiler's device time of the backward of
``scaled_dot_product_attention(..., enable_gqa=True)``.

Kernel launch counts are set to 0 before each forward, decode-vs-forward,
serve and train phase (smollm's, xLSTM's, each wide config's, mixtral's,
jamba's and whisper's, their training too, and each cell phase 19 runs) and
read after it, and before
each full-size app run of phase 13, which must launch none. The line before the last is ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate,
# bf16 tensor-core rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32 products at fp32 accuracy on the tensor cores: three TF32 products
# (495 TFLOP/s dense) for each (csrc/mlstm_chunk.cu)
TF32X3_FLOPS = 495e12 / 3
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The flash backward held elementwise to its fp32 formulas on the same
# inputs (``ref.flash_attention_bwd_fp32_ref``, the kernel's arithmetic):
# |err| <= tol·|ref| + tol·rms(ref) per gradient. bf16: about one bf16 ulp
# (the kernel rounds only its outputs, half an ulp); f32: summation order.
BWD_ELT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the rows' log-sum-exp the forward writes for the backward: fp32
# statistics of values of order log S, summation order
LSE_TOL = 1e-4
# Fault injection of the train phase's 8-step workflow: at seed 6 the step
# tasks 3 and 7 fail at their first attempt and no task of this DAG fails at
# its last (attempt 2), whatever order the executors run in.
TRAIN_FAULTS = {"task_failure_prob": 0.05, "max_retries": 2, "seed": 6}
MLSTM_TOL = {"atol": 5e-5, "rtol": 5e-4}  # tests/test_kernels.py:85-86
# The mLSTM backward held elementwise, |err| <= tol·|ref| + tol·rms(ref) per
# gradient, against its plain version in float64 and in fp32: the f32 flash
# backward's rule. d log f sums terms that cancel; rms(ref) keeps the
# limit from shrinking to an entry that happens to be near 0.
MLSTM_BWD_TOL = 1e-4
# Fault injection of the xlstm_train phase's 4-step workflow: at seed 7 one
# task fails at its first attempt and is retried, and no task of this DAG
# fails at its last attempt. (A step run takes ~10 s, so the seed re-runs
# no step task; the smollm phase's seed does.)
XLSTM_TRAIN_FAULTS = {"task_failure_prob": 0.05, "max_retries": 2, "seed": 7}
XLSTM_TRAIN_B, XLSTM_TRAIN_S, XLSTM_TRAIN_STEPS = 2, 512, 4
# xlstm_train's depth: 8 of 24 layers (4 superblocks). A full-depth step run
# takes ~10 s, nearly all the sLSTM time loop, and 4 steps with a retry
# took 52 s of the script (H100, 700 W); PERF.md keeps the full-depth reading.
XLSTM_TRAIN_LAYERS = 8
# The xLSTM step profile cuts the depth to one superblock (an mLSTM and an
# sLSTM block, full width): a full-depth step launches ~300k kernels, whose
# trace takes minutes to read back. Full-depth host time is xlstm_train's.
XLSTM_PROFILE_LAYERS = 2
# xlstm-350m decode against forward in bf16. Both paths compute the same
# function and each rounds to bf16 in its own way; this model amplifies
# such roundings far more than smollm, and so does the JAX reference: at
# full depth its bf16 decode-vs-forward error exceeds smollm's limit of
# 5e-2 too (tests/test_torch_bf16.py). 0.15 is about twice the largest
# reading, on the card or of the JAX reference, that PERF.md records. A
# wrong state update or position gives errors of order 1 and fails the f32
# check at 1e-3.
XLSTM_BF16_TOL = 0.15
# mixtral-8x7b decode against forward in bf16. Its top-2 routing is a step
# function of the router logits: where the 2nd and 3rd experts' logits
# nearly tie, the two paths' roundings can pick different experts for a
# token (a flip), whose logits then differ by 0.1-0.3. The two paths round
# attention's probabilities in different places: the forward rounds them to
# bf16 before p.v (the wgmma kernel's bf16 P; on the CPU, sdpa's rounding),
# decode keeps them in fp32 (the decode kernel, as the reference's Pallas
# decode kernel). The JAX package does the same on its kernel path
# (use_pallas: Pallas flash keeps fp32 probabilities, decode runs sdpa's
# bf16) and then flips 0.8-1.5 % of (token, layer) routings on the CPU; on
# its plain path both run sdpa and flip none. The port flips 1.2-1.8 % on the
# CPU, none with its decode rounded as sdpa (tests/test_torch_bf16.py), and
# 2.5 % on an H100 (700 W) at full width and 4 layers (PERF.md). So the
# positions whose routing agrees in every layer are held to smollm's 5e-2,
# and the share of routings that flip to about twice the largest reading. A
# wrong router, dispatch or cache position flips most routings, and fails
# the f32 check at 1e-3.
MIXTRAL_BF16_FLIP_SHARE = 0.05
# jamba-1.5-large decode against forward in bf16, held as mixtral's: the
# positions whose routing agrees in every layer, and the share of routings
# that flip. The JAX package's plain path, which flips no mixtral routing,
# flips jamba's at the card's depth (one superblock of 8 layers with N = 16
# and 8 experts, d_model 256, on the CPU): over five seeds up to 2.3 % of
# (token, layer) routings, and its agreeing positions differ by up to 0.089
# (tests/test_torch_bf16.py). So jamba's limits are about twice those
# largest readings. A wrong scan, conv state or cache position gives errors
# of order 1 and fails the f32 check at 1e-3.
JAMBA_BF16_TOL = 0.18
JAMBA_BF16_FLIP_SHARE = 0.05
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
REPS = 30


# the script's start; each record carries the seconds since, so that a run
# shows where its time goes
T_START = time.perf_counter()


# Every case of phase 3, as (kernel op, its shapes, the operations its bound
# counts); phase 19 runs each again through the op on the card and under
# FakeTensorMode, and holds the op's FLOP formula to those operations.
KERNEL_CASES: list[tuple[str, dict, float]] = []


def emit(rec: dict) -> None:
    print(json.dumps({**rec, "elapsed_s": time.perf_counter() - T_START}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of ``fn`` in ms over ``REPS`` runs, each after an
    L2 flush (a 512 MiB write), between CUDA events."""

    def __init__(self, device):
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            self.flush.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def kernels_ms(self, fn, reps: int = 10) -> float | None:
        """Mean device time per call of the kernels ``fn`` launches
        (``torch.profiler``), each call after an L2 flush whose own kernel
        is left out: the call's time without its launch gaps. None when the
        trace holds no kernel of ``fn`` (not measured)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in kernel_rows(prof)
                    if "fill" not in e.key.lower())
        return total / 1e3 / reps if total > 0 else None

    def kernels_by_name(self, fn, reps: int = 10) -> dict:
        """Mean device ms per call of each kernel ``fn`` launches, by name."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in kernel_rows(prof):
            if e.self_device_time_total > 0:
                name = re.search(r"(\w+_kernel)\b", e.key)
                key = name.group(1) if name else e.key[:60]
                out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / reps
        return out


def bound(nbytes: float, flops: float, dtype, rate: float | None = None) -> tuple[float, str]:
    """The least time for ``nbytes`` and ``flops`` at the memory rate and at
    ``rate`` (default: the peak of ``dtype``), and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (rate or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref, dtype) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    return err


def rms_limit(err, ref, rms_tol) -> dict:
    """Holds ``err`` to ``rms_tol`` times the reference's rms as well: over
    many keys the outputs are small (rms ~0.04 at 1500 keys), and ``TOL``
    alone would pass a kernel that got a few percent of p·v wrong. Returns
    the fields to record; none when ``rms_tol`` is None."""
    if rms_tol is None:
        return {}
    rms = ref.float().square().mean().sqrt().item()
    assert err <= rms_tol * rms, (err, rms_tol, rms)
    return {"rms_ref": rms, "err_over_rms": err / rms, "rms_tol": rms_tol}


def check_decode(ops, ref, timer, dev, dtype, B, S, lens, H=15, K=5, hd=64, seed=0,
                 rms_tol=None):
    from repro_torch.kernels import decode_attention as decode_kernel

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, kc, vc, kv_len)
    want = ref.decode_attention_ref(q, kc, vc, kv_len)
    err = max_err(out, want, dtype)
    by_rms = rms_limit(err, want, rms_tol)
    lse_err = check_decode_lse(ops, ref, q, kc, vc, kv_len, out, dtype)
    # yardstick: SDPA over the cache with a length mask, kv heads repeated
    qs = q[:, :, None, :]
    ks, vs = (c.transpose(1, 2).repeat_interleave(H // K, dim=1) for c in (kc, vc))
    mask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    n_valid = sum(min(n, S) for n in lens)
    elt = q.element_size()
    nbytes = (2 * n_valid * K * hd + 2 * B * H * hd) * elt + 4 * B
    t_bound, by = bound(nbytes, 4.0 * n_valid * H * hd, dtype)
    KERNEL_CASES.append(("decode_attention", dict(dtype=dtype, B=B, S=S, lens=list(lens), H=H,
                                                  K=K, hd=hd), 4.0 * n_valid * H * hd))
    mine = lambda: ops.decode_attention(q, kc, vc, kv_len)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)  # noqa: E731
    return with_ratio({
        "shape": f"B={B} S={S} H={H} K={K} hd={hd} kv_len={_lens(lens)}",
        "dtype": DT_NAME[dtype], "n_split": decode_kernel.split_plan(B, K, S)[0],
        "max_abs_err": err, "tol": TOL[dtype], **by_rms, "lse_max_abs_err": lse_err,
        "ms": timer(mine), "kernel_ms": timer.kernels_ms(mine),
        "plain_ms": timer(lambda: ref.decode_attention_ref(q, kc, vc, kv_len)),
        "library_ms": timer(lib), "library_kernel_ms": timer.kernels_ms(lib),
        "bound_ms": t_bound, "bound_by": by,
    })


def check_decode_lse(ops, ref, q, kc, vc, kv_len, out, dtype) -> float:
    """The decode kernel asked for each row's log-sum-exp (what the
    sequence-parallel decode merges by): the same output as without it, and
    the lse within TOL of the plain version's, -inf exactly where kv_len <= 0.
    Returns the lse's largest error."""
    out2, lse = ops.decode_attention(q, kc, vc, kv_len, with_lse=True)
    assert torch.equal(out2, out)
    _, want = ref.decode_attention_ref(q, kc, vc, kv_len, with_lse=True)
    empty = (kv_len <= 0)[:, None].expand_as(lse)
    assert torch.equal(torch.isneginf(lse), empty) and torch.equal(torch.isneginf(want), empty)
    if bool(empty.all()):
        return 0.0
    torch.testing.assert_close(lse[~empty], want[~empty], atol=TOL[dtype], rtol=TOL[dtype])
    return (lse[~empty] - want[~empty]).abs().max().item()


def check_flash(ops, ref, timer, dev, dtype, B, S, causal, window, H=15, K=5, hd=64, seed=1,
                Skv=None, rms_tol=None):
    """Flash forward at q (B,S,H,hd) against k/v (B,Skv,K,hd), Skv = S
    unless given (cross-attention: no mask); ``rms_tol`` as ``rms_limit``."""
    from repro_torch.kernels import flash_attention as flash_kernel

    Skv = S if Skv is None else Skv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, Skv, K, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = max_err(out, want, dtype)
    by_rms = rms_limit(err, want, rms_tol)
    del want
    # the same kernel asked for the rows' log-sum-exp: the same output, and lse
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    assert torch.equal(flash_kernel.launch(q, k, v, causal=causal, window=window, lse=lse), out)
    lse_err = (lse - ref.flash_attention_lse_ref(q, k, causal=causal, window=window)).abs().max()
    assert lse_err.item() <= LSE_TOL, lse_err.item()
    mask = attention_mask(S, causal, window, dev, Skv)
    n_pairs = int(mask.sum().item())
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(H // K, dim=1) for t in (k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)  # noqa: E731
    else:
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)  # noqa: E731
    nbytes = 2 * B * (S * H + Skv * K) * hd * q.element_size()   # q, o; k, v
    flops = 4.0 * B * H * hd * n_pairs
    route = flash_kernel.route(dtype, hd)
    bounds = route_bounds(nbytes, flops, dtype, route)
    KERNEL_CASES.append(("flash_attention_fwd", dict(dtype=dtype, B=B, S=S, Skv=Skv, causal=causal,
                                                     window=window, H=H, K=K, hd=hd), flops))
    mine = lambda: ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
    lengths = f"S={S}" if Skv == S else f"Sq={S} Skv={Skv}"
    return with_ratio({
        "shape": f"B={B} {lengths} H={H} K={K} hd={hd} causal={causal} window={window}",
        "dtype": DT_NAME[dtype],
        "kernel": route,
        "kv_split": (flash_kernel.split_plan(B, S, Skv, H, hd, causal or window is not None)[0]
                     if route == "3xtf32" else 1),
        "max_abs_err": err, "tol": TOL[dtype], **by_rms, "lse_max_abs_err": lse_err.item(),
        "lse_tol": LSE_TOL,
        "ms": timer(mine), "kernel_ms": timer.kernels_ms(mine),
        "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                          window=window)),
        "library_ms": timer(lib), "library_kernel_ms": timer.kernels_ms(lib), **bounds,
    })


def route_bounds(nbytes: float, flops: float, dtype, route: str) -> dict:
    """The bound of an attention case at its route's rate: bf16 ``wgmma`` at
    the bf16 peak; ``3xtf32`` (f32 at every hd, bf16 at hd 16/32) at three
    TF32 products a product, with the fp32-FMA bound (the route before it)
    beside it, as ``check_mlstm`` records."""
    if route == "wgmma":
        t_bound, by = bound(nbytes, flops, dtype)
        return {"bound_ms": t_bound, "bound_by": by}
    t_bound, by = bound(nbytes, flops, dtype, TF32X3_FLOPS)
    t_fma, fma_by = bound(nbytes, flops, torch.float32)
    return {"bound_ms": t_bound, "bound_by": by, "bound_fp32_fma_ms": t_fma,
            "bound_fp32_fma_by": fma_by}


def check_flash_bwd(ops, ref, timer, dev, dtype, B, S, causal, window, H=15, K=5, hd=64,
                    seed=3, Skv=None):
    """Flash backward at q (B,S,H,hd) against k/v (B,Skv,K,hd), Skv = S
    unless given (cross-attention: no mask)."""
    from repro_torch.kernels import flash_attention as flash_kernel

    Skv = S if Skv is None else Skv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, Skv, K, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    # the forward kernel's output and the rows' log-sum-exp it writes for the backward
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    out = flash_kernel.launch(q, k, v, causal=causal, window=window, lse=lse)
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, causal=causal, window=window)
    again = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True)), "not repeatable"
    del again
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    exact = ref.flash_attention_bwd_fp32_ref(q, k, v, out, dout, causal=causal, window=window)
    err, err_plain, worst = {}, {}, {}
    for name, a, b, e in zip(("dq", "dk", "dv"), got, want, exact, strict=True):
        err_plain[name] = (a.float() - b.float()).abs().max().item()
        limit = BWD_TOL[dtype] * max(1.0, b.float().abs().max().item())
        assert err_plain[name] <= limit, (name, err_plain[name], limit)
        diff = (a.float() - e).abs()
        err[name] = diff.max().item()
        tol = BWD_ELT_TOL[dtype]
        worst[name] = (diff / (tol * e.abs() + tol * e.square().mean().sqrt())).max().item()
        assert worst[name] <= 1.0, (name, err[name], worst[name])
    del exact
    mask = attention_mask(S, causal, window, dev, Skv)
    n_pairs = int(mask.sum().item())
    elt = q.element_size()
    nbytes = 4 * B * (S * H + Skv * K) * hd * elt   # q, o, dO, dq; k, v, dk, dv
    flops = 10.0 * B * H * hd * n_pairs
    route = flash_kernel.route(dtype, hd)
    bounds = route_bounds(nbytes, flops, dtype, route)
    KERNEL_CASES.append(("flash_attention_bwd", dict(dtype=dtype, B=B, S=S, Skv=Skv, causal=causal,
                                                     window=window, H=H, K=K, hd=hd), flops))
    # yardstick: the backward of SDPA over the same function (kv heads grouped)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    if window is None:
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
    else:
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    douts = dout.transpose(1, 2)
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), douts, retain_graph=True)  # noqa: E731
    mine = lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse=lse,  # noqa: E731
                                           causal=causal, window=window)
    kernel = ("delta + dq + dkdv, bf16 wgmma" if route == "wgmma"
              else "delta + (dq | dkdv), 3xTF32 mma.sync")
    lengths = f"S={S}" if Skv == S else f"Sq={S} Skv={Skv}"
    return {
        "shape": f"B={B} {lengths} H={H} K={K} hd={hd} causal={causal} window={window}",
        "dtype": DT_NAME[dtype], "route": route, "kernel": kernel, "bitwise_repeatable": True,
        "max_abs_err": max(err.values()), "max_abs_err_by_grad": err,
        "tol": f"{BWD_ELT_TOL[dtype]} x (|ref| + rms(ref)), fp32 formulas",
        "err_over_tol_by_grad": worst,
        "max_abs_err_plain_by_grad": err_plain,
        "tol_plain": f"{BWD_TOL[dtype]} x max(1, max|plain|)",
        "ms": timer(mine), "kernel_ms": timer.kernels_ms(mine),
        "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                                              window=window)),
        "library_ms": timer.kernels_ms(lib), "library_event_ms": timer(lib), **bounds,
    }


def attention_mask(S, causal, window, dev, Skv=None):
    """The (S, Skv) boolean mask of visible (row, col) pairs, Skv = S
    unless given."""
    Skv = S if Skv is None else Skv
    rows = torch.arange(S, device=dev)[:, None]
    cols = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def with_ratio(case: dict) -> dict:
    """``case`` with its time over the library call's (below 1: faster)."""
    return {**case, "ms_over_library": case["ms"] / case["library_ms"]}


def _lens(lens: list) -> str:
    """kv_len for a shape string: a run of one value as value x count."""
    return f"{lens[0]}x{len(lens)}" if len(set(lens)) == 1 else str(lens)


def check_mlstm(ops, ref, timer, dev, B, S, H, hd, with_state, seed=2, chunk=64):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # the model's scales: q carries hd^-0.5, forget gates near sigmoid(2)
    q, k, v = randn(B, S, H, hd) * hd ** -0.5, randn(B, S, H, hd), randn(B, S, H, hd)
    log_f = F.logsigmoid(randn(B, S, H) + 2.0)
    i_gate = torch.sigmoid(randn(B, S, H))
    state = (randn(B, H, hd, hd) * 0.1, randn(B, H, hd)) if with_state else None
    c = min(chunk, S)
    got = ops.mlstm_chunk(q, k, v, log_f, i_gate, chunk=chunk, state=state)
    want = ref.mlstm_chunk_ref(q, k, v, log_f, i_gate, chunk=c, state=state)
    err = 0.0
    for a, b in ((got[0], want[0]), *zip(got[1], want[1])):
        torch.testing.assert_close(a, b, **MLSTM_TOL)
        err = max(err, (a - b).abs().max().item())
    state_elems = B * H * (hd * hd + hd)
    nbytes = 4 * (4 * B * S * H * hd + 2 * B * S * H + (2 if with_state else 1) * state_elems)
    # q·k and p·v over the causal pairs (t <= s) of each chunk, the last one
    # ragged, then q·C and the state update at each position
    n_pairs = sum(n * (n + 1) // 2 for n in (min(c, S - s0) for s0 in range(0, S, c)))
    flops = B * H * (4.0 * hd * n_pairs + 4.0 * hd * hd * S)
    # the products are 3xTF32 on the tensor cores: held to that route's bound;
    # the fp32-FMA bound (PR 12's route) is kept beside it
    t_bound, by = bound(nbytes, flops, torch.float32, TF32X3_FLOPS)
    t_fma, fma_by = bound(nbytes, flops, torch.float32)
    KERNEL_CASES.append(("mlstm_chunk_fwd", dict(B=B, S=S, H=H, hd=hd, chunk=c,
                                                 with_state=with_state), flops))
    mine = lambda: ops.mlstm_chunk(q, k, v, log_f, i_gate, chunk=chunk, state=state)  # noqa: E731
    return {
        "shape": f"B={B} S={S} H={H} hd={hd} chunk={c} state={with_state}", "dtype": "f32",
        "kernel": "scores + state, 3xTF32 mma.sync", "max_abs_err": err, "tol": MLSTM_TOL,
        "output_sha256": digest(got[0], *got[1]),
        "ms": timer(mine), "kernel_ms": timer.kernels_ms(mine),
        "plain_ms": timer(lambda: ref.mlstm_chunk_ref(q, k, v, log_f, i_gate, chunk=c,
                                                      state=state)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by,
        "bound_fp32_fma_ms": t_fma, "bound_fp32_fma_by": fma_by,
    }


def check_mlstm_bwd(ops, ref, timer, dev, B, S, H, hd, with_state, final_grads, seed=4,
                    chunk=64):
    from repro_torch.kernels import mlstm_chunk as mlstm_kernel

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # the forward's scales (check_mlstm)
    q, k, v = randn(B, S, H, hd) * hd ** -0.5, randn(B, S, H, hd), randn(B, S, H, hd)
    log_f = F.logsigmoid(randn(B, S, H) + 2.0)
    i_gate = torch.sigmoid(randn(B, S, H))
    state = (randn(B, H, hd, hd) * 0.1, randn(B, H, hd)) if with_state else None
    c = min(chunk, S)
    y, _, saved = mlstm_kernel.launch(q, k, v, log_f, i_gate, chunk=c, state=state, save=True)
    assert torch.equal(y, mlstm_kernel.launch(q, k, v, log_f, i_gate, chunk=c, state=state)[0])
    forward_digest = digest(y, *saved)
    dy = randn(B, S, H, hd)
    dC, dn = (randn(B, H, hd, hd), randn(B, H, hd)) if final_grads else (None, None)
    args = (q, k, v, log_f, i_gate, y, dy)
    kw = dict(chunk=c, state=state, dC=dC, dn=dn)
    got = ops.mlstm_chunk_bwd(*args, saved=saved, **kw)
    again = ops.mlstm_chunk_bwd(*args, saved=saved, **kw)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again, strict=True))
    del again
    as64 = lambda t: None if t is None else t.double()  # noqa: E731
    exact = ref.mlstm_chunk_bwd_ref(*(t.double() for t in args), chunk=c,
                                    state=None if state is None else tuple(map(as64, state)),
                                    dC=as64(dC), dn=as64(dn))
    plain = ref.mlstm_chunk_bwd_ref(*args, **kw)
    names = ("dq", "dk", "dv", "dlog_f", "di", "dC0", "dn0")
    err, worst, worst_plain = {}, {}, {}

    def over_tol(a, want):
        want = want.double()
        limit = MLSTM_BWD_TOL * (want.abs() + want.square().mean().sqrt())
        return ((a.double() - want).abs() / limit).max().item()

    for name, a, e, p in zip(names, got, exact, plain, strict=True):
        if a is None:
            continue
        err[name] = (a.double() - e).abs().max().item()
        worst[name], worst_plain[name] = over_tol(a, e), over_tol(a, p)
        assert worst[name] <= 1.0 and worst_plain[name] <= 1.0, (name, worst, worst_plain)
    del exact, plain
    n_chunks = -(-S // c)
    n_pairs = sum(n * (n + 1) // 2 for n in (min(c, S - s0) for s0 in range(0, S, c)))
    flops = B * H * (10.0 * hd * n_pairs + 8.0 * hd * hd * S + 2.0 * hd * hd * n_chunks)
    elems = (5 * B * S * H * hd + 3 * B * S * H          # q, k, v, y, dy; gates and nrm
             + B * H * n_chunks * (hd * hd + hd)          # the saved states
             + (B * H * (hd * hd + hd) if final_grads else 0)
             + 3 * B * S * H * hd + 2 * B * S * H         # dq, dk, dv; d log f, d i
             + (B * H * (hd * hd + hd) if with_state else 0))
    # the products are 3xTF32 on the tensor cores: held to that route's bound;
    # the fp32-FMA bound (the first backward's route) is kept beside it
    t_bound, by = bound(4.0 * elems, flops, torch.float32, TF32X3_FLOPS)
    t_fma, fma_by = bound(4.0 * elems, flops, torch.float32)
    KERNEL_CASES.append(("mlstm_chunk_bwd", dict(B=B, S=S, H=H, hd=hd, chunk=c,
                                                 with_state=with_state, final_grads=final_grads),
                         flops))
    mine = lambda: ops.mlstm_chunk_bwd(*args, saved=saved, **kw)  # noqa: E731
    return {
        "shape": f"B={B} S={S} H={H} hd={hd} chunk={c} state={with_state} "
                 f"final_grads={final_grads}", "dtype": "f32",
        "kernel": "rows + scores + sweep + tiles + gates; scores, sweep and tiles on 3xTF32 "
                  "mma.sync", "bitwise_repeatable": True,
        "forward_output_unchanged_by_saving": True, "forward_sha256": forward_digest,
        "max_abs_err": max(err.values()), "max_abs_err_by_grad": err,
        "tol": f"{MLSTM_BWD_TOL} x (|ref| + rms(ref)), plain version in float64 and in fp32",
        "err_over_tol_by_grad": worst, "err_over_tol_fp32_plain_by_grad": worst_plain,
        "ms": timer(mine), "kernel_ms": timer.kernels_ms(mine),
        "kernel_ms_by_kernel": timer.kernels_by_name(mine),
        "plain_ms": timer(lambda: ref.mlstm_chunk_bwd_ref(*args, **kw)),
        "library_ms": None, "bound_ms": t_bound, "bound_by": by,
        "bound_fp32_fma_ms": t_fma, "bound_fp32_fma_by": fma_by,
    }


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def ptxas_by_kernel(log: str) -> dict:
    """Registers, shared memory and spills of each kernel in an
    ``-Xptxas=-v`` log, by the kernel's name with its template arguments
    (``decode_split_kernel<bf16,192,16>``)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            short = re.search(r"([a-z_]+_kernel)I((?:f|13__nv_bfloat16|Li\d+E)+)E", mangled)
            if short:
                args = [{"f": "f32", "13__nv_bfloat16": "bf16"}.get(t, t[2:-1])
                        for t in re.findall(r"f|13__nv_bfloat16|Li\d+E", short.group(2))]
                name = f"{short.group(1)}<{','.join(args)}>"
            else:
                name = mangled
            out[name] = {}
        elif name and "spill" in line:
            out[name]["spill"] = line.split(":", 1)[-1].strip() if ":" in line else line.strip()
        elif name and "Used" in line and "registers" in line:
            out[name]["usage"] = line.split("Used", 1)[1].strip()
    return out


def attention_build(_build, libs) -> dict:
    """For the flash kernels of the 3xTF32 route (forward and backward, every
    instantiation), the wgmma backward's and every hd-192 instantiation of
    the wgmma forward and decode: ptxas's registers and spills, and the
    dynamic shared memory a block takes (read from the libraries)."""
    fwd, wg = _build.library("flash_attention"), _build.library("flash_attention_wgmma")
    bwd, bwg = _build.library("flash_attention_bwd"), _build.library("flash_attention_bwd_wgmma")
    dec = _build.library("decode_attention")
    smem = {"flash_wgmma_kernel<192>": wg.flash_attention_wgmma_smem_bytes(192)}
    for hd in (16, 32, 64, 128, 192):
        for dt, code in (("f32", 0), ("bf16", 1)):
            smem[f"flash_fwd_kernel<{dt},{hd}>"] = fwd.flash_attention_fwd_smem_bytes(code, hd)
            smem[f"flash_bwd_kernel<{dt},{hd}>"] = bwd.flash_attention_bwd_smem_bytes(code, hd)
        for i, kind in enumerate(("dq", "dkdv")):
            smem[f"flash_bwd_wgmma_{kind}_kernel<{hd}>"] = bwg.flash_attention_bwd_wgmma_smem_bytes(hd, i)
    for dt, code in (("f32", 0), ("bf16", 1)):
        for gmax in (4, 8, 12, 16):
            smem[f"decode_split_kernel<{dt},192,{gmax}>"] = dec.decode_attention_smem_bytes(code, 192, gmax)
    ptxas = {}
    for lib in ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
                "flash_attention_bwd_wgmma", "decode_attention"):
        ptxas.update(ptxas_by_kernel(libs[lib].with_suffix(".log").read_text()))
    keep = {n: r for n, r in ptxas.items()
            if "flash_bwd" in n or "flash_fwd" in n or ",192" in n or "<192" in n}
    return {n: {**r, "smem_bytes": smem.get(n)} for n, r in keep.items()}


def mlstm_build(_build, libs) -> dict:
    """ptxas's registers and spills of the mlstm kernels and of its
    backward's, the dynamic shared memory each block takes at each head dim
    (of the backward: its tiles kernel), and how many clusters of the state
    kernel the card holds at once."""
    lib = _build.library("mlstm_chunk")
    bwd = _build.library("mlstm_chunk_bwd")
    return {"ptxas": {**ptxas_by_kernel(libs["mlstm_chunk"].with_suffix(".log").read_text()),
                      **ptxas_by_kernel(libs["mlstm_chunk_bwd"].with_suffix(".log").read_text())},
            "smem_bytes": {**{f"{kind}<{hd}>": lib.mlstm_chunk_smem_bytes(hd, i)
                              for hd in (32, 64, 512)
                              for i, kind in enumerate(("scores", "state"))},
                           **{f"bwd_tiles<{hd}>": bwd.mlstm_chunk_bwd_smem_bytes(hd)
                              for hd in (32, 64, 512)}},
            "state_max_active_clusters": {hd: lib.mlstm_chunk_max_clusters(hd)
                                          for hd in (32, 64, 512)}}


def rel_err(a, b) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


KERNELS = ("flash_attention", "decode_attention", "mlstm_chunk")
MOE_OPS = ("moe_dispatch", "moe_combine")


def reset(ops) -> None:
    for name in KERNELS:
        getattr(ops, name).launches = 0
    ops.flash_attention.bwd_launches = 0
    ops.mlstm_chunk.bwd_launches = 0
    ops.adamw_update.launches = 0
    for name in MOE_OPS:
        getattr(ops, name).launches = getattr(ops, name).bwd_launches = 0


def moe_counts(ops) -> dict:
    """The MoE kernels' launches, each op's forward and backward."""
    return {f"{name}{suffix}": getattr(getattr(ops, name), attr) for name in MOE_OPS
            for suffix, attr in (("", "launches"), ("_bwd", "bwd_launches"))}


def moe_train_launches(cfg, runs: int) -> dict:
    """The MoE kernels' launches of ``runs`` train-step runs of ``cfg``: per MoE
    layer one dispatch and one combine (two of each under ``remat``: the
    recomputation runs the combine too, for the tensors it saves) and one
    backward of each."""
    n_moe = sum(cfg.mlp_of(e) == "moe" for e in cfg.block_pattern) * cfg.n_repeats
    fwd, bwd = (2 if cfg.remat else 1) * n_moe * runs, n_moe * runs
    return {"moe_dispatch": fwd, "moe_dispatch_bwd": bwd, "moe_combine": fwd,
            "moe_combine_bwd": bwd}


def counts(ops) -> dict:
    return {**{name: getattr(ops, name).launches for name in KERNELS},
            "flash_attention_bwd": ops.flash_attention.bwd_launches,
            "mlstm_chunk_bwd": ops.mlstm_chunk.bwd_launches}


def train_launches(cfg, runs: int) -> dict:
    """The kernel launches of ``runs`` train-step runs of ``cfg``: per layer
    one forward (two under ``remat``: the forward and its recomputation in
    the backward) and one backward; the encoder-decoder's attention layers
    are the encoder's, and the decoder's self- and cross-attention."""
    n_attn = sum(cfg.mixer_of(e) == "attn" for e in cfg.block_pattern) * cfg.n_repeats
    if cfg.enc_dec:
        n_attn = cfg.n_enc_layers + 2 * n_attn
    n_mlstm = sum(cfg.mixer_of(e) == "mlstm" for e in cfg.block_pattern) * cfg.n_repeats
    fwd = 2 if cfg.remat else 1
    return {"flash_attention": fwd * n_attn * runs, "decode_attention": 0,
            "mlstm_chunk": fwd * n_mlstm * runs, "flash_attention_bwd": n_attn * runs,
            "mlstm_chunk_bwd": n_mlstm * runs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for p in libs.values()
             for line in p.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line] if libs else []
    emit({"phase": "build", "seconds": build_s,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": ptxas,
          "mlstm_kernels": mlstm_build(_build, libs),
          "attention_kernels": attention_build(_build, libs)})

    # 3. kernel checks at smollm-360m's shapes (H=15, K=5, hd=64)
    timer = Timer(dev)
    decode_cases, flash_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        decode_cases.append(check_decode(ops, ref, timer, dev, dtype, 4, 64, [63] * 4))
        decode_cases.append(check_decode(ops, ref, timer, dev, dtype, 8, 2048,
                                         [2048, 2048, 1, 1000, 1517, 333, 64, 2047]))
        flash_cases.append(check_flash(ops, ref, timer, dev, dtype, 2, 512, True, None))
        flash_cases.append(check_flash(ops, ref, timer, dev, dtype, 2, 1024, True, None))
        flash_cases.append(check_flash(ops, ref, timer, dev, dtype, 2, 1000, True, None))
        flash_cases.append(check_flash(ops, ref, timer, dev, dtype, 2, 1024, True, 256))
    # one long request; qwen2-72b's attention per layer (64 heads over 8, hd 128)
    decode_cases.append(check_decode(ops, ref, timer, dev, torch.bfloat16, 1, 8192, [8191]))
    flash_cases.append(check_flash(ops, ref, timer, dev, torch.bfloat16, 1, 2048, True, None,
                                   H=64, K=8, hd=128))
    # nemotron-4-340b's attention per layer: 96 heads over 8, hd 192
    for dtype in (torch.bfloat16, torch.float32):
        flash_cases.append(check_flash(ops, ref, timer, dev, dtype, 1, 2048, True, None,
                                       H=NEMOTRON_H, K=NEMOTRON_K, hd=192))
        decode_cases.append(check_decode(ops, ref, timer, dev, dtype, 4, 2048,
                                         [2048, 1, 1517, 700], H=NEMOTRON_H, K=NEMOTRON_K,
                                         hd=192))
    # mixtral's attention per layer: 32 (8x22b: 48) heads over 8, hd 128, the window of 4096
    for H in (MIXTRAL_H, MIXTRAL_22B_H):
        flash_cases.append(check_flash(ops, ref, timer, dev, torch.bfloat16, 1, 2 * MIXTRAL_WINDOW,
                                       True, MIXTRAL_WINDOW, H=H, K=MIXTRAL_K, hd=128))
        decode_cases.append(check_decode(ops, ref, timer, dev, torch.bfloat16, 4, MIXTRAL_WINDOW,
                                         [4096, 1, 2000, 4096], H=H, K=MIXTRAL_K, hd=128))
    # ... and at the shapes phase 15 gives them: its forward (bf16, B=2 S=512, the window
    # longer than S), its ring check (f32, window 48 over 96 positions: flash on
    # csrc/flash_attention.cu, decode over the wrapped ring of 48), serving's last step
    mixtral = {"H": MIXTRAL_H, "K": MIXTRAL_K, "hd": 128}
    flash_cases.append(check_flash(ops, ref, timer, dev, torch.bfloat16, 2, 512, True,
                                   MIXTRAL_WINDOW, **mixtral))
    flash_cases.append(check_flash(ops, ref, timer, dev, torch.float32, 2, MIXTRAL_RING_POSITIONS,
                                   True, MIXTRAL_RING_WINDOW, **mixtral))
    decode_cases.append(check_decode(ops, ref, timer, dev, torch.bfloat16, 2, 32, [31, 31],
                                     **mixtral))
    decode_cases.append(check_decode(ops, ref, timer, dev, torch.float32, 2, MIXTRAL_RING_WINDOW,
                                     [MIXTRAL_RING_WINDOW] * 2, **mixtral))
    # jamba's attention layer at the shapes phase 16 gives it: its forward (bf16, B=2 S=512,
    # causal, no window), serving's last step (B=2 over a cache of 32, kv_len 31), and the
    # f32 decode-vs-forward check (flash on csrc/flash_attention.cu over 64 positions, decode
    # at G = 8 over a cache of 64)
    jamba = {"H": JAMBA_H, "K": JAMBA_K, "hd": 128}
    flash_cases.append(check_flash(ops, ref, timer, dev, torch.bfloat16, 2, 512, True, None,
                                   **jamba))
    flash_cases.append(check_flash(ops, ref, timer, dev, torch.float32, 2, 64, True, None,
                                   **jamba))
    decode_cases.append(check_decode(ops, ref, timer, dev, torch.bfloat16, 2, 32, [31, 31],
                                     **jamba))
    decode_cases.append(check_decode(ops, ref, timer, dev, torch.float32, 2, 64, [64, 64],
                                     **jamba))
    whisper_flash, whisper_decode = whisper_checks(ops, ref, timer, dev)
    flash_cases += whisper_flash
    decode_cases += whisper_decode
    mlstm_cases, mlstm_bwd_cases = mlstm_checks(ops, ref, timer, dev)
    adamw_cases = adamw_checks(ops, ref, timer, dev, get_config)
    moe_cases = moe_checks(ops, ref, timer, dev)
    # the flash backward at smollm's training shapes and qwen2-72b's width
    bwd_cases = [check_flash_bwd(ops, ref, timer, dev, dtype, B, S, True, window)
                 for dtype in (torch.bfloat16, torch.float32)
                 for B, S, window in ((TRAIN_B, TRAIN_S, None), (2, 1000, None),
                                      (2, 1024, 256))]
    bwd_cases.append(check_flash_bwd(ops, ref, timer, dev, torch.bfloat16, 1, 2048, True, None,
                                     H=64, K=8, hd=128))
    for dtype, S in ((torch.bfloat16, 2048), (torch.float32, 512)):  # nemotron's width
        bwd_cases.append(check_flash_bwd(ops, ref, timer, dev, dtype, 1, S, True, None,
                                         H=NEMOTRON_H, K=NEMOTRON_K, hd=192))
    bwd_cases.append(check_flash_bwd(ops, ref, timer, dev, torch.bfloat16, 1, 2 * MIXTRAL_WINDOW,
                                     True, MIXTRAL_WINDOW, H=MIXTRAL_H, K=MIXTRAL_K, hd=128))
    bwd_cases += whisper_bwd_checks(ops, ref, timer, dev)
    # llama3-405b's attention per layer (128 heads over 8, G = 16, hd 128): flash and its
    # backward at S=2048, decode at phase 12's last serving step (a cache of 48, kv_len 47);
    # the flash backward at phase 20's training shape (mixtral-8x7b, B=4 S=512, window 4096)
    llama3 = {"H": LLAMA3_H, "K": LLAMA3_K, "hd": 128}
    flash_cases.append(check_flash(ops, ref, timer, dev, torch.bfloat16, 1, 2048, True, None,
                                   **llama3))
    bwd_cases.append(check_flash_bwd(ops, ref, timer, dev, torch.bfloat16, 1, 2048, True, None,
                                     **llama3))
    serve_cache = WIDE_SERVE["prompt_len"] + WIDE_SERVE["gen_len"]
    decode_cases.append(check_decode(ops, ref, timer, dev, torch.bfloat16, 2, serve_cache,
                                     [serve_cache - 1] * 2, **llama3))
    bwd_cases.append(check_flash_bwd(ops, ref, timer, dev, torch.bfloat16, MIXTRAL_TRAIN_B,
                                     MIXTRAL_TRAIN_S, True, MIXTRAL_WINDOW, **mixtral))
    for rec in (decode_cases + flash_cases + mlstm_cases + mlstm_bwd_cases + bwd_cases
                + adamw_cases + moe_cases):
        emit({"phase": "kernel_check", **rec})
    del timer
    free_memory()

    cfg = get_config("smollm_360m")

    # 4. forward: full width, bf16, B=2, S=512
    params = M.init_model(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 512)),
                             device=dev)
    fwd_s, fwd_counts = timed_forward(M, ops, cfg, params, tokens)
    assert fwd_counts["flash_attention"] == cfg.n_layers, fwd_counts
    emit({"phase": "forward", "shape": [2, 512], "dtype": "bf16", "seconds": fwd_s,
          "launches": fwd_counts})
    del params
    free_memory()

    # 5. decode against forward, full width, 64 positions
    for name, dcfg, tol in (("f32", dataclasses.replace(cfg, dtype="float32"), 1e-3),
                            ("bf16", cfg, 5e-2)):
        err, c, truth = decode_vs_forward(M, ops, dcfg, tokens, dev)
        emit({"phase": "decode_vs_forward", "dtype": name, "positions": 64,
              "rel_err": err, "tol": tol, "launches": c, **truth})
        assert err < tol, (name, err, tol)
        assert c == {"flash_attention": dcfg.n_layers, "decode_attention": 64 * dcfg.n_layers,
                     "mlstm_chunk": 0, "flash_attention_bwd": 0, "mlstm_chunk_bwd": 0}, c
    free_memory()

    # 6. serve through the copied engine, full width
    rep, serve_counts = serve_full_width(serve_mod, ops, "smollm_360m", cfg.vocab)
    steps = 32 + 32 - 1
    assert serve_counts["decode_attention"] >= cfg.n_layers * steps * 4, serve_counts
    emit({"phase": "serve", **serve_record(rep, serve_counts)})
    small = dataclasses.replace(reduced(cfg), n_heads=6, n_kv_heads=2)  # G = 3
    emit({"phase": "serve_reference", "config": "reduced smollm f32, H=6 K=2",
          "tokens_equal_cpu": serve_reference(serve_mod, M, small, dev)})

    # 7. decode step profile
    emit({"phase": "decode_step_profile", **profile_decode(cfg, M, dev)})
    free_memory()

    # 8. xlstm-350m
    xlstm_launches = run_xlstm(get_config, reduced, ops, serve_mod, M, dev, tokens)
    free_memory()

    # 9-11. training: full width through the engine, card against CPU, profile
    train = run_train(M, ops, cfg, dev)
    emit({"phase": "train", "card": smi, **train})
    print(f"train: {train['host_s_per_step']:.4f} s per step, "
          f"{train['tokens_per_s']:.0f} tokens/s, peak {train['peak_device_gb']:.1f} GiB "
          f"({smi})", flush=True)
    free_memory()
    emit({"phase": "train_reference", "config": "reduced smollm f32, H=6 K=2",
          **train_reference(M, ops, small, dev)})
    emit({"phase": "train_step_profile", "card": smi, **profile_train(M, cfg, dev)})
    free_memory()

    # 12. nemotron-4-340b, llama3-405b, qwen2-72b, chameleon-34b and mixtral-8x22b at full
    # width, cut in depth
    wide = {prefix: run_wide(get_config, ops, serve_mod, M, dev, smi, arch, prefix, layers,
                             f32_layers)
            for arch, prefix, layers, f32_layers in WIDE_CONFIGS}
    free_memory()

    # 13. the paper's workloads through the engine, at paper scale
    run_apps(ops, smi)
    free_memory()

    # 14. xLSTM training: full width, depth cut, through the engine; card against CPU; profile
    xcfg = get_config("xlstm_350m")
    t_phase = time.perf_counter()
    xtrain = run_train(M, ops, dataclasses.replace(xcfg, n_layers=XLSTM_TRAIN_LAYERS), dev,
                       batch=XLSTM_TRAIN_B, seq=XLSTM_TRAIN_S, steps=XLSTM_TRAIN_STEPS,
                       faults=XLSTM_TRAIN_FAULTS)
    emit({"phase": "xlstm_train", "card": smi, "layers": XLSTM_TRAIN_LAYERS, **xtrain,
          "phase_s": time.perf_counter() - t_phase})
    print(f"xlstm train: {xtrain['host_s_per_step']:.3f} s per step, "
          f"{xtrain['tokens_per_s']:.0f} tokens/s, loss {xtrain['losses'][0]:.4f} -> "
          f"{xtrain['losses'][-1]:.4f} ({smi})", flush=True)
    free_memory()
    t_phase = time.perf_counter()
    emit({"phase": "xlstm_train_reference", "config": "reduced xlstm f32",
          **train_reference(M, ops, reduced(xcfg), dev),
          "phase_s": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    emit({"phase": "xlstm_train_step_profile", "card": smi, "layers": XLSTM_PROFILE_LAYERS,
          **profile_train(M, dataclasses.replace(xcfg, n_layers=XLSTM_PROFILE_LAYERS), dev,
                          batch=XLSTM_TRAIN_B, seq=XLSTM_TRAIN_S, warm=1, steps=2),
          "phase_s": time.perf_counter() - t_phase})
    free_memory()

    # 15. mixtral-8x7b at full width, cut in depth: MoE, the window, the rotating cache
    mixtral_flash, mixtral_decode = run_mixtral(get_config, reduced, ops, serve_mod, M, dev, smi)
    free_memory()

    # 16. jamba-1.5-large at full width, one superblock, experts cut: mamba, the hybrid cache
    jamba_flash, jamba_decode = run_jamba(get_config, reduced, ops, serve_mod, M, dev, smi)
    free_memory()

    # 17. whisper-large-v3 at full width and full depth: the encoder, cross-attention, the
    # filled cross cache
    whisper_flash, whisper_decode = run_whisper(get_config, reduced, ops, serve_mod, M, dev, smi)
    free_memory()

    # 18. whisper-large-v3 training at full width and full depth: both flash backwards at
    # Sq != Skv and the non-causal one, through the engine; card against CPU; profile
    whisper_train = run_whisper_train(get_config, reduced, ops, M, dev, smi)
    free_memory()

    # 19. the dry run: every (arch x shape) cell traced without allocation, each fake kernel
    # held to its kernel, the cells that fit one H100 run on it against their traces
    dryrun_launches = run_dryrun(ops, get_config, dev, smi)
    free_memory()

    # 20. mixtral-8x7b training at full width, one layer: the MoE backward through the
    # engine, one step twice to the bit, card against CPU, profile
    mixtral_train = run_mixtral_train(get_config, reduced, ops, M, dev, smi)
    free_memory()

    moe_kernels = []
    for name in MOE_OPS:
        cases = [c for c in moe_cases if c["kernel"] in (name, f"{name}_bwd")]
        moe_kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu", "replaces": None,
            "note": "no TPU kernel: XLA compiles the JAX package's MoE indexing; this replaces "
                    "the port's gathers (kernels/ref.py moe_dispatch_ref, moe_combine_ref), "
                    "whose autograd backwards sort thousands of duplicate indices",
            "launches": mixtral_train["moe"][name], **_headline(cases[0]),
            "mixtral_train_bwd_launches": mixtral_train["moe"][f"{name}_bwd"], "cases": cases})
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         # bf16 at hd 64/128/192 (the main path); the f32 cases run csrc/flash_attention.cu
         "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attention.py:97",
         "launches": fwd_counts["flash_attention"], **_headline(flash_cases[0]),
         **{f"{p}_launches": w["flash_attention"] for p, w in wide.items()},
         "mixtral_launches": mixtral_flash,
         "jamba_launches": jamba_flash, "whisper_launches": whisper_flash,
         "whisper_train_launches": whisper_train["flash_attention"],
         "mixtral_train_launches": mixtral_train["flash_attention"],
         "dryrun_launches": dryrun_launches["flash_attention"],
         "sharded_launches": dryrun_launches["sharded_flash_attention"], "cases": flash_cases},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:77",
         "launches": serve_counts["decode_attention"], **_headline(decode_cases[0]),
         "mixtral_launches": mixtral_decode, "jamba_launches": jamba_decode,
         "whisper_launches": whisper_decode,
         **{f"{p}_launches": w["decode_attention"] for p, w in wide.items()},
         "cases": decode_cases},
        {"name": "mlstm_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
         "replaces": "src/repro/kernels/linear_attention.py:83",
         "launches": xlstm_launches, **_headline(mlstm_cases[0]), "cases": mlstm_cases},
        {"name": "mlstm_chunk_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm_chunk_bwd.cu",
         "replaces": None,
         "note": "no TPU kernel: the JAX package has no Pallas backward for mlstm_chunk; its "
                 "training differentiates the jnp recurrence (models/ssm.py) through XLA",
         "launches": xtrain["launches"]["mlstm_chunk_bwd"], **_headline(mlstm_bwd_cases[0]),
         "cases": mlstm_bwd_cases},
        {"name": "flash_attention_bwd", "route": "cuda",
         # bf16 at hd 64/128/192 (the main path); f32 runs csrc/flash_attention_bwd.cu
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
         "replaces": None,
         "note": "no TPU kernel: the JAX package has no Pallas backward; its training "
                 "differentiates layers.sdpa through XLA",
         "launches": train["launches"]["flash_attention_bwd"], **_headline(bwd_cases[0]),
         "whisper_train_launches": whisper_train["flash_attention_bwd"],
         "mixtral_train_launches": mixtral_train["flash_attention_bwd"],
         "dryrun_launches": dryrun_launches["flash_attention_bwd"],
         "sharded_launches": dryrun_launches["sharded_flash_attention_bwd"], "cases": bwd_cases},
        {"name": "adamw", "route": "cuda", "source": "src/repro_torch/kernels/csrc/adamw.cu",
         "replaces": None,
         "note": "no TPU kernel: XLA fuses the JAX package's AdamW; this replaces the port's "
                 "unfused fp32 passes (kernels/ref.py adamw_update_ref)",
         "launches": train["adamw_launches"], **_headline(adamw_cases[0]),
         "xlstm_train_launches": xtrain["adamw_launches"],
         "whisper_train_launches": whisper_train["adamw"],
         "mixtral_train_launches": mixtral_train["adamw"],
         "dryrun_launches": dryrun_launches["adamw"],
         "sharded_launches": dryrun_launches["sharded_adamw"], "cases": adamw_cases},
        *moe_kernels,
    ]
    for kr in kernels:
        assert kr["launches"] > 0, kr["name"]
        assert all(n > 0 for key, n in kr.items() if key.endswith("_launches")), kr["name"]
        assert all(math.isfinite(kr[k]) for k in ("ms", "plain_ms", "bound_ms")), kr["name"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def whisper_checks(ops, ref, timer, dev) -> tuple[list, list]:
    """Phase 3's whisper-large-v3 rows (20 heads over 20, hd 64), at the
    shapes phase 17 gives the kernels, in bf16 (its path) and f32 (its
    decode-vs-forward check): the encoder's non-causal self-attention over
    the 1500 frames (ragged against the 64- and 128-row tiles);
    cross-attention from the decoder's 512 tokens, from 37 (ragged, under
    one tile) and from 1 to the 1500 frames; decode over the filled cross
    cache (every frame visible, G = 1); the decoder's causal self-attention
    (G = 1) in the forward (bf16 S = 512) and in the f32 check (S = 64), and
    its decode in serving's last step (bf16, a cache of 32, kv_len 31) and
    in the f32 check (a cache of 64). The rows over the 1500 frames are
    also held to ``WHISPER_RMS_TOL`` of the reference's rms. Returns the
    flash and decode rows."""
    whisper = {"H": WHISPER_H, "K": WHISPER_H, "hd": 64}
    frames = {"rms_tol": WHISPER_RMS_TOL, **whisper}
    F_ = WHISPER_FRAMES
    flash, decode = [], []
    for dtype in (torch.bfloat16, torch.float32):
        flash.append(check_flash(ops, ref, timer, dev, dtype, 2, F_, False, None, **frames))
        for Sq in (512, 37, 1):
            flash.append(check_flash(ops, ref, timer, dev, dtype, 2, Sq, False, None, Skv=F_,
                                     **frames))
        decode.append(check_decode(ops, ref, timer, dev, dtype, 2, F_, [F_, F_], **frames))
    flash.append(check_flash(ops, ref, timer, dev, torch.bfloat16, 2, 512, True, None, **whisper))
    flash.append(check_flash(ops, ref, timer, dev, torch.float32, 2, 64, True, None, **whisper))
    decode.append(check_decode(ops, ref, timer, dev, torch.bfloat16, 2, 32, [31, 31], **whisper))
    decode.append(check_decode(ops, ref, timer, dev, torch.float32, 2, 64, [64, 64], **whisper))
    return flash, decode


def whisper_bwd_checks(ops, ref, timer, dev) -> list:
    """Phase 3's flash backward rows at whisper-large-v3's training shapes
    (phase 18: B=4, 448 decoder tokens, 1500 frames; 20 heads over 20, hd
    64): the encoder's non-causal self-attention over the frames (ragged:
    1500 = 23·64 + 28) and cross-attention from the 448 tokens to the
    frames, each in bf16 (``flash_attention_bwd_wgmma.cu``) and f32
    (``flash_attention_bwd.cu``); cross-attention from 37 queries (ragged,
    under one tile) in bf16; the decoder's causal self-attention at G = 1 in
    bf16."""
    whisper = {"H": WHISPER_H, "K": WHISPER_H, "hd": 64}
    B, S, F_ = WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_FRAMES
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_flash_bwd(ops, ref, timer, dev, dtype, B, F_, False, None, **whisper))
        rows.append(check_flash_bwd(ops, ref, timer, dev, dtype, B, S, False, None, Skv=F_,
                                    **whisper))
    rows.append(check_flash_bwd(ops, ref, timer, dev, torch.bfloat16, B, 37, False, None, Skv=F_,
                                **whisper))
    rows.append(check_flash_bwd(ops, ref, timer, dev, torch.bfloat16, B, S, True, None, **whisper))
    return rows


def mlstm_checks(ops, ref, timer, dev):
    """The mLSTM kernel checks of phase 3, (forward, backward): the forward
    at xlstm-350m's shape (B=2, S=512, H=4, hd = 2·1024/4 = 512), ragged with
    a state, and at hd 64; its backward at xLSTM's training shape with and
    without an initial state and final-state gradients, ragged, at hd 64 and
    at reduced xlstm's hd 32 at a ragged S."""
    fwd = [check_mlstm(ops, ref, timer, dev, 2, 512, 4, 512, False),
           check_mlstm(ops, ref, timer, dev, 2, 300, 4, 512, True),
           check_mlstm(ops, ref, timer, dev, 1, 256, 4, 64, False)]
    B, S = XLSTM_TRAIN_B, XLSTM_TRAIN_S
    bwd = [check_mlstm_bwd(ops, ref, timer, dev, B, S, 4, 512, False, False),
           check_mlstm_bwd(ops, ref, timer, dev, B, S, 4, 512, True, True),
           check_mlstm_bwd(ops, ref, timer, dev, 2, 300, 4, 512, True, False),
           check_mlstm_bwd(ops, ref, timer, dev, 1, 256, 4, 64, False, True),
           check_mlstm_bwd(ops, ref, timer, dev, 2, 200, 4, 32, True, True)]
    return fwd, bwd


# phase 3's AdamW rows: mixtral-8x7b's leaves at phase 20's depth (1 of 32 layers, bf16),
# against the plain version within these units in the last place (the clip scale carries
# the norm's last bit, the second moment's square doubles it), the norm within 1e-6
ADAMW_F32_ULPS, ADAMW_BF16_ULPS = 8, 1


def adamw_bytes(params, grads) -> int:
    """What one AdamW step over these leaves must move: p, g, mu and nu read and
    p, mu and nu written once, and g read once more for the global norm."""
    from repro_torch.tree import leaves

    return sum(2 * p.nbytes + 2 * g.nbytes + 16 * p.numel()
               for p, g in zip(leaves(params), leaves(grads), strict=True))


def adamw_inputs(shapes, g_dtype, dev, seed=29):
    """(params bf16, grads, state) of these shapes, drawn on the card: weights
    ~N(0, 1/32), gradients ~N(0, 1e-3), moments of a few steps' size."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(scale, dtype, positive=False):
        out = {}
        for i, shape in enumerate(shapes):
            t = torch.randn(shape, generator=gen, device=dev).mul_(scale)
            out[f"l{i}"] = (t.abs_() if positive else t).to(dtype)
            del t
        return out

    params, grads = draw(1 / 32, torch.bfloat16), draw(1e-3, g_dtype)
    state = {"mu": draw(1e-4, torch.float32), "nu": draw(1e-8, torch.float32, positive=True),
             "count": torch.tensor(3, dtype=torch.int32, device=dev)}
    return params, grads, state


def fused_adamw_ms(timer, shape, dev) -> float:
    """``torch._fused_adamw_`` on one leaf, timed as a yardstick (the port
    never calls it): its lists share one dtype, so p, g, mu and nu are fp32
    (28 bytes a parameter), and it has no global-norm clip."""
    gen = torch.Generator(device=dev).manual_seed(31)
    p, g, m = (torch.randn(shape, generator=gen, device=dev) * s for s in (1 / 32, 1e-3, 1e-4))
    v = torch.full(shape, 1e-8, device=dev)
    step = torch.tensor(3.0, device=dev)
    ms = timer(lambda: torch._fused_adamw_([p], [g], [m], [v], [], [step], lr=3e-4, beta1=0.9,
                                           beta2=0.95, weight_decay=0.1, eps=1e-8,
                                           amsgrad=False, maximize=False))
    del p, g, m, v
    return ms


def check_adamw(ops, ref, timer, dev, shapes, g_dtype, case: str, plain: bool) -> dict:
    """One AdamW row of phase 3: ``ops.adamw_update`` (the kernels: a sum of
    squares a leaf, the finalize, an update a leaf) over bf16 parameters of
    ``shapes`` with ``g_dtype`` gradients, timed as the attention rows are,
    beside its byte bound (``adamw_bytes``); two calls equal to the bit and 2
    op calls a leaf and 1 a step. With ``plain``, also the plain version
    (``ref.adamw_update_ref``) on the same inputs, timed and held to it, and
    ``torch._fused_adamw_`` on the largest leaf as the library yardstick."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import leaves

    params, grads, state = adamw_inputs(shapes, g_dtype, dev)
    cfg = AdamWConfig()
    lr_scale = torch.tensor(0.5, device=dev)

    def run():
        return ops.adamw_update(grads, state, params, cfg, lr_scale)

    ops.adamw_update.launches = 0
    first = run()
    launches = ops.adamw_update.launches
    assert launches == 2 * len(shapes) + 1, launches
    again = run()
    repeatable = all(torch.equal(a, b) for a, b in zip(leaves(first), leaves(again),
                                                       strict=True))
    del again
    assert repeatable, case
    nbytes = adamw_bytes(params, grads)
    bound_ms, bound_by = bound(nbytes, 0, torch.float32)
    rec = {"kernel": "adamw", "case": case, "grad_dtype": DT_NAME[g_dtype],
           "param_dtype": "bf16", "shapes": [list(s) for s in shapes],
           "parameters": sum(math.prod(s) for s in shapes), "bytes": nbytes,
           "launches_per_step": launches, "repeatable": repeatable,
           "grad_norm": first[2]["grad_norm"].item()}
    if plain:
        want = ref.adamw_update_ref(grads, state, params, cfg, lr_scale)
        gn, gn_ref = first[2]["grad_norm"].item(), want[2]["grad_norm"].item()
        assert abs(gn - gn_ref) <= 1e-6 * gn_ref, (gn, gn_ref)
        errs = {}
        for name, got_t, want_t in (("params", first[0], want[0]), ("mu", first[1]["mu"],
                                                                       want[1]["mu"]),
                                    ("nu", first[1]["nu"], want[1]["nu"])):
            for a, b in zip(leaves(got_t), leaves(want_t), strict=True):
                ulps = ADAMW_BF16_ULPS if b.dtype == torch.bfloat16 else ADAMW_F32_ULPS
                rel = ulps * torch.finfo(b.dtype).eps
                torch.testing.assert_close(a.float(), b.float(), rtol=rel, atol=0)
                errs[name] = max(errs.get(name, 0.0), (a.float() - b.float()).abs().max().item())
        del want
        rec.update({"max_abs_err": errs["params"], "max_abs_err_moments": errs,
                    "grad_norm_rel_err": abs(gn - gn_ref) / gn_ref,
                    "plain_ms": timer(lambda: ref.adamw_update_ref(grads, state, params, cfg,
                                                                   lr_scale))})
    del first
    free_memory()
    rec["ms"] = timer(run)
    rec["kernel_ms"] = timer.kernels_ms(run)
    rec.update({"bound_ms": bound_ms, "bound_by": bound_by,
                "kernel_ms_over_bound": rec["kernel_ms"] / bound_ms})
    del params, grads, state
    free_memory()
    if plain:
        rec["library_ms"] = fused_adamw_ms(timer, max(shapes, key=math.prod), dev)
        rec["library_note"] = "torch._fused_adamw_, fp32 p/g/mu/nu, no clip"
    return rec


def adamw_checks(ops, ref, timer, dev, get_config) -> list:
    """Phase 3's AdamW rows at mixtral-8x7b's leaves, bf16 parameters with bf16
    and with fp32 gradients (b4s512's and accum8's): its expert stack (8 x
    4096 x 14336) alone, against the plain version; and the whole tree of one
    layer (13 leaves, 1.713 B parameters), the kernels alone (the plain
    version's fp32 passes would not fit beside it)."""
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=MIXTRAL_TRAIN_LAYERS)
    shapes = [tuple(t.shape) for t in leaves(M.abstract_params(cfg))]
    expert = next(s for s in shapes if s[1:] == (cfg.moe.n_experts, cfg.d_model, cfg.d_ff))
    cases = []
    for g_dtype in (torch.bfloat16, torch.float32):
        cases.append(check_adamw(ops, ref, timer, dev, [expert], g_dtype,
                                 "mixtral-8x7b expert stack", True))
        cases.append(check_adamw(ops, ref, timer, dev, shapes, g_dtype,
                                 "mixtral-8x7b, 1 layer, every leaf", False))
    return cases


# Phase 3's MoE rows: (case, groups G, group size g, experts E, top k, queue
# places cap, d_model, held (first, E_l)): mixtral-8x7b's training microbatch
# (B=4 S=512 in groups of 512, capacity 1.25) and DeepSeek-V3's decode step
# (256 one-token groups, top 8 of 256, the 8 experts 0-7 of the cell held).
MOE_SHAPES = (("mixtral-8x7b train B=4 S=512", 4, 512, 8, 2, 160, 4096, (0, 8)),
              ("deepseek-v3 decode B=256", 256, 1, 256, 8, 1, 7168, (0, 8)))


def moe_inputs(L, dev, G, g, E, k, cap, d, held, seed=37):
    """(x (G·g, d) bf16, slot_row, row_slot, w (G·g, k) fp32, ye, dout): a route
    from random logits (top k, softmax weights, queues of ``cap``; the
    router's balance before training), its maps over the ``held`` experts,
    random expert outputs and an output gradient."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    top, expert = torch.sort(torch.randn((G, g, E), generator=gen, device=dev), dim=-1,
                             descending=True, stable=True)
    route = L._queued(expert[..., :k], torch.softmax(top[..., :k], dim=-1), E, cap)
    slot_row, row_slot, _, weights = L.moe_maps(route, E, held[1], held[0])
    x = torch.randn((G * g, d), generator=gen, device=dev).bfloat16()
    ye = torch.randn((row_slot.numel(), d), generator=gen, device=dev).bfloat16()
    dout = torch.randn((G * g, d), generator=gen, device=dev)
    return x, slot_row, row_slot, weights.bfloat16().float().reshape(G * g, k), ye, dout


def check_moe(ops, ref, timer, dev, case, G, g, E, k, cap, d, held) -> list:
    """Phase 3's four MoE rows at one shape: each kernel op (the dispatch, its
    backward, the combine, its backward) timed as the attention rows are,
    beside its byte bound (each input row it must read once, each output row
    written once, the maps) and its plain version on the same inputs
    (``ref.moe_dispatch_ref`` / ``moe_combine_ref``, the backwards as autograd
    runs them, timed without the forward), held to it as
    ``tests/test_torch_cuda.py`` holds them: the forwards and dye equal to
    the bit; dx equal to the bit to its rows added in fp32 in slot order and
    rounded once, to the plain version's at k <= 2 (two fp32 addends from 0
    commute), and at k > 2 within k·eps of the type times the sum of its rows'
    magnitudes (``index_put_`` rounds each partial sum to the type); dw of a
    kept assignment within 2·d·2^-24 times the sum of its d terms' magnitudes
    (an fp32 sum in another order) and 0 for a dropped one. Each row records
    its largest gap and its largest gap over its tolerance."""
    from repro_torch.models import layers as L

    K = torch.ops.repro_torch
    x, slot_row, row_slot, w, ye, dout = moe_inputs(L, dev, G, g, E, k, cap, d, held)
    T, R = x.shape[0], row_slot.numel()
    kept = slot_row >= 0
    n_kept, tokens_read = int(kept.sum()), int(kept.any(dim=1).sum())
    es = x.element_size()
    xr = x.detach().clone().requires_grad_()
    xe_plain = ref.moe_dispatch_ref(xr, row_slot, k)
    yr, wr = ye.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    out_plain = ref.moe_combine_ref(yr, wr, slot_row)
    dxe = torch.randn_like(xe_plain)
    dx_plain, = torch.autograd.grad(xe_plain, xr, dxe, retain_graph=True)
    dye_plain, dw_plain = torch.autograd.grad(out_plain, (yr, wr), dout, retain_graph=True)
    maps = {"row_slot": 8 * R, "slot_row": 8 * T * k, "w": 4 * T * k}
    rows = [
        ("moe_dispatch", lambda: K.moe_dispatch(x, row_slot, k),
         lambda: ref.moe_dispatch_ref(x, row_slot, k),
         tokens_read * d * es + maps["row_slot"] + R * d * es),
        ("moe_dispatch_bwd", lambda: K.moe_dispatch_bwd(dxe, slot_row),
         lambda: torch.autograd.grad(xe_plain, xr, dxe, retain_graph=True),
         n_kept * d * es + maps["slot_row"] + T * d * es),
        ("moe_combine", lambda: K.moe_combine(ye, w, slot_row),
         lambda: ref.moe_combine_ref(ye, w, slot_row),
         n_kept * d * es + maps["w"] + maps["slot_row"] + T * d * 4),
        ("moe_combine_bwd", lambda: K.moe_combine_bwd(ye, w, dout, slot_row, row_slot),
         lambda: torch.autograd.grad(out_plain, (yr, wr), dout, retain_graph=True),
         n_kept * d * es + tokens_read * d * 4 + maps["w"] + maps["slot_row"]
         + maps["row_slot"] + R * d * es + 4 * T * k),
    ]
    xe, out = K.moe_dispatch(x, row_slot, k), K.moe_combine(ye, w, slot_row)
    dx = K.moe_dispatch_bwd(dxe, slot_row)
    dye, dw = K.moe_combine_bwd(ye, w, dout, slot_row, row_slot)
    assert torch.equal(xe, xe_plain) and torch.equal(out, out_plain), case
    assert torch.equal(dye, dye_plain), case
    assert k > 2 or torch.equal(dx, dx_plain), case
    rows_dx = torch.where(kept[..., None], dxe[slot_row.clamp(min=0)].float(), 0.0)
    assert torch.equal(dx, _slot_sum(rows_dx).to(dx.dtype)), case
    dx_err = (dx.float() - dx_plain.float()).abs()
    dx_tol = k * torch.finfo(dx.dtype).eps * rows_dx.abs().sum(1)
    dw_err = (dw - dw_plain).abs()[kept]
    dw_tol = (2 * d * 2.0 ** -24 * (dout[:, None, :] * ye[slot_row.clamp(min=0)].float()).abs()
              .sum(-1))[kept]
    assert bool((dw[~kept] == 0).all()), case
    errs = {"moe_dispatch": (0.0, 0.0), "moe_combine": (0.0, 0.0),
            "moe_dispatch_bwd": (dx_err.max().item(), _err_over_tol(dx_err, dx_tol, case)),
            "moe_combine_bwd": (dw_err.max().item(), _err_over_tol(dw_err, dw_tol, case))}
    tols = {"moe_dispatch": "equal", "moe_combine": "equal",
            "moe_dispatch_bwd": "equal" if k <= 2 else "k eps sum|rows|; fp32 slot sum equal",
            "moe_combine_bwd": "dye equal; dw 2d 2^-24 sum|terms|, 0 where dropped"}
    shape = {"G": G, "g": g, "E": E, "k": k, "cap": cap, "d": d, "held": list(held),
             "tokens": T, "rows": R, "kept": n_kept, "slot_use": n_kept / R}
    recs = []
    for name, run, plain, nbytes in rows:
        again = run()
        before = moe_counts(ops)
        first = run()
        assert sum(moe_counts(ops).values()) == sum(before.values()) + 1, (case, name)
        same = all(torch.equal(a, b) for a, b in zip(
            torch.utils._pytree.tree_leaves(first), torch.utils._pytree.tree_leaves(again)))
        assert same, (case, name)
        bound_ms, bound_by = bound(nbytes, 0, torch.bfloat16)
        rec = {"kernel": name, "case": case, "dtype": "bf16", **shape, "bytes": nbytes,
               "repeatable": same, "launches_per_call": 1, "max_abs_err": errs[name][0],
               "tol": tols[name], "err_over_tol": errs[name][1],
               "ms": timer(run),
               "kernel_ms": timer.kernels_ms(run), "bound_ms": bound_ms, "bound_by": bound_by,
               "plain_ms": timer(plain), "library_ms": None}
        rec["kernel_ms_over_bound"] = (rec["kernel_ms"] / bound_ms if rec["kernel_ms"]
                                       else None)
        recs.append(rec)
    del xr, xe_plain, yr, wr, out_plain
    return recs


def _slot_sum(rows: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): the k rows added one after another in slot order."""
    acc = rows[:, 0]
    for j in range(1, rows.shape[1]):
        acc = acc + rows[:, j]
    return acc


def _err_over_tol(err: torch.Tensor, tol: torch.Tensor, case: str) -> float:
    """The largest of err / tol, asserting each err within its tol."""
    assert bool((err <= tol).all()), case
    return (err / tol.clamp(min=torch.finfo(torch.float32).tiny)).max().item()


def moe_checks(ops, ref, timer, dev) -> list:
    """Phase 3's MoE rows at ``MOE_SHAPES``: four a shape."""
    return [rec for case, *shape in MOE_SHAPES
            for rec in check_moe(ops, ref, timer, dev, case, *shape)]


def run_xlstm(get_config, reduced, ops, serve_mod, M, dev, tokens) -> int:
    """Phase 8: xlstm-350m forward, decode against forward, serving, the
    card-vs-CPU serving reference and the decode step profile. Returns the
    ``mlstm_chunk`` launches of the full-width forward."""
    from repro_torch.models import ssm

    cfg = get_config("xlstm_350m")
    n_mlstm = cfg.n_layers // 2                      # pattern ("mlstm", "slstm")
    params = M.init_model(cfg, seed=0, device=dev)
    M.forward(params, cfg, tokens)                   # first call: set-up costs
    fwd_s, fwd_counts = timed_forward(M, ops, cfg, params, tokens)
    assert fwd_counts == {"flash_attention": 0, "decode_attention": 0,
                          "mlstm_chunk": n_mlstm, "flash_attention_bwd": 0,
                          "mlstm_chunk_bwd": 0}, fwd_counts
    # a third forward with each sLSTM call timed (synchronised around it)
    slstm_s, slstm = 0.0, ssm.slstm

    def timed_slstm(*args, **kw):
        nonlocal slstm_s
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = slstm(*args, **kw)
        torch.cuda.synchronize()
        slstm_s += time.perf_counter() - t
        return out

    ssm.slstm = timed_slstm
    try:
        timed_s, _ = timed_forward(M, ops, cfg, params, tokens)
    finally:
        ssm.slstm = slstm
    emit({"phase": "xlstm_forward", "shape": [2, 512], "dtype": "bf16", "seconds": fwd_s,
          "timed_forward_seconds": timed_s, "slstm_loop_seconds": slstm_s,
          "slstm_share": slstm_s / timed_s, "launches": fwd_counts})
    del params
    free_memory()

    f32 = dataclasses.replace(cfg, dtype="float32")
    for name, dcfg, tol, seed in (("f32", f32, 1e-3, 0), ("bf16", cfg, XLSTM_BF16_TOL, 0),
                                  ("bf16", cfg, XLSTM_BF16_TOL, 1),
                                  ("bf16", cfg, XLSTM_BF16_TOL, 2)):
        err, c, truth = decode_vs_forward(M, ops, dcfg, tokens, dev, seed=seed)
        emit({"phase": "xlstm_decode_vs_forward", "dtype": name, "weight_seed": seed,
              "positions": 64, "rel_err": err, "tol": tol, "launches": c, **truth})
        assert err < tol, (name, err, tol)
        assert c == {"flash_attention": 0, "decode_attention": 0, "mlstm_chunk": n_mlstm,
                     "flash_attention_bwd": 0, "mlstm_chunk_bwd": 0}, c
    free_memory()

    rep, serve_counts = serve_full_width(serve_mod, ops, "xlstm_350m", cfg.vocab)
    emit({"phase": "xlstm_serve", **serve_record(rep, serve_counts)})
    emit({"phase": "xlstm_serve_reference", "config": "reduced xlstm f32",
          "tokens_equal_cpu": serve_reference(serve_mod, M, reduced(cfg), dev)})
    emit({"phase": "xlstm_decode_step_profile", **profile_decode(cfg, M, dev)})
    return fwd_counts["mlstm_chunk"]


TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 8
NEMOTRON_H, NEMOTRON_K = 96, 8  # nemotron-4-340b: 96 heads over 8, hd 18432 / 96 = 192
LLAMA3_H, LLAMA3_K = 128, 8     # llama3-405b: 128 heads over 8 (G = 16), hd 16384 / 128 = 128
# mixtral-8x7b: 32 heads over 8, hd 4096 / 32 = 128, window 4096; 8x22b: 48 over 8
MIXTRAL_H, MIXTRAL_22B_H, MIXTRAL_K, MIXTRAL_WINDOW = 32, 48, 8, 4096
MIXTRAL_LAYERS, MIXTRAL_F32_LAYERS = 4, 2        # of 32
# the rotating-cache check: the window cut so that 96 positions wrap its ring
MIXTRAL_RING_WINDOW, MIXTRAL_RING_POSITIONS = 48, 96
# jamba-1.5-large: 64 heads over 8, hd 8192 / 64 = 128. Phase 16 runs one
# superblock of its pattern (7 mamba layers, 1 attention, MoE on 4) at full
# width; a superblock with all 16 experts is 90.5 GB in bf16, so the
# experts are cut: 8 in bf16 (51.8 GB), 4 in f32 (65.0 GB).
JAMBA_H, JAMBA_K = 64, 8
JAMBA_LAYERS = 8                                     # of 72
JAMBA_EXPERTS = {"bf16": 8, "f32": 4}                # of 16
# a card that phase 16 may fill holds no more than this before each init_model
EMPTY_CARD_GB = 0.5
# whisper-large-v3: 20 heads over 20, hd 1280 / 20 = 64, 1500 encoder frames
WHISPER_H, WHISPER_FRAMES = 20, 1500
# Phase 3's rows over the 1500 frames hold the kernel's error to this share
# of the reference's rms as well (rms ~0.043 with randn inputs). bf16
# readings on an H100 (700 W) were 9.8e-4 to 1.95e-3, 0.023-0.045 of the
# rms (PERF.md); 0.1 is about twice the largest. TOL's 2e-2 is about half
# a typical output there; this holds the error to a tenth of one.
WHISPER_RMS_TOL = 0.1
# whisper-large-v3 decode against forward in bf16, at full depth: smollm's
# limit. The JAX package's plain path, its cross cache filled by hand, reads
# 0.010 at the card's depth on the CPU (32 + 32 layers, d_model 256, 150
# frames), the port 0.015 there (tests/test_torch_bf16.py) and 0.018 on an
# H100 at full width (PERF.md).
WHISPER_BF16_TOL = 5e-2
# phase 18's training shape: the decoder's published context of 448 tokens
# (max_target_positions of openai/whisper-large-v3), B=4, 3 AdamW steps with
# no injected failure. The engine keeps every step run's output state: at
# 16.45 GB a state (1.645 B parameters, bf16, and fp32 moments), 3 steps hold
# 4 states; PERF.md works out the peak. A retry would add a state.
WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 4, 448, 3


# Phase 12's configs at full width, their depth cut: (arch, record prefix, bf16 layers,
# f32 layers or None). Their bf16 weights, reckoned from the configs' shapes: nemotron-4-340b
# 32.7 GB (f32 at 1 layer 51.6 GB), llama3-405b 21.2 GB (f32 at 1 layer 29.6 GB),
# qwen2-72b 12.0 GB (f32 at 1 layer 13.5 GB), chameleon-34b 7.7 GB, mixtral-8x22b 10.8 GB.
# The f32 passes hold qwen2's attention bias and llama3's G = 16 on the 3xTF32 route at 1e-3.
WIDE_CONFIGS = (("nemotron_4_340b", "nemotron", 2, 1), ("llama3_405b", "llama3", 2, 1),
                ("qwen2_72b", "qwen2", 4, 1), ("chameleon_34b", "chameleon", 4, None),
                ("mixtral_8x22b", "mixtral_8x22b", 2, None))
# serving in phase 12: 2 requests x batch 2, prompt 32, gen 16
WIDE_SERVE = {"requests": 2, "batch": 2, "prompt_len": 32, "gen_len": 16}


def run_wide(get_config, ops, serve_mod, M, dev, smi, arch, prefix, layers,
             f32_layers) -> dict:
    """Phase 12: ``arch`` at full width, its depth cut to ``layers`` in bf16,
    weights made on the card from a seed. The forward at B=1 S=512 with one
    flash launch per layer; decode against forward over 64 positions (rel <
    5e-2; an MoE config at its drop-free capacity over the positions whose
    routing agrees, with at most ``MIXTRAL_BF16_FLIP_SHARE`` of routings
    flipped); serving through the engine, ``WIDE_SERVE`` (``launch.serve``;
    an MoE config ``launch.serve_lm.run``, with its injected failures); then,
    given ``f32_layers``, decode against forward in f32 at that depth (rel <
    1e-3). Each record is ``<prefix>_forward``, ``_decode_vs_forward`` or
    ``_serve``. Returns the forward's flash launches and the serving run's
    decode launches."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import layers as L
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    moe = cfg.moe is not None
    none = {"decode_attention": 0, "mlstm_chunk": 0, "flash_attention_bwd": 0,
            "mlstm_chunk_bwd": 0}
    shape = {"arch": cfg.name, "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
             "hd": cfg.hd, "G": cfg.n_heads // cfg.n_kv_heads, "d_ff": cfg.d_ff,
             "vocab": cfg.vocab, "qkv_bias": cfg.qkv_bias,
             "cuts": {"n_layers": f"{layers} of {full.n_layers} (bf16)"
                                   + (f", {f32_layers} (f32)" if f32_layers else "")}}

    def gb(params):
        return sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9

    free_memory()
    rng = np.random.default_rng(0)
    params = M.init_model(cfg, seed=0, device=dev)  # made on the card: no host copy
    weights_gb = gb(params)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 512)), device=dev)
    M.forward(params, cfg, tokens[:, :64])           # first call: set-up costs
    fwd_s, fwd_counts = timed_forward(M, ops, cfg, params, tokens)
    assert fwd_counts == {"flash_attention": layers, **none}, fwd_counts
    emit({"phase": f"{prefix}_forward", **shape, "layers": layers, "shape": [1, 512],
          "dtype": "bf16", "seconds": fwd_s, "tokens_per_s": 512 / fwd_s,
          "launches": fwd_counts, "weights_gb": weights_gb,
          "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9, "card": smi})
    dec_tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device=dev)
    want = {"flash_attention": layers, **none, "decode_attention": 64 * layers}
    if moe:
        drop_free = {"moe_capacity_factor": cfg.moe.n_experts / cfg.moe.top_k}
        rec = moe_decode_vs_forward(M, L, ops, dataclasses.replace(cfg, **drop_free),
                                    dec_tokens, params)
        rec = {**rec, "tol": 5e-2, "flip_share_tol": MIXTRAL_BF16_FLIP_SHARE, **drop_free}
        assert rec["rel_err_agreeing"] < 5e-2, rec
        assert rec["flip_share"] <= MIXTRAL_BF16_FLIP_SHARE, rec
    else:
        err, c, _ = decode_vs_forward(M, ops, cfg, dec_tokens, dev, params=params, truth=False)
        rec = {"rel_err": err, "tol": 5e-2, "launches": c}
        assert err < 5e-2, err
    assert rec["launches"] == want, rec["launches"]
    emit({"phase": f"{prefix}_decode_vs_forward", **shape, "layers": layers, "dtype": "bf16",
          "positions": 64, **rec, "weights_gb": weights_gb, "card": smi})
    reset(ops)
    t0 = time.perf_counter()
    if moe:
        rep, lines = serve_lm.run(cfg, params, seed=0, device=dev, **WIDE_SERVE)
        for line in lines:
            print(f"{line} ({smi})", flush=True)
    else:
        rep = serve_mod.serve(cfg, params, seed=0, device=dev, **WIDE_SERVE)
    serve_s = time.perf_counter() - t0
    serve_counts = counts(ops)
    summary = rep.results["summary"]
    n, B = WIDE_SERVE["requests"], WIDE_SERVE["batch"]
    steps = WIDE_SERVE["prompt_len"] + WIDE_SERVE["gen_len"] - 1
    assert len(summary["tokens"]) == n
    for toks in summary["tokens"]:
        assert toks.shape == (B, WIDE_SERVE["gen_len"]) and toks.min() >= 0
        assert toks.max() < cfg.vocab
    # a request re-run after an injected failure decodes again
    assert serve_counts["decode_attention"] >= n * layers * steps, serve_counts
    assert moe or serve_counts["decode_attention"] == n * layers * steps, serve_counts
    emit({"phase": f"{prefix}_serve", **shape, "layers": layers, **WIDE_SERVE,
          "seconds": serve_s, "mean_tokens_per_s": summary["mean_tps"],
          "p99_latency_s": summary["p99_latency_s"], "charged_ms": rep.charged_ms,
          "fault_stats": rep.fault_stats, "launches": serve_counts, "weights_gb": weights_gb,
          "card": smi})
    del params, rep
    free_memory()  # the engine's job graph holds the weights in a reference cycle
    if f32_layers:
        torch.cuda.reset_peak_memory_stats(dev)
        f32 = dataclasses.replace(full, n_layers=f32_layers, dtype="float32")
        params = M.init_model(f32, seed=0, device=dev)
        f32_gb = gb(params)
        err, c, _ = decode_vs_forward(M, ops, f32, dec_tokens, dev, params=params, truth=False)
        del params
        emit({"phase": f"{prefix}_decode_vs_forward", **shape, "layers": f32_layers,
              "dtype": "f32", "positions": 64, "rel_err": err, "tol": 1e-3, "launches": c,
              "weights_gb": f32_gb,
              "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "card": smi})
        assert err < 1e-3, err
        assert c == {"flash_attention": f32_layers, **none,
                     "decode_attention": 64 * f32_layers}, c
        free_memory()
    print(f"{cfg.name} ({layers} layers, bf16, {weights_gb:.1f} GB): forward {fwd_s:.3f} s, "
          f"serving {summary['mean_tps']:.1f} tokens/s ({smi})", flush=True)
    return {"flash_attention": fwd_counts["flash_attention"],
            "decode_attention": serve_counts["decode_attention"]}


def run_mixtral(get_config, reduced, ops, serve_mod, M, dev, smi) -> tuple[int, int]:
    """Phase 15: mixtral-8x7b at full width, its depth cut to 4 layers in
    bf16 (12.1 GB of weights) and to 2 in f32 (12.7 GB). Returns the
    forward's flash launches and the serving run's decode launches."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import layers as L
    from repro_torch.tree import leaves

    full = get_config("mixtral_8x7b")
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.hd, full.d_ff, full.vocab,
            full.moe.n_experts, full.moe.top_k, full.sliding_window, full.rope_theta,
            full.tie_embeddings) == (4096, MIXTRAL_H, MIXTRAL_K, 128, 14336, 32000, 8, 2,
                                     MIXTRAL_WINDOW, 1e6, False)
    E, k = full.moe.n_experts, full.moe.top_k
    cut = {"n_layers": f"{MIXTRAL_LAYERS} of {full.n_layers} (bf16), {MIXTRAL_F32_LAYERS} (f32)"}
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    rng = np.random.default_rng(0)
    params = M.init_model(cfg, seed=0, device=dev)  # made on the card: no 12 GB host copy
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 512)), device=dev)
    M.forward(params, cfg, tokens[:, :64])           # first call: set-up costs
    fwd_s, fwd_counts = timed_forward(M, ops, cfg, params, tokens)
    assert fwd_counts == {"flash_attention": MIXTRAL_LAYERS, "decode_attention": 0,
                          "mlstm_chunk": 0, "flash_attention_bwd": 0, "mlstm_chunk_bwd": 0}
    with routes_recorded(L) as routes:
        M.forward(params, cfg, tokens)
    assert len(routes) == MIXTRAL_LAYERS
    dropped = sum(int((~r.keep).sum()) for r in routes) / sum(r.keep.numel() for r in routes)
    emit({"phase": "mixtral_forward", "layers": MIXTRAL_LAYERS, "shape": [2, 512],
          "dtype": "bf16", "seconds": fwd_s, "tokens_per_s": 2 * 512 / fwd_s,
          "launches": fwd_counts, "cuts": cut,
          "moe": {"capacity_factor": cfg.moe_capacity_factor, "group": routes[0].expert.shape[1],
                  "cap": routes[0].cap, "assignments": sum(r.keep.numel() for r in routes),
                  "dropped_share": dropped},
          "weights_gb": sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9,
          "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9, "card": smi})

    # decode against forward at a drop-free capacity (cap = group), bf16
    drop_free = {"moe_capacity_factor": E / k}
    dec_tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device=dev)
    rec = moe_decode_vs_forward(M, L, ops, dataclasses.replace(cfg, **drop_free), dec_tokens,
                                params)
    emit({"phase": "mixtral_decode_vs_forward", "layers": MIXTRAL_LAYERS, "dtype": "bf16",
          "positions": 64, **rec, "tol": 5e-2, "flip_share_tol": MIXTRAL_BF16_FLIP_SHARE,
          "cuts": {**cut, **drop_free}})
    assert rec["rel_err_agreeing"] < 5e-2, rec
    assert rec["flip_share"] <= MIXTRAL_BF16_FLIP_SHARE, rec
    assert rec["launches"]["flash_attention"] == MIXTRAL_LAYERS
    assert rec["launches"]["decode_attention"] == 64 * MIXTRAL_LAYERS

    # serving through the engine, launch.serve_lm's requests at full width
    reset(ops)
    t0 = time.perf_counter()
    rep, lines = serve_lm.run(cfg, params, requests=4, batch=2, prompt_len=16, gen_len=16,
                              seed=0, device=dev)
    serve_s = time.perf_counter() - t0
    serve_counts = counts(ops)
    summary = rep.results["summary"]
    assert len(summary["tokens"]) == 4
    for toks in summary["tokens"]:
        assert toks.shape == (2, 16) and toks.min() >= 0 and toks.max() < cfg.vocab
    assert serve_counts["decode_attention"] >= 4 * MIXTRAL_LAYERS * (16 + 16 - 1), serve_counts
    for line in lines:
        print(f"{line} ({smi})", flush=True)
    emit({"phase": "mixtral_serve", "layers": MIXTRAL_LAYERS, "requests": 4, "batch": 2,
          "prompt_len": 16, "gen_len": 16, "seconds": serve_s, "lines": lines,
          "mean_tokens_per_s": summary["mean_tps"], "p99_latency_s": summary["p99_latency_s"],
          "charged_ms": rep.charged_ms, "fault_stats": rep.fault_stats,
          "launches": serve_counts, "card": smi})
    del params, rep
    free_memory()  # the engine's job graph holds the weights in a reference cycle

    # f32: decode against forward, then with the window cut so that the ring wraps
    f32 = dataclasses.replace(full, n_layers=MIXTRAL_F32_LAYERS, dtype="float32", **drop_free)
    params = M.init_model(f32, seed=0, device=dev)
    ring_tokens = torch.as_tensor(rng.integers(0, f32.vocab, (2, MIXTRAL_RING_POSITIONS)),
                                  device=dev)
    for name, c, toks in (("f32", f32, dec_tokens),
                          ("f32_ring", dataclasses.replace(f32, sliding_window=MIXTRAL_RING_WINDOW),
                           ring_tokens)):
        rec = moe_decode_vs_forward(M, L, ops, c, toks, params)
        extra = ({"sliding_window": f"{MIXTRAL_RING_WINDOW} (cut from {MIXTRAL_WINDOW})"}
                 if c.sliding_window != MIXTRAL_WINDOW else {})
        emit({"phase": "mixtral_decode_vs_forward", "layers": MIXTRAL_F32_LAYERS,
              "dtype": name, "positions": toks.shape[1], **rec, "tol": 1e-3,
              "cuts": {**cut, **drop_free, **extra},
              "cache_len": min(toks.shape[1], c.sliding_window)})
        assert rec["rel_err"] < 1e-3, rec
        assert rec["launches"]["flash_attention"] == MIXTRAL_F32_LAYERS
        assert rec["launches"]["decode_attention"] == toks.shape[1] * MIXTRAL_F32_LAYERS
    del params
    free_memory()

    small = dataclasses.replace(reduced(full), sliding_window=8)
    emit({"phase": "mixtral_serve_reference", "config": "reduced mixtral f32, window 8",
          "tokens_equal_cpu": serve_reference(serve_mod, M, small, dev)})
    emit({"phase": "mixtral_decode_step_profile", "layers": MIXTRAL_LAYERS, "card": smi,
          **profile_decode(cfg, M, dev, batch=2)})
    print(f"mixtral (4 layers, bf16): forward {fwd_s:.3f} s, dropped {dropped:.2%} at capacity "
          f"factor {cfg.moe_capacity_factor}, serving {summary['mean_tps']:.1f} tokens/s ({smi})",
          flush=True)
    return fwd_counts["flash_attention"], serve_counts["decode_attention"]


def run_jamba(get_config, reduced, ops, serve_mod, M, dev, smi) -> tuple[int, int]:
    """Phase 16: jamba-1.5-large at full width (d_model 8192, d_inner 16384,
    N 16, 64 heads over 8, hd 128, d_ff 24576, vocab 65536, untied head),
    its depth cut to one superblock (8 of 72 layers) and its experts from 16
    to 8 in bf16 and to 4 in f32. Forward at B=2 S=512 (two scan chunks)
    with the mamba layer's launches and device time, decode against forward
    over 64 positions at a drop-free capacity, serving through
    ``launch.serve_lm``, the reduced f32 model's serving and training on the
    card against the CPU, and the decode step profile. Returns the forward's
    flash launches and the serving run's decode launches."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.tree import leaves

    full = get_config("jamba_1_5_large_398b")
    assert (full.d_model, full.d_inner, full.ssm_state_dim, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab, full.moe.n_experts, full.moe.top_k,
            full.sliding_window, full.tie_embeddings) == (8192, 16384, 16, JAMBA_H, JAMBA_K, 128,
                                                          24576, 65536, 16, 2, None, False)
    k = full.moe.top_k

    def config(dt, **kw):
        moe = dataclasses.replace(full.moe, n_experts=JAMBA_EXPERTS[dt])
        return dataclasses.replace(full, n_layers=JAMBA_LAYERS, moe=moe, **kw)

    def cut(dt, **kw):
        return {"n_layers": f"{JAMBA_LAYERS} of {full.n_layers}",
                "n_experts": f"{JAMBA_EXPERTS[dt]} of {full.moe.n_experts}", **kw}

    def made(cfg):  # weights drawn on the card from a seed, on a card holding nothing else
        allocated = torch.cuda.memory_allocated(dev) / 1e9
        assert allocated < EMPTY_CARD_GB, allocated
        return M.init_model(cfg, seed=0, device=dev)

    def gb(params):
        return sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9

    cfg = config("bf16")
    mixers = [cfg.mixer_of(e) for e in cfg.block_pattern]
    n_attn, n_mamba = mixers.count("attn"), mixers.count("mamba")
    n_moe = sum(cfg.mlp_of(e) == "moe" for e in cfg.block_pattern)
    none = {"decode_attention": 0, "mlstm_chunk": 0, "flash_attention_bwd": 0,
            "mlstm_chunk_bwd": 0}
    rng = np.random.default_rng(0)
    params = made(cfg)
    weights_gb = gb(params)
    step_gb = weights_gb - gb([params["embed"]])  # a decode step reads B rows of the embedding
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 512)), device=dev)
    M.forward(params, cfg, tokens[:, :64])           # first call: set-up costs
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_s, fwd_counts = timed_forward(M, ops, cfg, params, tokens)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    assert fwd_counts == {"flash_attention": n_attn, **none}, fwd_counts
    with routes_recorded(L) as routes:
        M.forward(params, cfg, tokens)
    assert len(routes) == n_moe
    dropped = sum(int((~r.keep).sum()) for r in routes) / sum(r.keep.numel() for r in routes)
    moe = {"capacity_factor": cfg.moe_capacity_factor, "group": routes[0].expert.shape[1],
           "cap": routes[0].cap, "assignments": sum(r.keep.numel() for r in routes),
           "dropped_share": dropped}
    # one mamba layer at the forward's shape and at one decode step
    mixer = {name: leaf[0] for name, leaf in params["blocks"][0]["mixer"].items()}
    gen = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    state = (torch.zeros((2, cfg.ssm_conv_width - 1, cfg.d_inner), dtype=torch.bfloat16,
                         device=dev),
             torch.zeros((2, cfg.d_inner, cfg.ssm_state_dim), device=dev))
    mamba_layer = {"forward": kernel_summary(profiled(lambda: ssm.mamba(mixer, h, cfg))[0]),
                   "decode_step": kernel_summary(profiled(
                       lambda: ssm.mamba(mixer, h[:, :1], cfg, state=state))[0])}
    del h, state, mixer, routes  # views and records of the weights: they must go with them
    emit({"phase": "jamba_forward", "layers": JAMBA_LAYERS, "mamba_layers": n_mamba,
          "shape": [2, 512], "dtype": "bf16", "seconds": fwd_s, "tokens_per_s": 2 * 512 / fwd_s,
          "launches": fwd_counts, "cuts": cut("bf16"), "mamba_layer": mamba_layer,
          "moe": moe, "weights_gb": weights_gb,
          "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9, "peak_allocated_gb": peak_gb,
          "card": smi})

    # decode against forward at a drop-free capacity (cap = group), bf16
    drop_free = {"moe_capacity_factor": JAMBA_EXPERTS["bf16"] / k}
    dec_tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device=dev)
    rec = moe_decode_vs_forward(M, L, ops, dataclasses.replace(cfg, **drop_free), dec_tokens,
                                params)
    emit({"phase": "jamba_decode_vs_forward", "layers": JAMBA_LAYERS, "dtype": "bf16",
          "positions": 64, **rec, "tol": JAMBA_BF16_TOL, "flip_share_tol": JAMBA_BF16_FLIP_SHARE,
          "cuts": cut("bf16", **drop_free)})
    assert rec["rel_err_agreeing"] < JAMBA_BF16_TOL, rec
    assert rec["flip_share"] <= JAMBA_BF16_FLIP_SHARE, rec
    assert rec["launches"] == {"flash_attention": n_attn, **none,
                               "decode_attention": 64 * n_attn}, rec["launches"]

    # serving through the engine, launch.serve_lm's requests at full width
    reset(ops)
    t0 = time.perf_counter()
    rep, lines = serve_lm.run(cfg, params, requests=4, batch=2, prompt_len=16, gen_len=16,
                              seed=0, device=dev)
    serve_s = time.perf_counter() - t0
    serve_counts = counts(ops)
    summary = rep.results["summary"]
    assert len(summary["tokens"]) == 4
    for toks in summary["tokens"]:
        assert toks.shape == (2, 16) and toks.min() >= 0 and toks.max() < cfg.vocab
    assert serve_counts["decode_attention"] >= 4 * n_attn * (16 + 16 - 1), serve_counts
    for line in lines:
        print(f"{line} ({smi})", flush=True)
    emit({"phase": "jamba_serve", "layers": JAMBA_LAYERS, "requests": 4, "batch": 2,
          "prompt_len": 16, "gen_len": 16, "seconds": serve_s, "lines": lines,
          "mean_tokens_per_s": summary["mean_tps"], "p99_latency_s": summary["p99_latency_s"],
          "charged_ms": rep.charged_ms, "fault_stats": rep.fault_stats,
          "launches": serve_counts, "cuts": cut("bf16"), "card": smi})
    del params, rep
    free_memory()  # the engine's job graph holds the weights in a reference cycle

    # f32, 4 experts: decode against forward
    f32 = config("f32", dtype="float32", moe_capacity_factor=JAMBA_EXPERTS["f32"] / k)
    params = made(f32)
    rec = moe_decode_vs_forward(M, L, ops, f32, dec_tokens, params)
    emit({"phase": "jamba_decode_vs_forward", "layers": JAMBA_LAYERS, "dtype": "f32",
          "positions": 64, **rec, "tol": 1e-3, "weights_gb": gb(params),
          "cuts": cut("f32", moe_capacity_factor=f32.moe_capacity_factor)})
    assert rec["rel_err"] < 1e-3, rec
    assert rec["launches"] == {"flash_attention": n_attn, **none,
                               "decode_attention": 64 * n_attn}, rec["launches"]
    del params
    free_memory()

    small = reduced(full)
    emit({"phase": "jamba_serve_reference", "config": "reduced jamba f32",
          "tokens_equal_cpu": serve_reference(serve_mod, M, small, dev)})
    emit({"phase": "jamba_train_reference", "config": "reduced jamba f32",
          **train_reference(M, ops, small, dev)})
    allocated = torch.cuda.memory_allocated(dev) / 1e9
    assert allocated < EMPTY_CARD_GB, allocated
    with routes_recorded(L) as routes:
        prof = profile_decode(cfg, M, dev, batch=2)
    bound_ms = step_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    # the padded dispatch reads every expert; a step needs only those its tokens chose
    E = JAMBA_EXPERTS["bf16"]
    chosen = statistics.mean(int(r.expert[r.keep].unique().numel()) for r in routes)
    expert_gb = 3 * cfg.d_model * cfg.d_ff * 2 / 1e9                # w_gate, w_up, w_down, bf16
    needed_gb = step_gb - n_moe * (E - chosen) * expert_gb
    needed_ms = needed_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    del routes
    emit({"phase": "jamba_decode_step_profile", "layers": JAMBA_LAYERS, "card": smi,
          "cuts": cut("bf16"), **prof, "weights_read_gb": step_gb, "bound_ms": bound_ms,
          "device_ms_over_bound": prof["device_ms_per_step"] / bound_ms,
          "experts_chosen_per_moe_layer": chosen, "needed_weights_gb": needed_gb,
          "needed_bound_ms": needed_ms,
          "device_ms_over_needed_bound": prof["device_ms_per_step"] / needed_ms})
    print(f"jamba (8 layers, 8 experts, bf16): forward {fwd_s:.3f} s, a mamba layer "
          f"{mamba_layer['forward']['launches']} launches at S=512 and "
          f"{mamba_layer['decode_step']['launches']} a decode step, dropped {dropped:.2%} at "
          f"capacity factor {cfg.moe_capacity_factor}, serving {summary['mean_tps']:.1f} "
          f"tokens/s, a decode step {prof['device_ms_per_step']:.2f} ms on the card against a "
          f"bound of {bound_ms:.2f} (padded dispatch) and {needed_ms:.2f} (the experts chosen) "
          f"({smi})", flush=True)
    return fwd_counts["flash_attention"], serve_counts["decode_attention"]


def whisper_frames(cfg, batch, seed, dev) -> torch.Tensor:
    """Frame embeddings (batch, enc_frames, d_model) fp32 on the card: a
    request's frames as serving draws them (``serve.request_frames``, request
    0 of ``seed``): the config's audio frontend is a stub."""
    from repro_torch.launch.serve import request_frames

    return torch.from_numpy(request_frames(seed, 0, batch, cfg.enc_frames, cfg.d_model)).to(dev)


def whisper_forward_flops(cfg, B, S) -> float:
    """The operations of one encoder-decoder forward at decoder length S:
    every matmul of the encoder over the frames and of the decoder over its
    tokens (cross-attention's keys and values over the frames), attention's
    4·hd per visible (query, key) pair and head, and the head."""
    d, F_, H, K, hd = cfg.d_model, cfg.enc_frames, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qo, kv, mlp = 2 * d * H * hd, 2 * d * K * hd, 2 * d * cfg.d_ff
    enc = 2 * B * F_ * (qo + kv + mlp) + 4 * B * H * hd * F_ * F_
    dec = (2 * B * S * (qo + kv + qo + mlp) + 2 * B * F_ * kv
           + 4 * B * H * hd * (S * (S + 1) / 2 + S * F_))
    return cfg.n_enc_layers * enc + cfg.n_layers * dec + 2 * B * S * d * cfg.vocab


def run_whisper(get_config, reduced, ops, serve_mod, M, dev, smi) -> tuple[int, int]:
    """Phase 17: whisper-large-v3 at full width and full depth (d_model 1280,
    20 heads over 20, hd 64, d_ff 5120 GELU, vocab 51866, 32 encoder and 32
    decoder layers, 1500 frames), weights made on the card from a seed on a
    card that holds nothing else, frames drawn from a seed (the frontend is
    a stub). Forward at B=2 S=512 (per layer set three flash launches: the
    encoder's, the decoder's causal self-attention, cross-attention);
    decode against forward over 64 positions with the cross cache filled by
    ``prefill_cross``, bf16 and f32; ``launch.serve_lm``'s requests through
    the engine; the reduced f32 model's serving on the card against the
    CPU; the decode step profile beside its byte bound. Returns the
    forward's flash launches and the serving run's decode launches."""
    from repro_torch.launch import serve_lm
    from repro_torch.tree import leaves

    cfg = get_config("whisper_large_v3")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.activation,
            cfg.vocab, cfg.n_layers, cfg.n_enc_layers, cfg.enc_frames, cfg.tie_embeddings,
            cfg.enc_dec) == (1280, WHISPER_H, WHISPER_H, 64, 5120, "gelu", 51866, 32, 32,
                             WHISPER_FRAMES, False, True)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    none = {"mlstm_chunk": 0, "flash_attention_bwd": 0, "mlstm_chunk_bwd": 0}

    def made(c):  # weights drawn on the card from a seed, on a card holding nothing else
        allocated = torch.cuda.memory_allocated(dev) / 1e9
        assert allocated < EMPTY_CARD_GB, allocated
        return M.init_model(c, seed=0, device=dev)

    def gb(tensors):
        return sum(t.numel() * t.element_size() for t in tensors) / 1e9

    rng = np.random.default_rng(0)
    params = made(cfg)
    weights_gb = gb(leaves(params))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 512)), device=dev)
    frames = whisper_frames(cfg, 2, 0, dev)
    M.forward(params, cfg, tokens[:, :64], frames)    # first call: set-up costs
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_s, fwd_counts = timed_forward(M, ops, cfg, params, tokens, enc_embeds=frames)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    assert fwd_counts == {"flash_attention": n_enc + 2 * n_dec, "decode_attention": 0,
                          **none}, fwd_counts
    flops = whisper_forward_flops(cfg, 2, 512)
    fwd_bound_ms, fwd_bound_by = bound(weights_gb * 1e9, flops, torch.bfloat16)
    kernels, traced_ms = profiled(lambda: M.forward(params, cfg, tokens, frames))
    fwd_kernels = kernel_summary(kernels)
    flash_ms = sum(e.self_device_time_total for e in kernels if "flash" in e.key) / 1e3
    emit({"phase": "whisper_forward", "layers": [n_enc, n_dec], "frames": cfg.enc_frames,
          "shape": [2, 512], "dtype": "bf16", "seconds": fwd_s, "tokens_per_s": 2 * 512 / fwd_s,
          "launches": fwd_counts, "flops": flops, "bound_ms": fwd_bound_ms,
          "bound_by": fwd_bound_by, "seconds_over_bound": fwd_s * 1e3 / fwd_bound_ms,
          "traced_ms": traced_ms, "device_ms": fwd_kernels["device_ms"],
          "device_ms_over_bound": fwd_kernels["device_ms"] / fwd_bound_ms,
          "device_busy_share": fwd_kernels["device_ms"] / (fwd_s * 1e3),
          "kernel_launches": fwd_kernels["launches"], "flash_ms": flash_ms,
          "top_kernels": fwd_kernels["top_kernels"],
          "weights_gb": weights_gb, "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9,
          "peak_allocated_gb": peak_gb, "card": smi})

    # decode against forward over 64 positions, the cross cache filled from the encoder
    dec_tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), device=dev)
    dec_frames = whisper_frames(cfg, 2, 1, dev)
    want = {"flash_attention": 2 * n_enc + 2 * n_dec, "decode_attention": 64 * 2 * n_dec,
            **none}  # the forward's 96 and prefill_cross's encoder; self and cross a step
    err, c, truth = decode_vs_forward(M, ops, cfg, dec_tokens, dev, params=params,
                                      enc_embeds=dec_frames)
    emit({"phase": "whisper_decode_vs_forward", "dtype": "bf16", "positions": 64,
          "rel_err": err, "tol": WHISPER_BF16_TOL, "launches": c, **truth})
    assert err < WHISPER_BF16_TOL, err
    assert c == want, c

    # serving through the engine, launch.serve_lm's requests at full width
    reset(ops)
    t0 = time.perf_counter()
    rep, lines = serve_lm.run(cfg, params, requests=4, batch=2, prompt_len=16, gen_len=16,
                              seed=0, device=dev)
    serve_s = time.perf_counter() - t0
    serve_counts = counts(ops)
    summary = rep.results["summary"]
    assert len(summary["tokens"]) == 4
    for toks in summary["tokens"]:
        assert toks.shape == (2, 16) and toks.min() >= 0 and toks.max() < cfg.vocab
    # at least every request once: each encodes its frames, then 31 steps of 2 per layer
    assert serve_counts["flash_attention"] >= 4 * n_enc, serve_counts
    assert serve_counts["decode_attention"] >= 4 * 2 * n_dec * (16 + 16 - 1), serve_counts
    for line in lines:
        print(f"{line} ({smi})", flush=True)
    emit({"phase": "whisper_serve", "requests": 4, "batch": 2, "prompt_len": 16,
          "gen_len": 16, "seconds": serve_s, "lines": lines,
          "mean_tokens_per_s": summary["mean_tps"], "p99_latency_s": summary["p99_latency_s"],
          "mean_prefill_s": summary["mean_prefill_s"], "charged_ms": rep.charged_ms,
          "fault_stats": rep.fault_stats, "launches": serve_counts, "card": smi})
    # what a decode step reads: every decoder-layer weight but cross-attention's wk and wv
    # (prefill_cross used them), the head, and the cross caches (the self caches' few
    # rows, under 1 % of it, are left out)
    step_gb = (gb(t for block in params["blocks"] for t in leaves(block))
               - gb(block["cross"][w] for block in params["blocks"] for w in ("wk", "wv"))
               + gb([params["lm_head"]])
               + 2 * n_dec * 2 * cfg.enc_frames * cfg.n_kv_heads * cfg.hd * 2 / 1e9)
    del params, rep
    free_memory()  # the engine's job graph holds the weights in a reference cycle

    # f32: decode against forward
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = made(f32)
    err, c, _ = decode_vs_forward(M, ops, f32, dec_tokens, dev, params=params,
                                  enc_embeds=dec_frames)
    emit({"phase": "whisper_decode_vs_forward", "dtype": "f32", "positions": 64,
          "rel_err": err, "tol": 1e-3, "launches": c, "weights_gb": gb(leaves(params))})
    assert err < 1e-3, err
    assert c == want, c
    del params
    free_memory()

    emit({"phase": "whisper_serve_reference", "config": "reduced whisper f32",
          "tokens_equal_cpu": serve_reference(serve_mod, M, reduced(cfg), dev)})
    allocated = torch.cuda.memory_allocated(dev) / 1e9
    assert allocated < EMPTY_CARD_GB, allocated
    prof = profile_decode(cfg, M, dev, batch=2)
    bound_ms = step_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    emit({"phase": "whisper_decode_step_profile", "card": smi, **prof, "bytes_read_gb": step_gb,
          "bound_ms": bound_ms, "device_ms_over_bound": prof["device_ms_per_step"] / bound_ms})
    print(f"whisper-large-v3 (32 + 32 layers, bf16): forward {fwd_s:.3f} s at B=2 S=512 "
          f"({fwd_bound_ms:.2f} ms bound), serving {summary['mean_tps']:.1f} tokens/s, prefill "
          f"{summary['mean_prefill_s']:.3f} s, a decode step {prof['device_ms_per_step']:.2f} ms "
          f"on the card against a bound of {bound_ms:.2f} ({smi})", flush=True)
    return fwd_counts["flash_attention"], serve_counts["decode_attention"]


def run_whisper_train(get_config, reduced, ops, M, dev, smi) -> dict:
    """Phase 18: whisper-large-v3 training at full width and full depth
    (phase 17's model, 32 + 32 layers, 1500 frames, bf16, weights made on
    the card from a seed on a card that holds nothing else), B=4 S=448.
    ``whisper_train``: ``WHISPER_TRAIN_STEPS`` AdamW steps on one fixed
    ``synthetic_batch`` (tokens and frames) through the engine, no injected
    failure; the loss finite and falling; per step run 2 x 96 flash forward
    launches (encoder, decoder self- and cross-attention, each twice under
    ``remat``) and 96 backward launches. ``whisper_train_reference``:
    reduced f32 whisper, 3 steps on the card and the CPU (loss 1e-4, params
    2e-3). ``whisper_train_step_profile``: ``profile_train`` at the same
    shape beside the step's bound from its operations. Returns the train
    phase's launches."""
    cfg = get_config("whisper_large_v3")
    B, S = WHISPER_TRAIN_B, WHISPER_TRAIN_S
    allocated = torch.cuda.memory_allocated(dev) / 1e9
    assert allocated < EMPTY_CARD_GB, allocated
    t_phase = time.perf_counter()
    wtrain = run_train(M, ops, cfg, dev, batch=B, seq=S, steps=WHISPER_TRAIN_STEPS, faults=None)
    per_run = train_launches(cfg, 1)
    assert per_run["flash_attention"] == 2 * 96 and per_run["flash_attention_bwd"] == 96, per_run
    emit({"phase": "whisper_train", "card": smi, "layers": [cfg.n_enc_layers, cfg.n_layers],
          "frames": cfg.enc_frames, **wtrain, "phase_s": time.perf_counter() - t_phase})
    print(f"whisper train (32 + 32 layers, bf16, B={B} S={S}): "
          f"{wtrain['host_s_per_step']:.3f} s per step, {wtrain['tokens_per_s']:.0f} tokens/s, "
          f"loss {wtrain['losses'][0]:.4f} -> {wtrain['losses'][-1]:.4f}, peak "
          f"{wtrain['peak_device_gb']:.1f} GiB ({smi})", flush=True)
    free_memory()
    t_phase = time.perf_counter()
    emit({"phase": "whisper_train_reference", "config": "reduced whisper f32",
          **train_reference(M, ops, reduced(cfg), dev), "phase_s": time.perf_counter() - t_phase})
    allocated = torch.cuda.memory_allocated(dev) / 1e9
    assert allocated < EMPTY_CARD_GB, allocated
    t_phase = time.perf_counter()
    prof = profile_train(M, cfg, dev, batch=B, seq=S, warm=1, steps=2)
    fwd_flops = whisper_forward_flops(cfg, B, S)
    step_flops = 3 * fwd_flops   # the forward, and the backward at twice its operations
    # the state (params and moments) read once and written once; the forward
    # recomputed under remat counted in, and beside it the bound without it
    nbytes = 2 * prof["state_gb"] * 1e9
    bound_ms, bound_by = bound(nbytes, step_flops + fwd_flops, torch.bfloat16)
    emit({"phase": "whisper_train_step_profile", "card": smi, **prof,
          "step_flops": step_flops, "remat_recompute_flops": fwd_flops, "bytes": nbytes,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_ms_without_recompute": bound(nbytes, step_flops, torch.bfloat16)[0],
          "device_ms_over_bound": prof["device_ms_per_step"] / bound_ms,
          "step_ms_over_bound": prof["step_ms"] / bound_ms,
          "phase_s": time.perf_counter() - t_phase})
    return {**wtrain["launches"], "adamw": wtrain["adamw_launches"]}


# phase 20's training shape: mixtral-8x7b at full width, 1 of its 32 layers, B=4 S=512 in
# bf16 under remat (1.713 B parameters: 17.13 GB of state with AdamW's fp32 moments). The
# engine keeps every step run's state: 3 steps when train_peak_reckoning leaves this much of
# the card free, else 2.
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_S = 1, 4, 512
TRAIN_PEAK_MARGIN_GIB = 2.0


def train_peak_reckoning(M, cfg, steps: int) -> dict:
    """The training workflow's peak device memory, reckoned from the config's
    shapes (``model.abstract_params``) before it runs. The engine keeps every
    step run's state (the parameters and AdamW's fp32 moments), so the last
    of ``steps`` runs starts with ``steps`` states held; one step then peaks
    at the end of ``adamw_update``, holding the gradients in the parameters'
    dtype and the new parameters and moments: the AdamW kernels write each
    leaf's into fresh tensors and hold no temporary of a leaf's size, only
    the norm's partial sums (``SLOTS`` fp32 a leaf). The loss's activations
    are freed by then."""
    from repro_torch.kernels.adamw import SLOTS
    from repro_torch.tree import leaves

    shapes = leaves(M.abstract_params(cfg))
    params_b = sum(t.numel() * t.element_size() for t in shapes)
    moments_b = 8 * sum(t.numel() for t in shapes)
    state_b = params_b + moments_b + 4                       # and the int32 step count
    step_b = params_b + (params_b + moments_b + 4) + 4 * SLOTS * len(shapes)
    return {"steps": steps, "state_gb": state_b / 1e9, "step_above_state_gib": step_b / 2**30,
            "peak_gib": (steps * state_b + step_b) / 2**30}


def moe_train_flops(cfg, B, S, kept: int) -> dict:
    """The operations of one training step of an ``attn+moe`` decoder at (B,
    S): per layer the attention projections, attention's 4·hd per visible
    (query, key) pair and head, and the router; the three expert products of
    each of the ``kept`` assignments (every layer's); the head. The step is
    three forwards (the backward at twice the forward's operations); under
    ``remat`` the layers' forward once more."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = cfg.sliding_window or S
    pairs = sum(min(t + 1, window) for t in range(S))
    attn = 2 * B * S * d * (2 * H * hd + 2 * K * hd) + 4 * B * H * hd * pairs
    layers = cfg.n_layers * (attn + 2 * B * S * d * cfg.moe.n_experts) + kept * 3 * 2 * d * cfg.d_ff
    head = 2 * B * S * d * cfg.vocab
    return {"forward": layers + head, "step": 3 * (layers + head),
            "remat_recompute": layers if cfg.remat else 0}


def expert_gemms(cfg, rows: int, dev) -> dict:
    """The expert products of one MoE layer at a train step's dispatch shape
    (E experts x ``rows`` rows x d_model, bf16), taken apart from the step,
    each timed between CUDA events (``Timer``): the forward's three products
    (x·w_gate, x·w_up, h·w_down) alone and with the SwiGLU between, and the
    backward's six (dh = dy·w_downᵀ, dw_down = hᵀ·dy, dx from dg·w_gateᵀ and
    du·w_upᵀ, dw_gate = xᵀ·dg, dw_up = xᵀ·du) alone and as autograd runs them
    with the SwiGLU's gradient."""
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(11)
    xe = torch.randn((E, rows, d), generator=g, device=dev).bfloat16().requires_grad_()
    wg, wu = ((torch.randn((E, d, f), generator=g, device=dev) * d ** -0.5).bfloat16()
              .requires_grad_() for _ in range(2))
    wd = (torch.randn((E, f, d), generator=g, device=dev) * f ** -0.5).bfloat16().requires_grad_()
    dy = torch.randn((E, rows, d), generator=g, device=dev).bfloat16()

    def forward():
        return (F.silu(xe @ wg) * (xe @ wu)) @ wd

    ye = forward()
    timer = Timer(dev)
    with torch.no_grad():
        h = F.silu(xe @ wg) * (xe @ wu)
        dg, du = torch.randn_like(h), torch.randn_like(h)   # the SwiGLU's gradients' shape
        fwd_gemm = timer(lambda: (xe @ wg, xe @ wu, h @ wd))
        bwd_gemm = timer(lambda: (dy @ wd.mT, h.mT @ dy, dg @ wg.mT, du @ wu.mT, xe.mT @ dg,
                                  xe.mT @ du))
        fwd = timer(forward)
    bwd = timer(lambda: torch.autograd.grad(ye, (xe, wg, wu, wd), dy, retain_graph=True))
    del timer
    return {"forward": {"ms": fwd, "gemm_ms": fwd_gemm},
            "backward": {"ms": bwd, "gemm_ms": bwd_gemm},
            "flops": {"forward": 3 * 2 * E * rows * d * f, "backward": 6 * 2 * E * rows * d * f}}


def run_mixtral_train(get_config, reduced, ops, M, dev, smi) -> dict:
    """Phase 20: mixtral-8x7b training at full width, its depth cut to
    ``MIXTRAL_TRAIN_LAYERS`` (bf16, ``remat`` on, B=4 S=512), on a card that
    holds nothing else. ``mixtral_train``: the workflow's peak reckoned
    first (``train_peak_reckoning``: 3 steps if that leaves
    ``TRAIN_PEAK_MARGIN_GIB`` of the card, else 2), then that many AdamW
    steps on one fixed ``synthetic_batch`` through the engine with no
    injected failure; the loss finite and falling, per step run 2 flash
    forward launches and 1 backward a layer, the dropped share of the
    forward's assignments and the routings that differ between the forward
    and its recomputation under ``remat`` (none: the route has no atomics);
    the peak against the reckoning. ``mixtral_train_bitwise``: one step run
    twice on one state, parameters, moments and loss equal to the bit, the
    state left as it was (its bits kept on the host). ``mixtral_train_reference``:
    reduced f32 mixtral, 3 steps on the card and the CPU (loss 1e-4, params
    2e-3). ``mixtral_train_step_profile``: ``profile_train`` at the same
    shape, the expert products' forward and backward taken apart
    (``expert_gemms``), the step's bound from the operations of its kept
    assignments and attention (``moe_train_flops``) and from the state read and
    written once. Returns the train phase's launches."""
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train import build_train_step, synthetic_batch
    from repro_torch.tree import leaves

    full = get_config("mixtral_8x7b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_TRAIN_LAYERS)
    assert cfg.remat and cfg.dtype == "bfloat16"
    B, S = MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_S
    cut = {"n_layers": f"{MIXTRAL_TRAIN_LAYERS} of {full.n_layers}"}
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    reckoning = train_peak_reckoning(M, cfg, 3)
    if card_gib - reckoning["peak_gib"] < TRAIN_PEAK_MARGIN_GIB:
        reckoning = train_peak_reckoning(M, cfg, 2)
    steps = reckoning["steps"]
    allocated = torch.cuda.memory_allocated(dev) / 1e9
    assert allocated < EMPTY_CARD_GB, allocated
    t_phase = time.perf_counter()
    with routes_recorded(L) as routes:
        mtrain = run_train(M, ops, cfg, dev, batch=B, seq=S, steps=steps, faults=None)
    per_run = train_launches(cfg, 1)
    assert per_run["flash_attention"] == 2 * cfg.n_layers, per_run
    # per step run each MoE layer routes in the forward, then again in the recomputation,
    # the layers in reverse
    n = cfg.n_layers
    assert len(routes) == 2 * n * mtrain["step_runs"], len(routes)
    fwd = [r for i in range(mtrain["step_runs"]) for r in routes[2 * n * i:2 * n * i + n]]
    again = [r for i in range(mtrain["step_runs"])
             for r in reversed(routes[2 * n * i + n:2 * n * (i + 1)])]
    flips = sum(int((a.expert != b.expert).any(dim=-1).sum()) for a, b in zip(fwd, again))
    same = all(torch.equal(a.slot, b.slot) and torch.equal(a.keep, b.keep)
               for a, b in zip(fwd, again))
    dropped = [int((~r.keep).sum()) / r.keep.numel() for r in fwd]
    del routes, fwd, again
    peak_gib = mtrain["peak_device_gb"]
    emit({"phase": "mixtral_train", "card": smi, "layers": n, "cuts": cut, **mtrain,
          "reckoning": reckoning, "card_gib": card_gib,
          "peak_over_reckoning": peak_gib / reckoning["peak_gib"],
          "moe": {"capacity_factor": cfg.moe_capacity_factor,
                  "dropped_share_by_step_run": dropped,
                  "routing_flips_forward_vs_recompute": flips,
                  "slots_and_drops_equal": same},
          "phase_s": time.perf_counter() - t_phase})
    assert flips == 0 and same, (flips, same)
    assert abs(peak_gib / reckoning["peak_gib"] - 1) <= 0.05, (peak_gib, reckoning)
    print(f"mixtral train (1 layer, bf16, B={B} S={S}): {mtrain['host_s_per_step']:.3f} s per "
          f"step, loss {mtrain['losses'][0]:.4f} -> {mtrain['losses'][-1]:.4f}, peak "
          f"{peak_gib:.2f} GiB against {reckoning['peak_gib']:.2f} reckoned ({smi})", flush=True)
    free_memory()

    # one step run twice on one state: the engine's re-run of a step task
    t_phase = time.perf_counter()
    params = M.init_model(cfg, seed=0, device=dev)
    state = (params, adamw_init(params))
    data = synthetic_batch(cfg, B, S, seed=7, device=dev)
    kept = [t.cpu() for t in leaves(state)]          # the state's bits, on the host
    step = build_train_step(cfg, AdamWConfig(lr=5e-3, weight_decay=0.0, warmup=1))
    first = step(*state, data)
    second = step(*state, data)
    pairs = list(zip(leaves(first), leaves(second), strict=True))
    equal = sum(torch.equal(a, b) for a, b in pairs)
    loss = (first[2]["loss"].item(), second[2]["loss"].item())
    del first, second, pairs
    unchanged = sum(torch.equal(t, k.to(dev)) for t, k in zip(leaves(state), kept, strict=True))
    emit({"phase": "mixtral_train_bitwise", "card": smi, "layers": n, "shape": [B, S],
          "leaves": len(kept) + 3, "equal_leaves": equal, "losses": loss,
          "state_leaves": len(kept), "state_leaves_unchanged": unchanged,
          "phase_s": time.perf_counter() - t_phase})
    assert equal == len(kept) + 3 and loss[0] == loss[1], (equal, loss)  # + the metrics
    assert unchanged == len(kept), unchanged
    del params, state, data, kept
    free_memory()

    t_phase = time.perf_counter()
    emit({"phase": "mixtral_train_reference", "config": "reduced mixtral f32",
          **train_reference(M, ops, reduced(full), dev), "phase_s": time.perf_counter() - t_phase})
    allocated = torch.cuda.memory_allocated(dev) / 1e9
    assert allocated < EMPTY_CARD_GB, allocated
    t_phase = time.perf_counter()
    g = min(cfg.moe_group, S)
    cap = max(1, int(cfg.moe.top_k * g * cfg.moe_capacity_factor / cfg.moe.n_experts))
    rows = B * (S // g) * cap                         # moe_route's queue places per expert
    experts = expert_gemms(cfg, rows, dev)
    free_memory()
    with routes_recorded(L) as routes:
        prof = profile_train(M, cfg, dev, batch=B, seq=S, warm=1, steps=2)
    traced = routes[-2 * n:-n]                        # the traced step's forward
    assert traced[0].cap == cap, (traced[0].cap, cap)
    kept_assignments = sum(int(r.keep.sum()) for r in traced)
    del routes, traced
    flops = moe_train_flops(cfg, B, S, kept_assignments)
    nbytes = 2 * prof["state_gb"] * 1e9
    bound_ms, bound_by = bound(nbytes, flops["step"] + flops["remat_recompute"], torch.bfloat16)
    step_experts_ms = n * (2 * experts["forward"]["ms"] + experts["backward"]["ms"])
    step_gemms_ms = n * (2 * experts["forward"]["gemm_ms"] + experts["backward"]["gemm_ms"])
    emit({"phase": "mixtral_train_step_profile", "card": smi, "layers": n, "cuts": cut, **prof,
          "kept_assignments": kept_assignments, "dispatch_rows_per_expert": rows,
          "expert_products": experts,
          "expert_ms_per_step": step_experts_ms, "expert_gemm_ms_per_step": step_gemms_ms,
          "expert_gemm_tflop_per_s": {k: experts["flops"][k] / experts[k]["gemm_ms"] / 1e9
                                      for k in ("forward", "backward")},
          "expert_share": step_experts_ms / prof["device_ms_per_step"],
          "expert_gemm_share": step_gemms_ms / prof["device_ms_per_step"],
          "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "device_ms_over_bound": prof["device_ms_per_step"] / bound_ms,
          "step_ms_over_bound": prof["step_ms"] / bound_ms,
          "phase_s": time.perf_counter() - t_phase})
    return {**mtrain["launches"], "adamw": mtrain["adamw_launches"],
            "moe": mtrain["moe_launches"]}


def profiled(fn) -> tuple[list, float]:
    """The CUDA kernels of one call of ``fn`` (``torch.profiler``'s
    ``key_averages`` rows, the step's own range left out) and the call's
    host ms, from a trace whose active step runs ``fn`` after a warm-up step
    that runs it too. (A trace without the warm-up step, opened late in the
    script, missed the first ~10 kernels of the call.) The trace records
    the card's activity only: no figure reads the host ops' events, and
    with them the smollm decode profile (a trace of 16 steps) took 27 s."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kernels, host_ms = [], []

    def read(prof):
        kernels.extend(kernel_rows(prof))

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=read) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            prof.step()
    assert kernels, "the profiler gave no trace"
    return kernels, host_ms[-1]


def kernel_rows(prof) -> list:
    """The card's rows of ``prof.key_averages()``: its CUDA rows but the
    ranges that reach the card's timeline as annotations, the profiler's
    steps and the program's ``tracing`` spans (``repro_torch: …``). Then
    forgets the spans the profile recorded (``tracing.reset``, which also
    removes the collection hook), so no profile keeps the last one's."""
    from repro_torch import tracing

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("ProfilerStep", tracing.PREFIX))]
    tracing.reset()
    return rows


def outermost_torch_call(e) -> bool:
    """Whether a host event is a torch call inside none but the program's
    ``tracing`` spans (``engine.job``, ``engine.task``, …)."""
    from repro_torch import tracing

    if e.name.startswith(tracing.PREFIX):
        return False
    p = e.cpu_parent
    while p is not None and p.name.startswith(tracing.PREFIX):
        p = p.cpu_parent
    return p is None


def kernel_summary(kernels, calls: int = 1) -> dict:
    """Launches, device ms and the six largest kernels per call, from the
    kernels that ``profiled`` gives for ``calls`` calls."""
    biggest = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"launches": sum(e.count for e in kernels) / calls,
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3 / calls,
                             "launches": e.count / calls} for e in biggest]}


@contextlib.contextmanager
def routes_recorded(L):
    """Every ``MoeRoute`` that ``layers.moe_route`` returns while open, in
    call order (``moe_mlp`` looks the helper up at each call)."""
    routes, route = [], L.moe_route

    def recorded(*args):
        r = route(*args)
        routes.append(r)
        return r

    L.moe_route = recorded
    try:
        yield routes
    finally:
        L.moe_route = route


def routing_flips(experts, S: int) -> torch.Tensor:
    """(layer, B, S) bool: the (token, layer) routings whose set of chosen
    experts differs between one forward over S positions and S decode
    steps. ``experts`` holds each MoE layer call's chosen experts (B, n, k)
    in call order: the forward's layers (n = S), then each step's (n = 1)."""
    n = len(experts) // (S + 1)
    assert n and len(experts) == n * (S + 1), (len(experts), S)
    chosen = [torch.as_tensor(e).sort(dim=-1).values for e in experts]
    B, k = chosen[0].shape[0], chosen[0].shape[-1]
    fwd = torch.stack(chosen[:n])
    step = torch.cat(chosen[n:], dim=1).reshape(B, S, n, k).permute(2, 0, 1, 3)
    return (fwd != step).any(dim=-1)


def moe_decode_vs_forward(M, L, ops, cfg, tokens, params) -> dict:
    """Step-by-step decode against one forward over ``tokens`` for an MoE
    model, each MoE layer's chosen experts recorded on both paths: the
    relative max error over all positions and over the positions whose
    routing agrees in every layer, the (token, layer) routings that differ
    (flips), and the launches."""
    B, S = tokens.shape
    with routes_recorded(L) as routes:
        dec, full, launches = decode_and_forward(M, ops, cfg, params, tokens)
    flips = routing_flips([r.expert.reshape(B, -1, r.expert.shape[-1]) for r in routes], S)
    flipped = flips.any(dim=0)
    return {"rel_err": rel_err(dec, full),
            "rel_err_agreeing": rel_err(torch.where(flipped[..., None], full, dec), full),
            "routings_flipped": int(flips.sum()), "routings": flips.numel(),
            "flip_share": flips.float().mean().item(),
            "flips_by_layer": flips.sum(dim=(1, 2)).tolist(),
            "positions_left_out": int(flipped.sum()), "launches": launches}


# Phase 13's card-against-CPU price check runs each app at the sizes of
# tests/test_apps.py.
APPS_SMALL = {"gemm": (256, 64), "tsqr": (1024, 32, 8), "rsvd": (512, 8), "svc": (4096, 8, 3)}
# Fig. 10's ablation: the ideal-storage run regenerates the same blocks and
# runs the same products on them; its singular values may differ from the
# normal run's by f32 rounding only if a library call picks another
# algorithm.
IDEAL_SV_RTOL = 1e-6


def run_apps(ops, smi) -> None:
    """Phase 13. First each app at a small size on the card and on the CPU:
    equal engine prices (these runs also load the libraries' kernels). Then
    GEMM, TSQR SVD, randomized SVD (normal and ideal storage) and SVC
    through the copied engine on the card at ``launch.apps.SIZES``: a first
    run held to its float64 reference on the card (host seconds ``cold_s``:
    the allocator grows its cache), a second (``host_s``, blocks reused)
    and a third under ``torch.profiler`` (device time, busy share, the
    engine's share of host time). Last, the copied orchestrator over 20 jobs
    of the default mix on the card and on the CPU: equal reports."""
    from repro_torch.apps import device as app_device
    from repro_torch.core import JobOrchestrator, OrchestratorConfig, WorkloadConfig
    from repro_torch.launch import apps as apps_mod

    t_phase = time.perf_counter()
    # the engine's price does not depend on the device
    for app, size in APPS_SMALL.items():
        for ideal in ((False, True) if app == "rsvd" else (False,)):
            card, cpu = (apps_mod.run_app(app, size, d, ideal_storage=ideal)
                         for d in ("cuda", "cpu"))
            assert card["check"]["ok"] and cpu["check"]["ok"], (card, cpu)
            assert (card["charged_ms"], card["kv_stats"]) == (cpu["charged_ms"], cpu["kv_stats"])
            emit({"phase": "apps_price_card_vs_cpu", "app": app, "ideal_storage": ideal,
                  "size": list(size), "charged_ms": card["charged_ms"],
                  "kv_stats": card["kv_stats"], "equal": True})

    runs = {}
    for app in apps_mod.APPS:
        for ideal in ((False, True) if app == "rsvd" else (False,)):
            reset(ops)
            torch.cuda.reset_peak_memory_stats()
            rec = apps_mod.run_app(app, apps_mod.SIZES[app], "cuda", ideal_storage=ideal)
            assert counts(ops) == dict.fromkeys(counts(ops), 0), counts(ops)  # library calls
            rec["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["cold_s"] = rec.pop("host_s")
            gc.collect()  # drop the first run's graph; its blocks stay cached
            rec.update(profile_app(apps_mod, app, ideal))
            free_memory()
            emit({"phase": "apps", "card": smi, **rec})
            print(f"apps {app}{' ideal' if ideal else ''}: host {rec['host_s']:.3f} s (first "
                  f"run {rec['cold_s']:.3f}), device {rec['device_ms']:.1f} ms, busy "
                  f"{rec['device_busy_share']:.1%}, engine {rec['engine_share_of_traced_host']:.1%}"
                  f" of traced host, charged {rec['charged_ms']:.1f} ms, kv bytes "
                  f"{rec['bytes_written']} ({smi})", flush=True)
            assert rec["check"]["ok"], rec
            runs[(app, ideal)] = rec
    normal, ideal = runs[("rsvd", False)], runs[("rsvd", True)]
    assert ideal["bytes_written"] < normal["bytes_written"], (ideal, normal)
    s_n, s_i = (np.array(r["check"]["singular_values"]) for r in (normal, ideal))
    assert np.allclose(s_i, s_n, rtol=IDEAL_SV_RTOL, atol=0), (s_i, s_n)
    emit({"phase": "apps_ideal_storage", "kv_bytes_written": ideal["bytes_written"],
          "normal_kv_bytes_written": normal["bytes_written"],
          "sv_max_rel_diff": float(np.max(np.abs(s_i - s_n) / s_n)), "tol": IDEAL_SV_RTOL,
          "bitwise_equal": bool(np.array_equal(s_i, s_n)),
          "breakdown_normal": normal["breakdown"], "breakdown_ideal": ideal["breakdown"]})

    reports, host_s = {}, {}
    for d in ("cuda", "cpu"):
        with app_device.on_device(d):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orch = JobOrchestrator(OrchestratorConfig(workload=WorkloadConfig(n_jobs=20,
                                                                               seed=0)))
            reports[d] = dataclasses.asdict(orch.run())
            torch.cuda.synchronize()
            host_s[d] = time.perf_counter() - t0
            del orch
    rep = reports["cuda"]
    assert rep["completed"] == rep["jobs"] == 20 and rep["failed"] == 0, rep
    assert {r["app"] for r in rep["job_records"]} >= {"gemm", "svd", "svc"}, rep["job_records"]
    assert rep == reports["cpu"]  # per job: billed USD, latency, tasks; the whole report
    emit({"phase": "apps_orchestrator", "jobs": rep["jobs"],
          "apps": sorted({r["app"] for r in rep["job_records"]}),
          "host_s": host_s, "makespan_s": rep["makespan_s"], "p99_s": rep["p99_s"],
          "billed_usd_total": rep["billed_usd_total"], "equal_cpu": True,
          "phase_s": time.perf_counter() - t_phase})


def profile_app(apps_mod, app, ideal) -> dict:
    """Two more runs of ``app`` at full size: host seconds of the first, and
    a ``torch.profiler`` trace of the second for its device ms (kernel
    times), busy share against those host seconds, kernel launches, top
    kernels, the torch calls that take the most host time, and the engine's
    share of the traced host time: the time outside the outermost torch
    calls (whose CPU time holds their launches, allocations and waits)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EngineConfig, WukongEngine

    def run() -> None:
        dag = apps_mod.build(app, apps_mod.SIZES[app], "cuda", ideal_storage=ideal)
        WukongEngine(EngineConfig()).compute(dag)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_s = time.perf_counter() - t0
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_rows(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    calls: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and outermost_torch_call(e):
            c = calls.setdefault(e.name, [0.0, 0])
            c[0] += e.cpu_time_total / 1e3
            c[1] += 1
    torch_ms = sum(ms for ms, _ in calls.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"host_s": host_s, "device_ms": device_ms,
            "device_busy_share": device_ms / (host_s * 1e3),
            "traced_host_ms": traced_ms, "torch_calls_ms": torch_ms,
            "engine_share_of_traced_host": 1 - torch_ms / traced_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                             "launches": e.count} for e in top],
            "top_torch_calls": [{"name": n, "host_ms": ms, "calls": k}
                                for n, (ms, k) in sorted(calls.items(),
                                                         key=lambda c: -c[1][0])[:5]]}


def run_train(M, ops, cfg, dev, batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
              faults=TRAIN_FAULTS) -> dict:
    """Phases 9, 14 and 18: ``steps`` full-width steps on one fixed batch
    (the encoder-decoder's with its frames) as tasks of the copied engine,
    with injected failures unless ``faults`` is None; the loss must be
    finite and fall, and each step run must launch each layer's kernels as
    ``train_launches`` says (under ``remat`` the forward twice) and AdamW's
    a sum of squares and an update a leaf and one finalize."""
    from repro_torch.core import EngineConfig, FaultConfig
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.orchestrator import build_training_workflow, run_training_workflow
    from repro_torch.runtime.train import build_train_step, synthetic_batch
    from repro_torch.tree import leaves

    params = M.init_model(cfg, seed=0, device=dev)
    data = synthetic_batch(cfg, batch, seq, seed=7, device=dev)
    step = build_train_step(cfg, AdamWConfig(lr=5e-3, weight_decay=0.0, warmup=1))
    step_s: list[float] = []

    def step_fn(state, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(*state, data)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return (p, o), {"loss": loss}

    dag, final_key, mk = build_training_workflow(
        n_steps=steps, step_fn=step_fn, init_fn=lambda: (params, adamw_init(params)))
    reset(ops)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_training_workflow(dag, final_key, mk, EngineConfig(
        faults=FaultConfig(**(faults or {})), job_timeout_s=3600.0))
    seconds = time.perf_counter() - t0
    launches = counts(ops)
    adamw_launches = ops.adamw_update.launches
    moe_launches = moe_counts(ops)
    losses = [res.report.results[k]["loss"] for k in mk]
    _, final_opt = res.report.results[final_key]
    runs = len(step_s)
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    assert int(final_opt["count"]) == steps
    assert (res.report.fault_stats["injected_failures"] > 0) == (faults is not None), \
        res.report.fault_stats
    assert runs >= steps
    assert launches == train_launches(cfg, runs), (launches, runs)
    # AdamW's kernels: a sum of squares and an update a leaf, one finalize a step run
    assert adamw_launches == runs * (2 * len(leaves(params)) + 1), (adamw_launches, runs)
    assert moe_launches == moe_train_launches(cfg, runs), (moe_launches, runs)
    per_step = statistics.median(step_s[1:])
    return {"arch": cfg.name, "shape": [batch, seq], "dtype": "bf16", "remat": cfg.remat,
            "steps": steps,
            "step_runs": runs, "losses": losses, "fault_stats": res.report.fault_stats,
            "injected_failures": res.report.fault_stats["injected_failures"],
            "launches": launches, "adamw_launches": adamw_launches,
            "moe_launches": moe_launches, "launches_per_step_run": {k: v / runs for k, v in launches.items()},
            "workflow_seconds": seconds, "step_run_seconds": step_s,
            "host_s_per_step": per_step, "tokens_per_s": batch * seq / per_step,
            "charged_ms": res.report.charged_ms,
            "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 2**30}


def train_reference(M, ops, small, dev, steps=3) -> dict:
    """Phase 10: the same ``steps`` train steps of a reduced f32 model on the
    card and on the CPU from the same weights and batches; raises unless
    each loss agrees within 1e-4 and the parameters within 2e-3."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train import build_train_step, synthetic_batch
    from repro_torch.tree import leaves

    step = build_train_step(small, AdamWConfig(lr=1e-3, warmup=2))
    p_cpu = M.init_model(small, seed=2, device="cpu")
    states = {"cpu": (p_cpu, adamw_init(p_cpu))}
    p_gpu = _to(p_cpu, dev)
    states["cuda"] = (p_gpu, adamw_init(p_gpu))
    reset(ops)
    loss_err = []
    for i in range(steps):
        batch = synthetic_batch(small, 2, 100, seed=10 + i, device="cpu")
        pc, oc, mc = step(*states["cpu"], batch)
        pg, og, mg = step(*states["cuda"], _to(batch, dev))
        loss_err.append(abs(mc["loss"].item() - mg["loss"].item()))
        states = {"cpu": (pc, oc), "cuda": (pg, og)}
    launches = counts(ops)
    param_err = max((a.cpu() - b).abs().max().item()
                    for a, b in zip(leaves(states["cuda"][0]), leaves(states["cpu"][0])))
    assert max(loss_err) < 1e-4, loss_err
    assert param_err < 2e-3, param_err
    assert launches == train_launches(small, steps), launches
    return {"steps": steps, "loss_abs_err": loss_err, "param_max_abs_err": param_err,
            "tol": {"loss": 1e-4, "params": 2e-3}, "launches": launches}


def profile_train(M, cfg, dev, batch=TRAIN_B, seq=TRAIN_S, warm=2, steps=3) -> dict:
    """Phases 11, 14, 18 and 20: host ms of a full-width training step
    without the profiler, then a ``torch.profiler`` trace of one step for
    device time, kernel launches, the top kernels and the kernels' shares;
    for xLSTM also the sLSTM loop's share of the step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train import build_train_step, synthetic_batch
    from repro_torch.tree import leaves, map_tree

    params = M.init_model(cfg, seed=0, device=dev)
    state = (params, adamw_init(params))
    state_gb = sum(t.numel() * t.element_size() for t in leaves(state)) / 1e9
    data = synthetic_batch(cfg, batch, seq, seed=7, device=dev)
    step = build_train_step(cfg, AdamWConfig(lr=5e-3, weight_decay=0.0, warmup=1))

    def run(n):
        nonlocal state
        for _ in range(n):
            p, o, _ = step(*state, data)
            state = (p, o)
        torch.cuda.synchronize()

    run(warm)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    slstm = slstm_share(cfg, ssm, state[0], run, step_ms, batch, seq, dev)

    def peak_gib(fn) -> float:
        """Peak device memory of ``fn()`` above what is allocated before it
        (the params, AdamW state and batch)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        return peak / 2**30

    def loss_and_grads(c):
        p = map_tree(lambda t: t.detach().requires_grad_(), state[0])
        loss = M.loss_fn(p, c, data["tokens"], data["labels"], data.get("enc_embeds"))
        return torch.autograd.grad(loss, leaves(p))

    peak = {}
    for name, remat in (("remat", True), ("no_remat", False)):
        c = dataclasses.replace(cfg, remat=remat)
        st = build_train_step(c, AdamWConfig(lr=5e-3, weight_decay=0.0, warmup=1))
        peak[name] = {"step": peak_gib(lambda: st(*state, data)),
                      "loss_and_grads": peak_gib(lambda: loss_and_grads(c))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the card's activity only
        t0 = time.perf_counter()
        run(1)
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_rows(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def share(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key)) / 1e3 / device_ms

    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"arch": cfg.name, "shape": [batch, seq], "dtype": "bf16", "remat": cfg.remat,
            "step_ms": step_ms, **slstm, "state_gb": state_gb, "peak_gib_above_state": peak,
            "traced_step_ms": traced_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / step_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels),
            "flash_fwd_share": share(lambda k: "flash" in k and "bwd" not in k),
            "flash_bwd_share": share(lambda k: "flash_bwd" in k),
            "mlstm_fwd_share": share(lambda k: "mlstm" in k and "bwd" not in k),
            "mlstm_bwd_share": share(lambda k: "mlstm_bwd" in k),
            "top_kernels": [{"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3,
                             "launches_per_step": e.count} for e in top]}


def slstm_share(cfg, ssm, params, run, step_ms, batch, seq, dev) -> dict:
    """For a config with sLSTM blocks: the host seconds of a step's sLSTM
    forward calls (the forward and, under ``remat``, its recomputation; each
    call synchronised around), and of one sLSTM layer's backward at the
    step's shape (input in the model's dtype, the first layer's weights)
    times the layers;
    their sum over ``step_ms`` is the loop's share of the step."""
    from repro_torch.models.layers import dtype_of

    n_slstm = sum(cfg.mixer_of(e) == "slstm" for e in cfg.block_pattern) * cfg.n_repeats
    if n_slstm == 0:
        return {}
    fwd_s, slstm = 0.0, ssm.slstm

    def timed(*args, **kw):
        nonlocal fwd_s
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = slstm(*args, **kw)
        torch.cuda.synchronize()
        fwd_s += time.perf_counter() - t
        return out

    ssm.slstm = timed
    try:
        run(1)
    finally:
        ssm.slstm = slstm
    pos = cfg.block_pattern.index("slstm")
    layer = {k: t[0].detach().requires_grad_() for k, t in params["blocks"][pos]["mixer"].items()}
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((batch, seq, cfg.d_model), generator=g, device=dev).to(dtype_of(cfg))
    y, _ = slstm(layer, x.requires_grad_(), cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    bwd_s = (time.perf_counter() - t) * n_slstm
    return {"slstm_layers": n_slstm, "slstm_forward_s_in_step": fwd_s,
            "slstm_backward_s_estimate": bwd_s,
            "slstm_share": (fwd_s + bwd_s) / (step_ms / 1e3)}


def timed_forward(M, ops, cfg, params, tokens, enc_embeds=None) -> tuple[float, dict]:
    """Host seconds of one forward ending in a synchronise, and the kernel
    launches it made; the logits must be finite and of the right shape."""
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = M.forward(params, cfg, tokens, enc_embeds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(ops)
    assert logits.shape == (*tokens.shape, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all())
    return seconds, launches


def decode_vs_forward(M, ops, cfg, tokens, dev, seed=0, positions=64, params=None,
                      truth=True, enc_embeds=None) -> tuple[float, dict, dict]:
    """Relative max error of step-by-step decode logits against one forward
    over the first ``positions`` tokens, and the launches of both, with
    ``params`` or weights made from ``seed`` (and for the encoder-decoder
    the frames ``enc_embeds``). In bf16 with ``truth``, also what rounding
    alone costs each path: its error against an f32 forward of the same
    (bf16) weights, run after the launches are read."""
    p = M.init_model(cfg, seed=seed, device=dev) if params is None else params
    toks = tokens[:, :positions]
    dec, full, launches = decode_and_forward(M, ops, cfg, p, toks, enc_embeds)
    rounding = {}
    if truth and cfg.dtype == "bfloat16":
        f32 = M.forward(_to(p, torch.float32), dataclasses.replace(cfg, dtype="float32"), toks,
                        enc_embeds)
        rounding = {"forward_vs_f32": rel_err(full, f32), "decode_vs_f32": rel_err(dec, f32)}
    return rel_err(dec, full), launches, rounding


def decode_and_forward(M, ops, cfg, params, toks, enc_embeds=None) -> tuple:
    """Step-by-step decode logits and one forward's over ``toks`` (B, S),
    each (B, S, vocab), and the kernel launches of both; the
    encoder-decoder's decode first fills its cross cache from
    ``enc_embeds``."""
    reset(ops)
    full = M.forward(params, cfg, toks, enc_embeds)
    cache = M.init_cache(cfg, toks.shape[0], toks.shape[1], device=toks.device)
    if cfg.enc_dec:
        M.prefill_cross(params, cfg, cache, enc_embeds)
    steps = []
    for t in range(toks.shape[1]):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t], t)
        steps.append(lg)
    return torch.stack(steps, dim=1), full, counts(ops)


def serve_full_width(serve_mod, ops, arch, vocab):
    """``repro_torch.launch.serve`` at full width: 4 requests x batch 4,
    prompt 32, gen 32; returns the job report and the launches."""
    reset(ops)
    rep = serve_mod.main(["--arch", arch, "--full-width", "--requests", "4", "--batch", "4",
                          "--prompt-len", "32", "--gen-len", "32", "--device", "cuda",
                          "--seed", "0"])
    launches = counts(ops)
    summary = rep.results["summary"]
    assert len(summary["tokens"]) == 4
    for toks in summary["tokens"]:
        assert toks.shape == (4, 32) and toks.min() >= 0 and toks.max() < vocab
    return rep, launches


def serve_record(rep, launches) -> dict:
    summary = rep.results["summary"]
    return {"requests": 4, "batch": 4, "prompt_len": 32, "gen_len": 32,
            "mean_tokens_per_s": summary["mean_tps"],
            "p99_latency_s": summary["p99_latency_s"], "charged_ms": rep.charged_ms,
            "launches": launches}


def serve_reference(serve_mod, M, small, dev) -> bool:
    """Greedy tokens of a reduced f32 model served on the card and on the
    CPU from the same weights; raises unless they are equal."""
    p_cpu = M.init_model(small, seed=1, device="cpu")
    p_gpu = _to(p_cpu, dev)
    kw = dict(requests=2, batch=3, prompt_len=8, gen_len=12, seed=1)
    on_gpu = serve_mod.serve(small, p_gpu, device=dev, **kw).results["summary"]["tokens"]
    on_cpu = serve_mod.serve(small, p_cpu, device="cpu", **kw).results["summary"]["tokens"]
    same = all(np.array_equal(a, b) for a, b in zip(on_gpu, on_cpu, strict=True))
    assert same, (on_gpu, on_cpu)
    return same


def profile_decode(cfg, M, dev, batch=4, warm=8, steps=16) -> dict:
    """Where a full-width serving step's time goes: host ms per step
    without the profiler, then a ``torch.profiler`` trace of the same
    number of steps (``profiled``) for device time, kernel launches and the
    top kernels, per step."""
    params = M.init_model(cfg, seed=0, device=dev)
    cache = M.init_cache(cfg, batch, warm + 3 * steps, device=dev)
    if cfg.enc_dec:
        M.prefill_cross(params, cfg, cache, whisper_frames(cfg, batch, 2, dev))
    tok = torch.arange(batch, device=dev)          # each row a sequence of its own
    pos = 0

    def run(n):
        nonlocal tok, pos
        for _ in range(n):
            logits, _ = M.decode_step(params, cfg, cache, tok, pos)
            tok = logits.argmax(dim=-1)
            pos += 1
        torch.cuda.synchronize()

    run(warm)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, traced_ms = profiled(lambda: run(steps))
    per_step = kernel_summary(kernels, steps)
    return {"batch": batch, "cache_len": warm + 3 * steps, "step_ms": step_ms,
            "traced_step_ms": traced_ms / steps, "device_ms_per_step": per_step["device_ms"],
            "device_busy_share": per_step["device_ms"] / step_ms,
            "kernel_launches_per_step": per_step["launches"],
            "top_kernels_per_step": per_step["top_kernels"]}


def _headline(case: dict) -> dict:
    """The main path's shape: the first (bf16) case of each kernel."""
    return {k: case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}


# Phase 19: the dry run's records go here (the repository's build/, git-ignored)
DRYRUN_DIR = ROOT / "build" / "dryrun"
# The dry run on the card's machine: probe traces in parallel, one process each
DRYRUN_JOBS = 8
# the cells phase 19 runs on the card: what the dry run says fits one H100 at
# its full shape (smollm's train cell at the least power of two of
# microbatches that fits, the reference's own Variant(n_microbatches=N))
DRYRUN_CARD_CELLS = (("xlstm_350m", "decode_32k"), ("xlstm_350m", "long_500k"),
                     ("smollm_360m", "train_4k"))
# the production meshes, whose records hold one device's trace and collectives
DRYRUN_MESHES = ("16x16", "2x16x16")
DRYRUN_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                      "collective-permute")
# phase 19 (d): the card cell run as DTensors over the card's own 1x1 mesh, at twice
# the microbatches of (c) (the same step; half the activations, room for both runs)
SHARDED_CARD_MICROBATCHES = 32
# the fake-CUDA trace's bytes and peak against the meta trace's (relative)
META_GAP = 0.01
# the CUDA caching allocator rounds each tensor up to 512 bytes, and hands a
# large tensor a cached block whole when splitting it would leave 1 MB or less
ALLOC_UNSPLIT = 1 << 20
# The measured peak (max_memory_allocated over the step) against the traced
# one: measured / traced must lie in this band. First reading (H100, 700 W):
# 1.0 exactly for both xLSTM decode cells, 1.000001 for smollm's train cell at
# 16 microbatches (77 KB over 75.6 GB). The trace counts the same allocations
# rounded as the allocator rounds them, so it can over-count only by a tensor
# that a real run frees sooner (none seen); it leaves out the kernels' scratch
# (flash backward's row sums, B·H·Sq fp32, 3.9 MB per call there; decode's
# partials; the mLSTM workspaces) and the cached blocks the allocator hands
# out whole (up to 1 MB over a large tensor's request), which a peak can hold:
# 1 % above covers that at these cells.
PEAK_BAND = (0.999, 1.01)
PEAK_BAND_WHY = ("the trace counts the step's own allocations, 512-byte rounded (first "
                 "reading 1.0, 1.0, 1.000001); above it only the kernels' scratch it omits")


def _op_inputs(kind: str, shape: dict, dev) -> list:
    """Random inputs on the card of one phase-3 case, as its kernel op takes
    them (``torch.ops.repro_torch``); a backward's from its forward op."""
    K = torch.ops.repro_torch
    g = torch.Generator(device=dev).manual_seed(19)

    def randn(*size, dtype=torch.float32):
        return torch.randn(size, generator=g, device=dev).to(dtype)

    if kind.startswith("flash"):
        d, B, S, Skv, H, Kh, hd = (shape[k] for k in ("dtype", "B", "S", "Skv", "H", "K", "hd"))
        q, k, v = randn(B, S, H, hd, dtype=d), randn(B, Skv, Kh, hd, dtype=d), randn(
            B, Skv, Kh, hd, dtype=d)
        mask = (shape["causal"], shape["window"])
        if kind == "flash_attention_fwd":
            return [q, k, v, *mask, True]
        out, (lse,) = K.flash_attention_fwd(q, k, v, *mask, True)
        return [q, k, v, out, randn(B, S, H, hd, dtype=d), lse, *mask]
    if kind == "decode_attention":
        d, B, S, H, Kh, hd = (shape[k] for k in ("dtype", "B", "S", "H", "K", "hd"))
        return [randn(B, H, hd, dtype=d), randn(B, S, Kh, hd, dtype=d),
                randn(B, S, Kh, hd, dtype=d),
                torch.tensor(shape["lens"], dtype=torch.int32, device=dev), True]
    B, S, H, hd, chunk = (shape[k] for k in ("B", "S", "H", "hd", "chunk"))
    q, k, v = (randn(B, S, H, hd) for _ in range(3))
    log_f, i_gate = F.logsigmoid(randn(B, S, H) + 2.0), torch.sigmoid(randn(B, S, H))
    state = [randn(B, H, hd, hd) * 0.1, randn(B, H, hd)] if shape["with_state"] else [None, None]
    if kind == "mlstm_chunk_fwd":
        return [q, k, v, log_f, i_gate, *state, chunk, True]
    y, _, _, saved = K.mlstm_chunk_fwd(q, k, v, log_f, i_gate, *state, chunk, True)
    final = ([randn(B, H, hd, hd), randn(B, H, hd)] if shape["final_grads"] else [None, None])
    return [q, k, v, log_f, i_gate, y, randn(B, S, H, hd), *saved, *final, chunk,
            shape["with_state"]]


def fake_kernel_checks(dev) -> list:
    """Phase 19 (b): each phase-3 case through its kernel op on the card and
    on fake CUDA tensors of the same inputs (``FakeTensorMode``): the fake
    outputs' shapes, dtypes and strides must equal the kernel's, and the
    op's FLOP formula (``FlopCounterMode`` over the real call) must equal
    the operations the case's bound counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    def layout(out):
        return [(tuple(t.shape), str(t.dtype), tuple(t.stride()))
                for t in torch.utils._pytree.tree_leaves(out)]

    checked = []
    for kind, shape, bound_flops in KERNEL_CASES:
        op = getattr(torch.ops.repro_torch, kind)
        args = _op_inputs(kind, shape, dev)
        with FlopCounterMode(display=False) as fc:
            real = op(*args)
        mode = FakeTensorMode()
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with mode:
            fake = op(*fake_args)
        assert layout(fake) == layout(real), (kind, shape, layout(fake), layout(real))
        assert fc.get_total_flops() == bound_flops, (kind, shape, fc.get_total_flops(),
                                                     bound_flops)
        checked.append({"op": kind, "shape": {k: str(v) for k, v in shape.items()},
                        "outputs": layout(real), "flops": fc.get_total_flops()})
        del args, real, fake, fake_args
    return checked


def _gb(n: float) -> float:
    return n / 1e9


def dryrun_start() -> subprocess.Popen:
    """Phase 19 (a): ``python -m repro_torch.launch.dryrun --all
    --both-meshes`` as a process of its own (its fake process group of 512
    ranks is global), started to run while the rest of the phase traces."""
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                             "--both-meshes", "--jobs", str(DRYRUN_JOBS), "--out",
                             str(DRYRUN_DIR)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def dryrun_records(proc: subprocess.Popen, t0: float) -> tuple[dict, dict]:
    """(a)'s end: every one of the 34 cells must be ok. Prints a line per cell;
    returns the records by (arch, shape, mesh) and the phase's summary."""
    out, err = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, out[-4000:] + err[-4000:]
    assert "34 ok, 0 failed" in out, out[-2000:]
    recs = {}
    for path in DRYRUN_DIR.glob("*__baseline.json"):
        r = json.loads(path.read_text())
        recs[r["arch"], r["shape"], r["mesh"]] = r
    cells = sorted({(a, sh) for a, sh, _ in recs})
    assert len(cells) == 34 and all(r["ok"] for r in recs.values())
    for arch, shape in cells:
        host = recs[arch, shape, "1x1"]
        by_mesh = " ".join(f"{m} {_gb(recs[arch, shape, m]['argument_bytes']['total']):.3f}"
                           for m in ("1x1", "16x16", "2x16x16"))
        print(f"dryrun {arch} {shape}: args/device GB {by_mesh} | traced peak "
              f"{_gb(host['peak_bytes']):.3f} GB fits_one_h100={host['fits_one_h100']} "
              f"flops {host['flops']:.4e}", flush=True)
    per_device = {}
    for mesh in DRYRUN_MESHES:
        for arch, shape in cells:
            r = recs[arch, shape, mesh]
            coll = r["collective_bytes"]
            assert set(coll) == {*DRYRUN_COLLECTIVES, *(f"{k}_count" for k in DRYRUN_COLLECTIVES),
                                 "total"}, (arch, shape, mesh, coll)
            print(f"dryrun {arch} {shape} {mesh}/device: peak {_gb(r['peak_bytes']):.3f} GB "
                  f"fits={r['fits_per_device']} flops {r['flops']:.4e} collectives "
                  f"{_gb(coll['total']):.3f} GB in "
                  f"{sum(coll[f'{k}_count'] for k in DRYRUN_COLLECTIVES)}", flush=True)
        per_device[mesh] = sorted(f"{a} {sh}" for a, sh in cells
                                  if recs[a, sh, mesh]["fits_per_device"])
    fits = [f"{a} {sh}" for a, sh in cells if recs[a, sh, "1x1"]["fits_one_h100"]]
    return recs, {"seconds": seconds, "cells": len(cells), "fit_one_h100": fits,
                  "fit_one_device_of": per_device}


def trace_on_card_route(D, get_config, arch: str, shape: str, variant) -> dict:
    """The cell traced on fake CUDA tensors, the card's route."""
    t0 = time.perf_counter()
    traced = D.trace_cell(get_config(arch), shape, variant, device="cuda")
    traced["seconds"] = time.perf_counter() - t0
    return traced


def run_dryrun_cell(D, ops, get_config, arch: str, shape: str, variant, traced: dict,
                    meta: dict, dev) -> dict:
    """Phase 19 (c): one cell that fits one H100, its trace on fake CUDA
    tensors (``traced``) held to the meta trace (``meta``: FLOPs and kernel
    calls equal, bytes and peak within META_GAP), then run once on the card:
    the allocated arguments must be the dry run's argument bytes up to the
    allocator's 512 bytes per tensor, FlopCounterMode's count the trace's
    exactly, the kernel launches its kernel calls, and the measured peak
    within PEAK_BAND of the traced one. Also places the arguments on the
    card's own 1x1 mesh."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.tree import leaves

    for key in ("flops", "kernel_calls"):
        assert traced[key] == meta[key], (arch, shape, key, traced[key], meta[key])
    # meta tensors allocate as the CPU does where an op allocates by device (log_sigmoid's
    # buffer, empty on CUDA): bytes and peak may differ a little from the card's route
    meta_gap = {key: traced[key] / meta[key] - 1 for key in ("bytes_accessed", "peak_bytes")}
    assert all(abs(g) <= META_GAP for g in meta_gap.values()), (arch, shape, meta_gap)
    cell = D.build_cell(get_config(arch), shape, variant)
    mesh = mesh_lib.make_host_mesh("cuda")
    try:
        arg_bytes = D.argument_bytes(cell, mesh)
    finally:
        dist.destroy_process_group()
    free_memory()
    base = torch.cuda.memory_allocated()
    base_requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    args = D.materialize(cell, dev)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - base_requested
    n_tensors = sum(isinstance(t, torch.Tensor) for t in leaves(args))
    # what the tensors asked for is the argument bytes exactly; what the allocator holds for
    # them adds its rounding: 512 B a tensor, and a cached block it does not split (a
    # large one may exceed the request by up to 1 MB)
    assert requested == arg_bytes["total"], (arch, shape, requested, arg_bytes)
    assert 0 <= allocated - requested <= n_tensors * ALLOC_UNSPLIT, (
        arch, shape, allocated, requested)
    torch.cuda.reset_peak_memory_stats()
    reset(ops)
    step = cell.step()
    t0 = time.perf_counter()
    with D.flop_counter() as fc:
        out = step(args)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {**counts(ops), "adamw": ops.adamw_update.launches}
    del out, args
    free_memory()
    flops = fc.get_total_flops()
    ratio = peak / traced["peak_bytes"]
    rec = {"arch": arch, "shape": shape, "variant": variant.tag,
           "trace_s": traced["seconds"], "fake_cuda_over_meta_minus_1": meta_gap,
           "argument_bytes": arg_bytes, "requested_bytes": requested,
           "allocated_bytes": allocated, "tensors": n_tensors,
           "flops": flops, "traced_flops": traced["flops"],
           "traced_peak_bytes": traced["peak_bytes"], "traced_peak_by_phase":
           traced["peak_by_phase"], "meta_peak_bytes": meta["peak_bytes"], "peak_bytes": peak,
           "peak_over_traced": ratio, "peak_band": PEAK_BAND, "peak_band_why": PEAK_BAND_WHY,
           "traced_kernel_calls": traced["kernel_calls"], "launches": launches,
           "step_s": step_s}
    emit({"phase": "dryrun_card_cell", **rec})
    assert flops == traced["flops"], (arch, shape, flops, traced["flops"])
    calls = dict(traced["kernel_calls"])
    # AdamW's ops share one counter: its sum of squares and update a leaf, its finalize
    adamw = sum(calls.pop(k, 0) for k in ("adamw_sumsq", "adamw_finalize", "adamw_update"))
    assert launches["adamw"] == adamw, (arch, shape, launches, traced["kernel_calls"])
    for name, n in calls.items():
        key = {"flash_attention_fwd": "flash_attention", "mlstm_chunk_fwd": "mlstm_chunk"}.get(
            name, name)
        assert launches[key] == n, (arch, shape, name, launches, traced["kernel_calls"])
    assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], (arch, shape, peak, traced["peak_bytes"])
    return rec


def run_sharded_card_cell(D, ops, get_config, dev, smi) -> dict:
    """Phase 19 (d): smollm's train cell (DRYRUN_CARD_CELLS[2], at
    SHARDED_CARD_MICROBATCHES) stepped twice on the same arguments: as plain
    tensors, then as DTensors placed by the dry run's rules on the card's
    world-of-one NCCL 1x1 mesh (``launch.mesh.make_host_mesh``), the kernels
    reached through their sharded entries (``runtime.sharding.run_local``).
    Every output (new parameters, AdamW state, metrics) must equal the plain
    step's to the bit: the same kernels in the same order, and no collective
    on a mesh of one device. Launch counts are set to 0 before each run."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.tree import leaves

    arch, shape = DRYRUN_CARD_CELLS[2]
    n = SHARDED_CARD_MICROBATCHES
    cell = D.build_cell(get_config(arch), shape,
                        D.Variant(n_microbatches=n, tag=f"n_microbatches={n}"))
    free_memory()
    args = D.materialize(cell, dev)
    reset(ops)
    t0 = time.perf_counter()
    out = cell.step()(args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = {**counts(ops), "adamw": ops.adamw_update.launches}
    want = [t.cpu() for t in leaves(out)]
    del out
    free_memory()
    mesh = mesh_lib.make_host_mesh("cuda")
    try:
        sargs = D.shard_args(cell, mesh, args)
        reset(ops)
        t0 = time.perf_counter()
        with implicit_replication(), D.CollectiveCounter() as cc:
            out = cell.step(D.placements(cell, mesh))(sargs)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        launches = {**counts(ops), "adamw": ops.adamw_update.launches}
        got = [t.to_local() if hasattr(t, "to_local") else t for t in leaves(out)]
        equal = [torch.equal(a, b.cpu()) for a, b in zip(want, got, strict=True)]
        del out, sargs, got
    finally:
        dist.destroy_process_group()
    del args
    free_memory()
    rec = {"phase": "dryrun_sharded_card_cell", "arch": arch, "shape": shape,
           "n_microbatches": n, "mesh": "1x1 (NCCL, world of one)", "leaves": len(want),
           "bitwise_equal_leaves": sum(equal), "plain_launches": plain_launches,
           "launches": launches, "collectives": cc.tally.record(), "plain_step_s": plain_s,
           "sharded_step_s": sharded_s, "card": smi}
    emit(rec)
    assert all(equal), [i for i, e in enumerate(equal) if not e]
    assert launches == plain_launches and launches["flash_attention"] > 0, (launches,
                                                                            plain_launches)
    assert cc.tally.record()["total"] == 0, cc.tally.record()
    return launches


def run_dryrun(ops, get_config, dev, smi) -> dict:
    """Phase 19: the dry run (a) over every cell in a process of its own;
    meanwhile (b) each fake kernel held to its kernel, and the cells that fit
    one H100 traced on the card's route (smollm's train cell at the least
    power of two of microbatches that its meta trace fits); then (c) those
    cells run on the card."""
    from repro_torch.launch import dryrun as D

    t_phase = time.perf_counter()
    proc = dryrun_start()
    t0 = time.perf_counter()
    fakes = fake_kernel_checks(dev)
    emit({"phase": "dryrun_fake_kernels", "cases": len(fakes), "seconds":
          time.perf_counter() - t0, "checked": fakes})
    free_memory()
    arch, shape = DRYRUN_CARD_CELLS[2]
    t0 = time.perf_counter()
    n, smollm_meta = D.least_microbatches(get_config(arch), shape)
    search_s = time.perf_counter() - t0
    variants = [D.Variant()] * 2 + [D.Variant(n_microbatches=n, tag=f"n_microbatches={n}")]
    traced = [trace_on_card_route(D, get_config, a, sh, v)
              for (a, sh), v in zip(DRYRUN_CARD_CELLS, variants)]
    recs, summary = dryrun_records(proc, t_phase)
    emit({"phase": "dryrun", **summary, "card": smi})
    fit = {(a, sh) for a, sh, m in recs if m == "1x1" and recs[a, sh, m]["fits_one_h100"]}
    assert fit == set(DRYRUN_CARD_CELLS[:2]), fit
    metas = [recs[a, sh, "1x1"] for a, sh in DRYRUN_CARD_CELLS[:2]] + [smollm_meta]
    cells = [run_dryrun_cell(D, ops, get_config, a, sh, v, t, m, dev)
             for (a, sh), v, t, m in zip(DRYRUN_CARD_CELLS, variants, traced, metas)]
    sharded = run_sharded_card_cell(D, ops, get_config, dev, smi)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "dryrun_summary", "card": smi, "phase_s": phase_s,
          "microbatch_search_s": search_s, "n_microbatches": n,
          "cells_on_card": [f"{c['arch']} {c['shape']} {c['variant']}" for c in cells]})
    return {"flash_attention": cells[2]["launches"]["flash_attention"],
            "flash_attention_bwd": cells[2]["launches"]["flash_attention_bwd"],
            "sharded_flash_attention": sharded["flash_attention"],
            "sharded_flash_attention_bwd": sharded["flash_attention_bwd"],
            "adamw": cells[2]["launches"]["adamw"], "sharded_adamw": sharded["adamw"]}


def free_memory() -> None:
    """Collect reference cycles that hold tensors, then give the cached
    blocks back, so that the next phase finds the card's memory free."""
    gc.collect()
    torch.cuda.empty_cache()


def _to(tree, to):
    """``tree`` with every tensor moved to a device or cast to a dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, to) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, to) for v in tree]
    return tree.to(to)


if __name__ == "__main__":
    sys.exit(main())
