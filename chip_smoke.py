#!/usr/bin/env python3
"""The port's kernel check on one CUDA card (``src/repro_torch``).

    python3 chip_smoke.py

Phases, one JSON line each, each with ``elapsed_s``, the seconds since the
script started; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   (``-Xptxas=-v``: registers and spills; for the mlstm kernels and its
   backward's also their registers and spills by kernel, the shared memory
   of the two forward kernels and of the backward's tiles kernel, and how
   many state-kernel clusters the card holds; for every flash kernel of the
   3xTF32 route (f32, bf16 at hd 16/32), the wgmma backward's and every
   hd-192 instantiation of the wgmma forward and decode their registers,
   spills and dynamic shared memory);
3. kernel checks (``kernel_check``, one line a case): each hand-written
   kernel against its plain version (``kernels/ref.py``) on the card, at the
   shapes the port's configurations give it, family by family (``FAMILIES``:
   decode, flash forward, mLSTM forward and backward, flash backward, AdamW,
   MoE), and timed with CUDA events (median of ``REPS``, L2 flushed before
   each run) beside the plain version,
   ``torch.nn.functional.scaled_dot_product_attention`` as a yardstick only
   (its ratio recorded), and the card's bound for the same work (the rows of
   the 3xTF32 route at its rate, a third of the TF32 rate, with the
   fp32-FMA bound beside it); the kernels' own device time from
   ``torch.profiler`` (``kernel_ms``: the call without its launch gaps).

Limits. Attention forward and decode: f32 2e-5, bf16 2e-2; the rows over
whisper's 1500 frames also within ``WHISPER_RMS_TOL`` of the reference's
rms; the rows' log-sum-exp the forward writes for the backward against
``ref.flash_attention_lse_ref`` (abs 1e-4); every decode case also with its
rows' log-sum-exp asked for (what the sequence-parallel decode merges by):
the same output, the lse against the plain version's (f32 2e-5, bf16
2e-2), -inf exactly where kv_len is 0. The flash backward (bf16 at hd
64/128/192 on ``csrc/flash_attention_bwd_wgmma.cu``, the rest on
``csrc/flash_attention_bwd.cu``), fed the log-sum-exp the forward kernel
wrote, per gradient, twice: elementwise against its fp32 formulas on the
same inputs with D from the same forward output (the kernel's arithmetic),
|err| <= tol·(|ref| + rms(ref)) with tol bf16 1e-2 (about one bf16 ulp) and
f32 1e-4; and against autograd of the plain version, max abs error <= tol x
max(1, max|ref|), tol f32 1e-4 and bf16 3e-2 (the plain version rounds its
bf16 products to bf16); and a second call gives the same bits. The
``mlstm_chunk`` forward: atol 5e-5, rtol 5e-4 (f32), final C and n too. Its
backward (``csrc/mlstm_chunk_bwd.cu``, 3xTF32 ``mma.sync``), fed the chunk
states and row normalisers the forward saved (which must leave the
forward's output as it was, to the bit): per gradient elementwise |err| <=
1e-4·(|ref| + rms(ref)) against its plain version ``ref.mlstm_chunk_bwd_ref``
in float64 and in fp32, two calls with the same bits. Each mLSTM record
carries a SHA-256 digest of the forward's outputs (and of the states it
saves for the backward): equal digests from two trees mean equal bits.
AdamW (``csrc/adamw.cu``) and the MoE dispatch and combine
(``csrc/moe_dispatch.cu``): as ``check_adamw`` and ``check_moe`` say.

Bounds count 4·hd FLOPs per visible (query, key) pair and head for
attention, 10·hd for its backward (the five products q·kᵀ, dO·vᵀ, pᵀ·dO,
dsᵀ·q, ds·k), q, o (dO, dq) over Sq·H and k, v (dk, dv) over Skv·K moved
once; the flash backward's library yardstick is the profiler's device time
of the backward of ``scaled_dot_product_attention(..., enable_gqa=True)``.
The mLSTM forward counts 4·hd per causal pair of a chunk and 4·hd² per
position; its backward 10·hd per causal pair (q·kᵀ, g·vᵀ, dS·k, dSᵀ·q,
Pᵀ·g), 8·hd² per position (g·C_jᵀ, v·dC'ᵀ, k·dC', the state gradient) and
2·hd² per (b, h, chunk) (Σ C_j ⊙ dC'), against the inputs read and the
gradients written once; no single PyTorch call computes it (``library_ms``
null). These are ``kernels/ops.py``'s FLOP formulas.

To time one family on two trees, import the tree's ``chip_smoke`` with its
``src`` first on ``sys.path`` and call ``<family>_checks(ops, ref,
Timer(dev), dev)``, a process a tree, in turns (README).

The line before the last is ``{"kernels": [...]}``, a summary a kernel; the
last is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
MLSTM_TOL = {"atol": 5e-5, "rtol": 5e-4}  # tests/test_kernels.py:85-86
# The mLSTM backward held elementwise, |err| <= tol·|ref| + tol·rms(ref) per
# gradient, against its plain version in float64 and in fp32: the f32 flash
# backward's rule. d log f sums terms that cancel; rms(ref) keeps the
# limit from shrinking to an entry that happens to be near 0.
MLSTM_BWD_TOL = 1e-4
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
REPS = 30

# the script's start; each record carries the seconds since, so that a run
# shows where its time goes
T_START = time.perf_counter()


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


def bound(nbytes: float, flops: float, dtype, rate: float | None = None) -> tuple[float, str]:
    """The least time for ``nbytes`` and ``flops`` at the memory rate and at
    ``rate`` (default: the peak of ``dtype``), and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (rate or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def free_memory() -> None:
    """Collect reference cycles that hold tensors, then give the cached
    blocks back, so that the next case finds the card's memory free."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The attention families: decode, flash forward, flash backward
# ---------------------------------------------------------------------------

# Attention widths (heads, kv heads, head dim) of the port's configurations;
# a check's default is smollm-360m's (15 over 5, hd 64).
QWEN2 = {"H": 64, "K": 8, "hd": 128}          # qwen2-72b
NEMOTRON = {"H": 96, "K": 8, "hd": 192}       # nemotron-4-340b: 18432 / 96
LLAMA3 = {"H": 128, "K": 8, "hd": 128}        # llama3-405b: G = 16
MIXTRAL = {"H": 32, "K": 8, "hd": 128}        # mixtral-8x7b
MIXTRAL_22B = {"H": 48, "K": 8, "hd": 128}    # mixtral-8x22b
MIXTRAL_WINDOW = 4096
JAMBA = {"H": 64, "K": 8, "hd": 128}          # jamba-1.5-large
WHISPER = {"H": 20, "K": 20, "hd": 64}        # whisper-large-v3
WHISPER_FRAMES = 1500
# mixtral's attention with its window cut to 48 over 96 positions: the decode
# cache's ring wraps (the f32 card test of decode against forward)
RING_WINDOW, RING_POSITIONS = 48, 96
# Training shapes: smollm-360m's, mixtral-8x7b's and whisper-large-v3's (B=4,
# the decoder's published 448 tokens)
SMOLLM_TRAIN_B, SMOLLM_TRAIN_S = 4, 512
MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_S = 4, 512
WHISPER_TRAIN_B, WHISPER_TRAIN_S = 4, 448
# The rows over whisper's 1500 frames hold the kernel's error to this share
# of the reference's rms as well (rms ~0.043 with randn inputs). bf16
# readings on an H100 (700 W) were 9.8e-4 to 1.95e-3, 0.023-0.045 of the
# rms (PERF.md); 0.1 is about twice the largest. TOL's 2e-2 is about half
# a typical output there; this holds the error to a tenth of one.
WHISPER_RMS_TOL = 0.1


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


def decode_checks(ops, ref, timer, dev) -> list:
    """Decode at smollm-360m's serving shape and over ragged requests of up
    to 2048 keys, over one 8192-key request; at nemotron-4-340b's width (hd
    192, G = 12); at mixtral-8x7b's and 8x22b's over the 4096 window, and at
    mixtral's and jamba-1.5-large's serving step (a cache of 32, kv_len 31)
    and f32 decode-vs-forward checks (mixtral's wrapped ring of 48, jamba's
    cache of 64); whisper-large-v3's cross decode over the 1500 frames (G =
    1, also within ``WHISPER_RMS_TOL``) and its self decode; llama3-405b's
    serving step (G = 16, a cache of 48, kv_len 47)."""
    bf16, f32 = torch.bfloat16, torch.float32
    args = []
    for dtype in (bf16, f32):
        args += [(dtype, 4, 64, [63] * 4, {}),
                 (dtype, 8, 2048, [2048, 2048, 1, 1000, 1517, 333, 64, 2047], {})]
    args.append((bf16, 1, 8192, [8191], {}))
    args += [(dtype, 4, 2048, [2048, 1, 1517, 700], NEMOTRON) for dtype in (bf16, f32)]
    args += [(bf16, 4, MIXTRAL_WINDOW, [4096, 1, 2000, 4096], width)
             for width in (MIXTRAL, MIXTRAL_22B)]
    args += [(bf16, 2, 32, [31, 31], MIXTRAL), (f32, 2, RING_WINDOW, [RING_WINDOW] * 2, MIXTRAL),
             (bf16, 2, 32, [31, 31], JAMBA), (f32, 2, 64, [64, 64], JAMBA)]
    frames = {"rms_tol": WHISPER_RMS_TOL, **WHISPER}
    args += [(dtype, 2, WHISPER_FRAMES, [WHISPER_FRAMES] * 2, frames) for dtype in (bf16, f32)]
    args += [(bf16, 2, 32, [31, 31], WHISPER), (f32, 2, 64, [64, 64], WHISPER),
             (bf16, 2, 48, [47, 47], LLAMA3)]
    return [check_decode(ops, ref, timer, dev, dtype, B, S, lens, **kw)
            for dtype, B, S, lens, kw in args]


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


def flash_checks(ops, ref, timer, dev) -> list:
    """The flash forward at smollm-360m's shapes (S 512, 1024, ragged 1000,
    window 256), bf16 and f32; at qwen2-72b's width; at nemotron-4-340b's
    (hd 192, bf16 and f32); at mixtral-8x7b's and 8x22b's (S=8192, the 4096
    window), mixtral's forward (B=2 S=512) and its f32 ring check (the window
    cut to 48 over 96 positions); jamba-1.5-large's forward (B=2 S=512) and
    f32 check (S=64); whisper-large-v3's encoder over its 1500 frames (not
    causal) and cross-attention from 512, 37 and 1 queries to them, bf16 and
    f32, these also within ``WHISPER_RMS_TOL``, and its decoder's causal
    self-attention (G = 1); llama3-405b's (G = 16, S=2048)."""
    bf16, f32 = torch.bfloat16, torch.float32
    args = []
    for dtype in (bf16, f32):
        args += [(dtype, 2, S, True, window, {})
                 for S, window in ((512, None), (1024, None), (1000, None), (1024, 256))]
    args.append((bf16, 1, 2048, True, None, QWEN2))
    args += [(dtype, 1, 2048, True, None, NEMOTRON) for dtype in (bf16, f32)]
    args += [(bf16, 1, 2 * MIXTRAL_WINDOW, True, MIXTRAL_WINDOW, width)
             for width in (MIXTRAL, MIXTRAL_22B)]
    args += [(bf16, 2, 512, True, MIXTRAL_WINDOW, MIXTRAL),
             (f32, 2, RING_POSITIONS, True, RING_WINDOW, MIXTRAL),
             (bf16, 2, 512, True, None, JAMBA), (f32, 2, 64, True, None, JAMBA)]
    frames = {"rms_tol": WHISPER_RMS_TOL, **WHISPER}
    for dtype in (bf16, f32):
        args.append((dtype, 2, WHISPER_FRAMES, False, None, frames))
        args += [(dtype, 2, Sq, False, None, {"Skv": WHISPER_FRAMES, **frames})
                 for Sq in (512, 37, 1)]
    args += [(bf16, 2, 512, True, None, WHISPER), (f32, 2, 64, True, None, WHISPER),
             (bf16, 1, 2048, True, None, LLAMA3)]
    return [check_flash(ops, ref, timer, dev, dtype, B, S, causal, window, **kw)
            for dtype, B, S, causal, window, kw in args]


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


def flash_bwd_checks(ops, ref, timer, dev) -> list:
    """The flash backward at smollm-360m's training shape (B=4 S=512) and at
    S 1000 and 1024 with a window of 256, bf16 and f32; at qwen2-72b's width;
    at nemotron-4-340b's (bf16 S=2048, f32 S=512); at mixtral-8x7b's (S=8192,
    the 4096 window); at whisper-large-v3's training shapes (B=4, 448 decoder
    tokens): the encoder over the 1500 frames (ragged: 23·64 + 28) and
    cross-attention from 448 queries to them, bf16 and f32, from 37 (ragged,
    under one tile) in bf16, and the decoder's causal self-attention (G = 1);
    at llama3-405b's width (G = 16) and mixtral-8x7b's training shape (B=4
    S=512, the 4096 window)."""
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, F_ = WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_FRAMES
    args = [(dtype, Bs, Ss, True, window, {}) for dtype in (bf16, f32)
            for Bs, Ss, window in ((SMOLLM_TRAIN_B, SMOLLM_TRAIN_S, None), (2, 1000, None),
                                   (2, 1024, 256))]
    args += [(bf16, 1, 2048, True, None, QWEN2), (bf16, 1, 2048, True, None, NEMOTRON),
             (f32, 1, 512, True, None, NEMOTRON),
             (bf16, 1, 2 * MIXTRAL_WINDOW, True, MIXTRAL_WINDOW, MIXTRAL)]
    for dtype in (bf16, f32):
        args += [(dtype, B, F_, False, None, WHISPER),
                 (dtype, B, S, False, None, {"Skv": F_, **WHISPER})]
    args += [(bf16, B, 37, False, None, {"Skv": F_, **WHISPER}),
             (bf16, B, S, True, None, WHISPER), (bf16, 1, 2048, True, None, LLAMA3),
             (bf16, MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_S, True, MIXTRAL_WINDOW, MIXTRAL)]
    return [check_flash_bwd(ops, ref, timer, dev, dtype, Bs, Ss, causal, window, **kw)
            for dtype, Bs, Ss, causal, window, kw in args]


# ---------------------------------------------------------------------------
# The mLSTM family: forward and backward
# ---------------------------------------------------------------------------

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
    # the fp32-FMA bound (the first forward's route) is kept beside it
    t_bound, by = bound(nbytes, flops, torch.float32, TF32X3_FLOPS)
    t_fma, fma_by = bound(nbytes, flops, torch.float32)
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


# xLSTM's training shape
XLSTM_TRAIN_B, XLSTM_TRAIN_S = 2, 512


def mlstm_checks(ops, ref, timer, dev) -> list:
    """The mLSTM forward at xlstm-350m's shape (B=2, S=512, H=4, hd =
    2·1024/4 = 512), ragged with a state, and at hd 64; then its backward at
    xLSTM's training shape with and without an initial state and
    final-state gradients, ragged, at hd 64 and at reduced xlstm's hd 32 at
    a ragged S."""
    B, S = XLSTM_TRAIN_B, XLSTM_TRAIN_S
    return [check_mlstm(ops, ref, timer, dev, 2, 512, 4, 512, False),
            check_mlstm(ops, ref, timer, dev, 2, 300, 4, 512, True),
            check_mlstm(ops, ref, timer, dev, 1, 256, 4, 64, False),
            check_mlstm_bwd(ops, ref, timer, dev, B, S, 4, 512, False, False),
            check_mlstm_bwd(ops, ref, timer, dev, B, S, 4, 512, True, True),
            check_mlstm_bwd(ops, ref, timer, dev, 2, 300, 4, 512, True, False),
            check_mlstm_bwd(ops, ref, timer, dev, 1, 256, 4, 64, False, True),
            check_mlstm_bwd(ops, ref, timer, dev, 2, 200, 4, 32, True, True)]


# ---------------------------------------------------------------------------
# The AdamW family
# ---------------------------------------------------------------------------

# mixtral-8x7b's leaves at the depth it trains on one card (1 of 32 layers, bf16),
# against the plain version within these units in the last place (the clip scale
# carries the norm's last bit, the second moment's square doubles it), the norm
# within 1e-6
ADAMW_LAYERS = 1
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
    """One AdamW row: ``ops.adamw_update`` (the kernels: a sum of squares a
    leaf, the finalize, an update a leaf) over bf16 parameters of ``shapes``
    with ``g_dtype`` gradients, timed as the attention rows are, beside its
    byte bound (``adamw_bytes``); two calls equal to the bit and 2 op calls a
    leaf and 1 a step. With ``plain``, also the plain version
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


def adamw_checks(ops, ref, timer, dev) -> list:
    """AdamW at mixtral-8x7b's leaves (``ADAMW_LAYERS``), bf16 parameters
    with bf16 and with fp32 gradients (b4s512's and accum8's): its expert
    stack (8 x 4096 x 14336) alone, against the plain version; and the whole
    tree of one layer (13 leaves, 1.713 B parameters), the kernels alone
    (the plain version's fp32 passes would not fit beside it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=ADAMW_LAYERS)
    shapes = [tuple(t.shape) for t in leaves(M.abstract_params(cfg))]
    expert = next(s for s in shapes if s[1:] == (cfg.moe.n_experts, cfg.d_model, cfg.d_ff))
    cases = []
    for g_dtype in (torch.bfloat16, torch.float32):
        cases.append(check_adamw(ops, ref, timer, dev, [expert], g_dtype,
                                 "mixtral-8x7b expert stack", True))
        cases.append(check_adamw(ops, ref, timer, dev, shapes, g_dtype,
                                 "mixtral-8x7b, 1 layer, every leaf", False))
    return cases


# ---------------------------------------------------------------------------
# The MoE family: the dispatch and the combine, and their backwards
# ---------------------------------------------------------------------------

# (case, groups G, group size g, experts E, top k, queue places cap, d_model,
# held (first, E_l)): mixtral-8x7b's training microbatch (B=4 S=512 in groups
# of 512, capacity 1.25) and DeepSeek-V3's decode step (256 one-token groups,
# top 8 of 256, the 8 experts 0-7 of the cell held).
MOE_SHAPES = (("mixtral-8x7b train B=4 S=512", 4, 512, 8, 2, 160, 4096, (0, 8)),
              ("deepseek-v3 decode B=256", 256, 1, 256, 8, 1, 7168, (0, 8)))
MOE_OPS = ("moe_dispatch", "moe_combine")


def moe_counts(ops) -> dict:
    """The MoE kernels' launches, each op's forward and backward."""
    return {f"{name}{suffix}": getattr(getattr(ops, name), attr) for name in MOE_OPS
            for suffix, attr in (("", "launches"), ("_bwd", "bwd_launches"))}


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
    """The four MoE rows at one shape: each kernel op (the dispatch, its
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
    """The MoE rows at ``MOE_SHAPES``: four a shape."""
    return [rec for case, *shape in MOE_SHAPES
            for rec in check_moe(ops, ref, timer, dev, case, *shape)]


# The kernel check's families, in the order of their records
FAMILIES = (decode_checks, flash_checks, mlstm_checks, flash_bwd_checks, adamw_checks,
            moe_checks)


# ---------------------------------------------------------------------------
# The build's report
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The summary a kernel
# ---------------------------------------------------------------------------

# (name, source under src/repro_torch/kernels/csrc, the TPU kernel it replaces,
# or None and why none, the family, and which of its rows are the kernel's)
KERNELS = (
    # bf16 at hd 64/128/192 (the main path); the f32 cases run flash_attention.cu
    ("flash_attention", "flash_attention_wgmma.cu", "src/repro/kernels/flash_attention.py:97",
     None, flash_checks, None),
    ("decode_attention", "decode_attention.cu", "src/repro/kernels/decode_attention.py:77",
     None, decode_checks, None),
    ("mlstm_chunk", "mlstm_chunk.cu", "src/repro/kernels/linear_attention.py:83", None,
     mlstm_checks, lambda r: "forward_sha256" not in r),
    ("mlstm_chunk_bwd", "mlstm_chunk_bwd.cu", None,
     "no TPU kernel: the JAX package has no Pallas backward for mlstm_chunk; its training "
     "differentiates the jnp recurrence (models/ssm.py) through XLA", mlstm_checks,
     lambda r: "forward_sha256" in r),
    # bf16 at hd 64/128/192 (the main path); f32 runs flash_attention_bwd.cu
    ("flash_attention_bwd", "flash_attention_bwd_wgmma.cu", None,
     "no TPU kernel: the JAX package has no Pallas backward; its training differentiates "
     "layers.sdpa through XLA", flash_bwd_checks, None),
    ("adamw", "adamw.cu", None,
     "no TPU kernel: XLA fuses the JAX package's AdamW; this replaces the port's unfused fp32 "
     "passes (kernels/ref.py adamw_update_ref)", adamw_checks, None),
    *((name, "moe_dispatch.cu", None,
       "no TPU kernel: XLA compiles the JAX package's MoE indexing; this replaces the port's "
       "gathers (kernels/ref.py moe_dispatch_ref, moe_combine_ref), whose autograd backwards "
       "sort thousands of duplicate indices", moe_checks,
       lambda r, name=name: r["kernel"] in (name, f"{name}_bwd")) for name in MOE_OPS),
)


def _headline(case: dict) -> dict:
    """The main path's shape: the first (bf16) case of each kernel."""
    return {k: case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops, ref

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

    # 3. kernel checks, family by family
    timer = Timer(dev)
    rows = {}
    for family in FAMILIES:
        rows[family] = family(ops, ref, timer, dev)
        for rec in rows[family]:
            emit({"phase": "kernel_check", **rec})
        free_memory()
    del timer

    kernels = []
    for name, source, replaces, note, family, mine in KERNELS:
        cases = [r for r in rows[family] if mine is None or mine(r)]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": replaces, **({"note": note} if note else {}),
                        **_headline(cases[0]), "cases": cases})
    for kr in kernels:
        assert all(math.isfinite(kr[k]) for k in ("ms", "plain_ms", "bound_ms")), kr["name"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
