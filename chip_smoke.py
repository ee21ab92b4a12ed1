#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc;
3. kernel checks: each CUDA kernel against its plain PyTorch version on
   the card at smollm-360m's shapes (tolerance f32 2e-5, bf16 2e-2), timed
   with CUDA events (median of 30, L2 flushed before each run) beside the
   plain version, ``torch.nn.functional.scaled_dot_product_attention`` as
   a yardstick only, and the card's bound for the same work;
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
   and from a ``torch.profiler`` trace its device ms, kernel launches and
   top kernels.

Kernel launch counts are set to 0 before each of phases 4-6 and read
after it. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
REPS = 30


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


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


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref, dtype) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    return err


def check_decode(ops, ref, timer, dev, dtype, B, S, lens, H=15, K=5, hd=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, kc, vc, kv_len)
    err = max_err(out, ref.decode_attention_ref(q, kc, vc, kv_len), dtype)
    # yardstick: SDPA over the cache with a length mask, kv heads repeated
    qs = q[:, :, None, :]
    ks, vs = (c.transpose(1, 2).repeat_interleave(H // K, dim=1) for c in (kc, vc))
    mask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    n_valid = sum(min(n, S) for n in lens)
    elt = q.element_size()
    nbytes = (2 * n_valid * K * hd + 2 * B * H * hd) * elt + 4 * B
    t_bound, by = bound(nbytes, 4.0 * n_valid * H * hd, dtype)
    return {
        "shape": f"B={B} S={S} H={H} K={K} hd={hd} kv_len={lens}", "dtype": DT_NAME[dtype],
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": timer(lambda: ops.decode_attention(q, kc, vc, kv_len)),
        "plain_ms": timer(lambda: ref.decode_attention_ref(q, kc, vc, kv_len)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
        "bound_ms": t_bound, "bound_by": by,
    }


def check_flash(ops, ref, timer, dev, dtype, B, S, causal, window, H=15, K=5, hd=64, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    err = max_err(out, ref.flash_attention_ref(q, k, v, causal=causal, window=window), dtype)
    rows = torch.arange(S, device=dev)[:, None]
    cols = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    n_pairs = int(mask.sum().item())
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(H // K, dim=1) for t in (k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)  # noqa: E731
    else:
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)  # noqa: E731
    nbytes = 2 * B * S * (H + K) * hd * q.element_size()
    t_bound, by = bound(nbytes, 4.0 * B * H * hd * n_pairs, dtype)
    return {
        "shape": f"B={B} S={S} H={H} K={K} hd={hd} causal={causal} window={window}",
        "dtype": DT_NAME[dtype], "max_abs_err": err, "tol": TOL[dtype],
        "ms": timer(lambda: ops.flash_attention(q, k, v, causal=causal, window=window)),
        "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                          window=window)),
        "library_ms": timer(lib), "bound_ms": t_bound, "bound_by": by,
    }


def rel_err(a, b) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def reset(ops) -> None:
    ops.flash_attention.launches = 0
    ops.decode_attention.launches = 0


def counts(ops) -> dict:
    return {"flash_attention": ops.flash_attention.launches,
            "decode_attention": ops.decode_attention.launches}


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
          "ptxas": ptxas})

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
    for rec in decode_cases + flash_cases:
        emit({"phase": "kernel_check", **rec})
    del timer
    torch.cuda.empty_cache()

    cfg = get_config("smollm_360m")

    # 4. forward: full width, bf16, B=2, S=512
    params = M.init_model(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 512)),
                             device=dev)
    reset(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = M.forward(params, cfg, tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = counts(ops)
    assert logits.shape == (2, 512, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all())
    assert fwd_counts["flash_attention"] == cfg.n_layers, fwd_counts
    emit({"phase": "forward", "shape": [2, 512], "dtype": "bf16", "seconds": fwd_s,
          "launches": fwd_counts})
    del logits

    # 5. decode against forward, full width, 64 positions
    for name, dcfg, tol in (("f32", dataclasses.replace(cfg, dtype="float32"), 1e-3),
                            ("bf16", cfg, 5e-2)):
        p = M.init_model(dcfg, seed=0, device=dev)
        toks = tokens[:, :64]
        reset(ops)
        full = M.forward(p, dcfg, toks)
        cache = M.init_cache(dcfg, 2, 64, device=dev)
        steps = []
        for t in range(64):
            lg, cache = M.decode_step(p, dcfg, cache, toks[:, t], t)
            steps.append(lg)
        err = rel_err(torch.stack(steps, dim=1), full)
        c = counts(ops)
        emit({"phase": "decode_vs_forward", "dtype": name, "positions": 64,
              "rel_err": err, "tol": tol, "launches": c})
        assert err < tol, (name, err, tol)
        assert c == {"flash_attention": dcfg.n_layers,
                     "decode_attention": 64 * dcfg.n_layers}, c
        del p, cache, full, steps
    del params
    torch.cuda.empty_cache()

    # 6. serve through the copied engine, full width
    reset(ops)
    rep = serve_mod.main(["--full-width", "--requests", "4", "--batch", "4",
                          "--prompt-len", "32", "--gen-len", "32",
                          "--device", "cuda", "--seed", "0"])
    serve_counts = counts(ops)
    summary = rep.results["summary"]
    assert len(summary["tokens"]) == 4
    for toks in summary["tokens"]:
        assert toks.shape == (4, 32) and toks.min() >= 0 and toks.max() < cfg.vocab
    steps = 32 + 32 - 1
    assert serve_counts["decode_attention"] >= cfg.n_layers * steps * 4, serve_counts
    emit({"phase": "serve", "requests": 4, "batch": 4, "prompt_len": 32, "gen_len": 32,
          "mean_tokens_per_s": summary["mean_tps"],
          "p99_latency_s": summary["p99_latency_s"], "charged_ms": rep.charged_ms,
          "launches": serve_counts})

    small = dataclasses.replace(reduced(cfg), n_heads=6, n_kv_heads=2)  # G = 3
    p_cpu = M.init_model(small, seed=1, device="cpu")
    p_gpu = _to(p_cpu, dev)
    kw = dict(requests=2, batch=3, prompt_len=8, gen_len=12, seed=1)
    on_gpu = serve_mod.serve(small, p_gpu, device=dev, **kw).results["summary"]["tokens"]
    on_cpu = serve_mod.serve(small, p_cpu, device="cpu", **kw).results["summary"]["tokens"]
    same = all(np.array_equal(a, b) for a, b in zip(on_gpu, on_cpu, strict=True))
    emit({"phase": "serve_reference", "config": "reduced smollm f32, H=6 K=2",
          "tokens_equal_cpu": same})
    assert same, (on_gpu, on_cpu)

    emit({"phase": "decode_step_profile", **profile_decode(cfg, M, dev)})

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:97",
         "launches": fwd_counts["flash_attention"], **_headline(flash_cases[0]),
         "cases": flash_cases},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:77",
         "launches": serve_counts["decode_attention"], **_headline(decode_cases[0]),
         "cases": decode_cases},
    ]
    for kr in kernels:
        assert kr["launches"] > 0, kr["name"]
        assert all(math.isfinite(kr[k]) for k in ("ms", "plain_ms", "bound_ms"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def profile_decode(cfg, M, dev, batch=4, warm=8, steps=16) -> dict:
    """Where a full-width serving step's time goes: host ms per step
    without the profiler, then a ``torch.profiler`` trace of the same
    steps for device time, kernel launches and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    params = M.init_model(cfg, seed=0, device=dev)
    cache = M.init_cache(cfg, batch, warm + 2 * steps, device=dev)
    tok = torch.zeros((batch,), dtype=torch.long, device=dev)

    def run(first, n):
        nonlocal tok
        for pos in range(first, first + n):
            logits, _ = M.decode_step(params, cfg, cache, tok, pos)
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()

    run(0, warm)
    t0 = time.perf_counter()
    run(warm, steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(warm + steps, steps)
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"batch": batch, "cache_len": warm + 2 * steps, "step_ms": step_ms,
            "traced_step_ms": traced_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / step_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "top_kernels": [{"name": e.key[:80], "ms_per_step":
                             e.self_device_time_total / 1e3 / steps,
                             "launches_per_step": e.count / steps} for e in top]}


def _headline(case: dict) -> dict:
    """The main path's shape: the first (bf16) case of each kernel."""
    return {k: case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
