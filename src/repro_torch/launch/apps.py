"""Paper workloads launcher: ``python -m repro_torch.launch.apps --app gemm tsqr rsvd svc``

The counterpart of ``examples/svd_pipeline.py`` and of the workload part of
``benchmarks/fig08``–``fig11``: each app's DAG (``repro_torch.apps``) runs
through the copied WUKONG engine with its default ``EngineConfig`` (virtual
clock, ``time_scale`` 0, no simulated compute: ``charged_ms`` is KV and
invocation cost only), on ``--device`` (default ``cuda``; the CPU only when
asked). For each app it prints the result check against the app's float64
reference on the same device, ``charged_ms``, the KV bytes written and the
host seconds of the run; for ``rsvd`` also the ideal-storage run (Fig. 10's
ablation) and the per-task KV-read / compute breakdown (Fig. 13). Sizes
default to the paper-scale ones below; ``--gemm N BS`` and the like
override them. Exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any

import numpy as np
import torch

from repro_torch.apps import device as app_device
from repro_torch.apps.device import normal_block
from repro_torch.apps.gemm import gemm_dag, gemm_expected
from repro_torch.apps.svc import svc_dag, svc_expected
from repro_torch.apps.svd import (
    randomized_svd_dag,
    randomized_svd_expected,
    tsqr_singular_values_expected,
    tsqr_svd_dag,
)
from repro_torch.core import EngineConfig, JobReport, WukongEngine

APPS = ("gemm", "tsqr", "rsvd", "svc")

# Paper-scale sizes on one 80 GB card: GEMM at the 10k x 10k of Fig. 8's
# claim; TSQR at 4M x 128; randomized SVD, rank 5 + 5, at n = 50000 (a
# quarter of Fig. 10's largest 100k x 100k, whose 40 GB of f32 blocks leave
# too little room beside them); SVC at 8M samples.
SIZES: dict[str, tuple[int, ...]] = {
    "gemm": (10240, 2048),             # n, block size
    "tsqr": (4194304, 128, 32),        # rows, cols, row blocks
    "rsvd": (50000, 8),                # n, row blocks
    "svc": (8388608, 64, 4),           # samples, blocks, iterations
}
RANK, OVERSAMPLE = 5, 5
TSQR_SEED = 3   # tsqr_svd_dag's default seed

# Limits of the result checks, all against float64 on the same device.
# gemm: max|C - C64| / max|C64|. f32 sums of n products round like
# sqrt(n)·2^-24 of a row's norm (~1e-6 at n = 10240); TF32's 10-bit
# mantissa would give ~1e-3.
GEMM_TOL = 1e-5
# tsqr: singular values, max relative error; U·diag(s)·Vᵀ against A, max
# abs error over max|A|, with V = (UᵀA)ᵀ·diag(1/s) in float64; and V's
# orthogonality, max|VᵀV - I|. All three within TSQR_TOL_FACTOR·2^-24·
# sqrt(rows of a block): the f32 QR of a block sums over its rows, which
# rounds like sqrt(rows)·2^-24 (on an H100 at 131072-row blocks the three
# read 2.8, 1.7 and 13 times that); a wrong factor gives errors of order 1.
TSQR_TOL_FACTOR = 30.0
# rsvd: top singular values, max relative error. Y = A·Omega sums n f32
# products per entry; the rest is small.
RSVD_TOL = 1e-4
# svc: w, rtol / atol as tests/test_apps.py:85-86 (a sample whose margin is
# within rounding of 1 may switch between active and inactive).
SVC_RTOL, SVC_ATOL = 1e-4, 1e-5


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(app: str, size: tuple[int, ...], device=None, ideal_storage: bool = False):
    """The DAG of ``app`` at ``size`` (see ``SIZES``) on ``device``."""
    if app == "gemm":
        return gemm_dag(*size, device=device)
    if app == "tsqr":
        rows, cols, n_blocks = size
        return tsqr_svd_dag(rows, cols, n_blocks, device=device)
    if app == "rsvd":
        n, n_blocks = size
        return randomized_svd_dag(n, RANK, OVERSAMPLE, n_blocks, ideal_storage=ideal_storage,
                                  device=device)
    if app == "svc":
        samples, n_blocks, iters = size
        return svc_dag(samples, n_blocks, iters, device=device)
    raise ValueError(f"unknown app {app!r}")


def check(app: str, size: tuple[int, ...], rep: JobReport, dev: torch.device) -> dict[str, Any]:
    """The app's result against its float64 reference on ``dev``."""
    res = rep.results
    if app == "gemm":
        n, bs = size
        b = n // bs
        c = torch.cat([torch.cat([res[f"gemm-C-{i}-{j}"] for j in range(b)], dim=1)
                       for i in range(b)])
        want = torch.from_numpy(gemm_expected(n, bs, device=dev)).to(dev)
        err = ((c.double() - want).abs().max() / want.abs().max()).item()
        return {"rel_err": err, "tol": GEMM_TOL, "ok": err <= GEMM_TOL}
    if app == "tsqr":
        rows, cols, n_blocks = size
        s = res["svd1-S"].double()
        want = tsqr_singular_values_expected(rows, cols, n_blocks, device=dev)
        errs = {"sv_rel_err": float(np.max(np.abs(s.cpu().numpy() - want) / want)),
                **_tsqr_reconstruction(rows, cols, n_blocks, res, s, dev)}
        tol = TSQR_TOL_FACTOR * 2.0 ** -24 * (rows // n_blocks) ** 0.5
        return {**errs, "tol": tol, "ok": max(errs.values()) <= tol}
    if app == "rsvd":
        n, n_blocks = size
        want = randomized_svd_expected(n, RANK, OVERSAMPLE, n_blocks, device=dev)
        got = res["svd2-S"].double().cpu().numpy()
        err = float(np.max(np.abs(got - want) / want))
        return {"rel_err": err, "tol": RSVD_TOL, "ok": err <= RSVD_TOL,
                "singular_values": got.tolist()}
    if app == "svc":
        samples, n_blocks, iters = size
        want = svc_expected(samples, n_blocks, iters, device=dev)
        got = res[f"svc-w{iters}"].double().cpu().numpy()
        err = float(np.max(np.abs(got - want)))
        ok = bool(np.allclose(got, want, rtol=SVC_RTOL, atol=SVC_ATOL))
        return {"max_abs_err": err, "rtol": SVC_RTOL, "atol": SVC_ATOL, "ok": ok}
    raise ValueError(f"unknown app {app!r}")


def _tsqr_reconstruction(rows, cols, n_blocks, res, s, dev) -> dict[str, float]:
    """U·diag(s)·Vᵀ against A, block by block, V = (UᵀA)ᵀ·diag(1/s)."""
    shape = (rows // n_blocks, cols)
    a = [normal_block(TSQR_SEED, i, 0, shape, dev).double() for i in range(n_blocks)]
    u = [res[f"svd1-U-{i}"].double() for i in range(n_blocks)]
    v = sum(ui.T @ ai for ui, ai in zip(u, a)).T / s
    eye = torch.eye(cols, dtype=torch.float64, device=dev)
    a_max = max(ai.abs().max() for ai in a)
    recon = max(((ui * s) @ v.T - ai).abs().max() for ui, ai in zip(u, a))
    return {"recon_rel_err": (recon / a_max).item(),
            "v_orth_err": (v.T @ v - eye).abs().max().item()}


def breakdown(rep: JobReport) -> dict[str, dict[str, float]]:
    """Fig. 13: per-task KV-read and compute ms over the executed tasks."""
    execd = [m for m in rep.metrics if m.get("event") == "executed"]
    out = {}
    for name, key in (("kv_read", "read_ms"), ("compute", "compute_ms")):
        vals = np.array([m[key] for m in execd])
        out[name] = {"p50_ms": float(np.percentile(vals, 50)),
                     "p99_ms": float(np.percentile(vals, 99)), "max_ms": float(vals.max())}
    out["tasks"] = len(execd)
    return out


def run_app(app: str, size: tuple[int, ...], device=None,
            ideal_storage: bool = False) -> dict[str, Any]:
    """One run of ``app`` through the engine: host seconds (closed by a
    synchronise on the card), the engine's price and the result check."""
    dev = app_device.resolve(device)
    dag = build(app, size, dev, ideal_storage=ideal_storage)
    _sync(dev)
    t0 = time.perf_counter()  # lint: allow(REPRO001)
    rep = WukongEngine(EngineConfig()).compute(dag)
    _sync(dev)
    host_s = time.perf_counter() - t0  # lint: allow(REPRO001)
    rec = {"app": app, "size": list(size), "ideal_storage": ideal_storage,
           "device": str(dev), "host_s": host_s,
           "tasks": rep.tasks, "charged_ms": rep.charged_ms,
           "bytes_written": rep.kv_stats["bytes_written"], "kv_stats": rep.kv_stats,
           "check": check(app, size, rep, dev)}
    if app == "rsvd":
        rec["breakdown"] = breakdown(rep)
    return rec


def main(argv: list[str] | None = None) -> list[dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--app", nargs="+", choices=APPS, default=list(APPS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gemm", nargs=2, type=int, metavar=("N", "BLOCK"))
    ap.add_argument("--tsqr", nargs=3, type=int, metavar=("ROWS", "COLS", "BLOCKS"))
    ap.add_argument("--rsvd", nargs=2, type=int, metavar=("N", "BLOCKS"))
    ap.add_argument("--svc", nargs=3, type=int, metavar=("SAMPLES", "BLOCKS", "ITERS"))
    args = ap.parse_args(argv)

    records = []
    with app_device.on_device(args.device):
        for app in args.app:
            size = tuple(getattr(args, app) or SIZES[app])
            runs = [run_app(app, size)]
            if app == "rsvd":
                runs.append(run_app(app, size, ideal_storage=True))
            for rec in runs:
                print(json.dumps(rec), flush=True)
            if app == "rsvd":
                normal, ideal = runs
                bd = normal["breakdown"]
                print(f"rsvd ideal storage: kv bytes {ideal['bytes_written']:,} against "
                      f"{normal['bytes_written']:,}; Fig. 13 breakdown over {bd['tasks']} "
                      f"tasks: kv-read p50 {bd['kv_read']['p50_ms']:.2f} ms p99 "
                      f"{bd['kv_read']['p99_ms']:.2f} ms, compute p50 "
                      f"{bd['compute']['p50_ms']:.2f} ms p99 {bd['compute']['p99_ms']:.2f} ms",
                      flush=True)
            records += runs
    return records


if __name__ == "__main__":
    sys.exit(0 if all(r["check"]["ok"] for r in main()) else 1)
