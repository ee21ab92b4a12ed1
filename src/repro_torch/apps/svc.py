"""Support Vector Classification (paper §V, Fig. 11), torch payloads.

The paper runs SVC from the Dask-ML benchmark suite with growing sample
counts. We implement a linear SVM trained by full-batch sub-gradient
descent on the hinge loss, blocked over sample chunks: each iteration is a
wide fan-out (per-block gradients), a fan-in reduction tree, and an update
task that feeds the next iteration — a DAG with the bursty fan-out/fan-in
cadence that characterizes data-parallel ML, unrolled for ``n_iters``.

The DAG, task names, FLOP counts and task functions' names (the engine
prices a static schedule's shipped code by them) are those of ``repro.apps.svc``; the
payloads are f32 tensor ops on the DAG's device
(``repro_torch.apps.device``). A sample whose margin lies within rounding
of 1 may count as active in one package and not in the other.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.apps.device import BlockMaker, block_on, normal_blocks, resolve
from repro_torch.core.api import GraphBuilder
from repro_torch.core.dag import DAG

DIM = 32


def _data_block(blocks: BlockMaker, seed: int, i: int, rows: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Samples ``x = blocks(seed, i, 0, (rows, DIM))`` and their labels
    ``sign(x·w_true + 0.1)``, ``w_true = blocks(seed + 999, 0, 0, (DIM,))``
    (the JAX package draws it from PRNGKey(seed + 999))."""
    x = block_on(blocks, seed, i, 0, (rows, DIM), device)
    w_true = block_on(blocks, seed + 999, 0, 0, (DIM,), device)
    return x, torch.sign(x @ w_true + 0.1)


def _hinge_grad(block: tuple[torch.Tensor, torch.Tensor],
                w: torch.Tensor) -> torch.Tensor:
    x, y = block
    margin = y * (x @ w)
    active = (margin < 1.0).to(torch.float32)
    return -(x * (y * active)[:, None]).sum(dim=0)


def _apply_update(w: torch.Tensor, grad_sum: torch.Tensor, n: float,
                  lr: float, reg: float) -> torch.Tensor:
    return (1.0 - lr * reg) * w - lr * grad_sum / n


def svc_dag(
    n_samples: int,
    n_blocks: int = 8,
    n_iters: int = 4,
    lr: float = 0.1,
    reg: float = 1e-3,
    seed: int = 5,
    sleep_per_flop: float = 0.0,
    ms_per_flop: float = 0.0,
    device: "str | torch.device | None" = None,
    blocks: "BlockMaker | None" = None,
) -> DAG:
    if n_samples % n_blocks:
        raise ValueError("n_samples must divide into n_blocks")
    dev = resolve(device)
    blocks = blocks or normal_blocks(dev)
    rows = n_samples // n_blocks
    grad_flops = 4.0 * rows * DIM

    def costed(fn):
        from repro_torch.apps.costing import flop_costed

        return flop_costed(fn, grad_flops, sleep_per_flop, ms_per_flop)

    g = GraphBuilder()

    def leaf(i: int):
        def make():
            return _data_block(blocks, seed, i, rows, dev)

        make.__name__ = "svc_block"
        return make

    data = [g.add(leaf(i), name=f"svc-X-{i}") for i in range(n_blocks)]

    def init_w():
        return torch.zeros((DIM,), dtype=torch.float32, device=dev)

    init_w.__name__ = "svc_init"
    w = g.add(init_w, name="svc-w0")

    for it in range(n_iters):
        grads = [g.add(costed(_hinge_grad), blk, w,
                       name=f"svc-g{it}-{i}")
                 for i, blk in enumerate(data)]
        depth = 0
        while len(grads) > 1:
            nxt = []
            for i in range(0, len(grads) - 1, 2):
                nxt.append(g.add(torch.add, grads[i], grads[i + 1],
                                 name=f"svc-gs{it}-{depth}-{i // 2}"))
            if len(grads) % 2:
                nxt.append(grads[-1])
            grads, depth = nxt, depth + 1
        w = g.add(
            functools.partial(_apply_update, n=float(n_samples), lr=lr,
                              reg=reg),
            w, grads[0], name=f"svc-w{it + 1}",
        )
    return g.build()


def svc_expected(n_samples: int, n_blocks: int = 8, n_iters: int = 4,
                 lr: float = 0.1, reg: float = 1e-3, seed: int = 5,
                 device: "str | torch.device | None" = None,
                 blocks: "BlockMaker | None" = None) -> np.ndarray:
    """The same descent in float64 on ``device``, from the DAG's own blocks."""
    dev = resolve(device)
    blocks = blocks or normal_blocks(dev)
    rows = n_samples // n_blocks
    data = [tuple(t.double() for t in _data_block(blocks, seed, i, rows, dev))
            for i in range(n_blocks)]
    w = torch.zeros((DIM,), dtype=torch.float64, device=dev)
    for _ in range(n_iters):
        gsum = sum(_hinge_grad(blk, w) for blk in data)
        w = _apply_update(w, gsum, float(n_samples), lr, reg)
    return w.cpu().numpy()
