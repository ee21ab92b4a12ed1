"""Blocked General Matrix Multiplication (paper §V, Fig. 8), torch payloads.

C = A @ B with A, B split into a bxb grid of square blocks. Leaf tasks
materialize input blocks (seeded generators — the paper's client also does
not ship the matrices through the scheduler), inner tasks multiply blocks
with ``torch.matmul`` in f32 (TF32 stays off: the apps never enable it) and
a reduction tree sums the partial products per output block, giving the
large fan-out/fan-in structure that exercises WUKONG's proxy and dependency
counters. The DAG, task names, FLOP counts and task functions' names (the engine
prices a static schedule's shipped code by them) are those of
``repro.apps.gemm``; blocks live on the DAG's device
(``repro_torch.apps.device``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.apps.device import BlockMaker, block_on, normal_block, resolve
from repro_torch.core.api import GraphBuilder
from repro_torch.core.dag import DAG


def _gaussian_blocks(device: torch.device) -> BlockMaker:
    def make(seed: int, i: int, j: int, shape: tuple) -> torch.Tensor:
        return normal_block(seed, i, j, shape, device) / math.sqrt(shape[0])

    return make


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.add(a, b)


def gemm_dag(n: int, block_size: int, seed_a: int = 1, seed_b: int = 2,
             sleep_per_flop: float = 0.0, ms_per_flop: float = 0.0,
             device: "str | torch.device | None" = None,
             blocks: "BlockMaker | None" = None) -> DAG:
    """DAG computing C = A @ B for n x n matrices in block_size blocks.

    Roots are the bxb output blocks ``gemm-C-i-j``. ``ms_per_flop`` adds
    a simulated compute duration per task proportional to its analytic
    FLOPs, charged on the engine clock; ``sleep_per_flop`` is the legacy
    real-sleep variant (seconds per flop). Block ``(i, j)`` of A is
    ``blocks(seed_a, i, j, (bs, bs))``; by default a seeded standard normal
    block over sqrt(bs), on ``device`` (default: ``apps.device``'s).
    """
    from repro_torch.apps.costing import flop_costed

    def costed(fn, flops):
        return flop_costed(fn, flops, sleep_per_flop, ms_per_flop)

    if n % block_size:
        raise ValueError("n must be divisible by block_size")
    dev = resolve(device)
    blocks = blocks or _gaussian_blocks(dev)
    b = n // block_size
    mm_flops = 2.0 * block_size ** 3
    add_flops = float(block_size ** 2)
    g = GraphBuilder()

    def leaf(seed: int, i: int, j: int, tag: str):
        def make() -> torch.Tensor:
            return block_on(blocks, seed, i, j, (block_size, block_size), dev)

        make.__name__ = f"gemm_block_{tag}"
        return make

    A = {(i, k): g.add(leaf(seed_a, i, k, "A"), name=f"gemm-A-{i}-{k}")
         for i in range(b) for k in range(b)}
    B = {(k, j): g.add(leaf(seed_b, k, j, "B"), name=f"gemm-B-{k}-{j}")
         for k in range(b) for j in range(b)}

    for i in range(b):
        for j in range(b):
            partials = [
                g.add(costed(_matmul, mm_flops), A[(i, k)], B[(k, j)],
                      name=f"gemm-P-{i}-{j}-{k}")
                for k in range(b)
            ]
            # pairwise reduction tree over k
            depth = 0
            while len(partials) > 1:
                nxt = []
                for s in range(0, len(partials) - 1, 2):
                    nxt.append(
                        g.add(costed(_add, add_flops),
                              partials[s], partials[s + 1],
                              name=f"gemm-S-{i}-{j}-{depth}-{s // 2}")
                    )
                if len(partials) % 2:
                    nxt.append(partials[-1])
                partials, depth = nxt, depth + 1
            final = partials[0]
            # alias the root with a stable name
            g.add(lambda x: x, final, name=f"gemm-C-{i}-{j}")
    return g.build()


def gemm_expected(n: int, block_size: int, seed_a: int = 1, seed_b: int = 2,
                  device: "str | torch.device | None" = None,
                  blocks: "BlockMaker | None" = None) -> np.ndarray:
    """C = A @ B in float64 on ``device`` from the DAG's own blocks."""
    dev = resolve(device)
    blocks = blocks or _gaussian_blocks(dev)
    b = n // block_size
    shape = (block_size, block_size)
    A = torch.cat([torch.cat([block_on(blocks, seed_a, i, k, shape, dev).double()
                              for k in range(b)], dim=1) for i in range(b)])
    B = torch.cat([torch.cat([block_on(blocks, seed_b, k, j, shape, dev).double()
                              for j in range(b)], dim=1) for k in range(b)])
    return (A @ B).cpu().numpy()
