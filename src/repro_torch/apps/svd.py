"""SVD workloads (paper §V, Figs. 9 & 10), torch payloads.

SVD1 — tall-and-skinny SVD via the communication-avoiding TSQR algorithm
(the same algorithm Dask uses for ``da.linalg.svd`` on tall matrices):
block the rows, QR each block, reduce the R factors pairwise with stacked
QRs, SVD the final small R, then fan the right factor back out to form U.
The DAG is a reduction tree followed by a wide fan-out: exactly the shape
WUKONG's fan-in counters + proxy are built for.

SVD2 — rank-k randomized SVD of a square n x n matrix (Halko, Martinsson,
Tropp — the paper's citation [18]): Y = A @ Omega, QR(Y), B = Q^T A,
SVD(B). Blocked over row-blocks of A.

``ideal_storage=True`` reproduces the paper's §V-C "ideally-fast
intermediate storage" ablation: every input block is regenerated from its
seed instead of being read back from the KV store, which removes the
large-object KV traffic while keeping the DAG and compute identical.

The DAGs, task names, FLOP counts and task functions' names (the engine
prices a static schedule's shipped code by them) are those of ``repro.apps.svd``. The
payloads are ``torch.linalg`` calls in f32 on the DAG's device
(``repro_torch.apps.device``); on a card each of them waits for the device
(cuSOLVER's info check). ``torch.linalg.qr`` may give R rows of other
signs than XLA's, so R, Q_i, U columns and Bt_i can differ in sign from
the JAX DAG's; singular values cannot.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.apps.device import BlockMaker, block_on, normal_blocks, resolve
from repro_torch.core.api import GraphBuilder
from repro_torch.core.dag import DAG


def _row_block(blocks: BlockMaker, seed: int, i: int, rows: int, cols: int,
               device: torch.device) -> torch.Tensor:
    return block_on(blocks, seed, i, 0, (rows, cols), device)


def _omega(blocks: BlockMaker, seed: int, n: int, k: int,
           device: torch.device) -> torch.Tensor:
    # the JAX package draws Omega from PRNGKey(seed + 1): block (seed + 1, 0, 0)
    return block_on(blocks, seed + 1, 0, 0, (n, k), device)


def _qr_r(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(a, mode="r").R


def _stack_qr_r(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(torch.cat([r1, r2], dim=0), mode="r").R


def _singular_values(r: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svdvals(r)


def _costed(fn, flops, sleep_per_flop, ms_per_flop=0.0):
    """Per-task compute cost from analytic FLOPs (see
    repro_torch.apps.costing.flop_costed)."""
    from repro_torch.apps.costing import flop_costed

    return flop_costed(fn, flops, sleep_per_flop, ms_per_flop)


def tsqr_svd_dag(
    rows: int,
    cols: int = 64,
    n_blocks: int = 8,
    seed: int = 3,
    compute_u: bool = True,
    sleep_per_flop: float = 0.0,
    ms_per_flop: float = 0.0,
    device: "str | torch.device | None" = None,
    blocks: "BlockMaker | None" = None,
) -> DAG:
    """SVD1: tall-and-skinny (rows >> cols) SVD via TSQR.

    ``ms_per_flop`` (simulated, clock-charged) / ``sleep_per_flop``
    (legacy real sleep) simulate compute duration per task from analytic
    FLOPs. Row block ``i`` is ``blocks(seed, i, 0, (rows // n_blocks,
    cols))``, by default a seeded standard normal block on ``device``."""
    if rows % n_blocks:
        raise ValueError("rows must divide evenly into n_blocks")
    dev = resolve(device)
    blocks = blocks or normal_blocks(dev)
    block_rows = rows // n_blocks
    qr_flops = 2.0 * block_rows * cols ** 2
    g = GraphBuilder()

    def leaf(i: int):
        def make() -> torch.Tensor:
            return _row_block(blocks, seed, i, block_rows, cols, dev)

        make.__name__ = "svd_block"
        return make

    a_blocks = [g.add(leaf(i), name=f"svd1-A-{i}") for i in range(n_blocks)]
    rs = [g.add(_costed(_qr_r, qr_flops, sleep_per_flop, ms_per_flop), blk,
                name=f"svd1-R0-{i}")
          for i, blk in enumerate(a_blocks)]
    depth = 0
    while len(rs) > 1:
        nxt = []
        for i in range(0, len(rs) - 1, 2):
            nxt.append(g.add(_stack_qr_r, rs[i], rs[i + 1],
                             name=f"svd1-R{depth + 1}-{i // 2}"))
        if len(rs) % 2:
            nxt.append(rs[-1])
        rs, depth = nxt, depth + 1
    final_r = rs[0]
    g.add(_singular_values, final_r, name="svd1-S")

    if compute_u:
        # Fan-out: U_i = A_i @ V @ diag(1/s) — wide fan-out from final R.
        def u_block(a_blk: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
            _, s, vt = torch.linalg.svd(r, full_matrices=False)
            return a_blk @ vt.T / s[None, :]

        for i, blk in enumerate(a_blocks):
            g.add(_costed(u_block, 2.0 * block_rows * cols ** 2,
                          sleep_per_flop, ms_per_flop),
                  blk, final_r, name=f"svd1-U-{i}")
    return g.build()


def tsqr_singular_values_expected(rows: int, cols: int, n_blocks: int,
                                  seed: int = 3,
                                  device: "str | torch.device | None" = None,
                                  blocks: "BlockMaker | None" = None) -> np.ndarray:
    """A's singular values in float64 on ``device``, from the DAG's own blocks:
    the square roots of the eigenvalues of AᵀA, summed block by block (A is
    tall and Gaussian, so squaring its condition number costs nothing)."""
    dev = resolve(device)
    blocks = blocks or normal_blocks(dev)
    block_rows = rows // n_blocks
    gram = torch.zeros((cols, cols), dtype=torch.float64, device=dev)
    for i in range(n_blocks):
        a = _row_block(blocks, seed, i, block_rows, cols, dev).double()
        gram += a.T @ a
    return torch.linalg.eigvalsh(gram).flip(0).clamp_min(0).sqrt().cpu().numpy()


def randomized_svd_dag(
    n: int,
    rank: int = 5,
    oversample: int = 5,
    n_blocks: int = 8,
    seed: int = 4,
    ideal_storage: bool = False,
    sleep_per_flop: float = 0.0,
    ms_per_flop: float = 0.0,
    device: "str | torch.device | None" = None,
    blocks: "BlockMaker | None" = None,
) -> DAG:
    """SVD2: rank-``rank`` randomized SVD of an n x n matrix [Halko et al.].

    The square matrix is blocked by rows. ``ideal_storage`` regenerates
    A-blocks inside consumers instead of passing them through the KV store
    (paper §V-C's ideal-storage ablation — "all array data was randomly
    generated each time it was used"). Row block ``i`` is ``blocks(seed,
    i, 0, (n // n_blocks, n))`` and Omega is ``blocks(seed + 1, 0, 0, (n,
    rank + oversample))``.
    """
    if n % n_blocks:
        raise ValueError("n must divide evenly into n_blocks")
    dev = resolve(device)
    blocks = blocks or normal_blocks(dev)
    rows = n // n_blocks
    k = rank + oversample
    blk_mm_flops = 2.0 * rows * n * k        # Y_i / B_i block products
    g = GraphBuilder()

    def costed(fn, flops=blk_mm_flops):
        return _costed(fn, flops, sleep_per_flop, ms_per_flop)

    def make_omega() -> torch.Tensor:
        return _omega(blocks, seed, n, k, dev)

    make_omega.__name__ = "svd2_omega"
    om = g.add(make_omega, name="svd2-Omega")

    def leaf(i: int):
        def make() -> torch.Tensor:
            return _row_block(blocks, seed, i, rows, n, dev)

        make.__name__ = "svd2_block"
        return make

    def y_block(a_blk: torch.Tensor, om_: torch.Tensor) -> torch.Tensor:
        return a_blk @ om_

    def bt_block(a_blk: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return a_blk.T @ q

    # Ideal storage: A-block i is made inside its consumer, so the big
    # objects never pass through the KV store. Partials, as in the JAX
    # package: the engine prices shipped task code by function name.
    def y_block_ideal(i: int, om_: torch.Tensor) -> torch.Tensor:
        return y_block(_row_block(blocks, seed, i, rows, n, dev), om_)

    def bt_block_ideal(i: int, q: torch.Tensor) -> torch.Tensor:
        return bt_block(_row_block(blocks, seed, i, rows, n, dev), q)

    if ideal_storage:
        ys = [g.add(costed(functools.partial(y_block_ideal, i)), om,
                    name=f"svd2-Y-{i}")
              for i in range(n_blocks)]
    else:
        a_blocks = [g.add(leaf(i), name=f"svd2-A-{i}") for i in range(n_blocks)]
        ys = [g.add(costed(y_block), blk, om, name=f"svd2-Y-{i}")
              for i, blk in enumerate(a_blocks)]

    # TSQR on Y (n x k, tall-skinny) to get Q implicitly via R, then
    # B^T = A^T Q computed blockwise; SVD of B gives the rank-k factors.
    rs = [g.add(_qr_r, y, name=f"svd2-R0-{i}") for i, y in enumerate(ys)]
    depth = 0
    while len(rs) > 1:
        nxt = []
        for i in range(0, len(rs) - 1, 2):
            nxt.append(g.add(_stack_qr_r, rs[i], rs[i + 1],
                             name=f"svd2-R{depth + 1}-{i // 2}"))
        if len(rs) % 2:
            nxt.append(rs[-1])
        rs, depth = nxt, depth + 1
    final_r = rs[0]

    def q_block(y: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        # Q_i = Y_i R^{-1}
        return torch.linalg.solve_triangular(r, y, upper=True, left=False)

    qs = [g.add(costed(q_block, 2.0 * rows * k * k), y, final_r,
                name=f"svd2-Q-{i}")
          for i, y in enumerate(ys)]

    if ideal_storage:
        bts = [g.add(costed(functools.partial(bt_block_ideal, i)), q,
                     name=f"svd2-Bt-{i}")
               for i, q in enumerate(qs)]
    else:
        bts = [g.add(costed(bt_block), blk, q, name=f"svd2-Bt-{i}")
               for i, (blk, q) in enumerate(zip(a_blocks, qs))]

    def sum2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.add(a, b)

    acc = bts
    depth = 0
    while len(acc) > 1:
        nxt = []
        for i in range(0, len(acc) - 1, 2):
            nxt.append(g.add(sum2, acc[i], acc[i + 1],
                             name=f"svd2-BtSum{depth}-{i // 2}"))
        if len(acc) % 2:
            nxt.append(acc[-1])
        acc, depth = nxt, depth + 1

    def top_singular_values(bt: torch.Tensor, r: int) -> torch.Tensor:
        return torch.linalg.svdvals(bt.T)[:r]

    g.add(functools.partial(top_singular_values, r=rank), acc[0],
          name="svd2-S")
    return g.build()


def randomized_svd_expected(n: int, rank: int, oversample: int,
                            n_blocks: int, seed: int = 4,
                            device: "str | torch.device | None" = None,
                            blocks: "BlockMaker | None" = None) -> np.ndarray:
    """The same randomized SVD in float64 on ``device``, from the DAG's own
    blocks, one row block at a time: Y = A Omega, Q from Y's QR, the top
    singular values of QᵀA."""
    dev = resolve(device)
    blocks = blocks or normal_blocks(dev)
    rows = n // n_blocks
    om = _omega(blocks, seed, n, rank + oversample, dev).double()
    y = torch.cat([_row_block(blocks, seed, i, rows, n, dev).double() @ om
                   for i in range(n_blocks)])
    q = torch.linalg.qr(y).Q
    b = sum(q[i * rows:(i + 1) * rows].T @ _row_block(blocks, seed, i, rows, n, dev).double()
            for i in range(n_blocks))
    return torch.linalg.svdvals(b)[:rank].cpu().numpy()
