"""Device and seeded blocks of the torch payloads (``gemm``, ``svd``, ``svc``).

**Device.** The copied orchestrator builds a job's DAG with no device
argument (``core/orchestrator.py``, ``JobRequest.build_dag``), so every
DAG function takes ``device=None`` and reads the package default when it builds
the DAG; its task closures keep that device. The default is ``cuda``;
``on_device("cpu")`` changes it for the duration of a ``with`` block. It is
a plain module variable, not a thread-local: the orchestrator may build a
DAG on a clock actor thread. Nothing falls back to the CPU: without a card
the first tensor a task makes raises.

**Blocks.** A block is a pure function of ``(seed, i, j)``: the engine
re-runs tasks (retries, speculative duplicates) and ``ideal_storage``
regenerates blocks inside their consumers, so each draw comes from a fresh
``torch.Generator`` on the device, seeded from ``zlib.crc32`` of the three
numbers. CPU and CUDA generators give different values for one seed; on one
device a redraw equals the first draw bit for bit. A DAG function also takes a
block maker ``blocks(seed, i, j, shape) -> tensor`` (or array) that
replaces these draws: the parity tests feed it the JAX package's blocks
through numpy, since its threefry stream cannot be reproduced.
"""
from __future__ import annotations

import contextlib
import struct
import zlib
from typing import Any, Callable, Iterator

import torch

BlockMaker = Callable[[int, int, int, tuple], Any]

_default_device: "str | torch.device" = "cuda"


@contextlib.contextmanager
def on_device(device: "str | torch.device") -> Iterator[None]:
    """Build (and run) the app DAGs on ``device`` inside the block."""
    global _default_device
    before, _default_device = _default_device, device
    try:
        yield
    finally:
        _default_device = before


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """``device``, or the package default when None."""
    return torch.device(_default_device if device is None else device)


def block_seed(seed: int, i: int, j: int) -> int:
    return zlib.crc32(struct.pack("<3q", seed, i, j))


def normal_block(seed: int, i: int, j: int, shape: tuple,
                 device: torch.device) -> torch.Tensor:
    """Standard normal f32 block ``(seed, i, j)`` of ``shape`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, i, j))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def normal_blocks(device: torch.device) -> BlockMaker:
    """The default block maker: ``normal_block`` on ``device``."""
    def make(seed: int, i: int, j: int, shape: tuple) -> torch.Tensor:
        return normal_block(seed, i, j, shape, device)

    return make


def block_on(blocks: BlockMaker, seed: int, i: int, j: int, shape: tuple,
             device: torch.device) -> torch.Tensor:
    """Block ``(seed, i, j)`` from ``blocks``, as a tensor on ``device``."""
    return torch.as_tensor(blocks(seed, i, j, shape), device=device)
