"""AdamW with global-norm clipping and optional gradient compression.

The update of ``repro.optim.adamw``, written out by hand (``torch.optim.
AdamW`` differs: no global-norm clip, no bf16 round trip of the
gradients, decay on every leaf). Moments are fp32; ``grad_compress=
"bf16"`` rounds the gradients to bf16 and back, as the reference does
before its cross-replica reduction.

``adamw_update`` routes by the device of the leaves, as every wrapper in
``kernels.ops`` does (``ops.adamw_update``): CPU leaves take the plain
version (``kernels.ref.adamw_update_ref``); CUDA leaves the hand-written
kernels (``kernels/csrc/adamw.cu``: each gradient read once for the global
norm, then one pass a leaf over p, g, mu and nu), or it raises; meta and
fake leaves (a dry run's trace) the kernels' fake implementations; DTensors
run the kernels on each device's shards.

Functional: ``adamw_update`` returns new tensors and never writes into
``params``, ``state`` or ``grads``. The engine may run a step task twice
on the same input (a retry, a speculative duplicate); an update in place
would then be applied twice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compress: str | None = None  # None | "bf16"
    warmup: int = 200                 # schedule warmup steps


def adamw_init(params: Any) -> dict[str, Any]:
    """Zero fp32 moments shaped like ``params`` and a 0-d int32 step count,
    on the device of the first leaf."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "mu": map_tree(zeros, params),
        "nu": map_tree(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
    }


@torch.no_grad()
def adamw_update(
    grads: Any, state: dict[str, Any], params: Any, cfg: AdamWConfig,
    lr_scale: torch.Tensor | float = 1.0,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """(new params, new state, {"grad_norm"}): the clipped, bias-corrected
    AdamW step, in fp32, each new leaf cast back to its parameter's dtype."""
    return ops.adamw_update(grads, state, params, cfg, lr_scale)


def fused_leaves(params: Any) -> int:
    """How many leaves ``adamw_update`` hands to the kernel: every leaf of a
    tree off the CPU, none of a tree on it."""
    ps = leaves(params)
    return 0 if all(p.device.type == "cpu" for p in ps) else len(ps)
