"""AdamW with global-norm clipping and optional gradient compression.

The update of ``repro.optim.adamw``, written out by hand (``torch.optim.
AdamW`` differs: no global-norm clip, no bf16 round trip of the
gradients, decay on every leaf). Moments are fp32; ``grad_compress=
"bf16"`` rounds the gradients to bf16 and back, as the reference does
before its cross-replica reduction.

Functional: ``adamw_update`` returns new tensors and never writes into
``params``, ``state`` or ``grads``. The engine may run a step task twice
on the same input (a retry, a speculative duplicate); an update in place
would then be applied twice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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
    if cfg.grad_compress == "bf16":
        grads = map_tree(lambda g: g.to(torch.bfloat16), grads)
    grads = map_tree(lambda g: g.float(), grads)

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    grads = map_tree(lambda g: g * scale, grads)

    count = state["count"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    mu = map_tree(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state["mu"], grads)
    nu = map_tree(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state["nu"], grads)
    lr = cfg.lr * lr_scale

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # no weight decay on norms/bias
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = map_tree(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}, {"grad_norm": gnorm}
