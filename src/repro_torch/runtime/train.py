"""Training step: loss + grads + AdamW, with microbatch accumulation.

``build_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, the port of ``repro.runtime.train``. The step is a
pure function of its inputs: gradients are taken with respect to detached
views of the parameters, and ``adamw_update`` returns new tensors, so a
step that the engine runs twice on the same state gives the same result
and leaves that state as it was. Microbatches (the reference's
``lax.scan``) are a Python loop that sums fp32 gradients; only one
microbatch's activations are alive at a time.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.tree import leaves, map_tree, unflatten


def build_train_step(cfg: ModelConfig, opt: AdamWConfig, n_microbatches: int = 1):
    """The train step of ``cfg`` (``attn+dense`` decoders and xLSTM's
    mLSTM / sLSTM blocks: ``model.check_trainable``) under ``opt``;
    ``batch`` = {"tokens", "labels"}: (B, S) integer tensors, B divisible by
    ``n_microbatches``. Metrics are 0-d tensors: loss, grad_norm, lr_scale."""
    M.check_trainable(cfg)

    def value_and_grad(params, tokens, labels):
        with torch.enable_grad():
            p = map_tree(lambda t: t.detach().requires_grad_(), params)
            loss = M.loss_fn(p, cfg, tokens, labels)
            grads = torch.autograd.grad(loss, leaves(p))
        return loss.detach(), unflatten(params, list(grads))

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if n_microbatches == 1:
            loss, grads = value_and_grad(params, tokens, labels)
        else:
            B = tokens.shape[0]
            if B % n_microbatches:
                raise ValueError(f"batch {B} not divisible by {n_microbatches} microbatches")
            loss, grads = 0.0, None
            for t, lab in zip(tokens.chunk(n_microbatches), labels.chunk(n_microbatches)):
                mloss, g = value_and_grad(params, t, lab)
                g = map_tree(lambda x: x.float(), g)
                grads = g if grads is None else map_tree(torch.add, grads, g)
                loss = loss + mloss
            loss = loss / n_microbatches
            grads = map_tree(lambda g: g / n_microbatches, grads)

        lr_scale = cosine_schedule(opt_state["count"], warmup=opt.warmup)
        params, opt_state, om = adamw_update(grads, opt_state, params, opt, lr_scale)
        metrics = {"loss": loss, "grad_norm": om["grad_norm"], "lr_scale": lr_scale}
        return params, opt_state, metrics

    return train_step


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """Uniform random tokens (a data-pipeline stand-in) drawn from a
    ``torch.Generator`` seeded with ``seed``, labels the tokens shifted by
    one (rolled). Torch cannot reproduce JAX's threefry draws: the same
    seed gives other tokens than ``repro.runtime.train.synthetic_batch``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
