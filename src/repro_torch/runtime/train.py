"""Training step: loss + grads + AdamW, with microbatch accumulation.

``build_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, the port of ``repro.runtime.train``. The step is a
pure function of its inputs: gradients are taken with respect to detached
views of the parameters, and ``adamw_update`` returns new tensors, so a
step that the engine runs twice on the same state gives the same result
and leaves that state as it was. Microbatches (the reference's
``lax.scan``) are a Python loop that sums fp32 gradients; only one
microbatch's activations are alive at a time. The encoder-decoder's batch
also carries its frames, ``enc_embeds``, split into microbatches with the
tokens.

Under a profiler the step records ``tracing`` spans: ``train.step`` around
it, per microbatch ``train.forward`` (the loss), ``train.backward``
(``autograd.grad``) and, with microbatches, ``train.grad_accum`` (the fp32
cast and sum, the last one also the ``/ n``), then ``train.optimizer`` (the
schedule and ``adamw_update``, with ``fused``: the leaves the AdamW kernel
updated); the step, the accumulation and the optimizer also on the device's
timeline.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tracing
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, resolve_device
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import fused_leaves
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.runtime import sharding as sh
from repro_torch.tree import leaves, map_tree, unflatten


def build_train_step(cfg: ModelConfig, opt: AdamWConfig, n_microbatches: int = 1):
    """The train step of ``cfg`` (every model ``model.check_supported``
    takes) under ``opt``; ``batch`` = {"tokens", "labels"}: (B, S) integer
    tensors, B divisible by ``n_microbatches``, and for the encoder-decoder
    "enc_embeds" (B, F, d). Metrics are 0-d tensors: loss, grad_norm,
    lr_scale."""
    M.check_supported(cfg)

    def value_and_grad(params, tokens, labels, enc):
        with torch.enable_grad():
            p = map_tree(lambda t: t.detach().requires_grad_(), params)
            with tracing.span("train.forward"):
                loss = M.loss_fn(p, cfg, tokens, labels, enc)
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves(p))
        # on DTensors each gradient is placed as its parameter (a data-parallel
        # Partial sum reduced, FSDP's reduce-scattered), as the reference's are
        grads = [sh.settle(g, w) for g, w in zip(grads, leaves(params), strict=True)]
        return loss.detach(), unflatten(params, grads)

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        with tracing.span("train.step", device=tokens.device):
            return _train_step(params, opt_state, tokens, labels, batch.get("enc_embeds"))

    def _train_step(params, opt_state, tokens, labels, enc):
        dev = tokens.device
        if n_microbatches == 1:
            loss, grads = value_and_grad(params, tokens, labels, enc)
        else:
            B = tokens.shape[0]
            if B % n_microbatches:
                raise ValueError(f"batch {B} not divisible by {n_microbatches} microbatches")
            split = [x.chunk(n_microbatches) for x in (tokens, labels)]
            split.append([None] * n_microbatches if enc is None else enc.chunk(n_microbatches))
            loss, grads = 0.0, None
            for i, (t, lab, e) in enumerate(zip(*split)):
                mloss, g = value_and_grad(params, t, lab, e)
                with tracing.span("train.grad_accum", device=dev):
                    g = map_tree(lambda x: x.float(), g)
                    grads = g if grads is None else map_tree(torch.add, grads, g)
                    loss = loss + mloss
                    if i == n_microbatches - 1:
                        loss = loss / n_microbatches
                        grads = map_tree(lambda g: g / n_microbatches, grads)

        with tracing.span("train.optimizer", device=dev) as sp:
            lr_scale = cosine_schedule(opt_state["count"], warmup=opt.warmup)
            params, opt_state, om = adamw_update(grads, opt_state, params, opt, lr_scale)
            if sp.recording:
                sp.set(fused=fused_leaves(params))
        metrics = {"loss": loss, "grad_norm": om["grad_norm"], "lr_scale": lr_scale}
        return params, opt_state, metrics

    return train_step


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """Uniform random tokens (a data-pipeline stand-in) drawn from a
    ``torch.Generator`` seeded with ``seed``, labels the tokens shifted by
    one (rolled); for the encoder-decoder also standard normal frames
    ``enc_embeds`` (batch, enc_frames, d) in the model dtype, drawn after
    the tokens from the same generator. Torch cannot reproduce JAX's
    threefry draws: the same seed gives other tokens and frames than
    ``repro.runtime.train.synthetic_batch``, which also draws its frames
    from the very key of its tokens (a quirk not copied here). On
    ``device="meta"`` it allocates nothing: the reference's ``abstract=True``
    batch, for a dry run."""
    dev = resolve_device(device)
    # a meta batch (a dry run's) is shapes only: its draws need a generator, which meta lacks
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    out = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.enc_dec:
        out["enc_embeds"] = torch.randn((batch, cfg.enc_frames, cfg.d_model), generator=gen,
                                        device=dev).to(dtype_of(cfg))
    return out
