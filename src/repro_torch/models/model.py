"""The LM in PyTorch: init / forward / cache / decode.

Port of ``repro.models.model`` for blocks whose mixer is ``attn``,
``mamba``, ``mlstm`` or ``slstm`` (and ``mla``, which the JAX package
lacks) and whose MLP is ``dense``, ``moe`` or absent: the ``attn+dense``
decoders (smollm, llama3, qwen2, nemotron, chameleon), mixtral's ``attn+moe``
blocks (top-k experts with capacity, a sliding window whose decode cache
rotates), DeepSeek-V3's ``mla+dense`` and
``mla+moe`` blocks (latent attention, ``models/mla.py``, and DeepSeekMoE's
grouped sigmoid router with a shared expert; the block pattern spells out
the leading dense layers, one repeat), jamba's interleave of
``mamba+dense`` / ``mamba+moe`` blocks with one ``attn+dense`` block per
eight, xLSTM's alternating ``mlstm`` / ``slstm`` blocks, and whisper's
encoder-decoder (``cfg.enc_dec``: a non-causal encoder over precomputed
frame embeddings, decoder blocks with cross-attention to its output,
learned decoder positions and no RoPE). Parameters keep the reference's
pytree as plain dictionaries: per pattern position, each leaf stacked over
``n_repeats`` along a leading axis (the encoder's over ``n_enc_layers``).
``jax.lax.scan`` over the stack becomes a Python loop over the repeats.

``abstract_params``, ``model_specs`` and ``cache_specs`` are the dry run's
trees (``launch/dryrun.py``): the parameters as meta tensors, nothing
allocated, and the reference's logical-axis specs of the parameters and
the decode cache, leaf for leaf.

The encoder-decoder's decode reads a cross cache that ``prefill_cross``
fills from the encoder once per request. The reference allocates that
cache but never writes it (its decode attends over zeros); filling it is
what makes decode equal the reference's own ``forward``.

``loss_fn`` trains every ported block: attention (self and cross) and
mLSTM through their kernels' autograd Functions, mamba, sLSTM's time loop
and the MoE MLP through autograd. With ``cfg.remat`` set, ``forward`` wraps
each superblock (one repeat of the whole block pattern) and ``encode`` each
encoder block in non-reentrant ``torch.utils.checkpoint``, as the reference
wraps them in ``jax.checkpoint``: only their inputs are kept, and the
backward runs each one's forward again.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import mla, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.deepseek_config import MLAConfig
from repro_torch.models.layers import (
    EMBED,
    HEADS,
    INNER,
    KV,
    LAYERS,
    STATE,
    VOCAB,
    Params,
    attention,
    attention_cross_decode,
    attention_decode,
    cross_kv,
    dtype_of,
    embed,
    init_attention,
    init_mlp,
    init_moe,
    init_rmsnorm,
    mlp,
    moe_mlp,
    resolve_device,
    rmsnorm,
    specs_attention,
    specs_mlp,
    specs_moe,
    specs_rmsnorm,
)
from repro_torch.runtime import sharding as sh
from repro_torch.tree import is_spec, map_tree

_MIXERS = ("attn", "mamba", "mlstm", "slstm", "mla")
_MLPS = ("dense", "moe", None)
MAX_ABS_POS = 32768  # learned-position table of the encoder-decoder's decoder


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every block's mixer is ported
    (``attn``, ``mamba``, ``mlstm``, ``slstm``, and ``mla`` with an
    ``MLAConfig``) and its MLP is ``dense``, ``moe`` or absent. Every such
    block serves; all but ``mla`` train."""
    for entry in cfg.block_pattern:
        mixer, mlp_kind = cfg.mixer_of(entry), cfg.mlp_of(entry)
        if mixer == "mla" and not isinstance(cfg, MLAConfig):
            raise NotImplementedError(f"{cfg.name}: block {entry!r} needs an MLAConfig, "
                                      "which carries latent attention's widths")
        for part, ported in ((mixer, _MIXERS), (mlp_kind, _MLPS)):
            if part not in ported:
                raise NotImplementedError(
                    f"{cfg.name}: block {entry!r} has a {part!r} part, which the port "
                    f"does not build (mixers {_MIXERS}, MLPs {_MLPS})")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_INIT_MIXER = {"attn": init_attention, "mamba": ssm.init_mamba, "mlstm": ssm.init_mlstm,
               "slstm": ssm.init_slstm, "mla": mla.init_mla}


def _init_block(gen: torch.Generator, entry: str, cfg: ModelConfig,
                cross: bool = False) -> Params:
    dev = gen.device
    p = {"norm1": init_rmsnorm(cfg, dev), "mixer": _INIT_MIXER[cfg.mixer_of(entry)](gen, cfg)}
    mlp_kind = cfg.mlp_of(entry)
    if mlp_kind is not None:
        p["norm2"] = init_rmsnorm(cfg, dev)
        p["mlp"] = init_moe(gen, cfg) if mlp_kind == "moe" else init_mlp(gen, cfg)
    if cross:
        p["cross_norm"] = init_rmsnorm(cfg, dev)
        p["cross"] = init_attention(gen, cfg, cross=True)
    return p


def _stack(trees: list[Params]) -> Params:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device = "cuda") -> Params:
    """Random parameters at the reference's scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``. The
    encoder-decoder adds ``enc_blocks`` (``attn+dense`` stacked over
    ``n_enc_layers``), ``enc_norm`` and ``dec_pos`` (MAX_ABS_POS, d), and
    its decoder blocks ``cross_norm`` and ``cross``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = dtype_of(cfg)
    p: Params = {"embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                       device=dev) * 0.02).to(dt)}
    p["blocks"] = [_stack([_init_block(gen, entry, cfg, cross=cfg.enc_dec)
                           for _ in range(cfg.n_repeats)])
                   for entry in cfg.block_pattern]
    if cfg.enc_dec:
        p["enc_blocks"] = _stack([_init_block(gen, "attn+dense", cfg)
                                  for _ in range(cfg.n_enc_layers)])
        p["enc_norm"] = init_rmsnorm(cfg, dev)
        p["dec_pos"] = (torch.randn((MAX_ABS_POS, cfg.d_model), generator=gen,
                                    device=dev) * 0.02).to(dt)
    p["final_norm"] = init_rmsnorm(cfg, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                                    device=dev) * 0.02).to(dt)
    return p


def abstract_params(cfg: ModelConfig) -> Params:
    """``init_model``'s tree as meta tensors of its shapes, dtypes and
    strides: nothing is allocated. ``init_model`` runs under
    ``FakeTensorMode`` (its draws come from a CPU generator, and a meta
    device has none)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_model(cfg, device="cpu")
    return map_tree(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                  device="meta"), fake)


_SPECS_MIXER = {"attn": specs_attention, "mamba": ssm.specs_mamba, "mlstm": ssm.specs_mlstm,
                "slstm": ssm.specs_slstm, "mla": mla.specs_mla}


def _block_specs(entry: str, cfg: ModelConfig, cross: bool = False) -> Params:
    s = {"norm1": specs_rmsnorm(cfg), "mixer": _SPECS_MIXER[cfg.mixer_of(entry)](cfg)}
    mlp_kind = cfg.mlp_of(entry)
    if mlp_kind is not None:
        s["norm2"] = specs_rmsnorm(cfg)
        s["mlp"] = specs_moe(cfg) if mlp_kind == "moe" else specs_mlp(cfg)
    if cross:
        s["cross_norm"] = specs_rmsnorm(cfg)
        s["cross"] = specs_attention(cfg, cross=True)
    return s


def _stack_specs(spec: Params) -> Params:
    """Prepend the layers axis to every leaf spec."""
    return map_tree(lambda s: (LAYERS, *s), spec, is_leaf=is_spec)


def model_specs(cfg: ModelConfig) -> Params:
    """The reference's logical-axis spec tree, paralleling ``init_model``'s:
    at each leaf a tuple of axis names (``models.layers``), one per dimension,
    ``layers`` first on every stacked leaf."""
    check_supported(cfg)
    s: Params = {"embed": (VOCAB, EMBED)}
    s["blocks"] = [_stack_specs(_block_specs(entry, cfg, cross=cfg.enc_dec))
                   for entry in cfg.block_pattern]
    if cfg.enc_dec:
        s["enc_blocks"] = _stack_specs(_block_specs("attn+dense", cfg))
        s["enc_norm"] = specs_rmsnorm(cfg)
        s["dec_pos"] = (None, EMBED)
    s["final_norm"] = specs_rmsnorm(cfg)
    if not cfg.tie_embeddings:
        s["lm_head"] = (EMBED, VOCAB)
    return s


def _layers(block: Params, n: int) -> list[Params]:
    """All ``n`` repeats of a stacked block, each leaf split by one
    ``torch.unbind`` (views, no copies). Under autograd the repeats' gradients then
    come back as one stack per leaf; indexing each repeat instead would
    return each gradient as a zero-filled full stack, and summing those
    costs ``n`` times the stack's bytes."""
    split = {k: (_layers(v, n) if isinstance(v, dict) else torch.unbind(v))
             for k, v in block.items()}
    return [{k: v[r] for k, v in split.items()} for r in range(n)]


def _head(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_fwd(bp: Params, x: torch.Tensor, entry: str, cfg: ModelConfig,
               enc_out: torch.Tensor | None = None) -> torch.Tensor:
    """One block: the mixer's residual, then with ``enc_out`` the
    cross-attention's, then the MLP's."""
    mixer = cfg.mixer_of(entry)
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        y = attention(bp["mixer"], h, cfg, causal=True, use_rope=not cfg.enc_dec)
    elif mixer == "mamba":
        y, _ = ssm.mamba(bp["mixer"], h, cfg)
    elif mixer == "mlstm":
        y, _ = ssm.mlstm(bp["mixer"], h, cfg)
    elif mixer == "mla":
        y = mla.mla(bp["mixer"], h, cfg)
    else:
        y, _ = ssm.slstm(bp["mixer"], h, cfg)
    x = x + sh.settle(y, x)
    if enc_out is not None:
        h = rmsnorm(bp["cross_norm"], x, cfg.norm_eps)
        x = x + sh.settle(attention(bp["cross"], h, cfg, causal=False, xkv=enc_out,
                                    use_rope=False), x)
    return _mlp_residual(bp, x, entry, cfg)


def _enc_block_fwd(bp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One encoder block: non-causal self-attention without RoPE, then the
    dense MLP, each a pre-norm residual."""
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    x = x + sh.settle(attention(bp["mixer"], h, cfg, causal=False, use_rope=False), x)
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + sh.settle(mlp(bp["mlp"], h, cfg), x)


def _mlp_residual(bp: Params, x: torch.Tensor, entry: str, cfg: ModelConfig) -> torch.Tensor:
    """``x`` plus the block's MLP (dense or MoE) of its normed self, if any."""
    mlp_kind = cfg.mlp_of(entry)
    if mlp_kind is None:
        return x
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    y = moe_mlp(bp["mlp"], h, cfg) if mlp_kind == "moe" else mlp(bp["mlp"], h, cfg)
    return x + sh.settle(y, x)


def _superblock(x: torch.Tensor, bps: list[Params], cfg: ModelConfig,
                enc_out: torch.Tensor | None = None) -> torch.Tensor:
    """One repeat of the whole block pattern, in order (Jamba's interleave)."""
    for bp, entry in zip(bps, cfg.block_pattern):
        x = _block_fwd(bp, x, entry, cfg, enc_out)
    return x


def encode(p: Params, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over precomputed (stub frontend) frame embeddings
    (B, F, d) in the model dtype -> (B, F, d). Under ``cfg.remat`` and
    autograd each block is recomputed in the backward, as ``forward``'s
    superblocks."""
    remat = cfg.remat and torch.is_grad_enabled()
    x = enc_embeds
    for bp in _layers(p["enc_blocks"], cfg.n_enc_layers):
        if remat:
            x = checkpoint(_enc_block_fwd, bp, x, cfg, use_reentrant=False)
        else:
            x = _enc_block_fwd(bp, x, cfg)
    return rmsnorm(p["enc_norm"], x, cfg.norm_eps)


def _encoded(p: Params, cfg: ModelConfig, enc_embeds: torch.Tensor | None) -> torch.Tensor:
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder needs enc_embeds (B, "
                         f"{cfg.enc_frames}, {cfg.d_model})")
    return encode(p, cfg, enc_embeds.to(dtype_of(cfg)))


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            enc_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token logits for training / prefill: (B, S) ints -> (B, S, vocab) fp32.
    The encoder-decoder also takes the frame embeddings ``enc_embeds``
    (B, F, d), cast to the model dtype and encoded, and adds ``dec_pos[:S]``
    to the token embeddings. Under ``cfg.remat`` and autograd each
    superblock is recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant)."""
    x = embed(p["embed"], tokens).to(dtype_of(cfg))
    enc_out = None
    if cfg.enc_dec:
        enc_out = _encoded(p, cfg, enc_embeds)
        x = x + sh.reduced_grad(p["dec_pos"][:tokens.shape[1]])[None]
    layers = [_layers(block, cfg.n_repeats) for block in p["blocks"]]
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(cfg.n_repeats):
        bps = [stack[r] for stack in layers]
        if remat:
            x = checkpoint(_superblock, x, bps, cfg, enc_out, use_reentrant=False)
        else:
            x = _superblock(x, bps, cfg, enc_out)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return sh.matmul(x, _head(p, cfg)).float()


def loss_fn(p: Params, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
            enc_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy over fp32 logits plus the z-loss
    ``1e-4 · mean(logz²)`` (a 0-d fp32 tensor), as the reference's. The
    encoder-decoder needs its frames ``enc_embeds`` (B, F, d), as in
    ``forward``."""
    check_supported(cfg)
    logits = forward(p, cfg, tokens, enc_embeds)
    if sh.is_dtensor(logits):
        logz, gold = _sharded_logz_gold(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    ce = (logz - gold).mean()
    zloss = 1e-4 * torch.square(logz).mean()   # logit drift regularizer
    return ce + zloss


def _sharded_logz_gold(logits: torch.Tensor, labels: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp over the vocab, the label's logit) of DTensor logits
    (B, S, vocab), each batch-sharded as the logits. Where the vocab is
    sharded (over more than one device) it is Megatron's vocab-parallel
    cross entropy: each device reduces its own slice (the max, the sum of
    exponentials, the label's logit where it holds it) and the slices'
    results are reduced across devices, so no device gathers the logits;
    elsewhere each device takes the plain ``loss_fn`` terms of its rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = logits.device_mesh
    if not sh.is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, sh.replicated(mesh), run_check=False)
    vocab_dim = next((i for i, p in enumerate(logits.placements)
                      if p.is_shard(2) and mesh.shape[i] > 1), None)
    lp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in logits.placements)
    if vocab_dim is None:
        def plain(x, lab):
            return (torch.logsumexp(x, dim=-1),
                    torch.gather(x, -1, lab.long()[..., None]).squeeze(-1))
        return sh.run_local(plain, (logits, labels), (lp, lp), (lp, lp))

    xp = tuple(Shard(2) if i == vocab_dim else p for i, p in enumerate(lp))
    outp = tuple(Partial() if i == vocab_dim else p for i, p in enumerate(lp))
    logz = sh.run_local(lambda x: _VocabLogsumexp.apply(x, (mesh, vocab_dim)), (logits,),
                        (xp,), lp)

    def local(x, lab):
        lab = lab.long()
        first = mesh.get_local_rank(vocab_dim) * x.shape[-1]
        mine = (lab >= first) & (lab < first + x.shape[-1])
        got = torch.gather(x, -1, torch.where(mine, lab - first, 0)[..., None]).squeeze(-1)
        return torch.where(mine, got, 0.0)

    gold = sh.run_local(local, (logits, labels), (xp, lp), outp)
    return logz, gold.redistribute(mesh, lp)


class _VocabLogsumexp(torch.autograd.Function):
    """logsumexp over the last dimension of a device's vocab slice (B, S, V/n)
    whose other slices lie on the devices of ``group`` (a mesh and one of
    its dimensions): the slices' maxima and sums of exponentials are
    all-reduced in the forward; the backward, softmax times the gradient,
    needs nothing from the other slices."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        top = funcol.all_reduce(x.amax(dim=-1), "max", group)
        total = funcol.all_reduce(torch.exp(x - top[..., None]).sum(dim=-1), "sum", group)
        logz = top + torch.log(total)
        ctx.save_for_backward(x, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        x, logz = ctx.saved_tensors
        return g[..., None] * torch.exp(x - logz[..., None]), None


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: str | torch.device = "cuda") -> list[dict[str, torch.Tensor]]:
    """Zeroed decode state: one entry per pattern position, each leaf stacked
    over n_repeats. Attention: ``{"k", "v"}`` (R, batch, S, K, hd) in the
    model dtype, S = min(seq_len, sliding_window); mamba: ``{"conv", "ssm"}``
    (R, batch, w-1, d_inner) in the model dtype and (R, batch, d_inner, N)
    fp32; mLSTM: ``{"C", "n"}`` (R, batch, H, hd, hd) and (R, batch, H, hd)
    fp32; sLSTM: ``{"c", "h"}`` (R, batch, d) fp32; latent attention:
    ``{"ckv", "kpe"}`` (R, batch, seq_len, kv_lora_rank) and (R, batch,
    seq_len, qk_rope_dim) in the model dtype. The encoder-decoder adds
    ``{"cross_k", "cross_v"}`` (R, batch, enc_frames, K, hd) in the model
    dtype to every entry, for ``prefill_cross`` to fill."""
    check_supported(cfg)
    dev = resolve_device(device)
    R = cfg.n_repeats

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = []
    for entry in cfg.block_pattern:
        mixer = cfg.mixer_of(entry)
        if mixer == "attn":
            shape = (R, batch, _attn_cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
            cache.append({"k": zeros(*shape, dtype=dtype_of(cfg)),
                          "v": zeros(*shape, dtype=dtype_of(cfg))})
        elif mixer == "mamba":
            cache.append({"conv": zeros(R, batch, cfg.ssm_conv_width - 1, cfg.d_inner,
                                        dtype=dtype_of(cfg)),
                          "ssm": zeros(R, batch, cfg.d_inner, cfg.ssm_state_dim)})
        elif mixer == "mlstm":
            _, H, hd = ssm.mlstm_dims(cfg)
            cache.append({"C": zeros(R, batch, H, hd, hd), "n": zeros(R, batch, H, hd)})
        elif mixer == "mla":
            cache.append({"ckv": zeros(R, batch, seq_len, cfg.kv_lora_rank, dtype=dtype_of(cfg)),
                          "kpe": zeros(R, batch, seq_len, cfg.qk_rope_dim, dtype=dtype_of(cfg))})
        else:
            cache.append({"c": zeros(R, batch, cfg.d_model), "h": zeros(R, batch, cfg.d_model)})
        if cfg.enc_dec:
            shape = (R, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
            cache[-1]["cross_k"] = zeros(*shape, dtype=dtype_of(cfg))
            cache[-1]["cross_v"] = zeros(*shape, dtype=dtype_of(cfg))
    return cache


def cache_specs(cfg: ModelConfig) -> list[dict[str, tuple]]:
    """Logical-axis specs paralleling ``init_cache``'s tree, the reference's:
    ``batch`` and ``kv_seq`` name the cache's batch and sequence axes."""
    specs = []
    for entry in cfg.block_pattern:
        mixer = cfg.mixer_of(entry)
        if mixer == "attn":
            c = {"k": (LAYERS, "batch", "kv_seq", KV, None),
                 "v": (LAYERS, "batch", "kv_seq", KV, None)}
        elif mixer == "mamba":
            c = {"conv": (LAYERS, "batch", None, INNER), "ssm": (LAYERS, "batch", INNER, STATE)}
        elif mixer == "mlstm":
            c = {"C": (LAYERS, "batch", HEADS, None, None), "n": (LAYERS, "batch", HEADS, None)}
        elif mixer == "mla":
            c = {"ckv": (LAYERS, "batch", "kv_seq", None), "kpe": (LAYERS, "batch", "kv_seq", None)}
        else:
            c = {"c": (LAYERS, "batch", EMBED), "h": (LAYERS, "batch", EMBED)}
        if cfg.enc_dec:
            c["cross_k"] = (LAYERS, "batch", None, KV, None)
            c["cross_v"] = (LAYERS, "batch", None, KV, None)
        specs.append(c)
    return specs


def prefill_cross(p: Params, cfg: ModelConfig, cache: list[dict[str, torch.Tensor]],
                  enc_embeds: torch.Tensor) -> list[dict[str, torch.Tensor]]:
    """Fill the encoder-decoder's cross cache in place: encode the frame
    embeddings ``enc_embeds`` (B, F, d) once, cast to the model dtype, and
    write each decoder layer's ``enc_out @ wk`` and ``enc_out @ wv`` into its
    ``cross_k`` / ``cross_v`` slot. Returns ``cache`` itself."""
    enc_out = _encoded(p, cfg, enc_embeds)
    for block, c in zip(p["blocks"], cache):
        for r, bp in enumerate(_layers(block["cross"], cfg.n_repeats)):
            k, v = cross_kv(bp, enc_out, cfg)
            c["cross_k"][r].copy_(k)
            c["cross_v"][r].copy_(v)
    return cache


def _block_decode(bp: Params, c: dict[str, torch.Tensor], r: int, x: torch.Tensor,
                  pos: int, entry: str, cfg: ModelConfig) -> torch.Tensor:
    """One block of one decode step on repeat ``r``; updates ``c`` in place."""
    mixer = cfg.mixer_of(entry)
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        rotating = cfg.sliding_window is not None and c["k"].shape[2] <= cfg.sliding_window
        y, _, _ = attention_decode(bp["mixer"], h, c["k"][r], c["v"][r], pos, cfg,
                                   use_rope=not cfg.enc_dec, rotating=rotating)
    elif mixer == "mamba":
        y, (conv, st) = ssm.mamba(bp["mixer"], h, cfg, state=(c["conv"][r], c["ssm"][r]))
        c["conv"][r].copy_(conv)
        c["ssm"][r].copy_(st)
    elif mixer == "mlstm":
        y, (C, n) = ssm.mlstm_decode_step(bp["mixer"], h, cfg, (c["C"][r], c["n"][r]))
        c["C"][r].copy_(C)
        c["n"][r].copy_(n)
    elif mixer == "mla":
        y = mla.mla_decode(bp["mixer"], h, c["ckv"][r], c["kpe"][r], pos, cfg)
    else:
        y, (cc, hh) = ssm.slstm(bp["mixer"], h, cfg, state=(c["c"][r], c["h"][r]))
        c["c"][r].copy_(cc)
        c["h"][r].copy_(hh)
    x = x + sh.settle(y, x)
    if cfg.enc_dec:
        h = rmsnorm(bp["cross_norm"], x, cfg.norm_eps)
        x = x + sh.settle(attention_cross_decode(bp["cross"], h, c["cross_k"][r],
                                                 c["cross_v"][r], cfg), x)
    return _mlp_residual(bp, x, entry, cfg)


def decode_step(
    p: Params,
    cfg: ModelConfig,
    cache: list[dict[str, Any]],
    token: torch.Tensor,        # (B,) ints: the newest token
    pos: int | torch.Tensor,    # its position (a 0-d device tensor: latent attention only)
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """One serving step: append ``token`` at ``pos`` and return next-token
    logits (B, vocab) fp32 and the cache. The cache is updated in place:
    attention writes the new key and value into its slot, the recurrent
    mixers copy their new state over the old (the returned list is
    ``cache`` itself). The encoder-decoder adds ``dec_pos[pos]`` and reads
    the cross cache that ``prefill_cross`` filled. A model whose every mixer
    is ``mla`` also takes ``pos`` as a 0-d int64 tensor on the device, read
    there only, so one CUDA graph of the step serves every position
    (``runtime.serve.DecodeGraph``)."""
    x = embed(p["embed"], token)[:, None, :].to(dtype_of(cfg))   # (B, 1, d)
    if cfg.enc_dec:
        x = x + p["dec_pos"][pos][None, None, :]
    layers = [_layers(block, cfg.n_repeats) for block in p["blocks"]]
    for r in range(cfg.n_repeats):
        for stack, c, entry in zip(layers, cache, cfg.block_pattern):
            x = _block_decode(stack[r], c, r, x, pos, entry, cfg)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return sh.matmul(x[:, 0, :], _head(p, cfg)).float(), cache
