"""The yardstick of latent-attention serving cells: the operations and bytes of
a DeepSeek-V3 decode step and of its absorbed attention core, from the
configuration's shapes alone (the published ``config.json`` keys of
``portbench/configs/deepseek_v3.json``, ``n_experts`` held on this card, and
``dtype``). Frozen with the benchmark, as ``arith.py``; the card's peaks are
``arith.py``'s.

The decode step is the absorbed form the program runs: ``W_UK`` folded into
the query and ``W_UV`` into the output, so a token multiplies every entry of
``wkv_b`` once and attends over the cached latent and rotary key, one
``kv_lora_rank + qk_rope_head_dim`` wide kv head for all the query heads.
"""
from __future__ import annotations

from portbench.arith import DTYPE_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS


def mlps(c: dict) -> list[str]:
    """Every layer's MLP, in order: ``dense`` for the first
    ``first_k_dense_replace``, ``moe`` after."""
    k = c["first_k_dense_replace"]
    return ["dense"] * k + ["moe"] * (c["num_hidden_layers"] - k)


def mla_params(c: dict) -> int:
    """Matrix entries of one latent-attention layer: ``wq_a``, ``wq_b``,
    ``wkv_a``, ``wkv_b``, ``wo``."""
    d, H, qr, kr = (c["hidden_size"], c["num_attention_heads"], c["q_lora_rank"],
                    c["kv_lora_rank"])
    nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return d * qr + qr * H * (nope + rope) + d * (kr + rope) + kr * H * (nope + v) + H * v * d


def swiglu_params(c: dict, width: int) -> int:
    return 3 * c["hidden_size"] * width


def cache_bytes_per_token(c: dict) -> int:
    """A layer's cached bytes of one token: its normed latent and rotary key."""
    return (c["kv_lora_rank"] + c["qk_rope_head_dim"]) * DTYPE_BYTES[c["dtype"]]


def param_bytes(c: dict) -> int:
    """Bytes of every weight the card holds but the embedding table: norms'
    scales, the router and its correction bias in fp32, the rest in the model
    dtype; the held routed experts and the shared expert."""
    e = DTYPE_BYTES[c["dtype"]]
    d, E, f = c["hidden_size"], c["n_routed_experts"], c["moe_intermediate_size"]
    total = d * c["vocab_size"] * e + d * 4                          # head, final norm
    for mlp in mlps(c):
        total += 2 * d * 4 + (c["q_lora_rank"] + c["kv_lora_rank"]) * 4   # four norms
        total += mla_params(c) * e
        if mlp == "dense":
            total += swiglu_params(c, c["intermediate_size"]) * e
        else:
            total += (d * E + E) * 4
            total += (c["n_experts"] + c["n_shared_experts"]) * swiglu_params(c, f) * e
    return total


def attend_flops(c: dict, batch: int, kv_len: int) -> float:
    """The absorbed core of one layer: scores over the latent and rotary key
    (kv_lora_rank + rope a key) and the probabilities' sum of latents
    (kv_lora_rank), 2 per multiply-add, every head."""
    kr = c["kv_lora_rank"]
    return 2.0 * batch * c["num_attention_heads"] * kv_len * (kr + c["qk_rope_head_dim"] + kr)


def attend_bytes(c: dict, batch: int, kv_len: int) -> int:
    """The cache the core of one layer reads: ``kv_len`` tokens a sequence."""
    return batch * kv_len * cache_bytes_per_token(c)


def attend_bound_s(c: dict, batch: int, kv_len: int) -> float:
    return max(attend_flops(c, batch, kv_len) / PEAK_FLOPS[c["dtype"]],
               attend_bytes(c, batch, kv_len) / PEAK_BYTES_PER_S)


def decode_step_bound_s(c: dict, batch: int, pos: int) -> float:
    """The least time of one decode step of ``batch`` sequences at position
    ``pos``: the larger of its operations over the peak and its bytes over the
    HBM rate. Operations: 2 per matrix entry and token of attention's
    projections, the dense MLPs, the router, the shared expert and the head;
    the routed experts' for the assignments a held expert can expect,
    ``batch · num_experts_per_tok · n_experts / n_routed_experts`` a MoE
    layer; the core over ``pos + 1`` cached tokens. Bytes: every held weight
    read once, the tokens' embedding rows, each layer's cache up to ``pos``
    read and the new token's written, the fp32 logits written."""
    e = DTYPE_BYTES[c["dtype"]]
    d, V = c["hidden_size"], c["vocab_size"]
    E, f = c["n_routed_experts"], c["moe_intermediate_size"]
    kept = batch * c["num_experts_per_tok"] * c["n_experts"] / E
    flops = 2.0 * batch * d * V
    nbytes = param_bytes(c) + batch * d * e + batch * V * 4
    for mlp in mlps(c):
        flops += 2.0 * batch * mla_params(c) + attend_flops(c, batch, pos + 1)
        if mlp == "dense":
            flops += 2.0 * batch * swiglu_params(c, c["intermediate_size"])
        else:
            flops += 2.0 * batch * (d * E + c["n_shared_experts"] * swiglu_params(c, f))
            flops += 2.0 * kept * swiglu_params(c, f)
        nbytes += attend_bytes(c, batch, pos + 1) + batch * cache_bytes_per_token(c)
    return max(flops / PEAK_FLOPS[c["dtype"]], nbytes / PEAK_BYTES_PER_S)
