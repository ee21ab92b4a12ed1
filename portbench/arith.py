"""The benchmark's yardstick: the card's peaks and the operations and bytes of
the work a cell asks for, computed from shapes alone.

Every formula here is frozen with the benchmark. The program's own FLOP
formulas (its kernel ops' ``register_flop_formula``) may change with the
program; these do not, so a later change cannot move a roofline share by
recounting its work.

Configurations are the dictionaries of ``portbench/configs/<name>.json``:
``d_model``, ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``vocab``,
``block_pattern``, ``n_layers``, ``n_experts`` (held on this card),
``router_experts``, ``top_k``, ``sliding_window``, ``ssm_state_dim``,
``ssm_conv_width``, ``ssm_expand``, ``dtype``.
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB, dense rates at the full 700 W (NVIDIA's data sheet).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def repeats(c: dict) -> int:
    return c["n_layers"] // len(c["block_pattern"])


def entries(c: dict) -> list[str]:
    """Every layer's block entry, in order (the pattern over its repeats)."""
    return list(c["block_pattern"]) * repeats(c)


def d_inner(c: dict) -> int:
    return c["ssm_expand"] * c["d_model"]


def dt_rank(c: dict) -> int:
    return max(1, c["d_model"] // 16)


def attention_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """Visible (query, key) pairs of one head: queries aligned to the last
    ``sq`` of ``skv`` keys, the causal mask and the sliding window applied."""
    if not causal:
        return sq * skv
    off = skv - sq
    total = 0
    for t in range(sq):
        visible = off + t + 1
        total += min(visible, window) if window else visible
    return total


# ---------------------------------------------------------------------------
# Parameter counts (matrix entries a token multiplies, by block part)
# ---------------------------------------------------------------------------

def mixer_params(c: dict, mixer: str) -> int:
    d, H, K, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    if mixer == "attn":
        return d * H * hd + 2 * d * K * hd + H * hd * d
    if mixer == "mamba":
        di, n, r = d_inner(c), c["ssm_state_dim"], dt_rank(c)
        return d * 2 * di + di * (r + 2 * n) + r * di + di * d
    raise ValueError(f"no parameter count for mixer {mixer!r}")


def expert_params(c: dict) -> int:
    return 3 * c["d_model"] * c["d_ff"]


def mlp_params_active(c: dict, mlp: str | None) -> int:
    """Matrix entries one token multiplies in the block's MLP: the router and
    ``top_k`` experts for an MoE MLP."""
    if mlp is None:
        return 0
    if mlp == "dense":
        return expert_params(c)
    return c["d_model"] * c["router_experts"] + c["top_k"] * expert_params(c)


def active_matmul_params(c: dict) -> int:
    """Matrix entries one token multiplies in a forward: every layer's mixer
    and MLP (``top_k`` experts) and the head; the embedding is a lookup."""
    total = c["d_model"] * c["vocab"]
    for e in entries(c):
        mixer, _, mlp = e.partition("+")
        total += mixer_params(c, mixer) + mlp_params_active(c, mlp or None)
    return total


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_model_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` x ``seq`` tokens: three
    forwards' worth (the backward at twice the forward), each 2 per matrix
    entry and token (``top_k`` experts a token) plus attention's 4·hd per
    visible pair and head. Recomputation under remat and the padding of the
    capacity dispatch are not the model's, so they are not counted."""
    tokens = batch * seq
    fwd = 2.0 * tokens * active_matmul_params(c)
    pairs = attention_pairs(seq, seq, True, c.get("sliding_window"))
    n_attn = sum(e.split("+")[0] == "attn" for e in entries(c))
    fwd += n_attn * 4.0 * batch * c["n_heads"] * c["head_dim"] * pairs
    return 3.0 * fwd


def flash_bound_s(c: dict, batch: int, seq: int, backward: bool) -> float:
    """The least time of one flash attention call (self-attention, causal,
    the config's window) on the card: the larger of its operations over the
    bf16 peak (forward 4·hd, backward 10·hd per visible pair and head) and
    its bytes over the HBM rate (forward: q, k, v read, the output written;
    backward: q, k, v, the output, its gradient and the rows' log-sum-exp
    read, dq, dk, dv written)."""
    H, K, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    e = DTYPE_BYTES[c["dtype"]]
    pairs = attention_pairs(seq, seq, True, c.get("sliding_window"))
    q = batch * seq * H * hd * e
    kv = batch * seq * K * hd * e
    if backward:
        flops = 10.0 * batch * H * hd * pairs
        nbytes = (q + 2 * kv + q + q + batch * H * seq * 4) + (q + 2 * kv)
    else:
        flops = 4.0 * batch * H * hd * pairs
        nbytes = q + 2 * kv + q
    return max(flops / PEAK_FLOPS[c["dtype"]], nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------------------
# Serving (one decode step of a batch)
# ---------------------------------------------------------------------------

def param_bytes(c: dict) -> int:
    """Bytes of every weight the card holds but the embedding table: norms'
    scales, the router and mamba's ``dt_bias``, ``A_log``, ``D`` in fp32,
    the rest in the model dtype; all held experts."""
    e = DTYPE_BYTES[c["dtype"]]
    d = c["d_model"]
    total = d * c["vocab"] * e + d * 4                       # head, final norm
    for ent in entries(c):
        mixer, _, mlp = ent.partition("+")
        total += d * 4                                       # norm1
        total += mixer_params(c, mixer) * e
        if mixer == "mamba":
            di, n = d_inner(c), c["ssm_state_dim"]
            total += c["ssm_conv_width"] * di * e + di * e   # conv_w, conv_b
            total += di * 4 + di * n * 4 + di * 4            # dt_bias, A_log, D
        if mlp:
            total += d * 4                                   # norm2
            if mlp == "dense":
                total += expert_params(c) * e
            else:
                total += d * c["router_experts"] * 4 + c["n_experts"] * expert_params(c) * e
    return total


def decode_attention_bytes(c: dict, batch: int, kv_len: int) -> int:
    """Bytes one decode attention call needs: the queries, ``kv_len`` cached
    keys and values of every sequence, the output."""
    e = DTYPE_BYTES[c["dtype"]]
    H, K, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    return 2 * batch * H * hd * e + 2 * batch * kv_len * K * hd * e


def decode_attention_bound_s(c: dict, batch: int, kv_len: int) -> float:
    flops = 4.0 * batch * c["n_heads"] * c["head_dim"] * kv_len
    return max(flops / PEAK_FLOPS[c["dtype"]],
               decode_attention_bytes(c, batch, kv_len) / PEAK_BYTES_PER_S)


def decode_step_bound_s(c: dict, batch: int, pos: int) -> float:
    """The least time of one decode step of ``batch`` sequences at position
    ``pos``: the larger of its operations over the peak (2 per matrix entry
    and token, ``top_k`` experts a token, attention's 4·hd per cached key and
    head) and its bytes over the HBM rate (every held weight read once, as
    every held expert is chosen at the batches this is used for; the
    token's embedding rows; the mamba states read and written; each
    attention layer's cache up to ``pos``, the new key and value written;
    the fp32 logits written)."""
    e = DTYPE_BYTES[c["dtype"]]
    d, V = c["d_model"], c["vocab"]
    flops = 2.0 * batch * active_matmul_params(c)
    nbytes = param_bytes(c) + batch * d * e + batch * V * 4
    for ent in entries(c):
        mixer = ent.split("+")[0]
        if mixer == "attn":
            flops += 4.0 * batch * c["n_heads"] * c["head_dim"] * (pos + 1)
            nbytes += decode_attention_bytes(c, batch, pos + 1)
        elif mixer == "mamba":
            di, n, w = d_inner(c), c["ssm_state_dim"], c["ssm_conv_width"]
            nbytes += 2 * batch * (di * n * 4 + (w - 1) * di * e)
    return max(flops / PEAK_FLOPS[c["dtype"]], nbytes / PEAK_BYTES_PER_S)
