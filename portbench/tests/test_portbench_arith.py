"""The frozen operation and byte counts against counts made by hand."""
from __future__ import annotations

import pytest

from portbench import arith
from portbench import harness as H


def mixtral():
    return H.read_json(H.HERE / "configs" / "mixtral_8x7b.json")


def jamba():
    return H.read_json(H.HERE / "configs" / "jamba_1_5_large_398b.json")


def test_attention_pairs_by_hand():
    assert arith.attention_pairs(4, 4, True, None) == 1 + 2 + 3 + 4
    assert arith.attention_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert arith.attention_pairs(3, 5, False, None) == 15
    assert arith.attention_pairs(2, 5, True, None) == 4 + 5     # queries at the last two keys


def test_mixtral_active_parameters_by_hand():
    d, f, V = 4096, 14336, 32000
    attn = d * 4096 + 2 * d * 1024 + 4096 * d
    moe = d * 8 + 2 * 3 * d * f
    assert arith.active_matmul_params(mixtral()) == attn + moe + d * V


def test_mixtral_train_flops_by_hand():
    B, S = 32, 512
    tokens = B * S
    per_token = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 4096 * 8 + 2 * 3 * 4096 * 14336 + 4096 * 32000
    attn = 4 * B * 32 * 128 * (S * (S + 1) // 2)       # window 4096 > S: causal pairs
    assert arith.train_model_flops(mixtral(), B, S) == pytest.approx(
        3 * (2 * tokens * per_token + attn), rel=1e-12)


def test_flash_bounds_by_hand():
    c = mixtral()
    B, S = 4, 512
    q, kv = B * S * 32 * 128 * 2, B * S * 8 * 128 * 2
    pairs = S * (S + 1) // 2
    fwd = max(4 * B * 32 * 128 * pairs / 989e12, (2 * q + 2 * kv) / 3.35e12)
    bwd = max(10 * B * 32 * 128 * pairs / 989e12,
              (3 * q + 2 * kv + B * 32 * S * 4 + q + 2 * kv) / 3.35e12)
    assert arith.flash_bound_s(c, B, S, backward=False) == pytest.approx(fwd, rel=1e-12)
    assert arith.flash_bound_s(c, B, S, backward=True) == pytest.approx(bwd, rel=1e-12)
    assert fwd == (2 * q + 2 * kv) / 3.35e12                  # bound by its bytes


def test_jamba_weight_bytes_by_hand():
    d, di, n, r, f, V = 8192, 16384, 16, 512, 24576, 65536
    mamba = (d * 2 * di + di * (r + 2 * n) + r * di + di * d) * 2 + 4 * di * 2 + di * 2 \
        + (di + di * n + di) * 4
    attn = (d * 64 * 128 + 2 * d * 8 * 128 + 64 * 128 * d) * 2
    dense = 3 * d * f * 2
    moe = d * 16 * 4 + 8 * 3 * d * f * 2
    norms = (8 + 8 + 1) * d * 4
    want = 7 * mamba + attn + 4 * dense + 4 * moe + norms + d * V * 2
    assert arith.param_bytes(jamba()) == want
    assert 50.7e9 < want < 50.8e9                       # the 50.75 GB the card holds


def test_decode_bound_is_its_bytes_at_batch_32():
    c = jamba()
    t = arith.decode_step_bound_s(c, 32, 30)
    assert t == pytest.approx(15.31e-3, rel=1e-3)
    e = 2
    attn = 2 * 32 * 64 * 128 * e + 2 * 32 * 31 * 8 * 128 * e
    assert arith.decode_attention_bytes(c, 32, 31) == attn
