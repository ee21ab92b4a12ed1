"""The latent-attention serving cell's own files on the CPU:
``kinds/serve_mla.py`` through a whole run at a tiny size, sound and with
each fault the calibration plants; its weight cut; the arithmetic of
``arith_mla.py`` against the program's own tree; and the new readers on
hand-built records."""
from __future__ import annotations

import contextlib
import copy
import time

import pytest
import torch

from portbench import arith_mla as A
from portbench import calibrate as K
from portbench import harness as H
from portbench.kinds import serve_mla as D
from portbench.run import result

CPU = torch.device("cpu")
CELL = "deepseek_v3.serve_b256"
FULL_WIDTH = 7168      # DeepSeek-V3's d_model: the tiny head is drawn to give its logits' spread


def tiny_config(**kw) -> dict:
    c = copy.deepcopy(H.read_json(H.HERE / "configs" / "deepseek_v3.json"))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
             kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             n_routed_experts=32, n_experts=8, num_experts_per_tok=8, n_group=8, topk_group=4,
             moe_intermediate_size=32, intermediate_size=96, num_hidden_layers=4,
             first_k_dense_replace=1, vocab_size=128)
    c.update(kw)
    return c


def tiny_cell(**traffic) -> dict:
    cell = H.cell(CELL)
    cell["config"] = tiny_config()
    cell["traffic"].update(traffic)
    return cell


def test_weights_cut_to_the_held_experts_and_no_more():
    c = tiny_config()
    p = D.make_params(c, D.model_config(c), 2**31 + 5, CPU)
    dense, moe = p["blocks"][0]["mlp"], p["blocks"][1]["mlp"]
    assert set(dense) == {"w_gate", "w_up", "w_down"} and dense["w_up"].shape == (1, 64, 96)
    assert moe["router"].shape == (1, 64, 32) and moe["e_bias"].shape == (1, 32)
    assert moe["w_gate"].shape == (1, 8, 64, 32) and moe["w_down"].shape == (1, 8, 32, 64)
    assert moe["shared"]["w_up"].shape == (1, 64, 32)
    assert 0.5e-3 < moe["e_bias"].std().item() < 2e-3
    assert (p["blocks"][2]["mixer"]["q_norm"]["scale"] == 1).all()
    from repro_torch.tree import leaves

    again = D.make_params(c, D.model_config(c), 2**31 + 5, CPU)
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(again)))


def test_param_bytes_are_the_program_trees():
    from repro_torch.tree import leaves

    c = tiny_config(dtype="bfloat16")
    p = D.make_params(c, D.model_config(c), 7, CPU)
    held = sum(t.numel() * t.element_size() for t in leaves(p)) - p["embed"].numel() * 2
    assert A.param_bytes(c) == held


def test_published_sizes():
    c = H.read_json(H.HERE / "configs" / "deepseek_v3.json")
    assert A.mla_params(c) == 187_105_280
    assert A.cache_bytes_per_token(c) == 1152
    assert 39.0e9 < A.param_bytes(c) < 39.6e9
    # a step at batch 256 is bound by its bytes: 11.81 ms at the first, 11.99 at the 63rd
    assert 11.8e-3 < A.decode_step_bound_s(c, 256, 0) < A.decode_step_bound_s(c, 256, 62) < 12e-3
    assert A.attend_bytes(c, 256, 64) == 256 * 64 * 1152
    assert A.attend_flops(c, 256, 64) == 2 * 256 * 128 * 64 * (576 + 512)


FAULTS = {
    "sound": (contextlib.nullcontext, None),
    "cache_unchanged": (K.cache_unchanged, None),
    "half_batch": (contextlib.nullcontext, K.half_served),
    "token_altered": (contextlib.nullcontext, "altered"),
}


@pytest.fixture
def full_spread_logits(monkeypatch):
    """The tiny model's head drawn wider, so that its logits spread as the full
    model's do (0.02·√7168) and the cell's limit, set in logits, applies."""
    rule = H._init_rule

    def wide_head(path, shape):
        kind, val = rule(path, shape)
        if path[-1] == "['lm_head']":
            val *= (FULL_WIDTH / shape[-2]) ** 0.5
        return kind, val

    monkeypatch.setattr(H, "_init_rule", wide_head)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_serving_fault(fault, full_spread_logits):
    from repro_torch.launch.serve import serve

    ctx, wrap = FAULTS[fault]
    cell = tiny_cell(batch=8, prompt_len=4, gen_len=6, checked_jobs=2)
    serve_fn = (K.token_altered(serve, cell["config"]["vocab_size"]) if wrap == "altered"
                else wrap(serve) if wrap else None)
    with ctx():
        rec = D.run(cell, 2**31 + 23, 0.5, False, CPU, time.perf_counter(), serve_fn)
    assert rec["kind"] == "serve" and rec["steps_per_job"] == 9
    rec["device"] = {"platform": "gpu"}
    out = result(cell, rec, trace=False)
    assert out["correct"] is (fault == "sound"), out["checks"]


def span(i, name, device_ms=None, **attrs):
    return {"id": i, "name": name, "parent": None, "job": 1, "start_ns": 0, "end_ns": 1,
            "device_ms": device_ms, "attrs": attrs}


def test_readers_on_hand_built_records(monkeypatch):
    from repro_torch import tracing

    c = H.read_json(H.HERE / "configs" / "deepseek_v3.json")
    tr = H.read_json(H.HERE / "traffic" / "serve_mla_b256.json")
    rec = {"kind": "serve", "config": c, "traffic": tr, "trace": {"kernels": 1}, "jobs": 10,
           "window_s": 30.0, "steps_per_job": 63}
    spans = [span(1, "serve.prompt", 400.0), span(2, "serve.generate", 1200.0),
             span(3, "mla", 100.0), span(4, "mla", 60.0),
             span(5, "mla.attend", 0.05, pos=63, batch=256),
             span(6, "mla.attend", 0.05, pos=0, batch=256)]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    assert H.reader("mla_share.serve")(rec) == pytest.approx(10.0)
    bound = A.attend_bound_s(c, 256, 64) + A.attend_bound_s(c, 256, 1)
    assert H.reader("mla_attend_roofline.serve")(rec) == pytest.approx(100 * bound / 1e-4)
    per_job = sum(A.decode_step_bound_s(c, 256, pos) for pos in range(63))
    assert H.reader("mfu_mla.serve")(rec) == pytest.approx(100 * 10 * per_job / 30.0)
    jamba = dict(rec, config=H.read_json(H.HERE / "configs" / "jamba_1_5_large_398b.json"))
    assert H.reader("mfu_mla.serve")(jamba) is None
    assert H.reader("mla_attend_roofline.serve")(jamba) is None
    monkeypatch.setattr(tracing, "spans", lambda: spans[:2])
    assert H.reader("mla_share.serve")(rec) is None
    assert H.reader("mla_attend_roofline.serve")(rec) is None
    assert H.reader("mfu_mla.serve")(dict(rec, kind="train")) is None
