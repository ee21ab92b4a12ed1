"""Serving cells of latent-attention models (DeepSeek-V3): the program's serving
entry, one engine job a request batch, as ``kinds/serve.py`` runs them.

What differs from ``kinds/serve.py`` is what the configuration holds:

- The configuration file keeps the model's published ``config.json`` keys
  (``num_hidden_layers``, ``kv_lora_rank``, ``n_group``, ...), and
  ``model_config`` builds the program's ``MLAConfig`` from them: the first
  ``first_k_dense_replace`` layers ``mla+dense``, the rest ``mla+moe``, spelt
  out as one repeat.
- ``make_params`` draws the weights as the harness's ``make_params`` does,
  from the same stream, with each MoE layer's routed experts cut to the
  ``n_experts`` held and the router, its correction bias ``e_bias`` (drawn
  at N(0, 1e-3)) and the shared expert whole.
- The plain reference is ``reference/mla_moe.py``.
- On the card the program replays its decode step as CUDA graphs that it
  keeps (``runtime.serve.decode_graph``), asked for here at set-up so that
  they are captured before the first job, and the traced stretches replay
  the pair that records the model's spans, captured after the window,
  before the profiler starts (``DecodeGraph.capture_traced``). Set-up ends
  with ``WARM_JOBS`` jobs: a fresh graph's first 130–190 replays ran up to
  4 % slower on an H100, for a cause not found (``PERF.md`` §7). As in
  ``kinds/train.py``, set-up's objects are then frozen out of the
  collector's walk and each job ends in a collection. The program's graphs
  are dropped before the reference runs.

The record is of kind ``serve``, so the serving readers read it. The number
compared is ``kinds/serve.py``'s: the mean, over every served token of a
sample of the window's jobs, of how far its float32 reference logit lies
below the reference's best at its position.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Any, Callable

import numpy as np
import torch

from portbench import harness as H
from portbench.kinds import serve as S
from portbench.reference import mla_moe as ref
from portbench.reference.lm import Precision
from portbench.trace import Stretch

E_BIAS_STD = 1e-3
WARM_JOBS = 5   # 315 replays


def model_config(c: dict):
    """The program's ``MLAConfig`` for configuration ``c`` (the published keys):
    its router over ``n_routed_experts``."""
    from repro_torch.models.deepseek_config import DeepSeekMoEConfig, MLAConfig, YarnRope

    if (c["hidden_act"], c["scoring_func"], c["topk_method"]) != ("silu", "sigmoid", "noaux_tc") \
            or not c["norm_topk_prob"] or c["attention_bias"] or c["moe_layer_freq"] != 1:
        raise ValueError(f"{c['name']}: a configuration the program does not build")
    n, k, y = c["num_hidden_layers"], c["first_k_dense_replace"], c["rope_scaling"]
    if y["type"] != "yarn":
        raise ValueError(f"{c['name']}: rope scaling {y['type']!r} is not YaRN")
    moe = DeepSeekMoEConfig(n_experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
                            n_groups=c["n_group"], topk_groups=c["topk_group"],
                            routed_scale=c["routed_scaling_factor"],
                            n_shared=c["n_shared_experts"], d_expert=c["moe_intermediate_size"])
    return MLAConfig(
        name=c["model_name"], family="moe", n_layers=n, d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        block_pattern=("mla+dense",) * k + ("mla+moe",) * (n - k), moe=moe,
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["dtype"], remat=False,
        q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"],
        yarn=YarnRope(factor=y["factor"],
                      original_max_position=y["original_max_position_embeddings"],
                      beta_fast=y["beta_fast"], beta_slow=y["beta_slow"], mscale=y["mscale"],
                      mscale_all_dim=y["mscale_all_dim"]))


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def weight_shapes(c: dict, cfg) -> Any:
    """The program's parameter tree as meta tensors, each MoE layer's routed
    expert leaves (R, E, ...) cut to the ``n_experts`` held."""
    from repro_torch.models import model as M

    tree = M.abstract_params(cfg)
    for block, entry in zip(tree["blocks"], cfg.block_pattern):
        if entry.endswith("+moe"):
            mlp = block["mlp"]
            for name in EXPERT_LEAVES:
                v = mlp[name]
                mlp[name] = torch.empty((v.shape[0], c["n_experts"], *v.shape[2:]),
                                        dtype=v.dtype, device="meta")
    return tree


def _init_rule(path: tuple[str, ...], shape: tuple[int, ...]) -> tuple[str, float]:
    if path[-1].strip("[]'") == "e_bias":
        return "normal", E_BIAS_STD
    return H._init_rule(path, shape)


def make_params(c: dict, cfg, seed: int, device) -> Any:
    """The weights from ``seed`` on ``device``: ``harness.make_params``'s
    draws (one ``normal_`` over one flat buffer per dtype, from the same
    stream), over ``weight_shapes``' tree."""
    from repro_torch.tree import paths, unflatten

    tree = weight_shapes(c, cfg)
    shapes = list(paths(tree))
    rules = [_init_rule(p, tuple(t.shape)) for p, t in shapes]
    drawn: dict[torch.dtype, int] = {}
    for (_, t), (kind, _) in zip(shapes, rules):
        if kind == "normal":
            drawn[t.dtype] = drawn.get(t.dtype, 0) + t.numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(H.derive_seed(seed, H.WEIGHTS_STREAM))
    flat = {dt: torch.empty(n, dtype=dt, device=device).normal_(generator=gen)
            for dt, n in drawn.items()}
    used = dict.fromkeys(drawn, 0)
    out = []
    for (_, t), (kind, val) in zip(shapes, rules):
        if kind == "normal":
            at = used[t.dtype]
            out.append(flat[t.dtype][at:at + t.numel()].view(t.shape).mul_(val))
            used[t.dtype] = at + t.numel()
        else:
            out.append(torch.full(t.shape, val, dtype=t.dtype, device=device))
    return unflatten(tree, out)


def prompts(c: dict, tr: dict, s: int) -> np.ndarray:
    """The prompts the program draws for request 0 of a job seeded ``s``
    (``launch.serve.request_prompts``' rule, restated here)."""
    rng = np.random.default_rng([s, 0])
    return rng.integers(0, c["vocab_size"], size=(tr["batch"], tr["prompt_len"]),
                        dtype=np.int64)


class Program(S.Program):
    """``kinds/serve.py``'s program over this configuration's own config and
    weights."""

    def __init__(self, c: dict, tr: dict, seed: int, device, serve_fn: Callable | None = None):
        from repro_torch.launch.serve import serve

        self.c, self.tr, self.seed, self.device = c, tr, seed, device
        self.cfg = model_config(c)
        self.params = make_params(c, self.cfg, seed, device)
        self.serve = serve_fn or serve


def gaps(c: dict, tr: dict, params, jobs: list[dict], prec: Precision, device) -> dict:
    """Over ``jobs``, every served token's gap (``served``), and with a lower
    precision ``prec`` the gap of the token that precision ranks first
    (``control``), each flattened over sequences and positions."""
    served, control = [], []
    for job in jobs:
        p = torch.as_tensor(prompts(c, tr, job["seed"]), device=device)
        toks = torch.as_tensor(job["tokens"], device=device)
        got, ctl = ref.served_gaps(params, c, p, toks, None if prec.name == "fp32" else prec)
        served.append(got.flatten())
        if ctl is not None:
            control.append(ctl.flatten())
    out = {"served": torch.cat(served).cpu()}
    if control:
        out["control"] = torch.cat(control).cpu()
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        serve_fn: Callable | None = None) -> dict[str, Any]:
    c, tr = cell["config"], cell["traffic"]
    prog = Program(c, tr, seed, device, serve_fn)
    graph = None
    if device.type == "cuda":
        from repro_torch.runtime.serve import decode_graph

        graph = decode_graph(prog.cfg, prog.params, tr["batch"],
                             tr["prompt_len"] + tr["gen_len"], device)
    for _ in range(WARM_JOBS if graph is not None else 1):
        prog.job(S.WARM_JOB)
    # a job's steps run a little ahead of the card: a collection inside a job
    # stalls it, so each job ends in one, over what set-up made frozen out
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    jobs, j = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        jobs.append(prog.job(j))
        gc.collect()
        j += 1
    window_s = time.perf_counter() - t0
    done = [x for x in jobs if x["ok"]]
    B = tr["batch"]
    rec = {"kind": "serve", "config": c, "traffic": tr, "setup_s": setup_s,
           "window_s": window_s, "jobs": len(done),
           "tokens": len(done) * B * tr["gen_len"],
           "latencies_s": [x["t1"] - x["t0"] for x in done for _ in range(B)],
           "decode_s": sum(x["decode_s"] for x in done),
           "steps_per_job": tr["prompt_len"] + tr["gen_len"] - 1, "trace": None,
           "attempted": len(jobs) * B, "failed": (len(jobs) - len(done)) * B}
    if trace:
        if graph is not None:
            graph.capture_traced(prog.params)
        with Stretch(host=False) as st:
            for k in range(tr["trace_jobs"]):
                prog.job(j + k)
        rec["trace"] = st.read()
        rec["trace_jobs"] = tr["trace_jobs"]
        with Stretch(host=True) as st:
            prog.job(j + tr["trace_jobs"])
        rec["trace"]["idle_gaps"] = st.read()["idle_gaps"]
    rec["device"] = H.device_record(cell["workload"]["chips"]) if device.type == "cuda" else None

    params = prog.params
    del prog, graph
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        from repro_torch.runtime.serve import clear_decode_graphs

        clear_decode_graphs()
        torch.cuda.empty_cache()
    rng = random.Random(H.derive_seed(seed, S.JOB_STREAM, 0))
    sample = rng.sample(done, min(tr["checked_jobs"], len(done)))
    g = gaps(c, tr, params, sample, Precision("fp32"), device)["served"] if sample else None
    rec["numbers"] = {"mean_gap": g.mean().item() if sample else float("inf")}
    return rec
