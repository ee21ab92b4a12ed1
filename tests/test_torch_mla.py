"""DeepSeek-V3's blocks in the port: latent attention (``models/mla.py``),
DeepSeekMoE's router and shared expert (``models/layers.py``), its
configuration (``configs/deepseek_v3.py``) and the benchmark's build of it
(``portbench/kinds/serve_mla.py``).

The JAX package has no such block, so the port is held to the plain float32
reference (``_mla_moe_reference.reference``, the benchmark's own file) on a
tiny fp32 configuration: d 64, 4 heads, q/kv ranks 32/16, nope/rope/v
16/8/16, 16 experts of width 32 top 4 in 4 groups of which 2 are kept, one
shared expert, 1 dense + 2 MoE layers, vocab 256, YaRN as published (its
ramp falls inside the 4 rotary pairs). The capacity is E/k, so the forward
drops nothing, as the reference's serving forward does not.

Tolerances and why:

- forward, each decode step's logits, the MoE layer: max |err| ≤ 2e-5 ·
  max |reference| (the same fp32 arithmetic in another order: absorbed
  products, the flash plain version over padded heads); leaving out a term
  (the rotary part, YaRN's scale, the shared expert, the bias, one expert)
  moves the logits by a tenth or more of their size.
- served tokens: equal to the reference's greedy loop.
- the router: the same experts in the same order as brute-force
  enumeration of the groups, weights within 1e-6.
- the card (marked ``cuda``): latent attention in bf16, forward through the
  flash kernel at hd 192 and each absorbed decode step, against fp32 on the
  CPU at a reduced width: rel ≤ 5e-2, the port's bf16 decode limit.
"""
import copy
import dataclasses
import itertools
import math
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.runtime import serve as rserve
from repro_torch.runtime import sharding as sh

from _mla_moe_reference import BENCHMARK_FILE, Precision, reference
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness as H  # noqa: E402
from portbench.kinds import serve_mla as D  # noqa: E402

CPU = torch.device("cpu")
FP32 = Precision("fp32")
TOL = 2e-5


def tiny_config(**kw) -> dict:
    c = copy.deepcopy(H.read_json(H.HERE / "configs" / "deepseek_v3.json"))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
             kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             n_routed_experts=16, n_experts=16, num_experts_per_tok=4, n_group=4,
             topk_group=2, n_shared_experts=1, moe_intermediate_size=32,
             intermediate_size=128, num_hidden_layers=3, first_k_dense_replace=1,
             vocab_size=256, dtype="float32")
    c.update(kw)
    return c


def program(c: dict, seed: int = 3):
    """The program's config (capacity E/k: nothing dropped) and the weights
    ``kinds/serve_mla.py`` draws for ``c``."""
    cfg = D.model_config(c)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return cfg, D.make_params(c, cfg, seed, CPU)


@pytest.fixture(scope="module")
def tiny():
    c = tiny_config()
    return (c, *program(c))


def close(got, want, tol=TOL):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max().item())


def test_reference_is_the_benchmarks():
    assert Path(reference.__file__).resolve() == BENCHMARK_FILE.resolve()
    src = BENCHMARK_FILE.read_text()
    assert "import repro_torch" not in src and "from repro_torch" not in src


def test_config_has_the_published_widths():
    cfg = get_config("deepseek_v3")
    assert (cfg.n_layers, cfg.n_repeats, cfg.d_model, cfg.n_heads, cfg.vocab) == (
        61, 1, 7168, 128, 129280)
    assert cfg.block_pattern == ("mla+dense",) * 3 + ("mla+moe",) * 58 and cfg.d_ff == 18432
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim) == (1536, 512, 128, 64, 128)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.n_groups, m.topk_groups, m.routed_scale, m.n_shared,
            m.d_expert) == (256, 8, 8, 4, 2.5, 1, 2048)
    assert cfg.norm_eps == 1e-6 and cfg.rope_theta == 10000.0
    assert math.isclose(cfg.softmax_scale, 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2)
    assert cfg.yarn.rope_mscale == 1.0
    # the benchmark's file at its published depth builds the same configuration
    c = H.read_json(H.HERE / "configs" / "deepseek_v3.json")
    c["num_hidden_layers"] = c["published"]["num_hidden_layers"]
    assert dataclasses.replace(D.model_config(c), remat=True) == cfg


def test_yarn_frequencies_blend_between_the_correction_dims():
    cfg = get_config("deepseek_v3")
    f = MLA.rope_freqs(cfg, CPU)
    base = 1.0 / 10000 ** (torch.arange(0, 64, 2) / 64)
    # 32 rotations over 4096 positions: dim 10 (floor); 1 rotation: dim 23 (ceil)
    torch.testing.assert_close(f[:11], base[:11])
    torch.testing.assert_close(f[23:], base[23:] / 40)
    ramp = (torch.arange(11, 23) - 10) / 13
    torch.testing.assert_close(f[11:23], base[11:23] * (1 - ramp) + base[11:23] / 40 * ramp)
    torch.testing.assert_close(f, reference.inv_freq(H.read_json(
        H.HERE / "configs" / "deepseek_v3.json"), CPU))


def test_forward_matches_the_reference(tiny):
    c, cfg, params = tiny
    tokens = torch.randint(0, c["vocab_size"], (2, 11), generator=torch.Generator().manual_seed(1))
    close(M.forward(params, cfg, tokens), reference.forward(params, c, tokens, FP32))


def test_absorbed_decode_matches_the_reference_at_every_position(tiny):
    c, cfg, params = tiny
    tokens = torch.randint(0, c["vocab_size"], (3, 9), generator=torch.Generator().manual_seed(2))
    want = reference.forward(params, c, tokens, FP32)
    cache = M.init_cache(cfg, 3, 9, device=CPU)
    assert set(cache[0]) == {"ckv", "kpe"} and cache[0]["ckv"].shape == (1, 3, 9, 16)
    for pos in range(9):
        logits, cache = M.decode_step(params, cfg, cache, tokens[:, pos], pos)
        close(logits, want[:, pos])
    assert cache[1]["kpe"].abs().sum() > 0


def test_decode_at_a_tensor_position_is_the_same_step(tiny):
    """A 0-d position tensor (a CUDA graph's input) gives the int's bits."""
    c, cfg, params = tiny
    tokens = torch.randint(0, c["vocab_size"], (2, 5), generator=torch.Generator().manual_seed(6))
    a, b = (M.init_cache(cfg, 2, 5, device=CPU) for _ in range(2))
    for pos in range(5):
        la, a = M.decode_step(params, cfg, a, tokens[:, pos], pos)
        lb, b = M.decode_step(params, cfg, b, tokens[:, pos], torch.tensor(pos))
        assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for ca, cb in zip(a, b) for x, y in zip(ca.values(), cb.values()))


class EagerGraph:
    """A stand-in for ``runtime.serve.DecodeGraph`` on the CPU: its inputs,
    cache and lock, stepped eagerly."""

    def __init__(self, cfg, params, batch, max_len):
        self.cfg, self.params, self.batch, self.max_len = cfg, params, batch, max_len
        self.lock = threading.Lock()
        self.cache = M.init_cache(cfg, batch, max_len, device=CPU)
        self.steps = 0
        self.traced_with = []

    def capture_traced(self, params):
        self.traced_with.append(params)

    def begin(self):
        return [{k: v.zero_() for k, v in c.items()} for c in self.cache]

    def step(self, token, pos):
        self.steps += 1
        return M.decode_step(self.params, self.cfg, self.cache, token, torch.tensor(pos))[0]


def test_serve_through_a_decode_graph_gives_the_same_tokens(tiny, monkeypatch):
    """``handle_request`` asks ``decode_graph`` for the graph of its model,
    batch and length, and replays it at every step, under a profiler too,
    where it first asks for the traced pair; its tokens are the eager
    steps'."""
    c, cfg, params = tiny
    kw = dict(requests=2, batch=2, prompt_len=3, gen_len=4, seed=9, device=CPU)
    want = tserve.serve(cfg, params, **kw).results["summary"]["tokens"]
    graph, asked = EagerGraph(cfg, params, 2, 7), []

    def kept(*args):
        asked.append(args)
        return graph
    monkeypatch.setattr(tserve, "decode_graph", kept)
    got = tserve.serve(cfg, params, **kw).results["summary"]["tokens"]
    assert graph.steps == 2 * 6 and all((a == b).all() for a, b in zip(got, want))
    assert asked == [(cfg, params, 2, 7, CPU)] * 2 and graph.traced_with == []
    with profile(activities=[ProfilerActivity.CPU]):
        again = tserve.serve(cfg, params, **kw).results["summary"]["tokens"]
    tracing.reset()
    assert graph.steps == 4 * 6 and all((a == b).all() for a, b in zip(again, want))
    assert all(p is params for p in graph.traced_with) and len(graph.traced_with) == 2


def test_only_latent_attention_on_the_card_is_graphed(tiny):
    _, cfg, params = tiny
    mixtral = get_config("mixtral_8x7b")
    assert rserve.graphable(cfg) and not rserve.graphable(mixtral)
    assert rserve.decode_graph(cfg, params, 2, 4, CPU) is None
    assert rserve.decode_graph(mixtral, params, 2, 4, torch.device("cuda", 0)) is None
    with pytest.raises(ValueError, match="reads its position on the host"):
        rserve.DecodeGraph(mixtral, params, 2, 4, device=CPU)
    with pytest.raises(ValueError, match="need a CUDA device"):
        rserve.DecodeGraph(cfg, params, 2, 4, device=CPU)


def test_serve_gives_the_references_greedy_tokens(tiny):
    c, cfg, params = tiny
    batch, prompt_len, gen_len, seed = 2, 4, 5, 7
    rep = tserve.serve(cfg, params, requests=2, batch=batch, prompt_len=prompt_len,
                       gen_len=gen_len, seed=seed, device=CPU)
    for rid, got in enumerate(rep.results["summary"]["tokens"]):
        seq = torch.as_tensor(tserve.request_prompts(seed, rid, batch, prompt_len, c["vocab_size"]))
        for _ in range(gen_len):
            nxt = reference.forward(params, c, seq, FP32)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
        assert (torch.as_tensor(got) == seq[:, prompt_len:]).all()


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

def brute_force(scores: torch.Tensor, bias: torch.Tensor, cfg):
    """Per token: every choice of ``topk_groups`` groups, the one whose groups'
    two best biased scores sum highest; the ``top_k`` best biased scores in
    them, by a sort of (−biased, index); weights the unbiased scores over
    their sum times ``routed_scale``."""
    m = cfg.moe
    size = m.n_experts // m.n_groups
    experts, weights = [], []
    for s in scores.tolist():
        b = [x + y for x, y in zip(s, bias.tolist())]
        group = [sum(sorted(b[i * size:(i + 1) * size])[-2:]) for i in range(m.n_groups)]
        best = max(itertools.combinations(range(m.n_groups), m.topk_groups),
                   key=lambda gs: sum(group[i] for i in gs))
        allowed = [e for g in best for e in range(g * size, (g + 1) * size)]
        chosen = sorted(allowed, key=lambda e: (-b[e], e))[:m.top_k]
        total = sum(s[e] for e in chosen)
        experts.append(chosen)
        weights.append([s[e] / total * m.routed_scale for e in chosen])
    return torch.tensor(experts), torch.tensor(weights)


def route_case(case: str, cfg):
    g = torch.Generator().manual_seed(11)
    d, E = cfg.d_model, cfg.moe.n_experts
    router = torch.randn((d, E), generator=g) * d ** -0.5
    x = torch.randn((6, 1, d), generator=g)
    bias = torch.randn((E,), generator=g) * 1e-3
    if case == "bias_only":          # every score 0.5: the bias alone chooses
        x = torch.zeros_like(x)
        bias = torch.randn((E,), generator=g)
    elif case == "group_exclusion":  # expert 0 scores highest, its group's pair lowest
        bias = torch.zeros((E,))
        bias[0], bias[1:4] = 5.0, -10.0
    return router, bias, x


@pytest.mark.parametrize("case", ["random", "bias_only", "group_exclusion"])
def test_router_against_brute_force(tiny, case):
    _, cfg, _ = tiny
    router, bias, x = route_case(case, cfg)
    r = L.moe_route_grouped(router, bias, x, cfg)
    scores = torch.sigmoid(x[:, 0] @ router)
    want_e, want_w = brute_force(scores, bias, cfg)
    assert (r.expert.reshape(6, -1) == want_e).all()
    torch.testing.assert_close(r.weights.reshape(6, -1), want_w.float(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(r.weights.sum(-1), torch.full((6, 1), 2.5))
    assert r.keep.all() and r.cap == 1          # one token a group: every choice kept
    queued = L._queued(r.expert, r.weights, cfg.moe.n_experts, r.cap)
    assert torch.equal(queued.slot, r.slot) and torch.equal(queued.keep, r.keep)
    ref_e, ref_w = reference.route(x[:, 0] @ router, bias, tiny[0])
    assert (ref_e.sort(-1).values == want_e.sort(-1).values).all()
    if case == "bias_only":
        torch.testing.assert_close(r.weights, torch.full_like(r.weights, 2.5 / 4))
    if case == "group_exclusion":
        assert (scores + bias).argmax(-1).eq(0).all() and not (r.expert == 0).any()


def test_expert_parallel_shares_and_the_shared_expert_sum_to_the_layer(tiny):
    c, cfg, params = tiny
    p = {k: v[0] for k, v in params["blocks"][1]["mlp"].items() if k != "shared"}
    p["shared"] = {k: v[0] for k, v in params["blocks"][1]["mlp"]["shared"].items()}
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(4))
    shares = sum(L._moe_local({**p, **{k: p[k][4 * i:4 * i + 4] for k in D.EXPERT_LEAVES}},
                              x, cfg, first=4 * i) for i in range(4))
    layer = shares + L.mlp(p["shared"], x, cfg).float()
    close(layer, L.moe_mlp(p, x, cfg).float(), 1e-6)
    stacked = {k: (v[None] if k != "shared" else {n: w[None] for n, w in v.items()})
               for k, v in p.items()}
    close(layer, reference.moe(stacked, 0, x, c, FP32))


def test_dtensors_raise(tiny, monkeypatch):
    _, cfg, params = tiny
    monkeypatch.setattr(sh, "is_dtensor", lambda t: True)
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="latent attention"):
        MLA.mla(params["blocks"][0]["mixer"], x, cfg)
    with pytest.raises(NotImplementedError, match="DeepSeekMoE"):
        L.moe_mlp(params["blocks"][1]["mlp"], x, cfg)


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

def test_spans_and_counters_under_a_profiler(tiny):
    c, cfg, params = tiny
    tracing.reset()
    cache = M.init_cache(cfg, 2, 4, device=CPU)
    tokens = torch.tensor([3, 5])
    M.decode_step(params, cfg, cache, tokens, 0)
    assert tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        M.decode_step(params, cfg, cache, tokens, 1)
        M.decode_step(params, cfg, cache, tokens, 2)
        M.forward(params, cfg, torch.zeros((2, 4), dtype=torch.long))
    spans = tracing.spans()
    tracing.reset()
    by_id = {s["id"]: s for s in spans}
    mla = [s for s in spans if s["name"] == "mla"]
    attend = [s for s in spans if s["name"] == "mla.attend"]
    assert len(mla) == 3 * 3 and len(attend) == 2 * 3
    assert [s["attrs"] for s in attend] == [{"pos": 1, "batch": 2}] * 3 + [
        {"pos": 2, "batch": 2}] * 3
    assert all(by_id[s["parent"]]["name"] == "mla" for s in attend)
    dispatch = [s["attrs"] for s in spans if s["name"] == "moe.dispatch"]
    k = cfg.moe.top_k
    # decode: 2 tokens, each k distinct experts, all held, one row a group per expert
    # (fused 0: the CPU takes the plain gathers)
    assert dispatch[:4] == [{"kept": 2 * k, "rows": 16 * 2, "fused": 0}] * 4
    # forward: 2 groups of 4 tokens, capacity E/k·k·4/E = 4 places an expert
    assert dispatch[4:] == [{"kept": 8 * k, "rows": 16 * 2 * 4, "fused": 0}] * 2


def test_spans_captured_with_a_graph_record_at_each_replay(tiny):
    """Spans opened inside ``tracing.capture`` (a CUDA graph's capture) enter
    no profile; each ``replayed`` under a profiler records them anew, nested
    as captured under the span open then, their tensor counters as the
    buffers held at that replay (a graph rewrites them in place)."""
    c, cfg, params = tiny
    tracing.reset()
    cache = M.init_cache(cfg, 2, 4, device=CPU)
    pos = torch.tensor(0)
    with tracing.capture() as cap:
        M.decode_step(params, cfg, cache, torch.tensor([3, 5]), pos)
    assert tracing.spans() == []
    assert [s.name for s in cap.spans] == ["mla", "mla.attend"] + [
        "mla", "mla.attend", "moe.dispatch"] * 2
    kept = [s.attrs["kept"] for s in cap.spans if s.name == "moe.dispatch"]
    cap.replayed(0, 1)                        # no profiler: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("serve.generate"):
            cap.replayed(10, 20)
            pos.fill_(1)
            kept[0].zero_()
            cap.replayed(30, 40)
    spans = tracing.spans()
    tracing.reset()
    by_id = {s["id"]: s for s in spans}
    outer = spans[0]
    assert outer["name"] == "serve.generate" and len(spans) == 1 + 2 * 8
    first, second = spans[1:9], spans[9:]
    k = cfg.moe.top_k
    for replay, at, ns in ((first, 0, (10, 20)), (second, 1, (30, 40))):
        assert [s["name"] for s in replay] == [s.name for s in cap.spans]
        assert all((s["start_ns"], s["end_ns"]) == ns and s["device_ms"] is None for s in replay)
        attend = [s for s in replay if s["name"] == "mla.attend"]
        assert [s["attrs"] for s in attend] == [{"pos": at, "batch": 2}] * 3
        assert all(by_id[s["parent"]]["name"] == "mla" for s in attend)
        assert all(s["parent"] == outer["id"] for s in replay if s["name"] != "mla.attend")
    assert [s["attrs"]["kept"] for s in first if s["name"] == "moe.dispatch"] == [2 * k] * 2
    assert [s["attrs"]["kept"] for s in second if s["name"] == "moe.dispatch"] == [0, 2 * k]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (bf16 latent attention on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_mla_in_bf16_on_the_card_against_fp32(cuda):
    """Latent attention at hd 192 (nope 128 + rope 64, v 128), d 1024, 8 heads,
    ranks 256 / 128: the bf16 forward (flash at hd 192, v padded) and 24
    absorbed decode steps on the card, against the fp32 forward on the CPU."""
    cfg = dataclasses.replace(
        get_config("deepseek_v3"), d_model=1024, n_heads=8, n_kv_heads=8, q_lora_rank=256,
        kv_lora_rank=128, n_layers=1, block_pattern=("mla+dense",), dtype="float32")
    p = MLA.init_mla(torch.Generator().manual_seed(0), cfg)
    S, B = 24, 4
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want = MLA.mla(p, x, cfg)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    pb = {k: ({n: w.to(cuda) for n, w in v.items()} if isinstance(v, dict)
              else v.to(cuda, torch.bfloat16)) for k, v in p.items()}
    xb = x.to(cuda, torch.bfloat16)
    with torch.no_grad():
        fwd = MLA.mla(pb, xb, bf).float().cpu()
        ckv = torch.zeros((B, S, 128), dtype=torch.bfloat16, device=cuda)
        kpe = torch.zeros((B, S, 64), dtype=torch.bfloat16, device=cuda)
        dec = torch.cat([MLA.mla_decode(pb, xb[:, t:t + 1], ckv, kpe, t, bf)
                         for t in range(S)], dim=1).float().cpu()
    scale = want.abs().max().item()
    assert (fwd - want).abs().max().item() <= 5e-2 * scale
    assert (dec - want).abs().max().item() <= 5e-2 * scale


@pytest.mark.cuda
def test_a_decode_graph_on_the_card_replays_the_eager_steps(cuda, monkeypatch):
    """Tiny DeepSeek-V3 (3 layers) in bf16 on the card: the logits of every
    replay of a captured ``DecodeGraph`` equal the eager steps' (the same
    kernels), those of the traced pair too, captured midway and replayed
    under a profiler, whose replays record the model's spans with their
    device time; and serving, which replays the
    graph the program keeps, gives the eager tokens, twice over (the graph's
    cache zeroed for each request)."""
    c = tiny_config(dtype="bfloat16", vocab_size=512)
    cfg = D.model_config(c)
    params = D.make_params(c, cfg, 4, cuda)
    B, L = 4, 8
    graph = rserve.DecodeGraph(cfg, params, B, L, cuda)
    tokens = torch.randint(0, 512, (B, L), device=cuda)
    cache = M.init_cache(cfg, B, L, device=cuda)
    graph.begin()
    tracing.reset()
    with torch.no_grad():
        for pos in range(L):
            want, cache = M.decode_step(params, cfg, cache, tokens[:, pos], pos)
            if pos < L // 2:
                got = graph.step(tokens[:, pos], pos)
            else:
                graph.capture_traced(params)
                with profile(activities=[ProfilerActivity.CUDA]):
                    got = graph.step(tokens[:, pos], pos)
            assert torch.equal(got, want), pos
    spans = tracing.spans()
    tracing.reset()
    attend = [s for s in spans if s["name"] == "mla.attend"]
    assert [s["attrs"]["pos"] for s in attend] == [p for p in range(L // 2, L) for _ in range(3)]
    assert all(s["device_ms"] > 0 for s in spans if s["name"] in ("mla", "mla.attend"))
    assert [s["attrs"]["kept"] for s in spans if s["name"] == "moe.dispatch"] == [B * 4] * (2 * 4)
    kw = dict(requests=2, batch=B, prompt_len=3, gen_len=5, seed=2, device=cuda)
    graphed = tserve.serve(cfg, params, **kw).results["summary"]["tokens"]
    assert rserve.decode_graph(cfg, params, B, 8, cuda) is not None
    rserve.clear_decode_graphs()
    monkeypatch.setattr(tserve, "decode_graph", lambda *a: None)
    eager = tserve.serve(cfg, params, **kw).results["summary"]["tokens"]
    assert all((a == b).all() for a, b in zip(graphed, eager))
