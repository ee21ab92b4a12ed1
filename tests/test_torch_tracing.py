"""The port's spans and counters (``repro_torch.tracing``) and the benchmark's
readers of them (``portbench/spans.py``, ``portbench/metrics/*``), on the CPU.

- With no profiler, a train step, a serving job and an engine job record
  nothing, build no span and allocate no event.
- Under a profiler, spans nest under the right parents and share their job's
  id; a span's host start lies within 100 µs of the profiler's event of the
  same name (after the first span); a step of 8 microbatches is ``train.step``
  around 8 × (forward, backward, accumulation) and then the optimizer.
- ``moe.dispatch``'s counters equal a host recount of ``moe_route``'s
  ``keep``, with every expert held and with a slice of them.
- ``train.optimizer``'s ``fused`` counts the leaves AdamW's kernel updated:
  none on the CPU (the plain version), every leaf on meta tensors (the
  kernels' route), and nothing is recorded without a profiler.
- On a DAG of sleeping tasks the engine's self time is the job less the
  union of its task spans; ``gc.collect()`` gives a ``python.gc`` span.
- Each reader returns None without spans and its value on a hand-built list.
"""
import dataclasses
import gc
import sys
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.core import EngineConfig, GraphBuilder, WukongEngine
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.orchestrator import build_training_workflow, run_training_workflow
from repro_torch.runtime.train import build_train_step, synthetic_batch
from repro_torch.tree import leaves, map_tree

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness as H  # noqa: E402
from portbench import spans as PS  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def mixtral():
    cfg = reduced(get_config("mixtral_8x7b"))
    params = M.init_model(cfg, seed=0, device="cpu")
    return cfg, params


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def one_step_job(cfg, params, n_microbatches=1):
    """One engine job of one train step."""
    step = build_train_step(cfg, AdamWConfig(), n_microbatches=n_microbatches)
    batch = synthetic_batch(cfg, 8, 16, seed=1, device="cpu")

    def step_fn(st, i):
        p, o, m = step(st[0], st[1], batch)
        return (p, o), {"loss": m["loss"].item()}

    dag, final, metrics = build_training_workflow(
        n_steps=1, step_fn=step_fn, init_fn=lambda: (params, adamw_init(params)))
    return run_training_workflow(dag, final, metrics)


def serve_job(cfg, params):
    return tserve.serve(cfg, params, requests=1, batch=2, prompt_len=3, gen_len=3, seed=5,
                        device="cpu")


def test_nothing_recorded_without_a_profiler(mixtral, monkeypatch):
    cfg, params = mixtral

    def no_span(*a, **k):
        raise AssertionError("a span was built with no profiler recording")

    def no_event(*a, **k):
        raise AssertionError("an event was allocated with no profiler recording")

    monkeypatch.setattr(tracing, "Span", no_span)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("x", device=torch.device("cpu"), a=1) is tracing.OFF
    one_step_job(cfg, params, n_microbatches=2)
    serve_job(cfg, params)
    gc.collect()
    assert tracing.spans() == []
    assert tracing._on_gc not in gc.callbacks


def test_spans_nest_under_their_parents_and_share_the_job(mixtral):
    cfg, params = mixtral
    with recording():
        one_step_job(cfg, params)
        serve_job(cfg, params)
    spans = tracing.spans()
    by_id = {s["id"]: s for s in spans}
    jobs = PS.named(spans, "engine.job")
    assert len(jobs) == 2 and all(j["parent"] is None and j["job"] == j["id"] for j in jobs)

    def parent(s):
        return by_id[s["parent"]]["name"]

    (step,) = PS.named(spans, "train.step")
    assert parent(step) == "engine.task"
    assert by_id[step["parent"]]["attrs"]["key"] == "train/step-0"
    assert parent(by_id[step["parent"]]) == "engine.job"
    for name in ("train.forward", "train.backward", "train.optimizer"):
        (s,) = PS.named(spans, name)
        assert s["parent"] == step["id"] and s["job"] == step["job"] == jobs[0]["id"]
    for s in PS.named(spans, "moe.dispatch"):
        assert parent(s) in ("train.forward", "train.backward", "serve.prompt",
                             "serve.generate")
    (req,) = PS.named(spans, "serve.request")
    assert parent(req) == "engine.task" and req["job"] == jobs[1]["id"]
    for name in ("serve.cache_init", "serve.prompt", "serve.generate", "serve.readback"):
        (s,) = PS.named(spans, name)
        assert s["parent"] == req["id"] and s["job"] == jobs[1]["id"]
        assert req["start_ns"] <= s["start_ns"] <= s["end_ns"] <= req["end_ns"]
    assert all(s["device_ms"] is None for s in spans)   # no CUDA device here


def test_host_start_on_the_profilers_clock():
    names = [f"clock.{i}" for i in range(6)]
    with recording() as prof:
        for name in names:
            with tracing.span(name):
                torch.ones(64).sum()
    events = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()}
    starts = {s["name"]: s["start_ns"] for s in tracing.spans()}
    gaps_us = [abs(starts[n] - events[tracing.PREFIX + n]) / 1e3 for n in names]
    assert max(gaps_us[1:]) < 100, gaps_us


def test_accumulated_step_phases(mixtral):
    cfg, params = mixtral
    with recording():
        one_step_job(cfg, params, n_microbatches=8)
    spans = tracing.spans()
    (step,) = PS.named(spans, "train.step")
    phases = [s["name"] for s in spans if s["parent"] == step["id"]]
    assert phases == ["train.forward", "train.backward", "train.grad_accum"] * 8 + [
        "train.optimizer"]
    kids = [s for s in spans if s["parent"] == step["id"]]
    for a, b in zip(kids, kids[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert step["start_ns"] <= kids[0]["start_ns"] and kids[-1]["end_ns"] <= step["end_ns"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_optimizer_span_counts_the_leaves_the_kernel_updated(mixtral, device):
    cfg, params = mixtral
    if device == "meta":
        params = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
    step = build_train_step(cfg, AdamWConfig())
    batch = synthetic_batch(cfg, 2, 16, seed=1, device=device)
    state = adamw_init(params)
    step(params, state, batch)
    assert tracing.spans() == []
    with recording():
        step(params, state, batch)
    (opt,) = PS.named(tracing.spans(), "train.optimizer")
    assert opt["attrs"] == {"fused": 0 if device == "cpu" else len(leaves(params))}


@pytest.mark.parametrize("held", ["all", "slice"])
def test_moe_dispatch_counts_equal_a_host_recount(mixtral, held):
    cfg, params = mixtral
    cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)   # the benchmark's: drops
    p = {name: w[0] for name, w in params["blocks"][0]["mlp"].items()}   # first layer
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    first, E_l = (0, E) if held == "all" else (E // 4, E // 2)
    for w in ("w_gate", "w_up", "w_down"):
        p[w] = p[w][first:first + E_l]
    x = torch.randn(3, 16, cfg.d_model, generator=torch.Generator().manual_seed(3)).to(
        L.dtype_of(cfg))
    with recording():
        L._moe_local(p, x, cfg, first)
    (sp,) = PS.named(tracing.spans(), "moe.dispatch")
    r = L.moe_route(p["router"], x, cfg)
    G, g, _ = r.expert.shape
    mine = (r.expert >= first) & (r.expert < first + E_l)
    want = {"kept": int((r.keep & mine).sum()), "rows": E_l * G * r.cap}
    assert sp["attrs"] == {**want, "fused": 0}   # the CPU takes the plain gathers
    dropped = int((~r.keep).sum())
    assert dropped > 0 and (held == "all") == (want["kept"] + dropped == G * g * k)


def _dispatch_attrs(cfg, dev):
    """``moe.dispatch``'s attributes over empty tensors on ``dev``."""
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    x = torch.empty(2, 16, d, device=dev)
    p = {"router": torch.empty(d, E, device=dev), "w_gate": torch.empty(E, d, f, device=dev),
         "w_up": torch.empty(E, d, f, device=dev), "w_down": torch.empty(E, f, d, device=dev)}
    with recording():
        L._moe_local(p, x, cfg)
    (sp,) = PS.named(tracing.spans(), "moe.dispatch")
    return sp["attrs"]


def test_moe_dispatch_counts_nothing_on_meta_tensors(mixtral):
    assert _dispatch_attrs(mixtral[0], "meta") == {}


def test_moe_dispatch_counts_nothing_on_fake_tensors(mixtral):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        assert _dispatch_attrs(mixtral[0], "cpu") == {}


def test_engine_self_time_is_the_job_less_its_tasks():
    g = GraphBuilder()

    def nap(*_):
        time.sleep(0.02)
        return 1

    a, b = g.add(nap, name="a"), g.add(nap, name="b")
    g.add(nap, a, b, name="c")
    with recording():
        WukongEngine(EngineConfig()).compute(g.build())
    spans = tracing.spans()
    (job,) = PS.named(spans, "engine.job")
    tasks = PS.named(spans, "engine.task")
    assert sorted(t["attrs"]["key"] for t in tasks) == ["a", "b", "c"]
    assert all(t["job"] == job["id"] for t in tasks)
    assert all(t["end_ns"] - t["start_ns"] >= 20e6 for t in tasks)
    iv = sorted((t["start_ns"], t["end_ns"]) for t in tasks)
    assert all(x[1] <= y[0] for x, y in zip(iv, iv[1:]))   # one thread: no overlap
    want = (job["end_ns"] - job["start_ns"] - sum(t - s for s, t in iv)) / 1e6
    assert PS.self_ms(job, spans) == pytest.approx(want, abs=1e-9)
    assert PS.engine_self_ms(spans) == PS.self_ms(job, spans) > 0


def test_union_of_task_spans_on_several_threads():
    job = {"id": 1, "name": "engine.job", "start_ns": 0, "end_ns": 100}
    tasks = [{"name": "engine.task", "job": 1, "start_ns": s, "end_ns": t}
             for s, t in ((10, 30), (20, 40), (35, 50), (90, 120), (60, 60))]
    other = {"name": "engine.task", "job": 2, "start_ns": 0, "end_ns": 100}
    assert PS.covered_ns(0, 100, [(s["start_ns"], s["end_ns"]) for s in tasks]) == 50
    assert PS.self_ms(job, [job, *tasks, other]) == 50 / 1e6


def test_collection_under_a_profiler_is_a_gc_span():
    with recording():
        with tracing.span("outer"):
            garbage = [[] for _ in range(10)]
            for a, b in zip(garbage, garbage[1:]):
                a.append(b)
                b.append(a)
            del garbage, a, b
            gc.collect()
    spans = tracing.spans()
    (outer,) = PS.named(spans, "outer")
    collections = [s for s in PS.named(spans, tracing.GC) if s["parent"] == outer["id"]]
    assert collections and collections[-1]["attrs"]["generation"] == 2
    assert collections[-1]["attrs"]["collected"] >= 10
    tracing.reset()
    assert tracing._on_gc not in gc.callbacks


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, for its profile reader."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_profiles_leave_the_programs_spans_out():
    smoke = _chip_smoke()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class Prof:
        def key_averages(self):
            return [types.SimpleNamespace(key=k, device_type=d) for k, d in (
                ("ProfilerStep#1", cuda), (tracing.PREFIX + "train.step", cuda),
                ("void gemm_kernel<bf16>", cuda), ("aten::mm", cpu))]

    with recording():
        with tracing.span("engine.job"):
            with tracing.span("engine.task"):
                torch.ones(8).sum()
            torch.ones(8).mul(2)
    assert tracing.spans()
    assert [e.key for e in smoke.kernel_rows(Prof())] == ["void gemm_kernel<bf16>"]
    assert tracing.spans() == [] and tracing._on_gc not in gc.callbacks


def span(i, name, parent=None, job=None, start=0, end=0, device_ms=None, **attrs):
    return {"id": i, "name": name, "parent": parent, "job": job, "start_ns": start,
            "end_ns": end, "device_ms": device_ms, "attrs": attrs}


HAND_BUILT = [
    span(1, "engine.job", None, 1, 0, 10_000_000),
    span(2, "engine.task", 1, 1, 1_000_000, 9_000_000),
    span(3, "train.step", 2, 1, 1_000_000, 9_000_000, device_ms=100.0),
    span(4, "train.forward", 3, 1, device_ms=20.0),
    span(5, "moe.dispatch", 4, 1, kept=3900, rows=5120),
    span(6, "train.backward", 3, 1, device_ms=40.0),
    span(7, "moe.dispatch", 6, 1, kept=3940, rows=5120),
    span(8, "train.grad_accum", 3, 1, device_ms=10.0),
    span(9, "train.optimizer", 3, 1, device_ms=29.0),
    span(10, "engine.job", None, 10, 20_000_000, 24_000_000),
    span(11, "engine.task", 10, 10, 20_500_000, 23_000_000),
    span(12, "engine.task", 10, 10, 22_000_000, 23_500_000),
    span(13, "serve.prompt", 11, 10, device_ms=30.0),
    span(14, "serve.generate", 11, 10, device_ms=34.0),
    span(15, "moe.dispatch", 13, 10),                     # a dry run's: no counters
    span(16, "engine.job", None, 16, 30_000_000, 31_500_000),
]
READERS = {  # metric -> (kind, value on HAND_BUILT)
    "optimizer_share.train": ("train", 29.0),
    "grad_accum_share.train": ("train", 10.0),
    "moe_slot_use.serve": ("serve", 100.0 * 7840 / 10240),
    "engine_self_ms.train": ("train", 1.5),          # jobs: 2 ms, 1 ms, 1.5 ms
    "engine_self_ms.serve": ("serve", 1.5),
    "prompt_share.serve": ("serve", 100.0 * 30 / 64),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_none_without_spans_and_its_value_on_a_hand_built_list(metric, monkeypatch):
    kind, want = READERS[metric]
    read = H.reader(metric)
    traced = {"kind": kind, "trace": {"kernels": 1}}
    assert read({"kind": kind, "trace": None}) is None
    assert read(traced) is None                         # nothing recorded
    monkeypatch.setattr(tracing, "spans", lambda: HAND_BUILT)
    assert read(traced) == pytest.approx(want, rel=1e-12)
    assert read({"kind": "serve" if kind == "train" else "train", "trace": {}}) is None
    assert read({"kind": kind, "trace": None}) is None
