"""The paper's workloads as torch payloads, and the copied orchestrator.

Sizes are those of ``tests/test_apps.py``: gemm 256/64, tsqr 1024x32 in 8
blocks, rsvd 512 in 8 blocks (rank 5 + 5), svc 4096 in 8 blocks, 3
iterations. The port's DAGs are fed the JAX package's blocks through numpy
(``blocks=``; threefry cannot be reproduced), so values are held to the JAX
DAG's and to the JAX ``*_expected``:

- gemm: rtol 1e-5, atol 1e-6 (f32 products of the same blocks; only the
  summation order of a block product may differ);
- tsqr: singular values rtol 1e-5; U blocks (entries up to ~0.15) atol
  5e-5 after aligning each column's sign (``torch.linalg`` and XLA may
  pick R rows of other signs, and their f32 SVDs of R round differently;
  at 1e-5 one entry in 4096 is over, by 1.08e-5);
- rsvd: top singular values rtol 1e-5 against the JAX DAG and 1e-4
  against the JAX ``randomized_svd_expected`` (numpy in f32);
- svc: rtol 1e-4, atol 1e-5 (``tests/test_apps.py``: a margin within
  rounding of 1 may flip a sample's hinge term).

``charged_ms`` and ``kv_stats`` must be identical to the JAX DAG's under
``ms_per_flop > 0`` through every engine of ``ENGINES``: the engine prices
only sizes and FLOPs. The copied orchestrator must give the JAX one's
report on the default app mix, on a crash-recovery run and on a streaming
run with all four trigger sources.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.apps import gemm as jgemm
from repro.apps import svc as jsvc
from repro.apps import svd as jsvd
from repro_torch.apps import device as app_device
from repro_torch.apps import gemm as tgemm
from repro_torch.apps import svc as tsvc
from repro_torch.apps import svd as tsvd
from repro_torch.launch import apps as launch_apps

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
GEMM = (256, 64)
TSQR = (1024, 32, 8)
RSVD = (512, 5, 5, 8)
SVC = (4096, 8, 3)
MS_PER_FLOP = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with app_device.on_device("cpu"):
        yield


# The JAX package's blocks, by the block maker's (seed, i, j, shape).

def gemm_blocks(seed, i, j, shape):
    return np.array(jgemm._block(seed, i, j, shape[0]))


def tsqr_blocks(seed, i, j, shape):
    return np.array(jsvd._row_block(seed, i, *shape))


def rsvd_blocks(seed, i, j, shape, base=4):
    if seed == base + 1:  # Omega: PRNGKey(seed + 1)
        return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))
    return np.array(jsvd._row_block(seed, i, *shape))


def svc_blocks(seed, i, j, shape, base=5):
    if seed == base + 999:  # w_true: PRNGKey(seed + 999)
        return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))
    return np.array(jsvc._data_block(base, i, shape[0])[0])


def jax_dag(app, ms_per_flop=0.0, **kw):
    return {"gemm": lambda: jgemm.gemm_dag(*GEMM, ms_per_flop=ms_per_flop),
            "tsqr": lambda: jsvd.tsqr_svd_dag(*TSQR, ms_per_flop=ms_per_flop),
            "rsvd": lambda: jsvd.randomized_svd_dag(*RSVD, ms_per_flop=ms_per_flop, **kw),
            "rsvd_ideal": lambda: jsvd.randomized_svd_dag(*RSVD, ms_per_flop=ms_per_flop,
                                                          ideal_storage=True),
            "svc": lambda: jsvc.svc_dag(*SVC, ms_per_flop=ms_per_flop)}[app]()


def port_dag(app, ms_per_flop=0.0, **kw):
    return {"gemm": lambda: tgemm.gemm_dag(*GEMM, ms_per_flop=ms_per_flop,
                                           blocks=gemm_blocks),
            "tsqr": lambda: tsvd.tsqr_svd_dag(*TSQR, ms_per_flop=ms_per_flop,
                                              blocks=tsqr_blocks),
            "rsvd": lambda: tsvd.randomized_svd_dag(*RSVD, ms_per_flop=ms_per_flop,
                                                    blocks=rsvd_blocks, **kw),
            "rsvd_ideal": lambda: tsvd.randomized_svd_dag(*RSVD, ms_per_flop=ms_per_flop,
                                                          blocks=rsvd_blocks,
                                                          ideal_storage=True),
            "svc": lambda: tsvc.svc_dag(*SVC, ms_per_flop=ms_per_flop,
                                        blocks=svc_blocks)}[app]()


@functools.lru_cache(maxsize=None)
def jax_report(app, engine="wukong", ms_per_flop=0.0, ideal_storage=False):
    kw = {"ideal_storage": True} if ideal_storage else {}
    return jcore.ENGINES[engine]().compute(jax_dag(app, ms_per_flop, **kw))


def port_report(app, engine="wukong", ms_per_flop=0.0, ideal_storage=False):
    kw = {"ideal_storage": True} if ideal_storage else {}
    return tcore.ENGINES[engine]().compute(port_dag(app, ms_per_flop, **kw))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_gemm_matches_jax():
    j, t = jax_report("gemm"), port_report("gemm")
    assert j.results.keys() == t.results.keys()
    for key in j.results:
        assert t.results[key].dtype == torch.float32
        np.testing.assert_allclose(_np(t.results[key]), _np(j.results[key]),
                                   rtol=1e-5, atol=1e-6)
    want = jgemm.gemm_expected(*GEMM)
    np.testing.assert_allclose(tgemm.gemm_expected(*GEMM, blocks=gemm_blocks), want,
                               rtol=1e-5, atol=1e-6)


def _align_columns(u, ref):
    """``u`` with each column's sign flipped to agree with ``ref``'s."""
    return u * np.where((u * ref).sum(axis=0) < 0, -1.0, 1.0)


def test_tsqr_matches_jax_up_to_column_sign():
    j, t = jax_report("tsqr"), port_report("tsqr")
    s = _np(t.results["svd1-S"])
    np.testing.assert_allclose(s, _np(j.results["svd1-S"]), rtol=1e-5)
    np.testing.assert_allclose(s, jsvd.tsqr_singular_values_expected(*TSQR), rtol=1e-5)
    np.testing.assert_allclose(tsvd.tsqr_singular_values_expected(*TSQR, blocks=tsqr_blocks),
                               jsvd.tsqr_singular_values_expected(*TSQR), rtol=1e-5)
    for i in range(TSQR[2]):
        ju, tu = _np(j.results[f"svd1-U-{i}"]), _np(t.results[f"svd1-U-{i}"])
        np.testing.assert_allclose(_align_columns(tu, ju), ju, atol=5e-5)


def test_randomized_svd_matches_jax():
    j, t = jax_report("rsvd"), port_report("rsvd")
    s = _np(t.results["svd2-S"])
    np.testing.assert_allclose(s, _np(j.results["svd2-S"]), rtol=1e-5)
    want = jsvd.randomized_svd_expected(*RSVD)
    np.testing.assert_allclose(s, want, rtol=1e-4)
    np.testing.assert_allclose(tsvd.randomized_svd_expected(*RSVD, blocks=rsvd_blocks), want,
                               rtol=1e-4)


def test_svc_matches_jax():
    j, t = jax_report("svc"), port_report("svc")
    w = _np(t.results[f"svc-w{SVC[2]}"])
    np.testing.assert_allclose(w, _np(j.results[f"svc-w{SVC[2]}"]), rtol=1e-4, atol=1e-5)
    want = jsvc.svc_expected(*SVC)
    np.testing.assert_allclose(w, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsvc.svc_expected(*SVC, blocks=svc_blocks), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("engine", sorted(jcore.ENGINES))
@pytest.mark.parametrize("app", ["gemm", "tsqr", "rsvd", "rsvd_ideal", "svc"])
def test_engine_price_equals_jax(app, engine):
    j = jax_report(app, engine, MS_PER_FLOP)
    t = port_report(app, engine, MS_PER_FLOP)
    assert j.results.keys() == t.results.keys()
    assert t.charged_ms == j.charged_ms
    assert t.kv_stats == j.kv_stats
    assert t.tasks == j.tasks


def test_ideal_storage_same_values_fewer_kv_bytes():
    normal = port_report("rsvd")
    ideal = port_report("rsvd", ideal_storage=True)
    np.testing.assert_array_equal(_np(ideal.results["svd2-S"]), _np(normal.results["svd2-S"]))
    assert ideal.kv_stats["bytes_written"] < normal.kv_stats["bytes_written"] / 2
    j = jax_report("rsvd", ideal_storage=True)
    assert ideal.charged_ms == j.charged_ms and ideal.kv_stats == j.kv_stats


def test_own_blocks_are_pure_functions_of_seed_and_index():
    a = app_device.normal_block(7, 3, 1, (64, 32), torch.device("cpu"))
    assert torch.equal(a, app_device.normal_block(7, 3, 1, (64, 32), torch.device("cpu")))
    assert not torch.equal(a, app_device.normal_block(7, 3, 2, (64, 32), torch.device("cpu")))
    # a retried leaf gives the same block: two runs of one DAG agree bit for bit
    r1 = tcore.WukongEngine().compute(tsvd.tsqr_svd_dag(*TSQR))
    r2 = tcore.WukongEngine().compute(tsvd.tsqr_svd_dag(*TSQR))
    for key in r1.results:
        assert torch.equal(r1.results[key], r2.results[key])


def test_own_blocks_hold_to_own_expected():
    rep = tcore.WukongEngine().compute(tgemm.gemm_dag(*GEMM))
    b = GEMM[0] // GEMM[1]
    c = np.block([[_np(rep.results[f"gemm-C-{i}-{j}"]) for j in range(b)] for i in range(b)])
    np.testing.assert_allclose(c, tgemm.gemm_expected(*GEMM), rtol=1e-5, atol=1e-6)
    rep = tcore.WukongEngine().compute(tsvc.svc_dag(*SVC))
    np.testing.assert_allclose(_np(rep.results[f"svc-w{SVC[2]}"]), tsvc.svc_expected(*SVC),
                               rtol=1e-4, atol=1e-5)


def test_default_device_is_cuda_and_nothing_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works there")
    code = ("from repro_torch.apps.device import resolve\n"
            "from repro_torch.apps.gemm import gemm_dag\n"
            "from repro_torch.core import WukongEngine\n"
            "print(resolve(), flush=True)\n"
            "WukongEngine().compute(gemm_dag(64, 32))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=300)
    assert out.stdout.strip() == "cuda"
    assert out.returncode != 0 and "JobError" in out.stderr and "CUDA" in out.stderr
    with app_device.on_device("cuda"):
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            tsvd.tsqr_singular_values_expected(64, 8, 2)
    assert app_device.resolve() == torch.device("cpu")


def test_on_device_restores_the_default():
    from repro_torch.apps import device as d

    assert d.resolve() == torch.device("cpu")  # the autouse fixture's
    with d.on_device("meta"):
        assert d.resolve() == torch.device("meta")
        assert d.resolve("cpu") == torch.device("cpu")
    assert d.resolve() == torch.device("cpu")


def test_launcher_runs_every_app_on_cpu(capsys):
    records = launch_apps.main(["--device", "cpu", "--gemm", "128", "64",
                                "--tsqr", "512", "32", "4", "--rsvd", "256", "4",
                                "--svc", "1024", "4", "2"])
    out = capsys.readouterr().out
    assert [r["app"] for r in records] == ["gemm", "tsqr", "rsvd", "rsvd", "svc"]
    assert all(r["check"]["ok"] for r in records), records
    normal, ideal = records[2:4]
    assert ideal["bytes_written"] < normal["bytes_written"]
    assert ideal["check"]["singular_values"] == normal["check"]["singular_values"]
    assert "Fig. 13 breakdown" in out and normal["breakdown"]["tasks"] == normal["tasks"]


# ---------------------------------------------------------------------------
# The copied orchestrator against the JAX one
# ---------------------------------------------------------------------------


def _states(orch, core):
    sub = orch.last_substrate
    machine = core.JobStateMachine(sub.control())
    sub.clock.run(machine.replay_g())
    return machine.jobs()


def _run_both(make_cfg, recover=False):
    out = []
    for core in (jcore, tcore):
        orch = core.JobOrchestrator(make_cfg(core))
        rep = orch.run_with_recovery() if recover else orch.run()
        out.append((orch, dataclasses.asdict(rep), _states(orch, core)))
    return out


def _default_mix(core):
    return core.OrchestratorConfig(workload=core.WorkloadConfig(n_jobs=12, seed=0))


def test_orchestrator_default_mix_equals_jax():
    (_, j, js), (_, t, ts) = _run_both(_default_mix)
    assert {r["app"] for r in j["job_records"]} >= {"gemm", "svd", "svc", "tree_reduction"}
    assert j["completed"] == j["jobs"] == 12 and j["failed"] == 0
    assert t == j
    assert ts == js and set(js.values()) == {jcore.COMPLETED}


def _crashing_mix(core):
    return core.OrchestratorConfig(
        engine=core.EngineConfig(num_initial_invokers=2, num_proxy_invokers=2,
                                 max_concurrency=64),
        workload=core.WorkloadConfig(n_jobs=8, arrival_rate_per_s=8.0, seed=0),
        max_concurrent_jobs=3,
        faults=core.FaultConfig(orchestrator_crash_point="dispatch",
                                orchestrator_crash_at=2))


def test_orchestrator_crash_recovery_equals_jax():
    (_, j, js), (_, t, ts) = _run_both(_crashing_mix, recover=True)
    assert j["crashes"] == 1 and j["recovered_jobs"] > 0
    assert j["completed"] == j["jobs"] and j["failed"] == 0
    assert {r["app"] for r in j["job_records"]} - {"tree_reduction"}
    assert t == j and ts == js


def _streaming(core):
    stream = core.StreamConfig(n_events=40, rate_per_s=40.0, seed=3, flush_event="eos")
    action = {"app": "tree_reduction", "size": 8, "tenant": "tenant-a"}
    return core.OrchestratorConfig(
        engine=core.EngineConfig(num_initial_invokers=4, num_proxy_invokers=4,
                                 max_concurrency=512),
        workload=core.WorkloadConfig(n_jobs=4, seed=1, tenants=(
            core.TenantSpec("tenant-a"), core.TenantSpec("tenant-b"))),
        max_concurrent_jobs=8,
        triggers=(
            core.TriggerRule("window", "kv_write", action,
                             key_prefix=stream.store_prefix, window_ms=250.0),
            core.TriggerRule("tick", "timer", {"app": "svc", "size": (512, 4, 2),
                                               "tenant": "tenant-b"},
                             period_ms=700.0, max_fires=2),
            core.TriggerRule("ckpt", "job_completed", {"app": "gemm", "size": (64, 32),
                                                       "tenant": "tenant-b"},
                             job_app="tree_reduction", every_n=4),
            core.TriggerRule("flush", "external", action, event="eos", flush_windows=True),
        ),
        stream=stream)


def test_orchestrator_streaming_equals_jax():
    (jo, j, js), (to, t, ts) = _run_both(_streaming)
    fires = [dataclasses.asdict(orch.last_substrate.trigger_bus.report(n_events=40))
             for orch in (jo, to)]
    assert j["completed"] == j["jobs"] > 4 and j["failed"] == 0
    for source in ("timer", "kv_write", "job_completed", "external"):
        assert fires[0]["fires"].get(source, 0) >= 1, (source, fires[0])
    assert {r["app"] for r in j["job_records"]} >= {"svc", "gemm"}
    assert t == j and ts == js
    assert fires[1] == fires[0]
    assert to.last_substrate.trigger_bus.fired_records() == \
        jo.last_substrate.trigger_bus.fired_records()


# ---------------------------------------------------------------------------
# The copied analysis package
# ---------------------------------------------------------------------------


def test_port_sanitizer_traces_the_port_clocks():
    from repro_torch.analysis import Tracer, diff_traces

    def actor():
        for ms in (3.0, 1.0, 2.0):
            yield ("charge", ms)
        yield ("flush",)
        return 6.0

    traces = []
    for clock_cls in (tcore.EventClock, tcore.VirtualClock):
        clock = clock_cls()
        clock.tracer = Tracer()
        assert clock.run(actor()) == 6.0
        traces.append(clock.tracer)
    assert [e.charge for e in traces[0].events if e.effect == "charge"] == [3.0, 1.0, 2.0]
    assert diff_traces(*traces) is None


def test_port_lint_cli_checks_the_port_by_default(capsys):
    import json

    from repro_torch.analysis.__main__ import main

    assert main(["--baseline", str(SRC.parent / "analysis-baseline.json")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["checked_files"] == len(list((SRC / "repro_torch").rglob("*.py")))
    assert out["findings"] == []
