"""Quickstart: ``python -m repro_torch.launch.quickstart``

The counterpart of ``examples/quickstart.py`` on the port's copy of the
engine: build the paper's Figure 6 DAG with torch payloads, run it on
WUKONG, on every design iteration, through the DAG compiler, on the
stateful platform model, and as multi-tenant traffic through the job
orchestrator. It runs no model, so it takes no ``--device``: the payloads
are four-element CPU tensors. The engine prices a payload by its bytes
and a task's shipped code by its function's name, so the tasks keep the
reference's names and their outputs its sizes, and every line it prints
equals the reference's.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.core import (
    ENGINES,
    EngineConfig,
    GraphBuilder,
    JobOrchestrator,
    OrchestratorConfig,
    PlatformConfig,
    WorkloadConfig,
    WukongEngine,
)


def cumsum(x: torch.Tensor) -> torch.Tensor:  # named as the reference's np.cumsum
    return torch.cumsum(x, dim=0)


def main() -> None:
    # --- 1. author a workflow (the paper's Figure 6 DAG) ---------------
    g = GraphBuilder()
    t1 = g.add(lambda: torch.arange(4.0, dtype=torch.float64), name="T1")
    t2 = g.add(lambda: torch.ones(4, dtype=torch.float64), name="T2")
    t3 = g.add(lambda x: x * 2, t2, name="T3")
    t5 = g.add(cumsum, t3, name="T5")
    t4 = g.add(operator.add, t1, t3, name="T4")
    g.add(lambda a, b: float(a.sum() + b.sum()), t4, t5, name="T6")
    dag = g.build()
    print(f"DAG: {len(dag)} tasks, leaves={dag.leaves}, roots={dag.roots}")

    # --- 2. run it decentralized (WUKONG) -------------------------------
    report = WukongEngine().compute(dag)
    print(f"WUKONG result: {report.results}  "
          f"(executors={report.executors_invoked}, "
          f"kv={report.kv_stats['puts']} puts/{report.kv_stats['gets']} gets)")

    # --- 3. same DAG on every design iteration --------------------------
    for name, Engine in ENGINES.items():
        rep = Engine().compute(dag)
        print(f"  {name:18s} -> {rep.results['T6']:.1f}  "
              f"simulated-cost {rep.charged_ms:7.1f} ms")

    # --- 4. through the DAG compiler (fusion/clustering/coalescing) -----
    opt = WukongEngine().compute(g.build(optimize=True))
    print(f"optimized: {opt.results}  "
          f"(executors={opt.executors_invoked}, "
          f"kv puts={opt.kv_stats['puts']}, passes={[s.name for s in opt.optimizer]})")

    # --- 5. on the stateful platform model: what did the job COST? ------
    billed = WukongEngine(EngineConfig(
        platform=PlatformConfig(memory_mb=1792, keep_alive_s=600.0)
    )).compute(dag)
    ps = billed.platform_stats
    print(f"platform: billed ${ps['billed_usd']:.9f} "
          f"({ps['billed_requests']} requests, "
          f"{ps['billed_gb_s']:.4f} GB-s; "
          f"cold={ps['cold_starts']}, warm={ps['warm_reuses']}, "
          f"peak concurrency={ps['peak_concurrency']})")

    # --- 6. multi-tenant traffic on ONE shared platform -----------------
    traffic = JobOrchestrator(OrchestratorConfig(
        workload=WorkloadConfig(n_jobs=16, arrival_rate_per_s=4.0,
                                app_mix=(("tree_reduction", 1.0),)),
        max_concurrent_jobs=8,
    )).run()
    print(f"orchestrator: {traffic.completed}/{traffic.jobs} jobs, "
          f"p50={traffic.p50_s:.3f}s p99={traffic.p99_s:.3f}s, "
          f"warm share {traffic.warm_share * 100:.0f}%, "
          f"account bill ${traffic.billed_usd_total:.9f} across "
          f"{len(traffic.per_tenant)} tenants")


if __name__ == "__main__":
    main()
