"""WUKONG core: decentralized serverless DAG engine (the paper's contribution)."""
from repro_torch.core.api import GraphBuilder, delayed_graph
from repro_torch.core.cache import (
    CacheConfig,
    CacheRegistry,
    CacheStats,
    ExecutorCache,
)
from repro_torch.core.dag import (
    DAG,
    EXPAND_BASE,
    DynamicDAG,
    Expansion,
    ExpansionDelta,
    ExpansionError,
    Task,
    TaskRef,
    expansion_base_key,
)
from repro_torch.core.engine import (
    ENGINES,
    CentralizedConfig,
    EngineConfig,
    JobError,
    JobReport,
    JobSubstrate,
    ParallelInvokerEngine,
    PubSubEngine,
    ServerfulConfig,
    ServerfulEngine,
    StrawmanEngine,
    WukongEngine,
)
from repro_torch.core.faults import (
    FaultConfig,
    FaultInjector,
    FaultStats,
    SimulatedTaskFailure,
)
from repro_torch.core.kvstore import PURGED, CostModel, KVNamespace, ShardedKVStore
from repro_torch.core.optimize import (
    ALL_PASSES,
    NO_PASSES,
    CompiledDAG,
    OptimizeConfig,
    PassStats,
    compile_dag,
)
from repro_torch.core.orchestrator import (
    JobOrchestrator,
    JobRequest,
    OrchestratorConfig,
    OrchestratorCrashed,
    OrchestratorReport,
    Substrate,
    TenantSpec,
    WorkloadConfig,
    generate_workload,
)
from repro_torch.core.schedule import StaticSchedule, generate_static_schedules
from repro_torch.core.simclock import (
    EventClock,
    RealtimeClock,
    VirtualClock,
    clock_for_scale,
    drain_worker_cache,
    run_effects,
    simulated_compute,
    worker_cache_size,
)
from repro_torch.core.statemachine import (
    ADMITTED,
    CANCELLED,
    COMPLETED,
    CONTROL_NS,
    FAILED,
    PENDING,
    RUNNING,
    TERMINAL_STATES,
    InvalidTransition,
    JobStateMachine,
)
from repro_torch.core.triggers import (
    TRIGGER_NS,
    TRIGGER_SOURCES,
    StreamConfig,
    StreamingReport,
    TriggerBus,
    TriggerRule,
    stream_arrivals,
    stream_source,
)


def __getattr__(name):
    # Lazy re-export of the platform surface (PEP 562): an eager import
    # would close the repro_torch.platform -> repro_torch.core.kvstore ->
    # repro_torch.core.__init__ cycle and break `import repro_torch.platform` in a
    # fresh process.
    if name in ("FaaSPlatform", "PlatformConfig"):
        import repro_torch.platform

        return getattr(repro_torch.platform, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "DAG", "Task", "TaskRef", "GraphBuilder", "delayed_graph",
    "DynamicDAG", "Expansion", "ExpansionDelta", "ExpansionError",
    "EXPAND_BASE", "expansion_base_key",
    "ENGINES", "EngineConfig", "CentralizedConfig", "ServerfulConfig",
    "JobError", "JobReport", "JobSubstrate", "WukongEngine",
    "StrawmanEngine", "PubSubEngine", "ParallelInvokerEngine",
    "ServerfulEngine",
    "FaultConfig", "FaultInjector", "FaultStats", "SimulatedTaskFailure",
    "CacheConfig", "CacheStats", "ExecutorCache", "CacheRegistry",
    "CostModel", "ShardedKVStore", "KVNamespace", "PURGED",
    "TriggerBus", "TriggerRule", "StreamConfig", "StreamingReport",
    "TRIGGER_NS", "TRIGGER_SOURCES", "stream_arrivals", "stream_source",
    "JobOrchestrator", "JobRequest", "OrchestratorConfig",
    "OrchestratorCrashed", "OrchestratorReport", "Substrate", "TenantSpec",
    "WorkloadConfig", "generate_workload",
    "JobStateMachine", "InvalidTransition", "CONTROL_NS",
    "PENDING", "ADMITTED", "RUNNING", "COMPLETED", "FAILED", "CANCELLED",
    "TERMINAL_STATES",
    "StaticSchedule", "generate_static_schedules",
    "OptimizeConfig", "CompiledDAG", "PassStats", "compile_dag",
    "ALL_PASSES", "NO_PASSES",
    "EventClock", "VirtualClock", "RealtimeClock", "clock_for_scale",
    "run_effects", "drain_worker_cache", "worker_cache_size",
    "simulated_compute",
    "PlatformConfig", "FaaSPlatform",
]
