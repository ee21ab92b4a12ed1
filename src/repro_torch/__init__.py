"""PyTorch port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s layout. ``core`` (the WUKONG engine, the multi-tenant
orchestrator, the job state machine and the trigger bus), ``platform`` and
``analysis`` (DAG checks, the determinism lint and sanitizer) are verbatim
copies with their imports renamed, but for the engine's ``tracing`` spans.
``apps`` holds the paper's workloads: tree reductions copied as they are,
GEMM, the two SVDs and SVC rewritten with torch payloads on a chosen device
(``apps.device``). ``models``/``kernels``/``runtime``/``optim``/``launch``
serve and train the LMs in PyTorch, with the Pallas TPU kernels rewritten as
CUDA C++ kernels for ``sm_90a``. ``tracing`` records spans and counters while
a torch profiler records. Imports ``torch`` and never ``jax`` or ``repro``.
"""
