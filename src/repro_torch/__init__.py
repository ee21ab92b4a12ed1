"""PyTorch port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s layout: ``core``/``platform``/``analysis`` hold a
verbatim copy of the WUKONG engine, ``models``/``kernels``/``runtime``/
``launch`` the LM serving path in PyTorch, with the Pallas TPU kernels
rewritten as CUDA C++ kernels for ``sm_90a``. Imports ``torch`` and never
``jax`` or ``repro``.
"""
