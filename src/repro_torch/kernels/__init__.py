"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``) on the LM path.

Each kernel ships a source (``csrc/<name>.cu``, plain C entry point), a
launcher (``<name>.py``, ctypes), a plain PyTorch version (``ref.py``) and
a public wrapper (``ops.py``) that picks one or the other by device.
``_build.py`` compiles the sources with nvcc at first CUDA use.
"""
