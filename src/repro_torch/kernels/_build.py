"""Build the CUDA kernels with nvcc and load them through ctypes.

Every ``csrc/*.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` (Hopper) at first use, one ``nvcc`` per
source, all started together. Libraries go to ``build/repro_torch/`` at
the repository root, named by a hash of the source and flags, so a build
is reused until a source changes. Importing this module needs no nvcc:
only ``library()`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; returns name -> path.

    Compiler output (``-Xptxas=-v``: registers, shared memory, spills)
    is kept beside each library as ``<name>-<hash>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, BUILD_DIR / f"{src.stem}-{_digest(src)}.so")
               for src in sorted(CSRC.glob("*.cu"))}
    jobs = []
    for name, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        jobs.append((name, tmp, out, log,
                     subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, out, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds at first use)."""
    with _lock:
        if name not in _libs:
            for stem, path in build_all().items():
                _libs.setdefault(stem, ctypes.CDLL(str(path)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
