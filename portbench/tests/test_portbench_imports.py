"""The harness loads neither JAX nor the JAX package, and reports nothing
without a card."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench import harness as H

PROBE = r"""
import importlib, json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
import portbench.run
from portbench import harness as H
for f in sorted((root / "portbench").rglob("*.py")):
    rel = f.relative_to(root)
    if rel.parts[1] == "tests":
        continue
    if rel.parts[1] in ("metrics", "kinds"):
        H.load_file(f, "probe_" + "_".join(rel.with_suffix("").parts).replace(".", "_"))
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts))
for entry in ("repro_torch.launch.serve", "repro_torch.runtime.train",
              "repro_torch.runtime.orchestrator", "repro_torch.optim", "repro_torch.kernels.ops",
              "repro_torch.models.model", "repro_torch.core"):
    importlib.import_module(entry)      # every entry point a run drives
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_or_jax_package_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE, str(H.ROOT)], capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin"})
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "portbench.run" in loaded
    bad = sorted({m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")})
    assert bad == []
    assert any(m.split(".")[0] == "repro_torch" for m in loaded)   # the port itself is fine


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert not {"repro_torch_probe", "jaxtyping_probe"} & set(H.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in H.forbidden_modules()


def test_a_cpu_run_reports_nothing():
    out = subprocess.run([sys.executable, str(H.HERE / "run.py"), "--workload",
                          "mixtral_8x7b.train_b4s512", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_reports_nothing(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files the
    program is missing, and the run fails before it prints a result."""
    import shutil

    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mixtral_8x7b.train_b4s512", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
