"""Serving through the port's engine copy, and the copy itself.

- The port's serving path (``repro_torch.launch.serve``, reduced smollm on
  the CPU) gives the same greedy tokens as the JAX ``decode_step`` loop on
  the same prompts and converted params.
- A faulted numpy DAG gives identical results, ``charged_ms`` and
  ``kv_stats`` through ``repro.core`` and ``repro_torch.core``.
- Every copied engine file equals its original after the import rewrite.
- ``repro_torch`` imports neither JAX nor anything of ``repro``.
"""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve

SRC = Path(__file__).resolve().parents[1] / "src"

COPIED = ([f"core/{n}.py" for n in ("api", "cache", "dag", "engine", "executor", "faults",
                                     "invoker", "kvstore", "optimize", "schedule",
                                     "simclock")]
          + ["analysis/dagcheck.py", "models/config.py"]
          + [f"platform/{p.name}" for p in sorted((SRC / "repro/platform").glob("*.py"))]
          + [f"configs/{p.name}" for p in sorted((SRC / "repro/configs").glob("*.py"))])
_RENAME = re.compile(r"\brepro\.(core|analysis|platform|models|configs)\b")


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_equals_original_after_import_rewrite(rel):
    original = (SRC / "repro" / rel).read_text()
    assert (SRC / "repro_torch" / rel).read_text() == \
        _RENAME.sub(r"repro_torch.\1", original)


def test_serve_greedy_tokens_match_jax_decode_loop():
    jcfg = jax_reduced(jax_get_config("smollm_360m"))
    tcfg = reduced(get_config("smollm_360m"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    requests, batch, prompt_len, gen_len, seed = 2, 2, 5, 6, 11
    rep = tserve.serve(tcfg, tparams, requests=requests, batch=batch,
                       prompt_len=prompt_len, gen_len=gen_len, seed=seed, device="cpu")
    assert rep.results["summary"]["n"] == requests
    step = jax.jit(JM.decode_step, static_argnums=1)
    for rid in range(requests):
        prompt = tserve.request_prompts(seed, rid, batch, prompt_len, jcfg.vocab)
        cache = JM.init_cache(jcfg, batch, prompt_len + gen_len)
        tok, generated = jnp.asarray(prompt[:, 0]), []
        for pos in range(prompt_len + gen_len - 1):
            logits, cache = step(jparams, jcfg, cache, tok, jnp.int32(pos))
            if pos + 1 < prompt_len:
                tok = jnp.asarray(prompt[:, pos + 1])
            else:
                tok = jnp.argmax(logits, axis=-1)
                generated.append(np.asarray(tok))
        got = rep.results["summary"]["tokens"][rid]
        assert isinstance(got, np.ndarray) and got.shape == (batch, gen_len)
        np.testing.assert_array_equal(got, np.stack(generated, axis=1))


def test_serve_main_runs_on_cpu():
    rep = tserve.main(["--device", "cpu", "--requests", "2", "--batch", "2",
                       "--prompt-len", "3", "--gen-len", "3", "--seed", "4"])
    again = tserve.main(["--device", "cpu", "--requests", "2", "--batch", "2",
                         "--prompt-len", "3", "--gen-len", "3", "--seed", "4"])
    for got, want in zip(rep.results["summary"]["tokens"],
                         again.results["summary"]["tokens"], strict=True):
        np.testing.assert_array_equal(got, want)


def _fan_in_dag(core):
    """8 numpy leaves -> pairwise sums -> one total."""
    g = core.GraphBuilder()
    leaves = [g.add(np.full, (64, 64), float(i), name=f"leaf-{i}") for i in range(8)]
    while len(leaves) > 1:
        leaves = [g.add(np.add, a, b, name=f"sum-{a.key}-{b.key}")
                  for a, b in zip(leaves[::2], leaves[1::2])]
    return g.build()


@pytest.mark.parametrize("fault_seed", [3, 5])
def test_engine_copy_prices_a_faulted_dag_identically(fault_seed):
    reports = []
    for core in (jcore, tcore):
        cfg = core.EngineConfig(faults=core.FaultConfig(
            task_failure_prob=0.2, max_retries=6, seed=fault_seed))
        reports.append(core.WukongEngine(cfg).compute(_fan_in_dag(core)))
    j, t = reports
    assert j.fault_stats["injected_failures"] > 0
    assert j.results.keys() == t.results.keys()
    for key in j.results:
        np.testing.assert_array_equal(j.results[key], t.results[key])
    assert j.charged_ms == t.charged_ms
    assert j.kv_stats == t.kv_stats
    assert j.fault_stats == t.fault_stats


def test_port_imports_neither_jax_nor_repro():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": len(names), "bad": bad}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         check=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["imported"] >= 30 and res["bad"] == []


def test_port_source_has_no_jax_or_repro_import():
    found = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
            else:
                continue
            found += [(path.name, r) for r in roots if r in ("jax", "jaxlib", "repro")]
    assert found == []
