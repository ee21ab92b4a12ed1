"""What every cell shares: finding its files by name, building the program's
configuration, making the weights from the seed, the device record, the
per-layer metric readers and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
sizes are ``configs/<config>.json``, and a traffic mix, whose parameters
are ``traffic/<traffic>.json``. The mix's ``kind`` names the driver,
``kinds/<kind>.py``, which runs set-up, the measured window, the traced
stretch and the comparison with the plain reference. The limits of that
comparison are ``limits/<workload>.json``, and a per-layer metric is read by
``metrics/<metric>.py``. A cell or a metric is added by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs() -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout (the program's nvcc builds already go to ``build/repro_torch``)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def program_path() -> None:
    """Make the program (``src/repro_torch``) and this package importable."""
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def read_json(path: Path) -> Any:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(workload: str) -> dict:
    """The workload's entry with its configuration, traffic and limits
    loaded: keys ``workload``, ``config``, ``traffic``, ``limits``, and
    ``end_to_end`` and ``per_layer``, the metric entries the cell reports."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"workload": entry,
            "config": read_json(HERE / "configs" / f"{entry['config']}.json"),
            "traffic": read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "limits": read_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_file(HERE / "kinds" / f"{kind}.py", f"portbench_kind_{kind}")


def reader(metric: str) -> Callable[[dict], float | None]:
    """``metrics/<metric>.py``'s ``read(record) -> value or None``."""
    return load_file(HERE / "metrics" / f"{metric}.py",
                     "portbench_metric_" + metric.replace(".", "_")).read


# ---------------------------------------------------------------------------
# The program's configuration and the weights
# ---------------------------------------------------------------------------

MODEL_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "sliding_window", "activation", "rope_theta", "norm_eps",
              "tie_embeddings", "dtype", "moe_capacity_factor", "moe_group", "remat",
              "ssm_state_dim", "ssm_conv_width", "ssm_expand")


def model_config(c: dict):
    """The program's ``ModelConfig`` for configuration ``c``: its router over
    ``router_experts``, ``n_experts`` of them held on this card."""
    from repro_torch.models import ssm
    from repro_torch.models.config import ModelConfig, MoEConfig

    moe = None
    if any(e.endswith("+moe") for e in c["block_pattern"]):
        moe = MoEConfig(n_experts=c["router_experts"], top_k=c["top_k"])
    cfg = ModelConfig(name=c["model_name"], block_pattern=tuple(c["block_pattern"]), moe=moe,
                      **{k: c[k] for k in MODEL_KEYS})
    if "mamba_dt_rank" in c and ssm.mamba_dt_rank(cfg) != c["mamba_dt_rank"]:
        raise ValueError(f"the program's mamba dt rank {ssm.mamba_dt_rank(cfg)} is not the "
                         f"configuration's {c['mamba_dt_rank']}")
    return cfg


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream (weights, a step's rows, a job's prompts)."""
    import numpy as np

    entropy = [seed & 0xFFFF_FFFF_FFFF_FFFF, *tags]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHTS_STREAM = 1


def _init_rule(path: tuple[str, ...], shape: tuple[int, ...]) -> tuple[str, float]:
    """How a leaf starts: ("normal", std) or ("const", value); ``A_log``
    is ("arange_log", 0). The program's own initial scales: fan-in⁻½ for a
    matrix (its rows, ``shape[-2]``), 0.02 for the embedding and the head."""
    name = path[-1].strip("[]'")
    if name == "scale" or name == "D":
        return "const", 1.0
    if name == "conv_b":
        return "const", 0.0
    if name == "dt_bias":
        return "const", -4.6
    if name == "A_log":
        return "arange_log", 0.0
    if name in ("embed", "lm_head"):
        return "normal", 0.02
    return "normal", shape[-2] ** -0.5


def weight_shapes(c: dict, cfg) -> Any:
    """The program's parameter tree (``model.abstract_params``) as meta
    tensors, each MoE block's expert leaves cut to the ``n_experts`` held."""
    import torch

    from repro_torch.models import model as M

    tree = M.abstract_params(cfg)
    held = c["n_experts"]
    for block, entry in zip(tree["blocks"], c["block_pattern"]):
        if entry.endswith("+moe"):
            block["mlp"] = {k: (v if k == "router" else
                                torch.empty((v.shape[0], held, *v.shape[2:]), dtype=v.dtype,
                                            device="meta"))
                            for k, v in block["mlp"].items()}
    return tree


def make_params(c: dict, cfg, seed: int, device) -> Any:
    """The weights of configuration ``c`` from ``seed``, on ``device`` in the
    dtypes they are served in: one ``normal_`` draw per dtype over one flat
    buffer from a generator on the device, each leaf a view of it scaled in
    place; constant leaves filled."""
    import torch

    from repro_torch.tree import paths, unflatten

    tree = weight_shapes(c, cfg)
    shapes = list(paths(tree))
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, WEIGHTS_STREAM))
    drawn: dict[torch.dtype, int] = {}
    rules = [_init_rule(p, tuple(t.shape)) for p, t in shapes]
    for (_, t), (kind, _) in zip(shapes, rules):
        if kind == "normal":
            drawn[t.dtype] = drawn.get(t.dtype, 0) + t.numel()
    flat = {dt: torch.empty(n, dtype=dt, device=device).normal_(generator=gen)
            for dt, n in drawn.items()}
    used = dict.fromkeys(drawn, 0)
    out = []
    for (path, t), (kind, val) in zip(shapes, rules):
        if kind == "normal":
            at = used[t.dtype]
            leaf = flat[t.dtype][at:at + t.numel()].view(t.shape).mul_(val)
            used[t.dtype] = at + t.numel()
        elif kind == "const":
            leaf = torch.full(t.shape, val, dtype=t.dtype, device=device)
        else:
            n = t.shape[-1]
            leaf = torch.log(torch.arange(1, n + 1, dtype=t.dtype, device=device)).expand(
                t.shape).contiguous()
        out.append(leaf)
    return unflatten(tree, out)


# ---------------------------------------------------------------------------
# The run's record
# ---------------------------------------------------------------------------

def require_cards(chips: int) -> None:
    """Stop, printing no result, unless ``chips`` CUDA devices are there."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; the benchmark measures the card and "
                         "reports nothing from a CPU run")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")


def device_record(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def checks_text(checks: dict) -> str:
    return "; ".join(f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items())
