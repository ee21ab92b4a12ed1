"""Shared pieces of the benchmark's CPU tests: tiny copies of the cells'
configurations, and a card check made inside fixtures, never at import."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny_config(name: str, **kw) -> dict:
    """Configuration ``name`` at widths a CPU test can hold, its pattern,
    routing and dtype kept."""
    from portbench import harness as H

    c = copy.deepcopy(H.read_json(H.HERE / "configs" / f"{name}.json"))
    c.update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=128)
    c.pop("mamba_dt_rank", None)
    if c["router_experts"] > c["n_experts"]:
        c.update(router_experts=8, n_experts=4)
    else:
        c.update(router_experts=4, n_experts=4)
    c.update(kw)
    return c


def tiny_cell(workload: str, config: dict | None = None, **traffic) -> dict:
    from portbench import harness as H

    cell = H.cell(workload)
    cell["config"] = config or tiny_config(cell["workload"]["config"])
    cell["traffic"].update(traffic)
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the harness measures the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
