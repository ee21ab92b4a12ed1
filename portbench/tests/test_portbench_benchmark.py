"""``BENCHMARK.json`` within the contract's names, units and shapes, and every
cell's and metric's files found by name."""
from __future__ import annotations

import json
import re

import pytest

from portbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = H.benchmark()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((H.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")


def test_every_name_unit_and_text():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_report_what_they_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        cell = H.cell(w["name"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in {x["name"] for x in cell["end_to_end"]}


def test_configs_name_their_cuts():
    for c in BENCH["configs"]:
        data = H.read_json(H.ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        for key in c["reduced"]:
            assert data[key] < data["published"][key], key
        for key, value in data["published"].items():
            assert key in c["reduced"] or data[key] == value, key


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = H.cell(workload)
    assert (H.HERE / "kinds" / f"{cell['traffic']['kind']}.py").exists()
    assert set(cell["limits"]) and all("limit" in v for v in cell["limits"].values())
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(H.reader(m["name"])), m["name"]


def test_a_new_traffic_file_is_found_by_name(tmp_path, monkeypatch):
    """A cell added as data: a traffic file and a workload entry, nothing else."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "mixtral_8x7b.json").write_text(
        (H.HERE / "configs" / "mixtral_8x7b.json").read_text())
    mix = {"kind": "serve", "batch": 8, "prompt_len": 64, "gen_len": 64, "checked_jobs": 1,
           "trace_jobs": 1}
    (tmp_path / "traffic" / "serve_b8_long.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "mixtral_8x7b.serve_b8_long.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.5}}))
    bench = dict(BENCH, workloads=[{"name": "mixtral_8x7b.serve_b8_long",
                                    "config": "mixtral_8x7b", "traffic": "serve_b8_long",
                                    "chips": 1, "why": "a test"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(H, "HERE", tmp_path)
    monkeypatch.setattr(H, "ROOT", tmp_path)
    cell = H.cell("mixtral_8x7b.serve_b8_long")
    assert cell["traffic"] == mix and cell["limits"]["logit_gap"]["limit"] == 0.5
