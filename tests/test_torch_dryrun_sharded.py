"""The sharded dry run (``dryrun.trace(..., mesh=)``) against real sharded runs.

The cells of ``_torch_sharded_cases.CELLS`` (reduced dense, GQA with H = 8
and K = 2, mixtral's MoE with 4 experts, whisper's encoder-decoder, one
superblock of jamba's mamba and MoE; train, prefill and decode) run three
ways, each in a process of its own, all three at once (``runs``):

- four gloo ranks run each cell on real CPU tensors as DTensors on a 2×2
  and a 1×4 ("data", "model") mesh: its outputs equal the unsharded step's
  (logits, loss, gradient norm and AdamW moments 1e-5 relative, parameters
  after one AdamW step 2e-3), and its collectives, as the dry run's
  ``CollectiveCounter`` and as ``CommDebugMode`` count them, equal the fake
  world's trace of the same cell on the same mesh exactly, kind by kind;
  and the MoE MLP alone in bf16 under expert parallelism gives the
  unsharded MLP's bits;
- the reference's ``build_cell`` on a 2×2 mesh of its host devices gives
  the same logits, decode cache, loss, gradient norm and moments (1e-5
  relative) and parameters (2e-3), and puts the same shard shape of every
  parameter, optimizer and cache leaf on a device; its collective tally is
  printed beside the port's (``-s``): a report, not a gate;
- bounds that catch a quiet gather: at pure tensor parallelism (1×4) the
  dense and GQA prefills issue exactly the collectives Megatron's layout
  needs, the decode cells' collectives do not grow with the cache, and
  per-device FLOPs times the chips equal the unsharded trace's where every
  sharded dimension divides;
- the depth probes of a sharded trace under FSDP extrapolate to the whole
  trace: FLOPs, bytes, kernel calls and collectives exactly, the peak
  within 1 %.

Last, the decode kernel's plain version writes each row's log-sum-exp.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

import _torch_sharded_cases as C
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
KEYS = [f"{c}@{m}" for m in C.MESHES for c in C.CELLS]
# every sharded dimension divides on both meshes: each device does 1/chips of the FLOPs
EVEN = ("dense_prefill", "dense_train", "dense_decode", "gqa_prefill", "gqa_train",
        "gqa_decode", "whisper_prefill", "whisper_train")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = {run: subprocess.Popen([sys.executable, str(ROOT / "tests/_torch_sharded_cases.py"),
                                    run, str(out)], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for run in ("real", "fake", "jax")}
    logs = {run: p.communicate(timeout=600)[0] for run, p in procs.items()}
    for run, p in procs.items():
        assert p.returncode == 0, logs[run][-4000:]
    return {run: json.loads((out / f"{run}.json").read_text()) for run in procs} | {"dir": out}


def _rel(err, scale):
    return err / max(scale, 1e-30)


def _check(name, err, scale):
    """Parameters after one AdamW step within 2e-3, the repo's microbatched
    step limit; the rest within 1e-5 of its leaf's largest magnitude: logits,
    loss, the decode cache, and the backward's own outputs, the gradient norm
    and both AdamW moments (mu = (1 - b1)·g and nu = (1 - b2)·g² after the
    first step). The first step moves a parameter by about the learning rate,
    3e-4 / 200, far inside 2e-3: the moments are what hold the gradients."""
    if name.startswith("param"):
        assert err < 2e-3, (name, err)
    else:
        assert _rel(err, scale) < 1e-5, (name, err, scale)


@pytest.mark.parametrize("key", KEYS)
def test_sharded_step_equals_the_unsharded_one(runs, key):
    rec = runs["real"][key]
    if "train" in key:
        assert {"grad_norm", "mu0", "nu0"} <= set(rec["errors"])
    for name, err in rec["errors"].items():
        _check(name, err, rec["scale"][name])


@pytest.mark.parametrize("mesh", C.MESHES)
def test_expert_parallel_moe_rounds_as_the_unsharded_one_in_bf16(runs, mesh):
    """Each device adds its experts' share of a token's k weighted outputs in
    fp32, the shares are all-reduced in fp32 and the sum is rounded once, as
    the unsharded MLP rounds it: at top-2 the same bits, where a bf16
    rounding per device before the sum would differ."""
    assert runs["real"][f"moe_bf16@{mesh}"] == 0.0


@pytest.mark.parametrize("key", KEYS)
def test_trace_tally_equals_the_real_run(runs, key):
    real, fake = runs["real"][key]["tally"], runs["fake"][key]["tally"]
    assert real == fake
    counts = {k.removesuffix("_count"): v for k, v in real.items() if k.endswith("_count") and v}
    assert runs["real"][key]["comm_debug"] == counts


@pytest.mark.parametrize("cell", C.REFERENCE_CELLS)
def test_sharded_step_equals_the_references(runs, cell):
    port = np.load(runs["dir"] / f"port_{cell}.npz")
    ref_out = np.load(runs["dir"] / f"jax_{cell}.npz")
    assert set(ref_out.files) == set(port.files)
    for name in ref_out.files:
        _check(name, float(np.abs(port[name] - ref_out[name]).max()),
               float(np.abs(ref_out[name]).max()))
    jt = {k: v for k, v in runs["jax"][cell]["tally"].items() if v}
    pt = {k: v for k, v in runs["real"][f"{cell}@2x2"]["tally"].items() if v}
    print(f"\n{cell} on 2x2: reference {jt}\n{' ' * len(cell)}           port {pt}")


@pytest.mark.parametrize("cell", C.REFERENCE_CELLS)
def test_shard_shapes_equal_the_references(runs, cell):
    assert runs["fake"][f"{cell}@2x2"]["shard_shapes"] == runs["jax"][cell]["shard_shapes"]


def _megatron(cell):
    """The collectives of a prefill at pure tensor parallelism over 4 devices:
    the embedding's all-reduce, two all-reduces of the residual per block,
    and the logits' all-gather over the vocab. Where the kv heads do not
    divide the axis, also an all-gather of k and of v per block: the rules
    shard wk and wv along K·hd whenever 4 divides it, which here cuts each
    kv head in half, so a device's q heads find only half of their kv head's
    columns and the halves must be exchanged. The reference's compiled step
    exchanges them too, on the same mesh (printed with ``-s``; PERF.md §4)."""
    c = C.port_cell(cell)
    cfg = c.cfg
    B, S = c.shape.global_batch, c.shape.seq_len
    act = B * S * cfg.d_model * 4
    kv_gathers = 2 * cfg.n_layers if cfg.n_kv_heads % 4 else 0
    want = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                          "collective-permute"), 0)
    want |= {k + "_count": 0 for k in list(want)}
    n_reduce = 1 + 2 * cfg.n_layers
    want["all-reduce"], want["all-reduce_count"] = act * n_reduce, n_reduce
    want["all-gather"] = B * S * cfg.vocab * 4 + kv_gathers * B * S * cfg.n_kv_heads * cfg.hd * 4
    want["all-gather_count"] = 1 + kv_gathers
    want["total"] = want["all-gather"] + want["all-reduce"]
    return want


@pytest.mark.parametrize("cell", C.TENSOR_PARALLEL)
def test_tensor_parallel_prefill_issues_only_megatrons_collectives(runs, cell):
    got = runs["fake"][f"{cell}@1x4"]["tally"]
    jt = {k: v for k, v in runs["jax"][f"{cell}@1x4"]["tally"].items() if v}
    print(f"\n{cell} on 1x4: reference {jt}\n{' ' * len(cell)}           port "
          f"{ {k: v for k, v in got.items() if v} }")
    assert got == _megatron(cell)


@pytest.mark.parametrize("key", [k for k in KEYS if "decode" in k])
def test_sequence_parallel_decode_collectives_do_not_grow_with_the_cache(runs, key):
    short, long = runs["fake"][key]["tally_by_length"]
    assert short == long and short["total"] > 0


@pytest.mark.parametrize("key", [f"{c}@{m}" for m in C.MESHES for c in C.PROBED])
def test_sharded_probes_extrapolate_to_a_whole_trace(runs, key):
    """Under FSDP at 3 superblocks (whisper: and 3 encoder layers): the probes
    at 1 and 2 give the whole trace's FLOPs, bytes, kernel calls and
    collectives exactly, its peak within 1 %."""
    got, want = runs["fake"][key]["probed"]
    for name in ("flops", "bytes_accessed", "kernel_calls", "collective_bytes"):
        assert got[name] == want[name], name
    assert abs(got["peak_bytes"] - want["peak_bytes"]) <= 0.01 * want["peak_bytes"]


@pytest.mark.parametrize("key", KEYS)
def test_flops_per_device_add_up_to_the_unsharded_trace(runs, key):
    cell, mesh = key.split("@")
    chips = int(np.prod(C.MESHES[mesh]))
    per_device, whole = runs["fake"][key]["flops"], runs["fake"][f"{cell}@1x1"]["flops"]
    if cell in EVEN:
        assert per_device * chips == whole
    else:  # the MoE router runs on every device of the model axis
        assert per_device * chips >= whole


# ---------------------------------------------------------------------------
# The decode kernel's log-sum-exp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plain_version_writes_each_rows_logsumexp(dtype):
    """Full (kv_len = S), partial and empty (kv_len 0: -inf, not NaN) rows."""
    gen = torch.Generator().manual_seed(0)
    B, S, H, K, hd = 4, 40, 8, 2, 32
    q = torch.randn((B, H, hd), generator=gen).to(dtype)
    kc, vc = (torch.randn((B, S, K, hd), generator=gen).to(dtype) for _ in range(2))
    kv_len = torch.tensor([S, 17, 1, 0], dtype=torch.int32)
    out, lse = ops.decode_attention(q, kc, vc, kv_len, with_lse=True)
    assert torch.equal(out, ops.decode_attention(q, kc, vc, kv_len))
    scores = torch.einsum("bkgh,bskh->bkgs", q.float().reshape(B, K, H // K, hd),
                          kc.float()) * hd ** -0.5
    for b in range(B):
        n = int(kv_len[b])
        want = (torch.logsumexp(scores[b, ..., :n], dim=-1).reshape(H) if n
                else torch.full((H,), float("-inf")))
        assert lse.dtype == torch.float32 and lse.shape == (B, H)
        torch.testing.assert_close(lse[b], want, rtol=1e-6, atol=1e-5)


def test_decode_fake_lse_matches_the_plain_versions_shapes():
    q, kc = torch.randn(3, 8, 64), torch.randn(3, 100, 2, 64)
    lens = torch.tensor([1, 50, 100], dtype=torch.int32)
    out, lse = ref.decode_attention_ref(q, kc, kc, lens, with_lse=True)
    meta = [t.to("meta") for t in (q, kc, kc, lens)]
    out_m, (lse_m,) = torch.ops.repro_torch.decode_attention(*meta, True)
    assert [(t.shape, t.dtype) for t in (out_m, lse_m)] == [(t.shape, t.dtype) for t in (out, lse)]
    assert torch.ops.repro_torch.decode_attention(*meta, False)[1] == []
