"""The dry run (``repro_torch.launch.dryrun``) and the kernels' fake implementations.

- The command line, as its own process, over every arch's cells cut to a
  smoke test's size (``--reduced``) on the 1×1, 16×16 and 2×16×16 meshes,
  and over full-width smollm-360m, mixtral-8x7b and whisper-large-v3: every
  cell ``ok``, its records' argument bytes those of its meta trees, the 1×1
  record the unsharded trace's (no ``collective_bytes``), each production
  mesh's record one device's trace (per-device FLOPs, bytes, peak, fit,
  kernel calls, the reference's eleven collective keys), and nothing of JAX
  or ``repro`` imported.
- The argument bytes equal a real CPU allocation of the same trees.
- A trace's FLOPs equal ``FlopCounterMode`` over a real CPU run of the same
  step (reduced configs), where the plain versions run on the CPU and are
  counted by their kernels' FLOP formulas, as the trace counts the fake
  kernels; its kernel calls equal the plain versions' calls (AdamW's plain
  version standing for its kernels' calls: a sum and an update a leaf and
  one finalize).
- The probes' extrapolation in depth (and in sequence, xLSTM) against a
  full trace: FLOPs, bytes and kernel calls equal, the peak within 1 %.
- Each kernel op's fake implementation on meta tensors gives the shapes
  and dtypes of its plain version's outputs; the FLOP formulas count what
  ``ref._visible`` and the mLSTM's chunks hold.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import mlstm_chunk as mlstm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ShapeConfig, applicable_shapes
from repro_torch.tree import leaves

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
FULL_WIDTH = ["smollm_360m", "mixtral_8x7b", "whisper_large_v3"]


def _tensors(tree):
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


CODE = """import json, sys
from repro_torch.launch import dryrun
rc = dryrun.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(bad))
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The dry run's command line, each run a process of its own, one after
    the other (the suite's workers keep their cores): every arch's reduced
    cells, and the full-width ones through its pool of probe processes. Per
    run: (exit code, output, records by (arch, shape, mesh), the modules of
    JAX or ``repro`` it imported)."""
    argvs = {"reduced": ["--all", "--reduced", "--both-meshes"],  # in process, --jobs 1
             "full": ["--arch", ",".join(FULL_WIDTH), "--both-meshes", "--jobs", "3"]}
    runs = {}
    for k, argv in argvs.items():
        out_dir = tmp_path_factory.mktemp(k)
        proc = subprocess.run([sys.executable, "-c", CODE, *argv, "--out", str(out_dir)],
                              capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        records = {}
        for path in out_dir.glob("*.json"):
            rec = json.loads(path.read_text())
            records[rec["arch"], rec["shape"], rec["mesh"]] = rec
        out = proc.stdout + proc.stderr
        runs[k] = (proc.returncode, out, records, json.loads(proc.stdout.strip().splitlines()[-1]))
    return runs


def _check_records(records, archs, reduce):
    for arch in archs:
        for shape in applicable_shapes(get_config(arch)):
            cfg, shp = D.cell_of(arch, shape, reduce)
            cell = D.build_cell(cfg, shp, D.Variant())
            host = records[arch, shape, "1x1"]
            assert host["ok"], host.get("traceback")
            assert host["argument_bytes"]["total"] == _nbytes(cell.args)
            assert host["memory_analysis"]["argument_size_in_bytes"] == _nbytes(cell.args)
            assert host["argument_bytes"]["params"] == _nbytes(cell.args["params"])
            assert host["flops"] > 0 and host["bytes_accessed"] > 0
            assert host["peak_bytes"] >= host["argument_bytes"]["total"]
            assert host["fits_one_h100"] == (host["peak_bytes"] <= D.H100_BYTES)
            assert host["collective_bytes"] is None and "fits_per_device" not in host
            for name in ("16x16", "2x16x16"):
                rec = records[arch, shape, name]
                assert rec["ok"], rec.get("traceback")
                assert rec["chips"] == (256 if name == "16x16" else 512)
                assert 0 < rec["argument_bytes"]["total"] <= host["argument_bytes"]["total"]
                # one device's share of the step, and what it communicates
                assert 0 < rec["flops"] <= host["flops"]
                assert 0 < rec["bytes_accessed"] and rec["argument_bytes"]["total"] <= rec[
                    "peak_bytes"] <= host["peak_bytes"]
                assert rec["fits_per_device"] == (rec["peak_bytes"] <= D.H100_BYTES)
                assert sum(rec["kernel_calls"].values()) == sum(host["kernel_calls"].values())
                coll = rec["collective_bytes"]
                assert set(coll) == {*D.COLLECTIVES, *(f"{k}_count" for k in D.COLLECTIVES),
                                     "total"}
                assert coll["total"] == sum(coll[k] for k in D.COLLECTIVES) > 0
                assert all(coll[f"{k}_count"] >= (coll[k] > 0) for k in D.COLLECTIVES)


def test_cli_over_reduced_cells_of_every_arch(cli):
    rc, out, records, bad = cli["reduced"]
    assert rc == 0, out
    assert bad == []
    assert "dry-run complete: 34 ok, 0 failed" in out
    assert len(records) == 34 * 3
    _check_records(records, ARCHS, True)


def test_cli_over_full_width_cells(cli):
    rc, out, records, bad = cli["full"]
    assert rc == 0, out
    assert bad == []
    _check_records(records, FULL_WIDTH, False)
    # smollm's 360 M bf16 parameters and fp32 moments at B=256, S=4096 never fit one card
    train = records["smollm_360m", "train_4k", "1x1"]
    assert not train["fits_one_h100"] and train["kernel_calls"] == {
        "flash_attention_bwd": 32, "flash_attention_fwd": 64,  # remat replays each forward
        "adamw_sumsq": 11, "adamw_finalize": 1, "adamw_update": 11}  # its 11 leaves
    assert train["argument_bytes"]["optimizer"] == 2 * 4 * 361821120 + 4


FAILING = """import sys
from repro_torch.launch import dryrun

def refuse(cell, mesh, args=None):
    raise ValueError("planted: this step does not shard")

dryrun.shard_args = refuse
sys.exit(dryrun.main(sys.argv[1:]))
"""


def test_cli_records_a_step_that_does_not_shard_as_failed(tmp_path):
    """In process (``--jobs 1``): a production mesh whose sharded step raises
    gets an ``ok: false`` record with the error and no trace in its place;
    the 1×1 record is the unsharded trace as ever, and the run exits 1."""
    proc = subprocess.run([sys.executable, "-c", FAILING, "--arch", "smollm_360m", "--shape",
                           "decode_32k", "--reduced", "--both-meshes", "--out", str(tmp_path)],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "dry-run complete: 0 ok, 1 failed" in out
    records = {r["mesh"]: r for r in (json.loads(f.read_text()) for f in tmp_path.glob("*.json"))}
    assert records["1x1"]["ok"] and records["1x1"]["flops"] > 0
    for name in ("16x16", "2x16x16"):
        rec = records[name]
        assert not rec["ok"] and "planted: this step does not shard" in rec["error"]
        assert not {"flops", "peak_bytes", "collective_bytes"} & set(rec)


@pytest.fixture
def host_mesh():
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


SMALL = {"train": ShapeConfig("train", "train", 64, 2),
         "prefill": ShapeConfig("prefill", "prefill", 64, 2),
         "decode": ShapeConfig("decode", "decode", 64, 2)}


def _small(arch, kind):
    """A reduced config cut to one superblock (whisper: one encoder layer), at a small shape."""
    cfg, shape = reduced(get_config(arch)), SMALL[kind]
    cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period,
                              n_enc_layers=1 if cfg.enc_dec else 0)
    if arch.startswith("jamba"):  # mamba's chunks of 256
        shape = dataclasses.replace(shape, seq_len=256)
    return cfg, shape


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_a_real_allocation(arch, host_mesh):
    for kind in SMALL:
        cell = D.build_cell(*_small(arch, kind), D.Variant())
        real = D.materialize(cell, "cpu")
        got = D.argument_bytes(cell, host_mesh)
        assert got["total"] == _nbytes(real) == _nbytes(cell.args)
        assert [tuple(t.shape) for t in _tensors(real)] == [
            tuple(t.shape) for t in _tensors(cell.args)]


@contextlib.contextmanager
def kernels_by_formula(fc):
    """The plain versions' own ops hidden from ``fc``; each call counted by
    its kernel op's FLOP formula instead, and the calls tallied. AdamW's
    kernels count no FLOPs, as its plain version's elementwise ops count
    none; its call is tallied as the kernels' calls on its leaves. The MoE
    dispatch's and combine's plain gathers count none either; each call is
    tallied as its kernel's, and its backward kernel's where autograd
    reaches its output."""
    from torch.utils._python_dispatch import _disable_current_modes

    K = torch.ops.repro_torch
    formulas = {
        "flash_attention_ref": (K.flash_attention_fwd, lambda q, k, v, causal, window:
                                ops._flash_fwd_flops(q, k, v, causal, window, False)),
        "flash_attention_bwd_ref": (K.flash_attention_bwd, lambda q, k, v, do, causal, window:
                                    ops._flash_bwd_flops(q, k, v, q, do, q, causal, window)),
        "decode_attention_ref": (K.decode_attention, lambda q, kc, vc, n:
                                 ops._decode_flops(q, kc, vc, n)),
        "mlstm_chunk_ref": (K.mlstm_chunk_fwd, lambda q, k, v, lf, ig, chunk, state:
                            ops._mlstm_fwd_flops(q, k, v, lf, ig, None, None, chunk, False)),
        "mlstm_chunk_bwd_ref": (K.mlstm_chunk_bwd, lambda q, k, v, lf, ig, y, dy, chunk, state,
                                dC, dn: ops._mlstm_bwd_flops(q, k, v, lf, ig, y, dy, q, q, q,
                                                             None, None, chunk, False)),
    }
    calls = {}
    saved = {name: getattr(ops, name) for name in formulas}

    def counted(name):
        op, formula = formulas[name]

        def run(*args, **kw):
            with _disable_current_modes():
                out = saved[name](*args, **kw)
            fc.flop_counts["Global"][op] += formula(*args, **kw)
            calls[op._qualified_op_name.split("::")[1]] = calls.get(
                op._qualified_op_name.split("::")[1], 0) + 1
            return out
        return run

    for name in formulas:
        setattr(ops, name, counted(name))
    saved["adamw_update_ref"] = ops.adamw_update_ref

    def adamw(grads, *args, **kw):
        n = len(leaves(grads))
        for op, k in (("adamw_sumsq", n), ("adamw_finalize", 1), ("adamw_update", n)):
            calls[op] = calls.get(op, 0) + k
        return saved["adamw_update_ref"](grads, *args, **kw)

    ops.adamw_update_ref = adamw

    def moe(name, op):
        def run(*args, **kw):
            # counted first: remat's recomputation may stop inside the call once it
            # has what the backward saved
            calls[op] = calls.get(op, 0) + 1
            out = saved[name](*args, **kw)
            if out.requires_grad:  # the backward kernel runs where autograd reaches it
                out.register_hook(lambda g: calls.update({f"{op}_bwd": calls.get(
                    f"{op}_bwd", 0) + 1}))
            return out
        return run

    for name, op in (("moe_dispatch_ref", "moe_dispatch"), ("moe_combine_ref", "moe_combine")):
        saved[name] = getattr(ops, name)
        setattr(ops, name, moe(name, op))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@pytest.mark.parametrize("arch", ARCHS)
def test_trace_flops_equal_a_real_cpu_run(arch):
    for kind in SMALL:
        cfg, shape = _small(arch, kind)
        cell = D.build_cell(dataclasses.replace(cfg, remat=kind == "train"), shape, D.Variant())
        traced = D.trace(cell)
        real = D.materialize(cell, "cpu")
        with D.flop_counter() as fc, kernels_by_formula(fc) as calls:
            cell.step()(real)
        assert fc.get_total_flops() == traced["flops"], (kind, fc.get_flop_counts())
        assert calls == traced["kernel_calls"], kind


@pytest.mark.parametrize("arch", ARCHS)
def test_probes_extrapolate_to_a_full_trace(arch):
    """Depth at 3 superblocks (whisper: and 3 encoder layers), every kind of
    cell; xLSTM's sequence at 256 positions of one superblock, in a train
    step (its sLSTM loop makes a full trace slow); jamba's train step."""
    cfg = reduced(get_config(arch))
    R = 1 if arch == "xlstm_350m" else 3
    cfg = dataclasses.replace(cfg, n_layers=R * cfg.pattern_period, remat=arch != "xlstm_350m",
                              n_enc_layers=3 if cfg.enc_dec else 0)
    S = 256 if arch == "xlstm_350m" else 128
    kinds = ("train",) if arch in ("xlstm_350m", "jamba_1_5_large_398b") else (
        "train", "prefill", "decode")
    for kind in kinds:
        shape = ShapeConfig(kind, kind, S, 1 if arch == "xlstm_350m" else 2)
        plan = D.probe_plan(cfg, shape)
        assert all(p[0] in (1, 2) for p, _, _ in plan)
        if arch == "xlstm_350m":
            assert {p[2] for p, _, _ in plan} == {64, 128, 192}
        got = D.trace_cell(cfg, shape, D.Variant())
        want = D.trace_cell(cfg, shape, D.Variant(), full=True)
        for key in ("flops", "bytes_accessed", "kernel_calls"):
            assert got[key] == want[key], (kind, key)
        assert abs(got["peak_bytes"] - want["peak_bytes"]) <= 0.01 * want["peak_bytes"], kind


def test_least_microbatches_finds_the_least_that_fits():
    cfg, shape = reduced(get_config("smollm_360m")), ShapeConfig("t", "train", 64, 16)
    peaks = {n: D.trace_cell(cfg, shape, D.Variant(n_microbatches=n))["peak_bytes"]
             for n in (1, 2, 4)}
    assert peaks[1] > peaks[2] > peaks[4]
    n, m = D.least_microbatches(cfg, shape, budget=peaks[2])
    assert n == 2 and m["peak_bytes"] == peaks[2]


# ---------------------------------------------------------------------------
# The kernel ops' fake implementations and FLOP formulas
# ---------------------------------------------------------------------------

def _pair(*shape, dtype=torch.float32):
    """The same shape on meta and on the CPU (random)."""
    return torch.empty(shape, dtype=dtype, device="meta"), torch.randn(shape).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,causal,window", [(64, 64, True, None), (64, 64, True, 16),
                                                  (64, 64, False, None), (8, 40, False, None)])
def test_fake_flash_matches_plain_shapes(dtype, Sq, Skv, causal, window):
    (qm, q), (km, k), (vm, v) = _pair(2, Sq, 6, 64, dtype=dtype), *(
        _pair(2, Skv, 2, 64, dtype=dtype) for _ in range(2))
    out_m, (lse_m,) = torch.ops.repro_torch.flash_attention_fwd(qm, km, vm, causal, window, True)
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    for m, c in ((out_m, out), (lse_m, lse)):
        assert (m.shape, m.dtype, m.is_contiguous()) == (c.shape, c.dtype, True)
    assert torch.ops.repro_torch.flash_attention_fwd(qm, km, vm, causal, window, False)[1] == []
    grads_m = torch.ops.repro_torch.flash_attention_bwd(qm, km, vm, out_m, qm, lse_m, causal,
                                                        window)
    grads = ref.flash_attention_bwd_ref(q, k, v, q, causal=causal, window=window)
    assert [(g.shape, g.dtype) for g in grads_m] == [(g.shape, g.dtype) for g in grads]
    # the wrappers route meta tensors to the same fake kernels, and count no launch
    before = (ops.flash_attention.launches, ops.flash_attention.bwd_launches)
    assert ops.flash_attention(qm, km, vm, causal=causal, window=window).shape == out.shape
    assert (ops.flash_attention.launches, ops.flash_attention.bwd_launches) == before
    pairs = int(ref._visible(Sq, Skv, causal, window, torch.device("cpu")).sum())
    assert ops.attention_pairs(Sq, Skv, causal, window) == pairs
    assert ops._flash_fwd_flops(qm, km, vm, causal, window, True) == 4 * 2 * 6 * 64 * pairs


def test_fake_flash_refuses_what_the_kernel_refuses():
    q = torch.empty((1, 8, 2, 48), device="meta")
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="takes no mask"):
        ops.flash_attention(q, torch.empty((1, 16, 2, 64), device="meta"),
                            torch.empty((1, 16, 2, 64), device="meta"), causal=True)


def test_fake_decode_matches_plain_shapes():
    (qm, q), (km, k) = _pair(3, 8, 64, dtype=torch.bfloat16), _pair(3, 300, 2, 64,
                                                                     dtype=torch.bfloat16)
    lens = torch.tensor([1, 300, 500], dtype=torch.int32)
    out_m = ops.decode_attention(qm, km, km, lens.to("meta"))
    out = ref.decode_attention_ref(q, k, k, lens)
    assert (out_m.shape, out_m.dtype) == (out.shape, out.dtype)
    # real lengths count their visible keys (clamped to S); unknown ones every slot
    assert ops._decode_flops(q, k, k, lens) == 4 * 8 * 64 * (1 + 300 + 300)
    assert ops._decode_flops(qm, km, km, lens.to("meta")) == 4 * 8 * 64 * 3 * 300


@pytest.mark.parametrize("S,chunk,with_state", [(128, 64, False), (100, 64, True), (40, 40, True)])
def test_fake_mlstm_matches_plain_shapes(S, chunk, with_state):
    B, H, hd = 2, 2, 32
    (qm, q), (lm, lf) = _pair(B, S, H, hd), _pair(B, S, H)
    lf = torch.nn.functional.logsigmoid(lf)
    state_m, state = ((None, None), None)
    if with_state:
        (Cm, C), (nm, n) = _pair(B, H, hd, hd), _pair(B, H, hd)
        state_m, state = (Cm, nm), (C, n)
    y_m, C_m, n_m, saved = torch.ops.repro_torch.mlstm_chunk_fwd(qm, qm, qm, lm, lm, *state_m,
                                                                 chunk, True)
    assert torch.ops.repro_torch.mlstm_chunk_fwd(qm, qm, qm, lm, lm, *state_m, chunk, False)[3] == []
    y, (C, n) = ref.mlstm_chunk_ref(q, q, q, lf, lf.exp(), chunk=chunk, state=state)
    assert [(t.shape, t.dtype) for t in (y_m, C_m, n_m)] == [
        (t.shape, t.dtype) for t in (y, C, n)]
    assert [tuple(t.shape) for t in saved] == list(mlstm_kernel.saved_shapes(B, S, H, hd, chunk))
    *grads_m, state_grads = torch.ops.repro_torch.mlstm_chunk_bwd(
        qm, qm, qm, lm, lm, y_m, y_m, *saved, None, None, chunk, with_state)
    grads = ref.mlstm_chunk_bwd_ref(q, q, q, lf, lf.exp(), y, y, chunk=chunk, state=state)
    assert len(state_grads) == (2 if with_state else 0)
    for m, c in zip(grads_m + state_grads, grads, strict=False):
        assert (m.shape, m.dtype) == (c.shape, c.dtype)
    n_pairs = sum(min(chunk, S - s) * (min(chunk, S - s) + 1) // 2 for s in range(0, S, chunk))
    assert ops.mlstm_pairs(S, chunk) == n_pairs
    assert ops._mlstm_fwd_flops(qm, qm, qm, lm, lm, None, None, chunk, False) == (
        B * H * (4 * hd * n_pairs + 4 * hd * hd * S))
    with pytest.raises(ValueError, match="float32"):
        ops.mlstm_chunk(qm.bfloat16(), qm.bfloat16(), qm.bfloat16(), lm, lm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_moe_matches_plain_shapes(dtype):
    """The MoE ops on meta tensors (a dry run's route): the dispatch, the
    combine and both backwards give the shapes and dtypes of the plain
    gathers and their gradients, and count no launch."""
    from repro_torch.models import layers as L

    T, d, k, E, cap = 12, 16, 2, 4, 5
    logits = torch.randn((1, T, E), generator=torch.Generator().manual_seed(3))
    top, expert = torch.sort(logits, dim=-1, descending=True, stable=True)
    route = L._queued(expert[..., :k], torch.softmax(top[..., :k], -1), E, cap)
    slot_row, row_slot, _, weights = L.moe_maps(route, E, E)
    (xm, x), (yem, ye) = _pair(T, d, dtype=dtype), _pair(E * cap, d, dtype=dtype)
    w = weights.reshape(T, k)
    maps_m = [t.to("meta") for t in (row_slot, slot_row)]
    xm.requires_grad_(), yem.requires_grad_()
    counters = [(getattr(ops, n), a) for n in ("moe_dispatch", "moe_combine")
                for a in ("launches", "bwd_launches")]
    before = [getattr(o, a) for o, a in counters]
    xe_m, xe = ops.moe_dispatch(xm, *maps_m), ops.moe_dispatch(x, row_slot, slot_row)
    out_m, out = (ops.moe_combine(yem, w.to("meta"), *maps_m),
                  ops.moe_combine(ye, w, row_slot, slot_row))
    for m, c in ((xe_m, xe), (out_m, out)):
        assert (m.shape, m.dtype) == (c.shape, c.dtype)
    dx_m, dye_m = torch.autograd.grad((xe_m.float().sum() + out_m.sum()), (xm, yem))
    assert (dx_m.shape, dx_m.dtype, dye_m.shape, dye_m.dtype) == (x.shape, dtype, ye.shape, dtype)
    K = torch.ops.repro_torch
    dye_k, dw_k = K.moe_combine_bwd(yem, w.to("meta"), out_m, maps_m[1], maps_m[0])
    assert (dye_k.shape, dw_k.shape, dw_k.dtype) == (ye.shape, w.shape, torch.float32)
    assert [getattr(o, a) for o, a in counters] == before
    with pytest.raises(ValueError, match="int64"):
        ops.moe_dispatch(xm, maps_m[0].int(), maps_m[1])
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.moe_dispatch(xm[:, :12], *maps_m)
