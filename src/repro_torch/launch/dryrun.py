"""Dry run: every (arch × shape) cell traced on the card's route, nothing allocated.

Port of ``repro.launch.dryrun``. For each cell (``models.config.SHAPES``
that ``applicable_shapes`` gives each of the ten archs) it answers whether
the step builds, whether the cell fits one H100, and what one device of
each of the reference's meshes holds, does and communicates:

1. **Arguments.** The parameters (``model.abstract_params``), the AdamW
   state, and the batch (train, prefill) or the decode cache and inputs,
   as meta tensors: nothing is allocated. Their placements on each mesh
   come from the logical-axis rules (``runtime.sharding``; FSDP at 10 B
   parameters and more, as the reference's ``_fsdp_auto``). The bytes one
   device holds are exact: ``argument_bytes`` (params / optimizer /
   batch_or_cache) and ``memory_analysis.argument_size_in_bytes``.
2. **Trace** (the host mesh, one H100). The cell's real step
   (``runtime.train.build_train_step``, the prefill ``model.forward``, or
   ``runtime.serve.build_serve_step``) runs once on meta tensors: every op
   computes shapes only, and the kernels take their fake implementations
   (``kernels.ops``), the route a CUDA tensor takes, so a shape error fails
   the cell as a compile error fails the reference's. ``trace(...,
   device="cuda")`` traces fake CUDA tensors instead (``FakeTensorMode``),
   the card's own route; it needs a CUDA build (a CPU-only one cannot record an autograd
   graph on a tensor that claims a CUDA device) and costs about three
   times as much on the host. Meta tensors allocate as the CPU does where
   an op allocates by device (``log_sigmoid``'s buffer is empty on CUDA):
   on an H100 the two traces gave equal FLOPs, kernel calls and peaks, and
   bytes within 1e-4 (``tests/test_torch_cuda.py`` holds both at one cell
   that fits the card). It records:

   - ``flops``: by ``FlopCounterMode``'s formulas, the kernels by theirs,
     ``torch.utils.checkpoint``'s replay under ``remat`` included;
   - ``bytes_accessed``: inputs plus outputs of every op that makes a new
     tensor or writes one in place (views move nothing), XLA's definition;
   - ``peak_bytes``: the most that live tensors ever held, the arguments
     included, each storage rounded up to the CUDA caching allocator's 512
     bytes, as ``torch.cuda.max_memory_allocated`` counts it; the kernels'
     scratch buffers (flash backward's row sums, decode's partial results,
     the mLSTM workspaces) are not in it;
   - ``fits_one_h100``: ``peak_bytes`` <= ``H100_BYTES``;
   - ``kernel_calls``: calls of each kernel op (``torch.ops.repro_torch``).

3. **Probes.** A fake op costs tens to hundreds of microseconds on the
   host, and a full-depth step runs up to hundreds of thousands of them.
   So the trace runs at 1 and 2 superblocks (whisper: also at 1 and 2
   encoder layers) and extrapolates linearly to full depth, as the
   reference's ``depth_probe``; xLSTM's train and prefill cells, whose
   sLSTM is a loop over time, also at three sequence lengths
   (``seq_probes``). The peak is extrapolated per phase of the step
   (forward, backward, the rest: the optimizer and the gradient sums), op
   by op where the probes ran the same ops, and the largest taken
   (``probe_plan``, ``combine``). The record's ``trace`` lists the probes
   and their weights; ``trace_cell(..., full=True)`` traces the whole cell;
   ``--jobs`` runs the probes in parallel processes.

4. **Sharded trace** (each production mesh: 16×16 and 2×16×16). The same
   step runs once more on meta DTensors, each argument placed by the rules
   (``shard_args``): DTensor runs every op on each device's shards and
   issues the collectives its placements need, and the port's kernel
   entries, its matmuls, the embedding, the loss, the decode cache and the
   MoE dispatch state their own placements (``runtime.sharding.run_local``
   and ``matmul``, ``kernels.ops``, ``models.layers``). The process is rank
   0 of the fake world of 512 (``launch.mesh``); every split is even, so
   its trace is every device's. ``StepTrace`` counts only the local ops
   (an op on DTensors goes back to DTensor, which runs the local ops
   through it; its shape propagation on fake global tensors is skipped),
   so every number is one device's: ``flops``, ``bytes_accessed``,
   ``peak_bytes`` (the local shards of the arguments included),
   ``fits_per_device`` and ``kernel_calls``; and ``collective_bytes``,
   the reference's record of ``parse_collective_bytes`` (the five kinds,
   their counts and the total): each functional collective, DTensor's and
   the port's own, counted at its result's size (``CollectiveTally``).
   Probes extrapolate them as in 3, the collectives additive in depth as
   in the reference's ``depth_probe``. A step that raises on a mesh makes
   that record ``ok: false`` with the error; nothing falls back to the
   unsharded trace.

Variants keep the reference's knobs, ``shard_logits`` included (prefill's
logits stay vocab-sharded), except ``unroll_layers``: the port's layers are
always a Python loop.

Records go to ``build/dryrun/<arch>__<shape>__<mesh>__<variant>.json``;
the exit code is 1 if any cell fails. The production meshes live in the
fake process-group world of 512 ranks (``launch.mesh``), which is global
to the process: run the dry run as its own process.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --jobs 8 [--variant n_microbatches=16]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import logging
import math
import time
import traceback
import weakref
import zlib
from fractions import Fraction
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import reduced as reduce_config
from repro_torch.kernels.mlstm_chunk import MAX_CHUNK as MLSTM_KERNEL_CHUNK
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, applicable_shapes
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import serve as serve_lib
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import train as train_lib
from repro_torch.tree import leaves, map_tree

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# The budget of one card: an H100 SXM's 80 GB of HBM ("NVIDIA H100 80GB HBM3",
# 700 W power limit), as NVIDIA's data sheet gives it.
H100_BYTES = 80 * 10**9
ALLOC_ROUND = 512  # the CUDA caching allocator's granule (c10 kMinBlockSize)
REDUCED_SEQ, REDUCED_BATCH = 128, 2  # --reduced cells' shapes


@dataclasses.dataclass
class Variant:
    """A sharding / step configuration under test (the reference's knobs)."""
    fsdp: bool | None = None          # None = auto (>= 10 B params)
    shard_kv_seq: bool = True         # sequence parallelism for decode caches
    expert_parallel: bool = True
    n_microbatches: int = 1
    remat: bool | None = None         # None = the config's
    tensor_parallel: bool = True      # False: replicate weights, go pure DP
    window: int | None = None         # override the attention window
    moe_group: int | None = None      # MoE dispatch group size override
    grad_compress: str | None = None  # "bf16": gradients rounded to bf16
    shard_logits: bool = False        # keep prefill logits vocab-sharded
    tag: str = "baseline"


def parse_variant(s: str) -> Variant:
    if not s or s == "baseline":
        return Variant(tag=s or "baseline")
    kw: dict[str, Any] = {"tag": s}
    for part in s.split(","):
        k, _, val = part.partition("=")
        if k in ("fsdp", "shard_kv_seq", "expert_parallel", "remat", "tensor_parallel",
                 "shard_logits"):
            kw[k] = bool(int(val))
        elif k in ("n_microbatches", "window", "moe_group"):
            kw[k] = int(val)
        elif k == "grad_compress":
            kw[k] = val
    return Variant(**kw)


def _fsdp_auto(cfg: ModelConfig) -> bool:
    return cfg.param_counts()["total"] >= 10e9


@dataclasses.dataclass
class Cell:
    """One (arch × shape) cell under a variant: its config, its arguments as
    meta tensors, and its step (``run``), the same on meta, fake and real
    tensors."""
    cfg: ModelConfig
    shape: ShapeConfig
    variant: Variant
    fsdp: bool
    args: dict[str, Any]

    def groups(self) -> dict[str, list[str]]:
        """The argument bytes' parts, as the record splits them."""
        if self.shape.kind == "train":
            return {"params": ["params"], "optimizer": ["opt"], "batch_or_cache": ["batch"]}
        if self.shape.kind == "prefill":
            return {"params": ["params"], "optimizer": [], "batch_or_cache": ["batch"]}
        return {"params": ["params"], "optimizer": [], "batch_or_cache": ["cache", "inputs"]}

    def step(self, places: dict[str, Any] | None = None) -> Callable[[dict[str, Any]], Any]:
        """The cell's step on a dict of arguments shaped like ``args``. Given
        the arguments' placements on a mesh (``placements``), the step's
        outputs are redistributed as the reference's ``out_shardings`` place
        them: the new parameters and optimizer state as the old, the metrics
        replicated, prefill's logits over the batch (vocab-sharded too under
        ``shard_logits``), decode's logits over the batch (its cache is
        written in place)."""
        step = self._step()
        if places is None:
            return step
        shape, variant = self.shape, self.variant

        def placed(a):
            out = step(a)
            mesh = _mesh_of(a)
            if shape.kind == "train":
                params, opt, metrics = out
                return (sh.redistribute_tree(params, places["params"]),
                        sh.redistribute_tree(opt, places["opt"]),
                        sh.redistribute_tree(metrics, sh.replicated(mesh)))
            if shape.kind == "prefill":
                return sh.redistribute_tree(out, logits_placements(mesh, shape, variant))
            logits, cache = out
            batch = sh.batch_sharding(mesh, 2, shape.global_batch)
            return sh.redistribute_tree(logits, batch), cache
        return placed

    def _step(self) -> Callable[[dict[str, Any]], Any]:
        cfg = self.cfg
        if self.shape.kind == "train":
            train = train_lib.build_train_step(
                cfg, AdamWConfig(grad_compress=self.variant.grad_compress),
                n_microbatches=self.variant.n_microbatches)
            return lambda a: train(a["params"], a["opt"], a["batch"])
        if self.shape.kind == "prefill":
            def prefill(a):
                with torch.no_grad():
                    return M.forward(a["params"], cfg, a["batch"]["tokens"],
                                     a["batch"].get("enc_embeds"))
            return prefill
        serve = serve_lib.build_serve_step(cfg)

        def decode(a):
            with torch.no_grad():
                return serve(a["params"], a["cache"], a["inputs"])
        return decode


def _mesh_of(args: dict[str, Any]):
    """The mesh of a dict of DTensor arguments."""
    return next(t for t in leaves(args["params"]) if sh.is_dtensor(t)).device_mesh


def logits_placements(mesh: Any, shape: ShapeConfig, variant: Variant) -> tuple:
    """Prefill's logits (B, S, vocab) on ``mesh``: over the batch axes where
    they divide the batch, and with ``shard_logits`` over the model axis
    along the vocab too, as the reference's ``out_shardings``."""
    from torch.distributed.tensor import Shard

    places = list(sh.batch_sharding(mesh, 3, shape.global_batch))
    if variant.shard_logits:
        places[mesh.mesh_dim_names.index("model")] = Shard(2)
    return tuple(places)


# An arch's cells share its parameters' meta tree (meta tensors hold no data): built once
# per config, it takes a fraction of a second under FakeTensorMode.
_abstract_params = functools.lru_cache(maxsize=None)(M.abstract_params)


def _shape(shape: str | ShapeConfig) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(cfg: ModelConfig, shape: str | ShapeConfig, variant: Variant,
               seq_len: int | None = None) -> Cell:
    """The cell's config under ``variant`` and its arguments on meta; the
    shape by name (``SHAPES``) or given (a test's), ``seq_len`` overriding
    its length (a sequence probe)."""
    shape = _shape(shape)
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    fsdp = variant.fsdp if variant.fsdp is not None else _fsdp_auto(cfg)
    if variant.remat is not None:
        cfg = dataclasses.replace(cfg, remat=variant.remat)
    if variant.window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=variant.window)
    if variant.moe_group is not None:
        cfg = dataclasses.replace(cfg, moe_group=variant.moe_group)
    B, S = shape.global_batch, shape.seq_len
    args: dict[str, Any] = {"params": _abstract_params(cfg)}
    if shape.kind == "train":
        args["opt"] = adamw_init(args["params"])
    if shape.kind in ("train", "prefill"):
        args["batch"] = train_lib.synthetic_batch(cfg, B, S, device="meta")
    else:
        args["cache"] = M.init_cache(cfg, B, S, device="meta")
        args["inputs"] = serve_lib.decode_inputs(cfg, B, S, device="meta")
    return Cell(cfg, shape, variant, fsdp, args)


def placements(cell: Cell, mesh: Any) -> dict[str, Any]:
    """Each argument tree's placements on ``mesh``, as the reference's
    ``build_cell`` shards its arguments."""
    rules = sh.rules_for(mesh, fsdp=cell.fsdp, shard_kv_seq=cell.variant.shard_kv_seq,
                         expert_parallel=cell.variant.expert_parallel,
                         tensor_parallel=cell.variant.tensor_parallel)
    specs = M.model_specs(cell.cfg)
    out = {"params": sh.tree_shardings(cell.args["params"], specs, mesh, rules)}
    by_batch = lambda t: sh.batch_sharding(mesh, t.ndim, t.shape[0])  # noqa: E731
    if "opt" in cell.args:
        out["opt"] = sh.tree_shardings(cell.args["opt"],
                                       {"mu": specs, "nu": specs, "count": ()}, mesh, rules)
    if "batch" in cell.args:
        out["batch"] = map_tree(by_batch, cell.args["batch"])
    if "cache" in cell.args:
        out["cache"] = sh.tree_shardings(cell.args["cache"], M.cache_specs(cell.cfg), mesh,
                                         rules)
        out["inputs"] = {"token": sh.batch_sharding(mesh, 1, cell.shape.global_batch)}
    return out


def shard_args(cell: Cell, mesh: Any, args: dict[str, Any] | None = None) -> dict[str, Any]:
    """The cell's arguments as DTensors on ``mesh`` under ``placements``: by
    default its meta trees, each device's shard an empty meta tensor; given
    ``args`` (real tensors, the same on every rank, ``materialize``), each
    rank's own shards of them. The decode step's ``pos`` stays an int."""
    args = cell.args if args is None else args
    places = placements(cell, mesh)
    out = {}
    for name, tree in args.items():
        if name == "inputs":
            tree, pos = {"token": tree["token"]}, tree["pos"]
        if args is cell.args:
            out[name] = sh.to_dtensors(tree, places[name], mesh)
        else:
            out[name] = sh.shard_tree(tree, places[name], mesh)
        if name == "inputs":
            out[name]["pos"] = pos
    return out


def argument_bytes(cell: Cell, mesh: Any) -> dict[str, int]:
    """Bytes one device of ``mesh`` holds of each part of the arguments."""
    places = placements(cell, mesh)
    out = {}
    for part, names in cell.groups().items():
        out[part] = sum(sh.tree_local_bytes(_tensors(cell.args[n]), _tensors(places[n]), mesh)
                        for n in names)
    out["total"] = sum(out.values())
    return out


def _tensors(tree: Any) -> Any:
    """``tree`` without its non-tensor leaves (the decode step's ``pos``)."""
    if isinstance(tree, dict) and "pos" in tree:
        return {k: v for k, v in tree.items() if k != "pos"}
    return tree


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _next_phase(phase: str, recorded: bool) -> str:
    """The step's phase at an op, given the phase before it and whether
    autograd may record the op (``recorded``: grad mode on, an input that
    requires grad): "backward" inside autograd's backward; "forward" from a
    recorded op until the backward (the kernels' ``autograd.Function``s run
    their own forwards unrecorded inside it); "other" from the backward's
    end until the next recorded op (the gradient sums, the optimizer) and
    in a step under ``no_grad``."""
    if torch._C._current_graph_task_id() != -1:
        return "backward"
    if phase == "backward":
        return "other"
    return "forward" if recorded else phase


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# torch's functional collectives (what DTensor issues, and the port's own) by the
# reference's HLO kinds; their result is the size the reference counts: the gathered
# output, the reduced buffer, the scattered output, the exchanged output
_FUNCOL_KIND = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
_FUNCOL_NOT_COMM = ("wait_tensor", "_wrap_tensor_autograd")


def local_op(types) -> bool:
    """False for an op on DTensors (DTensor itself runs it)."""
    from torch.distributed.tensor import DTensor

    return not any(issubclass(t, DTensor) for t in types)


def shape_propagation() -> bool:
    """True inside DTensor's sharding propagation, which runs each op once on
    fake tensors of the global shapes (under a ``FakeTensorMode``) to learn
    its output's shape: no device runs that op. A sharded trace runs on meta
    tensors with no fake mode of its own."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class CollectiveTally:
    """Bytes and count of each kind of collective one device issues, the
    reference's ``parse_collective_bytes`` record: the five kinds, their
    ``*_count`` and ``total``. A collective is one functional-collective op
    (``torch.distributed._functional_collectives``), whether DTensor issued
    it while redistributing or the port's code did; its bytes are its
    result's, as the reference counts them."""

    def __init__(self):
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.count = dict.fromkeys(COLLECTIVES, 0)

    def add(self, func, out) -> None:
        if func.namespace not in ("_c10d_functional", "c10d_functional"):
            return
        name = func._opname
        if name in _FUNCOL_NOT_COMM:
            return
        if name not in _FUNCOL_KIND:
            raise NotImplementedError(f"collective {func} has no kind in the reference's tally")
        kind = _FUNCOL_KIND[name]
        self.bytes[kind] += sum(t.numel() * t.element_size()
                                for t in torch.utils._pytree.tree_leaves(out)
                                if isinstance(t, torch.Tensor))
        self.count[kind] += 1

    def record(self) -> dict[str, int]:
        out = dict(self.bytes)
        out.update({f"{k}_count": v for k, v in self.count.items()})
        out["total"] = sum(self.bytes.values())
        return out


class CollectiveCounter(TorchDispatchMode):
    """``CollectiveTally`` of a real run: every functional collective that
    runs while the mode is on, DTensor's included."""

    def __init__(self):
        super().__init__()
        self.tally = CollectiveTally()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not local_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not shape_propagation():
            self.tally.add(func, out)
        return out


class StepTrace(TorchDispatchMode):
    """Live tensor storages through a step: their bytes (rounded as the CUDA
    caching allocator rounds them) from the op that makes each until its
    last reference goes, after every op; the bytes each op reads and writes;
    the FLOPs of the ops ``FlopCounterMode`` has a formula for (its
    registry, the kernel ops' included); the kernel ops' calls. ``roots``
    (the arguments) are live from the start. Per phase (``_next_phase``) it keeps the live bytes after each op
    (``timeline``) and a checksum of the ops' names (``ops_crc``): two
    traces whose phase ran the same ops can be extrapolated op by op."""

    def __init__(self, roots: list[torch.Tensor], sharded: bool = False):
        super().__init__()
        self.sharded = sharded
        self.collectives = CollectiveTally()
        self.live: dict[int, int] = {}
        self.now = 0
        self.phase = "other"
        self.timeline: dict[str, list[int]] = collections.defaultdict(list)
        self.ops_crc: dict[str, int] = collections.defaultdict(int)
        self.bytes_accessed = 0
        self.flops = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        for t in roots:
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> bool:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return False
        self.live[key] = _rounded(st.nbytes())
        self.now += self.live[key]
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.sharded:
            if not local_op(types):
                return NotImplemented  # DTensor runs it: its local ops come back here
            if shape_propagation():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if self.sharded:
            self.collectives.add(func, out)
        outs = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        new = [self._hold(t) for t in outs]
        recorded = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
        phase = self.phase = _next_phase(self.phase, recorded)
        self.timeline[phase].append(self.now)
        self.ops_crc[phase] = zlib.crc32(func._opname.encode(), self.ops_crc[phase])
        if any(new) or func._schema.is_mutable:  # views and aliases move nothing
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.namespace == "repro_torch":
            self.kernel_calls[func._opname] += 1
        return out


def flop_counter() -> FlopCounterMode:
    """``FlopCounterMode`` that leaves every op whole, to count a real run as
    ``StepTrace`` counts a trace. It decomposes the ops it has no formula
    for where a decomposition exists: in these steps only ``silu_backward``,
    into elementwise ops (no FLOPs counted either way) whose temporaries a
    real run would not hold. Given a formula of 0 it runs as itself, so a
    step under this counter allocates what it allocates without it."""
    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.silu_backward: lambda *a, **k: 0})


def trace(cell: Cell, device: str = "meta", mesh: Any = None) -> dict[str, Any]:
    """Run the cell's step once on fake tensors on ``device`` and measure it
    (the module's docstring): flops, bytes_accessed, peak bytes per phase,
    kernel calls, seconds. ``device="meta"`` runs meta tensors as they are
    (the fastest); any other device fake tensors under ``FakeTensorMode``
    (``"cuda"``: the card's, on a CUDA build). Given a production ``mesh``,
    the step runs on meta DTensors placed as on that mesh (``shard_args``)
    and everything is counted on this device's shards and local ops, with
    its collectives (``collective_bytes``): what one device of the mesh
    holds and does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()  # lint: allow(REPRO001)
    if mesh is not None:
        from torch.distributed.tensor.experimental import implicit_replication

        assert device == "meta", "a sharded trace runs on meta tensors"
        # DTensor warns of each reduction over several mesh axes it runs as one per axis
        logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
        args = shard_args(cell, mesh)
        step = cell.step(placements(cell, mesh))
        roots = [t.to_local() for t in leaves(args) if isinstance(t, torch.Tensor)]
        with implicit_replication(), StepTrace(roots, sharded=True) as mt:
            out = step(args)
            del out
    else:
        with FakeTensorMode() if device != "meta" else contextlib.nullcontext():
            args = map_tree(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                          device=device)
                            if isinstance(t, torch.Tensor) else t, cell.args)
            step = cell.step()
            roots = [t for t in leaves(args) if isinstance(t, torch.Tensor)]
            with StepTrace(roots) as mt:
                out = step(args)
                del out
    rec = {"flops": int(mt.flops), "bytes_accessed": int(mt.bytes_accessed),
           "peak_by_phase": {p: max(v) for p, v in mt.timeline.items()},
           "timeline": dict(mt.timeline), "ops_crc": dict(mt.ops_crc),
           "kernel_calls": dict(mt.kernel_calls),
           "seconds": time.perf_counter() - t0}  # lint: allow(REPRO001)
    if mesh is not None:
        rec["collective_bytes"] = mt.collectives.record()
    return rec


def _probe_cfg(cfg: ModelConfig, r: int, r_enc: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.pattern_period * r,
                               n_enc_layers=r_enc if cfg.enc_dec else 0)


def seq_probes(cfg: ModelConfig, shape: str | ShapeConfig) -> list[int] | None:
    """The sequence lengths an xLSTM train or prefill cell is traced at, or
    None (the whole length): 64, 128 and 192, whole chunks of the mLSTM
    kernel. Its sLSTM is a loop over time whose work per position is
    constant, but its backward is not: each step's slice of the gate
    pre-activations gets a gradient as long as the sequence, so the bytes it
    moves grow as S², and three lengths fit them. Other cells are traced at
    their whole length: jamba's mamba runs a loop over chunks of 256 too,
    but the peak of its step is not linear in S from short probes (256 to
    768 put it 5 % above a trace at 4096), and attention adds S² pairs."""
    shape = _shape(shape)
    mixers = {cfg.mixer_of(e) for e in cfg.block_pattern}
    if shape.kind == "decode" or not mixers <= {"mlstm", "slstm"}:
        return None
    lengths = [MLSTM_KERNEL_CHUNK * i for i in (1, 2, 3)]  # whole chunks: linear cost
    return lengths if lengths[-1] < shape.seq_len else None


def _lagrange(points: list[int], x: int) -> list[Fraction]:
    """Weights of the polynomial through ``points`` evaluated at ``x``."""
    return [math.prod((Fraction(x - q, p - q) for q in points if q != p), start=Fraction(1))
            for p in points]


def probe_plan(cfg: ModelConfig, shape: str | ShapeConfig, full: bool = False
               ) -> list[tuple[tuple[int, int, int], Fraction, Fraction]]:
    """((repeats, encoder layers, sequence length), weight, peak weight) of
    each probe trace. The cell's additive metrics (FLOPs, bytes, kernel
    calls) are the probes' sum by weight: linear in depth (1 and 2
    superblocks; the encoder-decoder also 1 and 2 encoder layers) and,
    through ``seq_probes``, quadratic in the sequence. Its peak is their
    sum by peak weight: linear in depth and in the sequence (the first two
    lengths; a quadratic from short probes would blow up any curvature of a
    peak). Weights are exact fractions; probes of both weights 0 are left
    out."""
    shape = _shape(shape)
    R, E, S = cfg.n_repeats, cfg.n_enc_layers if cfg.enc_dec else 0, shape.seq_len
    if full:
        return [((R, E, S), Fraction(1), Fraction(1))]
    if cfg.enc_dec:
        depth = [((1, 1), 3 - R - E), ((2, 1), R - 1), ((1, 2), E - 1)]
    else:
        depth = [((1, 0), 2 - R), ((2, 0), R - 1)]
    seqs = seq_probes(cfg, shape) or [S]
    along = _lagrange(seqs, S)
    along_peak = _lagrange(seqs[:2], S) + [Fraction(0)] * (len(seqs) - 2)
    return [((r, e, si), wd * ws, wd * wp) for (r, e), wd in depth
            for si, ws, wp in zip(seqs, along, along_peak) if wd * ws or wd * wp]


def trace_probe(cfg: ModelConfig, shape: str | ShapeConfig, variant: Variant,
                probe: tuple[int, int, int], device: str = "meta",
                mesh: Any = None) -> dict[str, Any]:
    """``trace`` of the cell cut to one probe of ``probe_plan``; with ``mesh``
    (a production mesh's name, or a mesh) sharded on that mesh."""
    r, r_enc, seq = probe
    if variant.fsdp is None:  # the whole cell's choice: a probe's few layers fall under 10 B
        variant = dataclasses.replace(variant, fsdp=_fsdp_auto(cfg))
    cell = build_cell(_probe_cfg(cfg, r, r_enc), shape, variant, seq)
    return trace(cell, device, make_mesh(mesh) if isinstance(mesh, str) else mesh)


def _phase_peak(results: list[dict], weights: list[Fraction], phase: str) -> int:
    """A phase's peak from the probes': where every probe with a weight ran
    the phase's same ops (the optimizer's, once per leaf, whatever the depth),
    the largest of the live bytes extrapolated op by op; else the probes'
    peaks extrapolated."""
    used = [(m, w) for m, w in zip(results, weights) if w]
    lines = [m["timeline"].get(phase, []) for m, _ in used]
    if len({m["ops_crc"].get(phase) for m, _ in used}) == 1 and len(set(map(len, lines))) == 1:
        return round(max(sum(w * x for (_, w), x in zip(used, at)) for at in zip(*lines)))
    return round(sum(w * max(m["timeline"].get(phase, [0])) for m, w in used))


def combine(plan: list[tuple[tuple[int, int, int], Fraction, Fraction]], results: list[dict],
            *, device: str = "meta", keep_probes: bool = False) -> dict[str, Any]:
    """The cell's metrics from its probes' (``probe_plan``, ``trace_probe``):
    each additive metric the sum by weight, each phase's peak by peak weight
    (``_phase_peak``) and the step's the largest of them, as whole numbers."""
    weights = [w for _, w, _ in plan]

    def wsum(get) -> int:
        return round(sum(w * get(m) for m, w in zip(results, weights)))

    phases = sorted(set().union(*(m["timeline"] for m in results)))
    ops = sorted(set().union(*(m["kernel_calls"] for m in results)))
    peaks = {p: _phase_peak(results, [w for _, _, w in plan], p) for p in phases}
    out = {"flops": wsum(lambda m: m["flops"]),
           "bytes_accessed": wsum(lambda m: m["bytes_accessed"]),
           "peak_bytes": max(peaks.values()), "peak_by_phase": peaks,
           "kernel_calls": {k: wsum(lambda m: m["kernel_calls"].get(k, 0)) for k in ops},
           "seconds": sum(m["seconds"] for m in results)}
    if "collective_bytes" in results[0]:  # additive in depth, as the reference's depth_probe
        out["collective_bytes"] = {k: wsum(lambda m: m["collective_bytes"][k])
                                   for k in results[0]["collective_bytes"]}
    out["fits_one_h100"] = out["peak_bytes"] <= H100_BYTES
    out["trace"] = {"device": device, "probes": [
        {"repeats": r, "enc_layers": e, "seq_len": s, "weight": str(w), "peak_weight": str(wp)}
        for (r, e, s), w, wp in plan]}
    if keep_probes:
        for rec, m in zip(out["trace"]["probes"], results):
            rec.update({k: v for k, v in m.items() if k not in ("timeline", "ops_crc")})
    return out


def trace_cell(cfg: ModelConfig, shape: str | ShapeConfig, variant: Variant, *,
               full: bool = False, device: str = "meta", mesh: Any = None,
               keep_probes: bool = False) -> dict[str, Any]:
    """The cell's trace metrics at full depth and sequence length:
    extrapolated from probes (``probe_plan``) unless ``full``; with
    ``keep_probes`` the probes' own metrics go into ``trace.probes``; with
    ``mesh`` one device's of that production mesh."""
    plan = probe_plan(cfg, shape, full)
    results = [trace_probe(cfg, shape, variant, probe, device, mesh) for probe, _, _ in plan]
    return combine(plan, results, device=device, keep_probes=keep_probes)


def least_microbatches(cfg: ModelConfig, shape: str | ShapeConfig, *, device: str = "meta",
                       budget: int = H100_BYTES) -> tuple[int, dict]:
    """The least power of two N of microbatches at which the train cell's
    traced peak is within ``budget`` (one H100), and that trace; raises if
    none up to the batch is."""
    n = 1
    while n <= _shape(shape).global_batch:
        m = trace_cell(cfg, shape, Variant(n_microbatches=n, tag=f"n_microbatches={n}"),
                       device=device)
        if m["peak_bytes"] <= budget:
            return n, m
        n *= 2
    raise ValueError(f"{cfg.name}: no microbatch count up to the batch fits {budget} bytes")


def materialize(cell: Cell, device: str | torch.device, seed: int = 0) -> dict[str, Any]:
    """The cell's arguments allocated on ``device``, as a run makes them:
    parameters drawn from ``seed`` (``model.init_model``), zero AdamW
    moments, a synthetic batch, or a zero decode cache and its inputs."""
    cfg, B, S = cell.cfg, cell.shape.global_batch, cell.shape.seq_len
    args: dict[str, Any] = {"params": M.init_model(cfg, seed=seed, device=device)}
    if "opt" in cell.args:
        args["opt"] = adamw_init(args["params"])
    if "batch" in cell.args:
        args["batch"] = train_lib.synthetic_batch(cfg, B, S, seed, device=device)
    if "cache" in cell.args:
        args["cache"] = M.init_cache(cfg, B, S, device=device)
        args["inputs"] = serve_lib.decode_inputs(cfg, B, S, device=device)
    return args


# ---------------------------------------------------------------------------
# Cells and the command line
# ---------------------------------------------------------------------------

def make_mesh(name: str):
    """The "1x1", "16x16" or "2x16x16" mesh in the fake world (``launch.mesh``):
    1×1 is the host mesh, one device, rank 0 of that world."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_production_mesh(multi_pod=name == "2x16x16")
    if name != "1x1":
        return mesh
    return DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.long),
                      mesh_dim_names=("data", "model"))


def cell_of(arch: str, shape_name: str, reduced: bool = False
            ) -> tuple[ModelConfig, ShapeConfig]:
    """An arch's config and a shape of ``SHAPES``; ``reduced``: both cut to a
    smoke test's size (``configs.reduced``: two superblocks, width 64; the
    sequence cut to ``REDUCED_SEQ`` and the batch to ``REDUCED_BATCH``)."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if reduced:
        cfg = reduce_config(cfg)
        shape = dataclasses.replace(shape, seq_len=REDUCED_SEQ, global_batch=REDUCED_BATCH)
    return cfg, shape


def run_cell(arch: str, shape_name: str, meshes: list[str], variant: Variant | None = None,
             *, reduced: bool = False, probe: bool = False,
             traces: Callable[[str | None], list[dict]] | None = None,
             out_dir: Path | None = RESULTS_DIR, verbose: bool = True) -> list[dict]:
    """One record per mesh of ``meshes``. The host mesh's ("1x1") carries the
    unsharded trace; a production mesh's the trace of one of its devices
    (``trace(..., mesh=)``), with its collectives. ``traces(mesh)`` returns
    the probes' traces on a production mesh's name, or on None the host
    trace's, where they were run elsewhere (``--jobs``). A record whose trace
    fails carries the error (a failing host trace fails the whole cell).
    Records are written to ``out_dir`` unless it is None."""
    variant = variant or Variant()
    records = []
    t0 = time.perf_counter()  # lint: allow(REPRO001)

    def failed(name: str, exc: Exception) -> dict:
        return {"arch": arch, "shape": shape_name, "mesh": name, "variant": variant.tag,
                "reduced": reduced, "ok": False, "error": repr(exc),
                "traceback": traceback.format_exc()}

    try:
        cfg, shape = cell_of(arch, shape_name, reduced)
        cell = build_cell(cfg, shape, variant)
        plan = probe_plan(cfg, shape)

        def metrics(mesh_name: str | None) -> dict:
            results = (traces(mesh_name) if traces is not None else
                       [trace_probe(cfg, shape, variant, p, mesh=mesh_name) for p, _, _ in plan])
            return combine(plan, results, keep_probes=probe)

        host = metrics(None) if "1x1" in meshes else None
        for name in meshes:
            mesh = make_mesh(name)
            arg = argument_bytes(cell, mesh)
            rec = {"arch": arch, "shape": shape_name, "mesh": name, "chips": mesh.size(),
                   "variant": variant.tag, "reduced": reduced, "fsdp": cell.fsdp, "ok": True,
                   "argument_bytes": arg,
                   "memory_analysis": {"argument_size_in_bytes": arg["total"]},
                   "collective_bytes": None}
            if name == "1x1":
                rec.update({k: host[k] for k in (
                    "flops", "bytes_accessed", "peak_bytes", "peak_by_phase", "fits_one_h100",
                    "kernel_calls", "trace")})
                rec["trace_s"] = host["seconds"]
                rec["budget"] = {"bytes": H100_BYTES, "card": "NVIDIA H100 80GB HBM3, 700 W"}
            else:
                try:
                    m = metrics(name)
                except Exception as exc:  # a step that does not shard is the finding
                    records.append(failed(name, exc))
                    continue
                rec.update({k: m[k] for k in ("flops", "bytes_accessed", "peak_bytes",
                                              "peak_by_phase", "kernel_calls",
                                              "collective_bytes", "trace")})
                rec["fits_per_device"] = m["peak_bytes"] <= H100_BYTES
                rec["trace_s"] = m["seconds"]
            records.append(rec)
    except Exception as exc:  # a cell that does not build is the finding
        records = [failed(name, exc) for name in meshes]
    seconds = time.perf_counter() - t0  # lint: allow(REPRO001)
    if verbose:
        print(_summary(records, seconds), flush=True)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        for rec in records:
            name = f"{arch}__{shape_name}__{rec['mesh']}__{variant.tag}"
            (out_dir / f"{name}{'__reduced' if reduced else ''}.json").write_text(
                json.dumps(rec, indent=2))
    return records


def _gb(n: float) -> str:
    return f"{n / 1e9:.3f}"


def _summary(records: list[dict], seconds: float) -> str:
    r0 = records[0]
    head = f"{r0['arch']} {r0['shape']} {r0['variant']}"
    bad = [r for r in records if not r["ok"]]
    if bad:
        return f"[FAIL] {head} {' '.join(r['mesh'] for r in bad)}: {bad[0]['error']}"
    args = " ".join(f"{r['mesh']} {_gb(r['argument_bytes']['total'])}" for r in records)
    host = next((r for r in records if r["mesh"] == "1x1"), None)
    traced = ("" if host is None else
              f" | peak {_gb(host['peak_bytes'])} GB fits_one_h100={host['fits_one_h100']} "
              f"flops {host['flops']:.4e}")
    per_device = "".join(
        f" | {r['mesh']}/device peak {_gb(r['peak_bytes'])} GB fits={r['fits_per_device']} "
        f"flops {r['flops']:.4e} coll {_gb(r['collective_bytes']['total'])} GB"
        for r in records if r["mesh"] != "1x1")
    return f"[OK] {head} | args/device GB: {args}{traced}{per_device} | {seconds:.1f} s"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh, not 16x16")
    ap.add_argument("--both-meshes", action="store_true", help="16x16 and 2x16x16")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--probe", action="store_true",
                    help="keep the probe traces' metrics in the record (trace.probes)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="probe traces run in parallel, each in a process of its own")
    ap.add_argument("--reduced", action="store_true",
                    help="each cell cut to a smoke test's size (cell_of)")
    ap.add_argument("--out", default=str(RESULTS_DIR), help="where the records go")
    args = ap.parse_args(argv)

    variant = parse_variant(args.variant)
    meshes = ["1x1"] + (["16x16", "2x16x16"] if args.both_meshes
                        else ["2x16x16" if args.multi_pod else "16x16"])
    archs = ARCHS if (args.all or not args.arch) else args.arch.split(",")
    cells = [(arch, shape) for arch in archs
             for shape in ([args.shape] if args.shape else applicable_shapes(get_config(arch)))]
    kw = dict(reduced=args.reduced, probe=args.probe, out_dir=Path(args.out))
    t0 = time.perf_counter()  # lint: allow(REPRO001)
    if args.jobs == 1:
        results = [run_cell(arch, shape, meshes, variant, **kw) for arch, shape in cells]
    else:  # every probe of every cell a task, the longest first
        import concurrent.futures
        import multiprocessing

        plans = {c: probe_plan(*cell_of(*c, args.reduced)) for c in cells}
        on = [None] + [m for m in meshes if m != "1x1"]  # None: the host trace
        tasks = sorted(((c, p, m) for c in cells for p, _, _ in plans[c] for m in on),
                       key=lambda t: -t[1][0] * t[1][2] * (1 if t[2] is None else 3))
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {t: pool.submit(trace_probe, *cell_of(*t[0], args.reduced), variant, t[1],
                                      mesh=t[2]) for t in tasks}
            results = [run_cell(*c, meshes, variant, **kw, traces=lambda m, c=c: [
                futures[c, p, m].result() for p, _, _ in plans[c]]) for c in cells]
    n_fail = sum(not all(r["ok"] for r in recs) for recs in results)
    seconds = time.perf_counter() - t0  # lint: allow(REPRO001)
    print(f"\ndry-run complete: {len(results) - n_fail} ok, {n_fail} failed, {seconds:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
