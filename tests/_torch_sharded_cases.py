"""The cells ``test_torch_dryrun_sharded.py`` runs sharded, and the three runs
it makes of them, each in a process of its own (a process group is global to
its process):

- ``real``: four gloo ranks over a ``FileStore`` run every cell on real CPU
  tensors on a 2×2 and a 1×4 ("data", "model") mesh, sharded and unsharded,
  and rank 0 writes the errors, the collective tallies (the dry run's
  ``CollectiveCounter`` and ``CommDebugMode``) and the 2×2 outputs (a train
  step's loss, gradient norm, parameters and both AdamW moments);
- ``fake``: a fake world of four ranks traces the same cells on the same
  meshes (``dryrun.trace(..., mesh=)``), and the 1×1 trace, and writes the
  tallies, FLOPs and each leaf's shard shape;
- ``jax``: the reference's ``build_cell`` on a 2×2 ``jax.make_mesh`` of its
  512 host devices runs the same cells on the same inputs and writes its
  outputs, each leaf's shard shape and its collective tally, and compiles
  the tensor-parallel prefills on a 1×4 mesh for their tallies.

Every input is drawn once from a numpy seed (``numpy_args``) and converted.
Run one as ``python _torch_sharded_cases.py <run> <out dir>`` with ``src`` and
``tests`` on the path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
SEED = 11
# name: (arch, config changes, kind, seq_len, batch, decode position)
CELLS = {
    "dense_prefill": ("smollm_360m", {}, "prefill", 16, 4, None),
    "dense_train": ("smollm_360m", {}, "train", 16, 4, None),
    "dense_decode": ("smollm_360m", {}, "decode", 16, 4, 5),
    "gqa_prefill": ("smollm_360m", {"n_heads": 8, "n_kv_heads": 2}, "prefill", 16, 4, None),
    "gqa_train": ("smollm_360m", {"n_heads": 8, "n_kv_heads": 2}, "train", 16, 4, None),
    "gqa_decode": ("smollm_360m", {"n_heads": 8, "n_kv_heads": 2}, "decode", 16, 4, 5),
    "moe_prefill": ("mixtral_8x7b", {}, "prefill", 16, 4, None),
    "moe_train": ("mixtral_8x7b", {}, "train", 16, 4, None),
    "whisper_prefill": ("whisper_large_v3", {}, "prefill", 16, 4, None),
    "whisper_train": ("whisper_large_v3", {}, "train", 16, 4, None),
    "mamba_train": ("jamba_1_5_large_398b", {"n_layers": 8}, "train", 16, 4, None),
    "mamba_decode": ("jamba_1_5_large_398b", {"n_layers": 8}, "decode", 16, 4, 5),
}
# the cells the reference runs too: all but jamba's (one superblock of mamba and MoE),
# which the reference compiles slowly; its sharded outputs are held to the unsharded port's
REFERENCE_CELLS = tuple(c for c in CELLS if not c.startswith("mamba"))
DECODE_LENGTHS = (16, 32)  # the decode cells' tallies at two cache lengths
# the prefills held to Megatron's count at pure tensor parallelism (1×4)
TENSOR_PARALLEL = ("dense_prefill", "gqa_prefill")
# cells traced at 3 superblocks (and 3 encoder layers) under FSDP, by probes and whole
PROBED = ("dense_train", "whisper_prefill", "dense_decode")


def port_cell(name: str, seq_len: int | None = None):
    """The port's ``dryrun.Cell`` of ``name``: a reduced config (width 64, two
    superblocks, f32) at its shape, decode at its position."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeConfig

    arch, changes, kind, S, B, pos = CELLS[name]
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    cell = D.build_cell(cfg, ShapeConfig(name, kind, seq_len or S, B), D.Variant())
    if pos is not None:
        cell.args["inputs"]["pos"] = pos
    return cell


def numpy_args(cell) -> dict:
    """The cell's arguments as numpy, in the port's tree, from ``SEED``:
    parameters normal·0.1 (norm scales 1 + that), zero optimizer moments and
    count, uniform tokens and their labels rolled by one, normal frames and
    a normal decode cache."""
    import torch

    from repro_torch.tree import map_tree, paths

    rng = np.random.default_rng(SEED)
    vocab = cell.cfg.vocab
    scales = {p: "scale" in "".join(p) for p, _ in paths(cell.args["params"])}
    out = {}

    def draw(t, one=False):
        a = rng.standard_normal(tuple(t.shape), dtype=np.float32) * 0.1
        return (a + 1 if one else a).astype(np.float32)

    flat = [(p, draw(t, scales[p])) for p, t in paths(cell.args["params"])]
    out["params"] = _unpaths(cell.args["params"], dict(flat))
    if "opt" in cell.args:
        out["opt"] = map_tree(lambda t: np.zeros(tuple(t.shape), np.float32
                                                 if t.dtype == torch.float32 else np.int32),
                              cell.args["opt"])
    if "batch" in cell.args:
        B, S = cell.args["batch"]["tokens"].shape
        toks = rng.integers(0, vocab, (B, S)).astype(np.int64)
        out["batch"] = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if "enc_embeds" in cell.args["batch"]:
            out["batch"]["enc_embeds"] = draw(cell.args["batch"]["enc_embeds"]) * 10
    if "cache" in cell.args:
        out["cache"] = map_tree(lambda t: draw(t) * 5, cell.args["cache"])
        B = cell.args["inputs"]["token"].shape[0]
        out["inputs"] = {"token": rng.integers(0, vocab, (B,)).astype(np.int64),
                         "pos": cell.args["inputs"]["pos"]}
    return out


def _unpaths(like, by_path, prefix=()):
    if isinstance(like, dict):
        return {k: _unpaths(v, by_path, (*prefix, f"[{k!r}]")) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unpaths(v, by_path, (*prefix, f"[{i}]")) for i, v in enumerate(like)]
    return by_path[prefix]


def torch_args(args: dict) -> dict:
    import torch

    from repro_torch.tree import map_tree

    return map_tree(lambda a: torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a,
                    args)


def kinds_of(comm_counts: dict) -> dict:
    """``CommDebugMode``'s counts by op, as the reference's kinds."""
    from repro_torch.launch.dryrun import _FUNCOL_KIND

    out: dict[str, int] = {}
    for op, n in comm_counts.items():
        name = str(op).split(".")[-1]
        kind = _FUNCOL_KIND.get(name)
        if kind is not None:
            out[kind] = out.get(kind, 0) + n
    return out


def _outputs(cell, out) -> dict:
    """The step's outputs to compare, as numpy (DTensors gathered)."""
    from repro_torch.runtime import sharding as sh
    from repro_torch.tree import leaves

    def full(t):
        t = t.full_tensor() if sh.is_dtensor(t) else t
        return t.detach().float().numpy()

    if cell.shape.kind == "train":
        params, opt, metrics = out
        return {"loss": full(metrics["loss"]), "grad_norm": full(metrics["grad_norm"]),
                **{f"param{i}": full(t) for i, t in enumerate(leaves(params))},
                **{f"{m}{i}": full(t) for m in ("mu", "nu")
                   for i, t in enumerate(leaves(opt[m]))}}
    if cell.shape.kind == "prefill":
        return {"logits": full(out)}
    logits, cache = out
    return {"logits": full(logits), **{f"cache{i}": full(t) for i, t in enumerate(leaves(cache))}}


def moe_bf16_error(mesh) -> float:
    """The MoE MLP alone in bf16 under expert parallelism (the MoE cell's 4
    experts over the model axis), its first layer on ``SEED``'s parameters
    and tokens: the largest difference between the sharded and the
    unsharded output."""
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.models import layers
    from repro_torch.runtime import sharding as sh

    cell = port_cell("moe_prefill")
    cfg = dataclasses.replace(cell.cfg, dtype="bfloat16")
    mlp = torch_args(numpy_args(cell))["params"]["blocks"][0]["mlp"]
    mlp = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in mlp.items()}  # fp32 router
    places = D.placements(cell, mesh)["params"]["blocks"][0]["mlp"]
    assert places["w_gate"][mesh.mesh_dim_names.index("model")].is_shard(1)  # experts
    B, S = cell.shape.global_batch, cell.shape.seq_len
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    want = layers.moe_mlp({k: v[0] for k, v in mlp.items()}, x, cfg)
    sp = sh.shard_tree(mlp, places, mesh)
    xs = sh.shard_tree(x, sh.batch_sharding(mesh, 3, B), mesh)
    got = layers.moe_mlp({k: v[0] for k, v in sp.items()}, xs, cfg).full_tensor()
    return float((got.float() - want.float()).abs().max())


def _real_rank(rank: int, store_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun as D

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    results = {}
    for mname, shape in MESHES.items():
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "model"))
        for name in CELLS:
            cell = port_cell(name)
            args = numpy_args(cell)
            want = _outputs(cell, cell.step()(torch_args(args)))
            sargs = D.shard_args(cell, mesh, torch_args(args))
            step = cell.step(D.placements(cell, mesh))
            with implicit_replication(), CommDebugMode() as comm, D.CollectiveCounter() as cc:
                out = step(sargs)
            got = _outputs(cell, out)
            results[f"{name}@{mname}"] = {
                "errors": {k: float(np.abs(got[k] - want[k]).max()) for k in want},
                "scale": {k: float(np.abs(want[k]).max()) for k in want},
                "tally": cc.tally.record(), "comm_debug": kinds_of(comm.get_comm_counts())}
            if rank == 0 and mname == "2x2":
                np.savez(Path(out_dir) / f"port_{name}.npz", **got)
        results[f"moe_bf16@{mname}"] = moe_bf16_error(mesh)
    if rank == 0:
        (Path(out_dir) / "real.json").write_text(json.dumps(results))
    dist.destroy_process_group()


def run_real(out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_real_rank, args=(str(Path(out_dir) / "store"), out_dir), nprocs=4)


def run_fake(out_dir: str) -> None:
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import sharding as sh
    from repro_torch.tree import leaves, paths

    torch.set_num_threads(1)
    results = {}
    for mname, shape in MESHES.items():
        mesh = mesh_lib.make_fake_mesh(shape, ("data", "model"), device_type="cpu")
        for name in CELLS:
            cell = port_cell(name)
            rec = D.trace(cell, mesh=mesh)
            results[f"{name}@{mname}"] = {"tally": rec["collective_bytes"], "flops": rec["flops"]}
            if cell.shape.kind == "decode":
                results[f"{name}@{mname}"]["tally_by_length"] = [
                    D.trace(port_cell(name, S), mesh=mesh)["collective_bytes"]
                    for S in DECODE_LENGTHS]
            if mname == "2x2":
                places = D.placements(cell, mesh)
                shapes = {}
                for part in ("params", "opt", "cache"):
                    if part in cell.args:
                        flat_p = leaves(places[part], is_leaf=sh.is_placements)
                        for (p, t), pl in zip(paths(cell.args[part]), flat_p, strict=True):
                            shapes[part + "".join(p)] = list(
                                sh.local_shape(tuple(t.shape), pl, mesh))
                results[f"{name}@{mname}"]["shard_shapes"] = shapes
        for name in PROBED:
            cell = port_cell(name)
            cfg = dataclasses.replace(cell.cfg, n_layers=3 * cell.cfg.pattern_period,
                                      n_enc_layers=3 if cell.cfg.enc_dec else 0)
            variant = D.Variant(fsdp=True, tag="fsdp=1")
            got, want = (D.trace_cell(cfg, cell.shape, variant, full=full, mesh=mesh)
                         for full in (False, True))
            results[f"{name}@{mname}"]["probed"] = [
                {k: m[k] for k in ("flops", "bytes_accessed", "peak_bytes", "kernel_calls",
                                   "collective_bytes")} for m in (got, want)]
    for name in CELLS:
        results[f"{name}@1x1"] = {"flops": D.trace(port_cell(name))["flops"]}
    (Path(out_dir) / "fake.json").write_text(json.dumps(results))


def run_jax(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.launch import dryrun as JD  # forces the reference's 512 host devices
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import config as jconfig
    from repro.models import model as JM
    from repro.runtime import sharding as jsh

    from repro_torch.tree import paths

    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    results = {}
    for name in REFERENCE_CELLS:
        arch, changes, kind, S, B, pos = CELLS[name]
        cell = port_cell(name)
        args = numpy_args(cell)
        jconfig.SHAPES[name] = jconfig.ShapeConfig(name, kind, S, B)
        cfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
        fn, abstract, _ = JD.build_cell(cfg, name, mesh, JD.Variant())
        jargs = jax.tree.map(jnp.asarray, _as_jax(args, kind))
        shapes = {}
        with mesh:
            rules = jsh.rules_for(mesh, fsdp=False, shard_kv_seq=True)
            trees = {"params": (abstract[0], JM.model_specs(cfg))}
            if kind == "train":
                trees["opt"] = (abstract[1], {"mu": JM.model_specs(cfg),
                                              "nu": JM.model_specs(cfg), "count": ()})
            if kind == "decode":
                trees["cache"] = (abstract[1], JM.cache_specs(cfg))
            for part, (tree, specs) in trees.items():
                shard = jsh.tree_shardings(tree, specs, mesh, rules)
                for (p, a), s in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                     jax.tree.leaves(shard), strict=True):
                    shapes[part + jax.tree_util.keystr(p)] = list(s.shard_shape(a.shape))
            compiled = fn.lower(*abstract).compile()
            out = fn(*jargs)
        tally = JD.parse_collective_bytes(compiled.as_text())
        if kind == "train":
            got = {"loss": np.asarray(out[2]["loss"]), "grad_norm": np.asarray(out[2]["grad_norm"])}
            for part, tree in (("param", out[0]), ("mu", out[1]["mu"]), ("nu", out[1]["nu"])):
                flat = jax.tree_util.tree_flatten_with_path(tree)[0]
                by_key = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
                for i, (p, _) in enumerate(paths(cell.args["params"])):
                    got[f"{part}{i}"] = by_key["".join(p)]
        elif kind == "prefill":
            got = {"logits": np.asarray(out)}
        else:
            got = {"logits": np.asarray(out[0])}
            flat = jax.tree_util.tree_flatten_with_path(out[1])[0]
            by_key = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
            for i, (p, _) in enumerate(paths(cell.args["cache"])):
                got[f"cache{i}"] = by_key["".join(p)]
        np.savez(Path(out_dir) / f"jax_{name}.npz", **got)
        results[name] = {"shard_shapes": shapes, "tally": tally}
    tp = jax.make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4])
    for name in TENSOR_PARALLEL:  # compiled only, for the tally
        arch, changes, *_ = CELLS[name]
        cfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
        fn, abstract, _ = JD.build_cell(cfg, name, tp, JD.Variant())
        with tp:
            compiled = fn.lower(*abstract).compile()
        results[f"{name}@1x4"] = {"tally": JD.parse_collective_bytes(compiled.as_text())}
    (Path(out_dir) / "jax.json").write_text(json.dumps(results))


def _as_jax(args: dict, kind: str):
    """The numpy arguments in the reference step's order."""
    if kind == "train":
        return args["params"], args["opt"], args["batch"]
    if kind == "prefill":
        return args["params"], args["batch"]
    return args["params"], args["cache"], {"token": args["inputs"]["token"].astype(np.int32),
                                           "pos": args["inputs"]["pos"]}


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    {"real": run_real, "fake": run_fake, "jax": run_jax}[sys.argv[1]](sys.argv[2])
