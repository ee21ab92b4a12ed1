"""Logical-axis → mesh-axis resolution (DP / FSDP / TP / EP / SP + pod).

Port of ``repro.runtime.sharding`` onto ``torch.distributed``'s
``DeviceMesh`` and DTensor placements. Model code names each parameter's
dimensions with *logical* axes (``models.layers``: ``vocab``, ``embed``,
``heads``, ...; ``model.model_specs`` and ``model.cache_specs``). This
module resolves them for a concrete mesh with the reference's rules and
its shape-aware divisibility guard: a mesh axis is applied only to a
tensor dimension it divides evenly, otherwise that dimension stays
replicated, and one mesh axis is never used twice in one spec. So one rule
set holds for all ten archs (xLSTM's 4 heads cannot shard over a 16-way
model axis; its projections still shard on the flat head·dim axis).

Two things differ from the reference:

- ``resolve_spec`` returns the mesh axes per tensor dimension (a tuple,
  the ``PartitionSpec`` analogue: None, an axis name, or a tuple of names
  for a dimension split over several mesh axes, major first; a rule's
  tuple of one name is that name, as ``PartitionSpec`` prints it);
- ``tree_shardings``, ``replicated`` and ``batch_sharding`` return DTensor
  placements, one per mesh dimension: ``Shard(d)`` where the mesh axis
  splits tensor dimension d, else ``Replicate()``.

``local_shape`` and ``local_bytes`` give what one device holds of a leaf
under its placements. The guard never lets torch's uneven sharding arise
(1000 rows over 16 would give some devices 63 and others 62):
``local_shape`` asserts that every split is even.

Parallelism layout, as the reference's:

- batch → ("pod", "data"): pure data parallelism across pods;
- heads / ff / vocab / inner → "model": Megatron-style tensor parallelism;
- embed (the weights' d_model dim) → "data" when ``fsdp``: ZeRO-3-style
  weight and optimizer sharding;
- experts → "model" when E divides the axis (expert parallelism), else
  tensor parallelism over ff;
- kv_seq → "model" for decode caches (sequence parallelism), when asked.

The rest runs a step on DTensors placed so (``launch/dryrun.py``'s sharded
trace, a real run over a process group): ``to_dtensors`` and ``shard_tree``
place a tree, ``run_local`` runs a function on each device's shards under
stated placements (the kernels' entries, the embedding, the loss, the MoE
dispatch), ``matmul`` is Megatron's column- and row-parallel product with
FSDP's gather, ``settle`` the reduction that ends a row-parallel block, and
``split_last`` / ``merge_last`` reshape heads where DTensor's own view rules
would refuse. Each states its placements rather than leaving them to
DTensor's search, whose choices depend on the shapes (a layer stack of one
and of two would communicate differently) and cost minutes of planning on
a three-axis mesh.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.tree import is_spec, leaves, unflatten


def axis_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its dim names and shape)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def batch_axes(mesh: Any) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def rules_for(mesh: Any, *, fsdp: bool, shard_kv_seq: bool = False,
              expert_parallel: bool = True,
              tensor_parallel: bool = True) -> dict[str | None, Any]:
    """Logical axis → mesh axis (None, a name, or a tuple of names).
    ``tensor_parallel=False`` replicates weights over the model axis and lets
    it carry extra batch instead (small models, whose per-op shards would be
    slivers)."""
    tp = "model" if tensor_parallel else None
    batch = batch_axes(mesh)
    if not tensor_parallel:
        batch = batch + ("model",)
    return {
        "vocab": tp,
        "embed": "data" if fsdp else None,
        "heads": tp,
        "kv_heads": tp,
        "head_dim": None,
        "ff": tp,
        "experts": tp if expert_parallel else None,
        "layers": None,
        "inner": tp,
        "state": None,
        "batch": batch,
        "kv_seq": "model" if (shard_kv_seq and tensor_parallel) else None,
        None: None,
    }


def _flat(axis: Any) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else ((axis,) if axis else ())


def resolve_spec(spec: tuple, shape: tuple[int, ...], mesh: Any,
                 rules: dict[str | None, Any]) -> tuple:
    """Logical spec + concrete shape -> the mesh axes of each dimension.

    Drops any mesh axis that does not divide its dimension, and never uses
    one mesh axis twice in a spec."""
    assert len(spec) == len(shape), (spec, shape)
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for logical, dim in zip(spec, shape):
        axis = rules.get(logical)
        flat = _flat(axis)
        if axis is None or any(a in used for a in flat) or dim % math.prod(
                sizes[a] for a in flat) != 0:
            out.append(None)
            continue
        used.update(flat)
        out.append(flat[0] if len(flat) == 1 else flat)
    return tuple(out)


def placements(axes: tuple, mesh: Any) -> tuple:
    """DTensor placements, one per mesh dimension, of a tensor whose
    dimensions take the mesh axes ``axes`` (``resolve_spec``'s result)."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: d for d, axis in enumerate(axes) for a in _flat(axis)}
    return tuple(Shard(dim_of[name]) if name in dim_of else Replicate()
                 for name in mesh.mesh_dim_names)


def tree_shardings(abstract: Any, specs: Any, mesh: Any,
                   rules: dict[str | None, Any]) -> Any:
    """Placements for each leaf of a tree given its (abstract) tensors and
    its spec tree, which parallel each other; the result has the spec
    tree's structure."""
    flat_a = leaves(abstract)
    flat_s = leaves(specs, is_leaf=is_spec)
    assert len(flat_a) == len(flat_s), (len(flat_a), len(flat_s))
    out = [placements(resolve_spec(s, tuple(a.shape), mesh, rules), mesh)
           for a, s in zip(flat_a, flat_s)]
    return unflatten(abstract, out)


def replicated(mesh: Any) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def batch_sharding(mesh: Any, ndim: int = 2, dim0: int | None = None) -> tuple:
    """Shard dim 0 (the global batch) over the data axes; replicate the rest.
    When ``dim0`` is given and the data axes do not divide it (long_500k's
    batch of 1), dim 0 stays replicated."""
    axes = batch_axes(mesh)
    if dim0 is not None and dim0 % math.prod(axis_sizes(mesh)[a] for a in axes):
        return replicated(mesh)
    return placements((axes, *([None] * (ndim - 1))), mesh)


def local_shape(shape: tuple[int, ...], places: tuple, mesh: Any) -> tuple[int, ...]:
    """What one device holds of a tensor of ``shape`` under ``places``."""
    out = list(shape)
    for p, size in zip(places, mesh.shape, strict=True):
        if p.is_shard():
            assert out[p.dim] % size == 0, ("uneven shard", shape, places, tuple(mesh.shape))
            out[p.dim] //= size
    return tuple(out)


def local_bytes(t: torch.Tensor, places: tuple, mesh: Any) -> int:
    return math.prod(local_shape(tuple(t.shape), places, mesh)) * t.element_size()


def is_placements(x: Any) -> bool:
    """A placements tree's leaf: a tuple of DTensor placements."""
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def tree_local_bytes(tree: Any, places: Any, mesh: Any) -> int:
    """Bytes one device holds of a tree of tensors under a parallel tree of
    placements (``tree_shardings``)."""
    return sum(local_bytes(t, p, mesh) for t, p in zip(
        leaves(tree), leaves(places, is_leaf=is_placements), strict=True))


# ---------------------------------------------------------------------------
# Running on DTensors: what a sharded step needs beyond the placements
# ---------------------------------------------------------------------------

def is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _placed(tree: Any, places: Any, one) -> Any:
    """``one(leaf, placements)`` of each tensor leaf of ``tree`` under the
    parallel tree ``places`` (a single placements tuple for every leaf);
    other leaves pass through."""
    flat = leaves(tree)
    flat_p = ([places] * len(flat) if is_placements(places)
              else leaves(places, is_leaf=is_placements))
    return unflatten(tree, [one(t, p) if isinstance(t, torch.Tensor) else t
                            for t, p in zip(flat, flat_p, strict=True)])


def to_dtensors(tree: Any, places: Any, mesh: Any) -> Any:
    """A tree of global tensors as DTensors under a parallel tree of
    placements, each device's shard an empty meta tensor: shapes only,
    nothing allocated."""
    from torch.distributed.tensor import DTensor

    return _placed(tree, places, lambda t, p: DTensor.from_local(
        torch.empty(local_shape(tuple(t.shape), p, mesh), dtype=t.dtype, device="meta"),
        mesh, p, run_check=False))


def shard_tree(tree: Any, places: Any, mesh: Any) -> Any:
    """A tree of real global tensors (the same on every rank) as DTensors
    under a parallel tree of placements: each rank keeps its own shard, cut
    out where it stands (no communication, no copy where the shard is
    contiguous; on a mesh of one device every leaf is its own shard)."""
    from torch.distributed.tensor import DTensor

    def one(t, p):
        for i, pl in enumerate(p):
            if pl.is_shard():
                t = t.chunk(mesh.shape[i], dim=pl.dim)[mesh.get_local_rank(i)]
        return DTensor.from_local(t.contiguous(), mesh, p, run_check=False)

    return _placed(tree, places, one)


def redistribute_tree(tree: Any, places: Any) -> Any:
    """Each DTensor leaf of ``tree`` redistributed to its placements in the
    parallel tree ``places`` (or to ``places`` itself, one placements tuple
    for every leaf)."""
    return _placed(tree, places, lambda t, p: t.redistribute(t.device_mesh, p)
                   if is_dtensor(t) and tuple(t.placements) != tuple(p) else t)


def settle(y: Any, like: Any) -> Any:
    """``y`` redistributed to the placements of ``like`` where both are
    DTensors (Megatron's reduction at the end of a row-parallel product:
    a Partial sum becomes ``like``'s Replicate by one all-reduce); plain
    tensors pass through."""
    if not (is_dtensor(y) and is_dtensor(like)) or y.placements == like.placements:
        return y
    return y.redistribute(like.device_mesh, like.placements)


def split_last(t: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``t.reshape(*t.shape[:-1], *shape)`` for a DTensor whose last dimension
    may be sharded: a mesh axis that splits it but not ``shape[0]`` (heads
    that do not divide the axis) is gathered first, so each device holds
    whole heads. DTensor would refuse the reshape otherwise."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate

        last = t.ndim - 1
        n = shape[0]
        sizes = t.device_mesh.shape
        places = []
        for p, size in zip(t.placements, sizes):
            if p.is_shard(last):
                if n % size:
                    p = Replicate()
                else:
                    n //= size
            places.append(p)
        if tuple(places) != tuple(t.placements):
            t = t.redistribute(t.device_mesh, places)
    return t.reshape(*t.shape[:-1], *shape)


def run_local(fn, args: tuple, in_places: tuple, out_places: Any,
              grad_places: tuple | None = None) -> Any:
    """``fn`` on each device's shards, the port's ``local_map``: each DTensor
    argument redistributed to its entry of ``in_places`` (plain tensors are
    taken as replicated; an entry None passes its argument as it is), ``fn``
    called on the local tensors, and its result (a tensor or a tuple; None
    entries pass through) wrapped under ``out_places``, parallel to it.
    ``grad_places`` (default ``in_places``) says how each argument's local
    gradient adds up across devices: ``Partial()`` on an axis where the
    argument is replicated but each device uses only part of it."""
    from torch.distributed.tensor import DTensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    grad_places = grad_places or in_places
    local = []
    for a, p, g in zip(args, in_places, grad_places, strict=True):
        if p is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, replicated(mesh), run_check=False)
        if tuple(a.placements) != tuple(p):
            a = a.redistribute(mesh, p)
        local.append(a.to_local(grad_placements=g))
    out = fn(*local)

    def wrap(o, p):
        return o if o is None or p is None else DTensor.from_local(o, mesh, p, run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(o, p) for o, p in zip(out, out_places, strict=True))
    return wrap(out, out_places)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations x (..., din) and a weight w (din, dout). On
    DTensors it is Megatron's layout, stated per mesh axis rather than left
    to DTensor's search: where x shards its batch (dim 0), w is gathered
    (FSDP) and its gradient is a Partial sum; elsewhere a w sharded along
    dout is column-parallel (x replicated, the output sharded along dout,
    x's gradient a Partial sum), one sharded along din row-parallel (x
    sharded along din, the output a Partial sum), and a replicated w leaves
    x replicated."""
    if not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = w.device_mesh
    last = x.ndim - 1
    xp, xg, wp, wg, yp = [], [], [], [], []
    x_places = x.placements if is_dtensor(x) else replicated(mesh)
    for px, pw in zip(x_places, w.placements, strict=True):
        if px.is_shard(0) and last > 0:
            xp.append(Shard(0)), xg.append(Shard(0)), wp.append(Replicate())
            wg.append(Partial()), yp.append(Shard(0))
        elif pw.is_shard(1):
            xp.append(Replicate()), xg.append(Partial()), wp.append(Shard(1))
            wg.append(Shard(1)), yp.append(Shard(last))
        elif pw.is_shard(0):
            xp.append(Shard(last)), xg.append(Shard(last)), wp.append(Shard(0))
            wg.append(Shard(0)), yp.append(Partial())
        else:
            xp.append(Replicate()), xg.append(Replicate()), wp.append(Replicate())
            wg.append(Replicate()), yp.append(Replicate())
    return run_local(torch.matmul, (x, w), (tuple(xp), tuple(wp)), tuple(yp),
                     (tuple(xg), tuple(wg)))


def merge_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last two dimensions merged (heads × head dim -> one).
    On a DTensor each device merges its own shard, so a gradient that comes
    back sharded along the merged dimension is first placed as ``t`` was,
    whole heads per device: DTensor cannot split a merged dimension whose
    shards cut across heads."""
    if not is_dtensor(t):
        return t.reshape(*t.shape[:-2], -1)
    from torch.distributed.tensor import Shard

    last = t.ndim - 1
    assert not any(p.is_shard(last) for p in t.placements), ("head dim sharded", t.placements)
    out = tuple(Shard(last - 1) if p.is_shard(last - 1) else p for p in t.placements)
    return run_local(lambda x: x.reshape(*x.shape[:-2], -1), (t,), (tuple(t.placements),), out)


def pointwise(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` for an elementwise ``fn``: on a DTensor each device applies it
    to its own shard (a Partial sum reduced first), for the elementwise ops
    DTensor has no rule for (``log_sigmoid``'s backward)."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import Replicate

    places = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return run_local(fn, (t,), (places,), places)


def reduced_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself; on a DTensor its gradient is reduced to ``t``'s placements
    here, before it flows further back: a slice of a table whose gradient
    would otherwise be reduced at the table's full size."""
    if not is_dtensor(t):
        return t
    return run_local(lambda x: x, (t,), (tuple(t.placements),), tuple(t.placements))


def zeros_batched(shape: tuple[int, ...], like: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of ``shape`` (batch first) on ``like``'s device. For a
    DTensor ``like`` they are a DTensor sharded over the batch axes as
    ``like`` (replicated elsewhere), each device making its own shard: a
    plain tensor of the global batch would be taken as replicated, and an
    op that meets it may gather ``like``'s batch to match."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = like.device_mesh
    places = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in like.placements)
    local = torch.zeros(local_shape(shape, places, mesh), dtype=torch.float32,
                        device=like.to_local().device)
    return DTensor.from_local(local, mesh, places, run_check=False)
