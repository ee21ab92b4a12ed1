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
