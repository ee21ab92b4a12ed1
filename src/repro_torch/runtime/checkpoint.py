"""Checkpointing: an npz file of the tree's leaves, written atomically.

The port of ``repro.runtime.checkpoint``, file format included, so a file
written by the JAX package loads here:

- one entry per leaf, keyed by its path as ``jax.tree_util`` prints it,
  ``"/".join(str(k) for k in path)``: ``['params']/['blocks']/[0]/
  ['mixer']/['wq']``, ``['opt']/['count']``; plus ``__step__``;
- bf16 leaves are stored as their raw 2-byte patterns (numpy reads them as
  ``|V2``: numpy has no bf16 without ``ml_dtypes``, which the port does not
  use). ``restore`` reinterprets such bits as ``torch.bfloat16``; it
  converts no bf16 value numerically;
- writes go to a temporary name, then ``os.replace`` (atomic).

``restore(..., placements, mesh)`` puts each leaf onto a ``DeviceMesh``
(elastic resume). ``save(..., async_=True)`` copies the tree to the host on the caller (the
training loop may go on and replace the tensors) and writes the file on a
thread it returns.
"""
from __future__ import annotations

import os
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves, paths, unflatten

_BF16_BITS = np.dtype("V2")


def _key(path: tuple[str, ...]) -> str:
    return "/".join(path)


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(p): _to_host(leaf) for p, leaf in paths(tree)}


def save(path: str, tree: Any, step: int, async_: bool = False
         ) -> threading.Thread | None:
    """Write a checkpoint of ``tree`` (tensors as leaves) at ``step``. With
    ``async_=True`` returns the writer thread (the device-to-host copy
    happens on the caller; file I/O overlaps training)."""
    host = _flatten(tree)

    def write():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        np.savez(tmp, __step__=np.asarray(step), **host)
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(path: str) -> int | None:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return int(z["__step__"])


def _leaf(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if arr.shape != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    if arr.dtype == _BF16_BITS or arr.dtype.name == "bfloat16":
        if like.dtype != torch.bfloat16:
            raise ValueError(f"checkpoint leaf {key} holds bf16 bits, target is {like.dtype}")
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, like: Any, placements: Any | None = None, mesh: Any | None = None
            ) -> tuple[Any, int]:
    """Load a checkpoint into the structure of ``like`` (a tree of tensors
    giving each leaf's shape, dtype and device); returns (tree, step).
    With ``placements`` (a parallel tree, ``runtime.sharding.tree_shardings``)
    and ``mesh`` (the current ``DeviceMesh``) each leaf is put onto the mesh
    as a DTensor with ``distribute_tensor``: the reference's elastic resume,
    which reshards a checkpoint onto whatever mesh the job now has."""
    with np.load(path) as z:
        step = int(z["__step__"])
        flat = [_leaf(z[_key(p)], leaf, _key(p)) for p, leaf in paths(like)]
    if placements is not None:
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.runtime.sharding import is_placements

        flat = [distribute_tensor(t, mesh, list(pl)) for t, pl in
                zip(flat, leaves(placements, is_leaf=is_placements), strict=True)]
    return unflatten(like, flat), step
