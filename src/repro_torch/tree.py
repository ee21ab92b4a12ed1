"""Parameter trees: nested dictionaries and lists with tensors as leaves.

The port keeps the JAX package's pytrees as plain containers (``dict``,
``list``, ``tuple``); these helpers walk them in one fixed order: dict
insertion order, then list order. (``jax.tree_util`` sorts dict keys
instead, so compare a port tree with a JAX one by path, not by leaf
position.) A spec tree (``runtime.sharding``) holds tuples of axis names as
its leaves: walk it with ``is_leaf=is_spec``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def is_spec(x: Any) -> bool:
    """A spec tree's leaf: a tuple of logical axis names (str or None)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _never(_: Any) -> bool:
    return False


def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] = _never) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which share its structure; the result has that structure. ``is_leaf``
    stops the walk at containers it accepts."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Any, is_leaf: Callable[[Any], bool] = _never) -> list[Any]:
    """The leaves of ``tree`` in ``map_tree``'s order."""
    return [leaf for _, leaf in paths(tree, is_leaf=is_leaf)]


def paths(tree: Any, prefix: tuple[str, ...] = (), is_leaf: Callable[[Any], bool] = _never
          ) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) for every leaf, the path as ``jax.tree_util`` prints its
    keys: ``['name']`` for a dict key, ``[i]`` for a list or tuple index."""
    if is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, (*prefix, f"[{k!r}]"), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, (*prefix, f"[{i}]"), is_leaf)
    else:
        yield prefix, tree


def unflatten(like: Any, flat: list[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``flat``, in order."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
