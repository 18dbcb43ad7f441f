"""Nested containers of tensors: the port's param, gradient and train-state
trees (dicts, lists, tuples and NamedTuples with tensor or scalar leaves).

The reference walks its pytrees with ``jax.tree``; these two functions are
what the port needs of that: the leaves with their paths, in a fixed order,
and a structure-preserving map.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _items(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]``: dict keys in insertion order, list and tuple
    items by index, NamedTuple fields by name; a path is a tuple of
    strings, e.g. ``("opt", "m", "layers", "0", "mixer", "wq")``."""
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += leaves_with_paths(sub, prefix + (str(key),))
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure; returns a
    tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
