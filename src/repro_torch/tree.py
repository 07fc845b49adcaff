"""Nested dicts (and tuples) of tensors: the port's parameter, optimizer and
checkpoint trees.

Leaves are visited in the order of ``jax.tree_util`` on the same tree: dict
keys sorted, tuple and list items by index.  So sums over leaves add in the
reference's order, and the checkpoint keys ``"a/b/c"`` are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree) -> Iterator[tuple[Any, Any]] | None:
    if isinstance(tree, dict):
        return ((k, tree[k]) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return enumerate(tree)
    return None


def leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf; a path is the tuple of keys and
    indices from the root."""
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from leaves_with_path(v, path + (k,))


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """A tree of ``tree``'s structure holding ``fn(path, leaf, *leaves of
    rest)``; ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def map_tree(fn: Callable, tree, *rest):
    """``map_with_path`` without the path."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def key(path: tuple) -> str:
    """A path as the checkpoint key of the reference: ``"a/b/0/c"``."""
    return "/".join(str(p) for p in path)
