"""Nested-dict parameter trees: the port's stand-in for `jax.tree`.

Leaves are visited in sorted key order at every level, as `jax.tree_util`
orders dict keys, so a flattened tree lines up leaf for leaf with the
reference's (global norms sum in the same order, checkpoint keys match).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_leaves", "tree_map", "tree_map_with_path", "tree_paths", "tree_unflatten"]


def tree_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] with paths "a/b/c" — the reference checkpoint's keys."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """The inverse of `tree_leaves`: `leaves` (in its order) shaped as `like`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """fn(path, leaf) over a tree, paths as in `tree_paths`."""
    if isinstance(tree, dict):
        return {
            k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()
        }
    return fn(prefix, tree)
