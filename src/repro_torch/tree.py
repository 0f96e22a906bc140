"""Trees of tensors: nested dicts, lists and tuples with anything else as
a leaf.

Leaves are visited in `jax.tree.leaves`' order (dict keys sorted,
sequences in order), the order in which the reference sums
`global_norm`, zips params with grads and moments, and names checkpoint
keys.  The optimizer, the train step and the checkpointer all walk trees
through this module.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree) -> list | None:
    """(key, child) pairs of a node in leaf order; None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) in leaf order; a path is the keys and indices from the
    root."""
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from leaves_with_paths(v, path + (k,))


def tree_leaves(tree) -> list:
    """The leaves of `tree` in leaf order."""
    return [x for _, x in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """A tree like `tree` of ``fn(leaf, *same leaves of rest)``; `rest` may
    hold subtrees where `tree` holds a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, values) -> Any:
    """A tree like `like` whose leaves are `values`, taken in leaf order;
    dicts keep `like`'s key order."""
    it = iter(values)

    def take(t):
        if isinstance(t, dict):
            got = {k: take(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(take(v) for v in t)
        return next(it)

    return take(like)
