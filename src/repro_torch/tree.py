"""Nested-container helpers for the training state.

The reference keeps parameters, optimizer state and the journaled train
state as JAX pytrees.  The port keeps the same trees as nested ``dict``s,
``list``s and ``tuple``s of tensors and walks them the way
``jax.tree_util`` does: dict keys in sorted order, sequences in order.
:func:`keystr_items` names every leaf with the string
``jax.tree_util.keystr`` gives its path (``['opt']['mu']['groups'][0]``),
which is how the training journal keys its records.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """``(key part, child)`` of one container node, in the reference's
    flattening order; ``None`` for a leaf."""
    if isinstance(tree, dict):
        return ((f"[{k!r}]", tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ((f"[{i}]", v) for i, v in enumerate(tree))
    return None


def keystr_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr path, leaf)`` for every leaf, in flattening order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for part, child in kids:
        yield from keystr_items(child, prefix + part)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in keystr_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), called in flattening order;
    returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten_like(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` in flattening
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
