"""Minimal nested-container helpers (the port's stand-in for the few
``jax.tree_util`` calls the serving path makes).

A tree is a dict, list or tuple of subtrees; anything else is a leaf,
and ``None`` is an empty subtree, as in ``jax.tree_util``. Dict leaves
come in sorted-key order, so a flattening here matches the reference
package's on the same nested structure.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_leaves(tree: Any,
                is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    """Every leaf of ``tree`` in flattening order."""
    out: List[Any] = []

    def walk(x):
        if x is None:
            return
        if is_leaf is not None and is_leaf(x):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif _is_node(x):
            for v in x:
                walk(v)
        else:
            out.append(x)

    walk(tree)
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``tree`` with ``fn`` applied to every leaf; containers keep their
    type (a namedtuple stays that namedtuple)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, is_leaf))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)
