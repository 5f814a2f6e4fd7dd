"""Nested-structure flatten/pack utilities.

The counterpart of ``analytics_zoo_tpu/utils/nest.py`` (the reference's
``zoo.util.nest`` names), over ``utils/tree.py`` in place of
``jax.tree_util``: a structure is a dict, list or tuple of substructures
(a namedtuple keeps its type), anything else is a leaf, ``None`` is an
empty subtree, and dict keys come in sorted order, as in jax.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence

from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map


def flatten(structure: Any) -> List[Any]:
    """Flatten a nested structure (dicts sorted by key, like pytrees)."""
    return tree_leaves(structure)


def _treedef(x: Any) -> Any:
    """A comparable description of ``x``'s structure (its leaves left
    out): the counterpart of a jax treedef."""
    if x is None:
        return None
    if isinstance(x, dict):
        return (dict, tuple((k, _treedef(x[k])) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_treedef(v) for v in x))
    return "*"


def _pack(x: Any, leaves: Iterator[Any]) -> Any:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _pack(x[k], leaves) for k in sorted(x)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_pack(v, leaves) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_pack(v, leaves) for v in x)
    return next(leaves)


def pack_sequence_as(structure: Any, flat_sequence: Sequence[Any]) -> Any:
    """Inverse of :func:`flatten` given a template ``structure``."""
    flat = list(flat_sequence)
    n = len(tree_leaves(structure))
    if len(flat) != n:
        raise ValueError(f"the structure has {n} leaves, the sequence "
                         f"{len(flat)}")
    return _pack(structure, iter(flat))


def map_structure(fn, structure: Any) -> Any:
    return tree_map(fn, structure)


def assert_same_structure(a: Any, b: Any) -> None:
    ta, tb = _treedef(a), _treedef(b)
    if ta != tb:
        raise ValueError(f"structures differ: {ta} vs {tb}")
