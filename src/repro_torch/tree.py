"""Nested dicts, lists and tuples of tensors: the part of
``jax.tree_util`` the port's optimizers, checkpoints and train step need.

Dict keys are visited in sorted order, as ``jax.tree`` visits them, so a
leaf list (and a Python sum over it, as in ``optim.adamw.global_norm``)
has the reference's order. Anything that is not a dict, list or tuple is
a leaf. A tree definition is the tree itself with ``None`` in place of
each leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


# The walks below are module-level functions handed their output list: a
# nested recursive closure refers to itself through its own cell, a
# reference cycle that would keep every leaf it saw alive until the
# cyclic garbage collector runs.

def _walk(t, out):
    if not _is_node(t):
        out.append(t)
        return None
    if isinstance(t, dict):
        return {k: _walk(t[k], out) for k in sorted(t)}
    return type(t)(_walk(c, out) for c in t)


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in order, tree definition)."""
    out: List[Any] = []
    return out, _walk(tree, out)


def _walk_path(t, path, out):
    if not _is_node(t):
        out.append((path, t))
        return None
    if isinstance(t, dict):
        return {k: _walk_path(t[k], path + (k,), out) for k in sorted(t)}
    return type(t)(_walk_path(c, path + (i,), out) for i, c in enumerate(t))


def flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """([(path, leaf)] in order, tree definition); a path is the tuple
    of dict keys and list / tuple indices from the root to the leaf (the
    reference's key paths, ``DictKey("layers")`` being ``"layers"``)."""
    out: List[Tuple[tuple, Any]] = []
    return out, _walk_path(tree, (), out)


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def flatten_up_to(treedef, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef``."""
    if treedef is None:
        return [tree]
    if isinstance(treedef, dict) and sorted(treedef) != sorted(tree):
        raise ValueError(f"tree keys {sorted(tree)} != {sorted(treedef)}")
    if len(_children(treedef)) != len(_children(tree)):
        raise ValueError("tree does not match the tree definition")
    out = []
    for d, t in zip(_children(treedef), _children(tree)):
        out.extend(flatten_up_to(d, t))
    return out


def _build(d, it):
    if d is None:
        return next(it)
    if isinstance(d, dict):
        return {k: _build(d[k], it) for k in sorted(d)}
    return type(d)(_build(c, it) for c in d)


def unflatten(treedef, items) -> Any:
    """The tree of ``treedef`` with ``items`` at its leaves, in order."""
    it = iter(items)
    out = _build(treedef, it)
    if next(it, it) is not it:
        raise ValueError("more items than the tree definition has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    each of ``rest``."""
    flat, treedef = flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
