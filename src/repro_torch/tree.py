"""A small pytree helper over dicts, lists, tuples, NamedTuples and ``None``.

It visits a tree in the order ``jax.tree`` does — **dict keys sorted**,
sequences and NamedTuple fields in order, ``None`` an empty node — so that a
parameter tree flattens to the same leaf order in the port as in the JAX
reference.  That order decides the float sum order of ``global_norm`` and the
order in which kernels are launched over the leaves.  (Python's insertion
order and ``torch.utils._pytree``'s dict order differ from it.)

Anything that is not one of those containers is a leaf; ``is_leaf`` makes a
container a leaf too (a packed ``{"q", "scales", ...}`` dict, for instance).
"""
from __future__ import annotations

import builtins
from typing import Any, Callable, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


class _Leaf:
    """Placeholder for a leaf in a :func:`structure` skeleton."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x: Any, is_leaf: IsLeaf):
    """``(kind, keys, children)`` of a container node, or ``None`` for a leaf."""
    if is_leaf is not None and is_leaf(x):
        return None
    if x is None:
        return "none", (), ()
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return "dict", keys, tuple(x[k] for k in keys)
    if _is_namedtuple(x):
        return "namedtuple", tuple(x._fields), tuple(x)
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(range(len(x))), tuple(x)
    return None


def leaves_with_path(tree: Any, is_leaf: IsLeaf = None
                     ) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree`` order; a path is the tuple of
    dict keys, sequence indices and NamedTuple field names from the root."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []
    _walk(tree, (), is_leaf, out)
    return out


# The recursions are module-level functions, not closures: a nested function
# that calls itself is a reference cycle, and one that also holds the leaves
# (or the output list) keeps every tensor of the tree alive until the cyclic
# garbage collector runs — gigabytes on the card, for a model's deltas.
def _walk(x: Any, path: Tuple[Any, ...], is_leaf: IsLeaf,
          out: List[Tuple[Tuple[Any, ...], Any]]) -> None:
    node = _children(x, is_leaf)
    if node is None:
        out.append((path, x))
        return
    _, keys, kids = node
    for k, c in zip(keys, kids):
        _walk(c, path + (k,), is_leaf, out)


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def structure(tree: Any, is_leaf: IsLeaf = None) -> Any:
    """The tree with every leaf replaced by :data:`LEAF` (the argument of
    :func:`unflatten`)."""
    return map(lambda _: LEAF, tree, is_leaf=is_leaf)


def unflatten(treedef: Any, leaves_: List[Any]) -> Any:
    """Rebuild a tree of ``treedef``'s shape from leaves in tree order."""
    it = iter(leaves_)
    out = map(lambda _: next(it), treedef, is_leaf=lambda x: x is LEAF)
    rest = builtins.sum(1 for _ in it)
    if rest:
        raise ValueError(f"unflatten: {rest} leaves left over")
    return out


def map(fn: Callable[..., Any], tree: Any, *rest: Any,
        is_leaf: IsLeaf = None) -> Any:
    """``fn`` applied leafwise over ``tree`` and trees of the same structure
    (``rest``), visiting leaves in ``jax.tree`` order."""
    return _map(fn, tree, rest, is_leaf)


def _map(fn: Callable[..., Any], x: Any, others: Tuple[Any, ...],
         is_leaf: IsLeaf) -> Any:
    node = _children(x, is_leaf)
    if node is None:
        return fn(x, *others)
    kind, keys, kids = node
    if kind == "dict":
        for o in others:
            if not isinstance(o, dict) or set(o) != set(keys):
                raise ValueError("tree.map: dict keys differ")
        return {k: _map(fn, c, tuple(o[k] for o in others), is_leaf)
                for k, c in zip(keys, kids)}
    if kind == "none":
        return None
    for o in others:
        if len(o) != len(kids):
            raise ValueError("tree.map: sequence lengths differ")
    new = [_map(fn, c, tuple(o[i] for o in others), is_leaf)
           for i, c in enumerate(kids)]
    if kind == "namedtuple":
        return type(x)(*new)
    return type(x)(new)
