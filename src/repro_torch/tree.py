"""Nested containers of tensors: what ``jax.tree_util`` does for the JAX
package, for the port's params, optimizer state and batches.

A tree is a dict (its keys visited in sorted order, as JAX flattens a
dict), a list or a tuple of trees, or a leaf (anything else, and a
``PartitionSpec``, a tuple that is a leaf in JAX's trees too).  A leaf's
key string is JAX's ``keystr`` of its path (``"['opt']['m']['embed']"``,
``"[0]"`` for a sequence index), so a checkpoint names its leaves as the
JAX package's does (``train.checkpoint``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return [(f"[{i}]", x) for i, x in enumerate(tree)]


def _is_node(tree) -> bool:
    # a tuple that marks itself a leaf (``sharding.spec.PartitionSpec``)
    # is one, as ``PartitionSpec`` is a leaf of a JAX tree
    return (isinstance(tree, (dict, list, tuple))
            and not getattr(tree, "_tree_leaf", False))


def keyed_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key string, leaf) of every leaf, in JAX's flattening order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(keyed_leaves(child, prefix + key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in keyed_leaves(tree)]


def _build(t, it) -> Any:
    if isinstance(t, dict):
        out = {k: _build(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}              # the caller's key order
    if _is_node(t):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def unflatten_like(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` (an iterable, in
    the order :func:`leaves` gives ``like``'s leaves).  No closure refers
    to itself here: a suspended generator of ``values`` (and whatever its
    frame holds, e.g. a train step's new state) is freed on return, not
    at the next garbage collection."""
    return _build(like, iter(values))


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` of each leaf of ``tree`` and the leaves at the same places
    in ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten_like(tree, (fn(x, *(o[i] for o in others))
                                 for i, x in enumerate(leaves(tree))))


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\d+)\]")


def parse_key(key: str) -> list:
    """A key string's path: dict keys as str, sequence indices as int."""
    path, pos = [], 0
    for m in _KEY.finditer(key):
        if m.start() != pos:
            raise ValueError(f"not a key string: {key!r}")
        tok = m.group(1)
        path.append(int(tok) if tok.isdigit() else
                    tok[1:-1].encode().decode("unicode_escape"))
        pos = m.end()
    if pos != len(key):
        raise ValueError(f"not a key string: {key!r}")
    return path


def from_keyed(pairs) -> Any:
    """The tree whose :func:`keyed_leaves` are ``pairs``: nested dicts,
    with lists where every key of a level is an index."""
    root: dict = {}
    for key, leaf in pairs:
        path = parse_key(key)
        if not path:
            return leaf
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(isinstance(k, int) for k in t):
            return [t[i] for i in range(len(t))]
        return t
    return listify(root)
