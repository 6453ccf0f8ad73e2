"""The tree a caller snapshots, flattened in ``jax.tree_util``'s leaf order.

A generation's stream is its leaves' bytes in tree order, so a tree must
flatten here exactly as the JAX package flattens it, or a generation would
not cross packages:

- a ``dict`` (``defaultdict`` included) goes in sorted-key order;
- an ``OrderedDict`` (torch's ``state_dict()``) in insertion order;
- a ``list``, a ``tuple`` and a namedtuple in order;
- ``None`` is an empty subtree;
- anything else is a leaf: a tensor, a numpy array, a numpy or Python
  scalar (which the snapshot takes as a 0-d array, as ``np.asarray``
  makes it).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _node(tree) -> Tuple[list, Callable[[list], Any]]:
    """``(children, rebuild)`` of one container node, or None for a
    leaf."""
    if tree is None:
        return [], lambda _: None
    if isinstance(tree, collections.OrderedDict):
        keys = list(tree)
        cls = type(tree)
        return [tree[k] for k in keys], lambda ch: cls(zip(keys, ch))
    if isinstance(tree, dict):
        keys = sorted(tree)
        if isinstance(tree, collections.defaultdict):
            factory = tree.default_factory
            return ([tree[k] for k in keys],
                    lambda ch: collections.defaultdict(factory,
                                                       zip(keys, ch)))
        cls = type(tree)
        return [tree[k] for k in keys], lambda ch: cls(zip(keys, ch))
    if _is_namedtuple(tree):
        cls = type(tree)
        return list(tree), lambda ch: cls(*ch)
    if isinstance(tree, (list, tuple)):
        cls = type(tree)
        return list(tree), lambda ch: cls(ch)
    return None


def flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """``(leaves, rebuild)``: the leaves in jax's order, and a function
    that builds the same structure around a list of as many new leaves."""
    leaves: List[Any] = []

    def walk(t):
        node = _node(t)
        if node is None:
            leaves.append(t)
            return None
        children, make = node
        return make, [walk(c) for c in children]

    spec = walk(tree)

    def build(s, it):
        if s is None:
            return next(it)
        make, children = s
        return make([build(c, it) for c in children])

    def rebuild(new_leaves) -> Any:
        new_leaves = list(new_leaves)
        if len(new_leaves) != len(leaves):
            raise ValueError(f"the tree has {len(leaves)} leaves, "
                             f"{len(new_leaves)} were given")
        return build(spec, iter(new_leaves))

    return leaves, rebuild
