"""The one tree walker of the port: batches, trainer states and snapshots
are dicts, lists, tuples and named tuples around their leaves."""

from __future__ import annotations


def tree_map(fn, tree, *others):
    """``tree`` with every leaf replaced by ``fn(leaf, *other_leaves)``.
    ``others`` are walked alongside ``tree``: where one of them has
    another structure at a place (not a dict with that key, or not a
    sequence of the same length), ``fn`` gets None for it there."""
    if isinstance(tree, dict):
        subs = [o if isinstance(o, dict) else {} for o in others]
        return type(tree)(
            (k, tree_map(fn, v, *(o.get(k) for o in subs)))
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        n = len(tree)
        subs = [o if isinstance(o, (list, tuple)) and len(o) == n
                else [None] * n for o in others]
        items = [tree_map(fn, v, *(o[i] for o in subs))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *others)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out
