"""Nested dicts, lists and tuples of tensors: the port's parameter and
optimizer-state trees (the JAX package's pytrees).

Leaves are visited in JAX's order (dict keys sorted, sequences by index),
and a leaf's path joins its dict keys and sequence indices with ``/``, as
the checkpoints of both packages key their arrays.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of ``tree`` in JAX's leaf order."""
    out: list[tuple[tuple, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def path_key(path: tuple) -> str:
    """A leaf's checkpoint key: its dict keys and indices joined by
    ``/``."""
    return "/".join(str(p) for p in path)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` (in
    :func:`flatten`'s order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its
    structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])


def describe(tree) -> str:
    """The structure of ``tree`` as text: dicts with their keys, lists and
    tuples with their lengths, ``*`` for a leaf (a checkpoint manifest's
    ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(child) for child in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    return "*"
