"""Parameter and state trees: nested dicts and lists of tensors.

The port's counterpart of the ``jax.tree`` calls the reference's training
half makes.  Leaves come out in ``jax.tree.flatten``'s order (dict keys
sorted, lists in order), so a flat index means the same leaf in both
packages: the optimizer sums the global norm in that order, and a
checkpoint's ``leaf_<i>`` names the same tensor whichever package wrote it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "leaves", "tree_map", "describe"]


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: the leaves in sorted-key order and the tree's
    structure with ``None`` where each leaf was."""
    out: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        out.append(t)
        return None

    return out, walk(tree)


def unflatten(treedef: Any, flat: List[Any]) -> Any:
    """The tree ``treedef`` describes, with ``flat``'s leaves in order."""
    it = iter(flat)

    def build(d):
        if isinstance(d, dict):
            return {k: build(d[k]) for k in sorted(d)}
        if isinstance(d, (list, tuple)):
            return type(d)(build(v) for v in d)
        return next(it)

    tree = build(treedef)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree has places")
    return tree


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must have its structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def describe(treedef: Any) -> str:
    """A one-line description of a structure, for checkpoint manifests."""
    if isinstance(treedef, dict):
        return "{" + ", ".join(f"'{k}': {describe(treedef[k])}"
                               for k in sorted(treedef)) + "}"
    if isinstance(treedef, (list, tuple)):
        inner = ", ".join(describe(v) for v in treedef)
        return f"[{inner}]" if isinstance(treedef, list) else f"({inner})"
    return "*"
