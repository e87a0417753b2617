"""Nested dicts of tensors ("trees"), the port's stand-in for the pytrees
the JAX package hands to ``jax.tree``.

Most families carry a flat dict of tensors; MultimodalCorrNMF nests one
dict per modality (modalities are ragged in their feature and signature
counts, so they cannot be stacked). The engine and the parallel fits walk
their parameter and data dicts through these helpers only, so both shapes
take the same path. A tree is a dict whose values are leaves or trees; order is
insertion order. A flat dict is its own flattening: its paths are its keys.
"""

from __future__ import annotations

from typing import Any, Callable

SEPARATOR = "/"


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """Apply fn to every leaf of `tree` (and the matching leaves of the
    trees in `rest`, which must have the same structure)."""
    out = {}
    for key, value in tree.items():
        others = [other[key] for other in rest]
        if isinstance(value, dict):
            out[key] = tree_map(fn, value, *others)
        else:
            out[key] = fn(value, *others)
    return out


def tree_leaves(tree: dict) -> list:
    """Every leaf, depth first in insertion order."""
    leaves = []
    for value in tree.values():
        if isinstance(value, dict):
            leaves.extend(tree_leaves(value))
        else:
            leaves.append(value)
    return leaves


def tree_flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """{path: leaf} with the nested keys joined by "/" (the entry names of
    the .npz stores). A flat dict comes back unchanged."""
    flat = {}
    for key, value in tree.items():
        if SEPARATOR in str(key):
            raise ValueError(
                f"tree keys must not contain {SEPARATOR!r}: got {key!r}")
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(tree_flatten(value, f"{path}{SEPARATOR}"))
        else:
            flat[path] = value
    return flat


def tree_unflatten(flat: dict[str, Any]) -> dict:
    """The inverse of tree_flatten."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split(SEPARATOR)
        node = tree
        for parent in parents:
            node = node.setdefault(parent, {})
        node[name] = leaf
    return tree
