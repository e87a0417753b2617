"""Carry parameters between the JAX package and the port.

The JAX package hands fitted parameters out as numpy arrays (its
engine/transfer.py fetches whole pytrees to the host); the port keeps them
as dicts of tensors. These two functions convert a params dict such as
{"W": (V, K), "H": (K, D)} - or its batched form with a leading restart
axis, or the nested tree of MultimodalCorrNMF ({"mods": {name: {...}},
"sample_embeddings", "variance"}) - in either direction, so a fit started
in one package can continue in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .tree import tree_map


def params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy (or array-like) params -> tensors on `device` (copies);
    floating leaves are cast to `dtype` when it is given."""
    def to_tensor(leaf):
        tensor = torch.as_tensor(np.array(leaf), device=device)
        if dtype is not None and tensor.dtype.is_floating_point:
            tensor = tensor.to(dtype)
        return tensor

    return tree_map(to_tensor, tree)


def params_to_numpy(tree: dict) -> dict:
    """Tensors (on any device) -> host numpy arrays."""
    return tree_map(lambda leaf: leaf.detach().cpu().numpy(), tree)
