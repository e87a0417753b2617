"""Carry parameters between the JAX package and the port.

The JAX package hands fitted parameters out as numpy arrays (its
engine/transfer.py fetches whole pytrees to the host); the port keeps them
as dicts of tensors. params_from_numpy and params_to_numpy convert a params dict such as
{"W": (V, K), "H": (K, D)} - or its batched form with a leading restart
axis, or the nested tree of MultimodalCorrNMF ({"mods": {name: {...}},
"sample_embeddings", "variance"}) - in either direction, so a fit started
in one package can continue in the other. svi_state_from_numpy and
svi_state_to_numpy do the same for the state of a minibatch fit
(ops/svi.py): parameters, running statistics, step and sampler position.
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


def svi_state_from_numpy(state, device=None, dtype=None):
    """A minibatch-fit state of the JAX package (its SVIState, KLSVIState or
    MMSVIState, or a dict of the same fields, with numpy leaves) -> the
    port's state of the same family: parameters, running statistics and
    stat_usq as tensors on `device` (floating leaves cast to `dtype` when
    given), step and cursor as host integers, perm as an int64 tensor. Both
    packages can then continue from the same mid-run state."""
    from ..ops import svi

    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    if "stats" in fields:
        kind = svi.MMSVIState
    elif "stat_observed" in fields:
        kind = svi.SVIState
    else:
        kind = svi.KLSVIState
    out = {}
    for name in kind._fields:
        value = fields[name]
        if name in ("step", "cursor"):
            out[name] = int(value)
        elif name == "perm":
            out[name] = torch.as_tensor(
                np.array(value, dtype=np.int64), device=device)
        elif isinstance(value, dict):
            out[name] = params_from_numpy(value, device, dtype)
        else:
            out[name] = params_from_numpy({"leaf": value}, device,
                                          dtype)["leaf"]
    return kind(**out)


def svi_state_to_numpy(state):
    """The port's minibatch-fit state -> the same NamedTuple with host
    numpy leaves (step and cursor as int32 scalars, perm as int32), the
    field layout of the JAX package's state of the same family."""
    out = {}
    for name, value in state._asdict().items():
        if name in ("step", "cursor"):
            out[name] = np.asarray(value, dtype=np.int32)
        elif name == "perm":
            out[name] = value.detach().cpu().numpy().astype(np.int32)
        elif isinstance(value, dict):
            out[name] = params_to_numpy(value)
        else:
            out[name] = value.detach().cpu().numpy()
    return type(state)(**out)
