"""Model checkpointing, held against salamander_tpu/io.py: save and load a
fitted model of any family, or a de novo extraction, as one .npz archive.

The archive format is the JAX package's, shared by both packages (format
version 1): one JSON "meta" entry (the class, the constructor
hyperparameters of ``_HYPERPARAM_KEYS``, the scalar state of
``_EXTRA_STATE``, the history keys), the history, KLNMF's loss weights,
and the count and signature containers as flat arrays. So a model or an
extraction saved by either package loads in the other. Everything in the
archive is host data: the device a model runs on is not part of it, and
``load_model``/``load_extraction`` take ``device=`` (None: the card) and
hand it to the model's constructor. bootstrap_stability and the
transform() paths clone a fitted model from ``_HYPERPARAM_KEYS`` the same
way, passing ``device=`` beside them.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from . import containers

_HYPERPARAM_KEYS = {
    "KLNMF": ["n_signatures", "init_method", "min_iterations", "max_iterations",
              "conv_test_freq", "tol", "dtype"],
    "ARDNMF": ["n_signatures", "prior", "a", "b", "init_method",
               "min_iterations", "max_iterations", "conv_test_freq", "tol",
               "dtype"],
    "MvNMF": ["n_signatures", "init_method", "lam", "delta", "min_iterations",
              "max_iterations", "conv_test_freq", "tol", "dtype"],
    "CorrNMFDet": ["n_signatures", "init_method", "dim_embeddings",
                   "min_iterations", "max_iterations", "conv_test_freq", "tol",
                   "dtype", "newton_cg_compat"],
    "MultimodalCorrNMF": ["ns_signatures", "dim_embeddings", "init_method",
                          "min_iterations", "max_iterations", "conv_test_freq",
                          "tol", "dtype", "newton_cg_compat"],
}

_EXTRA_STATE = {
    "KLNMF": [],
    "ARDNMF": ["b_resolved_"],
    "MvNMF": ["_gamma"],
    "CorrNMFDet": ["variance"],
    "MultimodalCorrNMF": ["variance"],
}


def _pack_adata(payload: dict, prefix: str, adata) -> None:
    payload[f"{prefix}/X"] = np.asarray(adata.X)
    payload[f"{prefix}/obs_names"] = np.asarray(adata.obs_names).astype(str)
    payload[f"{prefix}/var_names"] = np.asarray(adata.var_names).astype(str)
    for col in adata.obs.columns:
        values = np.asarray(adata.obs[col])
        if values.dtype == object:
            values = values.astype(str)
        payload[f"{prefix}/obs:{col}"] = values
    for key, value in adata.obsm.items():
        payload[f"{prefix}/obsm:{key}"] = value
    for key, value in adata.obsp.items():
        payload[f"{prefix}/obsp:{key}"] = value


def _unpack_adata(archive, prefix: str):
    adata = containers.AnnData(archive[f"{prefix}/X"])
    adata.obs_names = archive[f"{prefix}/obs_names"]
    adata.var_names = archive[f"{prefix}/var_names"]
    lead = f"{prefix}/"
    for key in archive.files:
        if not key.startswith(lead):
            continue
        rest = key[len(lead):]
        if rest.startswith("obs:"):
            adata.obs[rest[4:]] = archive[key]
        elif rest.startswith("obsm:"):
            adata.obsm[rest[5:]] = archive[key]
        elif rest.startswith("obsp:"):
            adata.obsp[rest[5:]] = archive[key]
    return adata


def save_model(model, path: str) -> None:
    """Serialize a (fitted) model of any family to a .npz checkpoint."""
    np.savez_compressed(path, **_model_payload(model))


def _model_payload(model) -> dict[str, np.ndarray]:
    """Flat key->array payload for one model (the save_model body; also
    embedded under a prefix by save_extraction)."""
    class_name = type(model).__name__
    if class_name not in _HYPERPARAM_KEYS:
        raise TypeError(f"Cannot checkpoint models of type {class_name}.")

    meta: dict[str, Any] = {
        "class": class_name,
        "format_version": 1,
        "hyperparameters": {
            key: getattr(model, key) for key in _HYPERPARAM_KEYS[class_name]
        },
        "extra_state": {
            key: float(getattr(model, key)) for key in _EXTRA_STATE[class_name]
        },
        "history_keys": sorted(model.history),
    }
    payload: dict[str, np.ndarray] = {
        "meta": np.asarray(json.dumps(meta)),
    }
    for key, values in model.history.items():
        payload[f"history/{key}"] = np.asarray(values)

    # KLNMF's fitted per-sample loss weights are model state too
    for weights_attr in ("weights_kl", "weights_lhalf"):
        weights = getattr(model, weights_attr, None)
        if weights is not None:
            payload[f"weights/{weights_attr}"] = np.asarray(weights)

    if class_name == "MultimodalCorrNMF":
        meta["mod_names"] = model.mod_names
        payload["meta"] = np.asarray(json.dumps(meta))
        for name in model.mod_names:
            _pack_adata(payload, f"mod/{name}", model.mdata[name])
            _pack_adata(payload, f"sigs/{name}", model.asignatures[name])
        payload["mdata/obs_names"] = np.asarray(model.mdata.obs_names).astype(str)
        for key, value in model.mdata.obsm.items():
            payload[f"mdata/obsm:{key}"] = value
    else:
        _pack_adata(payload, "adata", model.adata)
        _pack_adata(payload, "sigs", model.asignatures)

    return payload


class _PrefixedArchive:
    """View of an npz archive restricted to keys under `prefix` (duck-types
    the two members _model_from_archive reads: .files and __getitem__)."""

    def __init__(self, archive, prefix: str):
        self._archive = archive
        self._prefix = prefix
        self.files = [
            key[len(prefix):] for key in archive.files
            if key.startswith(prefix)
        ]

    def __getitem__(self, key):
        return self._archive[self._prefix + key]


def load_model(path: str, device=None):
    """Restore a model checkpoint written by save_model (by either
    package) onto `device` (None: the card)."""
    with np.load(path, allow_pickle=False) as archive:
        return _model_from_archive(archive, device)


def _model_from_archive(archive, device=None):
    from . import models

    meta = json.loads(str(archive["meta"]))
    model_cls = getattr(models, meta["class"])
    model = model_cls(**meta["hyperparameters"], device=device)
    for key, value in meta["extra_state"].items():
        setattr(model, key, value)
    for key in meta["history_keys"]:
        values = archive[f"history/{key}"]
        model.history[key] = (
            values.tolist() if values.ndim else values.item()
        )
    for key in archive.files:
        if key.startswith("weights/"):
            setattr(model, key[len("weights/"):], archive[key])

    if meta["class"] == "MultimodalCorrNMF":
        mods, sigs = {}, {}
        for name in meta["mod_names"]:
            mods[name] = _unpack_adata(archive, f"mod/{name}")
            sigs[name] = _unpack_adata(archive, f"sigs/{name}")
        model.mdata = containers.MuData(mods)
        model.mdata.obs_names = archive["mdata/obs_names"]
        for key in archive.files:
            if key.startswith("mdata/obsm:"):
                model.mdata.obsm[key[len("mdata/obsm:"):]] = archive[key]
        model.asignatures = sigs
    else:
        model.adata = _unpack_adata(archive, "adata")
        model.asignatures = _unpack_adata(archive, "sigs")
    model._is_fitted = True
    return model


def save_extraction(result, path: str) -> None:
    """Serialize an ExtractionResult (extraction.extract_signatures) to one
    .npz archive: the rank-selection table, every rank's consensus
    signatures / refit exposures / silhouettes / cluster-aligned replicate
    stacks / per-lane losses and iteration counts, the suggested rank, and
    (when fitted) the final model embedded under its own prefix. Discovery
    runs cost minutes of device time; the result persists so analysis and
    plotting never need a refit."""
    meta = {
        "format_version": 1,
        "kind": "extraction",
        "ranks": [int(k) for k in result.table.index],
        "table_columns": list(result.table.columns),
        "suggested_rank": result.suggested_rank,
        "has_model": result.model is not None,
        "var_names_name": result.consensus[
            int(result.table.index[0])
        ].columns.name,
        "obs_names_name": result.exposures[
            int(result.table.index[0])
        ].index.name,
        # the discovery fit's layout; an archive of the JAX package has
        # none, and its loader ignores the key
        "layout": result.layout,
    }
    payload: dict[str, np.ndarray] = {
        "meta": np.asarray(json.dumps(meta)),
        "table/values": result.table.to_numpy(),
    }
    for rank in meta["ranks"]:
        consensus = result.consensus[rank]
        exposures = result.exposures[rank]
        payload[f"consensus/{rank}"] = consensus.to_numpy()
        payload[f"exposures/{rank}"] = exposures.to_numpy()
        payload[f"silhouettes/{rank}"] = result.silhouettes[rank]
        payload[f"matched/{rank}"] = result.matched[rank]
        payload[f"losses/{rank}"] = result.replicate_losses[rank]
        payload[f"iterations/{rank}"] = result.replicate_iterations[rank]
        payload[f"names/{rank}"] = np.asarray(consensus.index).astype(str)
    first = meta["ranks"][0]
    payload["var_names"] = np.asarray(
        result.consensus[first].columns
    ).astype(str)
    payload["obs_names"] = np.asarray(
        result.exposures[first].index
    ).astype(str)
    if result.model is not None:
        for key, value in _model_payload(result.model).items():
            payload[f"model/{key}"] = value
    np.savez_compressed(path, **payload)


def load_extraction(path: str, device=None):
    """Restore an ExtractionResult written by save_extraction (by either
    package); its fitted model, if any, onto `device` (None: the card)."""
    import pandas as pd

    from .extraction import ExtractionResult

    with np.load(path, allow_pickle=False) as archive:
        meta = json.loads(str(archive["meta"]))
        if meta.get("kind") != "extraction":
            raise ValueError(f"{path} is not a save_extraction archive")
        ranks = meta["ranks"]
        var_names = pd.Index(
            archive["var_names"], name=meta.get("var_names_name")
        )
        obs_names = pd.Index(
            archive["obs_names"], name=meta.get("obs_names_name")
        )
        table = pd.DataFrame(
            archive["table/values"],
            index=pd.Index(ranks, name="n_signatures"),
            columns=meta["table_columns"],
        )
        consensus, exposures = {}, {}
        silhouettes, matched, losses, iterations = {}, {}, {}, {}
        for rank in ranks:
            names = archive[f"names/{rank}"]
            consensus[rank] = pd.DataFrame(
                archive[f"consensus/{rank}"], index=names, columns=var_names
            )
            exposures[rank] = pd.DataFrame(
                archive[f"exposures/{rank}"], index=obs_names, columns=names
            )
            silhouettes[rank] = archive[f"silhouettes/{rank}"]
            matched[rank] = archive[f"matched/{rank}"]
            losses[rank] = archive[f"losses/{rank}"]
            iterations[rank] = archive[f"iterations/{rank}"]
        model = (
            _model_from_archive(_PrefixedArchive(archive, "model/"), device)
            if meta["has_model"] else None
        )
    return ExtractionResult(
        table=table,
        consensus=consensus,
        exposures=exposures,
        silhouettes=silhouettes,
        matched=matched,
        replicate_losses=losses,
        replicate_iterations=iterations,
        suggested_rank=meta["suggested_rank"],
        model=model,
        layout=meta.get("layout", "padded"),
    )
