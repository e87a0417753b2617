"""Dispatch + container-level initialization of the W/H model families,
copied from salamander_tpu/initialization/initialize.py (host numpy code).

Mirrors the behavior of the reference's initialization/initialize.py:
  initialize_mat        :44-119  dispatch, given-signature overwrite, W column
                                 normalization (scale pushed into H), clip
  initialize_base       :158-218 signature AnnData ('Sig1..SigK' names; given
                                 signatures keep their annotations, names
                                 rolled so generated ones continue the count)
  initialize_standard_nmf :232-255
  given-parameter validators :122-155, 221-229

The CorrNMF and multimodal initializers are not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .. import containers
from ..utils import dict_checker, type_checker, value_checker
from .methods import (
    INIT_METHODS,
    init_custom,
    init_flat,
    init_nndsvd,
    init_random,
    init_separable_nmf,
)

EPSILON = float(np.finfo(np.float32).eps)

GIVEN_PARAMETERS_STANDARD_NMF = ["asignatures"]


def initialize_mat(
    data_mat: np.ndarray,
    n_signatures: int,
    method: str = "nndsvd",
    given_signatures_mat: np.ndarray | None = None,
    **kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Initialize (signatures_mat, exposures_mat) for a count matrix.

    data_mat: (n_samples, n_features). Returns signatures (n_signatures,
    n_features) with rows summing to one (scale pushed into the exposures),
    both clipped to EPSILON.
    """
    value_checker("method", method, INIT_METHODS)

    if method == "custom":
        signatures_mat, exposures_mat = init_custom(data_mat, n_signatures, **kwargs)
    elif method == "flat":
        signatures_mat, exposures_mat = init_flat(data_mat, n_signatures)
    elif method in ("nndsvd", "nndsvda", "nndsvdar"):
        signatures_mat, exposures_mat = init_nndsvd(
            data_mat, n_signatures, method=method, **kwargs
        )
    elif method == "random":
        signatures_mat, exposures_mat = init_random(data_mat, n_signatures, **kwargs)
    else:
        signatures_mat, exposures_mat = init_separable_nmf(
            data_mat, n_signatures, **kwargs
        )

    if given_signatures_mat is not None:
        type_checker("given_signatures_mat", given_signatures_mat, np.ndarray)
        n_given, n_given_features = given_signatures_mat.shape
        if n_given_features != data_mat.shape[1]:
            raise ValueError(
                "The given signature matrix has a different number of features "
                "than the data."
            )
        if n_given > n_signatures:
            raise ValueError(
                "The given signature matrix contains too many signatures."
            )
        signatures_mat[:n_given, :] = given_signatures_mat.copy()

    # Degenerate components (all-zero signature from e.g. NNDSVD on
    # low-rank data) would turn into NaN under the reference's raw
    # normalization; keep them finite (clip floors them to EPSILON) so the
    # multiplicative updates can recover instead of silently fitting NaN.
    scale = signatures_mat.T.sum(axis=0)
    safe_scale = np.where(scale == 0.0, 1.0, scale)
    W = signatures_mat.T / safe_scale
    H = exposures_mat.T * safe_scale[:, None]
    return W.T.clip(EPSILON), H.T.clip(EPSILON)


def check_given_asignatures(given_asignatures, adata, n_signatures: int) -> None:
    """Given signatures must share the data's features and not exceed
    the requested signature count."""
    if not hasattr(given_asignatures, "var_names"):
        raise TypeError("'given_asignatures' has to be an AnnData object.")
    if given_asignatures.n_vars != adata.n_vars:
        raise ValueError(
            "The given signatures have a different number of features than the data."
        )
    if not all(
        str(a) == str(b)
        for a, b in zip(given_asignatures.var_names, adata.var_names)
    ):
        raise ValueError(
            "The features of the given signatures and the data are not identical."
        )
    if given_asignatures.n_obs > n_signatures:
        raise ValueError(
            "The number of given signatures exceeds "
            "the number of signatures to initialize."
        )


def initialize_base(
    adata,
    n_signatures: int,
    method: str = "nndsvd",
    given_asignatures=None,
    **kwargs,
):
    """Initialize the signatures AnnData and the exposure matrix.

    Given signatures keep their own annotations; the generated ones are named
    SigK.. continuing past them (names rolled as in the reference).
    """
    given_signatures_mat = None
    if given_asignatures is not None:
        check_given_asignatures(given_asignatures, adata, n_signatures)
        given_signatures_mat = np.asarray(given_asignatures.X)

    signatures_mat, exposures_mat = initialize_mat(
        np.asarray(adata.X), n_signatures, method, given_signatures_mat, **kwargs
    )
    asignatures = containers.AnnData(signatures_mat)
    asignatures.var_names = adata.var_names
    asignatures.obs_names = [f"Sig{k + 1}" for k in range(n_signatures)]

    if given_asignatures is not None:
        n_given = given_asignatures.n_obs
        rolled = np.roll(np.asarray(asignatures.obs_names, dtype=object), n_given)
        asignatures.obs_names = rolled
        asignatures = containers.concat(
            [given_asignatures, asignatures[n_given:, :]], join="outer"
        )
    return asignatures, exposures_mat


def check_given_parameters_standard_nmf(
    adata, n_signatures: int, given_parameters: dict[str, Any]
) -> None:
    dict_checker("given_parameters", given_parameters, GIVEN_PARAMETERS_STANDARD_NMF)
    if "asignatures" in given_parameters:
        check_given_asignatures(given_parameters["asignatures"], adata, n_signatures)


def initialize_standard_nmf(
    adata,
    n_signatures: int,
    method: str = "nndsvd",
    given_parameters: dict[str, Any] | None = None,
    **kwargs,
):
    """Initialize signatures + exposures for KLNMF/MvNMF-style models and
    store the exposures into adata.obsm."""
    given_parameters = {} if given_parameters is None else given_parameters.copy()
    check_given_parameters_standard_nmf(adata, n_signatures, given_parameters)
    asignatures, exposures_mat = initialize_base(
        adata,
        n_signatures,
        method,
        given_parameters.get("asignatures"),
        **kwargs,
    )
    adata.obsm["exposures"] = exposures_mat
    return asignatures

