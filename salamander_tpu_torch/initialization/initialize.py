"""Dispatch + container-level initialization of the W/H model families,
copied from salamander_tpu/initialization/initialize.py (host numpy code).

Mirrors the behavior of the reference's initialization/initialize.py:
  initialize_mat        :44-119  dispatch, given-signature overwrite, W column
                                 normalization (scale pushed into H), clip
  initialize_base       :158-218 signature AnnData ('Sig1..SigK' names; given
                                 signatures keep their annotations, names
                                 rolled so generated ones continue the count)
  initialize_standard_nmf :232-255
  initialize_corrnmf    :319-384 adds zero scalings, Gaussian embeddings
                                 (global numpy RNG - seeded implicitly when
                                 the signature init method took a seed) and
                                 variance 1.0; rejects method='custom'
  initialize_mmcorrnmf  :419-465 per-modality CorrNMF inits (modality by
                                 modality, in order), then ONE draw of the
                                 shared sample embeddings from the global
                                 numpy RNG; generated names get the
                                 '{modality} ' prefix
  given-parameter validators :122-155, 221-229, 258-316, 387-416
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .. import containers
from ..utils import dict_checker, shape_checker, type_checker, value_checker
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
GIVEN_PARAMETERS_CORRNMF = [
    "asignatures",
    "signature_scalings",
    "sample_scalings",
    "signature_embeddings",
    "sample_embeddings",
    "variance",
]


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


def _check_given_array(value, expected_shape: tuple[int, ...], name: str) -> None:
    type_checker(name, value, np.ndarray)
    shape_checker(name, value, expected_shape)


# backwards-compatible named validators
def check_given_scalings_corrnmf(given_scalings, n_expected: int, name: str) -> None:
    _check_given_array(given_scalings, (n_expected,), name)


def check_given_embeddings_corrnmf(
    given_embeddings, n_expected: int, dim_expected: int, name: str
) -> None:
    _check_given_array(given_embeddings, (n_expected, dim_expected), name)


def check_given_parameters_corrnmf(
    adata, n_signatures: int, dim_embeddings: int, given_parameters: dict[str, Any]
) -> None:
    """Validate the CorrNMF given-parameter dict (declarative shape table)."""
    dict_checker("given_parameters", given_parameters, GIVEN_PARAMETERS_CORRNMF)

    expected_shapes = {
        "signature_scalings": (n_signatures,),
        "sample_scalings": (adata.n_obs,),
        "signature_embeddings": (n_signatures, dim_embeddings),
        "sample_embeddings": (adata.n_obs, dim_embeddings),
    }
    for key, shape in expected_shapes.items():
        if key in given_parameters:
            _check_given_array(given_parameters[key], shape, f"given_{key}")

    if "asignatures" in given_parameters:
        check_given_asignatures(given_parameters["asignatures"], adata, n_signatures)
    if "variance" in given_parameters:
        variance = given_parameters["variance"]
        type_checker("given_variance", variance, [float, int])
        if variance <= 0.0:
            raise ValueError("The variance has to be a positive real number.")


def initialize_corrnmf(
    adata,
    n_signatures: int,
    dim_embeddings: int,
    method: str = "nndsvd",
    given_parameters: dict[str, Any] | None = None,
    initialize_sample_embeddings: bool = True,
    **kwargs,
):
    """Initialize signatures, scalings, embeddings and variance for CorrNMF.

    Embeddings are standard-normal draws from the global numpy RNG (seeded by
    the signature init when a 'seed' kwarg was passed, matching the
    reference's implicit-seeding behavior).
    """
    if method == "custom":
        raise ValueError(
            "Custom parameter initializations are currently not supported "
            "for (multimodal) correlated NMF."
        )
    given_parameters = {} if given_parameters is None else given_parameters.copy()
    check_given_parameters_corrnmf(adata, n_signatures, dim_embeddings,
                                   given_parameters)

    asignatures, _ = initialize_base(
        adata,
        n_signatures,
        method,
        given_parameters.get("asignatures"),
        **kwargs,
    )

    def given_or(key: str, default_factory):
        return (
            given_parameters[key]
            if key in given_parameters
            else default_factory()
        )

    def gaussian_embeddings(count: int):
        # standard-normal draws from the global numpy RNG (implicitly seeded
        # by a stochastic signature init's 'seed' kwarg)
        return np.random.multivariate_normal(
            np.zeros(dim_embeddings), np.identity(dim_embeddings), size=count
        )

    asignatures.obs["scalings"] = given_or(
        "signature_scalings", lambda: np.zeros(n_signatures)
    )
    adata.obs["scalings"] = given_or(
        "sample_scalings", lambda: np.zeros(adata.n_obs)
    )
    asignatures.obsm["embeddings"] = given_or(
        "signature_embeddings", lambda: gaussian_embeddings(n_signatures)
    )
    if initialize_sample_embeddings:
        adata.obsm["embeddings"] = given_or(
            "sample_embeddings", lambda: gaussian_embeddings(adata.n_obs)
        )

    variance = float(given_parameters.get("variance", 1.0))
    return asignatures, variance


def check_given_parameters_mmcorrnmf(
    mdata, ns_signatures: list[int], dim_embeddings: int,
    given_parameters: dict[str, Any],
) -> None:
    valid_keys = list(mdata.mod.keys()) + ["sample_embeddings", "variance"]
    dict_checker("given_parameters", given_parameters, valid_keys)

    for (mod_name, adata), n_signatures in zip(mdata.mod.items(), ns_signatures):
        given_mod = given_parameters.get(mod_name, {})
        check_given_parameters_corrnmf(adata, n_signatures, dim_embeddings, given_mod)
        if "sample_embeddings" in given_mod:
            raise KeyError(
                "The sample embeddings are shared across modalities in multimodal "
                "correlated NMF. They cannot be provided as given parameters on the "
                "modality level."
            )
        if "variance" in given_mod:
            raise KeyError(
                "The variance parameter of multimodal correlated NMF is shared "
                "across modalities. It cannot be provided as a given parameter on "
                "the modality level."
            )


def initialize_mmcorrnmf(
    mdata,
    ns_signatures: list[int],
    dim_embeddings: int,
    method: str = "nndsvd",
    given_parameters: dict[str, Any] | None = None,
    **kwargs,
):
    """Per-modality CorrNMF initialization with shared sample embeddings.

    Generated signature names get a '{modality} ' prefix; given signatures
    keep their names unchanged.
    """
    given_parameters = {} if given_parameters is None else given_parameters.copy()
    check_given_parameters_mmcorrnmf(
        mdata, ns_signatures, dim_embeddings, given_parameters
    )
    asignatures = {}

    for (mod_name, adata), n_signatures in zip(mdata.mod.items(), ns_signatures):
        given_mod = given_parameters.get(mod_name, {})
        asigs, _ = initialize_corrnmf(
            adata,
            n_signatures,
            dim_embeddings,
            method,
            given_mod,
            initialize_sample_embeddings=False,
            **kwargs,
        )
        n_given = given_mod["asignatures"].n_obs if "asignatures" in given_mod else 0
        names = list(asigs.obs_names)
        asigs.obs_names = names[:n_given] + [
            f"{mod_name} {name}" for name in names[n_given:]
        ]
        asignatures[mod_name] = asigs

    if "sample_embeddings" in given_parameters:
        mdata.obsm["embeddings"] = given_parameters["sample_embeddings"]
    else:
        mdata.obsm["embeddings"] = np.random.multivariate_normal(
            np.zeros(dim_embeddings), np.identity(dim_embeddings), size=mdata.n_obs
        )

    variance = float(given_parameters.get("variance", 1.0))
    return asignatures, variance
