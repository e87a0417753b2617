"""Abstract correlated NMF: exposures refactored into scalings and
embeddings, held against salamander_tpu/models/corrnmf.py.

dim_embeddings (defaults to n_signatures), scalar variance, exposures
computed from scalings and embeddings, the ELBO objective (maximized),
scaled (cosine-of-embedding) correlations, transform() onto the frozen
signature side and the joint signature/sample embedding plot.
"""

from __future__ import annotations

import warnings
from typing import Iterable, Literal

import numpy as np
import torch

from .. import tools as tl
from ..initialization.initialize import initialize_corrnmf
from ..ops import corrnmf as ops
from ..ops import klnmf as klnmf_ops
from ..utils import compute_exposures_numpy, value_checker
from .signature_nmf import SignatureNMF


def _host(array) -> torch.Tensor:
    return torch.as_tensor(np.array(array, dtype=float))


class CorrNMF(SignatureNMF):
    """NMF with signature/sample scalings and embeddings in a shared
    low-dimensional Gaussian latent space."""

    # constructor arguments a transform() projector copies
    _hyperparameter_keys = (
        "n_signatures", "init_method", "dim_embeddings", "min_iterations",
        "max_iterations", "conv_test_freq", "tol", "dtype",
        "newton_cg_compat", "device",
    )

    def __init__(
        self,
        n_signatures: int = 1,
        init_method: str = "nndsvd",
        dim_embeddings: int | None = None,
        min_iterations: int = 500,
        max_iterations: int = 10000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
        newton_cg_compat: bool = False,
        device=None,
    ):
        super().__init__(
            n_signatures, init_method, min_iterations, max_iterations,
            conv_test_freq, tol, dtype=dtype, device=device,
        )
        self.dim_embeddings = (
            n_signatures if dim_embeddings is None else dim_embeddings
        )
        self.variance = 1.0
        # opt-in auditing mode: the embedding M-steps run the reference's
        # exact scipy Newton-CG on the host and the fit loop runs host-side
        self.newton_cg_compat = newton_cg_compat

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "maximize"

    def compute_exposures(self) -> None:
        """Refresh adata.obsm['exposures'] from scalings and embeddings
        (host numpy: every input is a host array here)."""
        self.adata.obsm["exposures"] = compute_exposures_numpy(
            self.asignatures.obs["scalings"],
            self.adata.obs["scalings"],
            self.asignatures.obsm["embeddings"],
            self.adata.obsm["embeddings"],
        )

    def compute_reconstruction_errors(self) -> None:
        self.compute_exposures()
        errors = klnmf_ops.samplewise_kl_divergence(
            _host(self.adata.X.T), _host(self.asignatures.X.T),
            _host(self.adata.obsm["exposures"].T),
        )
        self.adata.obs["reconstruction_error"] = errors.numpy()

    def objective_function(self,
                           penalize_sample_embeddings: bool = True) -> float:
        return float(
            ops.elbo_corrnmf(
                _host(self.adata.X),
                _host(self.asignatures.X),
                _host(self.adata.obsm["exposures"]),
                _host(self.asignatures.obsm["embeddings"]),
                _host(self.adata.obsm["embeddings"]),
                float(self.variance),
                penalize_sample_embeddings=penalize_sample_embeddings,
            )
        )

    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        init_kwargs = {} if init_kwargs is None else init_kwargs.copy()
        self.asignatures, self.variance = initialize_corrnmf(
            self.adata,
            self.n_signatures,
            self.dim_embeddings,
            self.init_method,
            given_parameters,
            **init_kwargs,
        )
        self.compute_exposures()

    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        return

    def _check_warm_start(self, given_parameters) -> None:
        super()._check_warm_start(given_parameters)
        try:
            np.asarray(self.adata.obs["scalings"])
            np.asarray(self.adata.obsm["embeddings"])
            np.asarray(self.asignatures.obs["scalings"])
            np.asarray(self.asignatures.obsm["embeddings"])
            float(self.variance)
        except (AttributeError, KeyError, TypeError):
            raise ValueError(
                "warm_start=True for a CorrNMF model needs the previous "
                "fit's scalings/embeddings/variance in the containers; "
                "fit once without warm_start first."
            ) from None

    def transform(self, adata, **fit_kwargs):
        """Infer scalings and embeddings for NEW samples under this model's
        frozen signature-side parameters (signatures, signature scalings,
        signature embeddings, variance). Returns the fitted projector model;
        neither `self` nor the input container is modified."""
        if not getattr(self, "_is_fitted", False):
            raise ValueError("transform() requires a fitted model.")
        if "given_parameters" in fit_kwargs:
            raise ValueError(
                "transform() freezes this model's signature-side parameters "
                "itself; 'given_parameters' cannot be overridden here - use "
                "fit() directly for custom given parameters."
            )
        projector = type(self)(
            **{key: getattr(self, key) for key in self._hyperparameter_keys}
        )
        given = {
            "asignatures": self.asignatures.copy(),
            "signature_scalings": np.asarray(
                self.asignatures.obs["scalings"], dtype=float
            ),
            "signature_embeddings": np.asarray(
                self.asignatures.obsm["embeddings"]
            ),
            "variance": float(self.variance),
        }
        projector.fit(
            adata.copy() if hasattr(adata, "copy") else adata,
            given_parameters=given,
            **fit_kwargs,
        )
        return projector

    def compute_correlation_scaled(
        self, data: Literal["samples", "signatures"] = "signatures"
    ) -> None:
        """Cosine similarity of the sample or signature embeddings."""
        value_checker("data", data, ["samples", "signatures"])
        if "embeddings" not in self.adata.obsm:
            raise ValueError(
                "Computing the sample or signature correlation "
                "requires fitting the CorrNMF model."
            )
        if data == "samples":
            vectors = self.adata.obsm["embeddings"]
        else:
            vectors = self.asignatures.obsm["embeddings"]
        norms = np.sqrt(np.sum(vectors**2, axis=1))
        corr = (vectors @ vectors.T) / np.outer(norms, norms)
        np.fill_diagonal(corr, 1.0)
        if data == "samples":
            self.adata.obsp["X_correlation"] = corr
        else:
            self.asignatures.obsp["correlation"] = corr

    def _default_embedding_styling(self, color, zorder):
        """Fill in the joint-plot styling columns when the caller gave none:
        signatures draw black on top (zorder 2), samples matplotlib-blue
        underneath. Column names are stable ('color_embeddings' /
        'zorder_embeddings') so io round-trips preserve them."""
        per_container = {
            "color": ("color_embeddings", "black", "#1f77b4"),
            "zorder": ("zorder_embeddings", 2, 1),
        }
        resolved = []
        for key, given in (("color", color), ("zorder", zorder)):
            if given is not None:
                resolved.append(given)
                continue
            name, sig_value, sample_value = per_container[key]
            self.asignatures.obs[name] = [sig_value] * self.n_signatures
            self.adata.obs[name] = [sample_value] * self.adata.n_obs
            resolved.append(name)
        return tuple(resolved)

    def plot_embeddings(
        self,
        method: str = "umap",
        n_components: int = 2,
        dimensions: tuple[int, int] = (0, 1),
        color: str | None = None,
        zorder: str | None = None,
        annotations: Iterable[str] | None = None,
        outfile: str | None = None,
        **kwargs,
    ):
        """Scatter signature and sample embeddings in one shared plane.

        Both containers are reduced jointly (they live in the same latent
        space), then drawn by pl.embedding_multiple with signatures
        annotated by name. When dim_embeddings is already <= 2 there is
        nothing to reduce; the raw embedding coordinates are plotted and a
        UserWarning says so.
        """
        from .. import plot as pl
        import matplotlib.pyplot as plt

        pair = [self.asignatures, self.adata]
        tl.reduce_dimension_multiple(
            adatas=pair, basis="embeddings", method=method,
            n_components=n_components, **kwargs,
        )
        reduction_is_trivial = self.dim_embeddings <= 2
        if reduction_is_trivial:
            warnings.warn(
                f"The embedding dimension is {self.dim_embeddings}. "
                "The embeddings are plotted without an additional "
                "dimensionality reduction.",
                UserWarning,
            )
        basis = "embeddings" if reduction_is_trivial else method
        color, zorder = self._default_embedding_styling(color, zorder)
        ax = pl.embedding_multiple(
            adatas=pair,
            basis=basis,
            dimensions=dimensions,
            color=color,
            zorder=zorder,
            annotations=(
                self.signature_names if annotations is None else annotations
            ),
            **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax
