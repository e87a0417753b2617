"""Shared structure of W/H-parameterized models, held against
salamander_tpu/models/standard_nmf.py: common initialization through
initialize_standard_nmf, exposures as the lower-dimensional
representation, transform() onto frozen signatures, and the exposure-based
embedding plot.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from .. import tools as tl
from ..initialization.initialize import initialize_standard_nmf
from .signature_nmf import SignatureNMF


class StandardNMF(SignatureNMF):
    """NMF models parameterized directly by a signature and exposure matrix."""

    # constructor arguments a transform() projector copies
    _hyperparameter_keys = (
        "n_signatures", "init_method", "min_iterations", "max_iterations",
        "conv_test_freq", "tol", "dtype", "device",
    )

    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        init_kwargs = {} if init_kwargs is None else init_kwargs.copy()
        self.asignatures = initialize_standard_nmf(
            self.adata,
            self.n_signatures,
            self.init_method,
            given_parameters,
            **init_kwargs,
        )

    def compute_reconstruction_errors(self) -> None:
        """Per-sample generalized KL between X and W @ H (host float64)."""
        from ..ops.klnmf import samplewise_kl_divergence

        errors = samplewise_kl_divergence(
            torch.as_tensor(np.asarray(self.adata.X.T, dtype=float)),
            torch.as_tensor(np.asarray(self.asignatures.X.T, dtype=float)),
            torch.as_tensor(np.asarray(self.adata.obsm["exposures"].T,
                                       dtype=float)),
        )
        self.adata.obs["reconstruction_error"] = errors.numpy()

    @staticmethod
    def _n_given_signatures(given_parameters: dict[str, Any] | None) -> int:
        if given_parameters and "asignatures" in given_parameters:
            return int(given_parameters["asignatures"].n_obs)
        return 0

    def _device_state(self):
        # kernel orientation: X (V, D), W (V, K), H (K, D)
        data = {"X": self._to_device(self.adata.X.T)}
        return self._device_params(), data

    def _device_params(self):
        return {
            "W": self._to_device(self.asignatures.X.T),
            "H": self._to_device(self.adata.obsm["exposures"].T),
        }

    def _absorb_params(self, params) -> None:
        self.asignatures.X = np.asarray(params["W"]).T
        self.adata.obsm["exposures"] = np.asarray(params["H"]).T

    def transform(self, adata, **fit_kwargs):
        """Infer exposures for NEW samples under this model's (frozen)
        signatures: a fresh fit of the same class with all signatures given,
        so only the exposure matrix is learned. Returns the fitted projector
        model; neither `self` nor the input container is modified.
        """
        if not getattr(self, "_is_fitted", False):
            raise ValueError("transform() requires a fitted model.")
        if "given_parameters" in fit_kwargs:
            raise ValueError(
                "transform() freezes this model's signatures itself; "
                "'given_parameters' cannot be overridden here - use fit() "
                "directly for custom given parameters."
            )
        hyperparameters = {
            key: getattr(self, key) for key in self._hyperparameter_keys
        }
        hyperparameters["init_method"] = "flat"
        projector = type(self)(**hyperparameters)
        projector.fit(
            adata.copy() if hasattr(adata, "copy") else adata,
            given_parameters={"asignatures": self.asignatures.copy()},
            **fit_kwargs,
        )
        return projector

    def plot_embeddings(
        self,
        method: str = "umap",
        n_components: int = 2,
        dimensions: tuple[int, int] = (0, 1),
        color: str | None = None,
        zorder: str | None = None,
        annotations=None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        tl.reduce_dimension(
            self.adata, basis="exposures", method=method,
            n_components=n_components,
        )
        if self.n_signatures <= 2:
            warnings.warn(
                f"There are only {self.n_signatures} many signatures. "
                "The exposures are plotted directly.",
                UserWarning,
            )
            basis = "exposures"
        else:
            basis = method

        ax = pl.embedding(
            adata=self.adata,
            basis=basis,
            dimensions=dimensions,
            color=color,
            zorder=zorder,
            annotations=annotations,
            **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax
