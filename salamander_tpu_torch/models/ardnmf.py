"""ARDNMF: KL-NMF with automatic relevance determination (rank inference),
held against salamander_tpu/models/ardnmf.py.

ARDNMF fits ONCE at an over-complete rank ``n_signatures = K_max`` and lets
inverse-gamma relevance priors (Tan & Fevotte 2013, beta=1) shrink
unsupported components to the EPSILON floor, so the effective rank is read
off the fitted relevance vector (ops/ardnmf.py has the objective and the
updates). The ARD extras:

  model.lambdas               per-signature relevance lambda_k (pd.Series)
  model.relevance             normalized excess over the prior resting value
  model.n_active_signatures   inferred rank
  model.active_signatures()   names of the data-supported signatures
  model.prune()               drop pruned components from the containers

Fitted ARD signatures are NOT column-normalized - their scale carries the
relevance; ``prune(normalize=True)`` renormalizes the survivors and pushes
the scale into the exposures (WH-invariant). No kernel: the updates carry
prior terms the fused KLNMF kernel does not have, so they run as plain
PyTorch ops. ``model.plot_relevance()`` draws the relevance spectrum.
fit(mesh=) shards the sample axis (ops/ardnmf.py's reduce_samples).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import pandas as pd
import torch

from ..ops import ardnmf as ops
from .standard_nmf import StandardNMF

_LAMBDA_KEY = "ard_lambda"


class ARDNMF(StandardNMF):
    """Decompose counts X into W @ H by minimizing generalized KL divergence
    with component-wise automatic relevance determination: fit with
    ``n_signatures`` set to an upper bound and read the inferred signature
    count from ``n_active_signatures``.

    prior : 'L1' (exponential priors, the default) or 'L2' (half-normal).
    a : inverse-gamma shape of the relevance hyperprior; with the
        moment-matched default b, SMALLER a prunes harder. Needs a > 2 for
        the default b under 'L1', a > 1 under 'L2'.
    b : inverse-gamma scale. None resolves it from the data at fit time
        (ops/ardnmf.default_b) into ``model.b_resolved_``.

    The default iteration cap is 20000: ARD shrinkage converges more slowly
    than plain KLNMF.
    """

    _hyperparameter_keys = StandardNMF._hyperparameter_keys + ("prior", "a",
                                                               "b")

    def __init__(
        self,
        n_signatures: int = 10,
        prior: str = "L1",
        a: float = 5.0,
        b: float | None = None,
        init_method: str = "nndsvd",
        min_iterations: int = 500,
        max_iterations: int = 20000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
        device=None,
    ):
        super().__init__(
            n_signatures, init_method, min_iterations, max_iterations,
            conv_test_freq, tol, dtype=dtype, device=device,
        )
        if prior not in ops.PRIORS:
            raise ValueError(
                f"Unknown ARD prior {prior!r}: use one of {ops.PRIORS}."
            )
        if a <= 0:
            raise ValueError(f"The hyperparameter a must be positive, got {a}.")
        if b is not None and b <= 0:
            raise ValueError(f"The hyperparameter b must be positive, got {b}.")
        self.prior = prior
        self.a = float(a)
        self.b = None if b is None else float(b)
        self.b_resolved_ = float("nan")

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "minimize"

    def _ard_ab(self, dtype=torch.float64, device=None) -> torch.Tensor:
        return torch.tensor([self.a, self.b_resolved_], dtype=dtype,
                            device=device)

    def objective_function(self) -> float:
        def host(array):
            return torch.as_tensor(np.array(array, dtype=float))

        return float(ops.ard_objective(
            host(self.adata.X.T), host(self.asignatures.X.T),
            host(self.adata.obsm["exposures"].T),
            host(self.asignatures.obs[_LAMBDA_KEY]), self._ard_ab(),
            self.prior,
        ))

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #
    def _resolve_b(self) -> float:
        if self.b is not None:
            return self.b
        return ops.default_b(
            self.prior, float(np.mean(self.adata.X)), self.n_signatures,
            self.a,
        )

    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        super()._initialize(given_parameters, init_kwargs)
        self.b_resolved_ = self._resolve_b()

        # rebalance + closed-form lambda0 (ops.init_params) in float64 on
        # the model's device
        def tensor(array):
            return torch.as_tensor(np.ascontiguousarray(array),
                                   dtype=torch.float64, device=self.device)

        params = ops.init_params(
            tensor(self.asignatures.X.T),
            tensor(self.adata.obsm["exposures"].T),
            self._ard_ab(device=self.device),
            self.prior,
            self._n_given_signatures(given_parameters),
        )
        self.asignatures.X = params["W"].cpu().numpy().T
        self.adata.obsm["exposures"] = params["H"].cpu().numpy().T
        self.asignatures.obs[_LAMBDA_KEY] = params["lam"].cpu().numpy()

    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        if fitting_kwargs:
            raise ValueError(
                "ARDNMF takes no fitting keyword arguments (its "
                "hyperparameters prior/a/b are constructor arguments); got "
                f"{sorted(fitting_kwargs)}."
            )

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_params(self):
        params = super()._device_params()
        params["lam"] = self._to_device(
            np.array(self.asignatures.obs[_LAMBDA_KEY], dtype=float))
        return params

    def _device_state(self):
        params, data = super()._device_state()
        data["ard_ab"] = self._ard_ab(data["X"].dtype, self.device)
        return params, data

    def _absorb_params(self, params) -> None:
        super()._absorb_params(params)
        self.asignatures.obs[_LAMBDA_KEY] = np.asarray(params["lam"])

    def _check_warm_start(self, given_parameters) -> None:
        super()._check_warm_start(given_parameters)
        try:
            np.asarray(self.asignatures.obs[_LAMBDA_KEY])
            ok = np.isfinite(float(self.b_resolved_))
        except (AttributeError, KeyError, TypeError):
            ok = False
        if not ok:
            raise ValueError(
                "warm_start=True for ARDNMF needs the previous fit's "
                "relevance state (per-signature lambda + resolved b); "
                "fit once without warm_start first."
            )

    def _build_step(self, given_parameters=None, reduce_samples=None):
        return ops.make_step_functions(
            self.prior, self._n_given_signatures(given_parameters),
            reduce_samples,
        )

    # ------------------------------------------------------------------ #
    # relevance / rank inference
    # ------------------------------------------------------------------ #
    def _require_fitted(self, what: str) -> None:
        if not getattr(self, "_is_fitted", False):
            raise ValueError(f"{what} requires a fitted model.")

    @property
    def lambdas(self) -> pd.Series:
        """Per-signature relevance parameter lambda_k."""
        self._require_fitted("lambdas")
        return pd.Series(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]),
            index=self.signature_names, name="lambda",
        )

    @property
    def relevance(self) -> pd.Series:
        """Normalized relevance excess (f(w_k)+f(h_k))/b: ~0 for pruned
        components, O(1) or larger for data-supported ones."""
        self._require_fitted("relevance")
        excess = ops.relevance_excess(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]),
            np.array([self.a, self.b_resolved_]),
            self.prior, self.adata.n_vars, self.adata.n_obs,
        )
        return pd.Series(excess, index=self.signature_names,
                         name="relevance")

    def active_signatures_mask(self, active_tol: float = 1e-2) -> np.ndarray:
        """Boolean (K,) mask of data-supported signatures: relevance excess
        at least `active_tol` times the most relevant component's."""
        self._require_fitted("active_signatures_mask()")
        return ops.active_components(
            np.asarray(self.asignatures.obs[_LAMBDA_KEY]),
            np.array([self.a, self.b_resolved_]),
            self.prior, self.adata.n_vars, self.adata.n_obs,
            active_tol=active_tol,
        )

    def active_signatures(self, active_tol: float = 1e-2) -> list[str]:
        mask = self.active_signatures_mask(active_tol)
        return [name for name, keep in zip(self.signature_names, mask) if keep]

    @property
    def n_active_signatures(self) -> int:
        """The inferred signature count (at the default active_tol)."""
        return int(self.active_signatures_mask().sum())

    def plot_relevance(self, active_tol: float = 1e-2,
                       outfile: str | None = None, **kwargs):
        """Bar plot of the relevance spectrum (log scale) with the
        active/pruned threshold - the visual rank readout."""
        from .. import plot as pl
        import matplotlib.pyplot as plt

        ax = pl.relevance(self, active_tol=active_tol, **kwargs)
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

    def prune(self, active_tol: float = 1e-2, normalize: bool = True
              ) -> "ARDNMF":
        """Drop pruned components from the containers in place (signatures,
        exposures, relevance), keeping W @ H unchanged up to the discarded
        components' EPSILON-floor mass. normalize=True rescales the
        survivors to sum one, pushing the scale into the exposures, and
        re-minimizes the stored lambdas at the new point. Returns self.
        """
        self._require_fitted("prune()")
        mask = self.active_signatures_mask(active_tol)
        keep = np.flatnonzero(mask)
        self.asignatures = self.asignatures[keep, :].copy()
        self.adata.obsm["exposures"] = self.adata.obsm["exposures"][:, keep]
        self.n_signatures = int(keep.size)
        if normalize:
            W = self.asignatures.X.T  # (V, k)
            scale = W.sum(axis=0)
            self.asignatures.X = (W / scale).T
            self.adata.obsm["exposures"] = (
                self.adata.obsm["exposures"] * scale[None, :]
            )
            # the closed form (f(w_k)+f(h_k)+b)/c at the rescaled point
            W = self.asignatures.X.T
            H = self.adata.obsm["exposures"].T
            if self.prior == "L1":
                f_norms = W.sum(axis=0) + H.sum(axis=1)
            else:
                f_norms = 0.5 * ((W**2).sum(axis=0) + (H**2).sum(axis=1))
            c = ops.prior_constant(
                self.prior, self.adata.n_vars, self.adata.n_obs, self.a
            )
            self.asignatures.obs[_LAMBDA_KEY] = (
                (f_norms + self.b_resolved_) / c
            )
        # stale caches of the pre-prune rank
        self._invalidate_derived(self.adata)
        return self
