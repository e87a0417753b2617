"""Minimum-volume NMF: KL reconstruction + logdet volume penalty, held
against salamander_tpu/models/mvnmf.py.

Hyperparameters lam/delta; each iteration is the H update, then the W
update with a backtracking line search whose step scale gamma persists
across iterations (reset to 1.0 per fit, carried through the engine as
params["gamma"]). No kernel: the iteration runs as plain PyTorch ops, with
one host sync per line-search round (ops/mvnmf.py); below float64 a trial
is accepted by its change of the objective, summed term by term.
fit(mesh=) shards the sample axis (the sums over D through ops/mvnmf.py's
reduce_samples).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from ..ops import klnmf as klnmf_ops
from ..ops import mvnmf as ops
from .standard_nmf import StandardNMF


def _host(array) -> torch.Tensor:
    return torch.as_tensor(np.asarray(array, dtype=float))


class MvNMF(StandardNMF):
    """Volume-regularized NMF (Leplat, Gillis & Ang 2020) with the
    generalized KL divergence."""

    _hyperparameter_keys = StandardNMF._hyperparameter_keys + ("lam",
                                                               "delta")

    def __init__(
        self,
        n_signatures: int = 1,
        init_method: str = "nndsvd",
        lam: float = 1.0,
        delta: float = 1.0,
        min_iterations: int = 500,
        max_iterations: int = 10000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
        device=None,
    ):
        super().__init__(
            n_signatures, init_method, min_iterations, max_iterations,
            conv_test_freq, tol, dtype=dtype, device=device,
        )
        self.lam = lam
        self.delta = delta
        self._gamma = 1.0
        # line-search trial batching (ops.line_search trial_batch): None =
        # serial, as in the JAX package, whose batched trials land on a
        # different float32 convergence stop than the serial search
        self._line_search_trial_batch: int | None = None

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "minimize"

    def objective_function(self) -> float:
        return float(
            ops.kl_divergence_penalized(
                _host(self.adata.X.T),
                _host(self.asignatures.X.T),
                _host(self.adata.obsm["exposures"].T),
                self.lam,
                self.delta,
            )
        )

    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        self._gamma = 1.0

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        params, data = super()._device_state()
        params["gamma"] = torch.tensor(self._gamma, dtype=params["W"].dtype,
                                       device=self.device)
        return params, data

    def _absorb_params(self, params) -> None:
        super()._absorb_params(params)
        self._gamma = float(params["gamma"])

    def _resolve_trial_batch(self) -> int:
        """Serial trials unless _line_search_trial_batch opts in."""
        if self._line_search_trial_batch is not None:
            return max(1, int(self._line_search_trial_batch))
        return 1

    def _build_step(self, given_parameters=None, reduce_samples=None):
        n_given = self._n_given_signatures(given_parameters)
        lam, delta = self.lam, self.delta
        freeze_W = n_given == self.n_signatures
        trial_batch = self._resolve_trial_batch()

        def update_fn(params, data):
            X = data["X"]
            H = klnmf_ops.update_H(X, params["W"], params["H"])
            if freeze_W:
                return {"W": params["W"], "H": H, "gamma": params["gamma"]}
            W_unconstrained, objective, WH = ops.w_step_and_objective(
                X, params["W"], H, lam, delta, n_given, reduce_samples
            )
            W, H, gamma = ops.line_search(
                X, params["W"], H, lam, delta, params["gamma"],
                W_unconstrained, trial_batch=trial_batch,
                reduce_samples=reduce_samples, prev_objective=objective,
                start_product=WH,
            )
            return {"W": W, "H": H, "gamma": gamma}

        def objective_fn(params, data):
            return ops.kl_divergence_penalized(
                data["X"], params["W"], params["H"], lam, delta,
                reduce_samples
            )

        return update_fn, objective_fn

    # single-step helpers on the host (float64), mirroring the reference's
    # test surface
    def _update_H(self) -> None:
        H = klnmf_ops.update_H(
            _host(self.adata.X.T), _host(self.asignatures.X.T),
            _host(self.adata.obsm["exposures"].T),
        )
        self.adata.obsm["exposures"] = H.numpy().T

    def _update_W(self, n_given_signatures: int = 0) -> None:
        if n_given_signatures == self.n_signatures:
            return
        X = _host(self.adata.X.T)
        W = _host(self.asignatures.X.T)
        H = _host(self.adata.obsm["exposures"].T)
        W_unconstrained = ops.update_W_unconstrained(
            X, W, H, self.lam, self.delta, n_given_signatures
        )
        W_new, H_new, gamma = ops.line_search(
            X, W, H, self.lam, self.delta, self._gamma, W_unconstrained
        )
        self.asignatures.X = W_new.numpy().T
        self.adata.obsm["exposures"] = H_new.numpy().T
        self._gamma = float(gamma)
