"""KLNMF: weighted generalized-KL NMF with optional l1/2 exposure sparsity,
held against salamander_tpu/models/klnmf.py.

fitting_kwargs 'weights_kl'/'weights_lhalf' (scalar/list broadcast to
per-sample arrays, non-negativity enforced), the joint update_WH per
iteration and the weighted-KL + penalty objective. A float32 fit on a card
without weights or given signatures advances each convergence block with
one launch of the fused CUDA kernel (ops/cuda_klnmf.py); every other fit
runs the plain PyTorch update. The stochastic minibatch fit is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Literal

import numpy as np
import torch

from ..ops import cuda_klnmf
from ..ops import klnmf as ops
from ..utils import shape_checker, type_checker
from .standard_nmf import StandardNMF

FITTING_KWARGS = ("weights_kl", "weights_lhalf")


class KLNMF(StandardNMF):
    """Decompose counts X into W @ H by minimizing weighted generalized KL
    divergence under normalized signatures (Lee & Seung multiplicative
    updates), with an optional sparsity-inducing l1/2 exposure penalty."""

    def __init__(
        self,
        n_signatures: int = 1,
        init_method: str = "nndsvd",
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
        self.weights_kl: np.ndarray | None = None
        self.weights_lhalf: np.ndarray | None = None

    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "minimize"

    def objective_function(self) -> float:
        def host(array):
            return None if array is None else torch.as_tensor(
                np.asarray(array, dtype=float)
            )

        return float(
            ops.klnmf_objective(
                host(self.adata.X.T),
                host(self.asignatures.X.T),
                host(self.adata.obsm["exposures"].T),
                host(self.weights_kl),
                host(self.weights_lhalf),
            )
        )

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        params, data = super()._device_state()
        if self.weights_kl is not None:
            data["weights_kl"] = self._to_device(self.weights_kl)
        if self.weights_lhalf is not None:
            data["weights_lhalf"] = self._to_device(self.weights_lhalf)
        return params, data

    def _build_step(self, given_parameters=None):
        return ops.make_step_functions(
            self._n_given_signatures(given_parameters)
        )

    def _block_update_fn(self, params, data, given_parameters=None):
        if cuda_klnmf.mu_block_supported(
            data["X"], params["W"], params["H"], data,
            self._n_given_signatures(given_parameters),
        ):
            return cuda_klnmf.fused_block_update
        return None

    # ------------------------------------------------------------------ #
    # fitting kwargs
    # ------------------------------------------------------------------ #
    def _check_weights(self, weights: np.ndarray, name: str = "weights") -> None:
        type_checker(name, weights, np.ndarray)
        shape_checker(name, weights, (self.adata.n_obs,))
        if not all(weights >= 0):
            raise ValueError(
                "Only non-negative KL-divergence and sparsity penalty weights "
                "are allowed."
            )

    def _setup_fitting_parameters(
        self, fitting_kwargs: dict[str, Any] | None = None
    ) -> None:
        if fitting_kwargs is None:
            fitting_kwargs = {name: None for name in FITTING_KWARGS}

        for kwarg in fitting_kwargs:
            if kwarg not in FITTING_KWARGS:
                raise ValueError(
                    "The given fitting keyword arguments include parameters "
                    f"outside of {list(FITTING_KWARGS)}."
                )

        for name, weights in fitting_kwargs.items():
            if weights is not None:
                type_checker(name, weights, [float, int, list, np.ndarray])
                if type(weights) in [float, int]:
                    weights = weights * np.ones(self.adata.n_obs)
                if type(weights) is list:
                    weights = np.array(weights)
                self._check_weights(weights, name)
            setattr(self, name, weights)
