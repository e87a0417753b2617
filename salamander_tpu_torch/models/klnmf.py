"""KLNMF: weighted generalized-KL NMF with optional l1/2 exposure sparsity,
held against salamander_tpu/models/klnmf.py.

fitting_kwargs 'weights_kl'/'weights_lhalf' (scalar/list broadcast to
per-sample arrays, non-negativity enforced), the joint update_WH per
iteration and the weighted-KL + penalty objective. A float32 fit on a card
without weights or given signatures advances each convergence block with
one launch of the fused CUDA kernel (ops/cuda_klnmf.py); every other fit
runs the plain PyTorch update. fit_minibatch is online NMF over the sample
axis (ops/svi.py), with the counts on the device or streamed from the host;
it runs plain PyTorch ops (its step is not the joint block the kernel
carries). fit(mesh=) and fit_minibatch(mesh=) shard the sample axis over
a mesh's ranks (models/signature_nmf.py, ops/svi.py).
"""

from __future__ import annotations

from typing import Any, Literal

import numpy as np
import torch

from ..ops import cuda_klnmf
from ..engine.transfer import params_to_numpy
from ..ops import klnmf as ops
from ..ops.precision import require_ieee_float32
from ..utils import shape_checker, type_checker
from .signature_nmf import (
    check_minibatch_placement,
    host_rows,
    record_minibatch_history,
    run_resident_minibatch,
)
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

    def _build_step(self, given_parameters=None, reduce_samples=None):
        return ops.make_step_functions(
            self._n_given_signatures(given_parameters), reduce_samples
        )

    def _block_update_fn(self, params, data, given_parameters=None,
                         sample_sharded: bool = False):
        if cuda_klnmf.mu_block_supported(
            data["X"], params["W"], params["H"], data,
            self._n_given_signatures(given_parameters),
            sample_sharded=sample_sharded,
        ):
            return cuda_klnmf.fused_block_update
        return None

    # ------------------------------------------------------------------ #
    # stochastic (minibatch) fitting: online NMF
    # ------------------------------------------------------------------ #
    def fit_minibatch(
        self,
        adata,
        batch_size: int = 128,
        n_steps: int = 2000,
        eval_freq: int = 50,
        forgetting: float = 0.51,
        delay: float = 1.0,
        seed: int = 0,
        h_inner_iters: int = 1,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        fitting_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        streaming: bool = False,
        eval_chunk: int = 8192,
        mesh=None,
    ) -> "KLNMF":
        """Fit with online (minibatch) NMF instead of full-batch cycles -
        for cohorts whose sample count makes full multiplicative-update
        sweeps too slow: per-step compute is amortized O(batch_size) while
        a full sweep is O(n_samples).

        Each step refreshes the minibatch's exposure columns with
        `h_inner_iters` exact multiplicative H updates and updates the
        signatures from a Robbins-Monro running average of the D-scaled
        expected signature counts (ops/svi.py make_klnmf_svi_step). With
        batch_size >= n_samples (it is clamped), delay=1 and
        h_inner_iters=1, the first step reduces exactly to one serial
        Lee-Seung cycle (update_H then update_W). Supports the same
        `fitting_kwargs` weights and given-signature freezing as fit().

        Runs a fixed `n_steps` budget; the full-data objective is recorded
        every `eval_freq` steps in the fit dtype (eval_freq=0 disables the
        O(n_samples) evaluations). `seed` seeds the CPU generator that
        draws each epoch's sample order.

        streaming=False keeps the count matrix device-resident.
        streaming=True keeps X HOST-resident and uploads minibatches (and
        eval_chunk-column objective-evaluation chunks) on the fly: only W,
        H and O(batch) buffers live in device memory. Same seed =>
        bit-equal parameters across the two placements (ops/svi.py
        run_svi_streaming); integer count matrices stay compact on the
        host (clipped per uploaded batch, not in place; the initializer
        then sees the unclipped counts, so an nndsvd start can differ from
        the resident fit's in its last bits: compare the placements on
        float counts).

        The default forgetting=0.51 (the slowest Robbins-Monro-admissible
        decay) is deliberate for KLNMF: multiplicative updates converge
        slowly, so fast statistic decay (e.g. the CorrNMF default 0.7)
        freezes the signatures far from the optimum.

        mesh (a DeviceMesh with a 'samples' axis that every rank passes)
        shards the resident cohort's samples: every rank draws the same
        batches, refreshes the exposures of its batch samples and
        all-reduces the W statistic and the recorded objective (ops/svi.py);
        with streaming=True it is refused, as the streaming path is
        host-driven and single-device.
        """
        from ..ops import svi

        check_minibatch_placement(mesh, streaming)
        if streaming:
            self._setup_adata_streaming(adata)
        else:
            self._setup_adata(adata)
        self._initialize(given_parameters, init_kwargs)
        self._setup_fitting_parameters(fitting_kwargs)
        if self.device.type == "cuda":
            require_ieee_float32()

        n_samples = int(self.adata.n_obs)
        config = svi.SVIConfig(
            batch_size=min(int(batch_size), n_samples),
            forgetting=forgetting,
            delay=delay,
        )
        step_kwargs = dict(
            n_samples=n_samples,
            config=config,
            n_given_signatures=self._n_given_signatures(given_parameters),
            h_inner_iters=h_inner_iters,
        )
        generator = torch.Generator().manual_seed(seed)
        if streaming:
            params = self._device_params()
            dtype = np.dtype(self.dtype)
            X_host = self.adata.X  # (D, V); kernel orientation is (V, B)
            w_kl, w_lhalf = self.weights_kl, self.weights_lhalf

            def get_batch(indices):
                rows = host_rows(X_host, indices, dtype)
                batch = {"X": np.ascontiguousarray(rows.T)}
                if w_kl is not None:
                    batch["weights_kl"] = np.asarray(w_kl[indices], dtype)
                if w_lhalf is not None:
                    batch["weights_lhalf"] = np.asarray(
                        w_lhalf[indices], dtype
                    )
                return batch

            objective_fn = None
            if eval_freq:
                objective_fn = svi.make_streamed_objective(
                    svi.klnmf_objective_stream_chunk,
                    svi.klnmf_objective_stream_rest,
                    get_batch, n_samples, chunk_size=eval_chunk,
                )
            state, trace = svi.run_svi_streaming(
                svi.make_klnmf_svi_batch_step(**step_kwargs),
                svi.klnmf_svi_init(params, streaming=True),
                get_batch, n_samples, config.batch_size, generator,
                n_steps, eval_freq, objective_fn,
            )
            params = state.params
        else:
            params, data = self._device_state()
            params, trace = run_resident_minibatch(
                svi.make_klnmf_svi_step, svi.klnmf_svi_init,
                svi.klnmf_full_objective, params, data, lambda d: d,
                self._sample_axes(), mesh, generator, n_steps,
                eval_freq, **step_kwargs)
        self._absorb_params(params_to_numpy(params))
        if history:
            record_minibatch_history(self.history, trace, n_steps, eval_freq)
        self._is_fitted = True
        return self

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
