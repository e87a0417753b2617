"""Deterministic batch variational EM for correlated NMF, held against
salamander_tpu/models/corrnmf_det.py.

The update cycle runs in the reference CorrNMFDet's order (its
models/corrnmf_det.py:157-169), which the objective traces observe:
  1 sample scalings (closed form)
  2 exposures from the (updated) scalings and embeddings
  3 the aux sufficient statistic
  4 signature scalings (closed form)
  5 embeddings: signatures to convergence, then samples with the updated
    signature embeddings, capped at 3 Newton steps (scipy maxiter=3 twin)
  6 variance from the fresh embeddings
  7 signatures by the KL multiplicative W update at the step-2 exposures
Both embedding sides are one batched Newton solve over all rows (and
lanes); ops/corrnmf.py. The ELBO reported during fitting uses the step-2
exposures, as the reference's container state does. newton_cg_compat=True
runs the reference's per-row scipy Newton-CG on the host instead, with the
whole fit loop host-side. No kernel: the cycle runs as plain PyTorch ops
(its W step is update_W at fixed exposures, not the joint step that the
fused KLNMF kernel carries). fit_minibatch is the stochastic (minibatch)
variational EM of ops/svi.py, with the counts on the device or streamed
from the host.

Under a sample-sharded mesh (fit(mesh=), fit_minibatch(mesh=)) each rank
holds a block of the samples; a cycle's sums over them take one collective
for the signature scalings and the signature update together, two per
signature-side Newton step and one for the variance (ops/corrnmf.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..engine.transfer import params_to_numpy
from ..ops import corrnmf as ops
from ..ops import klnmf as klnmf_ops
from ..ops.klnmf import sum_samples
from ..ops.precision import require_ieee_float32
from .corrnmf import CorrNMF, _host
from .signature_nmf import (
    NEWTON_CG_COMPAT_MINIBATCH,
    check_minibatch_placement,
    host_rows,
    record_minibatch_history,
    run_resident_minibatch,
)

SIGNATURE_NEWTON_ITERS = 100  # effectively to convergence (quadratic)
SAMPLE_NEWTON_ITERS = 3       # the reference's scipy options={"maxiter": 3}


class CorrNMFDet(CorrNMF):
    """Deterministic correlated NMF (Paisley, Blei & Jordan 2014 variant)."""

    @property
    def _fits_on_host(self) -> bool:
        # newton_cg_compat runs the reference's exact scipy Newton-CG per
        # embedding row; the whole fit loop then runs host-side
        return self.newton_cg_compat

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        data = {"X": self._to_device(self.adata.X)}  # (D, V), samples as rows
        return self._device_params(), data

    def _device_params(self, include_exposures: bool = True):
        """The parameter dict alone, without the counts."""
        params = {
            "signatures": self._to_device(self.asignatures.X),  # (K, V)
            "signature_scalings": self._to_device(
                np.array(self.asignatures.obs["scalings"], dtype=float)),
            "sample_scalings": self._to_device(
                np.array(self.adata.obs["scalings"], dtype=float)),
            "signature_embeddings": self._to_device(
                self.asignatures.obsm["embeddings"]),
            "sample_embeddings": self._to_device(
                self.adata.obsm["embeddings"]),
            "variance": torch.tensor(float(self.variance),
                                     dtype=self._device_dtype,
                                     device=self.device),
        }
        if include_exposures:
            params["exposures"] = self._to_device(
                self.adata.obsm["exposures"])
        return params

    def _absorb_params(self, params) -> None:
        self.asignatures.X = np.asarray(params["signatures"])
        self.asignatures.obs["scalings"] = np.asarray(
            params["signature_scalings"])
        self.adata.obs["scalings"] = np.asarray(params["sample_scalings"])
        self.asignatures.obsm["embeddings"] = np.asarray(
            params["signature_embeddings"]
        )
        self.adata.obsm["embeddings"] = np.asarray(
            params["sample_embeddings"])
        self.variance = float(params["variance"])
        self.adata.obsm["exposures"] = np.asarray(params["exposures"])

    def _given_flags(self, given_parameters) -> dict[str, Any]:
        """Freeze flags derived from a given_parameters dict - the single
        source of truth for which parameters a fit holds fixed."""
        given = given_parameters or {}
        n_given = 0
        if "asignatures" in given:
            n_given = int(given["asignatures"].n_obs)
        return {
            "n_given": n_given,
            "fix_signatures": n_given == self.n_signatures,
            "fix_signature_scalings": "signature_scalings" in given,
            "fix_sample_scalings": "sample_scalings" in given,
            "fix_signature_embeddings": "signature_embeddings" in given,
            "fix_sample_embeddings": "sample_embeddings" in given,
            "fix_variance": "variance" in given,
        }

    def _sample_axes(self):
        # samples as rows: the per-sample leaves and X split on axis 0
        return (
            {"sample_scalings": 0, "sample_embeddings": 0, "exposures": 0},
            {"X": 0},
        )

    def _build_step(self, given_parameters=None, reduce_samples=None):
        flags = self._given_flags(given_parameters)
        n_given = flags["n_given"]

        def update_fn(params, data):
            X = data["X"]
            signatures = params["signatures"]
            sig_scal = params["signature_scalings"]
            smp_scal = params["sample_scalings"]
            sig_emb = params["signature_embeddings"]
            smp_emb = params["sample_embeddings"]
            variance = params["variance"]

            if not flags["fix_sample_scalings"]:
                smp_scal = ops.update_sample_scalings(
                    X, sig_scal, sig_emb, smp_emb
                )
            exposures = ops.compute_exposures(sig_scal, smp_scal, sig_emb,
                                              smp_emb)
            aux = ops.compute_aux(X, signatures, exposures)
            # the sums over samples of the signature scalings and of the
            # signature update (step 7 reads the step-2 exposures and the
            # old signatures): one reduce_samples call under a mesh
            partials = []
            if not flags["fix_signature_scalings"]:
                partials += ops.signature_scaling_sums(aux, smp_scal,
                                                       sig_emb, smp_emb)
            if not flags["fix_signatures"]:
                partials.append(klnmf_ops.w_numerator(
                    X.mT, signatures.mT, exposures.mT))
            sums = list(sum_samples(reduce_samples, *partials))
            if not flags["fix_signature_scalings"]:
                observed, predicted = sums.pop(0), sums.pop(0)
                sig_scal = torch.log(observed) - torch.log(predicted)
            if not flags["fix_signature_embeddings"]:
                sig_emb = ops.update_embeddings(
                    sig_emb, smp_emb, sig_scal, smp_scal, variance, aux,
                    max_iter=SIGNATURE_NEWTON_ITERS,
                    reduce_samples=reduce_samples,
                )
            if not flags["fix_sample_embeddings"]:
                smp_emb = ops.update_embeddings(
                    smp_emb, sig_emb, smp_scal, sig_scal, variance, aux.mT,
                    max_iter=SAMPLE_NEWTON_ITERS,
                )
            if not flags["fix_variance"]:
                variance = ops.update_variance(sig_emb, smp_emb,
                                               reduce_samples)
            if not flags["fix_signatures"]:
                signatures = klnmf_ops.update_W_from_numerator(
                    signatures.mT, sums.pop(0), n_given).mT
            return {
                "signatures": signatures,
                "signature_scalings": sig_scal,
                "sample_scalings": smp_scal,
                "signature_embeddings": sig_emb,
                "sample_embeddings": smp_emb,
                "variance": variance,
                "exposures": exposures,
            }

        def objective_fn(params, data):
            return ops.elbo_corrnmf(
                data["X"],
                params["signatures"],
                params["exposures"],
                params["signature_embeddings"],
                params["sample_embeddings"],
                params["variance"],
                reduce_samples=reduce_samples,
            )

        return update_fn, objective_fn

    # ------------------------------------------------------------------ #
    # stochastic (minibatch) EM
    # ------------------------------------------------------------------ #
    def fit_minibatch(
        self,
        adata,
        batch_size: int = 128,
        n_steps: int = 2000,
        eval_freq: int = 50,
        forgetting: float = 0.7,
        delay: float = 1.0,
        seed: int = 0,
        signature_newton_iters: int = 4,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        streaming: bool = False,
        eval_chunk: int = 8192,
        mesh=None,
    ) -> "CorrNMFDet":
        """Fit with stochastic (minibatch) variational EM instead of
        full-batch cycles - for cohorts whose sample count makes full EM
        cycles too slow: per-step compute is amortized O(batch_size) while
        a full-batch cycle is O(n_samples).

        streaming=False (default) keeps the count matrix device-resident.
        streaming=True keeps X HOST-resident and uploads each minibatch
        (and, for the ELBO trace, eval_chunk-row evaluation chunks) on the
        fly: only the O(n_samples) per-sample parameters live in device
        memory, so a cohort whose counts exceed it fits end to end. Given
        the same seed, the two placements draw identical minibatch
        sequences and produce bit-equal parameters (ops/svi.py
        run_svi_streaming) - when comparing two separate calls, also seed
        numpy's global generator: the CorrNMF embedding initialization
        draws from it (reference semantics). Integer-dtype count matrices
        are kept compact on the host in streaming mode (adata.X is NOT
        clipped in place; the EPSILON clip is applied to each uploaded
        batch instead, and the initializer sees the unclipped counts, so
        compare the placements on float counts). Pass eval_freq=0 to skip the O(n_samples)
        full-data ELBO evaluations (recorded in the fit dtype).

        Each step refreshes `batch_size` samples' local parameters with the
        exact batch M-steps and updates the global parameters from
        Robbins-Monro running averages of minibatch-scaled sufficient
        statistics (rho_t = (t + delay)^(-forgetting); see ops/svi.py).
        With batch_size >= n_samples, delay=1, and signature_newton_iters
        raised to the full-batch cap (100), the first step reduces exactly
        to one deterministic EM cycle; at the default signature_newton_iters
        (4, plenty under rho-damping) it is the same cycle with a truncated
        signature-embedding Newton solve, and a step then makes no host
        sync.

        batch_size is clamped to n_samples, so the defaults work on small
        cohorts. Runs a fixed `n_steps` step budget (stochastic traces have
        no meaningful relative-change convergence test); the full-data ELBO
        is recorded every `eval_freq` steps into history. `seed` seeds the
        CPU generator that draws each epoch's sample order. Raising `delay`
        (20-100) tempers the early noisy steps and preserves more of the
        initialization basin.

        mesh (a DeviceMesh with a 'samples' axis that every rank passes)
        shards the resident cohort's samples: every rank draws the same
        batches, refreshes the locals of its batch samples and all-reduces
        the batch sums and the recorded ELBO (ops/svi.py); with
        streaming=True it is refused, as the streaming path is host-driven
        and single-device.
        """
        from ..ops import svi

        if self.newton_cg_compat:
            raise ValueError(NEWTON_CG_COMPAT_MINIBATCH)
        check_minibatch_placement(mesh, streaming)

        if streaming:
            self._setup_adata_streaming(adata)
        else:
            self._setup_adata(adata)
        self._initialize(given_parameters, init_kwargs)
        self._setup_fitting_parameters(None)
        if self.device.type == "cuda":
            require_ieee_float32()

        flags = self._given_flags(given_parameters)
        n_samples = int(self.adata.n_obs)
        config = svi.SVIConfig(
            batch_size=min(int(batch_size), n_samples),
            forgetting=forgetting,
            delay=delay,
            signature_newton_iters=signature_newton_iters,
            sample_newton_iters=SAMPLE_NEWTON_ITERS,
        )
        step_kwargs = dict(
            n_samples=n_samples,
            config=config,
            n_given_signatures=flags["n_given"],
            fix_signature_scalings=flags["fix_signature_scalings"],
            fix_sample_scalings=flags["fix_sample_scalings"],
            fix_signature_embeddings=flags["fix_signature_embeddings"],
            fix_sample_embeddings=flags["fix_sample_embeddings"],
            fix_variance=flags["fix_variance"],
        )
        generator = torch.Generator().manual_seed(seed)
        if streaming:
            params = self._device_params(include_exposures=False)
            dtype = np.dtype(self.dtype)
            X_host = self.adata.X

            def get_batch(indices):
                return host_rows(X_host, indices, dtype)

            objective_fn = None
            if eval_freq:
                objective_fn = svi.make_streamed_objective(
                    svi.corrnmf_elbo_stream_chunk,
                    svi.corrnmf_elbo_stream_rest,
                    get_batch, n_samples, chunk_size=eval_chunk,
                )
            state, elbo_trace = svi.run_svi_streaming(
                svi.make_svi_batch_step(**step_kwargs),
                svi.svi_init(params, streaming=True), get_batch,
                n_samples, config.batch_size, generator,
                n_steps, eval_freq, objective_fn,
                refresh_fn=svi.refresh_sample_usq,
            )
            final = dict(state.params)
        else:
            params, data = self._device_state()
            params, elbo_trace = run_resident_minibatch(
                svi.make_svi_step, svi.svi_init, svi.full_elbo, params,
                data, lambda d: d["X"], self._sample_axes(), mesh,
                generator, n_steps, eval_freq, **step_kwargs)
            final = dict(params)
        final["exposures"] = ops.compute_exposures(
            final["signature_scalings"],
            final["sample_scalings"],
            final["signature_embeddings"],
            final["sample_embeddings"],
        )
        self._absorb_params(params_to_numpy(final))
        if history:
            record_minibatch_history(self.history, elbo_trace, n_steps,
                                     eval_freq)
        self._is_fitted = True
        return self

    # ------------------------------------------------------------------ #
    # eager per-update methods (test/inspection surface, reference-named;
    # host float64)
    # ------------------------------------------------------------------ #
    def _compute_aux(self) -> np.ndarray:
        return ops.compute_aux(
            _host(self.adata.X), _host(self.asignatures.X),
            _host(self.adata.obsm["exposures"]),
        ).numpy()

    def update_sample_scalings(self, given_parameters=None) -> None:
        given = given_parameters or {}
        if "sample_scalings" not in given:
            self.adata.obs["scalings"] = ops.update_sample_scalings(
                _host(self.adata.X),
                _host(self.asignatures.obs["scalings"]),
                _host(self.asignatures.obsm["embeddings"]),
                _host(self.adata.obsm["embeddings"]),
            ).numpy()

    def update_signature_scalings(self, aux, given_parameters=None) -> None:
        given = given_parameters or {}
        if "signature_scalings" not in given:
            self.asignatures.obs["scalings"] = ops.update_signature_scalings(
                _host(aux),
                _host(self.adata.obs["scalings"]),
                _host(self.asignatures.obsm["embeddings"]),
                _host(self.adata.obsm["embeddings"]),
            ).numpy()

    def _update_side(self, embeddings, embeddings_other, scalings,
                     scalings_other, aux_mat, max_iter):
        """One side's embedding M-step: the batched Newton, or the
        reference's scipy Newton-CG under newton_cg_compat (the
        signature side then runs scipy's default iteration cap)."""
        if self.newton_cg_compat:
            return ops.update_embeddings_newton_cg(
                embeddings, embeddings_other, np.asarray(scalings),
                np.asarray(scalings_other), self.variance, aux_mat,
                max_iter=None if max_iter == SIGNATURE_NEWTON_ITERS
                else max_iter,
            )
        return ops.update_embeddings(
            _host(embeddings), _host(embeddings_other), _host(scalings),
            _host(scalings_other), float(self.variance), _host(aux_mat),
            max_iter=max_iter,
        ).numpy()

    def update_signature_embeddings(self, aux) -> None:
        self.asignatures.obsm["embeddings"] = self._update_side(
            self.asignatures.obsm["embeddings"],
            self.adata.obsm["embeddings"],
            self.asignatures.obs["scalings"], self.adata.obs["scalings"],
            np.asarray(aux), SIGNATURE_NEWTON_ITERS,
        )

    def update_sample_embeddings(self, aux) -> None:
        self.adata.obsm["embeddings"] = self._update_side(
            self.adata.obsm["embeddings"],
            self.asignatures.obsm["embeddings"],
            self.adata.obs["scalings"], self.asignatures.obs["scalings"],
            np.asarray(aux).T, SAMPLE_NEWTON_ITERS,
        )

    def update_embeddings(self, aux, given_parameters=None) -> None:
        given = given_parameters or {}
        if "signature_embeddings" not in given:
            self.update_signature_embeddings(aux)
        if "sample_embeddings" not in given:
            self.update_sample_embeddings(aux)

    def update_variance(self, given_parameters=None) -> None:
        given = given_parameters or {}
        if "variance" not in given:
            self.variance = float(
                ops.update_variance(
                    _host(self.asignatures.obsm["embeddings"]),
                    _host(self.adata.obsm["embeddings"]),
                )
            )

    def update_signatures(self, given_parameters=None) -> None:
        given = given_parameters or {}
        n_given = given["asignatures"].n_obs if "asignatures" in given else 0
        W = klnmf_ops.update_W(
            _host(self.adata.X.T),
            _host(self.asignatures.X.T),
            _host(self.adata.obsm["exposures"].T),
            n_given_signatures=n_given,
        )
        self.asignatures.X = W.numpy().T

    def _update_parameters(self, given_parameters: dict[str, Any] | None = None):
        """One full EM cycle, eagerly (reference order, corrnmf_det:157-169)."""
        given = given_parameters or {}
        self.update_sample_scalings(given)
        self.compute_exposures()
        aux = self._compute_aux()
        self.update_signature_scalings(aux, given)
        self.update_embeddings(aux, given)
        self.update_variance(given)
        self.update_signatures(given)
