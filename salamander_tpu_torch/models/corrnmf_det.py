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
fused KLNMF kernel carries). The stochastic minibatch fit waits for the
SVI port.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import corrnmf as ops
from ..ops import klnmf as klnmf_ops
from .corrnmf import CorrNMF, _host

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

    def _build_step(self, given_parameters=None):
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
            if not flags["fix_signature_scalings"]:
                sig_scal = ops.update_signature_scalings(
                    aux, smp_scal, sig_emb, smp_emb
                )
            if not flags["fix_signature_embeddings"]:
                sig_emb = ops.update_embeddings(
                    sig_emb, smp_emb, sig_scal, smp_scal, variance, aux,
                    max_iter=SIGNATURE_NEWTON_ITERS,
                )
            if not flags["fix_sample_embeddings"]:
                smp_emb = ops.update_embeddings(
                    smp_emb, sig_emb, smp_scal, sig_scal, variance, aux.mT,
                    max_iter=SAMPLE_NEWTON_ITERS,
                )
            if not flags["fix_variance"]:
                variance = ops.update_variance(sig_emb, smp_emb)
            if not flags["fix_signatures"]:
                signatures = klnmf_ops.update_W(
                    X.mT, signatures.mT, exposures.mT,
                    n_given_signatures=n_given,
                ).mT
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
            )

        return update_fn, objective_fn

    def fit_minibatch(self, *args, **kwargs):
        """Stochastic (minibatch) variational EM (JAX package
        models/corrnmf_det.py:190) waits for the SVI port."""
        raise NotImplementedError(
            "fit_minibatch waits for the port of ops/svi.py (SVI and "
            "streaming, ROADMAP Queue 1 item 13)"
        )

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
