"""Multimodal correlated NMF: several CorrNMF models fitted jointly with
shared sample embeddings, held against salamander_tpu/models/mmcorrnmf.py.

A standalone class (not a SignatureNMF subclass) over a MuData of
modalities sharing sample names: per-modality signatures, scalings and
signature embeddings; ONE shared set of sample embeddings and ONE shared
variance. The ELBO sums the per-modality terms and adds the sample penalty
once; the joint sample-embedding M-step concatenates signature embeddings,
scalings and aux across modalities.

Modalities are ragged in (n_features, n_signatures), so the parameters are
a nested dict (engine.tree): {"mods": {name: {signatures,
signature_scalings, sample_scalings, signature_embeddings, exposures}},
"sample_embeddings", "variance"}, and the data is {"X": {name: (D,
V_name)}}. The update cycle loops over the modalities (there are few); its
steps are batched-native: every parameter leaf may carry leading restart
(lane) axes, and with per-lane data (a bootstrap) X carries them too. The
joint sample update is one batched Newton solve over the concatenated
signature axis.

The cycle, in the reference's order:
  1 per-modality sample scalings, 2 exposures, 3 aux, 4 signature
  scalings, 5a per-modality signature embeddings (to convergence), 5b the
  joint sample embeddings (3 Newton steps), 6 the shared variance, 7
  signatures by the KL multiplicative W update at the step-2 exposures.
No kernel: step 7 is update_W at fixed exposures, not the joint W/H step
that the fused KLNMF kernel carries, so the cycle runs as plain PyTorch
ops, like CorrNMFDet's. fit_minibatch is the stochastic (minibatch)
variational EM of ops/svi.py with one shared minibatch across the
modalities. The plot_* methods draw through plot.py.

fit(mesh=) and fit_minibatch(mesh=) shard the shared sample axis: every
modality's counts and the per-sample leaves split once for all modalities,
the joint sample-embedding solve stays rank-local, and a cycle's sums over
the samples take one collective for every modality's signature scalings,
two per signature-side Newton step of each modality, and one for the
variance and every modality's signature update.
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable, Literal

import numpy as np
import pandas as pd
import torch

from .. import containers, profiling, tools as tl
from ..engine import FitConfig, effective_tolerance, make_fit_function
from ..engine.transfer import params_to_numpy
from ..initialization.initialize import EPSILON, initialize_mmcorrnmf
from ..ops import corrnmf as ops
from ..ops import klnmf as klnmf_ops
from ..ops.klnmf import sum_samples
from ..ops.precision import require_ieee_float32
from ..utils import (
    compute_exposures_numpy,
    dict_checker,
    type_checker,
    value_checker,
)
from .corrnmf import _host
from .corrnmf_det import SAMPLE_NEWTON_ITERS, SIGNATURE_NEWTON_ITERS
from .signature_nmf import (
    _DTYPES,
    NEWTON_CG_COMPAT_MINIBATCH,
    SignatureNMF,
    check_fit_mesh,
    check_minibatch_placement,
    gather_sample_leaves,
    host_rows,
    is_integer_counts,
    promote_objective,
    record_minibatch_history,
    resolve_device,
    resolve_dtype,
    run_resident_minibatch,
    sample_blocks,
)

# where the shared sample axis D sits in the fit state, by leaf name (data
# ["X"] holds every modality's (D, V) counts); the rest replicates
_SAMPLE_AXES = (
    {"sample_scalings": 0, "sample_embeddings": 0, "exposures": 0},
    {"X": 0},
)


class MultimodalCorrNMF:
    """Joint correlated NMF over multiple count modalities of the same
    samples, with shared sample embeddings and variance."""

    def __init__(
        self,
        ns_signatures: list[int],
        dim_embeddings: int | None = None,
        init_method: str = "nndsvd",
        min_iterations: int = 500,
        max_iterations: int = 10000,
        conv_test_freq: int = 10,
        tol: float = 1e-7,
        dtype: str | None = None,
        newton_cg_compat: bool = False,
        device=None,
    ):
        self.ns_signatures = list(ns_signatures)
        # opt-in auditing mode (see CorrNMF.newton_cg_compat)
        self.newton_cg_compat = newton_cg_compat
        self.dim_embeddings = (
            int(np.max(ns_signatures)) if dim_embeddings is None
            else dim_embeddings
        )
        self.init_method = init_method
        self.min_iterations = min_iterations
        self.max_iterations = max_iterations
        self.conv_test_freq = conv_test_freq
        self.tol = tol
        self.device = resolve_device(device)
        self.dtype = str(resolve_dtype(dtype, self.device)).removeprefix(
            "torch."
        )
        self.variance = 1.0

        default_names = [f"mod{n}" for n in range(1, len(ns_signatures) + 1)]
        self.mdata = containers.MuData(
            {name: containers.AnnData() for name in default_names}
        )
        self.asignatures = {
            name: containers.AnnData() for name in default_names
        }
        self.history: dict[str, Any] = {}
        self._is_fitted = False
        total = sum(ns_signatures)
        self.signature_correlation = np.full((total, total), np.nan)

    @property
    def _device_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array),
                               dtype=self._device_dtype, device=self.device)

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    @property
    def mod_names(self) -> list[str]:
        return list(self.mdata.mod.keys())

    @property
    def mutation_types(self) -> dict[str, list[str]]:
        return {
            name: list(adata.var_names)
            for name, adata in self.mdata.mod.items()
        }

    @property
    def signature_names(self) -> dict[str, list[str]]:
        return {
            name: list(asigs.obs_names)
            for name, asigs in self.asignatures.items()
        }

    @property
    def sample_names(self) -> list[str]:
        return list(self.mdata.obs_names)

    @property
    def signatures(self) -> dict[str, pd.DataFrame]:
        return {name: asigs.to_df()
                for name, asigs in self.asignatures.items()}

    @property
    def exposures(self) -> dict[str, pd.DataFrame]:
        return {
            name: pd.DataFrame(
                self.mdata[name].obsm["exposures"],
                index=self.sample_names,
                columns=self.asignatures[name].obs_names,
            )
            for name in self.mod_names
        }

    def compute_exposures(self) -> None:
        """Refresh every modality's obsm['exposures'] (host numpy: every
        input is a host array here)."""
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            adata.obsm["exposures"] = compute_exposures_numpy(
                asigs.obs["scalings"],
                adata.obs["scalings"],
                asigs.obsm["embeddings"],
                self.mdata.obsm["embeddings"],
            )

    def compute_reconstruction(self) -> None:
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            adata.obsm["X_reconstructed"] = adata.obsm["exposures"] @ asigs.X

    @property
    def data_reconstructed(self) -> dict[str, pd.DataFrame]:
        if any(
            "X_reconstructed" not in adata.obsm
            for adata in self.mdata.mod.values()
        ):
            self.compute_reconstruction()
        return {
            name: pd.DataFrame(
                adata.obsm["X_reconstructed"],
                index=adata.obs_names,
                columns=adata.var_names,
            )
            for name, adata in self.mdata.mod.items()
        }

    def compute_reconstruction_errors(self) -> None:
        self.compute_exposures()
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            errors = klnmf_ops.samplewise_kl_divergence(
                _host(adata.X.T), _host(asigs.X.T),
                _host(adata.obsm["exposures"].T),
            )
            adata.obs["reconstruction_error"] = errors.numpy()
        self.mdata.update()

    @property
    def reconstruction_errors(self) -> dict[str, float]:
        if any(
            "reconstruction_error" not in self.mdata[name].obs
            for name in self.mod_names
        ):
            self.compute_reconstruction_errors()
        return {
            name: float(np.sum(adata.obs["reconstruction_error"]))
            for name, adata in self.mdata.mod.items()
        }

    @property
    def reconstruction_error(self) -> float:
        return float(np.sum(list(self.reconstruction_errors.values())))

    # ------------------------------------------------------------------ #
    # objective
    # ------------------------------------------------------------------ #
    @property
    def objective(self) -> Literal["minimize", "maximize"]:
        return "maximize"

    def objective_function(self) -> float:
        """The ELBO at the container state (host float64): per-modality
        terms without the sample penalty, which is added once."""
        elbo = 0.0
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            elbo += float(
                ops.elbo_corrnmf(
                    _host(adata.X),
                    _host(asigs.X),
                    _host(adata.obsm["exposures"]),
                    _host(asigs.obsm["embeddings"]),
                    _host(self.mdata.obsm["embeddings"]),
                    float(self.variance),
                    penalize_sample_embeddings=False,
                )
            )
        n_obs = self.mdata.n_obs
        elbo -= (
            0.5 * self.dim_embeddings * n_obs
            * np.log(2 * np.pi * self.variance)
        )
        elbo -= float(
            np.sum(self.mdata.obsm["embeddings"] ** 2) / (2 * self.variance)
        )
        return elbo

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #
    def _setup_mdata(self, mdata, clip_integer_counts: bool = True) -> None:
        if not hasattr(mdata, "mod"):
            type_checker("mdata", mdata, containers.MuData)
        if mdata.n_mod != len(self.ns_signatures):
            raise ValueError(
                f"The data has to have {len(self.ns_signatures)} many "
                "modalities."
            )
        expected = list(list(mdata.mod.values())[0].obs_names)
        for adata in mdata.mod.values():
            if list(adata.obs_names) != expected:
                raise ValueError(
                    "The sample names of the different modalities are not "
                    "identical."
                )
        for adata in mdata.mod.values():
            SignatureNMF._invalidate_derived(adata)
            if clip_integer_counts or not is_integer_counts(adata.X):
                adata.X = adata.X.clip(EPSILON)
        self.mdata = mdata

    def _setup_mdata_streaming(self, mdata) -> None:
        """_setup_mdata for the host-streaming fit: integer-dtype modality
        count matrices stay UNCLIPPED in place (clipping would promote
        compact integer storage to float64; the clip is applied per
        uploaded batch instead - see
        SignatureNMF._setup_adata_streaming)."""
        self._setup_mdata(mdata, clip_integer_counts=False)

    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        init_kwargs = {} if init_kwargs is None else init_kwargs.copy()
        self.asignatures, self.variance = initialize_mmcorrnmf(
            self.mdata,
            self.ns_signatures,
            self.dim_embeddings,
            self.init_method,
            given_parameters,
            **init_kwargs,
        )
        self.compute_exposures()

    # ------------------------------------------------------------------ #
    # engine hooks
    # ------------------------------------------------------------------ #
    def _device_state(self):
        data = {
            "X": {
                name: self._to_device(self.mdata[name].X)  # (D, V_name)
                for name in self.mod_names
            }
        }
        return self._device_params(), data

    def _device_params(self, include_exposures: bool = True):
        """The parameter tree alone, without the counts."""
        mods = {}
        for name in self.mod_names:
            adata, asigs = self.mdata[name], self.asignatures[name]
            mods[name] = {
                "signatures": self._to_device(asigs.X),
                "signature_scalings": self._to_device(
                    np.array(asigs.obs["scalings"], dtype=float)),
                "sample_scalings": self._to_device(
                    np.array(adata.obs["scalings"], dtype=float)),
                "signature_embeddings": self._to_device(
                    asigs.obsm["embeddings"]),
            }
            if include_exposures:
                mods[name]["exposures"] = self._to_device(
                    adata.obsm["exposures"])
        return {
            "mods": mods,
            "sample_embeddings": self._to_device(
                self.mdata.obsm["embeddings"]),
            "variance": torch.tensor(float(self.variance),
                                     dtype=self._device_dtype,
                                     device=self.device),
        }

    def _absorb_params(self, params) -> None:
        """Write a host (numpy) parameter tree back into the containers."""
        for name in self.mod_names:
            mod = params["mods"][name]
            adata, asigs = self.mdata[name], self.asignatures[name]
            asigs.X = np.asarray(mod["signatures"])
            asigs.obs["scalings"] = np.asarray(mod["signature_scalings"])
            adata.obs["scalings"] = np.asarray(mod["sample_scalings"])
            asigs.obsm["embeddings"] = np.asarray(
                mod["signature_embeddings"])
            adata.obsm["exposures"] = np.asarray(mod["exposures"])
        self.mdata.obsm["embeddings"] = np.asarray(
            params["sample_embeddings"])
        self.variance = float(params["variance"])

    def _mod_flags(self, given_parameters) -> dict:
        """Per-modality freeze flags derived from a nested given_parameters
        dict - the single source of truth for which modality parameters a
        fit holds fixed. fix_signatures holds only when ALL of a modality's
        signatures are given; otherwise n_given freezes the leading
        columns inside update_W."""
        given = given_parameters or {}
        flags = {}
        for index, name in enumerate(self.mod_names):
            g = given.get(name, {})
            n_given = g["asignatures"].n_obs if "asignatures" in g else 0
            flags[name] = {
                "n_given": int(n_given),
                "fix_signatures": n_given == self.ns_signatures[index],
                "fix_sig_scalings": "signature_scalings" in g,
                "fix_smp_scalings": "sample_scalings" in g,
                "fix_sig_embeddings": "signature_embeddings" in g,
            }
        return flags

    def _check_warm_start(self, given_parameters) -> None:
        """Validate resumable multimodal state (warm_start=True)."""
        if given_parameters:
            raise ValueError(
                "warm_start=True cannot be combined with given_parameters: "
                "initialization (which warm start skips) is what stitches "
                "given values into the model state."
            )
        try:
            for name in self.mod_names:
                asigs = self.asignatures[name]
                np.asarray(asigs.obs["scalings"])
                np.asarray(asigs.obsm["embeddings"])
                np.asarray(self.mdata[name].obsm["exposures"])
                np.asarray(self.mdata[name].obs["scalings"])
            np.asarray(self.mdata.obsm["embeddings"])
            float(self.variance)
        except (AttributeError, KeyError, TypeError):
            raise ValueError(
                "warm_start=True resumes from the state already in the "
                "model and containers (per-modality signatures/scalings/"
                "exposures + shared embeddings/variance); fit once without "
                "warm_start - or load a saved model - first."
            ) from None

    def _sample_axes(self):
        """Which axis of each leaf of the fit state is the shared sample
        axis, by leaf name (params, data); absent = replicated."""
        return _SAMPLE_AXES

    def _build_step(self, given_parameters=None, reduce_samples=None):
        """The batched-native (update_fn, objective_fn) pair over (params,
        data): every leaf may carry leading lane axes (the variance is then
        (R,)), and data["X"][name] is (D, V) or, per lane, (R, D, V).
        reduce_samples completes the sums over a sample-sharded D."""
        given = given_parameters or {}
        mod_names = self.mod_names
        ns_signatures = self.ns_signatures
        flags = self._mod_flags(given_parameters)
        fix_sample_embeddings = "sample_embeddings" in given
        fix_variance = "variance" in given
        dim = self.dim_embeddings

        def update_fn(params, data):
            profiling.count("mmcorrnmf.cycles")
            mods = {name: dict(params["mods"][name]) for name in mod_names}
            U = params["sample_embeddings"]
            variance = params["variance"]

            # 1+2: per-modality sample scalings, then exposures
            for name in mod_names:
                m, f = mods[name], flags[name]
                if not f["fix_smp_scalings"]:
                    m["sample_scalings"] = ops.update_sample_scalings(
                        data["X"][name],
                        m["signature_scalings"],
                        m["signature_embeddings"],
                        U,
                    )
                m["exposures"] = ops.compute_exposures(
                    m["signature_scalings"], m["sample_scalings"],
                    m["signature_embeddings"], U,
                )

            # 3: per-modality sufficient statistics, (..., K_name, D)
            auxs = {
                name: ops.compute_aux(
                    data["X"][name], mods[name]["signatures"],
                    mods[name]["exposures"],
                )
                for name in mod_names
            }

            # 4: signature scalings (every modality's sums in one call)
            scaled = [name for name in mod_names
                      if not flags[name]["fix_sig_scalings"]]
            sums = list(sum_samples(reduce_samples, *(
                part for name in scaled
                for part in ops.signature_scaling_sums(
                    auxs[name], mods[name]["sample_scalings"],
                    mods[name]["signature_embeddings"], U))))
            for name in scaled:
                observed, predicted = sums.pop(0), sums.pop(0)
                mods[name]["signature_scalings"] = (
                    torch.log(observed) - torch.log(predicted))

            # 5a: per-modality signature embeddings (vs shared samples)
            for name in mod_names:
                m, f = mods[name], flags[name]
                if not f["fix_sig_embeddings"]:
                    m["signature_embeddings"] = ops.update_embeddings(
                        m["signature_embeddings"], U,
                        m["signature_scalings"], m["sample_scalings"],
                        variance, auxs[name],
                        max_iter=SIGNATURE_NEWTON_ITERS,
                        reduce_samples=reduce_samples,
                    )

            # 5b: joint sample embeddings across modalities; everything is
            # concatenated along the signature axis
            if not fix_sample_embeddings:
                sig_embs = torch.cat(
                    [mods[n]["signature_embeddings"] for n in mod_names],
                    dim=-2,
                )  # (..., sum K, m)
                sig_scals = torch.cat(
                    [mods[n]["signature_scalings"] for n in mod_names],
                    dim=-1,
                )
                aux_all = torch.cat(
                    [auxs[n] for n in mod_names], dim=-2
                )  # (..., sum K, D)
                # per-sample scalings repeated per modality signature count
                scalings_mat = torch.cat(
                    [
                        mods[n]["sample_scalings"].unsqueeze(-1).expand(
                            *mods[n]["sample_scalings"].shape,
                            ns_signatures[i])
                        for i, n in enumerate(mod_names)
                    ],
                    dim=-1,
                )  # (..., D, sum K)
                U = ops.update_embeddings(
                    U, sig_embs, scalings_mat, sig_scals, variance,
                    aux_all.mT, max_iter=SAMPLE_NEWTON_ITERS,
                )

            # 6: shared variance over all embeddings, and 7: signatures via
            # the KL multiplicative update (step-2 exposures, old
            # signatures): their sums over D in one call
            updated = [name for name in mod_names
                       if not flags[name]["fix_signatures"]]
            partials = [klnmf_ops.w_numerator(
                data["X"][name].mT, mods[name]["signatures"].mT,
                mods[name]["exposures"].mT) for name in updated]
            if not fix_variance:
                partials += ops.variance_sums(U)
            sums = list(sum_samples(reduce_samples, *partials))
            if not fix_variance:
                all_sig_embs = torch.cat(
                    [mods[n]["signature_embeddings"] for n in mod_names],
                    dim=-2,
                )
                variance = ops.variance_from(all_sig_embs, sums[-2],
                                             sums[-1], U.shape[-1])
            for index, name in enumerate(updated):
                m = mods[name]
                m["signatures"] = klnmf_ops.update_W_from_numerator(
                    m["signatures"].mT, sums[index],
                    flags[name]["n_given"]).mT

            return {
                "mods": mods,
                "sample_embeddings": U,
                "variance": variance,
            }

        def objective_fn(params, data):
            with profiling.span("mmcorrnmf.objective"):
                return elbo(params, data)

        def elbo(params, data):
            U = params["sample_embeddings"]
            variance = params["variance"]
            value = 0.0
            for name in mod_names:
                m = params["mods"][name]
                value = value + ops.elbo_corrnmf(
                    data["X"][name], m["signatures"], m["exposures"],
                    m["signature_embeddings"], U, variance,
                    penalize_sample_embeddings=False,
                    reduce_samples=reduce_samples,
                )
            sample_sq, n_obs = sum_samples(reduce_samples,
                                           *ops.variance_sums(U))
            value = value - 0.5 * dim * n_obs * torch.log(
                2 * torch.pi * variance)
            return value - sample_sq / (2 * variance)

        return update_fn, objective_fn

    def _update_parameters(self, given_parameters=None) -> None:
        """One full joint EM cycle, eagerly (test/inspection surface)."""
        if self.newton_cg_compat:
            self._update_parameters_host(given_parameters)
            return
        params, data = self._device_state()
        update_fn, _ = self._build_step(given_parameters)
        self._absorb_params(params_to_numpy(update_fn(params, data)))

    def _update_parameters_host(self, given_parameters=None) -> None:
        """One full joint EM cycle through the eager reference-named methods
        (the compatibility path: exact reference order, scipy Newton-CG
        embeddings; reference mmcorrnmf.py:443-453)."""
        given = given_parameters or {}
        self.update_sample_scalings(given)
        self.compute_exposures()
        auxs = self._compute_auxs()
        self.update_signature_scalings(auxs, given)
        self.update_embeddings(auxs, given)
        self.update_variance(given)
        self.update_signatures(given)

    # ------------------------------------------------------------------ #
    # eager per-update methods (reference-named test/inspection surface;
    # host float64)
    # ------------------------------------------------------------------ #
    def _compute_auxs(self) -> dict[str, np.ndarray]:
        return {
            name: ops.compute_aux(
                _host(self.mdata[name].X),
                _host(self.asignatures[name].X),
                _host(self.mdata[name].obsm["exposures"]),
            ).numpy()
            for name in self.mod_names
        }

    def update_sample_scalings_mod(
        self, mod_name: str, given_parameters_mod: dict[str, Any]
    ) -> None:
        """One modality's sample-scaling M-step (reference
        mmcorrnmf.py:249-261)."""
        if "sample_scalings" in given_parameters_mod:
            return
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        adata.obs["scalings"] = ops.update_sample_scalings(
            _host(adata.X),
            _host(asigs.obs["scalings"]),
            _host(asigs.obsm["embeddings"]),
            _host(self.mdata.obsm["embeddings"]),
        ).numpy()

    def update_sample_scalings(self, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_sample_scalings_mod(name, given.get(name, {}))

    def update_signature_scalings_mod(
        self, mod_name: str, aux, given_parameters_mod: dict[str, Any]
    ) -> None:
        """One modality's signature-scaling M-step (reference
        mmcorrnmf.py:276-287)."""
        if "signature_scalings" in given_parameters_mod:
            return
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        asigs.obs["scalings"] = ops.update_signature_scalings(
            _host(aux),
            _host(adata.obs["scalings"]),
            _host(asigs.obsm["embeddings"]),
            _host(self.mdata.obsm["embeddings"]),
        ).numpy()

    def update_signature_scalings(self, auxs, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_signature_scalings_mod(
                name, auxs[name], given.get(name, {})
            )

    def _update_side(self, embeddings, embeddings_other, scalings,
                     scalings_other, aux_mat, max_iter):
        """One side's embedding M-step: the batched Newton, or the
        reference's scipy Newton-CG under newton_cg_compat (the signature
        side then runs scipy's default iteration cap)."""
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

    def update_signature_embeddings_mod(
        self,
        mod_name: str,
        aux,
        outer_prods_sample_embeddings=None,
        given_parameters_mod: dict[str, Any] | None = None,
    ) -> None:
        """One modality's signature-embedding M-step (reference
        mmcorrnmf.py:347-366). `outer_prods_sample_embeddings` is accepted
        for signature parity but unused: the reference precomputes the
        scipy Hessian's outer products, while the batched Newton (and the
        compat scipy path) derive everything they need from the other
        arguments."""
        del outer_prods_sample_embeddings
        if "signature_embeddings" in (given_parameters_mod or {}):
            return
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        asigs.obsm["embeddings"] = self._update_side(
            asigs.obsm["embeddings"], self.mdata.obsm["embeddings"],
            asigs.obs["scalings"], adata.obs["scalings"], np.asarray(aux),
            SIGNATURE_NEWTON_ITERS,
        )

    def update_signature_embeddings(self, auxs, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_signature_embeddings_mod(
                name, auxs[name], None, given.get(name, {})
            )

    def update_sample_embeddings(self, auxs) -> None:
        """The joint sample-embedding M-step over the concatenated
        signature axes of all modalities."""
        sig_embs = np.concatenate(
            [asigs.obsm["embeddings"] for asigs in self.asignatures.values()]
        )
        sig_scals = np.concatenate(
            [np.asarray(asigs.obs["scalings"])
             for asigs in self.asignatures.values()]
        )
        aux_all = np.concatenate([auxs[name] for name in self.mod_names])
        scalings_mat = np.concatenate(
            [
                np.tile(
                    np.asarray(self.mdata[name].obs["scalings"])[:, None],
                    (1, k),
                )
                for name, k in zip(self.mod_names, self.ns_signatures)
            ],
            axis=1,
        )
        self.mdata.obsm["embeddings"] = self._update_side(
            self.mdata.obsm["embeddings"], sig_embs, scalings_mat, sig_scals,
            aux_all.T, SAMPLE_NEWTON_ITERS,
        )

    def update_embeddings(self, auxs, given_parameters=None) -> None:
        given = given_parameters or {}
        self.update_signature_embeddings(auxs, given)
        if "sample_embeddings" not in given:
            self.update_sample_embeddings(auxs)

    def update_variance(self, given_parameters=None) -> None:
        given = given_parameters or {}
        if "variance" not in given:
            sig_embs = np.concatenate(
                [asigs.obsm["embeddings"]
                 for asigs in self.asignatures.values()]
            )
            self.variance = float(
                ops.update_variance(
                    _host(sig_embs), _host(self.mdata.obsm["embeddings"]))
            )

    def update_signatures_mod(
        self, mod_name: str, given_parameters_mod: dict[str, Any]
    ) -> None:
        """One modality's KL signature update (reference
        mmcorrnmf.py:319-334)."""
        n_given = (
            given_parameters_mod["asignatures"].n_obs
            if "asignatures" in given_parameters_mod
            else 0
        )
        adata, asigs = self.mdata[mod_name], self.asignatures[mod_name]
        W = klnmf_ops.update_W(
            _host(adata.X.T),
            _host(asigs.X.T),
            _host(adata.obsm["exposures"].T),
            n_given_signatures=n_given,
        )
        asigs.X = W.numpy().T

    def update_signatures(self, given_parameters=None) -> None:
        given = given_parameters or {}
        for name in self.mod_names:
            self.update_signatures_mod(name, given.get(name, {}))

    # ------------------------------------------------------------------ #
    # fit
    # ------------------------------------------------------------------ #
    def _fit_config(self) -> FitConfig:
        return FitConfig(
            min_iterations=self.min_iterations,
            max_iterations=self.max_iterations,
            conv_test_freq=self.conv_test_freq,
            tol=self.tol,
        )

    def fit(
        self,
        mdata,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        verbose: Literal[0, 1] = 0,
        verbosity_freq: int = 100,
        stop_on_nonfinite: bool = False,
        mesh=None,
        warm_start: bool = False,
    ) -> "MultimodalCorrNMF":
        """Fit the joint model on self.device (reference fit loop:
        mmcorrnmf.py:455-491).

        warm_start=True skips initialization and CONTINUES from the state
        already in the model/containers; the convergence rule restarts
        fresh. The convergence objective is evaluated in float64
        (promote_objective).

        mesh (optional): a DeviceMesh with a 'samples' axis
        (parallel.make_mesh) that every rank passes: each rank fits its
        block of the shared samples (every modality's counts and the
        per-sample parameters), the sums over them all-reduced, and the
        per-sample parameters are gathered, so every rank's model equals
        the unsharded fit. Its sample ways must divide the samples.
        """
        sample_ways = 1 if mesh is None else check_fit_mesh(mesh, "fit")
        self._setup_mdata(mdata)
        if warm_start:
            self._check_warm_start(given_parameters)
        else:
            self._initialize(given_parameters, init_kwargs)

        if self.newton_cg_compat:
            if mesh is not None:
                raise ValueError(
                    "mesh= is not available under newton_cg_compat=True: "
                    "the scipy-exact fit loop runs host-side."
                )
            return self._fit_host(given_parameters, history, verbose,
                                  verbosity_freq)
        if self.device.type == "cuda":
            require_ieee_float32()
        params0, data = self._device_state()
        if mesh is not None:
            from ..parallel.mesh import first_rank_copy, samples_reducer

            params0 = first_rank_copy(params0, mesh)
        n_samples = int(self.mdata.n_obs)
        reduce_samples = None
        if sample_ways > 1:
            params0 = sample_blocks(params0, _SAMPLE_AXES[0], mesh,
                                    n_samples)
            data = sample_blocks(data, _SAMPLE_AXES[1], mesh, n_samples)
            reduce_samples = samples_reducer(mesh)
        update_fn, objective_fn = self._build_step(given_parameters,
                                                   reduce_samples)
        objective_fn = promote_objective(objective_fn, params0)
        config = self._fit_config()
        if stop_on_nonfinite:
            config = config._replace(stop_on_nonfinite=True)
        self.history["tol_effective"] = effective_tolerance(
            config, torch.float64, params0
        )
        run = make_fit_function(
            update_fn, objective_fn, config, verbose=bool(verbose),
            verbosity_freq=verbosity_freq,
        )
        result = run(params0, data)
        params = result.params
        if sample_ways > 1:
            params = gather_sample_leaves(params, _SAMPLE_AXES[0], mesh,
                                          n_samples)
        self._absorb_params(params_to_numpy(params))
        if history:
            n_evals = int(result.n_evals)
            self.history["objective_function"] = list(
                result.history[:n_evals].cpu().numpy()
            )
            self.history["n_iterations"] = int(result.n_iterations)
            self.history["step_freq"] = self.conv_test_freq
        self.mdata.update()
        self._is_fitted = True
        return self

    def _fit_host(self, given_parameters, history, verbose,
                  verbosity_freq) -> "MultimodalCorrNMF":
        """The reference's host loop over the scipy-exact update cycle
        (newton_cg_compat)."""
        of_values = [self.objective_function()]
        n_iteration = 0
        converged = False
        while not converged:
            n_iteration += 1
            if verbose and n_iteration % verbosity_freq == 0:
                print(f"iteration: {n_iteration}; "
                      f"objective: {of_values[-1]:.2f}")
            self._update_parameters_host(given_parameters)
            if n_iteration % self.conv_test_freq == 0:
                previous = of_values[-1]
                of_values.append(self.objective_function())
                rel_change = abs(previous - of_values[-1]) / abs(previous)
                converged = (
                    rel_change < self.tol
                    and n_iteration >= self.min_iterations
                )
            converged |= n_iteration >= self.max_iterations
        if history:
            self.history["objective_function"] = of_values[1:]
            self.history["n_iterations"] = n_iteration
            self.history["step_freq"] = self.conv_test_freq
        self.mdata.update()
        self._is_fitted = True
        return self

    def fit_minibatch(
        self,
        mdata,
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
    ) -> "MultimodalCorrNMF":
        """Stochastic (minibatch) variational EM for the multimodal model:
        one shared minibatch of samples drives all modalities per step, with
        the joint sample-embedding solve over the concatenated signature
        axes and Robbins-Monro-averaged per-modality global statistics
        (ops/svi.py). With batch_size >= n_samples (it is clamped), delay=1
        and signature_newton_iters=100, the first step is one full joint EM
        cycle; see CorrNMFDet.fit_minibatch for cost semantics (eval_freq=0
        skips the full-data ELBO evaluations). streaming=True keeps every
        modality's count matrix HOST-resident with per-step minibatch
        uploads, bit-equal to the resident path at the same seed (see
        CorrNMFDet.fit_minibatch / ops/svi.py run_svi_streaming). mesh=
        shards the resident cohort's shared samples, as
        CorrNMFDet.fit_minibatch does; with streaming=True it is
        refused."""
        from ..ops import svi

        check_minibatch_placement(mesh, streaming)
        if self.newton_cg_compat:
            raise ValueError(NEWTON_CG_COMPAT_MINIBATCH)

        if streaming:
            self._setup_mdata_streaming(mdata)
        else:
            self._setup_mdata(mdata)
        self._initialize(given_parameters, init_kwargs)
        if self.device.type == "cuda":
            require_ieee_float32()

        given = given_parameters or {}
        mod_names = self.mod_names
        n_samples = int(self.mdata.n_obs)
        config = svi.SVIConfig(
            batch_size=min(int(batch_size), n_samples),
            forgetting=forgetting, delay=delay,
            signature_newton_iters=signature_newton_iters,
            sample_newton_iters=SAMPLE_NEWTON_ITERS,
        )
        step_kwargs = dict(
            n_samples=n_samples,
            mod_names=mod_names,
            ns_signatures=self.ns_signatures,
            config=config,
            mod_flags=self._mod_flags(given_parameters),
            fix_sample_embeddings="sample_embeddings" in given,
            fix_variance="variance" in given,
        )
        generator = torch.Generator().manual_seed(seed)
        if streaming:
            params = self._device_params(include_exposures=False)
            dtype = np.dtype(self.dtype)
            X_host = {name: self.mdata[name].X for name in mod_names}

            def get_batch(indices):
                return {name: host_rows(X_host[name], indices, dtype)
                        for name in mod_names}

            objective_fn = None
            if eval_freq:
                objective_fn = svi.make_streamed_objective(
                    svi.mm_elbo_stream_chunk, svi.mm_elbo_stream_rest,
                    get_batch, n_samples, chunk_size=eval_chunk,
                )
            state, elbo_trace = svi.run_svi_streaming(
                svi.make_mm_svi_batch_step(**step_kwargs),
                svi.mm_svi_init(params, streaming=True), get_batch,
                n_samples, config.batch_size, generator,
                n_steps, eval_freq, objective_fn,
                refresh_fn=svi.refresh_sample_usq,
            )
            params = state.params
        else:
            params, data = self._device_state()
            params, elbo_trace = run_resident_minibatch(
                svi.make_mm_svi_step, svi.mm_svi_init, svi.mm_full_elbo,
                params, data, lambda d: d["X"], _SAMPLE_AXES, mesh,
                generator, n_steps, eval_freq, who="fit",
                **step_kwargs)
        final = {
            "mods": {},
            "sample_embeddings": params["sample_embeddings"],
            "variance": params["variance"],
        }
        for name in mod_names:
            mod = dict(params["mods"][name])
            mod["exposures"] = ops.compute_exposures(
                mod["signature_scalings"], mod["sample_scalings"],
                mod["signature_embeddings"], final["sample_embeddings"],
            )
            final["mods"][name] = mod
        self._absorb_params(params_to_numpy(final))
        if history:
            record_minibatch_history(self.history, elbo_trace, n_steps,
                                     eval_freq)
        self.mdata.update()
        self._is_fitted = True
        return self

    def transform(self, mdata, **fit_kwargs):
        """Infer sample-side parameters (scalings + shared embeddings) for a
        NEW multimodal cohort under this model's frozen signature-side
        parameters (per-modality signatures, signature scalings and
        signature embeddings, plus the shared variance). Returns the fitted
        projector model, on this model's device; neither `self` nor the
        input container is modified."""
        if not getattr(self, "_is_fitted", False):
            raise ValueError("transform() requires a fitted model.")
        if "given_parameters" in fit_kwargs:
            raise ValueError(
                "transform() freezes this model's signature-side parameters "
                "itself; 'given_parameters' cannot be overridden here - use "
                "fit() directly for custom given parameters."
            )
        from ..io import _HYPERPARAM_KEYS

        # carries dtype and newton_cg_compat into the projector; walk the
        # MRO so user subclasses keep working
        for klass in type(self).__mro__:
            if klass.__name__ in _HYPERPARAM_KEYS:
                hyperparameter_keys = _HYPERPARAM_KEYS[klass.__name__]
                break
        else:
            raise TypeError(
                f"transform() does not know the hyperparameters of "
                f"{type(self).__name__}."
            )
        projector = type(self)(
            **{key: getattr(self, key) for key in hyperparameter_keys},
            device=self.device,
        )
        given: dict[str, Any] = {"variance": float(self.variance)}
        for name in self.mod_names:
            asigs = self.asignatures[name]
            given[name] = {
                "asignatures": asigs.copy(),
                "signature_scalings": np.asarray(
                    asigs.obs["scalings"], dtype=float
                ),
                "signature_embeddings": np.asarray(asigs.obsm["embeddings"]),
            }
        projector.fit(
            mdata.copy() if hasattr(mdata, "copy") else mdata,
            given_parameters=given,
            **fit_kwargs,
        )
        return projector

    # ------------------------------------------------------------------ #
    # analysis + plotting
    # ------------------------------------------------------------------ #
    def compute_correlation(
        self, data: Literal["samples", "signatures"] = "signatures", **kwargs
    ) -> None:
        value_checker("data", data, ["samples", "signatures"])
        for adata in self.mdata.mod.values():
            assert "exposures" in adata.obsm, (
                "Computing the sample or signature correlation "
                "requires fitting the NMF model."
            )
        values = np.concatenate(
            [adata.obsm["exposures"] for adata in self.mdata.mod.values()],
            axis=1,
        )
        if data == "signatures":
            values = values.T
        corr = tl.correlation_numpy(values, **kwargs)
        if data == "samples":
            self.mdata.obsp["X_correlation"] = corr
        else:
            self.signature_correlation = corr

    def correlation(
        self, data: Literal["samples", "signatures"] = "signatures"
    ) -> pd.DataFrame:
        value_checker("data", data, ["samples", "signatures"])
        if data == "samples":
            if "X_correlation" not in self.mdata.obsp:
                self.compute_correlation("samples")
            values, names = self.mdata.obsp["X_correlation"], self.sample_names
        else:
            if np.isnan(self.signature_correlation).all():
                self.compute_correlation("signatures")
            values = self.signature_correlation
            names = sum(self.signature_names.values(), [])
        return pd.DataFrame(values, index=names, columns=names)

    def plot_history(self, outfile: str | None = None, **kwargs):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        if "objective_function" not in self.history:
            raise ValueError(
                "No history available, the model has to be fitted first. "
                "Remember to set 'history' to 'True' when calling 'fit()'."
            )
        if len(self.history["objective_function"]) == 0:
            raise ValueError(
                "The objective trace is empty: fit_minibatch(eval_freq=0) "
                "records no objective values. Refit with eval_freq >= 1 to "
                "plot a history."
            )
        ax = pl.history(
            values=self.history["objective_function"],
            # fit_minibatch traces are spaced by eval_freq, not conv_test_freq
            conv_test_freq=self.history.get("step_freq", self.conv_test_freq),
            **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

    def plot_signatures(
        self,
        colors=None,
        annotate_mutation_types: bool = False,
        figsize: tuple[float, float] | None = None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        colors = {} if colors is None else colors.copy()
        dict_checker("colors", colors, self.mod_names)
        max_n_signatures = int(np.max(self.ns_signatures))
        if figsize is None:
            figsize = (4 * self.mdata.n_mod, max_n_signatures)
        fig, axes = plt.subplots(max_n_signatures, self.mdata.n_mod,
                                 figsize=figsize, squeeze=False)
        for mod_name, axs in zip(self.mod_names, axes.T):
            sigs = self.asignatures[mod_name]
            pl.barplot(
                sigs,
                colors=colors.get(mod_name),
                annotate_vars=annotate_mutation_types,
                axes=axs[: sigs.n_obs],
                **kwargs,
            )
            for ax in axs[sigs.n_obs:]:
                fig.delaxes(ax)
        plt.tight_layout()
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return axes

    def plot_exposures(
        self,
        sample_order=None,
        reorder_signatures: bool = True,
        annotate_samples: bool = True,
        colors=None,
        axes=None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        if axes is None:
            _, axes = plt.subplots(
                self.mdata.n_mod, figsize=(20, 3 * self.mdata.n_mod)
            )
            axes = np.atleast_1d(axes)
        colors = {} if colors is None else colors.copy()
        dict_checker("colors", colors, self.mod_names)
        exposures = self.exposures

        if sample_order is None:
            normalized = pd.concat(
                [df.div(df.sum(axis=1), axis=0) for df in exposures.values()],
                axis=1,
            )
            sample_order = pl.get_obs_order(normalized)

        for n, (mod_name, ax) in enumerate(zip(self.mod_names, axes)):
            annotate = annotate_samples if n == self.mdata.n_mod - 1 else False
            ax = pl.stacked_barplot(
                data=exposures[mod_name],
                obs_order=sample_order,
                reorder_dimensions=reorder_signatures,
                annotate_obs=annotate,
                colors=colors.get(mod_name),
                ax=ax,
                **kwargs,
            )
            ax.set_title(f"{mod_name} signature exposures")
        plt.tight_layout()
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return axes

    def plot_correlation(
        self,
        data: Literal["samples", "signatures"] = "signatures",
        annot: bool | None = None,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        value_checker("data", data, ["samples", "signatures"])
        corr = self.correlation(data=data)
        if annot is None:
            annot = data != "samples"
        clustergrid = pl.correlation_pandas(corr, annot=annot, **kwargs)
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return clustergrid

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
        from .. import plot as pl
        import matplotlib.pyplot as plt

        adatas = list(self.asignatures.values()) + [self.mdata]
        tl.reduce_dimension_multiple(
            adatas=adatas, basis="embeddings", method=method,
            n_components=n_components,
        )
        if self.dim_embeddings <= 2:
            warnings.warn(
                f"The embedding dimension is {self.dim_embeddings}. "
                "The embeddings are plotted without an additional "
                "dimensionality reduction.",
                UserWarning,
            )
            basis = "embeddings"
        else:
            basis = method

        if color is None:
            color = "color_embeddings"
            for asigs in self.asignatures.values():
                asigs.obs[color] = asigs.n_obs * ["black"]
            self.mdata.obs[color] = self.mdata.n_obs * ["#1f77b4"]
        if zorder is None:
            zorder = "zorder_embeddings"
            for asigs in self.asignatures.values():
                asigs.obs[zorder] = asigs.n_obs * [2]
            self.mdata.obs[zorder] = self.mdata.n_obs * [1]
        if annotations is None:
            annotations = sum(self.signature_names.values(), [])

        ax = pl.embedding_multiple(
            adatas=adatas, basis=basis, dimensions=dimensions, color=color,
            zorder=zorder, annotations=annotations, **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax
