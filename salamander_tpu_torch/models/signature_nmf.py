"""Abstract base of the signature NMF models, held against
salamander_tpu/models/signature_nmf.py.

The same constructor hyperparameters, container conventions (exposures in
adata.obsm['exposures'], signatures as a second AnnData) and convergence
rule as the JAX package, with an explicit torch device and dtype: `fit`
hands a params dict of tensors to the block-driven engine.

Concrete models implement the engine hooks:
  _device_state()              -> (params dict, data dict) of tensors
  _build_step(given)           -> (update_fn(params, data),
                                   objective_fn(params, data))
  _block_update_fn(params, data, given)
                               -> the kernel's block update (params, n_steps)
                                  for this fit, or None for the plain update
                                  loop (KLNMF's: ops.cuda_klnmf.klnmf_block)
  _absorb_params(params)       -> write fitted arrays back into the containers

Every family's step functions take `reduce_samples`, so every fit shards
the sample axis over a mesh (`_sample_axes` names the sharded leaves).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Literal

import numpy as np
import pandas as pd
import torch

from .. import containers, tools as tl
from ..engine import FitConfig, effective_tolerance, make_fit_function
from ..engine.transfer import params_to_numpy
from ..engine.tree import (
    by_leaf_name,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from ..initialization.methods import INIT_METHODS
from ..ops.precision import require_ieee_float32
from ..utils import match_signatures_pair, type_checker, value_checker

EPSILON = float(np.finfo(np.float32).eps)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device=None) -> torch.device:
    """None means the current CUDA device; without one it raises, so a
    fit never moves to the CPU unasked (pass device="cpu" for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device found: pass device='cpu' to run "
                         "on the CPU")
    return torch.device("cuda")


def resolve_dtype(dtype, device) -> torch.dtype:
    """Validate and canonicalize a model compute dtype.

    None means float32 on CUDA (the production configuration) and float64
    on the CPU (the configuration the parity tests hold against the JAX
    package under x64).
    """
    if dtype is None:
        return torch.float32 if torch.device(device).type == "cuda" \
            else torch.float64
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(
            f"Unsupported model dtype {dtype!r}: use 'float32' or 'float64'."
        )
    return _DTYPES[name]


def is_integer_counts(X) -> bool:
    """Whether a count matrix is stored in an integer dtype, read WITHOUT
    materializing it (np.asarray on a lazily-backed X would load the whole
    matrix just to inspect it)."""
    x_dtype = getattr(X, "dtype", None)
    if x_dtype is None:
        x_dtype = np.asarray(X).dtype
    return bool(np.issubdtype(x_dtype, np.integer))


def host_rows(X_host, indices, dtype) -> np.ndarray:
    """The rows `indices` of a host count matrix in the fit dtype, clipped
    to the float32 EPSILON: what the streaming fits upload per batch. The
    values equal the resident fit's in-place clip followed by its cast."""
    return np.asarray(X_host[indices], dtype).clip(EPSILON)


MESH_WITH_STREAMING = (
    "mesh= and streaming=True are mutually exclusive: streaming keeps the "
    "counts host-resident and uploads minibatches to ONE device. Shard a "
    "resident fit, or stream unsharded."
)
NEWTON_CG_COMPAT_MINIBATCH = (
    "fit_minibatch does not support newton_cg_compat=True: the scipy-exact "
    "host path has no minibatch twin, so compat-mode audit traces would "
    "silently get device-Newton numerics. Use fit() for auditable traces."
)


def check_minibatch_placement(mesh, streaming: bool) -> None:
    """The mesh= rule shared by every fit_minibatch: the JAX package's
    refusal of a mesh with streaming (a mesh alone shards the resident
    cohort's samples)."""
    if mesh is not None and streaming:
        raise ValueError(MESH_WITH_STREAMING)


def check_fit_mesh(mesh, who: str = "model.fit") -> int:
    """The sample ways of a fit's mesh=: a DeviceMesh with a 'samples'
    axis (the JAX package's message otherwise)."""
    from ..parallel.mesh import SAMPLE_AXIS, axis_size, check_mesh

    check_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if SAMPLE_AXIS not in names:
        raise ValueError(
            f"mesh has axes {names}; {who} expects a "
            f"'{SAMPLE_AXIS}' axis (parallel.make_mesh(sample_ways=...))."
        )
    return axis_size(mesh, SAMPLE_AXIS)


def sample_blocks(tree: dict, axes: dict, mesh, n_samples: int) -> dict:
    """This rank's block of the samples of every leaf of `tree` that `axes`
    names (leaf name -> its sample axis); the other leaves as they are."""
    from ..parallel.mesh import sample_range

    lo, hi = sample_range(n_samples, mesh)

    def block(path, leaf):
        axis = by_leaf_name(path, axes)
        if axis is None:
            return leaf
        return leaf.narrow(axis, lo, hi - lo).contiguous()

    return tree_unflatten({path: block(path, leaf)
                           for path, leaf in tree_flatten(tree).items()})


def gather_sample_leaves(tree: dict, axes: dict, mesh,
                         n_samples: int) -> dict:
    """The whole samples of every leaf of `tree` that `axes` names, from
    every rank's sample_blocks (parallel.mesh.gather_samples)."""
    from ..parallel.mesh import gather_samples

    def whole(path, leaf):
        axis = by_leaf_name(path, axes)
        if axis is None:
            return leaf
        return gather_samples(leaf, mesh, n_samples, axis)

    return tree_unflatten({path: whole(path, leaf)
                           for path, leaf in tree_flatten(tree).items()})


def run_resident_minibatch(make_step, init, objective, params, data,
                           data_of, sample_axes, mesh, generator,
                           n_steps: int, eval_freq: int,
                           who: str = "model.fit", **step_kwargs):
    """ops.svi.run_svi over a device-resident cohort: the step of
    make_step(**step_kwargs), the state init(params), the recorded
    objective(params, data, reduce_samples), data_of(data) the step's data.
    Under a mesh with more than one sample way each rank runs on its block
    of the step_kwargs["n_samples"] samples (sample_axes, as _sample_axes
    names them) and the per-sample parameters are gathered. Returns
    (params, trace)."""
    from ..ops import svi
    from ..parallel.mesh import first_rank_copy, sample_range, samples_reducer

    n_samples = step_kwargs["n_samples"]

    sample_block = reduce_samples = None
    if mesh is not None:
        params = first_rank_copy(params, mesh)
    if mesh is not None and check_fit_mesh(mesh, who) > 1:
        params = sample_blocks(params, sample_axes[0], mesh, n_samples)
        data = sample_blocks(data, sample_axes[1], mesh, n_samples)
        sample_block = sample_range(n_samples, mesh)
        reduce_samples = samples_reducer(mesh)
    state = init(params)
    if reduce_samples is not None:
        state = svi.shard_state(state, n_samples, reduce_samples)
    state, trace = svi.run_svi(
        make_step(sample_block=sample_block, reduce_samples=reduce_samples,
                  **step_kwargs),
        state, data_of(data), generator, n_steps, eval_freq,
        elbo_fn=lambda p, x: objective(p, x, reduce_samples))
    params = state.params
    if reduce_samples is not None:
        params = gather_sample_leaves(params, sample_axes[0], mesh,
                                      n_samples)
    return params, trace


def record_minibatch_history(history: dict, trace, n_steps: int,
                             eval_freq: int) -> None:
    """Write a fit_minibatch trace (a device tensor, fetched here once)."""
    history["objective_function"] = list(trace.cpu().numpy())
    history["n_iterations"] = int(n_steps)
    # evaluations are eval_freq steps apart
    history["step_freq"] = int(eval_freq)


def cast_floating(tree: dict, dtype) -> dict:
    """Cast every floating tensor of a (nested) dict to `dtype`."""
    return tree_map(
        lambda leaf: leaf.to(dtype) if leaf.dtype.is_floating_point else leaf,
        tree,
    )


def promote_objective(objective_fn, params0):
    """Evaluate the convergence objective in float64 regardless of the
    update dtype.

    With float32 updates the objective's own resolution (~1e-7 relative)
    sits at the default convergence tolerance; measuring it in float64
    restores a meaningful convergence test at the cost of one upcast every
    conv_test_freq iterations. Mirrors the JAX package under x64; the
    engine still floors the tolerance at the float32 parameters'
    resolution (engine.tolerance_floor).
    """
    if all(leaf.dtype == torch.float64 for leaf in tree_leaves(params0)
           if leaf.dtype.is_floating_point):
        return objective_fn

    def objective_fn_f64(params, data):
        return objective_fn(
            cast_floating(params, torch.float64),
            cast_floating(data, torch.float64),
        )

    return objective_fn_f64


def segment_progress_printer():
    """The verbose=1 printer of segmented (compacting) multi-start fits:
    one line per segment, from the summary dict the runner passes
    (parallel.compaction.CompactingRunner.progress). Single-lane fits
    print the reference's 'iteration: N; objective: X' form."""
    def progress_cb(info):
        if info["n_lanes"] == 1:
            print(
                f"iteration: {info['iteration']}; objective: "
                f"{info['objective_min']:.2f}", flush=True,
            )
        else:
            print(
                f"iteration: {info['iteration']}; objective "
                f"range: [{info['objective_min']:.2f}, "
                f"{info['objective_max']:.2f}]; lanes alive: "
                f"{info['n_alive']}/{info['n_lanes']}", flush=True,
            )
    return progress_cb


class SignatureNMF(ABC):
    """Shared structure of all NMF models used for signature analysis."""

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
        value_checker("init_method", init_method, INIT_METHODS)
        self.n_signatures = n_signatures
        self.init_method = init_method
        self.min_iterations = min_iterations
        self.max_iterations = max_iterations
        self.conv_test_freq = conv_test_freq
        self.tol = tol
        self.device = resolve_device(device)
        # compute dtype of the fit; the convergence objective is promoted
        # to float64 (promote_objective)
        self.dtype = str(resolve_dtype(dtype, self.device)).removeprefix(
            "torch."
        )

        self.adata = containers.AnnData()
        self.asignatures = containers.AnnData()
        self.history: dict[str, Any] = {}
        self._is_fitted = False

    @property
    def _device_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array),
                               dtype=self._device_dtype, device=self.device)

    # ------------------------------------------------------------------ #
    # container views
    # ------------------------------------------------------------------ #
    @property
    def mutation_types(self) -> list[str]:
        return list(self.adata.var_names)

    @property
    def signature_names(self) -> list[str]:
        return list(self.asignatures.obs_names)

    @property
    def sample_names(self) -> list[str]:
        return list(self.adata.obs_names)

    @property
    def signatures(self) -> pd.DataFrame:
        return self.asignatures.to_df()

    @property
    def exposures(self) -> pd.DataFrame:
        if "exposures" not in self.adata.obsm:
            raise ValueError(
                "Learning the sample exposures requires fitting the NMF model."
            )
        return pd.DataFrame(
            self.adata.obsm["exposures"],
            index=self.sample_names,
            columns=self.signature_names,
        )

    def compute_reconstruction(self) -> None:
        self.adata.obsm["X_reconstructed"] = (
            self.adata.obsm["exposures"] @ self.asignatures.X
        )

    @property
    def data_reconstructed(self) -> pd.DataFrame:
        if "X_reconstructed" not in self.adata.obsm:
            self.compute_reconstruction()
        return pd.DataFrame(
            self.adata.obsm["X_reconstructed"],
            index=self.sample_names,
            columns=self.mutation_types,
        )

    @abstractmethod
    def compute_reconstruction_errors(self) -> None:
        """Store per-sample reconstruction errors in adata.obs."""

    @property
    def reconstruction_error(self) -> float:
        if "reconstruction_error" not in self.adata.obs:
            self.compute_reconstruction_errors()
        return float(np.sum(self.adata.obs["reconstruction_error"]))

    # ------------------------------------------------------------------ #
    # abstract model interface
    # ------------------------------------------------------------------ #
    @property
    @abstractmethod
    def objective(self) -> Literal["minimize", "maximize"]:
        """Whether the objective function is minimized or maximized."""

    @abstractmethod
    def objective_function(self) -> float:
        """The objective value at the current container state."""

    @abstractmethod
    def _initialize(self, given_parameters=None, init_kwargs=None) -> None:
        """Initialize all model parameters into the containers."""

    @abstractmethod
    def _setup_fitting_parameters(self, fitting_kwargs=None) -> None:
        """Prepare additional fit-time parameters (e.g. loss weights)."""

    @abstractmethod
    def _device_state(self):
        """Return (params dict, data dict) of tensors for the engine."""

    @abstractmethod
    def _build_step(self, given_parameters=None, reduce_samples=None):
        """Return (update_fn, objective_fn) over (params, data); under a
        sample-sharded mesh reduce_samples completes every sum over D."""

    def _block_update_fn(self, params, data, given_parameters=None,
                         sample_sharded: bool = False):
        """The kernel's block update (params, n_steps) -> params for a fit
        of `params` on `data`, bound to `data`, or None to run the plain
        update loop."""
        return None

    @abstractmethod
    def _absorb_params(self, params) -> None:
        """Write fitted host params back into the containers."""

    @abstractmethod
    def plot_embeddings(self, **kwargs):
        """Plot a 2D view of the model's sample (and signature) embeddings."""

    # ------------------------------------------------------------------ #
    # fitting
    # ------------------------------------------------------------------ #
    @staticmethod
    def _invalidate_derived(adata) -> None:
        """Drop lazily-derived caches a new fit invalidates
        (reconstruction errors and the reconstructed matrix of an earlier
        fit on the same container)."""
        if hasattr(adata.obs, "drop"):
            adata.obs.drop(columns=["reconstruction_error"],
                           errors="ignore", inplace=True)
        adata.obsm.pop("X_reconstructed", None)

    def _setup_adata(self, adata) -> None:
        """Validate the count container and clip zeros (EPSILON floor)."""
        if not hasattr(adata, "obsm") or not hasattr(adata, "X"):
            type_checker("adata", adata, containers.AnnData)
        self.adata = adata
        self._invalidate_derived(self.adata)
        self.adata.X = self.adata.X.clip(EPSILON)

    def _setup_adata_streaming(self, adata) -> None:
        """Container setup for the host-streaming fit path.

        Float count matrices get the normal in-place EPSILON clip (so the
        streaming fit is bit-equal to the resident one). Integer count
        matrices are left UNTOUCHED - clipping would silently promote a
        compact uint16/int32 cohort to float64, multiplying host memory by
        4-8x at exactly the scale this path exists for; the clip is applied
        per uploaded batch instead (identical values: integer counts cast
        exactly to the fit dtype and EPSILON only lifts zeros)."""
        if not hasattr(adata, "obsm") or not hasattr(adata, "X"):
            type_checker("adata", adata, containers.AnnData)
        self.adata = adata
        self._invalidate_derived(self.adata)
        if not is_integer_counts(adata.X):
            self.adata.X = self.adata.X.clip(EPSILON)

    def _update_parameters(self, given_parameters=None) -> None:
        """Apply one update cycle eagerly (test/inspection path)."""
        params, data = self._device_state()
        update_fn, _ = self._build_step(given_parameters)
        self._absorb_params(params_to_numpy(update_fn(params, data)))

    def _fit_config(self) -> FitConfig:
        return FitConfig(
            min_iterations=self.min_iterations,
            max_iterations=self.max_iterations,
            conv_test_freq=self.conv_test_freq,
            tol=self.tol,
        )

    # ------------------------------------------------------------------ #
    # sample-axis sharding of a single fit
    # ------------------------------------------------------------------ #
    def _sample_axes(self):
        """Which axis of each _device_state leaf carries the sample (D)
        dimension, keyed by leaf name; absent = replicated. The StandardNMF
        layout in kernel orientation: W (V, K) replicated, H (K, D) and
        X (V, D) on their trailing axis, per-sample weights on axis 0."""
        return (
            {"H": 1},                                        # params
            {"X": 1, "weights_kl": 0, "weights_lhalf": 0},   # data
        )

    def _local_state(self, params, data, mesh):
        """This rank's block of the samples of every leaf _sample_axes
        names (the counterpart of the JAX package's _shard_state)."""
        param_axes, data_axes = self._sample_axes()
        n_samples = int(self.adata.n_obs)
        return (sample_blocks(params, param_axes, mesh, n_samples),
                sample_blocks(data, data_axes, mesh, n_samples))

    def _check_warm_start(self, given_parameters) -> None:
        """Validate that the model/container pair carries a previous fit's
        state to resume from (warm_start=True skips initialization)."""
        if given_parameters:
            raise ValueError(
                "warm_start=True cannot be combined with given_parameters: "
                "initialization (which warm start skips) is what stitches "
                "given values into the model state. Freeze parameters on a "
                "cold fit instead."
            )
        asignatures = getattr(self, "asignatures", None)
        exposures = self.adata.obsm.get("exposures") \
            if hasattr(self.adata, "obsm") else None
        if asignatures is None or exposures is None:
            raise ValueError(
                "warm_start=True resumes from the signatures and exposures "
                "already in the model and container; fit once without "
                "warm_start first."
            )
        if (asignatures.n_obs != self.n_signatures
                or asignatures.n_vars != self.adata.n_vars
                or np.shape(exposures) != (self.adata.n_obs,
                                           self.n_signatures)):
            raise ValueError(
                "warm_start=True found state of the wrong shape: expected "
                f"signatures ({self.n_signatures}, {self.adata.n_vars}) "
                f"and exposures ({self.adata.n_obs}, {self.n_signatures}); "
                f"got signatures {asignatures.shape} and exposures "
                f"{np.shape(exposures)}."
            )

    def fit(
        self,
        adata,
        given_parameters: dict[str, Any] | None = None,
        init_kwargs: dict[str, Any] | None = None,
        fitting_kwargs: dict[str, Any] | None = None,
        history: bool = True,
        verbose: Literal[0, 1] = 0,
        verbosity_freq: int = 1000,
        stop_on_nonfinite: bool = False,
        mesh=None,
        warm_start: bool = False,
    ) -> "SignatureNMF":
        """Fit all model parameters on self.device.

        given_parameters holds a-priori known parameters to freeze,
        init_kwargs feeds the initializer (e.g. seed), fitting_kwargs feeds
        _setup_fitting_parameters (e.g. KLNMF loss weights).
        stop_on_nonfinite additionally fails fast if the objective becomes
        NaN/Inf. warm_start=True skips initialization and continues from
        the state already in the model/container; the convergence rule
        restarts fresh. Models with `_fits_on_host` set (CorrNMF's
        newton_cg_compat) run the reference's host loop (`_fit_host`).

        mesh (optional): a DeviceMesh with a 'samples' axis
        (parallel.make_mesh) that every rank passes. Each rank then fits
        its block of the samples, the sums over D all-reduced over the
        axis (plain updates: the kernel sums over all of D), and the
        fitted per-sample parameters are gathered, so every rank's model
        equals the unsharded fit. The mesh's sample ways must divide the
        samples. With one sample way every rank does the whole fit.
        """
        sample_ways = 1 if mesh is None else check_fit_mesh(mesh)
        self._setup_adata(adata)
        if warm_start:
            self._check_warm_start(given_parameters)
        else:
            self._initialize(given_parameters, init_kwargs)
        self._setup_fitting_parameters(fitting_kwargs)

        if getattr(self, "_fits_on_host", False):
            if mesh is not None:
                raise ValueError(
                    "mesh= is not available in host-loop compatibility "
                    "modes (newton_cg_compat): the fit runs host-side."
                )
            return self._fit_host(
                given_parameters, history, verbose, verbosity_freq
            )
        if self.device.type == "cuda":
            require_ieee_float32()
        params0, data = self._device_state()
        if mesh is not None:
            from ..parallel.mesh import first_rank_copy, samples_reducer

            params0 = first_rank_copy(params0, mesh)
        step_kwargs = {}
        if sample_ways > 1:
            params0, data = self._local_state(params0, data, mesh)
            step_kwargs["reduce_samples"] = samples_reducer(mesh)
        update_fn, objective_fn = self._build_step(given_parameters,
                                                   **step_kwargs)
        block_update_fn = self._block_update_fn(
            params0, data, given_parameters, sample_sharded=sample_ways > 1)
        objective_fn = promote_objective(objective_fn, params0)
        config = self._fit_config()
        if stop_on_nonfinite:
            config = config._replace(stop_on_nonfinite=True)
        # the tolerance the engine enforces (promote_objective makes every
        # objective float64), recorded so it is auditable post-fit
        self.history["tol_effective"] = effective_tolerance(
            config, torch.float64, params0
        )

        run = make_fit_function(
            update_fn, objective_fn, config, verbose=bool(verbose),
            verbosity_freq=verbosity_freq, block_update_fn=block_update_fn,
        )
        result = run(params0, data)
        params = result.params
        if sample_ways > 1:
            params = gather_sample_leaves(params, self._sample_axes()[0],
                                          mesh, int(self.adata.n_obs))
        self._absorb_params(params_to_numpy(params))
        if history:
            n_evals = int(result.n_evals)
            self.history["objective_function"] = list(
                result.history[:n_evals].cpu().numpy()
            )
            self.history["n_iterations"] = int(result.n_iterations)
            self.history["step_freq"] = self.conv_test_freq
        self._is_fitted = True
        return self

    def _fit_host(self, given_parameters=None, history: bool = True,
                  verbose: int = 0, verbosity_freq: int = 1000,
                  ) -> "SignatureNMF":
        """The reference's host fit loop, for compatibility modes whose
        per-iteration updates run host-side (CorrNMF's newton_cg_compat).
        Semantics: reference signature_nmf.py:315-385."""
        # host loops run float64 throughout: the user's tol is enforced
        self.history["tol_effective"] = float(self.tol)
        of_values = [self.objective_function()]
        n_iteration = 0
        converged = False
        while not converged:
            n_iteration += 1
            if verbose and n_iteration % verbosity_freq == 0:
                print(f"iteration: {n_iteration}; "
                      f"objective: {of_values[-1]:.2f}")
            self._update_parameters(given_parameters)
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
        self._is_fitted = True
        return self

    # ------------------------------------------------------------------ #
    # analysis
    # ------------------------------------------------------------------ #
    def reorder(self, asignatures_other, metric: str = "cosine",
                keep_names: bool = False) -> None:
        """Permute this model's signatures to best match another collection
        (Hungarian assignment on pairwise distances)."""
        names = self.asignatures.obs_names
        order = match_signatures_pair(
            asignatures_other.to_df(), self.asignatures.to_df(), metric=metric
        )
        self.asignatures = self.asignatures[order, :].copy()
        self.adata.obsm["exposures"] = self.adata.obsm["exposures"][:, order]
        if not keep_names:
            self.asignatures.obs_names = names

    def compute_correlation(
        self, data: Literal["samples", "signatures"] = "signatures", **kwargs
    ) -> None:
        value_checker("data", data, ["samples", "signatures"])
        if "exposures" not in self.adata.obsm:
            raise ValueError(
                "Computing the sample or signature correlation "
                "requires fitting the NMF model."
            )
        values = self.adata.obsm["exposures"]
        if data == "signatures":
            values = values.T
        corr = tl.correlation_numpy(values, **kwargs)
        if data == "samples":
            self.adata.obsp["X_correlation"] = corr
        else:
            self.asignatures.obsp["correlation"] = corr

    def correlation(
        self, data: Literal["samples", "signatures"] = "signatures"
    ) -> pd.DataFrame:
        value_checker("data", data, ["samples", "signatures"])
        if data == "samples":
            if "X_correlation" not in self.adata.obsp:
                self.compute_correlation("samples")
            values, names = self.adata.obsp["X_correlation"], self.sample_names
        else:
            if "correlation" not in self.asignatures.obsp:
                self.compute_correlation("signatures")
            values, names = (self.asignatures.obsp["correlation"],
                             self.signature_names)
        return pd.DataFrame(values, index=names, columns=names)

    # ------------------------------------------------------------------ #
    # plotting wrappers (host-side; implementations in plot.py, which
    # needs matplotlib and seaborn and is imported only here)
    # ------------------------------------------------------------------ #
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

    def plot_signatures(self, annotate_mutation_types: bool = False,
                        outfile: str | None = None, **kwargs):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        axes = pl.barplot(
            self.asignatures, annotate_vars=annotate_mutation_types, **kwargs
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return axes

    def plot_exposures(
        self,
        sample_order: np.ndarray | None = None,
        reorder_signatures: bool = True,
        annotate_samples: bool = True,
        outfile: str | None = None,
        **kwargs,
    ):
        from .. import plot as pl
        import matplotlib.pyplot as plt

        ax = pl.stacked_barplot(
            data=self.exposures,
            obs_order=sample_order,
            reorder_dimensions=reorder_signatures,
            annotate_obs=annotate_samples,
            **kwargs,
        )
        if outfile is not None:
            plt.savefig(outfile, bbox_inches="tight")
        return ax

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
