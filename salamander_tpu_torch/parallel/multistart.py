"""Batched multi-start over a model, held against
salamander_tpu/parallel/multistart.py.

fit_best_of runs the restarts of one model as one lockstep batch: the
per-restart initial parameters are stacked on a leading lane axis, the
model's own batched-native (update, objective) step functions drive the
convergence engine, and the best restart (by the model's objective
direction) is absorbed back into the model's containers. A KLNMF block
runs through the model's kernel block (SignatureNMF._block_update_fn:
the CUDA kernel where ops.cuda_klnmf.klnmf_block gives it).

Every family is batched: KLNMF, MvNMF, ARDNMF, CorrNMFDet and
MultimodalCorrNMF, whose parameters are a nested dict (engine.tree) and
whose data container is a MuData. The JAX package's runner cache exists to
avoid recompiles; nothing is compiled here, so there is none.

Under a (restarts, samples) mesh (parallel/mesh.py) every rank draws the
whole params0, runs its block of the lanes (and of the samples, whose sums
the family's step functions complete with reduce_samples) and gathers the
rest, so every rank absorbs the same best restart.

A call of fit_best_of is the root span ``multistart.fit_best_of`` of the
program's record (profiling.py).
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import profiling
from ..engine import FitResult, effective_tolerance
from ..engine.transfer import params_to_numpy
from ..engine.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .compaction import (
    CompactingRunner,
    lane_shards,
    lockstep_fit,
    on_mesh,
    plain_block_builder,
    resolve_compact,
)
from .mesh import (
    SAMPLE_AXIS,
    axis_size,
    check_divides,
    mesh_meta,
    open_store,
    samples_reducer,
)

# the families fit_best_of batches; each has a device-side batched
# 'random' initializer
PORTED_FAMILIES = ("KLNMF", "MvNMF", "ARDNMF", "CorrNMFDet",
                   "MultimodalCorrNMF")


class MultiStartSummary(NamedTuple):
    losses: np.ndarray        # (R,) final objective per restart
    n_iterations: np.ndarray  # (R,)
    best_index: int
    history: np.ndarray       # (R, max_evals) objective traces (NaN-padded)
    n_evals: np.ndarray       # (R,)
    signatures: Any = None    # (R, n_features, k) every restart's W
    # ({mod: stack} for MultimodalCorrNMF)


def _signature_stack(params) -> Any:
    """Every restart's signature matrix as (R, n_features, k): W/H families
    store W as (R, V, K); CorrNMF stores signatures as (R, K, V) rows;
    MultimodalCorrNMF nests them per modality, {mod: (R, V_mod, K_mod)}."""
    if "W" in params:
        return params["W"].cpu().numpy()
    if "mods" in params:
        return {name: mod["signatures"].mT.cpu().numpy()
                for name, mod in params["mods"].items()}
    return params["signatures"].mT.cpu().numpy()


def _is_multimodal(model) -> bool:
    return hasattr(model, "mdata") and not hasattr(model, "adata")


def _check_family(model) -> None:
    name = type(model).__name__
    if name not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"fit_best_of: the {name} family is not ported to PyTorch yet "
            f"(ported: {', '.join(PORTED_FAMILIES)})"
        )


def _device_init_batch(model, data, n_restarts: int, base_seed: int):
    """The batched params0 drawn on data["X"]'s device from a
    torch.Generator seeded with base_seed (no host loop, no global numpy
    RNG). MvNMF lanes start at gamma = 1; ARDNMF lanes are rebalanced with
    their closed-form lambda (ops.ardnmf.init_params)."""
    from ..initialization.methods import (
        corrnmf_init_batch,
        mm_corrnmf_init_batch,
        random_init_batch,
    )

    name = type(model).__name__
    generator = torch.Generator(device=model.device).manual_seed(base_seed)
    if name == "MultimodalCorrNMF":  # X is {mod: (D, V_mod)}
        return mm_corrnmf_init_batch(
            generator, data["X"], model.mod_names, model.ns_signatures,
            model.dim_embeddings, n_restarts)
    X = data["X"]
    if name == "CorrNMFDet":  # X is (D, V), samples as rows
        return corrnmf_init_batch(generator, X, model.n_signatures,
                                  model.dim_embeddings, n_restarts, X.dtype)
    # (V, D) kernel orientation
    W0, H0 = random_init_batch(generator, X, model.n_signatures, n_restarts,
                               X.dtype)
    if name == "ARDNMF":
        from ..ops.ardnmf import init_params

        return init_params(W0, H0, data["ard_ab"], model.prior)
    params = {"W": W0, "H": H0}
    if name == "MvNMF":
        params["gamma"] = torch.ones(n_restarts, dtype=X.dtype,
                                     device=X.device)
    return params


def _host_init_batch(model, n_restarts: int, base_seed: int,
                     given_parameters, init_kwargs, fitting_kwargs,
                     seeds_init_kwargs: bool):
    """The model's own initializer once per restart r, with the global
    numpy RNG reseeded to base_seed + r (and restored afterwards), stacked
    on a leading lane axis. Returns (params0, data)."""
    params_per_restart = []
    data = None
    rng_state = np.random.get_state()
    try:
        for restart in range(n_restarts):
            seed = base_seed + restart
            np.random.seed(seed)
            kwargs = dict(init_kwargs)
            if seeds_init_kwargs:
                kwargs["seed"] = seed
            model._initialize(given_parameters, kwargs)
            if hasattr(model, "_setup_fitting_parameters"):
                model._setup_fitting_parameters(fitting_kwargs)
            params_r, data = model._device_state()
            params_per_restart.append(params_r)
    finally:
        np.random.set_state(rng_state)
    params0 = tree_map(lambda *leaves: torch.stack(leaves),
                       *params_per_restart)
    return params0, data


def _best_of_store(checkpoint_dir, model, n_restarts: int, base_seed: int,
                   config, restart_chunk, mesh=None):
    """ChunkStore for a fit_best_of run: identity = counts (+ weights)
    fingerprint (every modality's counts, in mod_names order, for
    MultimodalCorrNMF), model class + constructor hyperparameters
    (CorrNMF's embedding dimension, ARDNMF's prior, a and resolved b
    included), compute dtype, MvNMF's line-search trial batch, restart
    layout, mesh (a mesh.MeshStore under one)."""
    from ..checkpoint import data_fingerprint

    if _is_multimodal(model):
        arrays = [np.asarray(model.mdata[name].X)
                  for name in model.mod_names]
    else:
        arrays = [np.asarray(model.adata.X)]
        for weights_name in ("weights_kl", "weights_lhalf"):
            weights = getattr(model, weights_name, None)
            if weights is not None:
                arrays.append(np.asarray(weights))
    trial_batch = (model._resolve_trial_batch()
                   if hasattr(model, "_resolve_trial_batch") else None)
    return open_store(checkpoint_dir, {
        "task": "fit_best_of",
        "model": type(model).__name__,
        "n_signatures": getattr(model, "n_signatures", None),
        "ns_signatures": getattr(model, "ns_signatures", None),
        "lam": getattr(model, "lam", None),
        "delta": getattr(model, "delta", None),
        "dim_embeddings": getattr(model, "dim_embeddings", None),
        "prior": getattr(model, "prior", None),
        "a": getattr(model, "a", None),
        "b": getattr(model, "b_resolved_", None),
        "init_method": model.init_method,
        "dtype": model.dtype,
        "line_search_trial_batch": trial_batch,
        "n_restarts": int(n_restarts),
        "base_seed": int(base_seed),
        "config": list(config),
        "restart_chunk": (
            None if restart_chunk is None else int(restart_chunk)
        ),
        "mesh": mesh_meta(mesh),
        "data": data_fingerprint(*arrays),
    }, mesh)


def _result_to_entry(result: FitResult, losses) -> dict:
    """A chunk's (FitResult, losses) as npz-ready host arrays; parameter
    leaves are named "p_" + their path in the tree (a flat family's key)."""
    payload = {
        "losses": losses.cpu().numpy(),
        "initial_objective": result.initial_objective.cpu().numpy(),
        "history": result.history.cpu().numpy(),
        "n_evals": result.n_evals.cpu().numpy(),
        "n_iterations": result.n_iterations.cpu().numpy(),
    }
    for path, leaf in tree_flatten(params_to_numpy(result.params)).items():
        payload[f"p_{path}"] = leaf
    return payload


def _entry_to_result(entry: dict, device):
    """The (FitResult, losses) chunk of a stored entry, on `device`."""
    def tensor(name):
        return torch.as_tensor(entry[name], device=device)

    params = tree_unflatten({name[2:]: tensor(name) for name in entry
                             if name.startswith("p_")})
    result = FitResult(
        params=params,
        initial_objective=tensor("initial_objective"),
        history=tensor("history"),
        n_evals=tensor("n_evals"),
        n_iterations=tensor("n_iterations"),
    )
    return result, tensor("losses")


def _concat_results(parts):
    if len(parts) == 1:
        return parts[0]
    results = [part[0] for part in parts]
    result = FitResult(
        params=tree_map(lambda *leaves: torch.cat(leaves),
                        *[r.params for r in results]),
        **{field: torch.cat([getattr(r, field) for r in results])
           for field in ("initial_objective", "history", "n_evals",
                         "n_iterations")},
    )
    return result, torch.cat([part[1] for part in parts])


@profiling.entry("multistart.fit_best_of")
def fit_best_of(
    model,
    data_container,
    n_restarts: int,
    base_seed: int = 0,
    given_parameters: dict[str, Any] | None = None,
    init_kwargs: dict[str, Any] | None = None,
    fitting_kwargs: dict[str, Any] | None = None,
    mesh=None,
    batched_init: bool | str = "auto",
    compact: bool | None = None,
    compact_min_bucket: int = 4,
    checkpoint_dir=None,
    restart_chunk: int | None = None,
    verbose: int = 0,
) -> MultiStartSummary:
    """Fit `n_restarts` differently-initialized copies of `model` at once and
    keep the best.

    The model's init_method should be stochastic ('random', 'separableNMF'
    or 'nndsvdar', or any CorrNMF init, whose embeddings are random);
    restart r is seeded with base_seed + r. The model ends
    up holding the best restart's parameters (and its objective trace in
    .history); the full loss table is returned. Everything runs on
    model.device.

    batched_init: with 'auto' (default), init_method='random' without
    given_parameters draws every restart at once on the model's device
    from a torch.Generator seeded with base_seed; other configurations run
    the model's own initializer in a host loop (reseeding the global
    numpy RNG per restart and restoring it afterwards), whose draws equal
    the JAX package's. True forces the device path (raises if
    unsupported), False forces the host loop.

    compact (None = auto, parallel.compaction.resolve_compact): lane
    compaction - as restarts converge they drop out of the batch in
    halving steps. Per-lane results equal the monolithic loop's.

    checkpoint_dir: preemption-safe resume (checkpoint.ChunkStore).
    Restarts run in chunks of `restart_chunk` lanes (default: one chunk)
    and each completed chunk is one atomic entry; a rerun with identical
    arguments loads finished chunks and computes only the missing ones.
    Not supported together with given_parameters (their values cannot be
    fingerprinted into the run identity). restart_chunk without
    checkpoint_dir simply batches the run in chunks.

    verbose=1 prints one objective-range line per compaction segment.

    mesh: a (restarts, samples) DeviceMesh (parallel.make_mesh) that every
    rank passes. Each rank runs its block of every chunk's lanes (the
    mesh's restart ways must divide each chunk) and the results are
    gathered, so every rank's model holds the best restart. A sample axis
    above 1 also shards the samples where its ways divide them; otherwise
    every rank of a sample row fits its lanes on all of them, as the JAX
    package replicates the samples.
    """
    from ..models.signature_nmf import (
        promote_objective,
        segment_progress_printer,
    )
    from ..ops.precision import require_ieee_float32

    _check_family(model)
    is_multimodal = _is_multimodal(model)
    if checkpoint_dir is not None and given_parameters:
        raise ValueError(
            "checkpoint_dir= does not support given_parameters: their "
            "values cannot be fingerprinted into the run identity."
        )
    if model.device.type == "cuda":
        require_ieee_float32()
    if is_multimodal:
        model._setup_mdata(data_container)
    else:
        model._setup_adata(data_container)
        model._setup_fitting_parameters(fitting_kwargs)
    # the samples of the data's sample axis (counts are (V, D) for the W/H
    # families, (D, V) for CorrNMF and each modality of MultimodalCorrNMF);
    # a sample axis that does not divide them replicates them, as the JAX
    # package's restart-only sharding of fit_best_of does
    n_samples = (model.mdata.n_obs if is_multimodal
                 else int(model.adata.n_obs))
    sample_ways = axis_size(mesh, SAMPLE_AXIS)
    sample_sharded = sample_ways > 1 and n_samples % sample_ways == 0

    init_kwargs = {} if init_kwargs is None else dict(init_kwargs)
    device_init_supported = (
        not given_parameters and model.init_method == "random"
    )
    if batched_init is True and not device_init_supported:
        raise ValueError(
            "batched_init=True requires init_method='random' and no "
            "given_parameters."
        )
    use_device_init = batched_init is not False and device_init_supported

    seeds_init_kwargs = "seed" in init_kwargs or model.init_method in (
        "random", "separableNMF", "nndsvdar"
    )
    # CorrNMF draws its embeddings from the (reseeded) global numpy RNG, so
    # its restarts differ even under a deterministic signature init
    draws_embeddings = hasattr(model, "dim_embeddings")
    if not seeds_init_kwargs and not draws_embeddings:
        warnings.warn(
            f"init_method='{model.init_method}' is deterministic: all "
            f"{n_restarts} restarts will be identical. Use a stochastic "
            "init ('random', 'separableNMF', 'nndsvdar') for a meaningful "
            "multi-start.",
            UserWarning,
        )

    if use_device_init:
        # one host init populates the containers (shapes/names); the
        # per-restart parameters come from one batched device draw
        kwargs = dict(init_kwargs)
        kwargs.setdefault("seed", base_seed)
        rng_state = np.random.get_state()
        try:
            model._initialize(given_parameters, kwargs)
        finally:
            np.random.set_state(rng_state)
        if not is_multimodal:
            model._setup_fitting_parameters(fitting_kwargs)
        _, data = model._device_state()
        params0 = _device_init_batch(model, data, n_restarts, base_seed)
    else:
        params0, data = _host_init_batch(
            model, n_restarts, base_seed, given_parameters, init_kwargs,
            fitting_kwargs, seeds_init_kwargs,
        )

    step_kwargs = {}
    if sample_sharded:
        step_kwargs["reduce_samples"] = samples_reducer(mesh)
    update_fn, objective_fn = model._build_step(given_parameters,
                                                **step_kwargs)
    objective_fn = promote_objective(objective_fn, params0)
    config = model._fit_config()
    model.history["tol_effective"] = effective_tolerance(
        config, torch.float64, params0
    )

    def make_block_update(params, data_):
        fused = None
        if not is_multimodal:  # only W/H families have a fused block
            fused = model._block_update_fn(params, data_, given_parameters,
                                           sample_sharded=sample_sharded)
        return fused or plain_block_builder(update_fn)(params, data_)

    def run_lanes(part0):
        """One lockstep run over a chunk of lanes: (FitResult, losses),
        the whole chunk's on every rank of a mesh."""
        n_lanes = int(tree_leaves(part0)[0].shape[0])
        compacting = resolve_compact(compact, config, mesh, n_lanes,
                                     compact_min_bucket, model.device)

        def run(local0, local_data):
            if compacting:
                runner = CompactingRunner(config, objective_fn,
                                          make_block_update,
                                          min_bucket=compact_min_bucket)
                if verbose:
                    runner.progress = segment_progress_printer()
                return runner.run(local0, local_data)
            return lockstep_fit(objective_fn, config, make_block_update,
                                local0, local_data)

        if mesh is not None:
            check_divides(mesh, n_lanes,
                          n_samples if sample_sharded else None)
        return on_mesh(run, mesh, lane_shards(model._sample_axes())
                       if sample_sharded else None)(part0, data)

    store = None
    if checkpoint_dir is not None:
        store = _best_of_store(checkpoint_dir, model, n_restarts, base_seed,
                               config, restart_chunk, mesh)
    if restart_chunk is None or restart_chunk >= n_restarts:
        chunks = [(0, n_restarts)]
    else:
        size = max(1, int(restart_chunk))
        chunks = [
            (lo, min(lo + size, n_restarts))
            for lo in range(0, n_restarts, size)
        ]
    parts = []
    for lo, hi in chunks:
        name = f"restarts_{lo}_{hi}"
        entry = store.load(name) if store is not None else None
        if entry is not None:
            parts.append(_entry_to_result(entry, model.device))
            continue
        result, losses = run_lanes(
            tree_map(lambda leaf: leaf[lo:hi], params0))
        if store is not None:
            store.save(name, **_result_to_entry(result, losses))
        parts.append((result, losses))
    result, losses = _concat_results(parts)

    final_losses = losses.cpu().numpy()
    direction = getattr(model, "objective", "minimize")
    best = int(np.argmax(final_losses)) if direction == "maximize" else int(
        np.argmin(final_losses)
    )
    model._absorb_params(params_to_numpy(
        tree_map(lambda leaf: leaf[best], result.params)))
    model._is_fitted = True
    history = result.history.cpu().numpy()
    n_evals = result.n_evals.cpu().numpy()
    n_iterations = result.n_iterations.cpu().numpy()
    model.history["objective_function"] = list(
        history[best][: int(n_evals[best])]
    )
    model.history["n_iterations"] = int(n_iterations[best])
    model.history["multistart_losses"] = final_losses.tolist()

    return MultiStartSummary(
        losses=final_losses,
        n_iterations=n_iterations,
        best_index=best,
        history=history,
        n_evals=n_evals,
        signatures=_signature_stack(result.params),
    )
