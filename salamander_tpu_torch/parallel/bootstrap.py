"""Bootstrap stability analysis for signatures, held against
salamander_tpu/parallel/bootstrap.py.

How stable are the extracted signatures under resampling of the cohort? B
bootstrap replicates (samples drawn with replacement) are fitted
SIMULTANEOUSLY - each replicate's count matrix rides a leading lane axis of
the data through the lockstep engine - and each replicate's signatures are
Hungarian-matched back to the full-data fit to give per-signature cosine
stability distributions (the SigProfiler-style stability score).

Every family refits under its OWN update rule and objective (the model's
engine step functions), so the numbers mean what they claim for KLNMF,
MvNMF, ARDNMF, CorrNMFDet and MultimodalCorrNMF (one resampled sample set
per replicate, shared by all modalities; matched per modality). A float32 KLNMF fit on a card runs its
replicates through the fused CUDA kernel with a per-lane X. The sample
indices and the per-replicate inits are host numpy, as in the JAX package,
so the replicates' inputs are equal value for value; the replicates are
built on the host, stacked once and moved to the device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pandas as pd
import torch

from .. import containers
from ..engine import FitConfig
from ..engine.tree import tree_map

_SUPPORTED = ("KLNMF", "MvNMF", "ARDNMF", "CorrNMFDet", "MultimodalCorrNMF")


class BootstrapResult(NamedTuple):
    """Per-signature stability of a fitted model under cohort resampling."""

    stability: pd.Series        # mean matched cosine per signature
    similarities: pd.DataFrame  # (n_bootstraps, n_signatures) matched cosines
    signatures: np.ndarray      # (B, K, V) matched bootstrap signatures in
    # the MODEL's row orientation (signatures x features, aligned to
    # model.signatures), Hungarian-matched, with per-replicate cosines in
    # `similarities`; {mod: (B, K_mod, V_mod)} for MultimodalCorrNMF
    losses: np.ndarray          # (B,) final objective per replicate


def _cosine(u, v):
    return float(np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)))


def _match_order(reference: np.ndarray, replicate: np.ndarray) -> np.ndarray:
    """The permutation of the replicate's rows minimizing the total cosine
    distance to the reference rows (Hungarian; utils.match_signatures_pair
    without scikit-learn, which the card's machine may lack)."""
    from scipy.optimize import linear_sum_assignment

    def units(rows):
        return rows / np.linalg.norm(rows, axis=1, keepdims=True)

    distance = 1.0 - units(reference) @ units(replicate).T
    return linear_sum_assignment(np.clip(distance, 0.0, 2.0))[1]


def _match_replicates(reference_signatures, W_boot, names):
    """Hungarian-match each replicate's signatures to the reference frame;
    returns (matched (B,K,V), similarities DataFrame)."""
    n_bootstraps, n_signatures, n_features = W_boot.shape
    matched = np.empty((n_bootstraps, n_signatures, n_features))
    similarities = np.empty((n_bootstraps, n_signatures))
    reference = np.asarray(reference_signatures.values, dtype=np.float64)
    for b in range(n_bootstraps):
        order = _match_order(reference, np.asarray(W_boot[b], np.float64))
        matched[b] = W_boot[b][order]
        for k in range(n_signatures):
            similarities[b, k] = _cosine(reference[k], matched[b, k])
    return matched, pd.DataFrame(similarities, columns=names)


def _stacked(trees, device):
    """The replicates' (nested) dicts of host tensors stacked on a leading
    lane axis and moved to `device`."""
    return tree_map(lambda *leaves: torch.stack(leaves).to(device), *trees)


def bootstrap_stability(
    model,
    n_bootstraps: int = 50,
    seed: int = 0,
    config: FitConfig | None = None,
) -> BootstrapResult:
    """Assess signature stability of a FITTED model under cohort resampling.

    Draws `n_bootstraps` resampled cohorts (samples with replacement, from
    ``np.random.default_rng(seed)``), fits all of them as one lockstep
    batch on the model's device with the model's own step functions (fresh
    initialization per replicate with the model's init_method, seeded
    seed + b), matches each replicate's signatures to the model's, and
    reports matched cosine similarities. Stability near 1 = robust
    signature; low mean stability flags overfitting / rank too high.

    MultimodalCorrNMF resamples the shared sample axis (the same bootstrap
    indices across all modalities), refits the joint model, and matches
    per modality; `signatures` is then a per-modality dict.

    ARDNMF replicates refit at the model's CURRENT n_signatures with the
    per-replicate moment-matched b - call `model.prune()` first so
    replicates run at the inferred rank.
    """
    from ..io import _HYPERPARAM_KEYS
    from ..models.signature_nmf import promote_objective
    from ..ops.precision import require_ieee_float32
    from .compaction import lockstep_fit, plain_block_builder

    class_name = type(model).__name__
    if class_name not in _SUPPORTED:
        raise ValueError(
            f"bootstrap_stability supports {_SUPPORTED}; got {class_name}."
        )
    if not getattr(model, "_is_fitted", False):
        raise ValueError("bootstrap_stability() requires a fitted model.")

    config = config or FitConfig(
        min_iterations=model.min_iterations,
        max_iterations=model.max_iterations,
        conv_test_freq=model.conv_test_freq,
        tol=model.tol,
    )
    device = model.device
    if device.type == "cuda":
        require_ieee_float32()
    if class_name == "MultimodalCorrNMF":
        return _bootstrap_multimodal(model, n_bootstraps, seed, config)
    n_samples = model.adata.n_obs
    rng = np.random.default_rng(seed)
    sample_indices = rng.integers(0, n_samples, size=(n_bootstraps, n_samples))
    X = np.asarray(model.adata.X)  # (D, V), samples as rows

    # one throwaway clone on the host builds every replicate's init and
    # device state; the stacked tensors move to the device once
    hyperparameters = {
        key: getattr(model, key) for key in _HYPERPARAM_KEYS[class_name]
    }
    clone = type(model)(**hyperparameters, device="cpu")
    stochastic_init = clone.init_method in ("random", "separableNMF",
                                            "nndsvdar")

    params_per_replicate, data_per_replicate = [], []
    rng_state = np.random.get_state()
    try:
        for b in range(n_bootstraps):
            indices = sample_indices[b]
            adata_b = containers.AnnData(X[indices])
            np.random.seed(seed + b)  # drives unseeded embedding draws
            clone._setup_adata(adata_b)
            init_kwargs = {"seed": seed + b} if stochastic_init else None
            clone._initialize(None, init_kwargs)
            clone._setup_fitting_parameters(None)
            # per-sample loss weights follow their samples into the replicate
            for attr in ("weights_kl", "weights_lhalf"):
                weights = getattr(model, attr, None)
                if weights is not None:
                    setattr(clone, attr, np.asarray(weights)[indices])
            params_b, data_b = clone._device_state()
            params_per_replicate.append(params_b)
            data_per_replicate.append(data_b)
    finally:
        np.random.set_state(rng_state)

    params0 = _stacked(params_per_replicate, device)
    data = _stacked(data_per_replicate, device)
    update_fn, objective_fn = clone._build_step(None)
    objective_fn = promote_objective(objective_fn, params0)

    def make_block_update(params, lane_data):
        return (clone._block_update_fn(params, lane_data)
                or plain_block_builder(update_fn)(params, lane_data))

    result, losses = lockstep_fit(objective_fn, config, make_block_update,
                                  params0, data)
    losses = losses.cpu().numpy()
    if "W" in result.params:  # KLNMF/MvNMF/ARDNMF kernel orientation
        W_boot = result.params["W"].transpose(1, 2).cpu().numpy()
    else:  # CorrNMFDet carries (B, K, V) signatures directly
        W_boot = result.params["signatures"].cpu().numpy()

    matched, similarity_frame = _match_replicates(
        model.signatures, W_boot, list(model.signature_names)
    )
    return BootstrapResult(
        stability=similarity_frame.mean(axis=0),
        similarities=similarity_frame,
        signatures=matched,
        losses=losses,
    )


def _bootstrap_multimodal(model, n_bootstraps: int, seed: int,
                          config: FitConfig) -> BootstrapResult:
    """Joint multimodal bootstrap: one resampled sample set per replicate
    shared by all modalities, refit with the model's own joint EM as one
    lockstep batch with per-lane data, matched per modality."""
    from ..io import _HYPERPARAM_KEYS
    from ..models.signature_nmf import promote_objective
    from .compaction import lockstep_fit, plain_block_builder

    hyperparameters = {
        key: getattr(model, key)
        for key in _HYPERPARAM_KEYS["MultimodalCorrNMF"]
    }
    clone = type(model)(**hyperparameters, device="cpu")
    stochastic_init = clone.init_method in ("random", "separableNMF",
                                            "nndsvdar")
    mod_names = model.mod_names
    X = {name: np.asarray(model.mdata[name].X) for name in mod_names}
    n_samples = model.mdata.n_obs
    rng = np.random.default_rng(seed)
    sample_indices = rng.integers(0, n_samples, size=(n_bootstraps, n_samples))

    params_per_replicate, data_per_replicate = [], []
    rng_state = np.random.get_state()
    try:
        for b in range(n_bootstraps):
            indices = sample_indices[b]
            mdata_b = containers.MuData({
                name: containers.AnnData(X[name][indices])
                for name in mod_names
            })
            np.random.seed(seed + b)  # drives unseeded embedding draws
            clone._setup_mdata(mdata_b)
            init_kwargs = {"seed": seed + b} if stochastic_init else None
            clone._initialize(None, init_kwargs)
            params_b, data_b = clone._device_state()
            params_per_replicate.append(params_b)
            data_per_replicate.append(data_b)
    finally:
        np.random.set_state(rng_state)

    params0 = _stacked(params_per_replicate, model.device)
    data = _stacked(data_per_replicate, model.device)
    update_fn, objective_fn = clone._build_step(None)
    objective_fn = promote_objective(objective_fn, params0)
    result, losses = lockstep_fit(objective_fn, config,
                                  plain_block_builder(update_fn), params0,
                                  data)

    matched_by_mod = {}
    similarity_frames = []
    for name in mod_names:
        W_boot = result.params["mods"][name]["signatures"].cpu().numpy()
        matched, frame = _match_replicates(
            model.signatures[name], W_boot, model.signature_names[name]
        )
        matched_by_mod[name] = matched
        similarity_frames.append(frame)
    similarity_frame = pd.concat(similarity_frames, axis=1)
    return BootstrapResult(
        stability=similarity_frame.mean(axis=0),
        similarities=similarity_frame,
        signatures=matched_by_mod,
        losses=losses.cpu().numpy(),
    )
