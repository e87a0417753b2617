"""De novo consensus signature extraction, held against
salamander_tpu/extraction.py.

The field's headline discovery workflow (SigProfilerExtractor-style):
resample the cohort's counts B times, factorize every resample at every
candidate rank, cluster the pooled signatures under a one-per-replicate
matching constraint, and report per-cluster silhouette stability next to
the consensus solution's reconstruction error - stability, not loss, marks
the true rank.

The discovery phase on the device:

1. ``ops.assign.resample_counts`` draws all B count resamples on the
   device from one torch.Generator seeded with ``seed``.
2. Every (rank, replicate) pair is a LANE that fits its own resample. Its
   random init depends only on (seed, rank, replicate): each (lane,
   signature) column is drawn on the host from
   ``np.random.default_rng((seed, rank, replicate, j))``, so neither the
   layout, the padding nor the chunking can change a lane. Two layouts:
   - grouped: each rank's lanes run as one unpadded lockstep batch, every
     block one launch of the fused CUDA kernel with a per-lane X
     (ops/cuda_klnmf.py). Taken on a card wherever the kernel takes the
     fit: KLNMF, float32, no given signatures (the choice rank_scan_klnmf
     made by measurement);
   - padded: every rank shares one rank-masked (K-padded) batch
     (ops.klnmf / ops.mvnmf make_masked_step_functions) in plain PyTorch
     ops: MvNMF, given signatures, the CPU.
3. Per-rank consensus exposures refit on the ORIGINAL counts
   (ops.assign.refit_exposures).

The clustering runs on the host (copied): Hungarian matching on (k x k)
cosine matrices and silhouettes.

Memory: the discovery fit holds per-lane data, ``len(ranks) * n_bootstraps
* V * D`` elements. Beyond the lane budget (``max_lane_gb``; None: a
fixed share of the card's total memory, unlimited on the CPU) the lanes
run as consecutive equal chunks with results identical to one chunk, and
a store keeps one entry per lane, so it resumes under any budget. The B
resamples stay resident across chunks while they fit 2 GiB; beyond it they
are drawn anew per chunk from the same seed.

Under a (restarts, samples) mesh (parallel/mesh.py; every rank calls)
each rank fits a contiguous block of the rank-sorted lanes, as the JAX
package's P(RESTART_AXIS) cuts them: on a restart-only mesh they run
grouped by rank, each group through the kernel with a per-lane X as
without a mesh; a sample axis above 1 also splits every lane's counts and
exposures over the samples, whose sums the plain updates complete with
reduce_samples. Each lane's resample and start are the meshless ones (the
keyed draws). The lanes are gathered, the clustering runs on every rank,
and the consensus refit and ``fit_final`` shard the samples.

Not ported: the JAX package's accelerator-specific chunk and runner
choices.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pandas as pd
import torch

from . import containers
from .engine import FitConfig
from .ops.assign import resample_counts
from .ops.klnmf import EPSILON

__all__ = ["ExtractionResult", "extract_signatures"]

# Keep all B bootstrap resamples resident when they fit in this budget
# (shared across lane chunks); beyond it they are drawn anew per chunk.
_BOOT_RESIDENT_BUDGET_BYTES = 2 * 1024**3


# --------------------------------------------------------------------- #
# Device phase: resample -> lane init -> lockstep fit
# --------------------------------------------------------------------- #


def _lane_draws(seed: int, rank: int, replicate: int, n_padded: int,
                n_features: int, n_samples: int):
    """The host exponential draws of one lane: (n_padded, V) for W and
    (n_padded, D) for H, column j from its own keyed generator."""
    draws_w = np.empty((n_padded, n_features))
    draws_h = np.empty((n_padded, n_samples))
    for j in range(n_padded):
        rng = np.random.default_rng((int(seed), int(rank), int(replicate), j))
        draws_w[j] = rng.standard_exponential(n_features)
        draws_h[j] = rng.standard_exponential(n_samples)
    return draws_w, draws_h


def _lane_init(X_lanes, draws_w, draws_h, masks):
    """Random (W, H) inits of masked lanes from their draws.

    Mirrors initialization.methods.random_init_batch (Dirichlet signatures
    via normalized exponentials, Dirichlet exposures scaled to per-sample
    totals, EPSILON clips) restricted to each lane's active signatures:
    normalizing a subset of iid exponentials over that subset IS a
    Dirichlet of the subset's size, so a rank-k lane of a rank-Kp batch
    draws exactly a rank-k init. Padded H rows are EXACT zero; padded W
    columns are inert and keep their draws.

    X_lanes (L, V, D); draws_w (L, Kp, V); draws_h (L, Kp, D); masks (L,
    Kp) bool. Returns W (L, V, Kp), H (L, Kp, D).
    """
    W = (draws_w / draws_w.sum(-1, keepdim=True)).transpose(1, 2)
    masked = torch.where(masks.unsqueeze(1), draws_h.transpose(1, 2), 0.0)
    exposures = masked / masked.sum(-1, keepdim=True)         # (L, D, Kp)
    totals = X_lanes.sum(1)                                    # (L, D)
    H = (exposures * totals.unsqueeze(-1)).transpose(1, 2)
    W = torch.clamp_min(W, EPSILON)
    H = torch.where(masks.unsqueeze(-1), torch.clamp_min(H, EPSILON), 0.0)
    return W.contiguous(), H.contiguous()


def _resample_all(X, generator, n_bootstraps: int, method: str):
    """All B bootstrap resamples of the cohort, EPSILON-clipped (models
    clip counts to EPSILON at fit start; replicate fits follow the same
    contract)."""
    return torch.clamp_min(resample_counts(X, generator, n_bootstraps,
                                           method), EPSILON)


def _prepare_lanes(X_boot, seed: int, lane_ranks, lane_replicates,
                   n_padded: int, with_gamma: bool = False, W_given=None,
                   n_given: int = 0):
    """Initialize every (rank, replicate) lane from the resampled counts.

    Returns (params0, data) for the masked lockstep fit: params0 {"W" (L,
    V, Kp), "H" (L, Kp, D), "mask" (L, Kp)} (+ MvNMF's per-lane "gamma",
    reset to 1), data {"X": (L, V, D)}. W_given/n_given (semi-supervised
    extraction): the first n_given signature columns of EVERY lane are
    W_given and the masked step freezes them; lane_ranks count the NEW
    signatures, in columns [n_given : n_given + rank].
    """
    device, dtype = X_boot.device, X_boot.dtype
    lane_ranks = np.asarray(lane_ranks)
    lane_replicates = np.asarray(lane_replicates)
    X_lanes = X_boot.index_select(
        0, torch.as_tensor(lane_replicates, device=device))
    _, n_features, n_samples = X_lanes.shape
    draws = [_lane_draws(seed, rank, replicate, n_padded, n_features,
                         n_samples)
             for rank, replicate in zip(lane_ranks, lane_replicates)]

    def stacked(i):
        return torch.as_tensor(np.stack([d[i] for d in draws]), dtype=dtype,
                               device=device)

    masks = torch.as_tensor(
        (n_given + lane_ranks)[:, None] > np.arange(n_padded)[None, :],
        device=device)
    W0, H0 = _lane_init(X_lanes, stacked(0), stacked(1), masks)
    if n_given:
        W0[:, :, :n_given] = torch.as_tensor(W_given, dtype=dtype,
                                             device=device)
    params0 = {"W": W0, "H": H0, "mask": masks}
    if with_gamma:
        params0["gamma"] = torch.ones(W0.shape[0], dtype=dtype,
                                      device=device)
    return params0, {"X": X_lanes}


def _discovery_fit(params0, data, config: FitConfig, model: str,
                   lam: float, delta: float, n_given: int, use_runner: bool,
                   masked: bool = True, reduce_samples=None):
    """One lockstep batch of lanes, each fitting its own data["X"] lane.
    Returns (W (L, V, K), losses (L,), n_iterations (L,)) on the device.

    masked=False runs unpadded KLNMF lanes (params without "mask"), whose
    blocks take the CUDA kernel with a per-lane X where
    cuda_klnmf.mu_block_supported holds. Without the runner the same steps
    run as one monolithic lockstep loop. reduce_samples: the lanes hold
    this rank's block of the samples (plain updates)."""
    from .parallel.compaction import extraction_compacting_runner, lockstep_fit

    runner = extraction_compacting_runner(
        config, params0["W"].dtype != torch.float64, 8, family=model,
        lam=lam, delta=delta, n_given=n_given, masked=masked,
        reduce_samples=reduce_samples)
    if use_runner:
        result, losses = runner.run(params0, data)
    else:
        result, losses = lockstep_fit(runner.objective_fn, config,
                                      runner.make_block_update, params0, data)
    return result.params["W"], losses, result.n_iterations


def _grouped_fit(params0, data, lane_ranks, config: FitConfig,
                 use_runner: bool, reduce_samples=None):
    """The grouped layout of a chunk of KLNMF lanes without given
    signatures: each rank's lanes run as one unpadded batch (the kernel's
    route on a card), from the first k columns of the padded inits.
    Returns what _discovery_fit does, with W padded back to Kp by the
    inert initial columns, as the padded layout leaves them."""
    W = params0["W"].clone()
    losses = torch.empty(W.shape[0], dtype=torch.float64, device=W.device)
    n_iterations = torch.empty(W.shape[0], dtype=torch.int32,
                               device=W.device)
    lane_ranks = np.asarray(lane_ranks)
    for rank in np.unique(lane_ranks):
        rows = torch.as_tensor(np.flatnonzero(lane_ranks == rank),
                               device=W.device)
        k = int(rank)
        group0 = {
            "W": params0["W"].index_select(0, rows)[:, :, :k].contiguous(),
            "H": params0["H"].index_select(0, rows)[:, :k].contiguous(),
        }
        group_data = {"X": data["X"].index_select(0, rows)}
        W_k, loss_k, iter_k = _discovery_fit(
            group0, group_data, config, "klnmf", 1.0, 1.0, 0, use_runner,
            masked=False, reduce_samples=reduce_samples)
        W[rows, :, :k] = W_k
        losses[rows] = loss_k.to(torch.float64)
        n_iterations[rows] = iter_k.to(torch.int32)
    return W, losses, n_iterations


def _choose_layout(model: str, dtype, n_given: int, ranks, n_features: int,
                   n_samples: int, device) -> str:
    """'grouped' where the kernel takes every rank's lanes (a card,
    KLNMF, float32, no given signatures, shapes a kernel holds), else
    'padded'. Decided from the arguments, before any launch."""
    from .ops import cuda_klnmf

    if (torch.device(device).type == "cuda" and model == "klnmf"
            and dtype == torch.float32 and n_given == 0
            and all(cuda_klnmf.plan_launch(1, n_features, k, n_samples,
                                           1).variant is not None
                    for k in ranks)):
        return "grouped"
    return "padded"


# --------------------------------------------------------------------- #
# Host phase: Hungarian-constrained consensus clustering + silhouettes
# (copied from the JAX package)
# --------------------------------------------------------------------- #


def _unit_rows(stack):
    norms = np.linalg.norm(stack, axis=-1, keepdims=True)
    return stack / np.clip(norms, np.finfo(np.float64).tiny, None)


def _consensus_cluster(stack: np.ndarray, best_index: int,
                       max_iterations: int = 200):
    """Partition B x k pooled signatures into k clusters, one signature per
    replicate per cluster (the constraint that makes 'cluster j' mean 'the
    same signature rediscovered B times', not an arbitrary blob).

    stack: (B, k, V) row signatures. Alternates Hungarian matching of each
    replicate onto the centroids (cosine) with centroid re-estimation
    (normalized mean of matched members), seeded from the best-loss
    replicate; converges when the matching stops changing (k-means-style
    monotone objective over a finite assignment set).

    Returns (consensus (k, V) rows summing to 1, matched (B, k, V) raw
    signatures, permutations (B, k) lane->cluster, mean matched cosine to
    the consensus (k,)).
    """
    from scipy.optimize import linear_sum_assignment

    n_replicates, k, _ = stack.shape
    units = _unit_rows(stack.astype(np.float64))
    centroids = units[best_index]
    perms = np.tile(np.arange(k), (n_replicates, 1))
    for _ in range(max_iterations):
        new_perms = np.empty_like(perms)
        for b in range(n_replicates):
            sim = centroids @ units[b].T  # (cluster, signature)
            rows, cols = linear_sum_assignment(1.0 - sim)
            new_perms[b, rows] = cols
        matched_units = units[np.arange(n_replicates)[:, None], new_perms]
        centroids = _unit_rows(matched_units.mean(axis=0))
        if np.array_equal(new_perms, perms):
            break
        perms = new_perms
    matched = stack[np.arange(n_replicates)[:, None], perms]
    consensus = matched.mean(axis=0)
    consensus = consensus / consensus.sum(axis=-1, keepdims=True)
    cosines = np.einsum(
        "bkv,kv->bk", matched_units, _unit_rows(consensus)
    ).mean(axis=0)
    return consensus, matched, perms, cosines


def _cluster_silhouettes(matched: np.ndarray) -> np.ndarray:
    """Per-cluster mean silhouette under cosine distance.

    matched: (B, k, V) cluster-aligned signatures (cluster j = [:, j]).
    Standard silhouette: a(i) = mean distance to own cluster's other
    members, b(i) = smallest mean distance to another cluster,
    s = (b - a) / max(a, b). NaN when B < 2 or k < 2 (undefined, not
    perfect - mirrors tl.signature_stability's single-restart contract).
    """
    n_replicates, k, _ = matched.shape
    if n_replicates < 2 or k < 2:
        return np.full(k, np.nan)
    units = _unit_rows(matched.astype(np.float64))
    points = units.transpose(1, 0, 2).reshape(k * n_replicates, -1)
    distance = 1.0 - points @ points.T
    labels = np.repeat(np.arange(k), n_replicates)
    same = labels[:, None] == labels[None, :]
    a = np.sum(np.where(same, distance, 0.0), axis=1) / (n_replicates - 1)
    mean_to = np.empty((k * n_replicates, k))
    for j in range(k):
        mean_to[:, j] = distance[:, labels == j].mean(axis=1)
    mean_to[np.arange(k * n_replicates), labels] = np.inf  # own cluster out
    b = mean_to.min(axis=1)
    s = (b - a) / np.maximum(np.maximum(a, b), np.finfo(np.float64).tiny)
    return s.reshape(k, n_replicates).mean(axis=1)


# --------------------------------------------------------------------- #
# The pipeline
# --------------------------------------------------------------------- #


@dataclass
class ExtractionResult:
    """Everything the consensus-extraction pipeline learned.

    ``table`` is `pl.rank_selection`-compatible (index ``n_signatures``;
    ``best_loss`` = the consensus solution's KL on the ORIGINAL counts,
    ``mean_stability``/``min_stability`` = per-cluster silhouettes).
    ``layout`` is the discovery fit's layout ('grouped' or 'padded')."""

    table: pd.DataFrame
    consensus: dict[int, pd.DataFrame]       # rank -> (k, V) row signatures
    exposures: dict[int, pd.DataFrame]       # rank -> (D, k) consensus refit
    silhouettes: dict[int, np.ndarray]       # rank -> (k,) cluster silhouette
    matched: dict[int, np.ndarray]           # rank -> (B, k, V) cluster-
    # aligned replicate signatures (cluster j = [:, j, :])
    replicate_losses: dict[int, np.ndarray]  # rank -> (B,) final loss per lane
    replicate_iterations: dict[int, np.ndarray]  # rank -> (B,) iterations
    # each lane ran before its convergence test fired
    suggested_rank: int | None
    model: Any = field(default=None)         # fitted model at the suggestion
    layout: str = "padded"


def _suggest_rank(ranks, min_sil, min_stability: float,
                  rank_rule: str) -> int | None:
    """Rank decision from per-rank min cluster silhouettes (see the
    ``suggested_rank`` docs on extract_signatures). ``ranks``/``min_sil``
    are aligned arrays; NaN silhouettes (rank 1's single cluster, or
    n_bootstraps < 2) are skipped as unmeasurable. Warns and returns None
    instead of raising when no rank qualifies."""
    min_sil = np.asarray(min_sil, dtype=float)
    if np.isnan(min_sil).all():
        warnings.warn(
            "cluster silhouettes are undefined (n_bootstraps < 2 or "
            "rank 1 only) - no rank suggestion; inspect result.table",
            UserWarning,
        )
        return None
    # rank 1 has a single cluster (silhouette undefined); start at the
    # first rank where stability is measurable
    start = int(np.argmax(~np.isnan(min_sil)))
    passes = min_sil[start:] >= min_stability
    if rank_rule == "largest":
        if passes.any():
            return int(ranks[start:][np.where(passes)[0][-1]])
        warnings.warn(
            f"every scanned rank falls below min_stability="
            f"{min_stability} (best min silhouette "
            f"{np.nanmax(min_sil):.3f}) - no suggestion; add bootstraps, "
            "scan other ranks, or lower the threshold",
            UserWarning,
        )
        return None
    if not passes[0]:
        warnings.warn(
            f"even the smallest measurable rank ({int(ranks[start])}) "
            f"falls below min_stability={min_stability} "
            f"(min silhouette {min_sil[start]:.3f}) - no suggestion under "
            "rank_rule='prefix'; scan smaller ranks, add bootstraps, or "
            "lower the threshold",
            UserWarning,
        )
        return None
    prefix_end = int(np.argmin(passes)) - 1 if not passes.all() else -1
    return int(ranks[start:][prefix_end])


def _lane_chunk_size(n_lanes: int, max_lane_gb, dtype, n_features: int,
                     n_samples: int, n_padded: int, device) -> int:
    """Lanes per discovery chunk. Per-lane residency during a block: the
    lane's bootstrap counts plus the aux quotient and the WH product
    (3.5 V x D buffers) and the factor pairs twice (state and scatter
    target), against max_lane_gb, or the memory budget of the device
    (assign._memory_budget: a fixed share of the card's total memory,
    unlimited on the CPU). The size decides no result and is no part of a
    store's identity: lanes are fitted and stored one by one."""
    from .assign import _memory_budget

    if max_lane_gb is not None and max_lane_gb <= 0:
        raise ValueError("max_lane_gb must be positive")
    budget = (int(max_lane_gb * 2**30) if max_lane_gb is not None
              else _memory_budget(torch.device(device)))
    if budget is None:
        return n_lanes
    itemsize = torch.finfo(dtype).bits // 8
    bytes_per_lane = itemsize * (
        3.5 * n_features * n_samples + 2 * n_padded * (n_features + n_samples)
    )
    n_chunks = max(1, int(-((n_lanes * bytes_per_lane) // -budget)))
    return -(n_lanes // -n_chunks)


def extract_signatures(
    data,
    ranks,
    n_bootstraps: int = 20,
    resample_method: str = "multinomial",
    seed: int = 0,
    min_stability: float = 0.8,
    rank_rule: str = "largest",
    model: str = "klnmf",
    lam: float = 1.0,
    delta: float = 1.0,
    given_signatures=None,
    min_iterations: int = 500,
    max_iterations: int = 10_000,
    conv_test_freq: int = 10,
    tol: float = 1e-7,
    dtype=None,
    fit_final: bool = True,
    mesh=None,
    compact: bool | None = None,
    max_lane_gb: float | None = None,
    checkpoint_dir=None,
    device=None,
) -> ExtractionResult:
    """De novo consensus signature extraction over a rank range.

    data: AnnData-like or samples-x-features DataFrame of counts.
    ranks: candidate signature counts (e.g. ``range(2, 11)``).
    n_bootstraps: count resamples per rank (``resample_method``:
    'multinomial' preserves per-sample totals, 'poisson' is the parametric
    bootstrap). Each (rank, replicate) pair fits de novo under the chosen
    family's update rule from a seeded Dirichlet init keyed by (seed,
    rank, replicate); per-rank pooled signatures are consensus-clustered
    and scored by silhouette (see the module docstring for the layouts).

    model: 'klnmf' or 'mvnmf' (minimum-volume NMF, ``lam``/``delta`` as on
    ``models.MvNMF``). The consensus-exposure refit on the original counts
    is the KL subproblem for both families; 'mvnmf' lane losses and
    ``best_loss`` are the penalized objective KL + lam*logdet(W^T W +
    delta I).

    given_signatures (semi-supervised extraction): known signatures every
    lane carries FROZEN in its leading columns; ``ranks`` then counts the
    NEW signatures. Clustering, silhouettes and the rank decision run on
    the new signatures only; ``consensus``/``exposures`` carry given + new
    (new names rolled past any collisions), and ``fit_final`` fits n_given
    + suggested signatures.

    suggested_rank: under ``rank_rule='largest'`` the LARGEST scanned rank
    whose min cluster silhouette stays >= ``min_stability``;
    ``rank_rule='prefix'`` the largest rank reachable from the smallest
    through consecutively stable ranks. None (with a warning) when no rank
    qualifies.

    fit_final=True refits the suggested rank's consensus signatures on the
    full data as a ``models.KLNMF`` (or ``MvNMF``) with
    ``given_parameters={"asignatures": ...}`` (exposure-only fit).

    dtype: None is float32 on a card, float64 on the CPU (resolve_dtype).
    device: None is the current CUDA device (raises without one).

    compact: lane compaction for the discovery fit (None = on a card,
    where min_iterations < max_iterations); survivors' bootstrap counts are
    gathered with their state. Per-lane results equal the lockstep loop's.

    max_lane_gb: device-memory budget of the discovery lanes (None: a
    fixed share of the card's total memory; unlimited on the CPU). Chunked
    results equal one chunk's: lane draws are (seed, rank, replicate)-keyed.

    checkpoint_dir: preemption-safe resume of completed discovery lanes
    (one entry each, so a rerun under another memory budget resumes too)
    and per-rank consensus refits (checkpoint.ChunkStore). Its identity
    holds the data, the arguments, the compute dtype and the lane layout,
    not the chunk size; a store of a different run is warned about and
    discarded.

    mesh: a (restarts, samples) DeviceMesh (parallel.make_mesh) that every
    rank passes (module docstring). Its restart ways must divide the
    ``len(ranks) * n_bootstraps`` lanes and its sample ways the samples;
    ``max_lane_gb`` is ignored under it (the lanes are already spread over
    the ranks). Every rank returns the whole result; the mesh's first rank
    writes the store.
    """
    from .assign import _align_catalog, _extract_counts
    from .models.signature_nmf import resolve_device, resolve_dtype
    from .ops.assign import refit_exposures
    from .ops.precision import require_ieee_float32
    from .parallel.mesh import (
        SAMPLE_AXIS,
        axis_size,
        check_divides,
        gather_samples,
        lane_range,
        open_store,
        restart_sum,
        sample_range,
        samples_reducer,
    )

    ranks = sorted({int(k) for k in ranks})
    if not ranks or ranks[0] < 1:
        raise ValueError(f"ranks must be positive integers, got {ranks!r}")
    if n_bootstraps < 1:
        raise ValueError("n_bootstraps must be >= 1")
    if model not in ("klnmf", "mvnmf"):
        raise ValueError(f"model must be 'klnmf' or 'mvnmf', got {model!r}")
    if rank_rule not in ("largest", "prefix"):
        raise ValueError(
            f"rank_rule must be 'largest' or 'prefix', got {rank_rule!r}"
        )
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    if device.type == "cuda":
        require_ieee_float32()
    X_host, obs_names, var_names = _extract_counts(data)  # (V, D)
    n_features, n_samples = X_host.shape
    W_given_host = None
    given_names: list[str] = []
    n_given = 0
    if given_signatures is not None:
        W_given_host, given_names = _align_catalog(
            given_signatures, var_names
        )
        n_given = W_given_host.shape[1]
    n_padded = n_given + ranks[-1]
    if n_padded > n_samples or n_padded > n_features:
        raise ValueError(
            f"max total rank {n_padded} (n_given={n_given} + "
            f"max new rank {ranks[-1]}) exceeds the data's "
            f"min(n_samples, n_features) = {min(n_samples, n_features)}"
        )

    lane_ranks = np.repeat(ranks, n_bootstraps)
    lane_replicates = np.tile(np.arange(n_bootstraps), len(ranks))
    n_lanes = len(lane_ranks)
    lane_lo, lane_hi = 0, n_lanes
    sample_lo, sample_hi = 0, n_samples
    reduce_samples = None
    if mesh is not None:
        check_divides(mesh, n_lanes, n_samples)
        lane_lo, lane_hi = lane_range(n_lanes, mesh)
        if axis_size(mesh, SAMPLE_AXIS) > 1:
            sample_lo, sample_hi = sample_range(n_samples, mesh)
            reduce_samples = samples_reducer(mesh)

    X = torch.as_tensor(np.maximum(X_host, EPSILON), dtype=dtype,
                        device=device)
    config = FitConfig(
        min_iterations=min_iterations, max_iterations=max_iterations,
        conv_test_freq=conv_test_freq, tol=tol,
    )
    layout = _choose_layout(model, dtype, n_given, ranks, n_features,
                            n_samples, device)
    chunk_size = n_lanes if mesh is not None else _lane_chunk_size(
        n_lanes, max_lane_gb, dtype, n_features, n_samples, n_padded, device)
    use_runner = (
        device.type == "cuda" and config.min_iterations
        < config.max_iterations
    ) if compact is None else bool(compact)

    def resample():
        generator = torch.Generator(device=device).manual_seed(int(seed))
        return _resample_all(X, generator, n_bootstraps, resample_method)

    itemsize = torch.finfo(dtype).bits // 8
    boot_bytes = n_bootstraps * n_features * n_samples * itemsize
    X_boot_shared = (resample() if boot_bytes <= _BOOT_RESIDENT_BUDGET_BYTES
                     else None)

    ckpt = None
    if checkpoint_dir is not None:
        from .checkpoint import data_fingerprint

        identity = {
            "pipeline": "extract_signatures",
            "format": 2,
            "data": data_fingerprint(X_host),
            "given": (None if W_given_host is None
                      else data_fingerprint(W_given_host)),
            "seed": int(seed),
            "ranks": [int(k) for k in ranks],
            "n_bootstraps": int(n_bootstraps),
            "resample_method": str(resample_method),
            "model": model,
            "lam": float(lam),
            "delta": float(delta),
            "min_iterations": int(min_iterations),
            "max_iterations": int(max_iterations),
            "conv_test_freq": int(conv_test_freq),
            "tol": float(tol),
            "dtype": str(dtype).removeprefix("torch."),
            "n_lanes": int(n_lanes),
            "compact": bool(use_runner),
            "layout": layout,
        }
        if mesh is not None:
            identity["mesh"] = True
        ckpt = open_store(checkpoint_dir, identity, mesh)

    lane_results: list = [None] * n_lanes  # (W (V, Kp), loss, iterations)
    if ckpt is not None:
        for lane in range(n_lanes):
            cached = ckpt.load(f"lane_{lane:06d}")
            if cached is not None:
                lane_results[lane] = (cached["W"], cached["loss"],
                                      cached["iterations"])
    for start in range(0, n_lanes, chunk_size):
        stop = min(start + chunk_size, n_lanes)
        sl = np.array([lane for lane in range(start, stop)
                       if lane_results[lane] is None], dtype=int)
        if sl.size == 0:
            continue
        # this rank's lanes (all of them without a mesh)
        mine = np.flatnonzero((sl >= lane_lo) & (sl < lane_hi))
        W_c = torch.zeros((sl.size, n_features, n_padded), dtype=dtype,
                          device=device)
        loss_c = torch.zeros(sl.size, dtype=torch.float64, device=device)
        iter_c = torch.zeros(sl.size, dtype=torch.float64, device=device)
        if mine.size:
            X_boot = (X_boot_shared if X_boot_shared is not None
                      else resample())
            params0, lane_data = _prepare_lanes(
                X_boot, seed, lane_ranks[sl[mine]],
                lane_replicates[sl[mine]], n_padded,
                with_gamma=(model == "mvnmf"), W_given=W_given_host,
                n_given=n_given,
            )
            if reduce_samples is not None:
                width = sample_hi - sample_lo
                params0["H"] = params0["H"].narrow(
                    -1, sample_lo, width).contiguous()
                lane_data["X"] = lane_data["X"].narrow(
                    -1, sample_lo, width).contiguous()
            if layout == "grouped":
                W_m, loss_m, iter_m = _grouped_fit(
                    params0, lane_data, lane_ranks[sl[mine]], config,
                    use_runner, reduce_samples)
            else:
                W_m, loss_m, iter_m = _discovery_fit(
                    params0, lane_data, config, model, lam, delta, n_given,
                    use_runner, reduce_samples=reduce_samples)
            rows = torch.as_tensor(mine, device=device)
            W_c[rows] = W_m
            loss_c[rows] = loss_m.to(torch.float64)
            iter_c[rows] = iter_m.to(torch.float64)
            del params0, lane_data, X_boot
        if mesh is not None:  # every lane is one restart rank's
            W_c, loss_c, iter_c = (restart_sum(W_c, mesh),
                                   restart_sum(loss_c, mesh),
                                   restart_sum(iter_c, mesh))
        W_c, loss_c, iter_c = (W_c.cpu().numpy(), loss_c.cpu().numpy(),
                               iter_c.cpu().numpy().astype(np.int32))
        for j, lane in enumerate(sl):
            lane_results[lane] = (W_c[j], loss_c[j], iter_c[j])
            if ckpt is not None:
                ckpt.save(f"lane_{lane:06d}", W=W_c[j], loss=loss_c[j],
                          iterations=iter_c[j])

    X_boot_shared = None  # free the resamples before the consensus refit
    W_lanes = np.stack([lane[0] for lane in lane_results])  # (L, V, Kp)
    losses = np.stack([lane[1] for lane in lane_results])
    lane_iterations = np.stack([lane[2] for lane in lane_results])

    rows = []
    consensus_by_rank: dict[int, pd.DataFrame] = {}
    exposures_by_rank: dict[int, pd.DataFrame] = {}
    silhouettes: dict[int, np.ndarray] = {}
    matched_by_rank: dict[int, np.ndarray] = {}
    losses_by_rank: dict[int, np.ndarray] = {}
    iterations_by_rank: dict[int, np.ndarray] = {}
    X64 = np.asarray(X_host, dtype=np.float64)
    norm_X = np.linalg.norm(X64)
    for rank in ranks:
        total = n_given + rank
        lanes = lane_ranks == rank
        # consensus-cluster the NEW signatures only: the given columns are
        # frozen identical across replicates
        stack = np.transpose(
            W_lanes[lanes][:, :, n_given:total], (0, 2, 1)
        )
        lane_losses = losses[lanes]
        consensus, matched, _, _ = _consensus_cluster(
            stack, int(np.argmin(lane_losses))
        )
        silhouette = _cluster_silhouettes(matched)

        H = None
        if ckpt is not None:
            cached = ckpt.load(
                f"rank_{rank:03d}", match={"consensus": consensus}
            )
            if cached is not None:
                H = np.asarray(cached["H"], dtype=np.float64)
        if H is None:
            W_pad = np.full((n_features, n_padded), 1.0 / n_features)
            if n_given:
                W_pad[:, :n_given] = W_given_host
            W_pad[:, n_given:total] = consensus.T
            mask2d = torch.as_tensor(
                np.arange(n_padded)[:, None]
                < np.full((1, sample_hi - sample_lo), total), device=device)
            H_pad, _ = refit_exposures(
                X[:, sample_lo:sample_hi],
                torch.as_tensor(W_pad, dtype=dtype, device=device),
                mask2d, max_iterations=max_iterations, tol=tol,
                conv_test_freq=conv_test_freq, reduce_samples=reduce_samples,
            )
            if reduce_samples is not None:
                H_pad = gather_samples(H_pad, mesh, n_samples)
            H = H_pad.cpu().numpy().astype(np.float64)[:total]  # (G + k, D)
            if ckpt is not None:
                ckpt.save(
                    f"rank_{rank:03d}", match={"consensus": consensus}, H=H
                )
        if n_given:
            W_full = np.concatenate(
                [np.asarray(W_given_host, np.float64),
                 consensus.T.astype(np.float64)], axis=1
            )  # (V, G + k)
        else:
            W_full = consensus.T.astype(np.float64)
        recon = W_full @ H                              # (V, D)
        positive = X64 > 0
        consensus_kl = float(
            np.sum(X64[positive] * np.log(X64[positive] / recon[positive]))
            - X64.sum() + recon.sum()
        )
        cos = np.sum(X64 * recon, axis=0) / np.maximum(
            np.linalg.norm(X64, axis=0) * np.linalg.norm(recon, axis=0),
            np.finfo(np.float64).tiny,
        )
        best_loss = consensus_kl
        if model == "mvnmf":
            # volume penalty over the FULL signature matrix (given + new)
            _, logdet = np.linalg.slogdet(
                W_full.T @ W_full + delta * np.eye(total)
            )
            best_loss = consensus_kl + lam * logdet
        # new signature names roll past any collision with the given names
        new_names: list[str] = []
        existing = set(given_names)
        j = 1
        while len(new_names) < rank:
            candidate = f"Sig{j}"
            if candidate not in existing:
                new_names.append(candidate)
            j += 1
        names = given_names + new_names
        consensus_by_rank[rank] = pd.DataFrame(
            W_full.T, index=names, columns=var_names
        )
        exposures_by_rank[rank] = pd.DataFrame(
            H.T, index=obs_names, columns=names
        )
        silhouettes[rank] = silhouette
        matched_by_rank[rank] = matched
        losses_by_rank[rank] = lane_losses
        iterations_by_rank[rank] = lane_iterations[lanes]
        rows.append({
            "n_signatures": rank,
            "best_loss": best_loss,
            "mean_stability": float(np.mean(silhouette)),
            "min_stability": float(np.min(silhouette)),
            "mean_sample_cosine": float(np.mean(cos)),
            "relative_error": float(np.linalg.norm(X64 - recon) / norm_X),
            "mean_replicate_loss": float(np.mean(lane_losses)),
        })
    table = pd.DataFrame(rows).set_index("n_signatures")

    suggested = _suggest_rank(
        np.asarray(table.index), table["min_stability"].to_numpy(),
        min_stability, rank_rule,
    )

    fitted = None
    if fit_final and suggested is not None:
        from .models import KLNMF, MvNMF

        asignatures = containers.AnnData(consensus_by_rank[suggested])
        adata = containers.AnnData(
            pd.DataFrame(X_host.T, index=obs_names, columns=var_names)
        )
        shared_kwargs = dict(
            n_signatures=n_given + suggested,
            min_iterations=min_iterations, max_iterations=max_iterations,
            conv_test_freq=conv_test_freq, tol=tol,
            dtype=str(dtype).removeprefix("torch."), device=device,
        )
        if model == "mvnmf":
            fitted = MvNMF(lam=lam, delta=delta, **shared_kwargs)
        else:
            fitted = KLNMF(**shared_kwargs)
        fitted.fit(
            adata,
            given_parameters={"asignatures": asignatures},
            init_kwargs={"seed": seed},
            mesh=mesh,
        )

    return ExtractionResult(
        table=table,
        consensus=consensus_by_rank,
        exposures=exposures_by_rank,
        silhouettes=silhouettes,
        matched=matched_by_rank,
        replicate_losses=losses_by_rank,
        replicate_iterations=iterations_by_rank,
        suggested_rank=suggested,
        model=fitted,
        layout=layout,
    )
