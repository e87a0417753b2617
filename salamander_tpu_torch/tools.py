"""Analysis tools (`sal.tl`), held against salamander_tpu/tools.py:
dimensionality reduction and correlation (compute-and-store into the
annotated containers), stability-based rank selection over scan results,
annotation against a catalog, and the sparse catalog decomposition of de
novo signatures, which runs on the assignment engine.

Host-side by design: these run once on small fitted representations; a
signature stack that lives on the device is fetched once. UMAP is optional
(umap-learn is not a hard dependency) and falls back to PCA; PCA falls back
to a numpy SVD and t-SNE raises ImportError where scikit-learn is missing.
"""

from __future__ import annotations

import warnings
from typing import Iterable

import numpy as np
import pandas as pd
import torch

from .utils import _get_basis_obsm, value_checker

__all__ = [
    "DIM_REDUCTION_METHODS",
    "DecompositionResult",
    "annotate_signatures",
    "correlation",
    "correlation_numpy",
    "decompose_signatures",
    "pca",
    "rank_selection_table",
    "reduce_dimension",
    "reduce_dimension_multiple",
    "reduce_dimension_numpy",
    "signature_stability",
    "suggest_rank",
    "tsne",
    "umap",
]

DIM_REDUCTION_METHODS = ("pca", "tsne", "umap")


def _pca(data: np.ndarray, n_components: int = 2, **kwargs) -> np.ndarray:
    try:
        from sklearn.decomposition import PCA

        return PCA(n_components=n_components, **kwargs).fit_transform(data)
    except ImportError:  # the card's machine has no scikit-learn
        centered = data - data.mean(axis=0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        return centered @ vt[:n_components].T


def pca(adata, basis: str, **kwargs) -> None:
    """Compute and store the PCA of adata.obsm[basis] as 'X_pca'."""
    adata.obsm["X_pca"] = _pca(_get_basis_obsm(adata, basis), **kwargs)


def _tsne(data: np.ndarray, n_components: int = 2, perplexity: float = 30.0,
          **kwargs) -> np.ndarray:
    from sklearn.manifold import TSNE

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        perplexity = min(perplexity, len(data) - 1)
        return TSNE(
            n_components=n_components, perplexity=perplexity, **kwargs
        ).fit_transform(data)


def tsne(adata, basis: str, **kwargs) -> None:
    """Compute and store the t-SNE of adata.obsm[basis] as 'X_tsne'."""
    adata.obsm["X_tsne"] = _tsne(_get_basis_obsm(adata, basis), **kwargs)


def _umap(data: np.ndarray, n_components: int = 2, n_neighbors: float = 15,
          min_dist: float = 0.1, **kwargs) -> np.ndarray:
    try:
        import umap
    except ImportError:
        warnings.warn(
            "umap-learn is not installed; falling back to PCA. Install the "
            "optional 'umap-learn' package or pass method='pca'/'tsne' to "
            "silence this warning.",
            UserWarning,
        )
        return _pca(data, n_components=n_components)
    n_neighbors = min(n_neighbors, len(data) - 1.0)
    return umap.UMAP(
        n_components=n_components, n_neighbors=n_neighbors,
        min_dist=min_dist, **kwargs
    ).fit_transform(data)


def umap(adata, basis: str, **kwargs) -> None:
    """Compute and store the UMAP of adata.obsm[basis] as 'X_umap'."""
    adata.obsm["X_umap"] = _umap(_get_basis_obsm(adata, basis), **kwargs)


_REDUCERS = {"pca": _pca, "tsne": _tsne, "umap": _umap}


def _warn_nothing_to_reduce(n_dimensions: int, what: str) -> bool:
    if n_dimensions not in (1, 2):
        return False
    warnings.warn(
        f"The dimension of the {what} is {n_dimensions}. "
        + ("The dimensionality of the data will not be reduced."
           if what == "data points"
           else "No dimensionality reduction will be applied."),
        UserWarning,
    )
    return True


def reduce_dimension_numpy(
    data: np.ndarray,
    method: str = "umap",
    n_components: int = 2,
    normalize: bool = False,
    **kwargs,
) -> np.ndarray:
    """Reduce rows of 'data' to n_components; 1-D/2-D data passes through
    with a warning (nothing to reduce)."""
    value_checker("method", method, DIM_REDUCTION_METHODS)
    if normalize:
        data = data / np.sqrt(np.sum(data**2, axis=1))[:, None]
    if _warn_nothing_to_reduce(data.shape[1], "data points"):
        return data
    return _REDUCERS[method](data, n_components=n_components, **kwargs)


def reduce_dimension(adata, basis: str, method: str = "umap",
                     n_components: int = 2, **kwargs) -> None:
    """Compute and store a dimensionality reduction of adata.obsm[basis]."""
    data = _get_basis_obsm(adata, basis)
    if _warn_nothing_to_reduce(data.shape[1], "observation annotations"):
        return
    adata.obsm[f"X_{method}"] = reduce_dimension_numpy(
        data, method=method, n_components=n_components, **kwargs
    )


def reduce_dimension_multiple(adatas: Iterable, basis: str,
                              method: str = "umap", **kwargs) -> None:
    """Jointly reduce the same obsm basis of several containers (used for the
    shared CorrNMF signature+sample embedding space)."""
    adatas = list(adatas)
    data = np.concatenate([_get_basis_obsm(a, basis) for a in adatas])
    if _warn_nothing_to_reduce(data.shape[1], "observation annotations"):
        return
    reduced = reduce_dimension_numpy(data, method=method, **kwargs)
    offset = 0
    for adata in adatas:
        adata.obsm[f"X_{method}"] = reduced[offset : offset + adata.n_obs, :]
        offset += adata.n_obs


def correlation_numpy(data: np.ndarray, **kwargs) -> np.ndarray:
    """Pearson correlation of the rows of 'data'."""
    return pd.DataFrame(data.T).corr(**kwargs).values


def correlation(adata, basis: str, **kwargs) -> None:
    """Compute and store the row correlation of adata.obsm[basis]."""
    adata.obsp["X_correlation"] = correlation_numpy(
        _get_basis_obsm(adata, basis), **kwargs
    )


# --------------------------------------------------------------------- #
# Rank selection from multi-start scan results (beyond-reference: the
# reference leaves choosing n_signatures entirely to the user - its
# tutorial loops fits over ranks and eyeballs the losses). The standard
# field practice (Alexandrov et al., SigProfiler) adds signature
# STABILITY across random restarts: real signatures reappear (cosine ~1)
# in every good restart, while overfit ranks split them into unstable
# noise components.
# --------------------------------------------------------------------- #


def _host(array) -> np.ndarray:
    """A host array of a stack that may live on the device (a
    RestartResult's W stays there): fetched once."""
    if isinstance(array, torch.Tensor):
        return array.cpu().numpy()
    return np.asarray(array)


def signature_stability(W_stack: np.ndarray,
                        best_index: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-signature stability of a multi-start fit.

    W_stack: (n_restarts, n_features, n_signatures) stack of signature
    matrices (parallel.RestartResult.W; a device tensor is fetched
    once). Each restart's signatures are optimally matched (Hungarian on
    cosine distance, as utils.match_signatures_pair) onto the reference
    restart `best_index`; the
    stability of signature j is its mean matched cosine similarity over
    the other restarts.

    Returns (per_signature (K,), matched (R, K)) cosine similarities;
    matched[best_index] is identically 1. With a single restart the
    per-signature stabilities are NaN (undefined, not perfect).

    Do NOT pass parallel.bootstrap_stability's result.signatures here:
    those are already Hungarian-matched replicates in the model's
    transposed (B, K, V) row orientation, with their cosines
    precomputed in result.similarities.
    """
    from scipy.optimize import linear_sum_assignment

    if W_stack is None:
        raise ValueError(
            "got None for W_stack - this result type exposes no "
            "per-restart signature stack"
        )
    W_stack = np.asarray(_host(W_stack), dtype=np.float64)
    if W_stack.ndim != 3:
        raise ValueError("W_stack must be (n_restarts, n_features, k)")
    n_restarts, _, k = W_stack.shape
    norms = np.linalg.norm(W_stack, axis=1, keepdims=True)
    units = W_stack / np.clip(norms, np.finfo(np.float64).tiny, None)
    ref = units[best_index]  # (V, K)
    matched = np.ones((n_restarts, k))
    for r in range(n_restarts):
        if r == best_index:
            continue
        sim = ref.T @ units[r]  # (K, K) pairwise cosine
        rows, cols = linear_sum_assignment(1.0 - sim)
        matched[r, rows] = sim[rows, cols]
    if n_restarts < 2:
        return np.full(k, np.nan), matched
    others = np.arange(n_restarts) != best_index
    return matched[others].mean(axis=0), matched


def _scan_point_signatures(res) -> tuple[np.ndarray, float, int]:
    """Normalize one scan point to ((R, V, K) host signature stack, best
    loss, sign): RestartResult carries W as (R, V, K) with losses
    MINIMIZED; CorrScanResult carries .signatures in the SAME (R, V, K)
    orientation but with ELBO MAXIMIZED (sign -1 so 'improvement' keeps
    one direction)."""
    if hasattr(res, "W") and res.W is not None:
        return _host(res.W), float(np.min(res.losses)), 1.0
    if getattr(res, "signatures", None) is not None:
        return (
            _host(res.signatures),
            float(np.max(res.losses)),
            -1.0,
        )
    raise TypeError(
        "scan point carries neither .W (RestartResult) nor .signatures "
        "(CorrScanResult) - cannot compute stability"
    )


def rank_selection_table(results: dict) -> pd.DataFrame:
    """Summarize a rank scan for model selection. Accepts the output of
    parallel.rank_scan_klnmf / rank_scan_mvnmf ({k: RestartResult},
    losses minimized) and parallel.rank_scan_corrnmf
    ({k | (k, m): CorrScanResult}, ELBO maximized).

    Columns per rank: best_loss (in the family's own direction),
    mean/min per-signature stability across restarts
    (signature_stability vs the best restart), and loss_improvement -
    the relative best-loss improvement vs the previous rank (NaN for the
    first; positive always means 'fits better'; NaN when the previous
    best loss is exactly zero, where a relative change is undefined).

    A (k, m)-keyed grid returns a (n_signatures, dim_embeddings)
    MultiIndex with loss_improvement chained over k WITHIN each m only -
    ELBOs across different embedding dimensions are differently
    regularized, so a cross-m 'improvement' would be meaningless.
    """
    if any(not isinstance(k, (int, np.integer)) for k in results):
        if not all(
            isinstance(key, tuple) and len(key) == 2 for key in results
        ):
            raise ValueError(
                "rank_selection_table takes {k: result} or "
                "{(k, m): result} scans"
            )
        by_m: dict = {}
        for (k, m), res in results.items():
            by_m.setdefault(m, {})[k] = res
        parts = []
        for m, points in sorted(by_m.items()):
            part = rank_selection_table(points)
            part["dim_embeddings"] = m
            parts.append(part.reset_index())
        return pd.concat(parts, ignore_index=True).set_index(
            ["n_signatures", "dim_embeddings"]
        )
    ranks = sorted(results)
    rows = []
    prev = None
    for k in ranks:
        W_stack, best_loss, sign = _scan_point_signatures(results[k])
        stab, _ = signature_stability(W_stack, results[k].best_index)
        improvement = (
            np.nan if prev is None or prev == 0.0
            else sign * (prev - best_loss) / abs(prev)
        )
        prev = best_loss
        rows.append({
            "n_signatures": k,
            "best_loss": best_loss,
            "mean_stability": float(np.mean(stab)),
            "min_stability": float(np.min(stab)),
            "loss_improvement": improvement,
        })
    return pd.DataFrame(rows).set_index("n_signatures")


def suggest_rank(results: dict, min_stability: float = 0.9):
    """Suggest n_signatures from a rank scan: the largest rank reachable
    through a CONTIGUOUS stable prefix - every scanned rank up to the
    suggestion must have all its signatures reproduce across restarts
    (min per-signature stability >= min_stability).

    This is the transparent core of the SigProfiler-style rule: past the
    true rank, extra components fit restart-specific noise and their
    matched cosine collapses, while the best-loss curve keeps creeping
    down (more parameters always fit better) - so stability, not loss,
    marks the boundary. The prefix requirement guards against noisy
    REBOUNDS: with few restarts, two noise components can match by
    chance at some k above an already-unstable one (observed on planted
    data: min stability 0.79 at k=4 but 0.80 at k=5 with k_true=3), and
    such an isolated pass says nothing. Inspect rank_selection_table()
    alongside; the loss_improvement column should corroborate with an
    elbow. Raises if the smallest scanned rank already fails (scan
    smaller ranks, add restarts, or lower the threshold).

    A (k, m)-keyed CorrNMF grid (rank_scan_corrnmf with
    dim_embeddings_range) returns {m: suggested_k} - the stability rule
    runs over k separately per embedding dimension (stability measures
    signature reproducibility, which is comparable within an m but
    confounded across m's differently-regularized posteriors).
    """
    if any(not isinstance(k, (int, np.integer)) for k in results):
        if not all(
            isinstance(key, tuple) and len(key) == 2 for key in results
        ):
            raise ValueError(
                "suggest_rank takes {k: result} or {(k, m): result} scans"
            )
        by_m: dict = {}
        for (k, m), res in results.items():
            by_m.setdefault(m, {})[k] = res
        return {
            m: suggest_rank(points, min_stability)
            for m, points in sorted(by_m.items())
        }
    table = rank_selection_table(results)
    if table["min_stability"].isna().any():
        raise ValueError(
            "signature stability is undefined with a single restart - "
            "rerun the scan with n_restarts >= 2 (more restarts sharpen "
            "the criterion)"
        )
    passes = (table["min_stability"] >= min_stability).to_numpy()
    if not passes[0]:
        raise ValueError(
            f"the smallest scanned rank already falls below "
            f"min_stability={min_stability} "
            f"(min {table['min_stability'].iloc[0]:.3f}) - scan smaller "
            "ranks, add restarts, or lower the threshold"
        )
    prefix_end = int(np.argmin(passes)) - 1 if not passes.all() else -1
    return int(table.index[prefix_end])


# --------------------------------------------------------------------- #
# ANNOTATION against a known catalog: name de novo signatures by their
# closest catalog entry (cosine), the standard step after discovery.
# --------------------------------------------------------------------- #


def _signatures_frame(signatures) -> pd.DataFrame:
    """Signatures as a (n_signatures, n_features) DataFrame from a fitted
    model, an AnnData of signatures, or a DataFrame (rows = signatures)."""
    if hasattr(signatures, "asignatures"):  # fitted model
        return signatures.signatures
    if hasattr(signatures, "obsm") and hasattr(signatures, "X"):
        return signatures.to_df()
    if isinstance(signatures, pd.DataFrame):
        return signatures
    raise TypeError(
        "signatures must be a fitted model, an AnnData of signatures or a "
        f"signatures-x-features DataFrame, got {type(signatures).__name__}."
    )


def annotate_signatures(
    signatures,
    catalog: pd.DataFrame,
    min_similarity: float = 0.8,
    unique: bool = False,
    rename: bool = False,
) -> pd.DataFrame:
    """Match signatures to their closest catalog entries by cosine.

    The step after de novo discovery: name each learned signature by the
    known catalog signature (e.g. COSMIC) it reproduces. Extends
    utils.match_to_catalog (reference utils.py:148-170 semantics, which
    returns only the matched catalog rows) with the similarity values, a
    runner-up column, a novelty flag, and optional in-place renaming.

    Args:
      signatures: fitted model, AnnData of signatures, or DataFrame with
        signatures as rows. Features must equal the catalog's as a set
        (order is realigned here).
      catalog: signatures-x-features DataFrame (datasets loader layout).
      min_similarity: below this cosine a signature is flagged novel
        (matched name still reported).
      unique: one-to-one Hungarian assignment instead of independent
        argmax (requires n_signatures <= catalog size). Use when the model
        rank is near the expected catalog subset so two learned signatures
        cannot claim the same catalog entry.
      rename: only with a fitted model - rename its signatures to the
        matched catalog names (novel ones keep their current name with
        "-like" appended to the match, e.g. "SBS3-like"); duplicates get
        ".1", ".2" suffixes. Renames propagate everywhere the model
        derives names (exposures columns, plots, checkpoints).

    Returns a DataFrame indexed by the current signature names with
    columns: matched, similarity, runner_up, runner_up_similarity, novel.
    """
    frame = _signatures_frame(signatures)
    if rename and not hasattr(signatures, "asignatures"):
        raise ValueError("rename=True requires a fitted model.")
    if not isinstance(catalog, pd.DataFrame):
        raise TypeError(
            f"catalog must be a DataFrame, got {type(catalog).__name__}."
        )
    features = set(map(str, frame.columns))
    if set(map(str, catalog.columns)) == features:
        cat = catalog
    elif set(map(str, catalog.index)) == features:
        cat = catalog.T
    else:
        raise ValueError(
            "catalog features do not match the signatures' features"
        )
    cat = cat.loc[:, frame.columns]

    S = frame.to_numpy(dtype=np.float64)
    C = cat.to_numpy(dtype=np.float64)
    tiny = np.finfo(np.float64).tiny
    S = S / np.clip(np.linalg.norm(S, axis=1, keepdims=True), tiny, None)
    C = C / np.clip(np.linalg.norm(C, axis=1, keepdims=True), tiny, None)
    similarity = S @ C.T  # (K, M)

    if unique:
        if frame.shape[0] > cat.shape[0]:
            raise ValueError(
                f"unique=True needs n_signatures ({frame.shape[0]}) <= "
                f"catalog size ({cat.shape[0]})"
            )
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(1.0 - similarity)
        best = np.empty(frame.shape[0], dtype=int)
        best[rows] = cols
    else:
        best = np.argmax(similarity, axis=1)

    best_sim = similarity[np.arange(frame.shape[0]), best]
    runner = similarity.copy()
    runner[np.arange(frame.shape[0]), best] = -np.inf
    second = np.argmax(runner, axis=1)
    second_sim = runner[np.arange(frame.shape[0]), second]

    catalog_names = [str(name) for name in cat.index]
    novel = best_sim < min_similarity
    table = pd.DataFrame(
        {
            "matched": [catalog_names[j] for j in best],
            "similarity": best_sim,
            "runner_up": [catalog_names[j] for j in second],
            "runner_up_similarity": second_sim,
            "novel": novel,
        },
        index=frame.index,
    )

    if rename:
        new_names, seen = [], {}
        for name, is_novel in zip(table["matched"], table["novel"]):
            candidate = f"{name}-like" if is_novel else name
            count = seen.get(candidate, 0)
            seen[candidate] = count + 1
            new_names.append(candidate if count == 0 else f"{candidate}.{count}")
        signatures.asignatures.obs_names = new_names
        table.index = pd.Index(new_names)
    return table


class DecompositionResult:
    """Sparse catalog decomposition of de novo signatures.

    weights: (de novo x catalog) mixture fractions, rows summing to 1,
      exact zeros off-support. active: bool supports. cosine: per-signature
      cosine between the original signature and its catalog reconstruction.
    table: long form (signature, component, weight), weights descending.
    """

    def __init__(self, weights, active, cosine, table, meta):
        self.weights = weights
        self.active = active
        self.cosine = cosine
        self.table = table
        self.meta = meta

    def __repr__(self):
        k, m = self.weights.shape
        return (
            f"DecompositionResult({k} signatures over {m} catalog entries, "
            f"mean support {float(self.active.to_numpy().sum(1).mean()):.1f}, "
            f"min cosine {float(self.cosine.min()):.4f})"
        )


def decompose_signatures(
    signatures,
    catalog,
    rel_tol: float = 0.02,
    abs_tol: float = 0.0,
    min_weight: float = 0.01,
    pseudo_total: float = 1e4,
    batch_size: int | None = None,
    device=None,
    dtype=None,
) -> DecompositionResult:
    """Decompose de novo signatures into sparse non-negative catalog
    mixtures (SigProfilerExtractor's 'decomposition' stage), e.g.
    "Sig2 = 0.62*SBS3 + 0.38*SBS5".

    Each signature, scaled to ``pseudo_total`` pseudo-counts, is one
    'sample' of the sparse assignment engine (``assign_signatures``):
    greedy backward elimination keeps the smallest support whose KL stays
    within ``(1 + rel_tol) * kl_dense + abs_tol`` of the full-catalog
    refit.

    Args:
      signatures: fitted model, AnnData of signatures, or DataFrame with
        signatures as rows (e.g. ``ExtractionResult.consensus[k]``).
      catalog: signatures-x-features DataFrame (datasets loader layout) or
        AnnData-like; features realigned to the signatures'.
      rel_tol / abs_tol: the elimination budget (abs_tol is in nats at the
        ``pseudo_total`` count scale).
      min_weight: after elimination, components below this mixture
        fraction are pruned and the remainder refit (ops.assign
        .refit_exposures), iterating until the support is stable; 0
        disables.
      pseudo_total: pseudo-count mass per signature; sets the KL scale.
      batch_size: chunk the signatures (see assign_signatures).
      device, dtype: as assign_signatures (None: the card, float32 there,
        float64 on the CPU).

    Returns a DecompositionResult; ``weights`` rows are renormalized to
    sum exactly one (the unnormalized refit masses, ~1 each, are kept in
    ``meta["mass"]``).
    """
    from .assign import _align_catalog, _setup, assign_signatures
    from .ops.assign import refit_exposures

    device, dtype = _setup(device, dtype, None)
    frame = _signatures_frame(signatures).astype(np.float64)
    rows = np.maximum(frame.to_numpy(), 0.0)
    totals = rows.sum(axis=1, keepdims=True)
    if not np.all(totals > 0):
        raise ValueError("every signature must have positive total mass")
    rows = rows / totals
    pseudo = pd.DataFrame(
        rows * float(pseudo_total), index=frame.index, columns=frame.columns
    )
    assignment = assign_signatures(
        pseudo, catalog, rel_tol=rel_tol, abs_tol=abs_tol,
        batch_size=batch_size, device=device, dtype=dtype,
    )
    exposures = assignment.exposures
    active = assignment.active
    W_cat, _ = _align_catalog(catalog, frame.columns)  # (V, K)

    if min_weight > 0:
        X_dev = torch.as_tensor(rows.T * float(pseudo_total), dtype=dtype,
                                device=device)          # (V, k)
        W_dev = torch.as_tensor(W_cat, dtype=dtype, device=device)
        keep = active.to_numpy()  # (k, K)
        for _ in range(10):
            w = exposures.to_numpy()
            w = w / np.clip(
                w.sum(axis=1, keepdims=True),
                np.finfo(np.float64).tiny, None,
            )
            new_keep = keep & (w >= min_weight)
            # never empty a signature's support: keep its largest component
            empty = ~new_keep.any(axis=1)
            if empty.any():
                new_keep[empty, np.argmax(w[empty], axis=1)] = True
            if (new_keep == keep).all():
                break
            keep = new_keep
            H, _ = refit_exposures(
                X_dev, W_dev, torch.as_tensor(keep.T, device=device))
            exposures = pd.DataFrame(
                H.cpu().numpy().T,
                index=exposures.index, columns=exposures.columns,
            )
        active = pd.DataFrame(
            keep, index=active.index, columns=active.columns
        )
        exposures = exposures.where(active, 0.0)

    mass = exposures.sum(axis=1) / float(pseudo_total)
    weights = exposures.div(exposures.sum(axis=1), axis=0)
    recon = weights.to_numpy() @ W_cat.T               # (k, V) row mixtures
    tiny = np.finfo(np.float64).tiny
    cosine = pd.Series(
        np.sum(rows * recon, axis=1) / np.clip(
            np.linalg.norm(rows, axis=1) * np.linalg.norm(recon, axis=1),
            tiny, None,
        ),
        index=frame.index, name="cosine",
    )

    records = []
    for name in weights.index:
        row = weights.loc[name]
        for component, weight in row[row > 0].sort_values(
            ascending=False
        ).items():
            records.append({
                "signature": name, "component": component,
                "weight": float(weight),
            })
    table = pd.DataFrame(records, columns=["signature", "component", "weight"])

    return DecompositionResult(
        weights=weights,
        active=active,
        cosine=cosine,
        table=table,
        meta={
            "rel_tol": rel_tol,
            "abs_tol": abs_tol,
            "pseudo_total": float(pseudo_total),
            "min_weight": min_weight,
            "mass": mass,
            "kl_dense": assignment.kl_dense,
            "kl_sparse": assignment.kl_sparse,
        },
    )
