"""Analysis tools, held against salamander_tpu/tools.py. Ported so far: the
sparse catalog decomposition of de novo signatures (decompose_signatures),
which runs on the assignment engine, and correlation_numpy (copied: the
models' sample and signature correlations); the rest of the module
(dimension reduction, rank selection, annotation, stability) waits for its
slice.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

__all__ = ["DecompositionResult", "correlation_numpy",
           "decompose_signatures"]


def correlation_numpy(data: np.ndarray, **kwargs) -> np.ndarray:
    """Pearson correlation of the rows of 'data'."""
    return pd.DataFrame(data.T).corr(**kwargs).values


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
