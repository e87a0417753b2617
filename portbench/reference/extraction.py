"""De novo consensus extraction as the port states it (extraction.py's
docstring), written plainly: multinomial count resamples, one fit of each
(rank, replicate) lane from its keyed start, the one-per-replicate
consensus clustering, cluster silhouettes and the rank suggestion.

The resamples and lane starts are drawn again here from the seed, as the
port states them: the resamples on the card from one torch.Generator
seeded with the seed, as a chain of conditional binomials over the
channels; each lane's start from numpy generators keyed by (seed, rank,
replicate, column). The clustering, silhouettes and rank rule are frozen
copies of salamander_tpu_torch/extraction.py:247-391 (numpy and scipy on
the host).
"""

from __future__ import annotations

import numpy as np
import torch

from .klnmf import EPS32, FLOAT64, Arith, effective_tol, fit_lanes


def multinomial_resamples(X32, generator, n_resamples: int):
    """Per sample, Multinomial(round(total), counts / total) per
    resample, as binomials channel by channel over the remaining total
    with the tail-normalized probability (the last channel takes the
    rest). Returns (n_resamples, V, D) float64."""
    X64 = X32.to(torch.float64)
    V, D = X64.shape
    totals = torch.round(X64.sum(0))
    probs = X64 / X64.sum(0)
    tails = torch.flip(torch.cumsum(torch.flip(probs, [0]), 0), [0])
    ratios = torch.where(tails > 0, probs / torch.where(tails > 0, tails,
                                                        1.0), 0.0)
    ratios = torch.clamp(ratios, 0.0, 1.0)
    remaining = totals.expand(n_resamples, D).clone()
    draws = torch.empty((n_resamples, V, D), dtype=torch.float64,
                        device=X32.device)
    for v in range(V - 1):
        count = torch.binomial(remaining,
                               ratios[v].expand(n_resamples, D).contiguous(),
                               generator=generator)
        draws[:, v] = count
        remaining = remaining - count
    draws[:, V - 1] = remaining
    return draws


def lane_draws(seed: int, rank: int, replicate: int, n_padded: int,
               V: int, D: int):
    """Exponential draws of one lane, column j from
    numpy.random.default_rng((seed, rank, replicate, j)): (n_padded, V)
    then (n_padded, D)."""
    draws_w = np.empty((n_padded, V))
    draws_h = np.empty((n_padded, D))
    for j in range(n_padded):
        rng = np.random.default_rng((int(seed), int(rank), int(replicate), j))
        draws_w[j] = rng.standard_exponential(V)
        draws_h[j] = rng.standard_exponential(D)
    return draws_w, draws_h


def lane_starts(X_lanes, draws_w, draws_h, rank: int):
    """Rank-`rank` starts of lanes X_lanes (L, V, D) from their padded
    draws (L, Kp, V), (L, Kp, D) in float32: normalized exponentials over
    the lane's first `rank` columns, exposures scaled to each sample's
    total, floored at float32's epsilon."""
    n_padded = draws_w.shape[1]
    mask = torch.arange(n_padded, device=X_lanes.device) < rank
    W = (draws_w / draws_w.sum(-1, keepdim=True)).transpose(1, 2)
    masked = torch.where(mask, draws_h.transpose(1, 2), 0.0)
    shares = masked / masked.sum(-1, keepdim=True)
    H = (shares * X_lanes.sum(1).unsqueeze(-1)).transpose(1, 2)
    W = torch.clamp_min(W, EPS32)[:, :, :rank]
    H = torch.clamp_min(H, EPS32)[:, :rank]
    return W.contiguous(), H.contiguous()


def _unit_rows(stack):
    norms = np.linalg.norm(stack, axis=-1, keepdims=True)
    return stack / np.clip(norms, np.finfo(np.float64).tiny, None)


def consensus_cluster(stack: np.ndarray, best_index: int,
                      max_iterations: int = 200):
    """B x k pooled row signatures -> k clusters of one signature per
    replicate: Hungarian matching on cosines against centroids seeded from
    the best-loss replicate, until the matching repeats. Returns
    (consensus rows summing to one, matched (B, k, V))."""
    from scipy.optimize import linear_sum_assignment

    n_replicates, k, _ = stack.shape
    units = _unit_rows(stack.astype(np.float64))
    centroids = units[best_index]
    perms = np.tile(np.arange(k), (n_replicates, 1))
    for _ in range(max_iterations):
        new_perms = np.empty_like(perms)
        for b in range(n_replicates):
            rows, cols = linear_sum_assignment(1.0 - centroids @ units[b].T)
            new_perms[b, rows] = cols
        matched_units = units[np.arange(n_replicates)[:, None], new_perms]
        centroids = _unit_rows(matched_units.mean(axis=0))
        if np.array_equal(new_perms, perms):
            break
        perms = new_perms
    matched = stack[np.arange(n_replicates)[:, None], perms]
    consensus = matched.mean(axis=0)
    return consensus / consensus.sum(axis=-1, keepdims=True), matched


def silhouettes(matched: np.ndarray) -> np.ndarray:
    """Per-cluster mean silhouette under cosine distance (NaN where B < 2
    or k < 2)."""
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
    mean_to[np.arange(k * n_replicates), labels] = np.inf
    b = mean_to.min(axis=1)
    s = (b - a) / np.maximum(np.maximum(a, b), np.finfo(np.float64).tiny)
    return s.reshape(k, n_replicates).mean(axis=1)


def suggest_rank(ranks, min_sil, min_stability: float = 0.8):
    """The largest rank whose minimum silhouette is at least
    min_stability (rank_rule 'largest'), skipping undefined ones; None if
    none is."""
    min_sil = np.asarray(min_sil, dtype=float)
    if np.isnan(min_sil).all():
        return None
    start = int(np.argmax(~np.isnan(min_sil)))
    passes = min_sil[start:] >= min_stability
    if not passes.any():
        return None
    return int(np.asarray(ranks)[start:][np.where(passes)[0][-1]])


def extract(X, ranks, n_bootstraps: int, seed: int, fit_config,
            arith: Arith = FLOAT64, device=None):
    """The reference extraction of counts X (V, D): per rank the lanes'
    losses and iterations, the consensus (k, V) and the silhouettes, and
    the suggested rank."""
    ranks = sorted(int(k) for k in ranks)
    X32 = torch.as_tensor(np.maximum(np.asarray(X), EPS32),
                          dtype=torch.float32, device=device)
    V, D = X32.shape
    n_padded = ranks[-1]
    generator = torch.Generator(device=X32.device).manual_seed(int(seed))
    X_boot = torch.clamp_min(
        multinomial_resamples(X32, generator, n_bootstraps).to(torch.float32),
        EPS32)
    min_it, max_it, freq, tol = fit_config
    out = {"ranks": {}}
    for rank in ranks:
        draws = [lane_draws(seed, rank, b, n_padded, V, D)
                 for b in range(n_bootstraps)]
        draws_w = torch.as_tensor(np.stack([d[0] for d in draws]),
                                  dtype=torch.float32, device=X32.device)
        draws_h = torch.as_tensor(np.stack([d[1] for d in draws]),
                                  dtype=torch.float32, device=X32.device)
        W0, H0 = lane_starts(X_boot, draws_w, draws_h, rank)
        W, _, losses, iterations = fit_lanes(
            X_boot, W0, H0, min_it, max_it, freq, effective_tol(tol), arith)
        stack = np.transpose(W.cpu().numpy().astype(np.float64), (0, 2, 1))
        consensus, matched = consensus_cluster(stack, int(np.argmin(losses)))
        out["ranks"][rank] = {
            "losses": losses, "iterations": iterations,
            "consensus": consensus, "silhouettes": silhouettes(matched),
        }
    out["suggested"] = suggest_rank(
        ranks, [np.min(out["ranks"][k]["silhouettes"]) for k in ranks])
    return out
