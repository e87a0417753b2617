"""Minimum-volume NMF (Leplat, Gillis & Ang, IEEE Trans. Signal Process. 68,
2020) with the generalized KL divergence, batched over lanes, and de novo
extraction through it, written plainly from the algorithm's statement.

The objective of a lane is KL(X || WH) + lam * logdet(W^T W + delta I),
W's columns on the unit simplex. An iteration:

1. H by the KL multiplicative update, H * W^T (X / WH) (W's columns sum
   to one), floored at float32's epsilon;
2. the closed-form minimum-volume W step: with Y the inverse of the Gram
   G = W^T W + delta I (through its Cholesky factor), Y- = max(-Y, 0),
   the H row sums h and the numerator matrix N = (X / WH) H^T,
   b = h - 4 lam W Y- and c = 8 lam (W |Y|) * N, each entry of W goes to
   W (sqrt(b^2 + c) - b) / (4 lam W |Y|), floored at float32's epsilon;
3. a backtracking search of each lane on its own gamma: the trial
   (1 - gamma) W + gamma W_step, renormalized (columns to sum one, the
   scale pushed into H's rows, both floored) and its objective evaluated;
   a trial worse than the objective at (W, H) shrinks gamma by 0.8 and
   tries again, until one is not worse or gamma is at most 1e-16; then
   gamma relaxes to min(1, 1.2 gamma) for the lane's next iteration.

The convergence rule is reference/klnmf.py's (blocks of conv_test_freq,
the objective after each, done lanes leave the batch). Departures from
the published description, each the port's stated arithmetic:

- sqrt(b^2 + c) - b is evaluated as c / (sqrt(b^2 + c) + b) where b > 0,
  the same number without the cancellation that breaks it in float32;
- every factor is floored at float32's epsilon, and the search stops at
  gamma <= 1e-16, where the description leaves both open;
- gamma starts at 1 for every lane of every fit.

The extraction draws its resamples and lane starts, clusters and ranks
with reference/extraction.py's functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .extraction import (
    consensus_cluster,
    lane_draws,
    lane_starts,
    multinomial_resamples,
    silhouettes,
    suggest_rank,
)
from .klnmf import EPS32, FLOAT64, Arith, effective_tol, kl

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GAMMA_FLOOR = 1e-16


def gram(W, delta: float, arith: Arith):
    K = W.shape[-1]
    return arith.mm(W.mT, W) + delta * torch.eye(K, dtype=W.dtype,
                                                  device=W.device)


def logdet(G):
    """log det of SPD Grams from their Cholesky factor."""
    L = torch.linalg.cholesky(G)
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def objective(X, W, H, lam: float, delta: float, arith: Arith):
    """KL + lam * logdet(W^T W + delta I) per lane."""
    return kl(X, W, H, arith.mm) + lam * logdet(gram(W, delta, arith))


def w_step(X, W, H, lam: float, delta: float, arith: Arith):
    """The closed-form minimum-volume W step (the module docstring's 2)."""
    Y = torch.cholesky_inverse(torch.linalg.cholesky(gram(W, delta, arith)))
    N = arith.mm(X / arith.mm(W, H), H.mT)
    h = H.sum(-1).unsqueeze(-2)
    WY_abs = arith.mm(W, torch.abs(Y))
    b = h - 4.0 * lam * arith.mm(W, torch.clamp_min(-Y, 0.0))
    c = 8.0 * lam * WY_abs * N
    root = torch.sqrt(b * b + c)
    numerator = torch.where(b > 0.0, c / (root + torch.abs(b)), root - b)
    return torch.clamp_min(W * numerator / (4.0 * lam * WY_abs), EPS32)


def renormalized(W_trial, H):
    scale = W_trial.sum(-2)
    return (torch.clamp_min(W_trial / scale.unsqueeze(-2), EPS32),
            torch.clamp_min(H * scale.unsqueeze(-1), EPS32))


def iteration(X, W, H, gamma, lam: float, delta: float, arith: Arith):
    """One iteration of every lane (the module docstring's 1-3); each
    lane's search runs until that lane stops, whatever the others do."""
    H = torch.clamp_min(H * arith.mm(W.mT, X / arith.mm(W, H)), EPS32)
    W_step = w_step(X, W, H, lam, delta, arith)
    start = objective(X, W, H, lam, delta, arith)
    W_new, H_new = renormalized(W_step, H)
    value = objective(X, W_new, H_new, lam, delta, arith)
    g = gamma.clone()
    searching = (value > start) & (g > GAMMA_FLOOR)
    while bool(searching.any()):
        rows = torch.nonzero(searching).squeeze(1)
        g[rows] = g[rows] * 0.8
        gl = g[rows].reshape(-1, 1, 1)
        W_t, H_t = renormalized((1.0 - gl) * W[rows] + gl * W_step[rows],
                                H[rows])
        value[rows] = objective(X[rows] if X.dim() == 3 else X, W_t, H_t,
                                lam, delta, arith)
        W_new[rows], H_new[rows] = W_t, H_t
        searching = (value > start) & (g > GAMMA_FLOOR)
    return W_new, H_new, torch.clamp_max(1.2 * g, 1.0)


def fit_lanes(X, W0, H0, lam: float, delta: float, min_iterations: int,
              max_iterations: int, conv_test_freq: int, tol: float,
              arith: Arith):
    """Fit every lane of W0 (L, V, K), H0 (L, K, D) against its own X
    (L, V, D), or a shared X (V, D), to the convergence rule, the
    objective in the precision of `arith`. Returns (W, H, losses as
    float64 numbers, iterations)."""
    X = X.to(arith.dtype)
    W, H = W0.to(arith.dtype).clone(), H0.to(arith.dtype).clone()
    n = W.shape[0]
    gamma = torch.ones(n, dtype=arith.dtype, device=W.device)

    def lanes_of(rows):
        return X if X.dim() == 2 else X[rows]

    def value(Xr, Wr, Hr):
        return objective(Xr, Wr, Hr, lam, delta, arith).to(torch.float64)

    alive = torch.arange(n, device=W.device)
    Xa = lanes_of(alive)
    prev = value(Xa, W, H)
    iterations = np.zeros(n, dtype=np.int64)
    it = 0
    while alive.numel() and it + conv_test_freq <= max_iterations:
        Wa, Ha, ga = W[alive], H[alive], gamma[alive]
        for _ in range(conv_test_freq):
            Wa, Ha, ga = iteration(Xa, Wa, Ha, ga, lam, delta, arith)
        it += conv_test_freq
        W[alive], H[alive], gamma[alive] = Wa, Ha, ga
        now = value(Xa, Wa, Ha)
        change = torch.abs(prev[alive] - now) / torch.abs(prev[alive])
        done = ((change < tol) & (it >= min_iterations)) | (
            it >= max_iterations)
        prev[alive] = now
        iterations[alive.cpu().numpy()] = it
        if bool(done.any()):
            alive = alive[~done]
            Xa = lanes_of(alive)
    tail = max_iterations - (max_iterations // conv_test_freq) * \
        conv_test_freq
    if alive.numel() and tail:
        Wa, Ha, ga = W[alive], H[alive], gamma[alive]
        for _ in range(tail):
            Wa, Ha, ga = iteration(Xa, Wa, Ha, ga, lam, delta, arith)
        W[alive], H[alive] = Wa, Ha
        iterations[alive.cpu().numpy()] = max_iterations
    losses = value(lanes_of(torch.arange(n, device=W.device)), W, H)
    return W, H, losses.cpu().numpy(), iterations


def extract(X, ranks, n_bootstraps: int, seed: int, fit_config,
            lam: float = 1.0, delta: float = 1.0, arith: Arith = FLOAT64,
            device=None):
    """The reference MvNMF extraction of counts X (V, D): per rank the
    lanes' penalized losses and iterations, the consensus (k, V) and the
    silhouettes, and the suggested rank."""
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
            X_boot, W0, H0, lam, delta, min_it, max_it, freq,
            effective_tol(tol), arith)
        stack = np.transpose(W.cpu().numpy().astype(np.float64), (0, 2, 1))
        consensus, matched = consensus_cluster(stack, int(np.argmin(losses)))
        out["ranks"][rank] = {
            "losses": losses, "iterations": iterations,
            "consensus": consensus, "silhouettes": silhouettes(matched),
        }
    out["suggested"] = suggest_rank(
        ranks, [np.min(out["ranks"][k]["silhouettes"]) for k in ranks])
    return out
