"""Minimum-volume NMF ops: the volume-regularized objective, the
unconstrained W update and the backtracking line search, held against
salamander_tpu/ops/mvnmf.py.

Every function is batched-native: W and H may carry leading restart (lane)
axes, X (V, D) broadcasts, objectives return one value per leading index,
and the line search's gamma is a tensor of the leading shape ((R,) for R
lanes, 0-d for one fit).

The (K, K) Gram factorizations run as batched ``torch.linalg`` on (..., K,
K) tensors, where the JAX package unrolls a scalar Cholesky to dodge tiny
linalg calls that serialize on its accelerator. The unrolled form floors
each pivot at ``EPSILON * diag`` so that a barely indefinite float32 Gram
stays finite; here ``cholesky_ex`` never raises, and a lane whose Gram
fails to factor is factored again with that floor added to its diagonal
(:func:`_cholesky`), without a host sync.

The backtracking search is a per-lane, data-dependent loop (a
``lax.while_loop`` under ``vmap`` in the JAX package). Here it is driven
from the host: it loops while any lane still searches, freezes the lanes
that have accepted, and so gives each lane the result of its own serial
search; each round costs one host sync.

reduce_samples (ops/klnmf.py): under a sample-sharded mesh every sum over
D is completed by this hook - the W step's numerator and H row sums with
the KL term of the objective the line search starts from (one call,
w_step_and_objective), and the KL term of every trial, so each trial's
accept test, and so every rank's loop, sees the same values. The volume
term does not sum over D.
"""

from __future__ import annotations

import torch

from .klnmf import EPSILON, kl_divergence, normalize_wh, sum_samples, update_H
from .precision import mm, omm

GAMMA_FLOOR = 1e-16  # the line search stops shrinking below this


def _eye_like(W):
    n = W.shape[-1]
    return torch.eye(n, dtype=W.dtype, device=W.device)


def _cholesky(gram):
    """Lower Cholesky factor of SPD (..., K, K) Grams that never raises.

    Lanes that fail to factor (float rounding can leave a Gram barely
    indefinite when delta is tiny) are factored again with EPSILON * diag
    added to the diagonal - the JAX package's pivot floor
    (``_chol_unrolled``) as a diagonal shift."""
    L, info = torch.linalg.cholesky_ex(gram)
    diagonal = torch.diagonal(gram, dim1=-2, dim2=-1)
    shifted = gram + torch.diag_embed(EPSILON * diagonal)
    L_floor, _ = torch.linalg.cholesky_ex(shifted)
    failed = (info != 0).unsqueeze(-1).unsqueeze(-1)
    return torch.where(failed, L_floor, L)


def _gram_logdet(gram):
    """log det of SPD Grams: 2 sum log diag(L)."""
    L = _cholesky(gram)
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def _gram_inverse(gram):
    """Inverse of SPD Grams through their Cholesky factor."""
    return torch.cholesky_inverse(_cholesky(gram))


def _gram(W, delta):
    return omm(W.mT, W) + delta * _eye_like(W)


def volume_logdet(W, delta: float):
    """log det(W^T W + delta I) - the signature-simplex volume surrogate."""
    return _gram_logdet(_gram(W, delta))


def kl_divergence_penalized(X, W, H, lam: float, delta: float,
                            reduce_samples=None):
    """The MvNMF objective: generalized KL plus lam * volume."""
    return (sum_samples(reduce_samples, kl_divergence(X, W, H))[0]
            + lam * volume_logdet(W, delta))


def _w_sums(X, W, H):
    """The W step's sums over D: (X / WH) @ H^T (..., V, K) and the H row
    sums (..., K)."""
    return mm(X / mm(W, H), H.mT), H.sum(-1)


def _min_volume_step(W, lam, Y, ratio_H, rowsums_H):
    """The closed-form minimum-volume multiplicative W step, given the Gram
    inverse Y and the step's (reduced) _w_sums (before clipping)."""
    Y_minus = torch.clamp_min(-Y, 0.0)
    Y_abs = torch.abs(Y)
    WY_minus = mm(W, Y_minus)
    WY_abs = mm(W, Y_abs)

    linear = rowsums_H.unsqueeze(-2) - 4.0 * lam * WY_minus  # (..., V, K)
    disc_ratio = 8.0 * lam * WY_abs * ratio_H
    root = torch.sqrt(linear**2 + disc_ratio)
    # numerator = sqrt(linear^2 + d) - linear. Evaluated literally it
    # cancels catastrophically in float32 when d << linear^2 (the fit then
    # oscillates and runs into the iteration cap); for positive `linear`
    # the equivalent d / (sqrt(linear^2 + d) + linear) is cancellation-free.
    numerator = torch.where(
        linear > 0.0,
        disc_ratio / (root + torch.abs(linear)),
        root - linear,
    )
    denominator = 4.0 * lam * WY_abs
    return W * numerator / denominator


def _freeze_given(W_new, W, n_given_signatures: int):
    if n_given_signatures == 0:
        return W_new
    given = torch.arange(W.shape[-1], device=W.device) < n_given_signatures
    return torch.where(given, W, W_new)


def update_W_unconstrained(X, W, H, lam: float, delta: float,
                           n_given_signatures: int = 0):
    """Closed-form minimum-volume multiplicative W step (before the
    normalization line search). Given columns are frozen and left unclipped.
    """
    return w_step_and_objective(X, W, H, lam, delta, n_given_signatures)[0]


def w_step_and_objective(X, W, H, lam: float, delta: float,
                         n_given_signatures: int = 0, reduce_samples=None,
                         mask=None):
    """update_W_unconstrained and the objective at (W, H) that the line
    search starts from: under a sample-sharded mesh their sums over D share
    one reduce_samples call. With a rank `mask` the Gram inverse is the
    identity-padded one and padded W columns are restored unchanged.
    Returns (W_unconstrained, objective)."""
    gram = _gram(W, delta) if mask is None else _masked_gram(W, delta, mask)
    ratio_H, rowsums_H, kl = sum_samples(
        reduce_samples, *_w_sums(X, W, H), kl_divergence(X, W, H))
    step = _min_volume_step(W, lam, _gram_inverse(gram), ratio_H, rowsums_H)
    W_new = _freeze_given(torch.clamp_min(step, EPSILON), W,
                          n_given_signatures)
    if mask is not None:
        W_new = torch.where(mask.unsqueeze(-2), W_new, W)
    return W_new, kl + lam * _gram_logdet(gram)


def _renormalized_objective(X, W_trial, H, lam, delta, reduce_samples=None):
    """Normalize the trial W (pushing scale into H), clip, and evaluate."""
    W_new, H_new = normalize_wh(W_trial, H)
    W_new = torch.clamp_min(W_new, EPSILON)
    H_new = torch.clamp_min(H_new, EPSILON)
    return W_new, H_new, kl_divergence_penalized(X, W_new, H_new, lam, delta,
                                                 reduce_samples)


def _lanes(flag, like):
    """Broadcast a per-lane flag (leading shape) against a (..., a, b)
    tensor."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def _serial_search(W, W_unconstrained, gamma, prev_objective, renormalize):
    """Per-lane serial backtracking: each lane shrinks gamma by 0.8 while its
    trial objective is worse than prev_objective and gamma > GAMMA_FLOOR;
    the first trial is the full unconstrained step. Accepted lanes are
    frozen, so every lane gets exactly its own serial result."""
    W_new, H_new, of_value = renormalize(W_unconstrained)
    g = gamma
    searching = (of_value > prev_objective) & (g > GAMMA_FLOOR)
    while bool(searching.any()):  # one host sync per trial
        g = torch.where(searching, g * 0.8, g)
        g_lanes = _lanes(g, W)
        W_trial = (1.0 - g_lanes) * W + g_lanes * W_unconstrained
        W_t, H_t, of_t = renormalize(W_trial)
        W_new = torch.where(_lanes(searching, W_new), W_t, W_new)
        H_new = torch.where(_lanes(searching, H_new), H_t, H_new)
        of_value = torch.where(searching, of_t, of_value)
        searching = (of_value > prev_objective) & (g > GAMMA_FLOOR)
    return W_new, H_new, torch.clamp_max(1.2 * g, 1.0)


def _batched_search(W, W_unconstrained, gamma, prev_objective, renormalize,
                    trial_batch: int):
    """trial_batch shrink candidates per round, evaluated as one pass over a
    leading trial axis; each lane accepts its first trial that satisfies
    the serial exit rule (objective not worse, or gamma at the floor)."""
    def shrink_chain(g):
        # bitwise the serial loop's repeated g *= 0.8
        chain = []
        for _ in range(trial_batch):
            g = g * 0.8
            chain.append(g)
        return torch.stack(chain)  # (T, ...)

    def eval_trials(gs):
        g_lanes = _lanes(gs, W.unsqueeze(0))
        return renormalize((1.0 - g_lanes) * W + g_lanes * W_unconstrained)

    def select(found_prior, W_prior, H_prior, g_prior, gs, Ws, Hs, ofs):
        ok = (ofs <= prev_objective) | (gs <= GAMMA_FLOOR)
        found = ok.any(0)
        idx = ok.to(torch.int8).argmax(0)  # first accepting trial
        W_pick = torch.take_along_dim(Ws, _lanes(idx, W)[None], 0)[0]
        H_pick = torch.take_along_dim(Hs, _lanes(idx, H_prior)[None], 0)[0]
        g_pick = torch.take_along_dim(gs, idx[None], 0)[0]
        W_sel = torch.where(_lanes(found_prior, W_prior), W_prior, W_pick)
        H_sel = torch.where(_lanes(found_prior, H_prior), H_prior, H_pick)
        g_sel = torch.where(found_prior, g_prior, g_pick)
        # carry the chain on from the round's last gamma while nothing
        # accepted yet
        g_next = torch.where(found_prior | found, g_sel, gs[-1])
        return found_prior | found, W_sel, H_sel, g_next

    W0, H0, of0 = renormalize(W_unconstrained)
    gs = shrink_chain(gamma)
    carry = select((of0 <= prev_objective) | (gamma <= GAMMA_FLOOR),
                   W0, H0, gamma, gs, *eval_trials(gs))
    while not bool(carry[0].all()):  # one host sync per round
        found, W_cur, H_cur, g = carry
        gs = shrink_chain(g)
        carry = select(found, W_cur, H_cur, g, gs, *eval_trials(gs))
    _, W_new, H_new, g = carry
    return W_new, H_new, torch.clamp_max(1.2 * g, 1.0)


def _as_gamma(gamma, W):
    """gamma as a tensor of W's dtype and device (leading shape of W)."""
    return torch.as_tensor(gamma, dtype=W.dtype, device=W.device)


def line_search(X, W, H, lam: float, delta: float, gamma, W_unconstrained,
                trial_batch: int = 1, reduce_samples=None,
                prev_objective=None):
    """Backtracking line search on the interpolation parameter gamma.

    Carries gamma across outer iterations (the caller persists it; one
    value per lane). Returns (W_new, H_new, gamma_new), gamma relaxed to
    min(1, 1.2 * gamma) after the search.

    trial_batch > 1 evaluates that many shrink candidates per round as one
    batched objective pass and accepts the first trial satisfying the
    serial loop's exit rule; the gamma chain is bitwise the serial one, so
    away from accept-boundary ties the result is the serial result (the
    JAX package's batched mode, which its model layer leaves off by
    default). prev_objective: the objective at (W, H) where the caller has
    it (w_step_and_objective).
    """
    gamma = _as_gamma(gamma, W)
    if prev_objective is None:
        prev_objective = kl_divergence_penalized(X, W, H, lam, delta,
                                                 reduce_samples)

    def renormalize(W_trial):
        return _renormalized_objective(X, W_trial, H, lam, delta,
                                       reduce_samples)

    if trial_batch <= 1:
        return _serial_search(W, W_unconstrained, gamma, prev_objective,
                              renormalize)
    return _batched_search(W, W_unconstrained, gamma, prev_objective,
                           renormalize, int(trial_batch))


# ---------------------------------------------------------------------------
# rank-masked twins: problems of different rank k share one padded rank Kp
# (the K-padded rank scans). Padded H rows are exact zeros and padded W
# columns pass through unchanged; the volume term and the (Kp, Kp) inverse
# see an identity-padded Gram, so the active block's logdet and inverse
# equal the rank-k values exactly (block-diagonal determinant/inverse).
# ---------------------------------------------------------------------------


def _masked_gram(W, delta, mask):
    """(W^T W + delta I) with padded rows/columns replaced by identity:
    blockdiag(active Gram + delta I, I). mask is (..., Kp) bool."""
    eye = _eye_like(W)
    both = mask.unsqueeze(-1) & mask.unsqueeze(-2)
    return torch.where(both, _gram(W, delta), eye)


def volume_logdet_masked(W, delta, mask):
    """log det of the ACTIVE signatures' Gram block (identity padding
    contributes log det I = 0)."""
    return _gram_logdet(_masked_gram(W, delta, mask))


def kl_divergence_penalized_masked(X, W, H, lam, delta, mask,
                                   reduce_samples=None):
    """Rank-k MvNMF objective through the Kp-padded arrays: padded H rows
    are exact zeros (KL term exact), padded Gram rows are identity (volume
    term exact)."""
    return (sum_samples(reduce_samples, kl_divergence(X, W, H))[0]
            + lam * volume_logdet_masked(W, delta, mask))


def _renormalized_objective_masked(X, W_trial, H, lam, delta, mask,
                                   reduce_samples=None):
    """normalize + clip + evaluate, keeping padded lanes EXACTLY inert:
    padded H rows stay exact zeros and padded W columns bypass the
    normalization."""
    W_new, H_new = normalize_wh(W_trial, H)
    W_new = torch.where(mask.unsqueeze(-2), torch.clamp_min(W_new, EPSILON),
                        W_trial)
    H_new = torch.where(mask.unsqueeze(-1), torch.clamp_min(H_new, EPSILON),
                        0.0)
    return W_new, H_new, kl_divergence_penalized_masked(
        X, W_new, H_new, lam, delta, mask, reduce_samples
    )


def line_search_masked(X, W, H, lam, delta, gamma, W_unconstrained, mask,
                       reduce_samples=None, prev_objective=None):
    """line_search (serial) through the masked objective and
    renormalization."""
    gamma = _as_gamma(gamma, W)
    if prev_objective is None:
        prev_objective = kl_divergence_penalized_masked(
            X, W, H, lam, delta, mask, reduce_samples)

    def renormalize(W_trial):
        return _renormalized_objective_masked(X, W_trial, H, lam, delta,
                                              mask, reduce_samples)

    return _serial_search(W, W_unconstrained, gamma, prev_objective,
                          renormalize)


def make_masked_step_functions(lam: float, delta: float,
                               n_given_signatures: int = 0,
                               reduce_samples=None):
    """Rank-masked MvNMF engine step for K-padded rank scans.

    params = {"W": (..., V, Kp), "H": (..., Kp, D), "gamma": (...,),
    "mask": (..., Kp)}; data = {"X": (V, D)}. Each active lane computes
    the rank-k MvNMF iteration (H multiplicative update, then the min-vol
    W update with backtracking line search and per-lane persistent
    gamma); padded lanes are inert. reduce_samples completes the sums
    over D of a sample-sharded fit (module docstring)."""

    def update_fn(params, data):
        X = data["X"]
        W, mask = params["W"], params["mask"]
        H = torch.where(mask.unsqueeze(-1), update_H(X, W, params["H"]), 0.0)
        W_unconstrained, objective = w_step_and_objective(
            X, W, H, lam, delta, n_given_signatures, reduce_samples, mask)
        W, H, gamma = line_search_masked(
            X, W, H, lam, delta, params["gamma"], W_unconstrained, mask,
            reduce_samples, objective
        )
        return {"W": W, "H": H, "gamma": gamma, "mask": mask}

    def objective_fn(params, data):
        return kl_divergence_penalized_masked(
            data["X"], params["W"], params["H"], lam, delta, params["mask"],
            reduce_samples
        )

    return update_fn, objective_fn
