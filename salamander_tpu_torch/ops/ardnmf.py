"""ARD-NMF ops: KL-divergence NMF with automatic relevance determination,
held against salamander_tpu/ops/ardnmf.py.

Tan & Fevotte, "Automatic relevance determination in nonnegative matrix
factorization with the beta-divergence" (IEEE TPAMI 2013), beta=1. Each
component k carries a relevance lambda_k tying column w_k and row h_k
through exponential (``prior='L1'``) or half-normal (``prior='L2'``)
priors of scale lambda_k, with an inverse-gamma(a, b) hyperprior on
lambda_k. The MAP objective (to MINIMIZE) is

    C(W, H, lam) = D_KL(X | WH)
                   + sum_k (f(w_k) + f(h_k) + b) / lam_k
                   + c * sum_k log lam_k

with, per prior:
    L1: f(u) = sum(u)          c = V + D + a + 1
    L2: f(u) = 0.5 * sum(u^2)  c = (V + D) / 2 + a + 1

(V = n_features, D = n_samples). Sequential majorize-minimize updates (H,
then W, then the closed-form lambda) each decrease C. Unsupported
components collapse to the EPSILON floor with lambda_k -> b / c; counting
the lambda_k above that floor gives the effective rank.

Conventions as ops/klnmf.py: X (V, D), W (..., V, K), H (..., K, D), lam
(..., K); every function is batched-native over leading restart axes. The
hyperparameters ride in the data dict as ``ard_ab = [a, b]``. The host
numpy helpers (default_b, relevance_excess, active_components) are copied.

reduce_samples (ops/klnmf.py): under a sample-sharded mesh each rank holds
a block of the samples, and every sum over D - the W numerator and H row
sums, f(h_k), the KL term, and the sample count D inside the constant c -
is completed by this hook, one call per iteration (update_whl) and one
per objective.
"""

from __future__ import annotations

import numpy as np
import torch

from .klnmf import EPSILON, kl_divergence, sum_samples
from .precision import mm

PRIORS = ("L1", "L2")


def prior_constant(prior: str, n_features: int, n_samples: int, a):
    """The log-lambda coefficient c of the MAP objective (see module doc)."""
    if prior == "L1":
        return n_features + n_samples + a + 1.0
    if prior == "L2":
        return (n_features + n_samples) / 2.0 + a + 1.0
    raise ValueError(f"Unknown ARD prior {prior!r}: use one of {PRIORS}.")


def default_b(prior: str, mean_x: float, n_signatures: int, a: float) -> float:
    """Data-driven inverse-gamma scale b (Tan & Fevotte's moment matching):
    choose b so the prior expectation of each reconstructed entry
    E[(WH)_vd] equals the empirical mean of X.

    L1 (exponential priors, E[w h | lam] = lam^2, E[lam^2] = b^2/((a-1)(a-2))):
        K * b^2 / ((a-1)(a-2)) = mean(X)  =>  b = sqrt((a-1)(a-2) mean(X) / K)
        (requires a > 2)
    L2 (half-normal priors, E[w h | lam] = 2 lam / pi, E[lam] = b/(a-1)):
        K * 2 b / (pi (a-1)) = mean(X)    =>  b = pi (a-1) mean(X) / (2 K)
        (requires a > 1)
    """
    if prior == "L1":
        if a <= 2.0:
            raise ValueError(
                "The default b for prior='L1' needs a > 2 (finite prior "
                f"second moment); got a={a}. Pass b explicitly."
            )
        return float(np.sqrt((a - 1.0) * (a - 2.0) * mean_x / n_signatures))
    if prior == "L2":
        if a <= 1.0:
            raise ValueError(
                "The default b for prior='L2' needs a > 1 (finite prior "
                f"mean); got a={a}. Pass b explicitly."
            )
        return float(np.pi * (a - 1.0) * mean_x / (2.0 * n_signatures))
    raise ValueError(f"Unknown ARD prior {prior!r}: use one of {PRIORS}.")


def _f_w(W, prior: str):
    """f(w_k) per component, shape (..., K)."""
    return W.sum(-2) if prior == "L1" else 0.5 * (W**2).sum(-2)


def _f_h(H, prior: str):
    """f(h_k) per component, shape (..., K): a sum over D."""
    return H.sum(-1) if prior == "L1" else 0.5 * (H**2).sum(-1)


def _local_count(H):
    """This rank's sample count, (..., 1): sum_samples completes it to D."""
    return torch.full_like(H[..., :1, 0], float(H.shape[-1]))


def _hyperparameters(n_features: int, n_samples, ard_ab, prior: str):
    """(b, c) shaped to broadcast against a (..., K) component vector."""
    a, b = ard_ab[..., 0:1], ard_ab[..., 1:2]
    return b, prior_constant(prior, n_features, n_samples, a)


def _lambda_from(W, f_h, n_samples, ard_ab, prior: str):
    b, c = _hyperparameters(W.shape[-2], n_samples, ard_ab, prior)
    return (_f_w(W, prior) + f_h + b) / c


def update_lambda(W, H, ard_ab, prior: str):
    """Closed-form exact minimizer of C in lam: (f(w)+f(h)+b) / c."""
    return _lambda_from(W, _f_h(H, prior), H.shape[-1], ard_ab, prior)


def ard_objective(X, W, H, lam, ard_ab, prior: str, reduce_samples=None):
    """The MAP objective C(W, H, lam) to minimize (module docstring); the
    KL term is ops/klnmf.kl_divergence (X==0 terms contribute only +WH)."""
    kl, f_h, n_samples = sum_samples(reduce_samples, kl_divergence(X, W, H),
                                     _f_h(H, prior), _local_count(H))
    b, c = _hyperparameters(W.shape[-2], n_samples, ard_ab, prior)
    penalty = ((_f_w(W, prior) + f_h + b) / lam).sum(-1)
    return kl + penalty + c.squeeze(-1) * torch.log(lam).sum(-1)


def update_H(X, W, H, lam, prior: str):
    """MM update of H at fixed W, lam (Tan & Fevotte Alg. 1, beta=1).

    L1: H <- H * (W^T (X/WH)) / (colsum(W) + 1/lam)          (exponent 1)
    L2: H <- H * sqrt((W^T (X/WH)) / (colsum(W) + H/lam))    (exponent 1/2)
    """
    numerator = mm(W.mT, X / mm(W, H))
    col_w = W.sum(-2).unsqueeze(-1)
    if prior == "L1":
        H_new = H * numerator / (col_w + (1.0 / lam).unsqueeze(-1))
    else:
        H_new = H * torch.sqrt(numerator / (col_w + H / lam.unsqueeze(-1)))
    return torch.clamp_min(H_new, EPSILON)


def update_W(X, W, H, lam, prior: str, n_given_signatures: int = 0):
    """MM update of W at fixed H, lam; leading given columns frozen exactly
    (no renormalization: ARD signatures carry their scale, which is what
    lambda measures)."""
    if n_given_signatures == W.shape[-1]:
        return W
    return _update_W_from(W, mm(X / mm(W, H), H.mT), H.sum(-1), lam, prior,
                          n_given_signatures)


def _update_W_from(W, numerator, row_h, lam, prior: str,
                   n_given_signatures: int):
    """update_W from its sums over D: the numerator (..., V, K) and the H
    row sums (..., K)."""
    n_signatures = W.shape[-1]
    row_h = row_h.unsqueeze(-2)
    if prior == "L1":
        W_new = W * numerator / (row_h + (1.0 / lam).unsqueeze(-2))
    else:
        W_new = W * torch.sqrt(numerator / (row_h + W / lam.unsqueeze(-2)))
    W_new = torch.clamp_min(W_new, EPSILON)
    if n_given_signatures > 0:
        given = torch.arange(n_signatures, device=W.device) \
            < n_given_signatures
        return torch.where(given, W, W_new)
    return W_new


def update_whl(X, W, H, lam, ard_ab, prior: str, n_given_signatures: int = 0,
               reduce_samples=None):
    """One full ARD iteration: H, then W (fresh ratio), then lambda. Under
    a sample-sharded mesh the W step's and lambda's sums over D (H is not
    touched in between) share one reduce_samples call."""
    H = update_H(X, W, H, lam, prior)
    numerator, row_h, f_h, n_samples = sum_samples(
        reduce_samples, mm(X / mm(W, H), H.mT), H.sum(-1), _f_h(H, prior),
        _local_count(H))
    if n_given_signatures != W.shape[-1]:
        W = _update_W_from(W, numerator, row_h, lam, prior,
                           n_given_signatures)
    return W, H, _lambda_from(W, f_h, n_samples, ard_ab, prior)


def init_params(W, H, ard_ab, prior: str, n_given_signatures: int = 0):
    """Build the ARD parameter dict from any (W, H) initialization.

    Rebalances each free component's W/H scales (WH-invariant: w_k *= s_k,
    h_k /= s_k with s_k chosen so f(w_k) = f(h_k)); given (frozen) leading
    columns pass through unscaled. Returns {"W", "H", "lam"} with the
    closed-form lambda at the rebalanced point; batched-native, so one call
    initializes every restart lane. A mesh's ranks initialize the whole
    cohort before it is sharded, so this needs no reduce_samples."""
    fw, fh = _f_w(W, prior), _f_h(H, prior)
    power = 0.5 if prior == "L1" else 0.25
    scale = (fh / torch.clamp_min(fw, EPSILON)) ** power
    if n_given_signatures > 0:
        given = torch.arange(scale.shape[-1], device=W.device) \
            < n_given_signatures
        scale = torch.where(given, 1.0, scale)
    W = torch.clamp_min(W * scale.unsqueeze(-2), EPSILON)
    H = torch.clamp_min(H / scale.unsqueeze(-1), EPSILON)
    return {"W": W, "H": H,
            "lam": update_lambda(W, H, ard_ab, prior)}


def make_step_functions(prior: str, n_given_signatures: int = 0,
                        reduce_samples=None):
    """Engine step functions of the ARDNMF family.

    params = {"W": (..., V, K), "H": (..., K, D), "lam": (..., K)};
    data = {"X": (V, D), "ard_ab": (2,) tensor [a, b]}. reduce_samples
    completes the sums over D of a sample-sharded fit (module docstring).
    """
    if prior not in PRIORS:
        raise ValueError(f"Unknown ARD prior {prior!r}: use one of {PRIORS}.")

    def update_fn(params, data):
        W, H, lam = update_whl(
            data["X"], params["W"], params["H"], params["lam"],
            data["ard_ab"], prior, n_given_signatures, reduce_samples,
        )
        return {"W": W, "H": H, "lam": lam}

    def objective_fn(params, data):
        return ard_objective(
            data["X"], params["W"], params["H"], params["lam"],
            data["ard_ab"], prior, reduce_samples,
        )

    return update_fn, objective_fn


def relevance_excess(lam, ard_ab, prior: str, n_features: int,
                     n_samples: int) -> np.ndarray:
    """Per-component relevance above the prior's resting value, normalized:

        e_k = (c * lam_k - b) / b = (f(w_k) + f(h_k)) / b

    A pruned component's W/H sit at the EPSILON floor, so e_k ~ (V+D)*eps/b
    (orders of magnitude below any data-supported component's e_k). Host
    numpy: the rank readout runs post-fit on container data."""
    lam = np.asarray(lam)
    a, b = float(np.asarray(ard_ab)[0]), float(np.asarray(ard_ab)[1])
    c = prior_constant(prior, n_features, n_samples, a)
    return (c * lam - b) / b


def active_components(lam, ard_ab, prior: str, n_features: int,
                      n_samples: int, active_tol: float = 1e-2) -> np.ndarray:
    """Boolean (K,) mask of data-supported components: relevance excess at
    least `active_tol` times the largest component's. Host numpy."""
    excess = relevance_excess(lam, ard_ab, prior, n_features, n_samples)
    return excess >= active_tol * np.max(excess)
