"""KL-divergence NMF ops (objectives + Lee-Seung multiplicative updates),
held against salamander_tpu/ops/klnmf.py.

Conventions (kernel orientation, transposed wrt the container layer):
  X: (..., n_features V, n_samples D) counts
  W: (..., V, n_signatures K) signatures, columns sum to one
  H: (..., K, D) exposures
  weights_*: (..., D) per-sample weights or None (a leading axis when
             each lane fits its own samples, as a bootstrap replicate does)
  n_given_signatures: int - leading columns of W held fixed.

Every function is batched-native: a leading restart axis on W and H (and
optionally X) broadcasts through, and an objective returns one value per
leading index. Reductions run over the named trailing axes, so a single
problem and a batch of R restarts share one code path.

reduce_samples: under a sample-sharded mesh each rank holds a block of the
samples, and every sum over D is completed by this hook (an all_reduce over
the mesh's sample axis, parallel.mesh.sample_sum): the W-update numerator
before the column normalization, and the objective's total. The H update
is per sample and needs none. None (the default) means all samples are
local.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import mm, omm

EPSILON = float(np.finfo(np.float32).eps)


def kl_divergence(X, W, H, weights=None):
    r"""Generalized KL divergence D(X || WH) = sum X ln(X/WH) - X + WH.

    Terms with X==0 contribute only their +WH part (the x ln x limit).
    """
    return kl_of_product(X, omm(W, H), weights)


def kl_of_product(X, WH, weights=None):
    """kl_divergence of X against the product WH already formed."""
    nonzero = X != 0
    safe_ratio = torch.where(nonzero, X / torch.where(nonzero, WH, 1.0), 1.0)
    summands = torch.where(nonzero, X * torch.log(safe_ratio) - X, 0.0) + WH
    per_sample = summands.sum(-2)
    if weights is not None:
        per_sample = per_sample * weights
    return per_sample.sum(-1)


def samplewise_kl_divergence(X, W, H, weights=None):
    """Per-sample generalized KL divergence, shape (..., D).

    Where X==0, both X and WH are replaced by EPSILON inside the log ratio
    (making that term vanish), while the linear terms use the raw matrices.
    """
    zero = X == 0
    X_safe = torch.where(zero, EPSILON, X)
    WH_safe = torch.where(zero, EPSILON, omm(W, H))
    log_term = (X_safe * torch.log(X_safe / WH_safe)).sum(-2)
    signature_sums = W.sum(-2).unsqueeze(-1)  # (..., K, 1)
    errors = log_term - X.sum(-2) + omm(H.mT, signature_sums).squeeze(-1)
    if weights is not None:
        errors = errors * weights
    return errors


def poisson_llh_wo_factorial(X, W, H):
    """sum X ln(WH) - WH, skipping WH==0 log terms."""
    WH = omm(W, H)
    nonzero = WH != 0
    log_wh = torch.log(torch.where(nonzero, WH, 1.0))
    return (torch.where(nonzero, X * log_wh, 0.0) - WH).sum((-2, -1))


def poisson_llh(X, W, H):
    """Poisson log-likelihood generalized to real-valued X."""
    return poisson_llh_wo_factorial(X, W, H) - torch.lgamma(1.0 + X).sum(
        (-2, -1)
    )


def _given_columns(n_signatures: int, n_given: int, device):
    return torch.arange(n_signatures, device=device) < n_given


def _freeze_given_columns(W_new, W_old, n_given: int):
    """Restore the first 'n_given' columns of W_old into W_new."""
    if n_given == 0:
        return W_new
    given = _given_columns(W_new.shape[-1], n_given, W_new.device)
    return torch.where(given, W_old, W_new)


def _columns(weights):
    """Per-sample weights (..., D) shaped to scale the sample columns of a
    (..., rows, D) matrix."""
    return None if weights is None else weights.unsqueeze(-2)


def _clip(values):
    # torch.clamp_min keeps NaN, as jnp.maximum does
    return torch.clamp_min(values, EPSILON)


def sum_samples(reduce_samples, *partials):
    """Complete several partial sums over D with ONE reduce_samples call:
    the partials (one dtype) are flattened into one buffer, reduced and
    split back. Returns them as a tuple, unchanged when reduce_samples is
    None."""
    if reduce_samples is None or not partials:
        return partials
    flat = reduce_samples(torch.cat([p.reshape(-1) for p in partials]))
    out, at = [], 0
    for p in partials:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return tuple(out)


def update_W(X, W, H, weights_kl=None, n_given_signatures: int = 0):
    """Multiplicative W update under column-normalization.

    Only the free (non-given) columns are clipped to EPSILON, so given
    signatures pass through bit-exactly.
    """
    if n_given_signatures == W.shape[-1]:
        return W
    return update_W_from_numerator(
        W, w_numerator(X, W, H, weights_kl), n_given_signatures)


def w_numerator(X, W, H, weights_kl=None):
    """update_W's sum over D, (..., V, K): (X / WH) @ H^T."""
    aux = X / mm(W, H)
    if weights_kl is not None:
        aux = aux * _columns(weights_kl)
    return mm(aux, H.mT)


def update_W_from_numerator(W, numerator, n_given_signatures: int = 0):
    """update_W from its (reduced) w_numerator."""
    W_new = W * numerator
    W_new = W_new / W_new.sum(-2, keepdim=True)
    clipped = _clip(W_new)
    if n_given_signatures > 0:
        given = _given_columns(W.shape[-1], n_given_signatures, W.device)
        return torch.where(given, W, clipped)
    return clipped


def _update_H_from_aux(H, W, aux, weights_kl=None, weights_lhalf=None):
    """Shared H update given the precomputed ratio aux = X / (W @ H)."""
    weights_kl, weights_lhalf = _columns(weights_kl), _columns(weights_lhalf)
    WtAux = mm(W.mT, aux)
    if weights_lhalf is None:
        return _clip(H * WtAux)

    quad = 4.0 * H * WtAux
    if weights_kl is not None:
        quad = quad * weights_kl**2
    half_weight = weights_lhalf / 2.0
    root = torch.sqrt(half_weight**2 + quad)
    # (w/2 - root)^2 with root = sqrt((w/2)^2 + quad) cancels
    # catastrophically in float32 when quad << w^2;
    # root - w/2 = quad / (root + w/2) is the exact cancellation-free form.
    H_new = 0.25 * (quad / (root + half_weight)) ** 2
    if weights_kl is not None:
        H_new = H_new / weights_kl**2
    return _clip(H_new)


def update_H(X, W, H, weights_kl=None, weights_lhalf=None):
    """Multiplicative H update with optional weighted KL and l1/2 sparsity
    closed form."""
    aux = X / mm(W, H)
    return _update_H_from_aux(H, W, aux, weights_kl, weights_lhalf)


def update_WH(
    X, W, H, weights_kl=None, weights_lhalf=None, n_given_signatures: int = 0,
    reduce_samples=None,
):
    """Joint W,H update sharing one aux = X/(WH) computed from the OLD W,H.

    The per-iteration hot path of KLNMF. Unlike update_W, the whole updated
    W - including restored given columns - is clipped to EPSILON.
    """
    n_signatures = W.shape[-1]
    aux = X / mm(W, H)

    if n_given_signatures == n_signatures:
        W_new = W
    else:
        scaled_aux = aux if weights_kl is None else _columns(weights_kl) * aux
        W_new = W * sum_samples(reduce_samples, mm(scaled_aux, H.mT))[0]
        W_new = W_new / W_new.sum(-2, keepdim=True)
        W_new = _freeze_given_columns(W_new, W, n_given_signatures)
        W_new = _clip(W_new)

    # H uses the OLD W and the shared aux
    H_new = _update_H_from_aux(H, W, aux, weights_kl, weights_lhalf)
    return W_new, H_new


def normalize_wh(W, H):
    """Rescale W columns to sum one, pushing the factor into H rows."""
    scale = W.sum(-2)
    return W / scale.unsqueeze(-2), H * scale.unsqueeze(-1)


def lhalf_penalty(H, weights_lhalf):
    """The sparsity penalty term sum_d w_d * sum_k sqrt(H_kd)."""
    return (torch.sqrt(H).sum(-2) * weights_lhalf).sum(-1)


def klnmf_objective(X, W, H, weights_kl=None, weights_lhalf=None,
                    reduce_samples=None):
    """Full KLNMF objective: weighted KL + optional l1/2 penalty. Both
    sum over D, so under a sample-sharded mesh their local total is
    completed by one reduce_samples."""
    value = kl_divergence(X, W, H, weights_kl)
    if weights_lhalf is not None:
        value = value + lhalf_penalty(H, weights_lhalf)
    return sum_samples(reduce_samples, value)[0]


def make_step_functions(n_given_signatures: int = 0, reduce_samples=None):
    """The engine step functions of the KLNMF family.

    Both take (params, data) with params = {"W": (..., V, K),
    "H": (..., K, D)} and data = {"X": (V, D)} plus optional
    'weights_kl'/'weights_lhalf' entries. A leading restart axis on the
    params batches both. reduce_samples completes the sums over D of a
    sample-sharded fit (module docstring).
    """

    def update_fn(params, data):
        W, H = update_WH(
            data["X"],
            params["W"],
            params["H"],
            data.get("weights_kl"),
            data.get("weights_lhalf"),
            n_given_signatures,
            reduce_samples,
        )
        return {"W": W, "H": H}

    def objective_fn(params, data):
        return klnmf_objective(
            data["X"],
            params["W"],
            params["H"],
            data.get("weights_kl"),
            data.get("weights_lhalf"),
            reduce_samples,
        )

    return update_fn, objective_fn


def make_masked_step_functions(n_given_signatures: int = 0,
                               reduce_samples=None):
    """Rank-masked twin of make_step_functions for K-padded batching.

    params carry a boolean 'mask' (..., K) marking the active leading
    signatures. Masked-off H rows are held at exact zero, so W @ H, every
    aux ratio and every objective equal the unpadded rank-k computation;
    masked-off W columns pass through unchanged.
    """

    def update_fn(params, data):
        X = data["X"]
        W, H, mask = params["W"], params["H"], params["mask"]
        weights_kl = data.get("weights_kl")
        weights_lhalf = data.get("weights_lhalf")
        n_signatures = W.shape[-1]
        column_mask = mask.unsqueeze(-2)  # (..., 1, K)

        aux = X / mm(W, H)
        if n_given_signatures == n_signatures:
            W_new = W
        else:
            scaled_aux = aux if weights_kl is None else \
                _columns(weights_kl) * aux
            W_new = W * sum_samples(reduce_samples, mm(scaled_aux, H.mT))[0]
            # padded columns have all-zero numerators; keep their sum at 1
            column_sums = W_new.sum(-2, keepdim=True)
            W_new = W_new / torch.where(column_mask, column_sums, 1.0)
            W_new = _freeze_given_columns(W_new, W, n_given_signatures)
            W_new = _clip(W_new)
            W_new = torch.where(column_mask, W_new, W)

        H_new = _update_H_from_aux(H, W, aux, weights_kl, weights_lhalf)
        H_new = torch.where(mask.unsqueeze(-1), H_new, 0.0)
        return {"W": W_new, "H": H_new, "mask": mask}

    def objective_fn(params, data):
        # padded H rows are exactly zero, so the objective equals the
        # unpadded rank-k value without any masking of its own
        return klnmf_objective(
            data["X"],
            params["W"],
            params["H"],
            data.get("weights_kl"),
            data.get("weights_lhalf"),
            reduce_samples,
        )

    return update_fn, objective_fn


def pad_rank(W, H, n_padded: int):
    """Pad a rank-k problem to rank n_padded for the masked step functions.

    W: (..., V, k) -> (..., V, n_padded) with uniform dummy columns;
    H: (..., k, D) -> (..., n_padded, D) with exact-zero dummy rows;
    also returns the (n_padded,) activity mask.
    """
    k = W.shape[-1]
    if n_padded < k:
        raise ValueError(f"n_padded={n_padded} below rank {k}")
    extra = n_padded - k
    V = W.shape[-2]
    W_pad = torch.cat(
        [W, torch.full(W.shape[:-1] + (extra,), 1.0 / V, dtype=W.dtype,
                       device=W.device)],
        dim=-1,
    )
    H_pad = torch.cat(
        [H, torch.zeros(H.shape[:-2] + (extra,) + H.shape[-1:],
                        dtype=H.dtype, device=H.device)],
        dim=-2,
    )
    mask = torch.arange(n_padded, device=W.device) < k
    return W_pad, H_pad, mask
