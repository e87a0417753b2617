"""Correlated-NMF ops: exposures, the sufficient statistic, the ELBO, the
closed-form scaling updates and the batched damped Newton solve of the
embeddings, held against salamander_tpu/ops/corrnmf.py.

Conventions (model orientation, samples as rows):
  X: (D, V) counts; signatures (..., K, V); exposures (..., D, K)
  signature_scalings (..., K), sample_scalings (..., D)
  signature_embeddings (..., K, m), sample_embeddings (..., D, m)
  variance (...,) - one value per restart lane (0-d for one fit).

Every function is batched-native: leading restart (lane) axes broadcast
through, and X may stay unbatched.

The embedding M-step solves every row with damped Newton and a vectorized
41-candidate Armijo backtracking (the first candidate that passes is taken;
2^-40 always passes). The (m, m) Newton systems are factored by batched
``torch.linalg.cholesky_ex`` (ops/mvnmf.py ``_cholesky``: a row whose
Hessian fails to factor is factored again with EPSILON * diag added, with
no host sync), where the JAX package unrolls Cramer and Cholesky solves to
keep tiny linalg calls off its accelerator. Every Newton product runs in
IEEE float32 or float64: under reduced precision the Hessian, a rank-k sum
plus I/variance with rates ~1e4-1e5, goes indefinite (the JAX package saw
it on its accelerator, salamander_tpu/ops/corrnmf.py:36-46).

The signature side (up to 100 Newton steps) stops, as the JAX package's
early-exit loop does, when every row is done: the host checks once per
step, and done rows are frozen with ``torch.where``, so extra masked steps
give the early-exit result. The sample side (3 steps, the reference's
scipy maxiter) runs its steps unconditionally.

reduce_samples (ops/klnmf.py): under a sample-sharded mesh each rank holds
a block of the samples (rows of X, the sample scalings and embeddings),
and every sum over them is completed by this hook: the ELBO's likelihood,
sample penalty and sample count, the signature scalings' two sums, the
variance's sample sum and count, and, in the signature-side Newton solve
(whose "other" rows are the samples), the linear term, the gradient,
Hessian and objective sums of each step (one call) and the Armijo
candidates' sums (a second). Every branch then reads reduced values, so
every rank takes it. The sample-side solve is rank-local and calls nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .klnmf import EPSILON, poisson_llh, sum_samples
from .mvnmf import _cholesky
from .precision import mm, omm

# scipy.optimize's Newton-CG 'avextol' default; threshold is dim * XTOL.
XTOL = 1e-5

# Armijo halvings until the serial backtracking's step floor: t visits
# 2^0 .. 2^-40 and 2^-40 (~9.1e-13) is accepted unconditionally.
_N_BACKTRACK = 41

# Newton-step caps at or below this run as that many masked steps with no
# early-exit test (and no host sync): the sample side's 3.
_UNROLL_NEWTON_LIMIT = 4


def _as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def compute_exposures(signature_scalings, sample_scalings,
                      signature_embeddings, sample_embeddings):
    """Exposure matrix (..., n_samples, n_signatures):
    exp(sigma_k + tau_d + <l_k, u_d>)."""
    logits = (
        signature_scalings.unsqueeze(-1)
        + sample_scalings.unsqueeze(-2)
        + mm(signature_embeddings, sample_embeddings.mT)
    )
    return torch.exp(logits).mT


def compute_aux(data_mat, signatures_mat, exposures_mat):
    """Sufficient statistic aux[k, d] = sum_v x_vd p_vkd, (..., K, D).

    data_mat: (D, V) counts; signatures_mat: (..., K, V); exposures_mat:
    (..., D, K)."""
    ratios = data_mat / mm(exposures_mat, signatures_mat)  # (..., D, V)
    return exposures_mat.mT * mm(signatures_mat, ratios.mT)


def elbo_corrnmf(data_mat, signatures_mat, exposures_mat,
                 signature_embeddings, sample_embeddings, variance,
                 penalize_sample_embeddings: bool = True,
                 reduce_samples=None):
    """Evidence lower bound: Poisson likelihood minus the Gaussian embedding
    penalties (the sample penalty is optional for multimodal CorrNMF)."""
    n_signatures, dim_embeddings = signature_embeddings.shape[-2:]
    variance = _as_tensor(variance, signature_embeddings)
    log_norm = torch.log(2.0 * math.pi * variance)
    llh = poisson_llh(data_mat.mT, signatures_mat.mT, exposures_mat.mT)
    llh, sample_sq, n_samples = sum_samples(
        reduce_samples, llh, *variance_sums(sample_embeddings))
    elbo = llh - 0.5 * dim_embeddings * n_signatures * log_norm
    elbo = elbo - (signature_embeddings**2).sum((-2, -1)) / (2.0 * variance)
    if penalize_sample_embeddings:
        elbo = elbo - 0.5 * dim_embeddings * n_samples * log_norm
        elbo = elbo - sample_sq / (2.0 * variance)
    return elbo


def signature_scaling_sums(aux, sample_scalings, signature_embeddings,
                           sample_embeddings):
    """The two sums over samples of the signature-scaling M-step:
    (observed, predicted), each (..., K)."""
    observed = aux.sum(-1)
    predicted = torch.exp(
        sample_scalings.unsqueeze(-2)
        + mm(signature_embeddings, sample_embeddings.mT)
    ).sum(-1)
    return observed, predicted


def update_signature_scalings(aux, sample_scalings,
                              signature_embeddings, sample_embeddings):
    """Closed-form M-step for the signature scalings sigma (..., K)."""
    observed, predicted = signature_scaling_sums(
        aux, sample_scalings, signature_embeddings, sample_embeddings)
    return torch.log(observed) - torch.log(predicted)


def update_sample_scalings(data_mat, signature_scalings,
                           signature_embeddings, sample_embeddings):
    """Closed-form M-step for the sample scalings tau (..., D); data_mat is
    (D, V) counts (samples are rows)."""
    observed = data_mat.sum(-1)
    predicted = torch.exp(
        signature_scalings.unsqueeze(-1)
        + mm(signature_embeddings, sample_embeddings.mT)
    ).sum(-2)
    return torch.log(observed) - torch.log(predicted)


def variance_sums(sample_embeddings):
    """The sums over samples of the variance M-step: (sum of squared
    sample embeddings, the sample count), each of the leading shape."""
    sample_sq = (sample_embeddings**2).sum((-2, -1))
    return sample_sq, torch.full_like(sample_sq,
                                      float(sample_embeddings.shape[-2]))


def variance_from(signature_embeddings, sample_sq, n_samples, dim: int):
    """The variance M-step from its reduced sums (variance_sums)."""
    total = (signature_embeddings**2).sum((-2, -1)) + sample_sq
    count = (signature_embeddings.shape[-2] * signature_embeddings.shape[-1]
             + n_samples * dim)
    return torch.clamp_min(total / count, EPSILON)


def update_variance(signature_embeddings, sample_embeddings,
                    reduce_samples=None):
    """M-step of the shared embedding variance: mean of all squared
    entries, floored at EPSILON."""
    sample_sq, n_samples = sum_samples(reduce_samples,
                                       *variance_sums(sample_embeddings))
    return variance_from(signature_embeddings, sample_sq, n_samples,
                         sample_embeddings.shape[-1])


# ---------------------------------------------------------------------------
# the surrogate of one embedding row (reference-named test surface)
# ---------------------------------------------------------------------------


def _rates(embedding, embeddings_other, scaling, scalings_other):
    products = omm(embeddings_other, embedding.unsqueeze(-1)).squeeze(-1)
    return products, torch.exp(scaling + scalings_other + products)


def embedding_objective(embedding, embeddings_other, scaling, scalings_other,
                        variance, aux_vector):
    """NEGATIVE surrogate objective of one embedding (m,). 'scaling' is a
    scalar or, for multimodal sample embeddings, a vector aligned with
    'scalings_other'."""
    products, rates = _rates(embedding, embeddings_other, scaling,
                             scalings_other)
    value = (products * aux_vector).sum(-1) - rates.sum(-1)
    value = value - (embedding * embedding).sum(-1) / (2.0 * variance)
    return -value


def embedding_gradient(embedding, embeddings_other, scaling, scalings_other,
                       variance, aux_vector):
    """Gradient of the NEGATIVE surrogate objective."""
    _, rates = _rates(embedding, embeddings_other, scaling, scalings_other)
    linear_term = omm(aux_vector.unsqueeze(-2), embeddings_other).squeeze(-2)
    return (-linear_term
            + omm(embeddings_other.mT, rates.unsqueeze(-1)).squeeze(-1)
            + embedding / variance)


def embedding_hessian(embedding, embeddings_other, scaling, scalings_other,
                      variance, aux_vector=None):
    """Hessian of the NEGATIVE surrogate objective:
    sum_i e_i o_i o_i^T + I/var, symmetric positive definite."""
    _, rates = _rates(embedding, embeddings_other, scaling, scalings_other)
    eye = torch.eye(embedding.shape[-1], dtype=embedding.dtype,
                    device=embedding.device)
    return (omm((embeddings_other * rates.unsqueeze(-1)).mT, embeddings_other)
            + eye / variance)


# Reference-named twins: the objective shares the reference signature; the
# gradient and Hessian take the reference's PRECOMPUTED per-row terms
# (summand_grad = aux_vector @ embeddings_other, the (rows, m, m) stack of
# outer products o_i o_i^T).
objective_function_embedding = embedding_objective


def gradient_embedding(embedding, embeddings_other, scaling, scalings_other,
                       variance, summand_grad):
    """Reference-convention gradient (summand_grad precomputed)."""
    _, rates = _rates(embedding, embeddings_other, scaling, scalings_other)
    return (-summand_grad
            + omm(embeddings_other.mT, rates.unsqueeze(-1)).squeeze(-1)
            + embedding / variance)


def hessian_embedding(embedding, embeddings_other, scaling, scalings_other,
                      variance, outer_prods_embeddings_other):
    """Reference-convention Hessian (outer products precomputed)."""
    _, rates = _rates(embedding, embeddings_other, scaling, scalings_other)
    eye = torch.eye(embedding.shape[-1], dtype=embedding.dtype,
                    device=embedding.device)
    return (torch.einsum("...i,...ijk->...jk", rates,
                         outer_prods_embeddings_other)
            + eye / variance)


# ---------------------------------------------------------------------------
# the batched damped Newton M-step
# ---------------------------------------------------------------------------


def _solve_spd(hess, grad):
    """Solve hess @ x = grad for (..., m, m) SPD systems by a Cholesky
    factor that never raises (ops/mvnmf.py _cholesky's diagonal floor)."""
    return torch.cholesky_solve(grad.unsqueeze(-1),
                                _cholesky(hess)).squeeze(-1)


def _newton_step(b, done, embeddings_other, offsets, linear_term, variance,
                 ts, xtol_total, reduce_samples=None,
                 complete_linear: bool = False):
    """One damped Newton step of every row, done rows frozen.

    b: (..., N, m) rows; embeddings_other: (..., M, m); offsets: (..., N,
    M) exponent constants; linear_term: (..., N, m) = aux @ embeddings_other;
    variance: (..., 1) (broadcast over rows); xtol_total: scalar or (...,
    1). The Armijo search evaluates all 41 halvings at once and takes the
    first that passes - the step the serial loop would accept.

    With reduce_samples the M rows are this rank's block: the step's sums
    over M are completed in two calls (gradient, Hessian and f0 sums, with
    the linear term's when `complete_linear`, as on the first step; then
    the candidates'). Returns (b, done, linear_term)."""
    var_rows = variance.unsqueeze(-1)                   # (..., 1, 1)
    rates = torch.exp(offsets + omm(b, embeddings_other.mT))  # (..., N, M)
    rate_grad = omm(rates, embeddings_other)
    weighted = rates.unsqueeze(-1) * embeddings_other.unsqueeze(-3)
    rate_hess = omm(weighted.mT, embeddings_other.unsqueeze(-3))
    rate_grad, rate_hess, rate_sum, *linear = sum_samples(
        reduce_samples, rate_grad, rate_hess, rates.sum(-1),
        *((linear_term,) if complete_linear else ()))
    linear_term = linear[0] if linear else linear_term
    grad = -linear_term + rate_grad + b / var_rows
    eye = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)
    hess = rate_hess + eye / var_rows.unsqueeze(-1)       # (..., N, m, m)
    direction = -_solve_spd(hess, grad)
    f0 = (-(linear_term * b).sum(-1) + rate_sum
          + (b * b).sum(-1) / (2.0 * variance))           # (..., N)
    slope = (grad * direction).sum(-1)

    candidates = b.unsqueeze(-2) + ts.unsqueeze(-1) * direction.unsqueeze(-2)
    (cand_rates,) = sum_samples(reduce_samples, torch.exp(
        omm(candidates, embeddings_other.mT.unsqueeze(-3))
        + offsets.unsqueeze(-2)).sum(-1))
    f_cand = (
        -omm(candidates, linear_term.unsqueeze(-1)).squeeze(-1)
        + cand_rates
        + (candidates * candidates).sum(-1) / (2.0 * var_rows)
    )                                                     # (..., N, 41)
    ok = f_cand <= f0.unsqueeze(-1) + 1e-4 * ts * slope.unsqueeze(-1)
    ok[..., -1] = True  # the step floor accepts 2^-40 regardless
    t = ts[ok.to(torch.int8).argmax(-1)]                  # first that passes
    update = t.unsqueeze(-1) * direction
    b_new = torch.where(done.unsqueeze(-1), b, b + update)
    done_new = done | (update.abs().sum(-1) < xtol_total)
    return b_new, done_new, linear_term


def _clamp_away_from_zero(embeddings):
    """Push magnitudes in (0, EPSILON) out to +-EPSILON, keeping exact
    zeros (reference _utils_corrnmf.py:408-409)."""
    tiny_pos = (embeddings > 0) & (embeddings < EPSILON)
    tiny_neg = (embeddings < 0) & (embeddings > -EPSILON)
    return torch.where(tiny_pos, EPSILON,
                       torch.where(tiny_neg, -EPSILON, embeddings))


def update_embeddings(embeddings0, embeddings_other, scalings, scalings_other,
                      variance, aux_mat, max_iter: int = 100,
                      xtol_total=None, reduce_samples=None):
    """Batched Newton update of N embedding rows at once.

    embeddings0:      (..., N, m) initial values (rows optimized
                      independently)
    embeddings_other: (..., M, m) the fixed opposite-side embeddings
    scalings:         (..., N) own scaling per row, or (..., N, M) (the
                      multimodal joint sample update)
    scalings_other:   (..., M)
    variance:         (...,) or a number
    aux_mat:          (..., N, M) rows of the sufficient statistic
    max_iter:         Newton-step cap; 3 is the reference's sample-side
                      scipy maxiter.
    xtol_total:       stopping threshold (sum|update| below it stops a
                      row); defaults to m * XTOL. The m-padded scan passes
                      the ACTIVE dimension's threshold per lane, (...,).
    reduce_samples:   the M rows of embeddings_other (and the columns of
                      aux_mat and offsets) are this rank's block of the
                      samples: the signature side under a sample-sharded
                      mesh (module docstring).
    """
    dim = embeddings0.shape[-1]
    if xtol_total is None:
        xtol_total = dim * XTOL
    elif isinstance(xtol_total, torch.Tensor):
        xtol_total = xtol_total.unsqueeze(-1)
    variance = _as_tensor(variance, embeddings0).unsqueeze(-1)  # (..., 1)
    # under a mesh a partial sum, completed in the first step's call
    linear_term = omm(aux_mat, embeddings_other)                # (..., N, m)
    if scalings.dim() == embeddings0.dim() - 1:
        offsets = scalings.unsqueeze(-1) + scalings_other.unsqueeze(-2)
    else:
        offsets = scalings + scalings_other.unsqueeze(-2)

    ts = 0.5 ** torch.arange(_N_BACKTRACK, dtype=embeddings0.dtype,
                             device=embeddings0.device)
    b = embeddings0
    done = torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    early_exit = max_iter > _UNROLL_NEWTON_LIMIT
    for step in range(int(max_iter)):
        b, done, linear_term = _newton_step(
            b, done, embeddings_other, offsets, linear_term, variance, ts,
            xtol_total, reduce_samples, step == 0)
        if early_exit and bool(done.all()):  # one host sync per step
            break
    return _clamp_away_from_zero(b)


def update_embeddings_newton_cg(embeddings0, embeddings_other, scalings,
                                scalings_other, variance, aux_mat,
                                max_iter: int | None = None):
    """Host-side scipy Newton-CG twin of update_embeddings for the opt-in
    compatibility mode: per-row scipy.optimize.minimize(method='Newton-CG')
    exactly as the reference runs it (_utils_corrnmf.py:354-410,
    corrnmf_det.py:103-141). numpy in, numpy out; slow but auditable.

    max_iter None = scipy's default (the reference's signature-side call);
    max_iter=3 = the reference's sample-side options={'maxiter': 3}.
    """
    from scipy import optimize

    embeddings0 = np.asarray(embeddings0, dtype=float)
    embeddings_other = np.asarray(embeddings_other, dtype=float)
    scalings = np.asarray(scalings, dtype=float)
    scalings_other = np.asarray(scalings_other, dtype=float)
    aux_mat = np.asarray(aux_mat, dtype=float)
    variance = float(variance)
    options = None if max_iter is None else {"maxiter": int(max_iter)}

    outer_prods = np.einsum(
        "Km,Kn->Kmn", embeddings_other, embeddings_other
    )
    result = np.empty_like(embeddings0)
    for row in range(embeddings0.shape[0]):
        scaling = scalings[row]
        aux_vec = aux_mat[row]
        summand_grad = np.sum(aux_vec[:, None] * embeddings_other, axis=0)

        def fun(b):
            products = embeddings_other @ b
            value = np.dot(products, aux_vec)
            value -= np.sum(np.exp(scaling + scalings_other + products))
            value -= np.dot(b, b) / (2.0 * variance)
            return -value

        def grad(b):
            rates = np.exp(scaling + scalings_other + embeddings_other @ b)
            return -summand_grad + embeddings_other.T @ rates + b / variance

        def hess(b):
            rates = np.exp(scaling + scalings_other + embeddings_other @ b)
            return (
                np.sum(rates[:, None, None] * outer_prods, axis=0)
                + np.eye(b.shape[0]) / variance
            )

        solution = optimize.minimize(
            fun=fun, x0=embeddings0[row], method="Newton-CG",
            jac=grad, hess=hess, options=options,
        ).x
        solution[(0 < solution) & (solution < EPSILON)] = EPSILON
        solution[(-EPSILON < solution) & (solution < 0)] = -EPSILON
        result[row] = solution
    return result


# ---------------------------------------------------------------------------
# rank- and dim-masked twins: CorrNMF problems of rank k and embedding
# dimension m share one padded (Kp, mp) batch (the padded scans)
# ---------------------------------------------------------------------------

# Padded signature scalings sit at this value: exp(NEG_PAD_SCALING + x)
# underflows to EXACTLY 0.0 in float32 and float64 for any realistic
# offset x, so the padded signatures' exposures, aux rows and rates are
# exact zeros and the sample-scaling, exposure, aux and both embedding
# updates need no masking of their own. Kept at the JAX package's value.
NEG_PAD_SCALING = -1e4


def _active_dim(embeddings, m_mask):
    if m_mask is None:
        return embeddings.shape[-1]
    return m_mask.sum(-1).to(embeddings.dtype)


def update_variance_masked(signature_embeddings, sample_embeddings, mask,
                           m_mask=None):
    """update_variance counting only the active signatures' embeddings and
    (for m-padded lanes) only the active dimensions - padded rows AND
    columns are exact zeros, so only the denominator needs the masks."""
    total = (signature_embeddings**2).sum((-2, -1)) \
        + (sample_embeddings**2).sum((-2, -1))
    dim = _active_dim(signature_embeddings, m_mask)
    count = (mask.sum(-1).to(total.dtype) + sample_embeddings.shape[-2]) * dim
    return torch.clamp_min(total / count, EPSILON)


def elbo_corrnmf_masked(data_mat, signatures_mat, exposures_mat,
                        signature_embeddings, sample_embeddings, variance,
                        mask, m_mask=None):
    """elbo_corrnmf with the Gaussian normalization counting only active
    signatures (and active embedding dimensions); padded exposure columns
    and embedding rows/columns are exact zeros."""
    dim_embeddings = _active_dim(signature_embeddings, m_mask)
    n_samples = sample_embeddings.shape[-2]
    n_active = mask.sum(-1).to(signature_embeddings.dtype)
    log_norm = torch.log(2.0 * math.pi * variance)
    elbo = poisson_llh(data_mat.mT, signatures_mat.mT, exposures_mat.mT)
    elbo = elbo - 0.5 * dim_embeddings * n_active * log_norm
    elbo = elbo - (signature_embeddings**2).sum((-2, -1)) / (2.0 * variance)
    elbo = elbo - 0.5 * dim_embeddings * n_samples * log_norm
    elbo = elbo - (sample_embeddings**2).sum((-2, -1)) / (2.0 * variance)
    return elbo


def pad_rank_corrnmf(params, n_padded: int, dim_padded: int | None = None):
    """Pad a rank-k, dim-m CorrNMF params dict (CorrNMFDet._device_state
    layout, optionally with leading lane axes) to rank n_padded (and
    embedding dimension dim_padded): uniform dummy signature rows,
    NEG_PAD_SCALING scalings, zero embedding rows/columns, zero exposure
    columns; adds the rank mask 'mask' (..., Kp) and the dimension mask
    'm_mask' (..., mp).

    m-padding is exact under zero initialization: a zero-padded embedding
    dimension has identically zero gradient, a block-diagonal Hessian row
    (I/variance) and so a zero Newton direction - it stays exactly zero.
    """
    signatures = params["signatures"]                    # (..., k, V)
    k, n_features = signatures.shape[-2:]
    if n_padded < k:
        raise ValueError(f"n_padded={n_padded} below rank {k}")
    dim = params["signature_embeddings"].shape[-1]
    if dim_padded is None:
        dim_padded = dim
    if dim_padded < dim:
        raise ValueError(f"dim_padded={dim_padded} below dim {dim}")
    lead = signatures.shape[:-2]
    n_samples = params["sample_embeddings"].shape[-2]
    extra, extra_dim = n_padded - k, dim_padded - dim

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=signatures.dtype,
                          device=signatures.device)

    padded = dict(params)
    padded["signatures"] = torch.cat(
        [signatures, full((extra, n_features), 1.0 / n_features)], -2)
    padded["signature_scalings"] = torch.cat(
        [params["signature_scalings"], full((extra,), NEG_PAD_SCALING)], -1)
    sig_emb = torch.cat([params["signature_embeddings"],
                         full((extra, dim), 0.0)], -2)
    smp_emb = params["sample_embeddings"]
    if extra_dim:
        sig_emb = torch.cat([sig_emb, full((n_padded, extra_dim), 0.0)], -1)
        smp_emb = torch.cat([smp_emb, full((n_samples, extra_dim), 0.0)], -1)
    padded["signature_embeddings"] = sig_emb
    padded["sample_embeddings"] = smp_emb
    padded["exposures"] = torch.cat(
        [params["exposures"], full((n_samples, extra), 0.0)], -1)
    device = signatures.device
    padded["mask"] = (torch.arange(n_padded, device=device) < k).expand(
        lead + (n_padded,))
    padded["m_mask"] = (torch.arange(dim_padded, device=device) < dim
                        ).expand(lead + (dim_padded,))
    return padded


def make_masked_corrnmf_step(signature_newton_iters: int = 100,
                             sample_newton_iters: int = 3):
    """Rank-masked CorrNMFDet EM cycle and ELBO for the padded scans.

    params carry the CorrNMFDet._device_state dict padded by
    pad_rank_corrnmf; each active lane computes the rank-k update in the
    order of CorrNMFDet._build_step. Padded exposures, aux rows and rates
    are exact zeros (NEG_PAD_SCALING), so the equations are the rank-k
    ones; float sums of other widths differ in the last bits only."""

    def update_fn(params, data):
        X = data["X"]
        signatures = params["signatures"]
        sig_scal = params["signature_scalings"]
        sig_emb = params["signature_embeddings"]
        smp_emb = params["sample_embeddings"]
        variance = params["variance"]
        mask = params["mask"]
        m_mask = params.get("m_mask")
        # the Newton stop threshold of the ACTIVE dimension, so an m-padded
        # lane stops exactly where the unpadded fit would
        xtol_total = (
            None if m_mask is None
            else m_mask.sum(-1).to(sig_emb.dtype) * XTOL
        )

        smp_scal = update_sample_scalings(X, sig_scal, sig_emb, smp_emb)
        exposures = compute_exposures(sig_scal, smp_scal, sig_emb, smp_emb)
        aux = compute_aux(X, signatures, exposures)
        sig_scal = torch.where(
            mask,
            update_signature_scalings(aux, smp_scal, sig_emb, smp_emb),
            NEG_PAD_SCALING,
        )
        sig_emb = update_embeddings(
            sig_emb, smp_emb, sig_scal, smp_scal, variance, aux,
            max_iter=signature_newton_iters, xtol_total=xtol_total,
        )
        smp_emb = update_embeddings(
            smp_emb, sig_emb, smp_scal, sig_scal, variance, aux.mT,
            max_iter=sample_newton_iters, xtol_total=xtol_total,
        )
        variance = update_variance_masked(sig_emb, smp_emb, mask, m_mask)

        # the KL signature update with the padded (zero-exposure) columns
        # guarded: they pass through unchanged
        W, H = signatures.mT, exposures.mT
        column_mask = mask.unsqueeze(-2)
        W_new = W * mm(X.mT / mm(W, H), H.mT)
        W_new = W_new / torch.where(column_mask,
                                    W_new.sum(-2, keepdim=True), 1.0)
        W_new = torch.clamp_min(W_new, EPSILON)
        signatures = torch.where(mask.unsqueeze(-1), W_new.mT, signatures)

        out = {
            "signatures": signatures,
            "signature_scalings": sig_scal,
            "sample_scalings": smp_scal,
            "signature_embeddings": sig_emb,
            "sample_embeddings": smp_emb,
            "variance": variance,
            "exposures": exposures,
            "mask": mask,
        }
        if m_mask is not None:
            out["m_mask"] = m_mask
        return out

    def objective_fn(params, data):
        return elbo_corrnmf_masked(
            data["X"],
            params["signatures"],
            params["exposures"],
            params["signature_embeddings"],
            params["sample_embeddings"],
            params["variance"],
            params["mask"],
            params.get("m_mask"),
        )

    return update_fn, objective_fn
