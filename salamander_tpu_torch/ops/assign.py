"""Catalog-assignment ops: exposure-only refits against a FIXED signature
catalog, with per-sample per-signature activity masks, held against
salamander_tpu/ops/assign.py.

With W fixed every sample is an independent K-variable problem, so

- the whole cohort refits as one batched multiplicative-update loop (the
  H update of KLNMF; W never updates), and
- the greedy backward elimination evaluates ALL K candidate removals for
  ALL samples at once: the candidates are a leading batch axis of (K, K, D)
  exposures and (K, V, D) products, the accept step is an argmin and a
  gather on the device (for as many samples at once as the caller's
  memory budget allows: candidates run a fixed step count, so the result
  does not depend on it), and
- bootstrap replicates refit as lanes that each converge on their own
  summed KL (refit_exposures_lanes), where the JAX package refits a chunk
  of replicates as one flat cohort: a replicate's exposures then do not
  depend on which replicates share its batch.

The convergence loop and the elimination rounds are driven from the host
with one sync per block or round, where the JAX package runs
``lax.while_loop``.

Under a sample-sharded mesh (reduce_samples, ops/klnmf.py) each rank holds
a block of the samples. The work is per sample, so the only sums over
them are the convergence objectives (one call a block) and the
elimination's stopping count (one a round): every rank then runs the
cohort's number of blocks and rounds, and a frozen sample gets the polish
steps of every round, as in one process.

Spans and counters (profiling.py): ``ops.host_syncs`` counts each host
read above (a refit's block, an elimination round's stopping count);
``eliminate_signatures`` opens ``assign.refit`` over its dense and its
final refit and ``assign.round`` over each round, through the read that
closes it.

Masking convention (ops.klnmf.make_masked_step_functions): inactive (k, d)
entries of H are held at EXACT zero, so W @ H, the KL and every ratio equal
the subset computation; active entries are clipped at EPSILON.

Precision: the JAX package pins every product at ``Precision.HIGHEST``
because a one-pass bf16 matmul on its accelerator broke the acceptance
budget for 146 of 192 PCAWG samples. Here every product is the port's IEEE
``mm``/``omm`` (ops/precision.py), never TF32.

Not ported: the ``*_guarded`` twins and their cost model, which exist for
the JAX package's accelerator program kill; the card has none.
"""

from __future__ import annotations

import torch

from .. import profiling
from .klnmf import EPSILON, samplewise_kl_divergence, sum_samples
from .precision import mm

__all__ = [
    "init_exposures",
    "refit_exposures_fixed",
    "refit_exposures",
    "refit_exposures_lanes",
    "eliminate_signatures",
    "resample_counts",
    "bootstrap_refit",
]


def _common(X, W):
    """X and W at their promoted dtype."""
    dtype = torch.promote_types(X.dtype, W.dtype)
    return X.to(dtype), W.to(dtype)


def _kl(X, W, H):
    """Per-sample KL (..., D): the acceptance and convergence decisions."""
    return samplewise_kl_divergence(X, W, H)


def init_exposures(X, W, mask):
    """Uniform warm start: each sample's counts split evenly over its
    active signatures (inactive entries exactly zero).

    X: (V, D) counts; W: (V, K) catalog; mask: (K, D) bool. Returns (K, D).
    """
    dtype = torch.promote_types(X.dtype, W.dtype)
    counts = mask.sum(0)
    colsum = X.to(dtype).sum(0)
    H0 = colsum.unsqueeze(0) / torch.clamp_min(counts, 1).unsqueeze(0)
    return torch.where(mask, torch.clamp_min(H0, EPSILON), 0.0)


def _masked_mu_step(X, W, H, mask):
    """One exposure-only MU step under the activity mask.

    The arithmetic of ops.klnmf.update_H (aux without clipping), so the
    all-active case is bitwise the canonical H update; a fully masked
    sample column yields nan in aux, and the where() pins its H entries to
    exact zero regardless. H and mask may carry leading candidate axes.
    """
    aux = X / mm(W, H)
    H_new = H * mm(W.mT, aux)
    return torch.where(mask, torch.clamp_min(H_new, EPSILON), 0.0)


def refit_exposures_fixed(X, W, mask, H0, n_iterations: int):
    """Masked exposure-only refit, FIXED iteration count: the candidate
    evaluation's warm-started workhorse."""
    H = H0
    for _ in range(int(n_iterations)):
        H = _masked_mu_step(X, W, H, mask)
    return H


def refit_exposures(X, W, mask, H0=None, max_iterations: int = 10_000,
                    tol: float = 1e-7, conv_test_freq: int = 10,
                    reduce_samples=None):
    """Masked exposure-only refit to convergence.

    Runs blocks of ``conv_test_freq`` MU steps and stops when the relative
    change of the summed KL over a block, |prev - cur| / max(|prev|,
    EPSILON), drops below ``tol`` or ``max_iterations`` (rounded up to a
    whole block) is reached. The first block always runs. One host sync
    per block. Returns (H, n_iterations) with n_iterations = blocks *
    conv_test_freq. Under a sample-sharded mesh X, mask and H0 are this
    rank's samples and reduce_samples completes the summed KL (one call a
    block), so every rank stops at the block of the whole cohort.
    """
    X, W = _common(X, W)
    if H0 is None:
        H0 = init_exposures(X, W, mask)
    max_blocks = -(-int(max_iterations) // int(conv_test_freq))

    def objective(H):
        return sum_samples(reduce_samples, _kl(X, W, H).sum())[0]

    H, prev, cur = H0, None, objective(H0)
    blocks = 0
    while blocks < max_blocks:
        if blocks >= 1:
            rel = torch.abs(prev - cur) / torch.clamp_min(torch.abs(prev),
                                                          EPSILON)
            profiling.count("ops.host_syncs")
            if not bool(rel >= tol):  # NaN stops, as the JAX cond does
                break
        H = refit_exposures_fixed(X, W, mask, H, conv_test_freq)
        prev, cur = cur, objective(H)
        blocks += 1
    return H, blocks * int(conv_test_freq)


def refit_exposures_lanes(X, W, mask, max_iterations: int = 10_000,
                          tol: float = 1e-7, conv_test_freq: int = 10,
                          reduce_samples=None):
    """refit_exposures for a stack of cohorts X (B, V, D) that share W and
    mask (K, D): every lane runs the rule of refit_exposures on its OWN
    summed KL and is frozen (``torch.where``) once it stops, so a lane's
    result is that of refit_exposures on its counts alone, whichever lanes
    share its batch. One host sync per block. Returns H (B, K, D).
    reduce_samples completes each lane's summed KL over a sample-sharded
    D."""
    X, W = _common(X, W)
    counts = torch.clamp_min(mask.sum(0), 1)
    H = torch.where(mask, torch.clamp_min(
        (X.sum(-2) / counts).unsqueeze(-2), EPSILON), 0.0)
    max_blocks = -(-int(max_iterations) // int(conv_test_freq))

    def objective(H):
        return sum_samples(reduce_samples, _kl(X, W, H).sum(-1))[0]

    prev = cur = objective(H)
    running = torch.ones_like(cur, dtype=torch.bool)
    for block in range(max_blocks):
        if block >= 1:
            rel = torch.abs(prev - cur) / torch.clamp_min(torch.abs(prev),
                                                          EPSILON)
            running = running & (rel >= tol)  # NaN stops a lane
            profiling.count("ops.host_syncs")
            if not bool(running.any()):
                break
        H_new = refit_exposures_fixed(X, W, mask, H, conv_test_freq)
        H = torch.where(running.view(-1, 1, 1), H_new, H)
        prev = torch.where(running, cur, prev)
        cur = torch.where(running, objective(H), cur)
    return H


def _finalize_contract(X, W, mask, H_final, H_accepted, H_dense,
                       rel_tol, abs_tol):
    """Close the acceptance contract: every reported sample satisfies
    kl_sparse <= (1 + rel_tol) * kl_dense + abs_tol EXACTLY.

    The budget and every candidate KL are evaluated together; each
    over-budget sample falls back down a chain that ends within budget -
    polished result -> pre-polish accepted state (same support) -> dense
    full-support refit (whose KL IS kl_dense) - and the reported kl_sparse
    is the SELECTED evaluation, never a re-evaluation.

    Returns (mask_out, H_out, kl_dense, kl_sparse, n_active).
    """
    kl_dense = _kl(X, W, H_dense)
    budget = (1.0 + rel_tol) * kl_dense + abs_tol
    kl_fin = _kl(X, W, H_final)
    kl_acc = _kl(X, W, H_accepted)
    use_fin = kl_fin <= budget
    use_acc = (~use_fin) & (kl_acc <= budget)
    use_dense = ~(use_fin | use_acc)
    H_out = torch.where(
        use_fin.unsqueeze(0), H_final,
        torch.where(use_acc.unsqueeze(0), H_accepted, H_dense),
    )
    mask_out = torch.where(use_dense.unsqueeze(0), True, mask)
    kl_sparse = torch.where(use_fin, kl_fin,
                            torch.where(use_acc, kl_acc, kl_dense))
    return mask_out, H_out, kl_dense, kl_sparse, mask_out.sum(0)


def _best_removal(X, W, mask, H, removes, candidate_iters: int):
    """Each sample's cheapest removal: candidate k is every sample refit
    with signature k removed (exposures (K, K, D), products (K, V, D)).
    Invalid candidates (inactive, or a sample's last signature) are +inf.
    Returns (k_star (D,), kl_star (D,), H_star (K, D)): the first minimum,
    its KL and its exposures."""
    K, D = H.shape
    m_k = mask.unsqueeze(0) & ~removes                           # (K, K, D)
    H_k = refit_exposures_fixed(X, W, m_k,
                                torch.where(m_k, H.unsqueeze(0), 0.0),
                                candidate_iters)
    valid = mask & (mask.sum(0) > 1)
    cand_kl = torch.where(valid, _kl(X, W, H_k), torch.inf)      # (K, D)
    k_star = torch.argmin(cand_kl, dim=0)  # the first minimum
    kl_star = torch.gather(cand_kl, 0, k_star.unsqueeze(0))[0]
    H_star = torch.gather(H_k, 0, k_star.view(1, 1, D).expand(1, K, D))[0]
    return k_star, kl_star, H_star


def _cat_columns(parts):
    """Per-chunk tuples of tensors joined along the sample (last) axis."""
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(leaves, dim=-1) for leaves in zip(*parts))


def eliminate_signatures(
    X,
    W,
    rel_tol,
    abs_tol=0.0,
    candidate_iters: int = 50,
    polish_iterations: int = 200,
    max_polish_iterations: int = 10_000,
    conv_test_freq: int = 10,
    polish_tol=1e-7,
    candidate_chunk: int | None = None,
    reduce_samples=None,
):
    """Greedy backward elimination of catalog signatures, per sample.

    Starting from the dense refit over the full catalog, each round tries
    removing every currently active signature from every sample (a leading
    candidate axis: exposures (K, K, D), products (K, V, D)), picks each
    sample's cheapest removal (the first minimum), and accepts it while the
    sample's KL stays within

        kl <= (1 + rel_tol) * kl_dense + abs_tol.

    Invalid candidates (inactive, or a sample's last signature) are +inf.
    Samples freeze independently; the round loop runs on the host, at most
    K rounds, with one sync each, and ends when every sample is frozen.

    Args:
      X: (V, D) counts. W: (V, K) column-stochastic catalog.
      candidate_iters: warm-started MU steps per candidate evaluation.
      polish_iterations: MU steps applied to the accepted state each round.
      candidate_chunk: samples whose candidates are evaluated at once (None:
        all). It bounds the (K, K, D) and (K, V, D) candidate tensors and
        nothing else: candidates run a fixed step count per sample, so the
        result does not depend on it.
      reduce_samples: X is this rank's block of a sample-sharded cohort
        (module docstring).

    Returns dict with: mask (K, D) int32 final supports; H (K, D)
    exposures; kl_dense / kl_sparse (D,); n_rounds (int); n_active (D,).
    """
    X, W = _common(X, W)
    K = W.shape[1]
    D = X.shape[1]
    device = X.device

    mask0 = torch.ones((K, D), dtype=torch.bool, device=device)
    with profiling.span("assign.refit"):
        H_dense, _ = refit_exposures(
            X, W, mask0, max_iterations=max_polish_iterations,
            tol=polish_tol, conv_test_freq=conv_test_freq,
            reduce_samples=reduce_samples,
        )
    kl_dense = _kl(X, W, H_dense)
    budget = (1.0 + rel_tol) * kl_dense + abs_tol

    removes = torch.eye(K, dtype=torch.bool, device=device).unsqueeze(-1)
    rows = torch.arange(K, device=device).unsqueeze(1)
    mask, H = mask0, H_dense
    frozen = torch.zeros(D, dtype=torch.bool, device=device)
    step = D if candidate_chunk is None else max(1, int(candidate_chunk))

    def searching():  # one host sync (and one reduce_samples) per round
        # the cohort's count, exact in float64
        (running,) = sum_samples(reduce_samples,
                                 (~frozen).sum(dtype=torch.float64))
        profiling.count("ops.host_syncs")
        return bool(running > 0)

    n_rounds = 0
    going = K > 0 and searching()
    while going:
        with profiling.span("assign.round"):
            k_star, kl_star, H_star = _cat_columns([
                _best_removal(X[:, lo:lo + step], W, mask[:, lo:lo + step],
                              H[:, lo:lo + step], removes, candidate_iters)
                for lo in range(0, D, step)
            ])
            accept = (~frozen) & (kl_star <= budget)
            removal = (rows == k_star.unsqueeze(0)) & accept.unsqueeze(0)
            new_mask = mask & ~removal
            new_H = torch.where(accept.unsqueeze(0), H_star, H)
            H = refit_exposures_fixed(X, W, new_mask, new_H,
                                      polish_iterations)
            mask = new_mask
            frozen = frozen | ~accept
            n_rounds += 1
            going = n_rounds < K and searching()

    with profiling.span("assign.refit"):
        H_final, _ = refit_exposures(
            X, W, mask, H0=H, max_iterations=max_polish_iterations,
            tol=polish_tol, conv_test_freq=conv_test_freq,
            reduce_samples=reduce_samples,
        )
    mask_out, H_out, kl_dense_out, kl_sparse, n_active = _finalize_contract(
        X, W, mask, H_final, H, H_dense, rel_tol, abs_tol
    )
    return {
        "mask": mask_out.to(torch.int32),
        "H": H_out,
        "kl_dense": kl_dense_out,
        "kl_sparse": kl_sparse,
        "n_rounds": n_rounds,
        "n_active": n_active,
    }


def _multinomial_columns(X, generator, n_resamples: int):
    """Per sample d, Multinomial(round(n_d), X[:, d] / n_d) for each of
    n_resamples replicates, as a chain of conditional binomials over the V
    features (torch's multinomials take one total per call): feature v
    draws Binomial(remaining, p_v / sum_{u >= v} p_u), the tail sums taken
    from suffix sums of p (not 1 - prefix, which cancels), each ratio
    clamped to [0, 1]; the last feature takes the remainder, so every
    total is preserved exactly. Returns (n_resamples, V, D) float64."""
    X64 = X.to(torch.float64)
    V, D = X64.shape
    totals = torch.round(X64.sum(0))                          # (D,)
    probs = X64 / X64.sum(0)                                  # (V, D)
    tails = torch.flip(torch.cumsum(torch.flip(probs, [0]), 0), [0])
    ratios = torch.where(tails > 0, probs / torch.where(tails > 0, tails,
                                                        1.0), 0.0)
    ratios = torch.clamp(ratios, 0.0, 1.0)
    remaining = totals.expand(n_resamples, D).clone()
    draws = torch.empty((n_resamples, V, D), dtype=torch.float64,
                        device=X.device)
    for v in range(V - 1):
        count = torch.binomial(remaining,
                               ratios[v].expand(n_resamples, D).contiguous(),
                               generator=generator)
        draws[:, v] = count
        remaining = remaining - count
    draws[:, V - 1] = remaining
    return draws


def resample_counts(X, generator, n_resamples: int,
                    method: str = "multinomial"):
    """Draw count-bootstrap resamples of a (V, D) count matrix on its
    device, from the torch.Generator `generator` (on X's device).

    method:
      'multinomial' - per sample d, redraw Multinomial(round(n_d),
        X[:, d] / n_d) (the SigProfiler-style nonparametric count
        bootstrap; per-sample totals are preserved exactly);
      'poisson' - X_b ~ Poisson(X), the parametric bootstrap under the
        model's own Poisson likelihood (samples' totals vary).

    The draws cannot equal jax.random's; the contract is the distribution
    and the totals. Returns (n_resamples, V, D) in X.dtype.
    """
    if method == "multinomial":
        return _multinomial_columns(X, generator, n_resamples).to(X.dtype)
    if method == "poisson":
        rates = X.unsqueeze(0).expand((n_resamples,) + tuple(X.shape))
        return torch.poisson(rates.contiguous(), generator=generator)
    raise ValueError(f"unknown bootstrap method {method!r}")


def bootstrap_refit(
    X,
    W,
    mask,
    generators,
    method: str = "multinomial",
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    conv_test_freq: int = 10,
    samples: tuple[int, int] | None = None,
    reduce_samples=None,
):
    """Resample the cohort's counts and refit exposures, every replicate a
    lane of ONE batched masked refit that converges on its own
    (refit_exposures_lanes).

    X: (V, D) counts; W: (V, K) catalog; mask: (K, D) activity (shared by
    the replicates: all-ones for dense refits, or an assignment's supports).
    `generators` holds one entry per lane: a torch.Generator (on X's
    device) draws that lane's resample, so a replicate's counts depend on
    its generator alone and not on the replicates that share its batch;
    None makes the lane the ORIGINAL X (the point estimate). Returns H
    (B, K, D).

    Under a sample-sharded mesh every rank draws the whole cohort's
    resamples and refits its block [lo, hi) = `samples` of them (mask is
    then that block's), reduce_samples completing the convergence sums:
    H is (B, K, hi - lo).
    """
    X, W = _common(X, W)
    lanes = torch.cat([X.unsqueeze(0) if generator is None
                       else resample_counts(X, generator, 1, method)
                       for generator in generators], 0)
    if samples is not None:
        lo, hi = samples
        lanes = lanes[..., lo:hi].contiguous()
    return refit_exposures_lanes(
        lanes, W, mask, max_iterations=max_iterations,
        tol=tol, conv_test_freq=conv_test_freq,
        reduce_samples=reduce_samples,
    )
