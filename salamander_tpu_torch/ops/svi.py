"""Stochastic (minibatch) variational EM for correlated NMF and online NMF
for KLNMF, held against salamander_tpu/ops/svi.py.

CorrNMFDet's fit is full-batch: every EM cycle touches all D samples. This
module is the online-EM variant (Cappe & Moulines 2009; the step sizes of
Hoffman et al. 2013): each step draws a minibatch of samples, refreshes
that minibatch's LOCAL parameters (sample scalings and embeddings) with the
exact batch M-steps, and updates the GLOBAL parameters from Robbins-Monro
running averages of the minibatch-scaled sufficient statistics:

  s1[k] = sum_d aux[k, d]                   (signature-scaling numerator)
  s2[k] = sum_d exp(tau_d + <l_k, u_d>)     (signature-scaling denominator)
  C[v,k] = W_vk * sum_d ratio_vd h_dk       (expected signature counts;
                                             column-normalizing C IS the
                                             KL multiplicative W update)

with rho_t = (t + delay)^(-forgetting) and t = 0, 1, ... The signature
embeddings have no fixed-dimensional sufficient statistic, so they take the
non-conjugate route: a Newton solve on the minibatch-rescaled surrogate,
blended into the running iterate with the same rho_t.

Exactness anchor: with batch_size = n_samples, rho = 1 (delay=1, t=0) and
signature_newton_iters raised to the full-batch cap, one step IS one
deterministic EM cycle, so the scheme generalizes CorrNMFDet's update. The
same scheme powers online NMF for KLNMF (make_klnmf_svi_step) and the
multimodal model (make_mm_svi_step).

What differs from the JAX package, and why:

- Nothing is compiled, so the loop is driven from the host: `step` and
  `cursor` of a state are Python integers, rho_t is a Python float, and a
  step with the default Newton caps (4 and 3, both within
  ops/corrnmf.py's unrolled limit) makes no host sync at all.
- The epoch sampler: ONE CPU ``torch.Generator`` seeded by the caller draws
  one ``torch.randperm`` an epoch, for the resident and the streaming
  placement alike (jax.random cannot be reproduced, and a CUDA generator's
  draws follow the launch grid). The resident step copies the epoch's
  permutation to the device once an epoch and slices it there.
- The scatter of the refreshed local parameters is an out-of-place
  ``index_copy`` on the batch's unique indices, which is deterministic.
- The streaming loop keeps the counts on the host and uploads each
  minibatch through a ring of ``prefetch + 1`` pinned slots on a side
  stream that carries copies only; every matrix product stays on the one
  compute stream, so the two placements feed the same core the same
  tensors and give bit-equal parameters.

A resident cohort may be sample-sharded over a mesh (parallel/mesh.py):
each rank holds a block of the samples, every rank draws the same epoch
order from the same CPU generator and keeps it on the host, where it cuts
out the batch samples of its block (local_batch: no device sync), so a
step's batch is the meshless one. Each rank refreshes the locals of its
batch samples, and the sums over the batch - the running statistics of the
signature scalings and signatures (one reduce_samples call), the
signature-side Newton solve's (ops/corrnmf.py) and the sample embeddings'
sum of squares (one) - and the recorded objectives are completed by the
caller's reduce_samples hook (ops/klnmf.py).

Precision: the update path runs in the fit dtype through ops/precision.py
(IEEE float32 on a card). The recorded objectives (full_elbo,
klnmf_full_objective, mm_full_elbo and their streamed forms) are evaluated
in the fit dtype too, as the JAX package does: a minibatch fit runs a
fixed n_steps, so the trace decides nothing.
"""

from __future__ import annotations

import collections
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..engine.tree import tree_leaves
from . import corrnmf as ops
from . import klnmf as klops
from .klnmf import EPSILON, sum_samples
from .precision import mm


class SVIConfig(NamedTuple):
    """Step-size schedule and solver knobs for the stochastic EM fit.

    rho_t = (t + delay)^(-forgetting): forgetting in (0.5, 1] guarantees
    Robbins-Monro convergence; delay >= 1 tempers early steps. delay=1 makes
    the first step's rho exactly 1, which initializes the running statistics
    to the first minibatch estimate.
    """

    batch_size: int = 128
    forgetting: float = 0.7
    delay: float = 1.0
    signature_newton_iters: int = 4
    sample_newton_iters: int = 3  # the reference's sample-side maxiter=3


def _validate_config(config: SVIConfig, n_samples: int) -> int:
    """Reject schedules that silently corrupt the fit. Returns batch_size.

    delay < 1 makes rho_0 = delay**(-forgetting) exceed 1 (delay=0 makes it
    inf), so the (1-rho)/rho blend leaves the convex hull and the running
    statistics go negative/NaN; forgetting outside (0.5, 1] breaks the
    Robbins-Monro conditions (sum rho = inf, sum rho^2 < inf)."""
    batch_size = int(config.batch_size)
    if not 1 <= batch_size <= n_samples:
        raise ValueError(
            f"batch_size={batch_size} must be in [1, n_samples={n_samples}]"
        )
    if not config.delay >= 1.0:
        raise ValueError(
            f"delay={config.delay} must be >= 1 (rho_0 = delay**-forgetting "
            "must not exceed 1)"
        )
    if not 0.5 < config.forgetting <= 1.0:
        raise ValueError(
            f"forgetting={config.forgetting} must be in (0.5, 1] for "
            "Robbins-Monro convergence"
        )
    if config.signature_newton_iters < 1 or config.sample_newton_iters < 1:
        raise ValueError("Newton iteration counts must be >= 1")
    return batch_size


def _rho(step: int, config: SVIConfig) -> float:
    return (step + config.delay) ** (-config.forgetting)


class SVIState(NamedTuple):
    params: Any          # the CorrNMFDet parameter dict (minus exposures)
    stat_observed: Any   # (K,) running average of D-scaled sum_d aux[k,d]
    stat_predicted: Any  # (K,) running average of D-scaled sum_d exp(...)
    stat_counts: Any     # (V,K) running average of expected signature counts
    step: int            # step counter t (a host integer)
    perm: Any            # (D,) epoch sample order on the device
    cursor: int          # position in perm (a host integer)
    stat_usq: Any        # 0-d running sum(sample_embeddings**2)


def _initial_perm(n_samples: int, device, streaming: bool):
    """The device-side epoch order of a fresh state: the identity (never
    read: cursor starts past its end, so the first step reshuffles), or
    (0,) for the streaming loop, which keeps the order on the host."""
    if streaming:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.arange(n_samples, dtype=torch.int64, device=device)


def svi_init(params, streaming: bool = False) -> SVIState:
    """Fresh SVI state around a CorrNMFDet parameter dict (the running
    statistics start at zero; rho_0 = 1 with the default delay overwrites
    them with the first minibatch estimate). cursor starts past the end of
    perm so the first step reshuffles.

    streaming=True builds the state for run_svi_streaming, whose epoch
    permutation lives on the HOST: the device-side perm collapses to shape
    (0,) so huge cohorts carry no dead (D,) index array."""
    signatures = params["signatures"]
    n_signatures, n_features = signatures.shape
    sample_embeddings = params["sample_embeddings"]
    n_samples = sample_embeddings.shape[0]
    return SVIState(
        params={key: value for key, value in params.items()
                if key != "exposures"},
        stat_observed=signatures.new_zeros(n_signatures),
        stat_predicted=signatures.new_zeros(n_signatures),
        stat_counts=signatures.new_zeros(n_features, n_signatures),
        step=0,
        perm=_initial_perm(n_samples, signatures.device, streaming),
        cursor=n_samples,
        stat_usq=(sample_embeddings**2).sum(),
    )


def refresh_sample_usq(state):
    """Exact-refresh the running sum(sample_embeddings**2) statistic (the
    epoch-boundary drift guard). Works for SVIState and MMSVIState. The
    streaming loop calls this at exactly the step positions where the
    resident step refreshes, which keeps the two paths bit-equal."""
    return state._replace(
        stat_usq=(state.params["sample_embeddings"] ** 2).sum()
    )


def draw_permutation(generator: torch.Generator, n_samples: int):
    """One epoch's sample order: a (n_samples,) int64 CPU tensor drawn from
    the caller's CPU generator, the single source of minibatch indices of
    both data placements."""
    return torch.randperm(n_samples, generator=generator)


def _to_device(tensor, device):
    """Copy a CPU tensor to `device`; to a card through pinned memory and
    without blocking the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)


def _draw_epoch_batch(generator, perm, cursor: int, batch_size: int):
    """Cut the next minibatch from the epoch permutation, reshuffling when
    the epoch is exhausted. Returns (indices, perm, cursor, reshuffled);
    the caller exact-refreshes its running sum-of-squares statistic when
    `reshuffled`, so its O(B) incremental updates cannot drift.

    Drop-last semantics: reshuffling triggers whenever fewer than batch_size
    samples remain, so when batch_size does not divide n_samples the tail
    partial batch of each epoch is NOT visited that epoch (it lands in the
    next epoch's fresh permutation with uniform probability)."""
    n_samples = perm.shape[0]
    reshuffled = cursor + batch_size > n_samples
    if reshuffled:
        perm = _to_device(draw_permutation(generator, n_samples), perm.device)
        cursor = 0
    indices = perm[cursor:cursor + batch_size]
    return indices, perm, cursor + batch_size, reshuffled


def shard_state(state, n_samples: int, reduce_samples):
    """A fresh SVI state around a rank's block of the samples: the epoch
    order of the whole cohort on the HOST (local_batch cuts it), and the
    running sum of squared sample embeddings, where the state has one,
    over every rank's samples."""
    state = state._replace(perm=torch.arange(n_samples), cursor=n_samples)
    if hasattr(state, "stat_usq"):
        (usq,) = sum_samples(reduce_samples, state.stat_usq)
        state = state._replace(stat_usq=usq)
    return state


def local_batch(state, generator, batch_size: int, block, reduce_samples,
                device, refresh: bool):
    """The sharded twin of _draw_into_state: the next minibatch of the
    cohort (every rank draws the same), of which this rank keeps the
    samples of its block [lo, hi) as local row indices on `device`. The
    epoch order is a host tensor, so the cut costs no device sync.
    `refresh` exact-refreshes stat_usq, over every rank, at a reshuffle."""
    indices, perm, cursor, reshuffled = _draw_epoch_batch(
        generator, state.perm, state.cursor, batch_size)
    state = state._replace(perm=perm, cursor=cursor)
    if reshuffled and refresh:
        (usq,) = sum_samples(
            reduce_samples, (state.params["sample_embeddings"] ** 2).sum())
        state = state._replace(stat_usq=usq)
    lo, hi = block
    local = indices[(indices >= lo) & (indices < hi)] - lo
    return state, _to_device(local, device)


def _usq_update(stat_usq, usq_old, u_batch, reduce_samples):
    """The running sum of squared sample embeddings after a batch's
    refresh: incremental, the batch's old and new sums over every rank."""
    usq_old, usq_new = sum_samples(reduce_samples, usq_old,
                                   (u_batch**2).sum())
    return stat_usq - usq_old + usq_new


def _signatures_from_counts(stat_counts, signatures, n_given: int):
    """Column-normalized running expected counts, clipped: the KL
    multiplicative W update in statistic form. signatures is (K, V); the
    leading n_given signatures are kept."""
    W_new = torch.clamp_min(stat_counts / stat_counts.sum(-2), EPSILON)
    if n_given > 0:
        given = klops._given_columns(W_new.shape[-1], n_given, W_new.device)
        W_new = torch.where(given, signatures.mT, W_new)
    return W_new.mT


def make_svi_batch_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    fix_signature_scalings: bool = False,
    fix_sample_scalings: bool = False,
    fix_signature_embeddings: bool = False,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
    reduce_samples=None,
):
    """Build the minibatch CORE (state, X_batch, indices) -> state.

    The caller supplies the minibatch: X_batch is the (B, V) count rows and
    indices the (B,) sample positions they came from (unique). This is the
    shared engine of both data placements:
      - make_svi_step wraps it with the epoch sampler and a gather from the
        device-resident full X;
      - run_svi_streaming drives it with host-sliced, uploaded batches,
        feeding the SAME index sequence, so the two paths produce
        bit-equal params.

    state.perm/state.cursor pass through untouched (the wrapper or the host
    loop owns them); state.stat_usq must already be epoch-refreshed when
    needed (refresh_sample_usq) - the core only applies the incremental
    update. reduce_samples: the batch is this rank's part of a sample-
    sharded cohort's (module docstring).
    """
    batch_size = _validate_config(config, n_samples)
    scale = n_samples / batch_size
    log_scale = math.log(scale)
    n_given = int(n_given_signatures)

    def batch_step(state: SVIState, X_batch, indices) -> SVIState:
        params = dict(state.params)
        signatures = params["signatures"]          # (K, V)
        sig_scal = params["signature_scalings"]    # (K,)
        smp_scal = params["sample_scalings"]       # (D,)
        sig_emb = params["signature_embeddings"]   # (K, m)
        smp_emb = params["sample_embeddings"]      # (D, m)
        variance = params["variance"]
        rho = _rho(state.step, config)
        stat_usq = state.stat_usq

        tau_batch = smp_scal.index_select(0, indices)  # (B,)
        u_batch = smp_emb.index_select(0, indices)     # (B, m)
        usq_batch_old = (u_batch**2).sum()

        # 1. minibatch sample scalings (exact local M-step, closed form)
        if not fix_sample_scalings:
            tau_batch = ops.update_sample_scalings(
                X_batch, sig_scal, sig_emb, u_batch
            )

        # 2.+3. minibatch exposures and sufficient statistics
        exposures_batch = ops.compute_exposures(
            sig_scal, tau_batch, sig_emb, u_batch
        )                                                # (B, K)
        ratios = X_batch / mm(exposures_batch, signatures)  # (B, V)
        aux_batch = exposures_batch.mT * mm(signatures, ratios.mT)  # (K, B)
        # the batch sums of steps 4 and 7 (the signatures are untouched in
        # between): one reduce_samples call
        observed, predicted, counts = sum_samples(
            reduce_samples,
            *ops.signature_scaling_sums(aux_batch, tau_batch, sig_emb,
                                        u_batch),
            mm(ratios.mT, exposures_batch))

        # 4. signature scalings from running-averaged statistics
        observed_hat = scale * observed
        predicted_hat = scale * predicted
        stat_observed = (1.0 - rho) * state.stat_observed + rho * observed_hat
        stat_predicted = (
            (1.0 - rho) * state.stat_predicted + rho * predicted_hat
        )
        if not fix_signature_scalings:
            sig_scal = torch.log(stat_observed) - torch.log(stat_predicted)

        # 5a. signature embeddings: Newton solve on the minibatch-rescaled
        # surrogate (aux and rate terms scaled by D/B; the log(scale) offset
        # multiplies the rate sum, the Gaussian prior stays unscaled),
        # blended with rho - the non-conjugate SVI global update
        if not fix_signature_embeddings:
            sig_emb_star = ops.update_embeddings(
                sig_emb, u_batch, sig_scal, tau_batch + log_scale,
                variance, scale * aux_batch,
                max_iter=config.signature_newton_iters,
                reduce_samples=reduce_samples,
            )
            sig_emb = (1.0 - rho) * sig_emb + rho * sig_emb_star

        # 5b. minibatch sample embeddings (exact local update, 3 Newton
        # steps as in the reference's sample-side maxiter=3)
        if not fix_sample_embeddings:
            u_batch = ops.update_embeddings(
                u_batch, sig_emb, tau_batch, sig_scal, variance,
                aux_batch.mT, max_iter=config.sample_newton_iters,
            )

        # scatter the refreshed locals back into the full arrays
        if not fix_sample_scalings:
            smp_scal = smp_scal.index_copy(0, indices, tau_batch)
        if not fix_sample_embeddings:
            smp_emb = smp_emb.index_copy(0, indices, u_batch)
            stat_usq = _usq_update(stat_usq, usq_batch_old, u_batch,
                                   reduce_samples)

        # 6. variance over all embeddings, with the O(D m) sample term
        # carried incrementally (exact-refreshed at each epoch boundary)
        if not fix_variance:
            total = (sig_emb**2).sum() + stat_usq
            count = sig_emb.numel() + n_samples * smp_emb.shape[-1]
            variance = torch.clamp_min(total / count, EPSILON)

        # 7. signatures: column-normalized running average of the expected
        # signature counts (the KL multiplicative W update in statistic form)
        counts_hat = signatures.mT * counts * scale      # (V, K)
        stat_counts = (1.0 - rho) * state.stat_counts + rho * counts_hat
        signatures = _signatures_from_counts(stat_counts, signatures, n_given)

        params.update(
            signatures=signatures,
            signature_scalings=sig_scal,
            sample_scalings=smp_scal,
            signature_embeddings=sig_emb,
            sample_embeddings=smp_emb,
            variance=variance,
        )
        return SVIState(
            params=params,
            stat_observed=stat_observed,
            stat_predicted=stat_predicted,
            stat_counts=stat_counts,
            step=state.step + 1,
            perm=state.perm,
            cursor=state.cursor,
            stat_usq=stat_usq,
        )

    return batch_step


def _draw_into_state(state, generator, batch_size: int, refresh: bool):
    """Advance a state's epoch sampler by one minibatch: (state, indices).
    `refresh` exact-refreshes stat_usq at a reshuffle (the states that
    carry one)."""
    indices, perm, cursor, reshuffled = _draw_epoch_batch(
        generator, state.perm, state.cursor, batch_size
    )
    state = state._replace(perm=perm, cursor=cursor)
    if reshuffled and refresh:
        state = refresh_sample_usq(state)
    return state, indices


def make_svi_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    fix_signature_scalings: bool = False,
    fix_sample_scalings: bool = False,
    fix_signature_embeddings: bool = False,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
    sample_block: tuple[int, int] | None = None,
    reduce_samples=None,
):
    """Build the resident minibatch step (state, X, generator) -> state.

    X is the full (D, V) count matrix on the device; each step gathers its
    minibatch rows and hands them to the shared make_svi_batch_step core.
    generator is the CPU ``torch.Generator`` that draws the epoch orders.
    The update order inside a step mirrors the deterministic EM cycle
    (sample scalings -> exposures/aux -> signature scalings -> signature
    embeddings -> sample embeddings -> variance -> signatures), which is
    what makes the full-batch/rho=1 case collapse to CorrNMFDet's update.

    Under a sample-sharded mesh X is this rank's block [lo, hi) =
    sample_block of the cohort and the state comes from shard_state
    (module docstring).
    """
    batch_size = _validate_config(config, n_samples)
    batch_step = make_svi_batch_step(
        n_samples, config, n_given_signatures,
        fix_signature_scalings, fix_sample_scalings,
        fix_signature_embeddings, fix_sample_embeddings, fix_variance,
        reduce_samples,
    )

    def step(state: SVIState, X, generator) -> SVIState:
        if sample_block is None:
            state, indices = _draw_into_state(state, generator, batch_size,
                                              True)
        else:
            state, indices = local_batch(state, generator, batch_size,
                                         sample_block, reduce_samples,
                                         X.device, True)
        return batch_step(state, X.index_select(0, indices), indices)

    return step


def full_elbo(params, X, reduce_samples=None):
    """Full-data ELBO at the current SVI state (exposures recomputed), in
    the dtype of the parameters."""
    exposures = ops.compute_exposures(
        params["signature_scalings"],
        params["sample_scalings"],
        params["signature_embeddings"],
        params["sample_embeddings"],
    )
    return ops.elbo_corrnmf(
        X,
        params["signatures"],
        exposures,
        params["signature_embeddings"],
        params["sample_embeddings"],
        params["variance"],
        reduce_samples=reduce_samples,
    )


def _check_run(n_steps: int, eval_freq: int) -> None:
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if eval_freq < 0:
        raise ValueError(
            f"eval_freq={eval_freq} must be >= 1, or 0 to disable the "
            "full-data ELBO trace"
        )


def _stack_history(evaluations, params):
    """The recorded objectives as one (n_evals,) tensor on the parameters'
    device (empty when nothing was evaluated)."""
    if evaluations:
        return torch.stack(evaluations)
    leaf = tree_leaves(params)[0]
    return leaf.new_zeros(0)


def run_svi(step_fn, state0, X, generator, n_steps: int, eval_freq: int,
            elbo_fn=full_elbo):
    """Drive `n_steps` resident minibatch steps from the host, recording
    the full-data objective after every `eval_freq` steps. Returns
    (final_state, history) with history a (n_steps // eval_freq,) tensor on
    the device, fetched by the caller once at the end; the count data
    (tensor or dict of per-modality tensors) stays on the device
    throughout. elbo_fn(params, X) evaluates the recorded objective
    (full_elbo for CorrNMFDet, klnmf_full_objective, mm_full_elbo).

    Each evaluation is a full O(D V) pass; eval_freq=0 disables evaluation
    entirely (history comes back empty), keeping every step O(batch). The
    steps after the last evaluation (n_steps not divisible by eval_freq)
    still run."""
    _check_run(n_steps, eval_freq)
    state = state0
    evaluations = []
    for t in range(n_steps):
        state = step_fn(state, X, generator)
        if eval_freq and (t + 1) % eval_freq == 0:
            evaluations.append(elbo_fn(state.params, X))
    return state, _stack_history(evaluations, state0.params)


# --------------------------------------------------------------------- #
# KLNMF: online NMF over the sample axis
# --------------------------------------------------------------------- #


class KLSVIState(NamedTuple):
    params: Any       # {"W": (V, K), "H": (K, D)}
    stat_counts: Any  # (V, K) running average of D-scaled expected counts
    step: int
    perm: Any         # (D,) epoch sample order on the device
    cursor: int       # position in perm


def klnmf_svi_init(params, streaming: bool = False) -> KLSVIState:
    """Fresh online-NMF state around a KLNMF parameter dict
    ({"W": (V, K), "H": (K, D)}; StandardNMF._device_state orientation).
    streaming=True collapses the device-side perm to (0,) (see svi_init)."""
    W, H = params["W"], params["H"]
    n_samples = H.shape[1]
    return KLSVIState(
        params={"W": W, "H": H},
        stat_counts=torch.zeros_like(W),
        step=0,
        perm=_initial_perm(n_samples, W.device, streaming),
        cursor=n_samples,
    )


def make_klnmf_svi_batch_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    h_inner_iters: int = 1,
    reduce_samples=None,
):
    """Online-NMF minibatch CORE for KLNMF:
    (KLSVIState, batch, indices) -> state, with batch = {"X": (V, B)} plus
    optional 'weights_kl'/'weights_lhalf' (B,) entries supplied by the
    caller (make_klnmf_svi_step gathers them from device-resident data;
    run_svi_streaming uploads host slices). The two placements feed the
    same index sequence and produce bit-equal params. Plain PyTorch ops:
    the fused KLNMF kernel carries the joint W/H step of a full-batch
    block, which this step is not. state.perm/cursor pass through
    untouched."""
    batch_size = _validate_config(config, n_samples)
    if h_inner_iters < 1:
        raise ValueError(f"h_inner_iters={h_inner_iters} must be >= 1")
    scale = n_samples / batch_size
    n_given = int(n_given_signatures)

    def batch_step(state: KLSVIState, batch, indices) -> KLSVIState:
        W = state.params["W"]
        H = state.params["H"]
        rho = _rho(state.step, config)
        X_batch = batch["X"]                       # (V, B)
        H_batch = H.index_select(1, indices)       # (K, B)
        w_kl_batch = batch.get("weights_kl")
        w_lhalf_batch = batch.get("weights_lhalf")

        # sample-local step: exact multiplicative H updates on the batch
        for _ in range(h_inner_iters):
            aux = X_batch / mm(W, H_batch)
            H_batch = klops._update_H_from_aux(
                H_batch, W, aux, w_kl_batch, w_lhalf_batch
            )

        # W statistic from the refreshed exposures (update_W semantics)
        aux = X_batch / mm(W, H_batch)
        scaled_aux = aux if w_kl_batch is None else w_kl_batch * aux
        (counts,) = sum_samples(reduce_samples, mm(scaled_aux, H_batch.mT))
        counts_hat = W * counts * scale                # (V, K)
        stat_counts = (1.0 - rho) * state.stat_counts + rho * counts_hat

        if n_given == W.shape[1]:
            W_new = W
        else:
            W_new = _signatures_from_counts(stat_counts, W.mT, n_given).mT

        return KLSVIState(
            params={"W": W_new, "H": H.index_copy(1, indices, H_batch)},
            stat_counts=stat_counts,
            step=state.step + 1,
            perm=state.perm,
            cursor=state.cursor,
        )

    return batch_step


def make_klnmf_svi_step(
    n_samples: int,
    config: SVIConfig,
    n_given_signatures: int = 0,
    h_inner_iters: int = 1,
    sample_block: tuple[int, int] | None = None,
    reduce_samples=None,
):
    """Resident online NMF step for KLNMF: (KLSVIState, data, generator)
    -> state.

    data = {"X": (V, D)} plus optional "weights_kl"/"weights_lhalf" (D,)
    entries, exactly as the engine's data dict (klnmf.make_step_functions).
    Each step refreshes the minibatch's exposure columns with
    `h_inner_iters` exact multiplicative H updates under the current W (the
    sample-local step), then updates W from the Robbins-Monro running
    average of the D-scaled expected signature counts
    C_hat = W * ((w . X/(W H)) @ H_b^T): column-normalizing the running
    counts IS the KL multiplicative W update in sufficient-statistic form
    (online dictionary learning in the style of Mairal et al. 2010, adapted
    to generalized KL).

    Exactness anchor: batch_size = n_samples, rho = 1, h_inner_iters = 1
    reduces to update_H followed by update_W - the serial Lee-Seung cycle
    (the full-batch engine's update_WH instead shares one aux from the OLD
    W,H; both are valid majorize-minimize cycles for the same objective).
    sample_block/reduce_samples: a sample-sharded cohort, as in
    make_svi_step.
    """
    batch_size = _validate_config(config, n_samples)
    batch_step = make_klnmf_svi_batch_step(
        n_samples, config, n_given_signatures, h_inner_iters,
        reduce_samples,
    )

    def step(state: KLSVIState, data, generator) -> KLSVIState:
        if sample_block is None:
            state, indices = _draw_into_state(state, generator, batch_size,
                                              False)
        else:
            state, indices = local_batch(state, generator, batch_size,
                                         sample_block, reduce_samples,
                                         data["X"].device, False)
        batch = {"X": data["X"].index_select(1, indices)}
        for name in ("weights_kl", "weights_lhalf"):
            if data.get(name) is not None:
                batch[name] = data[name].index_select(0, indices)
        return batch_step(state, batch, indices)

    return step


def klnmf_full_objective(params, data, reduce_samples=None):
    """Full-data KLNMF objective (weighted KL + optional l1/2 penalty) at
    the current online-NMF state, in the dtype of the parameters - the
    run_svi eval hook for KLNMF. This objective is MINIMIZED (the trace
    decreases), unlike the CorrNMF ELBOs."""
    return klops.klnmf_objective(
        data["X"],
        params["W"],
        params["H"],
        data.get("weights_kl"),
        data.get("weights_lhalf"),
        reduce_samples,
    )


# --------------------------------------------------------------------- #
# multimodal (MuData) variant: shared sample embeddings, per-modality
# globals and statistics
# --------------------------------------------------------------------- #


class MMSVIState(NamedTuple):
    params: Any   # the MultimodalCorrNMF parameter tree (minus exposures)
    stats: Any    # {mod: {"observed": (K,), "predicted": (K,),
    #                      "counts": (V, K)}}
    step: int
    perm: Any     # (D,) epoch sample order on the device
    cursor: int   # position in perm
    stat_usq: Any  # 0-d running sum(sample_embeddings**2)


def mm_svi_init(params, streaming: bool = False) -> MMSVIState:
    """Fresh multimodal SVI state around a MultimodalCorrNMF parameter
    tree (models/mmcorrnmf.py _device_state). streaming=True collapses the
    device-side perm to (0,) (see svi_init)."""
    mods = {}
    stats = {}
    for name, mod in params["mods"].items():
        signatures = mod["signatures"]
        n_signatures, n_features = signatures.shape
        mods[name] = {k: v for k, v in mod.items() if k != "exposures"}
        stats[name] = {
            "observed": signatures.new_zeros(n_signatures),
            "predicted": signatures.new_zeros(n_signatures),
            "counts": signatures.new_zeros(n_features, n_signatures),
        }
    sample_embeddings = params["sample_embeddings"]
    n_samples = sample_embeddings.shape[0]
    return MMSVIState(
        params={
            "mods": mods,
            "sample_embeddings": sample_embeddings,
            "variance": params["variance"],
        },
        stats=stats,
        step=0,
        perm=_initial_perm(n_samples, sample_embeddings.device, streaming),
        cursor=n_samples,
        stat_usq=(sample_embeddings**2).sum(),
    )


def _gaussian_penalty(embeddings, variance, reduce_samples=None):
    """The Gaussian log-density terms of one embedding matrix (count, m)
    under the shared variance (its rows over every rank's samples with
    reduce_samples)."""
    dim = embeddings.shape[-1]
    square, count = sum_samples(reduce_samples, *ops.variance_sums(embeddings))
    return (-0.5 * dim * count * torch.log(2.0 * math.pi * variance)
            - square / (2.0 * variance))


def mm_full_elbo(params, X, reduce_samples=None):
    """Full-data multimodal ELBO in the dtype of the parameters (exposures
    recomputed; shared sample penalty added exactly once, as in
    MultimodalCorrNMF._build_step)."""
    U = params["sample_embeddings"]
    variance = params["variance"]
    elbo = 0.0
    for name, mod in params["mods"].items():
        exposures = ops.compute_exposures(
            mod["signature_scalings"], mod["sample_scalings"],
            mod["signature_embeddings"], U,
        )
        elbo = elbo + ops.elbo_corrnmf(
            X[name], mod["signatures"], exposures,
            mod["signature_embeddings"], U, variance,
            penalize_sample_embeddings=False,
            reduce_samples=reduce_samples,
        )
    return elbo + _gaussian_penalty(U, variance, reduce_samples)


_MOD_FLAG_DEFAULTS = dict(
    n_given=0, fix_signatures=False, fix_sig_scalings=False,
    fix_smp_scalings=False, fix_sig_embeddings=False,
)


def make_mm_svi_batch_step(
    n_samples: int,
    mod_names: list,
    ns_signatures: list,
    config: SVIConfig,
    mod_flags: dict | None = None,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
    reduce_samples=None,
):
    """Multimodal minibatch CORE: (MMSVIState, X_batch, indices) -> state,
    with X_batch = {mod: (B, V_i) count rows} supplied by the caller - the
    shared engine of the device-resident (make_mm_svi_step) and
    host-streaming (run_svi_streaming) placements; see make_svi_batch_step.

    One shared minibatch of samples drives every modality; the joint
    sample-embedding update concatenates the modality signature axes as
    the full-batch step does (models/mmcorrnmf.py _build_step step 5b).
    mod_flags[name] may carry 'n_given', 'fix_signatures',
    'fix_sig_scalings', 'fix_smp_scalings', 'fix_sig_embeddings' (all
    defaulting to free).
    """
    batch_size = _validate_config(config, n_samples)
    scale = n_samples / batch_size
    log_scale = math.log(scale)
    mod_names = list(mod_names)
    ns_signatures = [int(n) for n in ns_signatures]
    flags = {
        name: {**_MOD_FLAG_DEFAULTS, **((mod_flags or {}).get(name) or {})}
        for name in mod_names
    }

    def batch_step(state: MMSVIState, X_batch_all, indices) -> MMSVIState:
        mods = {
            name: dict(state.params["mods"][name]) for name in mod_names
        }
        U = state.params["sample_embeddings"]
        variance = state.params["variance"]
        stats = {name: dict(state.stats[name]) for name in mod_names}
        rho = _rho(state.step, config)
        stat_usq = state.stat_usq

        U_batch = U.index_select(0, indices)  # (B, m)
        usq_batch_old = (U_batch**2).sum()

        # 1-3: per-modality locals + sufficient statistics on the batch
        batch = {}
        for name in mod_names:
            m, f = mods[name], flags[name]
            X_batch = X_batch_all[name]                    # (B, V_i)
            tau_batch = m["sample_scalings"].index_select(0, indices)
            if not f["fix_smp_scalings"]:
                tau_batch = ops.update_sample_scalings(
                    X_batch, m["signature_scalings"],
                    m["signature_embeddings"], U_batch,
                )
            exposures_batch = ops.compute_exposures(
                m["signature_scalings"], tau_batch,
                m["signature_embeddings"], U_batch,
            )                                              # (B, K_i)
            ratios = X_batch / mm(exposures_batch, m["signatures"])
            aux_batch = (
                exposures_batch.mT * mm(m["signatures"], ratios.mT)
            )                                              # (K_i, B)
            batch[name] = dict(
                tau=tau_batch, exposures=exposures_batch,
                ratios=ratios, aux=aux_batch,
            )

        # the batch sums of steps 4 and 7 of every modality (the signatures
        # are untouched in between): one reduce_samples call
        sums = list(sum_samples(reduce_samples, *(
            part for name in mod_names for part in (
                *ops.signature_scaling_sums(
                    batch[name]["aux"], batch[name]["tau"],
                    mods[name]["signature_embeddings"], U_batch),
                mm(batch[name]["ratios"].mT, batch[name]["exposures"])))))
        for name in mod_names:
            b = batch[name]
            b["observed"], b["predicted"], b["counts"] = sums[:3]
            del sums[:3]

        # 4: per-modality signature scalings from running averages
        for name in mod_names:
            m, f, b, s = mods[name], flags[name], batch[name], stats[name]
            observed_hat = scale * b["observed"]
            predicted_hat = scale * b["predicted"]
            s["observed"] = (1.0 - rho) * s["observed"] + rho * observed_hat
            s["predicted"] = (
                (1.0 - rho) * s["predicted"] + rho * predicted_hat
            )
            if not f["fix_sig_scalings"]:
                m["signature_scalings"] = (
                    torch.log(s["observed"]) - torch.log(s["predicted"])
                )

        # 5a: per-modality signature embeddings (damped SVI global update)
        for name in mod_names:
            m, f, b = mods[name], flags[name], batch[name]
            if f["fix_sig_embeddings"]:
                continue
            sig_emb_star = ops.update_embeddings(
                m["signature_embeddings"], U_batch,
                m["signature_scalings"], b["tau"] + log_scale,
                variance, scale * b["aux"],
                max_iter=config.signature_newton_iters,
                reduce_samples=reduce_samples,
            )
            m["signature_embeddings"] = (
                (1.0 - rho) * m["signature_embeddings"] + rho * sig_emb_star
            )

        # 5b: joint minibatch sample-embedding update across modalities;
        # everything is concatenated along the signature axis
        if not fix_sample_embeddings:
            sig_embs = torch.cat(
                [mods[n]["signature_embeddings"] for n in mod_names], dim=-2
            )
            sig_scals = torch.cat(
                [mods[n]["signature_scalings"] for n in mod_names], dim=-1
            )
            aux_all = torch.cat(
                [batch[n]["aux"] for n in mod_names], dim=-2
            )                                              # (sum K, B)
            scalings_mat = torch.cat(
                [
                    batch[n]["tau"].unsqueeze(-1).expand(-1, ns_signatures[i])
                    for i, n in enumerate(mod_names)
                ],
                dim=-1,
            )                                              # (B, sum K)
            U_batch = ops.update_embeddings(
                U_batch, sig_embs, scalings_mat, sig_scals, variance,
                aux_all.mT, max_iter=config.sample_newton_iters,
            )
            U = U.index_copy(0, indices, U_batch)
            stat_usq = _usq_update(stat_usq, usq_batch_old, U_batch,
                                   reduce_samples)

        # scatter the per-modality locals
        for name in mod_names:
            if not flags[name]["fix_smp_scalings"]:
                mods[name]["sample_scalings"] = (
                    mods[name]["sample_scalings"].index_copy(
                        0, indices, batch[name]["tau"])
                )

        # 6: shared variance from all signature embeddings + full U, with
        # the O(D m) sample term carried incrementally (exact-refreshed at
        # each epoch boundary)
        if not fix_variance:
            all_sig_embs = torch.cat(
                [mods[n]["signature_embeddings"] for n in mod_names], dim=-2
            )
            total = (all_sig_embs**2).sum() + stat_usq
            count = all_sig_embs.numel() + n_samples * U.shape[-1]
            variance = torch.clamp_min(total / count, EPSILON)

        # 7: per-modality signatures from running expected counts
        for name in mod_names:
            m, f, b, s = mods[name], flags[name], batch[name], stats[name]
            counts_hat = m["signatures"].mT * b["counts"] * scale  # (V, K)
            s["counts"] = (1.0 - rho) * s["counts"] + rho * counts_hat
            if not f["fix_signatures"]:
                m["signatures"] = _signatures_from_counts(
                    s["counts"], m["signatures"], f["n_given"])

        return MMSVIState(
            params={
                "mods": mods,
                "sample_embeddings": U,
                "variance": variance,
            },
            stats=stats,
            step=state.step + 1,
            perm=state.perm,
            cursor=state.cursor,
            stat_usq=stat_usq,
        )

    return batch_step


def make_mm_svi_step(
    n_samples: int,
    mod_names: list,
    ns_signatures: list,
    config: SVIConfig,
    mod_flags: dict | None = None,
    fix_sample_embeddings: bool = False,
    fix_variance: bool = False,
    sample_block: tuple[int, int] | None = None,
    reduce_samples=None,
):
    """Multimodal twin of make_svi_step: (MMSVIState, X_dict, generator)
    -> state, with X_dict = {mod: (D, V_i)} on the device (the rank's
    block of a sample-sharded cohort with sample_block, as in
    make_svi_step)."""
    batch_size = _validate_config(config, n_samples)
    batch_step = make_mm_svi_batch_step(
        n_samples, mod_names, ns_signatures, config, mod_flags,
        fix_sample_embeddings, fix_variance, reduce_samples,
    )
    mod_names = list(mod_names)

    def step(state: MMSVIState, X, generator) -> MMSVIState:
        if sample_block is None:
            state, indices = _draw_into_state(state, generator, batch_size,
                                              True)
        else:
            state, indices = local_batch(
                state, generator, batch_size, sample_block, reduce_samples,
                next(iter(X.values())).device, True)
        X_batch = {
            name: X[name].index_select(0, indices) for name in mod_names
        }
        return batch_step(state, X_batch, indices)

    return step


# --------------------------------------------------------------------- #
# streaming: X host-resident, minibatches uploaded per step
# --------------------------------------------------------------------- #


def _as_cpu_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


class _UploadRing:
    """A ring of host slots that carries trees of host arrays to `device`.

    On a card each slot owns, per leaf, a flat pinned host buffer and a flat
    device buffer (grown when a larger leaf arrives, viewed at the leaf's
    shape, so every uploaded tensor is contiguous); the copies run with
    ``non_blocking`` on ONE side stream that carries copies only, and two
    events a slot order them against the compute stream: `copied` (the
    compute stream waits for it before it reads the slot) and `consumed`
    (recorded on the compute stream after the consumer has enqueued its
    work; the host waits for it before it refills the slot). On the CPU the
    same slots are plain buffers and the copies plain copies."""

    def __init__(self, n_slots: int, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.slots = [{"host": {}, "device": {}, "views": None,
                       "released": False}
                      for _ in range(n_slots)]
        if self.on_card:
            self.copy_stream = torch.cuda.Stream(self.device)
            for slot in self.slots:
                slot["copied"] = torch.cuda.Event()
                slot["consumed"] = torch.cuda.Event()

    def _buffers(self, slot, path, leaf):
        """Views at `leaf`'s shape of the slot's host and device buffers."""
        n = leaf.numel()
        host = slot["host"].get(path)
        if host is None or host.numel() < n or host.dtype != leaf.dtype:
            host = torch.empty(n, dtype=leaf.dtype, pin_memory=self.on_card)
            slot["host"][path] = host
            slot["device"][path] = (
                torch.empty(n, dtype=leaf.dtype, device=self.device)
                if self.on_card else host
            )
            if self.on_card:
                # the new block may still be read by work queued on the
                # compute stream: the first copy into it waits for that
                self.copy_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
        return (host[:n].view(leaf.shape),
                slot["device"][path][:n].view(leaf.shape))

    def upload(self, position: int, tree: dict) -> None:
        """Copy `tree` (a dict of arrays, nested or not) into the slot of
        `position` and start its copy to the device."""
        slot = self.slots[position % len(self.slots)]
        if self.on_card and slot["released"]:
            slot["consumed"].synchronize()
        staged = []

        def stage(path, node):
            if isinstance(node, dict):
                return {key: stage(f"{path}/{key}", value)
                        for key, value in node.items()}
            leaf = _as_cpu_tensor(node)
            host, device = self._buffers(slot, path, leaf)
            host.copy_(leaf)
            staged.append((host, device))
            return device

        slot["views"] = stage("", tree)
        if self.on_card:
            with torch.cuda.stream(self.copy_stream):
                for host, device in staged:
                    device.copy_(host, non_blocking=True)
                slot["copied"].record(self.copy_stream)

    def take(self, position: int) -> dict:
        """The device tree of `position`; the compute stream waits for its
        copy."""
        slot = self.slots[position % len(self.slots)]
        if self.on_card:
            torch.cuda.current_stream(self.device).wait_event(slot["copied"])
        return slot["views"]

    def release(self, position: int) -> None:
        """Call once the consumer has enqueued all work that reads the
        slot of `position`."""
        if self.on_card:
            slot = self.slots[position % len(self.slots)]
            slot["consumed"].record(torch.cuda.current_stream(self.device))
            slot["released"] = True


def _prefetched(host_items, ring: _UploadRing, prefetch: int):
    """Yield (device tree, extra) for each (host tree, extra) of
    `host_items`, in order, with up to `prefetch` uploads started ahead of
    the item being consumed. The consumer must enqueue all work on an item
    before it asks for the next one (its slot is then released and, once
    the device has finished with it, refilled)."""
    host_items = iter(host_items)
    extras = collections.deque()
    uploaded = 0

    def upload_next() -> None:
        nonlocal uploaded
        item = next(host_items, None)
        if item is not None:
            tree, extra = item
            ring.upload(uploaded, tree)
            extras.append(extra)
            uploaded += 1

    for _ in range(prefetch):
        upload_next()
    position = 0
    while extras:
        yield ring.take(position), extras.popleft()
        ring.release(position)
        upload_next()
        position += 1


def _tree_device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def run_svi_streaming(
    batch_step_fn,
    state0,
    get_batch,
    n_samples: int,
    batch_size: int,
    generator,
    n_steps: int,
    eval_freq: int = 0,
    objective_fn=None,
    refresh_fn=None,
    prefetch: int = 2,
):
    """Drive minibatch steps with the count data HOST-resident: the epoch
    permutation lives on the host, each step's rows are sliced from host
    memory into a pinned slot and copied to the device on a side stream
    while the device is still computing earlier steps. `prefetch` (>= 1)
    is the number of batches uploaded ahead; the ring's `prefetch + 1`
    slots bound the batch buffers on the host and the device.

    Only the O(D) per-sample state (scalings/embeddings or H) and O(B)
    batches live on the device, so a cohort whose count matrix exceeds the
    device's memory fits end to end.

    batch_step_fn: a make_*_svi_batch_step core (state, batch, indices) ->
    state. get_batch(indices) -> host batch tree for those samples (numpy;
    the family's layout: (B, V) rows for CorrNMF, {"X": (V, B), weights...}
    for KLNMF, {mod: (B, V_i)} for multimodal); indices is a (B,) int64
    numpy array.

    The index sequence is the resident path's: the same CPU generator draws
    the same permutation at the same reshuffle positions with the same
    drop-last semantics, so streaming and resident fits from the same seed
    produce bit-equal parameters; refresh_fn (refresh_sample_usq where the
    family carries a running sum-of-squares) is applied at exactly the
    resident refresh positions.

    objective_fn(params) -> device scalar (e.g. from
    make_streamed_objective) is evaluated after every `eval_freq` steps,
    matching run_svi's recording positions. Returns (final_state, history)
    with history a (n_evals,) device tensor. The final state's perm and
    cursor are NOT meaningful (the host owns them).
    """
    _check_run(n_steps, eval_freq)
    if not 1 <= batch_size <= n_samples:
        raise ValueError(
            f"batch_size={batch_size} must be in [1, n_samples={n_samples}]"
        )
    if prefetch < 1:
        raise ValueError(f"prefetch={prefetch} must be >= 1")

    def host_batches():
        perm = None
        cursor = n_samples  # svi_init semantics: the first step reshuffles
        for _ in range(n_steps):
            reshuffled = cursor + batch_size > n_samples
            if reshuffled:
                perm = draw_permutation(generator, n_samples)
                cursor = 0
            indices = perm[cursor:cursor + batch_size]
            cursor += batch_size
            yield ({"batch": get_batch(indices.numpy()),
                    "indices": indices}, reshuffled)

    state = state0
    evaluations = []
    ring = _UploadRing(prefetch + 1, _tree_device(state0.params))
    for t, (item, reshuffled) in enumerate(
            _prefetched(host_batches(), ring, prefetch)):
        if reshuffled and refresh_fn is not None:
            state = refresh_fn(state)
        state = batch_step_fn(state, item["batch"], item["indices"])
        if eval_freq and objective_fn is not None \
                and (t + 1) % eval_freq == 0:
            evaluations.append(objective_fn(state.params))
    return state, _stack_history(evaluations, state0.params)


def make_streamed_objective(
    chunk_fn,
    rest_fn,
    get_chunk,
    n_samples: int,
    chunk_size: int = 8192,
):
    """Build params -> device-scalar full-data objective that streams the
    host-resident counts through the device in chunks (double-buffered
    through the same pinned ring as the minibatches), in the dtype of the
    parameters.

    chunk_fn(carry, params, chunk, indices) accumulates the chunk's
    decomposable contribution into the scalar carry; rest_fn(params) adds
    the sample-independent terms (Gaussian penalties). get_chunk(indices)
    -> host tree of those samples' counts. The last chunk is simply
    shorter: nothing is compiled, so it needs neither index padding nor a
    validity mask. The accumulation stays ON THE DEVICE - one scalar an
    evaluation, fetched by the caller."""
    chunk_size = int(min(chunk_size, n_samples))
    rings = {}  # one ring of two slots per device, kept across evaluations

    def evaluate(params):
        device = _tree_device(params)
        if device not in rings:
            rings[device] = _UploadRing(2, device)
        ring = rings[device]

        def host_chunks():
            for start in range(0, n_samples, chunk_size):
                stop = min(start + chunk_size, n_samples)
                indices = np.arange(start, stop, dtype=np.int64)
                yield {"chunk": get_chunk(indices), "indices": indices}, None

        carry = tree_leaves(params)[0].new_zeros(())
        for item, _ in _prefetched(host_chunks(), ring, 1):
            carry = chunk_fn(carry, params, item["chunk"], item["indices"])
        return carry + rest_fn(params)

    return evaluate


def corrnmf_elbo_stream_chunk(carry, params, X_chunk, indices):
    """Per-chunk Poisson log-likelihood contribution to the CorrNMF ELBO
    (the sample-decomposable part of ops.corrnmf.elbo_corrnmf; X_chunk is
    (C, V) count rows)."""
    tau = params["sample_scalings"].index_select(0, indices)
    u = params["sample_embeddings"].index_select(0, indices)
    exposures = ops.compute_exposures(
        params["signature_scalings"], tau, params["signature_embeddings"], u
    )                                           # (C, K)
    return carry + klops.poisson_llh(
        X_chunk.mT, params["signatures"].mT, exposures.mT)


def corrnmf_elbo_stream_rest(params):
    """Sample-count-independent ELBO terms: both Gaussian embedding
    penalties (the full sample-embedding matrix is device-resident)."""
    variance = params["variance"]
    return (_gaussian_penalty(params["signature_embeddings"], variance)
            + _gaussian_penalty(params["sample_embeddings"], variance))


def klnmf_objective_stream_chunk(carry, params, chunk, indices):
    """Per-chunk weighted-KL (+ l1/2) contribution to the KLNMF objective
    (sample-decomposable; chunk = {"X": (V, C)} plus optional weights)."""
    H_cols = params["H"].index_select(1, indices)   # (K, C)
    return carry + klops.klnmf_objective(
        chunk["X"], params["W"], H_cols,
        chunk.get("weights_kl"), chunk.get("weights_lhalf"),
    )


def klnmf_objective_stream_rest(params):
    """KLNMF has no sample-independent objective terms."""
    return params["W"].new_zeros(())


def mm_elbo_stream_chunk(carry, params, X_chunk, indices):
    """Per-chunk multimodal ELBO contribution: each modality's Poisson
    log-likelihood over the chunk's samples (X_chunk = {mod: (C, V_i)})."""
    U = params["sample_embeddings"]
    for name, mod in params["mods"].items():
        sub = {
            "sample_scalings": mod["sample_scalings"],
            "sample_embeddings": U,
            "signature_scalings": mod["signature_scalings"],
            "signature_embeddings": mod["signature_embeddings"],
            "signatures": mod["signatures"],
        }
        carry = corrnmf_elbo_stream_chunk(carry, sub, X_chunk[name], indices)
    return carry


def mm_elbo_stream_rest(params):
    """Multimodal sample-independent terms: per-modality signature
    penalties plus the shared sample penalty exactly once (mm_full_elbo
    semantics)."""
    variance = params["variance"]
    rest = _gaussian_penalty(params["sample_embeddings"], variance)
    for mod in params["mods"].values():
        rest = rest + _gaussian_penalty(mod["signature_embeddings"], variance)
    return rest


__all__ = [
    "KLSVIState",
    "MMSVIState",
    "SVIConfig",
    "SVIState",
    "corrnmf_elbo_stream_chunk",
    "corrnmf_elbo_stream_rest",
    "draw_permutation",
    "full_elbo",
    "klnmf_full_objective",
    "klnmf_objective_stream_chunk",
    "klnmf_objective_stream_rest",
    "klnmf_svi_init",
    "make_klnmf_svi_batch_step",
    "make_klnmf_svi_step",
    "make_mm_svi_batch_step",
    "make_mm_svi_step",
    "make_streamed_objective",
    "make_svi_batch_step",
    "make_svi_step",
    "mm_elbo_stream_chunk",
    "mm_elbo_stream_rest",
    "mm_full_elbo",
    "mm_svi_init",
    "refresh_sample_usq",
    "run_svi",
    "run_svi_streaming",
    "svi_init",
]
