"""Multimodal correlated NMF (joint CorrNMF over modalities that share
their samples), batched over restart lanes, written from the stated
algorithm of one joint EM cycle, in this order:

1. per modality, the sample scalings tau_d = log sum_v x_dv - log sum_k
   exp(sigma_k + <l_k, u_d>), then the exposures
   e_dk = exp(sigma_k + tau_d + <l_k, u_d>);
2. per modality, aux_kd = e_dk sum_v s_kv x_dv / (E S)_dv, then the
   signature scalings sigma_k = log sum_d aux_kd - log sum_d exp(tau_d +
   <l_k, u_d>);
3. per modality, each signature embedding l_k by damped Newton on its
   surrogate f(b) = -<b, sum_d aux_kd u_d> + sum_d exp(sigma_k + tau_d +
   <b, u_d>) + |b|^2 / (2 variance), to its own stop: a step solves
   H d = -g, tries t = 1, 1/2, ..., 2^-40 and takes the first t with
   f(b + t d) - f(b) <= 1e-4 t <g, d> (2^-40 always), the difference
   summed term by term (a rate's change r (exp(t <d, u_d>) - 1) by
   expm1), and a row stops once sum |t d| < m * 1e-5, or after 100 steps;
4. the shared sample embeddings u_d by 3 such Newton steps over the
   signatures of every modality at once (each term's scaling is its own
   modality's tau_d);
5. the shared variance, the mean of every squared embedding entry,
   floored at float32's epsilon;
6. per modality, the signatures by the KL multiplicative update at the
   step-1 exposures and the old signatures, columns renormalized, floored
   at float32's epsilon.

Magnitudes of the new embeddings in (0, eps) are pushed out to +-eps (eps
float32's). The ELBO is the sum over modalities of the Poisson
log-likelihood of X against E S (E the stored step-1 exposures, S the
new signatures), minus the Gaussian penalties of every signature embedding
and, once, of the sample embeddings, each with its normalization. The
convergence rule is reference/klnmf.py's: the ELBO every conv_test_freq
cycles (in the precision of `Arith`, float64 for the reference), a lane
done once its relative change falls below the tolerance after
min_iterations, or at max_iterations; done lanes frozen.

Departures from the reference Salamander's equations (mmcorrnmf.py and
_utils_corrnmf.py of parklab/Salamander):
- the embedding M-steps are damped Newton with the Armijo halvings above
  where Salamander calls scipy's Newton-CG per row (signature side at
  scipy's defaults, sample side maxiter 3); the optimum of each
  signature-side solve is the same strictly convex minimum, the 3 sample
  steps are not;
- the Newton system is solved by torch.linalg.solve (LU), not conjugate
  gradients;
- the done rows of a solve are frozen while others step, and the
  sample-side steps stop a row the same way (scipy's maxiter 3 has no such
  test);
- the sample-side row stop and the cap of 100 signature-side steps are the
  port's statement, not Salamander's.

The starting points are drawn again as the port's fit_best_of draws them
for init_method="random" without given parameters (its device path): one
torch.Generator on the data's device seeded with the base seed, in the
configuration's dtype; the sample embeddings (R, D, m) standard normal
first, then per modality in order Dirichlet(1) signatures as normalized
Exponential(1) draws (R, K, V), floored at eps, and standard-normal
signature embeddings (R, K, m); zero scalings, unit variance, the
exposures of those.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .klnmf import EPS32, FLOAT64, Arith, effective_tol

XTOL = 1e-5              # a row's Newton stop, times the dimension
N_HALVINGS = 41          # t = 2^0 .. 2^-40
SIGNATURE_STEPS = 100    # the signature side's cap
SAMPLE_STEPS = 3         # the sample side's steps


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exposures(sig_scal, smp_scal, sig_emb, smp_emb, arith: Arith):
    """(..., D, K): exp(sigma_k + tau_d + <l_k, u_d>)."""
    return torch.exp(sig_scal.unsqueeze(-2) + smp_scal.unsqueeze(-1)
                     + arith.mm(smp_emb, sig_emb.mT))


def newton(rows, others, offsets, aux, variance, steps: int, early_exit,
           arith: Arith):
    """Damped Newton on every row of `rows` (..., N, m) against the fixed
    `others` (..., M, m): offsets (..., N, M) the scalings' sum, aux
    (..., N, M) the rows' statistics, variance (...,). Done rows are
    frozen; with early_exit the loop ends once every row is done."""
    dim = rows.shape[-1]
    var = variance[..., None, None]
    ts = 0.5 ** torch.arange(N_HALVINGS, dtype=rows.dtype,
                             device=rows.device)
    linear = arith.mm(aux, others)                           # (..., N, m)
    eye = torch.eye(dim, dtype=rows.dtype, device=rows.device)
    done = torch.zeros(rows.shape[:-1], dtype=torch.bool, device=rows.device)
    b = rows
    for _ in range(steps):
        rates = torch.exp(offsets + arith.mm(b, others.mT))  # (..., N, M)
        grad = -linear + arith.mm(rates, others) + b / var
        hess = arith.mm((rates.unsqueeze(-1) * others.unsqueeze(-3)).mT,
                        others.unsqueeze(-3)) + eye / var.unsqueeze(-1)
        direction = -torch.linalg.solve(hess, grad.unsqueeze(-1)).squeeze(-1)
        slope = (grad * direction).sum(-1)
        # f(b + t d) - f(b), each term's change as such
        along = arith.mm(direction, others.mT)               # (..., N, M)
        change = ((rates.unsqueeze(-2) * torch.expm1(
            ts.unsqueeze(-1) * along.unsqueeze(-2))).sum(-1)
            - ts * (linear * direction).sum(-1, keepdim=True)
            + (2.0 * ts * (b * direction).sum(-1, keepdim=True)
               + ts * ts * (direction * direction).sum(-1, keepdim=True))
            / (2.0 * var))                                   # (..., N, 41)
        ok = change <= 1e-4 * ts * slope.unsqueeze(-1)
        ok[..., -1] = True
        t = ts[ok.to(torch.int8).argmax(-1)]
        update = t.unsqueeze(-1) * direction
        b = torch.where(done.unsqueeze(-1), b, b + update)
        done = done | (update.abs().sum(-1) < dim * XTOL)
        if early_exit and bool(done.all()):
            break
    tiny_pos = (b > 0) & (b < EPS32)
    tiny_neg = (b < 0) & (b > -EPS32)
    return torch.where(tiny_pos, EPS32, torch.where(tiny_neg, -EPS32, b))


def cycle(Xs, params, arith: Arith):
    """One joint EM cycle of every lane: Xs {mod: (D, V)}, params the tree
    {"mods": {mod: {signatures (R, K, V), signature_scalings (R, K),
    sample_scalings (R, D), signature_embeddings (R, K, m), exposures
    (R, D, K)}}, "sample_embeddings" (R, D, m), "variance" (R,)}."""
    names = list(Xs)
    U, variance = params["sample_embeddings"], params["variance"]
    mods = {name: dict(params["mods"][name]) for name in names}
    auxs = {}
    for name in names:  # 1
        m, X = mods[name], Xs[name]
        m["sample_scalings"] = torch.log(X.sum(-1)) - torch.log(torch.exp(
            m["signature_scalings"].unsqueeze(-2)
            + arith.mm(U, m["signature_embeddings"].mT)).sum(-1))
        m["exposures"] = exposures(m["signature_scalings"],
                                   m["sample_scalings"],
                                   m["signature_embeddings"], U, arith)
    for name in names:  # 2
        m, X = mods[name], Xs[name]
        E, S = m["exposures"], m["signatures"]
        auxs[name] = E.mT * arith.mm(S, (X / arith.mm(E, S)).mT)  # (R, K, D)
        predicted = torch.exp(m["sample_scalings"].unsqueeze(-2)
                              + arith.mm(m["signature_embeddings"], U.mT))
        m["signature_scalings"] = (torch.log(auxs[name].sum(-1))
                                   - torch.log(predicted.sum(-1)))
    for name in names:  # 3
        m = mods[name]
        offsets = (m["signature_scalings"].unsqueeze(-1)
                   + m["sample_scalings"].unsqueeze(-2))
        m["signature_embeddings"] = newton(
            m["signature_embeddings"], U, offsets, auxs[name], variance,
            SIGNATURE_STEPS, True, arith)
    # 4: the joint sample side over the concatenated signatures
    L = torch.cat([mods[n]["signature_embeddings"] for n in names], -2)
    sigma = torch.cat([mods[n]["signature_scalings"] for n in names], -1)
    tau = torch.cat([mods[n]["sample_scalings"].unsqueeze(-1).expand(
        *mods[n]["sample_scalings"].shape, mods[n]["signatures"].shape[-2])
        for n in names], -1)                                  # (R, D, sum K)
    aux = torch.cat([auxs[n] for n in names], -2).mT          # (R, D, sum K)
    U = newton(U, L, tau + sigma.unsqueeze(-2), aux, variance, SAMPLE_STEPS,
               False, arith)
    # 5
    count = L.shape[-2] * L.shape[-1] + U.shape[-2] * U.shape[-1]
    variance = torch.clamp_min(
        ((L * L).sum((-2, -1)) + (U * U).sum((-2, -1))) / count, EPS32)
    for name in names:  # 6
        m, X = mods[name], Xs[name]
        W, H = m["signatures"].mT, m["exposures"].mT  # (R, V, K), (R, K, D)
        W_new = W * arith.mm(X.mT / arith.mm(W, H), H.mT)
        W_new = torch.clamp_min(W_new / W_new.sum(-2, keepdim=True), EPS32)
        m["signatures"] = W_new.mT
    return {"mods": mods, "sample_embeddings": U, "variance": variance}


def elbo(Xs, params, arith: Arith = FLOAT64):
    """Every lane's ELBO (..., ) at the stored exposures and signatures."""
    U, variance = params["sample_embeddings"], params["variance"]
    dim = U.shape[-1]
    log_norm = torch.log(2.0 * math.pi * variance)
    value = 0.0
    for name, X in Xs.items():
        m = params["mods"][name]
        rate = arith.mm(m["exposures"], m["signatures"])       # (R, D, V)
        positive = rate != 0
        value = value + (torch.where(
            positive, X * torch.log(torch.where(positive, rate, 1.0)), 0.0)
            - rate).sum((-2, -1)) - torch.lgamma(1.0 + X).sum((-2, -1))
        L = m["signature_embeddings"]
        value = (value - 0.5 * dim * L.shape[-2] * log_norm
                 - (L * L).sum((-2, -1)) / (2.0 * variance))
    value = (value - 0.5 * dim * U.shape[-2] * log_norm
             - (U * U).sum((-2, -1)) / (2.0 * variance))
    return value


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def restart_init(Xs, ns_signatures, dim: int, n_restarts: int, seed: int,
                 dtype=torch.float32):
    """The seeded starting points of fit_best_of's device draw (module
    docstring), on the device of Xs, in `dtype`."""
    first = next(iter(Xs.values()))
    n_samples, device = first.shape[0], first.device
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def empty(*shape):
        return torch.empty((n_restarts,) + shape, dtype=dtype, device=device)

    U = empty(n_samples, dim).normal_(generator=generator)
    mods = {}
    for (name, X), k in zip(Xs.items(), ns_signatures):
        draws = empty(k, X.shape[1]).exponential_(generator=generator)
        mod = {
            "signatures": torch.clamp_min(draws / draws.sum(-1, keepdim=True),
                                          EPS32),
            "signature_scalings": torch.zeros((n_restarts, k), dtype=dtype,
                                              device=device),
            "sample_scalings": torch.zeros((n_restarts, n_samples),
                                           dtype=dtype, device=device),
            "signature_embeddings": empty(k, dim).normal_(
                generator=generator),
        }
        mod["exposures"] = exposures(mod["signature_scalings"],
                                     mod["sample_scalings"],
                                     mod["signature_embeddings"], U,
                                     Arith(dtype))
        mods[name] = mod
    return {"mods": mods, "sample_embeddings": U,
            "variance": torch.ones(n_restarts, dtype=dtype, device=device)}


def _where_tree(done, new, old):
    """new where the lane is not done, old where it is (lanes lead)."""
    if isinstance(new, dict):
        return {key: _where_tree(done, new[key], old[key]) for key in new}
    mask = done.reshape(done.shape + (1,) * (new.dim() - 1))
    return torch.where(mask, old, new)


def fit_lanes(Xs, params0, min_iterations: int, max_iterations: int,
              conv_test_freq: int, tol: float, arith: Arith = FLOAT64):
    """Fit every lane of params0 to the convergence rule (module
    docstring) in arith's precision. Returns (params, ELBOs of the final
    parameters as float64 numbers, iterations)."""
    Xs = {name: torch.clamp_min(X.to(arith.dtype), EPS32)
          for name, X in Xs.items()}
    params = tree_map(lambda leaf: leaf.to(arith.dtype), params0)
    n = params["variance"].shape[0]
    device = params["variance"].device
    prev = elbo(Xs, params, arith).to(torch.float64)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    iterations = np.zeros(n, dtype=np.int64)
    iteration = 0
    while not bool(done.all()) and iteration + conv_test_freq <= \
            max_iterations:
        new = params
        for _ in range(conv_test_freq):
            new = cycle(Xs, new, arith)
        iteration += conv_test_freq
        params = _where_tree(done, new, params)
        value = elbo(Xs, params, arith).to(torch.float64)
        change = torch.abs(prev - value) / torch.abs(prev)
        iterations[(~done).cpu().numpy()] = iteration
        finished = ((change < tol) & (iteration >= min_iterations)) | (
            iteration >= max_iterations)
        prev = torch.where(done, prev, value)
        done = done | finished
    tail = max_iterations - (max_iterations // conv_test_freq) \
        * conv_test_freq
    if tail and not bool(done.all()):
        new = params
        for _ in range(tail):
            new = cycle(Xs, new, arith)
        iterations[(~done).cpu().numpy()] = max_iterations
        params = _where_tree(done, new, params)
    losses = elbo(Xs, params, arith).to(torch.float64)
    return params, losses.cpu().numpy(), iterations


def best_of(counts, ns_signatures, dim: int, n_restarts: int, seed: int,
            fit_config, arith: Arith = FLOAT64, device=None,
            init_dtype=torch.float32):
    """The reference best-of-R fit of counts {mod: (D, V) host array}:
    (params with lanes leading, ELBOs, iterations, best lane)."""
    _no_tf32()
    Xs = {name: torch.as_tensor(np.asarray(X), dtype=torch.float64,
                                device=device)
          for name, X in counts.items()}
    params0 = restart_init(Xs, ns_signatures, dim, n_restarts, seed,
                           init_dtype)
    min_it, max_it, freq, tol = fit_config
    params, losses, iterations = fit_lanes(
        Xs, params0, min_it, max_it, freq,
        effective_tol(tol, init_dtype), arith)
    return params, losses, iterations, int(np.argmax(losses))
