"""KL-NMF by Lee and Seung's multiplicative updates, batched over lanes,
with the convergence rule the port states (engine/fit.py's docstring):
blocks of ``conv_test_freq`` joint updates, the objective after each (in
float64 for the reference), a lane done when its relative change falls
below the tolerance after ``min_iterations`` or at ``max_iterations``,
done lanes frozen.

``Arith`` says how the updates compute: the configuration's float32 with
IEEE products, float64 (the reference), or float32 whose products take
TF32 inputs (10 mantissa bits, as an H100's tensor cores read them): the
control, the nearest precision below the configuration's. TF32 is emulated
by rounding the operands, so the control runs alike on a card and a CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10 mantissa bits (ties to
    even), as float32."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


class Arith(NamedTuple):
    dtype: torch.dtype
    tf32: bool = False

    def mm(self, a, b):
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)


FLOAT64 = Arith(torch.float64)
FLOAT32 = Arith(torch.float32)
TF32 = Arith(torch.float32, tf32=True)


def effective_tol(tol: float, param_dtype=torch.float32) -> float:
    """The stated tolerance floored at ten epsilons of the parameters'
    float type (the port's rule: below it a float32 objective jitters
    forever)."""
    if param_dtype == torch.float64:
        return float(tol)
    return max(float(tol), 10.0 * EPS32)


def kl(X, W, H, mm=torch.matmul):
    """Generalized KL divergence D(X || WH) per lane, summed over V and
    D; X == 0 terms contribute WH alone."""
    WH = mm(W, H)
    positive = X > 0
    ratio = torch.where(positive, X / torch.where(positive, WH, 1.0), 1.0)
    terms = torch.where(positive, X * torch.log(ratio) - X, 0.0) + WH
    return terms.sum((-2, -1))


def mu_step(X, W, H, arith: Arith):
    """One joint update from the OLD (W, H): W's numerator (X / WH) H^T,
    columns renormalized to sum one, H by W^T (X / WH); both floored at
    float32's epsilon."""
    aux = X / arith.mm(W, H)
    W_new = W * arith.mm(aux, H.mT)
    W_new = torch.clamp_min(W_new / W_new.sum(-2, keepdim=True), EPS32)
    H_new = torch.clamp_min(H * arith.mm(W.mT, aux), EPS32)
    return W_new, H_new


def fit_lanes(X, W0, H0, min_iterations: int, max_iterations: int,
              conv_test_freq: int, tol: float, arith: Arith):
    """Fit every lane of W0 (L, V, K), H0 (L, K, D) against X (V, D) or
    its own X (L, V, D) to the rule above, the objective in the precision
    of `arith` (float64 for the reference; the control's own). Done lanes
    leave the batch. Returns (W, H, losses of the final factors as
    float64 numbers, iterations)."""
    X = X.to(arith.dtype)
    W, H = W0.to(arith.dtype).clone(), H0.to(arith.dtype).clone()
    n = W.shape[0]

    def lanes_of(rows):
        return X if X.dim() == 2 else X[rows]

    def objective(Xr, Wr, Hr):
        return kl(Xr, Wr, Hr, arith.mm).to(torch.float64)

    alive = torch.arange(n, device=W.device)
    Xa = lanes_of(alive)
    prev = objective(Xa, W, H)
    iterations = np.zeros(n, dtype=np.int64)
    iteration = 0
    while alive.numel() and iteration + conv_test_freq <= max_iterations:
        Wa, Ha = W[alive], H[alive]
        for _ in range(conv_test_freq):
            Wa, Ha = mu_step(Xa, Wa, Ha, arith)
        iteration += conv_test_freq
        W[alive], H[alive] = Wa, Ha
        value = objective(Xa, Wa, Ha)
        change = torch.abs(prev[alive] - value) / torch.abs(prev[alive])
        done = ((change < tol) & (iteration >= min_iterations)) | (
            iteration >= max_iterations)
        prev[alive] = value
        iterations[alive.cpu().numpy()] = iteration
        if bool(done.any()):
            alive = alive[~done]
            Xa = lanes_of(alive)
    tail = max_iterations - (max_iterations // conv_test_freq) * \
        conv_test_freq
    if alive.numel() and tail:
        Wa, Ha = W[alive], H[alive]
        for _ in range(tail):
            Wa, Ha = mu_step(Xa, Wa, Ha, arith)
        W[alive], H[alive] = Wa, Ha
        iterations[alive.cpu().numpy()] = max_iterations
    losses = objective(lanes_of(torch.arange(n, device=W.device)), W, H)
    return W, H, losses.cpu().numpy(), iterations


def restart_init(X32, n_signatures: int, n_restarts: int, seed: int):
    """The seeded starting points of a multi-start fit, drawn again on
    X32's device as the port states them: Dirichlet(1) signatures and
    per-sample exposure shares as normalized Exponential(1) draws from one
    torch.Generator seeded with `seed` (signatures first), exposures
    scaled to each sample's total, both floored at float32's epsilon."""
    V, D = X32.shape
    generator = torch.Generator(device=X32.device).manual_seed(int(seed))
    draws_w = torch.empty((n_restarts, n_signatures, V), dtype=torch.float32,
                          device=X32.device)
    draws_w.exponential_(generator=generator)
    W = (draws_w / draws_w.sum(-1, keepdim=True)).transpose(1, 2)
    draws_h = torch.empty((n_restarts, D, n_signatures), dtype=torch.float32,
                          device=X32.device)
    draws_h.exponential_(generator=generator)
    shares = (draws_h / draws_h.sum(-1, keepdim=True)).transpose(1, 2)
    H = shares * X32.sum(0)
    return (torch.clamp_min(W, EPS32).contiguous(),
            torch.clamp_min(H, EPS32).contiguous())


def restarts(X, n_signatures: int, n_restarts: int, seed: int, fit_config,
             arith: Arith = FLOAT64, device=None):
    """The reference multi-start fit of counts X (V, D): (W, H, losses,
    iterations) as host arrays."""
    X32 = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)
    W0, H0 = restart_init(X32, n_signatures, n_restarts, seed)
    min_it, max_it, freq, tol = fit_config
    W, H, losses, iterations = fit_lanes(
        X32, W0, H0, min_it, max_it, freq, effective_tol(tol), arith)
    return W.cpu().numpy(), H.cpu().numpy(), losses, iterations
