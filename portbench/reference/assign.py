"""Sparse assignment of samples to a fixed signature catalog by greedy
backward elimination, as the port states it (assign.py and
ops/assign.py's docstrings), written plainly.

Every sample starts from its dense refit over the whole catalog (uniform
warm start, masked multiplicative H updates in blocks of ten, stopped when
the batch's summed KL changes by less than ``tol``). Each round refits
every sample with each active signature removed (50 warm-started steps),
takes the first cheapest removal and accepts it while the sample's KL
stays within ``(1 + rel_tol) * kl_dense``; then every sample gets 200
polishing steps. After the rounds, a refit to convergence, and a sample
over its budget falls back to its pre-polish state, then to its dense
refit.
"""

from __future__ import annotations

import numpy as np
import torch

from .klnmf import EPS32, FLOAT64, Arith


def catalog_matrix(catalog_frame, channels) -> np.ndarray:
    """Signatures x channels frame -> (V, K) float64, columns aligned to
    `channels`, floored at float32's epsilon and normalized."""
    W = catalog_frame.loc[:, list(channels)].to_numpy(np.float64).T
    W = np.maximum(W, EPS32)
    return W / W.sum(axis=0, keepdims=True)


def sample_kl(X, W, H, arith: Arith):
    """Per-sample KL (..., D), X == 0 entries contributing only WH."""
    zero = X == 0
    X_safe = torch.where(zero, EPS32, X)
    WH_safe = torch.where(zero, EPS32, arith.mm(W, H))
    log_term = (X_safe * torch.log(X_safe / WH_safe)).sum(-2)
    sums = W.sum(-2).unsqueeze(-1)
    return log_term - X.sum(-2) + arith.mm(H.mT, sums).squeeze(-1)


def masked_steps(X, W, H, mask, n: int, arith: Arith):
    for _ in range(int(n)):
        H = H * arith.mm(W.mT, X / arith.mm(W, H))
        H = torch.where(mask, torch.clamp_min(H, EPS32), 0.0)
    return H


def refit(X, W, mask, H0, max_iterations: int, tol: float, arith: Arith,
          freq: int = 10):
    """Masked refit to convergence of the batch's summed KL."""
    if H0 is None:
        share = X.sum(0) / torch.clamp_min(mask.sum(0), 1)
        H0 = torch.where(mask, torch.clamp_min(share.unsqueeze(0), EPS32),
                         0.0)
    H, prev = H0, None
    cur = sample_kl(X, W, H0, arith).sum()
    for block in range(-(-int(max_iterations) // freq)):
        if block >= 1:
            change = torch.abs(prev - cur) / torch.clamp_min(torch.abs(prev),
                                                             EPS32)
            if not bool(change >= tol):
                break
        H = masked_steps(X, W, H, mask, freq, arith)
        prev, cur = cur, sample_kl(X, W, H, arith).sum()
    return H


def eliminate(X, W, rel_tol: float, arith: Arith = FLOAT64,
              candidate_iters: int = 50, polish_iterations: int = 200,
              max_iterations: int = 10_000, tol: float = 1e-7,
              chunk: int = 20_000, device=None):
    """Sparse supports of counts X (V, D) on catalog W (V, K). Returns
    host arrays: mask (K, D) bool, H (K, D), kl_dense, kl_sparse (D,),
    n_rounds."""
    X = torch.as_tensor(np.asarray(X), dtype=arith.dtype, device=device)
    W = torch.as_tensor(np.asarray(W), dtype=arith.dtype, device=device)
    K, D = W.shape[1], X.shape[1]
    full = torch.ones((K, D), dtype=torch.bool, device=X.device)
    H_dense = refit(X, W, full, None, max_iterations, tol, arith)
    kl_dense = sample_kl(X, W, H_dense, arith)
    budget = (1.0 + rel_tol) * kl_dense
    removes = torch.eye(K, dtype=torch.bool, device=X.device).unsqueeze(-1)
    rows = torch.arange(K, device=X.device).unsqueeze(1)
    mask, H = full, H_dense
    frozen = torch.zeros(D, dtype=torch.bool, device=X.device)
    n_rounds = 0
    while n_rounds < K and bool((~frozen).any()):
        picks, kls, Hs = [], [], []
        for lo in range(0, D, chunk):
            Xc, mc, Hc = X[:, lo:lo + chunk], mask[:, lo:lo + chunk], \
                H[:, lo:lo + chunk]
            m_k = mc.unsqueeze(0) & ~removes
            H_k = masked_steps(Xc, W, torch.where(m_k, Hc.unsqueeze(0), 0.0),
                               m_k, candidate_iters, arith)
            valid = mc & (mc.sum(0) > 1)
            cand = torch.where(valid, sample_kl(Xc, W, H_k, arith), torch.inf)
            pick = torch.argmin(cand, dim=0)
            picks.append(pick)
            kls.append(torch.gather(cand, 0, pick.unsqueeze(0))[0])
            Hs.append(torch.gather(
                H_k, 0, pick.view(1, 1, -1).expand(1, K, -1))[0])
        pick, kl_star, H_star = (torch.cat(picks), torch.cat(kls),
                                 torch.cat(Hs, dim=-1))
        accept = (~frozen) & (kl_star <= budget)
        new_mask = mask & ~((rows == pick.unsqueeze(0)) & accept.unsqueeze(0))
        H = masked_steps(X, W, torch.where(accept.unsqueeze(0), H_star, H),
                         new_mask, polish_iterations, arith)
        mask = new_mask
        frozen = frozen | ~accept
        n_rounds += 1
    H_final = refit(X, W, mask, H, max_iterations, tol, arith)
    kl_final = sample_kl(X, W, H_final, arith)
    kl_accepted = sample_kl(X, W, H, arith)
    use_final = kl_final <= budget
    use_accepted = (~use_final) & (kl_accepted <= budget)
    use_dense = ~(use_final | use_accepted)
    H_out = torch.where(use_final, H_final,
                        torch.where(use_accepted, H, H_dense))
    mask_out = mask | use_dense
    kl_sparse = torch.where(use_final, kl_final,
                            torch.where(use_accepted, kl_accepted, kl_dense))
    return {"mask": mask_out.cpu().numpy(), "H": H_out.cpu().numpy(),
            "kl_dense": kl_dense.cpu().numpy(),
            "kl_sparse": kl_sparse.cpu().numpy(), "n_rounds": n_rounds}
