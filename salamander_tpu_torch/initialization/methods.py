"""The seven initialization methods (held against
salamander_tpu/initialization/methods.py; the host methods are copied).

Parity notes (reference initialization/methods.py):
  init_custom      :27-55  shape/type checks only
  init_flat        :58-66  uniform signatures, rowsum/k exposures
  init_nndsvd      :69-86  delegates to sklearn's private _initialize_nmf -
                           we do the same when sklearn is present (it is the
                           only way to reproduce the reference's exact draws,
                           including nndsvdar's randomized fill-in), with a
                           self-contained SVD fallback otherwise
  init_random      :89-109 Dirichlet draws on the simplex via the GLOBAL
                           numpy RNG after np.random.seed(seed) - kept
                           verbatim in semantics for golden parity
  init_separableNMF:112-135 Gillis-Vavasis successive projection; exposures
                           delegated to init_random with the same seed

These run host-side on numpy: they execute once per fit on tiny matrices and
must replicate numpy RNG streams bit-for-bit. The batched multi-start
initializers (random_init_batch, corrnmf_init_batch) live at the bottom and
draw with a torch.Generator on the device of the data.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from ..utils import shape_checker, type_checker

EPSILON = float(np.finfo(np.float32).eps)

INIT_METHODS = (
    "custom",
    "flat",
    "nndsvd",
    "nndsvda",
    "nndsvdar",
    "random",
    "separableNMF",
)


def init_custom(
    data_mat: np.ndarray,
    n_signatures: int,
    signatures_mat: np.ndarray,
    exposures_mat: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Validate user-provided signature and exposure matrices.

    data_mat: (n_samples, n_features); signatures_mat: (n_signatures,
    n_features); exposures_mat: (n_samples, n_signatures).
    """
    type_checker("signatures_mat", signatures_mat, np.ndarray)
    type_checker("exposures_mat", exposures_mat, np.ndarray)
    n_samples, n_features = data_mat.shape
    shape_checker("signatures_mat", signatures_mat, (n_signatures, n_features))
    shape_checker("exposures_mat", exposures_mat, (n_samples, n_signatures))
    return signatures_mat, exposures_mat


def init_flat(data_mat: np.ndarray, n_signatures: int):
    """Uniform signatures; every sample's counts split evenly across them."""
    n_features = data_mat.shape[1]
    signatures_mat = np.full((n_signatures, n_features), 1.0 / n_features)
    per_signature = np.sum(data_mat, axis=1) / n_signatures
    exposures_mat = np.tile(per_signature, (n_signatures, 1)).T
    return signatures_mat, exposures_mat


def _nndsvd_numpy(data_mat: np.ndarray, n_signatures: int,
                  variant: str, seed: int | None):
    """Self-contained NNDSVD(+a/ar) fallback (Boutsidis & Gallopoulos 2008),
    used only when sklearn is unavailable."""
    U, S, Vt = np.linalg.svd(data_mat, full_matrices=False)
    E = np.zeros((data_mat.shape[0], n_signatures))
    F = np.zeros((n_signatures, data_mat.shape[1]))
    E[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    F[0, :] = np.sqrt(S[0]) * np.abs(Vt[0, :])
    for j in range(1, n_signatures):
        u, v = U[:, j], Vt[j, :]
        u_pos, v_pos = np.maximum(u, 0), np.maximum(v, 0)
        u_neg, v_neg = np.maximum(-u, 0), np.maximum(-v, 0)
        norm_pos = np.linalg.norm(u_pos) * np.linalg.norm(v_pos)
        norm_neg = np.linalg.norm(u_neg) * np.linalg.norm(v_neg)
        if norm_pos >= norm_neg:
            scale = norm_pos
            uu = u_pos / np.linalg.norm(u_pos)
            vv = v_pos / np.linalg.norm(v_pos)
        else:
            scale = norm_neg
            uu = u_neg / np.linalg.norm(u_neg)
            vv = v_neg / np.linalg.norm(v_neg)
        E[:, j] = np.sqrt(S[j] * scale) * uu
        F[j, :] = np.sqrt(S[j] * scale) * vv
    if variant == "nndsvda":
        mean = data_mat.mean()
        E[E == 0] = mean
        F[F == 0] = mean
    elif variant == "nndsvdar":
        rng = np.random.mtrand._rand
        mean = data_mat.mean()
        E[E == 0] = mean * rng.standard_normal(size=(E == 0).sum()) / 100.0
        F[F == 0] = mean * rng.standard_normal(size=(F == 0).sum()) / 100.0
    return F, E  # (signatures, exposures)


def init_nndsvd(
    data_mat: np.ndarray,
    n_signatures: int,
    method: Literal["nndsvd", "nndsvda", "nndsvdar"] = "nndsvd",
    seed: int | None = None,
):
    """Non-negative double SVD initialization.

    Matches the reference by delegating to sklearn's implementation when
    available (reference methods.py:69-86 uses the same private API); the
    global numpy RNG is seeded first so 'nndsvdar' reproduces the exact
    random fill-in of the golden fixtures.
    """
    if seed is not None:
        np.random.seed(seed)
    try:
        from sklearn.decomposition import _nmf as sklearn_nmf

        exposures_mat, signatures_mat = sklearn_nmf._initialize_nmf(
            data_mat, n_signatures, init=method
        )
    except ImportError:  # no sklearn: the self-contained SVD route
        signatures_mat, exposures_mat = _nndsvd_numpy(
            data_mat, n_signatures, method, seed
        )
    return signatures_mat, exposures_mat


def init_random(data_mat: np.ndarray, n_signatures: int, seed: int | None = None):
    """Dirichlet draws on the simplex: uniform random signatures, and
    per-sample exposures scaled to the sample's total count."""
    if seed is not None:
        np.random.seed(seed)
    n_samples, n_features = data_mat.shape
    signatures_mat = np.random.dirichlet(np.ones(n_features), size=n_signatures)
    totals = np.sum(data_mat, axis=1)
    exposures_mat = totals[:, None] * np.random.dirichlet(
        np.ones(n_signatures), size=n_samples
    )
    return signatures_mat, exposures_mat


def init_separable_nmf(data_mat: np.ndarray, n_signatures: int,
                       seed: int | None = None):
    """Successive projection (SPA): greedily pick the data rows with the
    largest residual column norm as anchor signatures (Gillis & Vavasis 2013,
    Algorithm 1 with f = ||.||^2); exposures from init_random."""
    chosen = np.empty(n_signatures, dtype=int)
    residual = data_mat.T / np.sum(data_mat.T, axis=0)
    for k in range(n_signatures):
        norms = np.sum(residual**2, axis=0)
        anchor = int(np.argmax(norms))
        u = residual[:, anchor]
        projector = np.identity(residual.shape[0]) - np.outer(u, u) / norms[anchor]
        residual = projector @ residual
        chosen[k] = anchor
    signatures_mat = data_mat[chosen, :].astype(float)
    signatures_mat /= signatures_mat.sum(axis=1)[:, None]
    _, exposures_mat = init_random(data_mat, n_signatures, seed=seed)
    return signatures_mat, exposures_mat


# backwards-compatible alias matching the reference's camel-case name
init_separableNMF = init_separable_nmf


# ---------------------------------------------------------------------------
# Batched initialization for the multi-start fit (torch.Generator).
# ---------------------------------------------------------------------------

def random_init_batch(generator, data_mat, n_signatures: int,
                      n_restarts: int, dtype=None):
    """Initialize (W, H) for many restarts at once on data_mat's device.

    Returns W: (n_restarts, V, K) column-stochastic and H: (n_restarts, K, D)
    scaled to per-sample totals - the batched counterpart of init_random.
    data_mat is (V, D) in kernel orientation; `generator` is a
    torch.Generator on the same device. Dirichlet(1, ..., 1) draws are
    normalized iid Exponential(1) draws (the same distribution).
    """
    import torch

    if dtype is None:
        dtype = data_mat.dtype
    n_features, n_samples = data_mat.shape
    device = data_mat.device
    draws_w = torch.empty((n_restarts, n_signatures, n_features),
                          dtype=dtype, device=device)
    draws_w.exponential_(generator=generator)
    W = (draws_w / draws_w.sum(-1, keepdim=True)).transpose(1, 2)
    draws_h = torch.empty((n_restarts, n_samples, n_signatures),
                          dtype=dtype, device=device)
    draws_h.exponential_(generator=generator)
    exposures = (draws_h / draws_h.sum(-1, keepdim=True)).transpose(1, 2)
    totals = data_mat.to(dtype).sum(0)
    H = exposures * totals
    W = torch.clamp_min(W, EPSILON).contiguous()
    H = torch.clamp_min(H, EPSILON).contiguous()
    return W, H


def corrnmf_init_batch(generator, data_mat, n_signatures: int,
                       dim_embeddings: int, n_restarts: int, dtype=None):
    """Initialize a batch of CorrNMF parameter dicts on data_mat's device.

    The batched counterpart of initialize_corrnmf with init_method 'random'
    (reference initialization/initialize.py:319-384): Dirichlet signatures
    (normalized exponentials), zero scalings, standard-normal embeddings,
    unit variance; exposures derived from the scalings and embeddings.
    data_mat is (D, V) with samples as rows (model orientation);
    `generator` is a torch.Generator on its device. Returns the params of
    CorrNMFDet._device_state with a leading restart axis.
    """
    import torch

    from ..ops.corrnmf import compute_exposures

    if dtype is None:
        dtype = data_mat.dtype
    n_samples, n_features = data_mat.shape
    device = data_mat.device

    def draw(shape, sampler):
        values = torch.empty((n_restarts,) + shape, dtype=dtype,
                             device=device)
        return sampler(values)

    draws = draw((n_signatures, n_features),
                 lambda t: t.exponential_(generator=generator))
    signatures = torch.clamp_min(draws / draws.sum(-1, keepdim=True),
                                 EPSILON)
    signature_embeddings = draw((n_signatures, dim_embeddings),
                                lambda t: t.normal_(generator=generator))
    sample_embeddings = draw((n_samples, dim_embeddings),
                             lambda t: t.normal_(generator=generator))
    signature_scalings = torch.zeros((n_restarts, n_signatures), dtype=dtype,
                                     device=device)
    sample_scalings = torch.zeros((n_restarts, n_samples), dtype=dtype,
                                  device=device)
    return {
        "signatures": signatures,
        "signature_scalings": signature_scalings,
        "sample_scalings": sample_scalings,
        "signature_embeddings": signature_embeddings,
        "sample_embeddings": sample_embeddings,
        "variance": torch.ones(n_restarts, dtype=dtype, device=device),
        "exposures": compute_exposures(signature_scalings, sample_scalings,
                                       signature_embeddings,
                                       sample_embeddings),
    }
