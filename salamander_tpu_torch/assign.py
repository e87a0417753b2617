"""Signature assignment: refit a cohort's exposures against a FIXED, known
signature catalog (e.g. COSMIC), densely or sparsely; held against
salamander_tpu/assign.py.

The dense refit is one masked multiplicative-update solve over the whole
cohort; the sparse search is greedy backward elimination with every
(sample, candidate removal) pair evaluated as one batched tensor per round
(ops/assign.py).

Typical use::

    catalog = sal.datasets.load_cosmic_sbs_catalog()   # signatures x 96
    res = sal.assign_signatures(adata, catalog, rel_tol=0.02)
    res.exposures     # samples x signatures, exact zeros off-support
    res.active        # bool samples x signatures

Everything runs on ``device`` (None: the current CUDA device, raising
without one) in the compute dtype of ``resolve_dtype``: float32 on a card,
float64 on the CPU. How much runs at once on the card follows from a
memory model of the working tensors against a fixed share of the card's
total memory (never its free memory), and decides no result: candidates
run a fixed step count per sample, bootstrap replicates converge each on
their own and draw from a generator keyed by (seed, replicate), and the
stores hold no memory-sized chunk. The JAX package sizes its chunks by its
accelerator's program kill.

mesh= (a parallel.make_mesh DeviceMesh that every rank passes) shards the
cohort's samples over the mesh's sample ways: each rank refits and
eliminates on its block, the convergence sums and the elimination's
stopping count are all-reduced (ops/assign.py), and the tables are
gathered, so every rank returns the whole result; the mesh's first rank
writes the stores. The sample ways must divide each chunk's width.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pandas as pd
import torch

from .models.signature_nmf import resolve_device, resolve_dtype
from .ops import assign as ops
from .ops.klnmf import EPSILON
from .ops.precision import require_ieee_float32

__all__ = [
    "AssignmentResult",
    "BootstrapExposuresResult",
    "assign_exposures",
    "assign_signatures",
    "bootstrap_exposures",
]

# share of the card's TOTAL memory that the working tensors of one batch may
# take: a function of the device alone, so one seed gives one result and one
# store layout whatever else holds memory on the card
_DEVICE_MEMORY_SHARE = 0.4


def _extract_counts(data) -> tuple[np.ndarray, pd.Index, pd.Index]:
    """Counts as (V, D) float plus (obs_names, var_names).

    Accepts the package/scverse AnnData duck type (samples x features) or
    a samples-x-features DataFrame. The input is never modified.
    """
    if hasattr(data, "obsm") and hasattr(data, "X"):
        X = np.asarray(data.X, dtype=np.float64)
        return X.T.copy(), pd.Index(data.obs_names), pd.Index(data.var_names)
    if isinstance(data, pd.DataFrame):
        return (
            data.to_numpy(dtype=np.float64).T.copy(),
            pd.Index(data.index.astype(str)),
            pd.Index(data.columns.astype(str)),
        )
    raise TypeError(
        "data must be an AnnData-like container or a samples-x-features "
        f"DataFrame, got {type(data).__name__}."
    )


def _align_catalog(catalog, var_names: pd.Index) -> tuple[np.ndarray, list[str]]:
    """Catalog -> column-stochastic W (V, K) aligned to the data's feature
    order, plus signature names.

    Accepts a signatures-x-features DataFrame (the datasets loader
    convention), a features-x-signatures DataFrame (auto-detected via the
    index), or an AnnData-like of signatures. Features must match the
    data's as a set; order is realigned here. Columns are EPSILON-floored
    and renormalized to sum one (the package-wide signature convention).
    """
    if hasattr(catalog, "obsm") and hasattr(catalog, "X"):
        catalog = pd.DataFrame(
            np.asarray(catalog.X),
            index=pd.Index(catalog.obs_names),
            columns=pd.Index(catalog.var_names),
        )
    if not isinstance(catalog, pd.DataFrame):
        raise TypeError(
            "catalog must be a DataFrame or an AnnData-like of signatures, "
            f"got {type(catalog).__name__}."
        )
    features = set(var_names)
    if set(catalog.columns.astype(str)) == features:
        frame = catalog
    elif set(catalog.index.astype(str)) == features:
        frame = catalog.T
    else:
        raise ValueError(
            "catalog features do not match the data's var_names: "
            f"{len(features)} data features, catalog is "
            f"{catalog.shape[0]} x {catalog.shape[1]}."
        )
    frame = frame.loc[:, var_names]
    W = np.maximum(frame.to_numpy(dtype=np.float64).T, EPSILON)
    W = W / W.sum(axis=0, keepdims=True)
    return W, [str(name) for name in frame.index]


def _setup(device, dtype, mesh):
    """(device, dtype) of an assignment call (a mesh= that is not a
    DeviceMesh is refused)."""
    if mesh is not None:
        from .parallel.mesh import check_mesh

        check_mesh(mesh)
    device = resolve_device(device)
    if device.type == "cuda":
        require_ieee_float32()
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    return device, resolve_dtype(dtype, device)


def _memory_budget(device) -> int | None:
    """Bytes that one batch's working tensors may take: a fixed share of
    the card's total memory; None (unlimited) on the CPU. A batch that does
    not fit after all raises its out-of-memory error: a retry at a smaller
    size would make results depend on the allocator's state."""
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(_DEVICE_MEMORY_SHARE * total)


def _memory_lanes(device, bytes_per_lane: float, n: int) -> int:
    """How many of n lanes (samples or replicates) fit the memory budget
    at bytes_per_lane each; all n on the CPU."""
    budget = _memory_budget(device)
    if budget is None:
        return n
    return max(1, min(n, int(budget / bytes_per_lane)))


def _host(tensor) -> np.ndarray:
    return tensor.cpu().numpy()


class _Samples:
    """The sample axis of an assignment call under `mesh`: the ways, and
    this rank's block of a width the ways must divide (the JAX package's
    message otherwise). Without a mesh (or with one sample way) a block is
    the whole width and nothing is reduced."""

    def __init__(self, mesh):
        from .parallel.mesh import SAMPLE_AXIS, axis_size

        self.mesh = mesh
        self.ways = axis_size(mesh, SAMPLE_AXIS)
        self.reduce = None
        if self.ways > 1:
            from .parallel.mesh import samples_reducer

            self.reduce = samples_reducer(mesh)

    def block(self, width: int) -> tuple[int, int]:
        if width % self.ways:
            raise ValueError(
                f"the sample axis ({width}) must divide the mesh's "
                f"{self.ways} sample ways; pass a batch_size that is a "
                f"multiple of {self.ways} or pad the cohort"
            )
        if self.ways == 1:
            return 0, width
        from .parallel.mesh import sample_range

        return sample_range(width, self.mesh)

    def gather(self, tensor, width: int):
        """The whole width of a (..., block) tensor."""
        if self.ways == 1:
            return tensor
        from .parallel.mesh import gather_samples

        return gather_samples(tensor, self.mesh, width)


def _open_store(checkpoint_dir, identity: dict, mesh):
    """The call's store: the mesh's first rank writes it under a mesh,
    whose runs carry "mesh" in their identity (the JAX package's)."""
    from .parallel.mesh import open_store

    if mesh is not None:
        identity = dict(identity, mesh=True)
    return open_store(checkpoint_dir, identity, mesh)


@dataclass
class AssignmentResult:
    """Sparse catalog assignment of a cohort.

    exposures: (samples x signatures) refit exposures, exact zeros off the
      per-sample support. active: bool (samples x signatures) supports.
    kl_dense / kl_sparse: per-sample KL of the full-catalog refit vs the
      sparse one. n_active: per-sample support sizes.
    """

    exposures: pd.DataFrame
    active: pd.DataFrame
    kl_dense: pd.Series
    kl_sparse: pd.Series
    n_active: pd.Series
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def signature_names(self) -> list[str]:
        return list(self.exposures.columns)

    def assigned_signatures(self) -> list[str]:
        """Catalog signatures active in at least one sample."""
        return list(self.active.columns[self.active.to_numpy().any(axis=0)])


def assign_exposures(data, catalog, max_iterations: int = 10_000,
                     tol: float = 1e-7, mesh=None, device=None,
                     dtype=None) -> pd.DataFrame:
    """Dense catalog refit: exposures for every sample over the FULL
    catalog (all signatures active), KLNMF H-updates to convergence, as
    one batched refit of the whole cohort. Equivalent to the reference's
    fit(given_parameters={'asignatures': catalog}) exposures, without
    learning anything. Returns a samples x signatures DataFrame. mesh=
    shards the samples (module docstring).
    """
    device, dtype = _setup(device, dtype, mesh)
    X, obs_names, var_names = _extract_counts(data)
    W, sig_names = _align_catalog(catalog, var_names)
    samples = _Samples(mesh)
    D = X.shape[1]
    lo, hi = samples.block(D)
    X_dev = torch.as_tensor(X[:, lo:hi], dtype=dtype, device=device)
    W_dev = torch.as_tensor(W, dtype=dtype, device=device)
    mask = torch.ones((W.shape[1], hi - lo), dtype=torch.bool,
                      device=device)
    H, _ = ops.refit_exposures(X_dev, W_dev, mask,
                               max_iterations=max_iterations, tol=tol,
                               reduce_samples=samples.reduce)
    H = samples.gather(H, D)
    return pd.DataFrame(_host(H).T, index=obs_names, columns=sig_names)


def candidate_bytes_per_sample(n_features: int, n_signatures: int,
                               itemsize: int) -> int:
    """The memory model of one sample in an elimination round: the
    candidate exposures twice at (K, K) (state and update) and the
    products WH and aux at (K, V)."""
    K, V = n_signatures, n_features
    return itemsize * (2 * K * K + 2 * K * V)


def assign_signatures(
    data,
    catalog,
    rel_tol: float = 0.02,
    abs_tol: float = 0.0,
    candidate_iters: int = 50,
    polish_iterations: int = 200,
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    batch_size: int | None = None,
    mesh=None,
    checkpoint_dir=None,
    device=None,
    dtype=None,
) -> AssignmentResult:
    """Sparse per-sample signature assignment against a fixed catalog.

    Greedy backward elimination from the dense refit: each sample keeps
    the (greedily) smallest signature subset whose KL stays within
    ``(1 + rel_tol) * kl_dense + abs_tol`` of its full-catalog refit, and
    the reported numbers honour that budget exactly
    (ops/assign._finalize_contract).

    ``batch_size`` runs the samples in equal-width chunks (the tail chunk
    padded with copies of its first sample and trimmed); None is one chunk.
    Samples are independent; the only chunking effect is that the
    convergence test aggregates the objective per chunk, so refits may stop
    a block earlier or later. Device memory needs no ``batch_size``: within
    a chunk the candidate tensors (candidate_bytes_per_sample: H twice at
    (K, K, B), WH and aux at (K, V, B)) are evaluated for as many samples
    at once as fit the memory budget (_memory_budget), which changes no
    result and no store.

    ``checkpoint_dir``: preemption-safe resume (checkpoint.ChunkStore):
    every completed chunk is written atomically, and a rerun with the same
    data, arguments, compute dtype and chunk layout skips past completed
    chunks. A store from a different run is warned about and discarded.

    ``mesh`` shards each chunk's samples (module docstring); a
    ``batch_size`` is rounded up to a multiple of the sample ways, as the
    JAX package does.
    """
    device, dtype = _setup(device, dtype, mesh)
    X, obs_names, var_names = _extract_counts(data)
    W, sig_names = _align_catalog(catalog, var_names)
    V, D = X.shape
    K = W.shape[1]
    samples = _Samples(mesh)
    if batch_size is not None and batch_size % samples.ways:
        batch_size += samples.ways - batch_size % samples.ways
    W_dev = torch.as_tensor(W, dtype=dtype, device=device)
    width = D if batch_size is None or batch_size >= D else int(batch_size)
    lo, hi = samples.block(width)
    candidate_chunk = _memory_lanes(device, candidate_bytes_per_sample(
        V, K, torch.finfo(dtype).bits // 8), hi - lo)

    store = None
    if checkpoint_dir is not None:
        from .checkpoint import data_fingerprint

        store = _open_store(checkpoint_dir, {
            "pipeline": "assign_signatures",
            "format": 1,
            "data": data_fingerprint(X, W),
            "rel_tol": float(rel_tol),
            "abs_tol": float(abs_tol),
            "candidate_iters": int(candidate_iters),
            "polish_iterations": int(polish_iterations),
            "max_iterations": int(max_iterations),
            "tol": float(tol),
            "batch_size": None if batch_size is None else int(batch_size),
            "dtype": str(dtype).removeprefix("torch."),
        }, mesh)

    def run(chunk: np.ndarray) -> dict[str, np.ndarray]:
        out = ops.eliminate_signatures(
            torch.as_tensor(chunk[:, lo:hi], dtype=dtype, device=device),
            W_dev, rel_tol, abs_tol, candidate_iters=candidate_iters,
            polish_iterations=polish_iterations,
            max_polish_iterations=max_iterations, polish_tol=tol,
            candidate_chunk=candidate_chunk, reduce_samples=samples.reduce,
        )
        n_rounds = out.pop("n_rounds")  # the chunk's, on every rank
        fetched = {key: _host(samples.gather(value, width))
                   for key, value in out.items()}
        fetched["n_rounds"] = int(n_rounds)
        return fetched

    parts = []
    for start in range(0, D, width):
        stop = min(start + width, D)
        name = f"chunk_{start:08d}"
        if store is not None:
            cached = store.load(name, match={"start": start, "stop": stop})
            if cached is not None:
                cached["n_rounds"] = int(cached["n_rounds"])
                parts.append(cached)
                continue
        chunk = X[:, start:stop]
        pad = width - chunk.shape[1]
        if pad:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:, :1], pad, axis=1)], axis=1
            )
        out = run(chunk)
        if pad:
            out = {
                key: value[..., :-pad] if np.ndim(value) else value
                for key, value in out.items()
            }
        if store is not None:
            store.save(name, match={"start": start, "stop": stop}, **out)
        parts.append(out)

    def cat(key):
        return np.concatenate([part[key] for part in parts], axis=-1)

    active = cat("mask").astype(bool)
    return AssignmentResult(
        exposures=pd.DataFrame(cat("H").T, index=obs_names, columns=sig_names),
        active=pd.DataFrame(active.T, index=obs_names, columns=sig_names),
        kl_dense=pd.Series(cat("kl_dense"), index=obs_names, name="kl_dense"),
        kl_sparse=pd.Series(cat("kl_sparse"), index=obs_names,
                            name="kl_sparse"),
        n_active=pd.Series(cat("n_active"), index=obs_names, name="n_active"),
        meta={
            "rel_tol": rel_tol,
            "abs_tol": abs_tol,
            "candidate_iters": candidate_iters,
            "n_rounds": max(part["n_rounds"] for part in parts),
            "batch_size": width,
        },
    )


@dataclass
class BootstrapExposuresResult:
    """Bootstrap uncertainty of catalog-refit exposures.

    mean/std: (samples x signatures) over replicates (replicate 0, the
    point estimate on the original counts, is excluded from the moments).
    quantiles: {q: DataFrame} over replicates. presence: P(relative
    exposure >= min_fraction) per (sample, signature). point: the
    original-counts refit.
    """

    point: pd.DataFrame
    mean: pd.DataFrame
    std: pd.DataFrame
    quantiles: dict[float, pd.DataFrame]
    presence: pd.DataFrame
    meta: dict[str, Any] = field(default_factory=dict)


def replicate_seed(seed: int, replicate: int) -> int:
    """The torch.Generator seed of resample `replicate` under `seed`: a
    replicate's counts depend on (seed, replicate) alone, whichever
    replicates share its batch (the JAX package splits one key per
    chunk)."""
    return int(np.random.SeedSequence([int(seed), int(replicate)])
               .generate_state(1, np.uint64)[0])


def bootstrap_exposures(
    data,
    catalog,
    n_replicates: int = 200,
    seed: int = 0,
    method: str = "multinomial",
    quantiles: tuple[float, ...] = (0.05, 0.5, 0.95),
    min_fraction: float = 0.05,
    active=None,
    max_iterations: int = 10_000,
    tol: float = 1e-7,
    replicate_batch: int | None = None,
    mesh=None,
    checkpoint_dir=None,
    device=None,
    dtype=None,
) -> BootstrapExposuresResult:
    """Uncertainty of catalog-refit exposures by count bootstrap.

    Resamples every sample's counts ``n_replicates - 1`` times
    ('multinomial': redraw each sample's total over features, the
    SigProfiler-style nonparametric bootstrap; 'poisson': X_b ~ Poisson(X),
    the parametric bootstrap under the model's own likelihood) and refits
    exposures against the FIXED catalog, the replicates as lanes of one
    batched refit in which each converges on its own
    (ops/assign.bootstrap_refit).

    ``active`` restricts each sample to a support (bool samples x
    signatures DataFrame/array, e.g. ``AssignmentResult.active``):
    off-support entries are exact zeros in every replicate.

    ``replicate_batch`` bounds device memory: replicates run in batches of
    that many. None runs as many at once as fit the memory budget
    (_memory_budget) at ~3.5 copies of each replicate's (V + K, D) buffers,
    twice. Replicate 0 is the original X (the point estimate); replicate
    b >= 1 draws from a torch.Generator seeded with replicate_seed(seed, b).
    The batch size changes no result: resamples and refits are per
    replicate.

    Returns a BootstrapExposuresResult; `presence` is the fraction of
    replicates where a signature carries at least ``min_fraction`` of the
    sample's exposure mass.

    ``checkpoint_dir``: preemption-safe resume, one entry per completed
    replicate; ``quantiles``, ``min_fraction`` and the batch size are not
    part of the store's identity, the compute dtype is.

    ``mesh`` shards the samples (module docstring): every rank draws each
    replicate's whole resample from replicate_seed(seed, b) and refits its
    block of it.
    """
    device, dtype = _setup(device, dtype, mesh)
    X, obs_names, var_names = _extract_counts(data)
    W, sig_names = _align_catalog(catalog, var_names)
    K, D = W.shape[1], X.shape[1]
    samples = _Samples(mesh)
    block = samples.block(D)
    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2")

    if active is None:
        mask = np.ones((K, D), dtype=bool)
    else:
        mask_arr = (
            active.to_numpy() if hasattr(active, "to_numpy")
            else np.asarray(active)
        )
        if mask_arr.shape != (D, K):
            raise ValueError(
                f"active must be (n_samples, n_signatures) = ({D}, {K}), "
                f"got {mask_arr.shape}"
            )
        mask = mask_arr.T.astype(bool)

    X_dev = torch.as_tensor(X, dtype=dtype, device=device)
    W_dev = torch.as_tensor(W, dtype=dtype, device=device)
    mask_dev = torch.as_tensor(mask[:, block[0]:block[1]], device=device)

    if replicate_batch is None:
        itemsize = torch.finfo(dtype).bits // 8
        per_rep = 3.5 * itemsize * D * (2 * X.shape[0] + 2 * K)
        replicate_batch = _memory_lanes(device, per_rep, n_replicates)
    batch = max(1, min(int(replicate_batch), n_replicates))
    store = None
    if checkpoint_dir is not None:
        from .checkpoint import data_fingerprint

        store = _open_store(checkpoint_dir, {
            "pipeline": "bootstrap_exposures",
            "format": 2,
            "data": data_fingerprint(X, W, mask),
            "n_replicates": int(n_replicates),
            "seed": int(seed),
            "method": str(method),
            "max_iterations": int(max_iterations),
            "tol": float(tol),
            "dtype": str(dtype).removeprefix("torch."),
        }, mesh)
    H_all = [None] * n_replicates
    if store is not None:
        for b in range(n_replicates):
            cached = store.load(f"replicate_{b:06d}")
            if cached is not None:
                H_all[b] = cached["H"]
    missing = [b for b in range(n_replicates) if H_all[b] is None]
    for lo in range(0, len(missing), batch):
        lanes = missing[lo:lo + batch]
        generators = [
            None if b == 0 else torch.Generator(device=device).manual_seed(
                replicate_seed(seed, b))
            for b in lanes
        ]  # replicate 0 is the original X
        H = _host(samples.gather(ops.bootstrap_refit(
            X_dev, W_dev, mask_dev, generators, method=method,
            max_iterations=max_iterations, tol=tol,
            samples=None if samples.ways == 1 else block,
            reduce_samples=samples.reduce,
        ), D))
        for b, H_b in zip(lanes, H):
            H_all[b] = H_b
            if store is not None:
                store.save(f"replicate_{b:06d}", H=H_b)
    H_all = np.stack(H_all, axis=0)                          # (B, K, D)
    E = np.swapaxes(H_all, 1, 2)                             # (B, D, K)

    def frame(a):
        return pd.DataFrame(a, index=obs_names, columns=sig_names)

    resamples = E[1:]
    fractions = resamples / np.maximum(
        resamples.sum(axis=2, keepdims=True), EPSILON
    )
    return BootstrapExposuresResult(
        point=frame(E[0]),
        mean=frame(resamples.mean(axis=0)),
        std=frame(resamples.std(axis=0, ddof=1)),
        quantiles={
            float(q): frame(np.quantile(resamples, q, axis=0))
            for q in quantiles
        },
        presence=frame((fractions >= min_fraction).mean(axis=0)),
        meta={
            "n_replicates": n_replicates,
            "method": method,
            "seed": seed,
            "min_fraction": min_fraction,
            "sparse": active is not None,
        },
    )
