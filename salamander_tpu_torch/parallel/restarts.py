"""Batched multi-start fits and rank scans, held against
salamander_tpu/parallel/restarts.py.

All restarts of one rank advance together: the batched init draws on the
device, every lane steps in lockstep blocks of the convergence engine
(finished lanes frozen, or dropped by lane compaction), and only the loss
table returns to the host. On a card a float32, unweighted, unpadded KLNMF
fit runs each block as one launch of the fused CUDA kernel over all lanes
(ops/cuda_klnmf.py); the rank-masked (padded) scans and MvNMF run as plain
PyTorch ops.

Under a (restarts, samples) mesh (parallel/mesh.py) every rank draws the
whole init from the seed on its own device, keeps its block of the lanes
(and, for KLNMF, of the samples), and the losses, iterations, W and H are
gathered at the end, so every rank holds the whole RestartResult. On a
restart-only mesh each rank's lanes take the kernel as without a mesh; a
sample-sharded block runs the plain update with one all_reduce a step.
MvNMF takes the restart axis only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from ..engine import FitConfig
from ..initialization.methods import random_init_batch
from ..models.signature_nmf import resolve_device
from ..ops import klnmf as ops
from ..ops import mvnmf as mv_ops
from ..ops.precision import require_ieee_float32
from .compaction import (
    compacting_runner,
    fit_klnmf_restarts_compacting,
    klnmf_block_builder,
    klnmf_mesh_run,
    lockstep_fit,
    mvnmf_compacting_runner,
    plain_block_builder,
    resolve_compact,
)
from .mesh import check_divides, mesh_meta, open_store


class RestartResult(NamedTuple):
    """Outcome of a batched multi-start fit.

    W and H stay on the device (host arrays when loaded from a
    checkpoint); losses/n_iterations are host arrays."""

    W: Any            # (R, V, K) signatures per restart
    H: Any            # (R, K, D) exposures per restart
    losses: Any       # (R,) final objective per restart
    n_iterations: Any # (R,) iterations run per restart
    best_index: int

    @property
    def best_loss(self) -> float:
        return float(self.losses[self.best_index])

    def _best_lane(self, leaf) -> np.ndarray:
        lane = leaf[self.best_index]
        if isinstance(lane, torch.Tensor):
            return lane.cpu().numpy()
        return np.asarray(lane)

    @property
    def best_W(self) -> np.ndarray:
        return self._best_lane(self.W)

    @property
    def best_H(self) -> np.ndarray:
        return self._best_lane(self.H)


def _to_device(array, dtype, device) -> torch.Tensor:
    if isinstance(array, torch.Tensor):
        return array.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(array), dtype=dtype,
                           device=device)


def _restart_inputs(X, n_signatures, n_restarts, seed, weights_kl,
                    weights_lhalf, dtype, device):
    """The batched random init and the data dict of a multi-start KLNMF
    fit. device=None means the current CUDA device (resolve_device raises
    without one); the draws come from a torch.Generator seeded with `seed`
    on that device."""
    device = resolve_device(device)
    if device.type == "cuda":
        require_ieee_float32()
    X = _to_device(X, dtype, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    W0, H0 = random_init_batch(generator, X, n_signatures, n_restarts, dtype)
    data = {"X": X}
    if weights_kl is not None:
        data["weights_kl"] = _to_device(weights_kl, dtype, device)
    if weights_lhalf is not None:
        data["weights_lhalf"] = _to_device(weights_lhalf, dtype, device)
    return {"W": W0, "H": H0}, data


def _fit_with(objective_fn, config: FitConfig, make_block_update):
    """(params0, data) -> (FitResult, losses) of the monolithic lockstep
    fit (compaction.lockstep_fit)."""
    def run(params0, data):
        return lockstep_fit(objective_fn, config, make_block_update, params0,
                            data)

    return run


def _klnmf_runner(config: FitConfig, mesh, masked: bool):
    """(params0, data) -> (params, losses, n_iterations) of the monolithic
    lockstep KLNMF fit (rank-masked or not) on `mesh`
    (compaction.klnmf_mesh_run)."""
    make_steps = (ops.make_masked_step_functions if masked
                  else ops.make_step_functions)

    def make_run(reduce_samples):
        update_fn, objective_fn = make_steps(reduce_samples=reduce_samples)
        builder = (plain_block_builder(update_fn) if masked else
                   klnmf_block_builder(update_fn, reduce_samples is not None))
        return _fit_with(objective_fn, config, builder)

    def run(params0, data):
        result, losses = klnmf_mesh_run(
            make_run, mesh, params0["W"].shape[0], data["X"].shape[-1])(
            params0, data)
        return result.params, losses, result.n_iterations

    return run


def build_klnmf_restart_runner(config: FitConfig, mesh=None):
    """The batched multi-start KLNMF fit.

    Returns a function (params0, data) -> (params, losses, n_iterations)
    where params0 = {"W": (R, V, K), "H": (R, K, D)} and data = {"X": (V, D)}
    plus any 'weights_kl'/'weights_lhalf' entries. The block update is
    chosen per call from the tensors (cuda_klnmf.mu_block_supported).
    Under a `mesh` every rank passes the whole params0 and data and gets
    the whole result back; it fits its own block of them.
    """
    return _klnmf_runner(config, mesh, masked=False)


def fit_klnmf_restarts(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    mesh=None,
    dtype=torch.float32,
    device=None,
    runner=None,
    compact: bool | None = None,
    compact_min_bucket: int = 8,
) -> RestartResult:
    """Fit `n_restarts` random-initialized KLNMF models at once.

    X is (n_features, n_samples) in kernel orientation. device=None means
    the current CUDA device (resolve_device raises without one). The initial
    draws come from a torch.Generator seeded with `seed` on that device.
    Pass a prebuilt `runner` (build_klnmf_restart_runner) to reuse one
    across calls.

    compact (None = auto, parallel.compaction.resolve_compact): run the
    fit through the lane-compacting driver - as restarts converge,
    survivors are gathered into smaller batches so frozen lanes stop
    costing block updates. Per-lane results are those of the uncompacted
    loop.

    mesh: a (restarts, samples) DeviceMesh (parallel.make_mesh) that every
    rank passes: each rank fits its block of the lanes and samples, and
    every rank gets the whole result (module docstring). The mesh's ways
    must divide n_restarts and the samples. A `runner` must then be built
    on the same mesh.
    """
    config = config or FitConfig()
    if runner is None and resolve_compact(
        compact, config, mesh, n_restarts, compact_min_bucket,
        resolve_device(device),
    ):
        return fit_klnmf_restarts_compacting(
            X, n_signatures, n_restarts, seed=seed, config=config,
            weights_kl=weights_kl, weights_lhalf=weights_lhalf, dtype=dtype,
            min_bucket=compact_min_bucket, device=device, mesh=mesh,
        )
    params0, data = _restart_inputs(X, n_signatures, n_restarts, seed,
                                    weights_kl, weights_lhalf, dtype, device)
    if runner is None:
        runner = build_klnmf_restart_runner(config, mesh)
    params, losses, n_iterations = runner(params0, data)
    losses_host = losses.cpu().numpy()
    return RestartResult(
        W=params["W"],
        H=params["H"],
        losses=losses_host,
        n_iterations=n_iterations.cpu().numpy(),
        best_index=int(np.argmin(losses_host)),
    )


def _rank_scan_with_checkpoint(checkpoint_dir, task: str, X, ranks,
                               n_restarts: int, seed: int,
                               config: FitConfig, meta_extra: dict,
                               run_point, mesh=None):
    """Per-rank resumable wrapper shared by the scan drivers.

    Each completed rank is one atomic ChunkStore entry (host arrays); a
    rerun with the identical arguments loads finished ranks and computes
    only the missing ones. run_point(offset, k) -> RestartResult computes
    one rank through the normal driver with its ORIGINAL seed
    (seed + 1000 * offset), so a resumed scan equals an uninterrupted one.
    The mesh is part of the run's identity; under one, the mesh's first
    rank writes the store and every rank loads it (mesh.MeshStore).
    """
    from ..checkpoint import data_fingerprint

    X_host = X.cpu().numpy() if isinstance(X, torch.Tensor) else X
    store = open_store(checkpoint_dir, {
        "task": task,
        "ranks": [int(k) for k in ranks],
        "n_restarts": int(n_restarts),
        "seed": int(seed),
        "config": list(config),
        "data": data_fingerprint(np.asarray(X_host)),
        **meta_extra,
        "mesh": mesh_meta(mesh),
    }, mesh)
    results: dict[int, RestartResult] = {}
    for offset, k in enumerate(ranks):
        entry = store.load(f"rank{k}")
        if entry is not None:
            results[int(k)] = RestartResult(
                W=entry["W"], H=entry["H"], losses=entry["losses"],
                n_iterations=entry["n_iterations"],
                best_index=int(entry["best_index"]),
            )
            continue
        sub = run_point(offset, int(k))
        host = RestartResult(
            W=sub.W.cpu().numpy(), H=sub.H.cpu().numpy(),
            losses=np.asarray(sub.losses),
            n_iterations=np.asarray(sub.n_iterations),
            best_index=int(sub.best_index),
        )
        store.save(
            f"rank{k}", W=host.W, H=host.H, losses=host.losses,
            n_iterations=host.n_iterations,
            best_index=np.asarray(host.best_index),
        )
        results[int(k)] = host
    return results


def rank_scan(
    model_factory,
    data_container,
    n_signatures_range,
    n_restarts: int,
    base_seed: int = 0,
    **fit_best_of_kwargs,
):
    """Model-selection scan for any ported model family.

    model_factory(k) must return an unfitted model with k signatures (e.g.
    `lambda k: MvNMF(n_signatures=k, init_method="random")`). Each rank runs
    `n_restarts` batched restarts via fit_best_of with base seed
    base_seed + 1000 * offset; returns {k: (model, MultiStartSummary)} with
    each model holding its best restart.

    A `checkpoint_dir` in fit_best_of_kwargs is split into one
    subdirectory per rank (each rank's run identity differs, so sharing
    one ChunkStore would discard the previous rank's entries on every
    point).
    """
    from .multistart import fit_best_of

    checkpoint_root = fit_best_of_kwargs.pop("checkpoint_dir", None)
    results = {}
    for offset, k in enumerate(n_signatures_range):
        model = model_factory(int(k))
        container = (
            data_container.copy()
            if hasattr(data_container, "copy")
            else data_container
        )
        kwargs = dict(fit_best_of_kwargs)
        if checkpoint_root is not None:
            kwargs["checkpoint_dir"] = Path(checkpoint_root) / f"rank{k}"
        summary = fit_best_of(
            model, container, n_restarts,
            base_seed=base_seed + 1000 * offset,
            **kwargs,
        )
        results[int(k)] = (model, summary)
    return results


def build_klnmf_masked_runner(config: FitConfig, mesh=None):
    """A rank-MASKED multi-start KLNMF fit: lanes of different rank share
    one K-padded batch. params0 = {"W": (R, V, Kp), "H": (R, Kp, D),
    "mask": (R, Kp) bool}; returns (params, losses, n_iterations) like
    build_klnmf_restart_runner, on a `mesh` as it does. Plain PyTorch ops:
    the CUDA kernel has no rank mask."""
    return _klnmf_runner(config, mesh, masked=True)


def _padded_random_init(generator, X, n_signatures: int, n_restarts: int,
                        padded: int):
    """The draws of the unpadded path (random_init_batch on X's device, from
    the rank's own torch.Generator) padded to rank `padded`: identical
    per-rank inits in both layouts."""
    W0, H0 = random_init_batch(generator, X, n_signatures, n_restarts,
                               X.dtype)
    W0, H0, mask = ops.pad_rank(W0, H0, padded)
    return W0, H0, mask.expand(n_restarts, padded)


def _resolve_pack(pack_points, config: FitConfig, device) -> bool:
    """Decide whether several scan points may share one lockstep call.

    On a card the padded updates are plain PyTorch ops whose time is
    launches, not lanes, so packing the points of a bucket into one call
    pays even for convergence runs: measured 2.6-3.5x faster than one
    point per call for rank_scan_klnmf(range(2, 11), 20) and 3.6x for
    rank_scan_mvnmf(range(2, 8), 10) on PCAWG SBS (NVIDIA H100 80GB HBM3,
    700 W; PERF.md). Elsewhere frozen lanes cost their arithmetic, so
    auto packs only FIXED-LENGTH runs (min_iterations ==
    max_iterations), where no lane finishes early - the JAX package's
    rule. Results are identical either way: per-lane freezing makes each
    point's trajectory independent of its call's co-tenants.
    """
    if pack_points is None:
        return (torch.device(device).type == "cuda"
                or config.min_iterations >= config.max_iterations)
    return bool(pack_points)


def _rank_buckets(ranks, rank_bucket: int, pad: bool):
    buckets: dict[int, list[tuple[int, int]]] = {}
    for offset, k in enumerate(ranks):
        padded = ((k + rank_bucket - 1) // rank_bucket) * rank_bucket \
            if pad else k
        buckets.setdefault(padded, []).append((offset, k))
    return buckets


def _rank_groups(members, n_restarts: int, pack: bool, lanes_cap: int):
    if pack and len(members) * n_restarts <= lanes_cap:
        return [members]
    return [[member] for member in members]


def _padded_scan(X, ranks, n_restarts: int, seed: int, rank_bucket: int,
                 pad: bool, pack: bool, lanes_cap: int, run,
                 gamma: bool) -> dict[int, RestartResult]:
    """The rank-masked scan loop shared by rank_scan_klnmf and
    rank_scan_mvnmf: per bucket of padded rank, per group of ranks sharing
    one call, draw each rank's restarts (_padded_random_init), run the
    group's lanes through run(params0, data) -> (FitResult, losses) and
    slice per-rank RestartResults out of them. `gamma` adds MvNMF's
    per-lane line-search gamma, starting at 1."""
    results: dict[int, RestartResult] = {}
    for padded, members in sorted(_rank_buckets(ranks, rank_bucket,
                                                pad).items()):
        for group in _rank_groups(members, n_restarts, pack, lanes_cap):
            parts = [
                _padded_random_init(
                    torch.Generator(device=X.device).manual_seed(
                        seed + 1000 * offset),
                    X, k, n_restarts, padded,
                )
                for offset, k in group
            ]
            params0 = {
                name: torch.cat([part[i] for part in parts])
                for i, name in enumerate(("W", "H", "mask"))
            }
            if gamma:
                params0["gamma"] = torch.ones(len(group) * n_restarts,
                                              dtype=X.dtype, device=X.device)
            result, losses = run(params0, {"X": X})
            losses = losses.cpu().numpy()
            n_iterations = result.n_iterations.cpu().numpy()
            for i, (_, k) in enumerate(group):
                lanes = slice(i * n_restarts, (i + 1) * n_restarts)
                results[k] = RestartResult(
                    W=result.params["W"][lanes][:, :, :k],
                    H=result.params["H"][lanes][:, :k, :],
                    losses=losses[lanes],
                    n_iterations=n_iterations[lanes],
                    best_index=int(np.argmin(losses[lanes])),
                )
    return {k: results[k] for k in ranks}


# Guard on the lanes a packed call may hold: the aux ratio costs ~3 (V, D)
# buffers per lane (4 for MvNMF's line search), under this budget.
_LANE_BUDGET_BYTES = 4 * 1024**3


def _lanes_cap(X, n_restarts: int, buffers: int) -> int:
    per_lane = buffers * X.shape[0] * X.shape[1] * X.element_size()
    return max(n_restarts, int(_LANE_BUDGET_BYTES / per_lane))


def rank_scan_klnmf(
    X,
    n_signatures_range,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
    pad_ranks: bool | None = None,
    rank_bucket: int = 8,
    pack_points: bool | None = None,
    compact: bool | None = None,
    compact_min_bucket: int = 8,
    checkpoint_dir=None,
) -> dict[int, RestartResult]:
    """Multi-start KLNMF over a range of ranks (the model-selection scan).
    Rank k at position `offset` draws its restarts from seed + 1000 *
    offset, on the fit's device, in every layout.

    checkpoint_dir: preemption-safe resume (checkpoint.ChunkStore) - each
    completed rank is one atomic entry, and a rerun with identical
    arguments loads finished ranks and computes only the missing ones.

    pad_ranks=True rounds ranks up to multiples of `rank_bucket` and runs
    the ranks of a bucket as lanes of one K-padded batch with per-lane
    rank masks (plain PyTorch ops: the CUDA kernel has no rank mask).
    pad_ranks=False runs one unpadded multi-start per rank, through the
    kernel where cuda_klnmf.mu_block_supported holds. None (default) is
    False: on PCAWG SBS, range(2, 11) x 20 restarts, the unpadded scan
    took 3.6-3.8 s against 3.9-4.7 s padded and packed and 10.4-14.8 s
    padded one point per call (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
    Per-rank results are identical either way (same seeds, masked lanes
    advance and converge independently).

    pack_points: whether several ranks of a bucket share one lockstep call
    (None = auto, see _resolve_pack). compact (None = auto, see
    parallel.compaction.resolve_compact) runs each call through the
    lane-compacting driver. Under a `mesh` (every rank calls) each call's
    lanes and samples are sharded as in fit_klnmf_restarts; the mesh's
    ways must divide n_restarts and the samples.
    """
    config = config or FitConfig()
    device = resolve_device(device)
    ranks = [int(k) for k in n_signatures_range]
    if mesh is not None:
        check_divides(mesh, n_restarts, np.shape(X)[-1])
    if checkpoint_dir is not None:
        return _rank_scan_with_checkpoint(
            checkpoint_dir, "rank_scan_klnmf", X, ranks, n_restarts, seed,
            config,
            {
                "dtype": str(dtype).removeprefix("torch."),
                "pad_ranks": pad_ranks,
                "rank_bucket": int(rank_bucket),
            },
            lambda offset, k: rank_scan_klnmf(
                X, [k], n_restarts, seed=seed + 1000 * offset,
                config=config, mesh=mesh, dtype=dtype, device=device,
                pad_ranks=pad_ranks, rank_bucket=rank_bucket,
                pack_points=pack_points, compact=compact,
                compact_min_bucket=compact_min_bucket,
            )[k],
            mesh,
        )
    compact = resolve_compact(compact, config, mesh, n_restarts,
                              compact_min_bucket, device)
    if pad_ranks is None:
        pad_ranks = False
    X = _to_device(X, dtype, device)
    if device.type == "cuda":
        require_ieee_float32()

    if not pad_ranks:
        results = {}
        for offset, k in enumerate(ranks):
            # compact is resolved above: pass the decision through
            results[k] = fit_klnmf_restarts(
                X, k, n_restarts, seed=seed + 1000 * offset, config=config,
                mesh=mesh, dtype=dtype, device=device, compact=compact,
                compact_min_bucket=compact_min_bucket,
            )
        return results

    def make_run(reduce_samples):
        if compact:
            return compacting_runner(config, True, compact_min_bucket,
                                     reduce_samples).run
        update_fn, objective_fn = ops.make_masked_step_functions(
            reduce_samples=reduce_samples)
        return _fit_with(objective_fn, config, plain_block_builder(update_fn))

    def run(params0, data):
        return klnmf_mesh_run(make_run, mesh, params0["W"].shape[0],
                              data["X"].shape[-1])(params0, data)

    return _padded_scan(X, ranks, n_restarts, seed, rank_bucket, True,
                        _resolve_pack(pack_points, config, device),
                        _lanes_cap(X, n_restarts, 3), run, gamma=False)


def rank_scan_mvnmf(
    X,
    n_signatures_range,
    n_restarts: int,
    seed: int = 0,
    lam: float = 1.0,
    delta: float = 1.0,
    config: FitConfig | None = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
    pad_ranks: bool = True,
    rank_bucket: int = 4,
    pack_points: bool | None = None,
    compact: bool | None = None,
    compact_min_bucket: int = 8,
    checkpoint_dir=None,
) -> dict[int, RestartResult]:
    """Multi-start minimum-volume NMF over a range of ranks.

    The MvNMF twin of rank_scan_klnmf: with pad_ranks=True (default), ranks
    round up to multiples of `rank_bucket` and every rank of a bucket runs
    as lanes of one K-padded batch (per-lane rank masks; padded H rows
    exact zeros, the volume term and the (Kp, Kp) Gram inverse see
    identity padding - ops/mvnmf.py make_masked_step_functions). The
    line-search gamma persists per lane, exactly as the model's _gamma.
    pad_ranks=False runs the same masked step one rank per call (all-true
    masks). Seeding, pack_points, compact and checkpoint_dir as in
    rank_scan_klnmf. Losses MINIMIZE (KL + lam * volume). Under a `mesh`
    (every rank calls) each call's lanes and samples are sharded as in
    rank_scan_klnmf (the JAX package's restart_sharding): the mesh's ways
    must divide n_restarts and the samples.
    """
    config = config or FitConfig()
    device = resolve_device(device)
    ranks = [int(k) for k in n_signatures_range]
    if mesh is not None:
        check_divides(mesh, n_restarts, np.shape(X)[-1])
    if checkpoint_dir is not None:
        return _rank_scan_with_checkpoint(
            checkpoint_dir, "rank_scan_mvnmf", X, ranks, n_restarts, seed,
            config,
            {
                "lam": float(lam),
                "delta": float(delta),
                "dtype": str(dtype).removeprefix("torch."),
                "pad_ranks": bool(pad_ranks),
                "rank_bucket": int(rank_bucket),
            },
            lambda offset, k: rank_scan_mvnmf(
                X, [k], n_restarts, seed=seed + 1000 * offset, lam=lam,
                delta=delta, config=config, mesh=mesh, dtype=dtype,
                device=device, pad_ranks=pad_ranks, rank_bucket=rank_bucket,
                pack_points=pack_points, compact=compact,
                compact_min_bucket=compact_min_bucket,
            )[k],
            mesh,
        )
    compact = resolve_compact(compact, config, mesh, n_restarts,
                              compact_min_bucket, device)
    X = _to_device(X, dtype, device)
    if device.type == "cuda":
        require_ieee_float32()
    def make_run(reduce_samples):
        if compact:
            return mvnmf_compacting_runner(config, float(lam), float(delta),
                                           compact_min_bucket,
                                           reduce_samples).run
        update_fn, objective_fn = mv_ops.make_masked_step_functions(
            float(lam), float(delta), reduce_samples=reduce_samples)
        return _fit_with(objective_fn, config, plain_block_builder(update_fn))

    def run(params0, data):
        return klnmf_mesh_run(make_run, mesh, params0["W"].shape[0],
                              data["X"].shape[-1])(params0, data)

    return _padded_scan(X, ranks, n_restarts, seed, rank_bucket, pad_ranks,
                        _resolve_pack(pack_points, config, device),
                        _lanes_cap(X, n_restarts, 4), run, gamma=True)
