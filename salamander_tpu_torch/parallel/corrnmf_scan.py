"""Padded CorrNMF model-selection scans over (rank, embedding dimension),
held against salamander_tpu/parallel/corrnmf_scan.py.

The model-selection axes of CorrNMF are n_signatures AND dim_embeddings
(the reference defaults dim_embeddings to n_signatures because users tune
it). With pad_ranks=True every (k, m) point is padded to a shared (Kp, mp)
bucket and the points of a bucket run as lanes of one lockstep batch,
through the rank- and dim-masked CorrNMF step
(ops/corrnmf.py make_masked_corrnmf_step):

  - K-padding: padded signatures' scalings sit at NEG_PAD_SCALING, which
    makes their exposures, aux rows and rates exact zeros;
  - m-padding: zero-initialized embedding dimensions have identically zero
    gradient and a block-diagonal Hessian row, so they stay exactly zero.

pad_ranks=False runs every point in its own call through the same masked
step (all-true masks). Per-lane results do not depend on the layout beyond
float sums of other widths.

Each scan point comes back as a CorrScanResult carrying a FITTED model
(the winning restart absorbed into the model class) plus the per-restart
loss table and objective traces.

Under a (restarts, samples) mesh (parallel/mesh.py; every rank calls) each
call's lanes split over the restart axis with the counts replicated, as
the JAX package shards them, and are gathered: the ranks of a sample row
run the same lanes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..engine import FitConfig
from ..ops import corrnmf as corr_ops
from .compaction import (
    corrnmf_compacting_runner,
    on_mesh,
    plain_block_builder,
    resolve_compact,
)
from .mesh import mesh_meta, open_store
from .restarts import _fit_with, _resolve_pack

# the batched aux/ratio intermediates cost ~3 (D, V) + 2 (D, Kp) buffers
# per lane; a packed call holds at most this many bytes of them
_LANE_BUDGET_BYTES = 4 * 1024**3

_PARAM_KEYS = (
    "signatures", "signature_scalings", "sample_scalings",
    "signature_embeddings", "sample_embeddings", "variance", "exposures",
)


class CorrScanResult(NamedTuple):
    """Per-point outcome of a (padded) multi-start CorrNMF scan (host
    arrays)."""

    losses: Any        # (n_restarts,) final ELBO per restart (maximize)
    n_iterations: Any  # (n_restarts,)
    best_index: int
    best_params: dict  # numpy params of the winning restart, padding stripped
    model: Any = None  # fitted model holding the winning restart
    history: Any = None   # (n_restarts, max_evals) objective traces
    n_evals: Any = None   # (n_restarts,)
    signatures: Any = None  # (n_restarts, n_features, k), padding stripped

    @property
    def best_loss(self) -> float:
        return float(self.losses[self.best_index])


def _roundup(value: int, bucket: int) -> int:
    return ((value + bucket - 1) // bucket) * bucket


def _fitted_model(model_factory, X, k, m, seed, best_params, history,
                  n_iterations, config):
    """The winner of a point as a fitted model: the factory's model
    initialized with the winner's seed (names, containers), then the
    winner's parameters and trace absorbed."""
    from ..containers import AnnData

    model = model_factory(k, m)
    model._setup_adata(AnnData(X.copy()))
    np.random.seed(seed)
    model._initialize(init_kwargs={"seed": seed})
    model._setup_fitting_parameters()
    model._absorb_params(best_params)
    model._is_fitted = True
    model.history["objective_function"] = list(history)
    model.history["n_iterations"] = int(n_iterations)
    model.history["step_freq"] = config.conv_test_freq
    return model


def _checkpointed_corrnmf_scan(checkpoint_dir, X, points, grid_mode,
                               n_restarts, base_seed, config, pad_ranks,
                               rank_bucket, dim_bucket, init_method, dtype,
                               model_factory, build_models, scan_kwargs,
                               mesh=None):
    """Per-point resumable twin of rank_scan_corrnmf: every completed
    (k[, m]) point is one atomic ChunkStore entry (host arrays and the
    stripped winner); missing points run through rank_scan_corrnmf as
    singleton scans with their ORIGINAL offset-keyed seeds, and loaded
    points rebuild their fitted model as the scan does. The identity
    includes the compute dtype (the JAX package's leaves it out, so a
    float32 rerun would load a float64 store). Under a mesh the mesh's
    first rank writes it."""
    from ..checkpoint import data_fingerprint

    identity = {
        "task": "rank_scan_corrnmf",
        "points": [[int(k), int(m)] for k, m in points],
        "n_restarts": int(n_restarts),
        "base_seed": int(base_seed),
        "config": list(config),
        "pad_ranks": bool(pad_ranks),
        "rank_bucket": int(rank_bucket),
        "dim_bucket": int(dim_bucket),
        "grid_mode": bool(grid_mode),
        "init_method": str(init_method),
        "dtype": dtype,
        "data": data_fingerprint(np.asarray(X)),
    }
    if mesh is not None:
        identity["mesh"] = mesh_meta(mesh)
    store = open_store(checkpoint_dir, identity, mesh)
    rng_state = np.random.get_state()
    results: dict = {}
    try:
        for offset, (k, m) in enumerate(points):
            result_key = (k, m) if grid_mode else k
            name = f"point_k{k}_m{m}"
            entry = store.load(name)
            if entry is None:
                sub = rank_scan_corrnmf(
                    X, [k],
                    dim_embeddings=None if grid_mode else m,
                    n_restarts=n_restarts,
                    base_seed=base_seed + 1000 * offset,
                    config=config, pad_ranks=pad_ranks,
                    rank_bucket=rank_bucket, init_method=init_method,
                    dim_embeddings_range=[m] if grid_mode else None,
                    dim_bucket=dim_bucket, model_factory=model_factory,
                    build_models=build_models, mesh=mesh, **scan_kwargs,
                )[result_key]
                payload = {
                    "losses": sub.losses,
                    "n_iterations": sub.n_iterations,
                    "best_index": np.asarray(sub.best_index),
                    "history": sub.history,
                    "n_evals": sub.n_evals,
                    "signatures": sub.signatures,
                }
                for pkey, value in sub.best_params.items():
                    payload[f"bp_{pkey}"] = value
                store.save(name, **payload)
                results[result_key] = sub
                continue
            best = int(entry["best_index"])
            best_params = {
                pkey[3:]: entry[pkey]
                for pkey in entry if pkey.startswith("bp_")
            }
            model = None
            if build_models:
                model = _fitted_model(
                    model_factory, X, k, m, base_seed + 1000 * offset + best,
                    best_params,
                    entry["history"][best][:int(entry["n_evals"][best])],
                    entry["n_iterations"][best], config,
                )
            results[result_key] = CorrScanResult(
                losses=entry["losses"],
                n_iterations=entry["n_iterations"],
                best_index=best,
                best_params=best_params,
                model=model,
                history=entry["history"],
                n_evals=entry["n_evals"],
                signatures=entry["signatures"],
            )
    finally:
        np.random.set_state(rng_state)
    return results


def rank_scan_corrnmf(
    X,
    n_signatures_range,
    dim_embeddings: int | None = None,
    n_restarts: int = 1,
    base_seed: int = 0,
    config: FitConfig | None = None,
    pad_ranks: bool = True,
    rank_bucket: int = 4,
    init_method: str = "nndsvd",
    dim_embeddings_range=None,
    dim_bucket: int = 2,
    mesh=None,
    model_factory=None,
    build_models: bool = True,
    pack_points: bool | None = None,
    compact: bool | None = None,
    compact_min_bucket: int = 4,
    checkpoint_dir=None,
    dtype: str | None = None,
    device=None,
):
    """Multi-start CorrNMF model-selection scan over n_signatures (and
    optionally dim_embeddings).

    X: (n_samples, n_features) counts (model orientation, samples as rows).

    Every k in `n_signatures_range` is fitted at `dim_embeddings` (returns
    {k: CorrScanResult}); passing `dim_embeddings_range` instead scans the
    full (k, m) grid and returns {(k, m): CorrScanResult}. With
    pad_ranks=True, ranks round up to multiples of `rank_bucket` (and grid
    dims to multiples of `dim_bucket`) and the points of a (Kp, mp) bucket
    share lockstep calls with per-lane masks; pad_ranks=False runs one call
    per point. Restart r of grid offset o is seeded base_seed + 1000*o + r
    (offsets enumerate the k range, then the grid in m-major order); each
    lane is drawn by the model's own host initializer, so padded and
    unpadded lanes start equal.

    model_factory(k, m) may override the fitted class and hyperparameters
    (default: CorrNMFDet(n_signatures=k, dim_embeddings=m,
    init_method=init_method, dtype=dtype, device=device)); its model's
    device and dtype are the scan's. With build_models=True each result
    carries a fitted model; False leaves result.model as None.

    pack_points (None = auto, parallel.restarts._resolve_pack): several
    points of a bucket share one lockstep call. compact (None = auto,
    parallel.compaction.resolve_compact): lane compaction per call; a
    dropped lane stops paying for its Newton steps. Per-lane results are
    the same either way.

    checkpoint_dir: per-point preemption-safe resume (checkpoint.ChunkStore)
    - each completed (k[, m]) point is one atomic entry. The store cannot
    fingerprint a custom `model_factory`; keep one directory per factory.

    mesh: a (restarts, samples) DeviceMesh (parallel.make_mesh) that every
    rank passes: each call's lanes split over its restart ways, which must
    divide them (module docstring).
    """
    from ..containers import AnnData
    from ..models import CorrNMFDet
    from ..models.signature_nmf import promote_objective
    from ..ops.precision import require_ieee_float32

    config = config or FitConfig()
    ranks = [int(k) for k in n_signatures_range]
    grid_mode = dim_embeddings_range is not None
    if grid_mode:
        dims = [int(m) for m in dim_embeddings_range]
    else:
        if dim_embeddings is None:
            raise ValueError(
                "Pass dim_embeddings (fixed-m scan) or "
                "dim_embeddings_range (grid scan)."
            )
        dims = [int(dim_embeddings)]
    if model_factory is None:
        def model_factory(k, m):
            return CorrNMFDet(
                n_signatures=k, dim_embeddings=m, init_method=init_method,
                dtype=dtype, device=device,
            )
    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    X = np.asarray(X, dtype=float)

    # grid points in (m-major, k-minor) order; offset drives seeding
    points = [(k, m) for m in dims for k in ranks]
    probe = model_factory(*points[0])
    scan_device = probe.device

    if checkpoint_dir is not None:
        return _checkpointed_corrnmf_scan(
            checkpoint_dir, X, points, grid_mode, n_restarts, base_seed,
            config, pad_ranks, rank_bucket, dim_bucket, init_method,
            probe.dtype, model_factory, build_models,
            dict(pack_points=pack_points, compact=compact,
                 compact_min_bucket=compact_min_bucket),
            mesh,
        )
    if scan_device.type == "cuda":
        require_ieee_float32()

    # one container for the whole scan (every lane shares the counts;
    # _setup_adata's EPSILON clip is idempotent)
    adata = AnnData(X.copy())
    buckets: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
    for offset, (k, m) in enumerate(points):
        padded_k = _roundup(k, rank_bucket) if pad_ranks else k
        padded_m = (
            _roundup(m, dim_bucket) if (pad_ranks and grid_mode) else m
        )
        buckets.setdefault((padded_k, padded_m), []).append((offset, k, m))

    if resolve_compact(compact, config, mesh, n_restarts,
                       compact_min_bucket, scan_device):
        run = corrnmf_compacting_runner(config, compact_min_bucket).run
    else:
        update_fn, objective_fn = corr_ops.make_masked_corrnmf_step()
        run = _fit_with(
            promote_objective(
                objective_fn, {"probe": torch.zeros((), dtype=torch.float32)}),
            config, plain_block_builder(update_fn))
    run = on_mesh(run, mesh)

    def run_group(padded_k, padded_m, group):
        """One lockstep call for `group` (list of (offset, k, m))."""
        lanes = []
        data = None
        for offset, k, m in group:
            for restart in range(n_restarts):
                seed = base_seed + 1000 * offset + restart
                model = model_factory(k, m)
                model._setup_adata(adata)
                np.random.seed(seed)
                model._initialize(init_kwargs={"seed": seed})
                model._setup_fitting_parameters()
                params, data = model._device_state()
                lanes.append(corr_ops.pad_rank_corrnmf(params, padded_k,
                                                       padded_m))
        params0 = {key: torch.stack([lane[key] for lane in lanes])
                   for key in lanes[0]}
        return run(params0, data)

    results: dict = {}

    def absorb(result, final_losses, group):
        losses_all = final_losses.cpu().numpy()
        n_iterations = result.n_iterations.cpu().numpy()
        history = result.history.cpu().numpy()
        n_evals = result.n_evals.cpu().numpy()
        for i, (offset, k, m) in enumerate(group):
            lanes = slice(i * n_restarts, (i + 1) * n_restarts)
            losses = losses_all[lanes]
            best = int(np.argmax(losses))  # ELBO: maximize
            lane = lanes.start + best
            best_params = {}
            for key in _PARAM_KEYS:
                value = result.params[key][lane].cpu().numpy()
                if key in ("signatures", "signature_scalings"):
                    value = value[:k]
                elif key == "signature_embeddings":
                    value = value[:k, :m]
                elif key == "sample_embeddings":
                    value = value[:, :m]
                elif key == "exposures":
                    value = value[:, :k]
                best_params[key] = value
            model = None
            if build_models:
                model = _fitted_model(
                    model_factory, X, k, m, base_seed + 1000 * offset + best,
                    best_params, history[lane][:int(n_evals[lane])],
                    n_iterations[lane], config,
                )
            results[(k, m) if grid_mode else k] = CorrScanResult(
                losses=losses,
                n_iterations=n_iterations[lanes],
                best_index=best,
                best_params=best_params,
                model=model,
                history=history[lanes],
                n_evals=n_evals[lanes],
                signatures=result.params["signatures"][lanes][:, :k, :]
                .mT.cpu().numpy(),
            )

    pack = _resolve_pack(pack_points, config, scan_device)
    n_samples, n_features = X.shape
    rng_state = np.random.get_state()
    try:
        for (padded_k, padded_m), group in sorted(buckets.items()):
            per_lane = (
                3 * n_samples * n_features + 2 * n_samples * padded_k
            ) * 8
            lanes_cap = max(n_restarts, _LANE_BUDGET_BYTES // per_lane)
            if pack and len(group) * n_restarts <= lanes_cap:
                chunks = [group]
            else:
                chunks = [[entry] for entry in group]
            for chunk in chunks:
                absorb(*run_group(padded_k, padded_m, chunk), chunk)
    finally:
        np.random.set_state(rng_state)
    return results
