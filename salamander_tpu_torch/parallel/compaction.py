"""Lane compaction for convergence-based multi-start fits, held against
salamander_tpu/parallel/compaction.py.

A lockstep multi-start fit runs every restart until the SLOWEST one
converges, and frozen (converged) lanes still cost a full block update
every block. Compaction runs the loop as SEGMENTS
(engine.fit.run_lockstep_segment) that exit as soon as at most half the
lanes are still unconverged; the survivors are gathered (``nonzero`` +
``index_select``, so a kernel gets contiguous lanes) into a smaller batch
and resumed there. Finished lanes, their in-place history rows included,
are scattered back into full-size buffers by lane id. A lane's updates
never depend on its co-tenants, so per-lane results are those of the
uncompacted loop. One host sync per halving decides the gather. With
``batched_data=True`` every lane fits its own data (a bootstrap resample):
each data leaf carries the leading lane axis and is gathered with the
survivors' state.

Under a mesh (parallel/mesh.py) each rank compacts its own lanes
(``on_mesh``): ranks of one sample-axis row hold the same lanes, read the
same all-reduced objectives, and so take the same decisions.

Not ported: the JAX package's guards against its accelerator's program
kill (``CappedFitDispatcher``, the time-capped segments and their cost
model), which the card does not need.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..engine import FitConfig, FitResult
from ..engine.fit import (
    LockstepState,
    _effective_tol,
    finish_lockstep,
    fit_loop_lockstep,
    init_lockstep_state,
    run_lockstep_segment,
)
from ..engine.tree import (
    by_leaf_name,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from .mesh import (
    RESTART_AXIS,
    SAMPLE_AXIS,
    axis_size,
    check_divides,
    check_mesh,
    KLNMF_LAYOUT,
    gather_block,
    local_block,
    samples_reducer,
)


def _take_lanes(state: LockstepState, idx) -> LockstepState:
    """Gather a subset of lanes into a smaller valid LockstepState."""
    def take(leaf):
        return leaf.index_select(0, idx)

    return LockstepState(
        params=tree_map(take, state.params),
        of_prev=take(state.of_prev),
        history=take(state.history),
        n_evals=take(state.n_evals),
        eval_idx=state.eval_idx,
        iteration=state.iteration,
        n_iterations=take(state.n_iterations),
        done=take(state.done),
    )


def _scatter_lanes(out: LockstepState, ids,
                   state: LockstepState) -> LockstepState:
    """Write a bucket's lanes into the full-size buffers at rows `ids`
    (in place), carrying the bucket's (more advanced) shared counters."""
    tree_map(lambda full, leaf: full.index_copy_(0, ids, leaf), out.params,
             state.params)
    for name in ("of_prev", "history", "n_evals", "n_iterations", "done"):
        getattr(out, name).index_copy_(0, ids, getattr(state, name))
    return out._replace(eval_idx=state.eval_idx, iteration=state.iteration)


def _full_size_copy(state: LockstepState) -> LockstepState:
    return state._replace(
        params=tree_map(torch.clone, state.params),
        of_prev=state.of_prev.clone(),
        history=state.history.clone(),
        n_evals=state.n_evals.clone(),
        n_iterations=state.n_iterations.clone(),
        done=state.done.clone(),
    )


BlockBuilder = Callable[[dict, dict], Callable[[dict, int], dict]]


class CompactingRunner:
    """Schedule driver for one compacting fit flavor.

    objective_fn(params, data) -> (R,) is the batched-native objective;
    make_block_update(params, data) -> block_update_fn(params, n_steps)
    builds the block advance for the current bucket of lanes (it sees the
    bucket's tensors, so it can route a KLNMF block to the CUDA kernel
    before any launch). `progress`, when set, is called once per segment
    with a summary dict (iteration, lanes alive, objective range).

    batched_data=True: every data leaf carries the leading lane axis (each
    lane fits its own counts), and the survivors' data rows are gathered
    with ``index_select`` alongside their state.
    """

    def __init__(
        self,
        config: FitConfig,
        objective_fn: Callable[[Any, Any], torch.Tensor],
        make_block_update: BlockBuilder,
        min_bucket: int = 8,
        batched_data: bool = False,
    ):
        self.config = config
        self.objective_fn = objective_fn
        self.make_block_update = make_block_update
        self.min_bucket = max(1, int(min_bucket))
        self.batched_data = bool(batched_data)
        self.progress: Callable[[dict], None] | None = None

    def _report(self, state: LockstepState, n_lanes: int) -> None:
        if self.progress is None:
            return
        of_prev = state.of_prev.detach().to("cpu", torch.float64)
        self.progress({
            "iteration": state.iteration,
            "n_alive": int((~state.done).sum()),
            "n_lanes": n_lanes,
            "objective_min": float(of_prev.min()),
            "objective_max": float(of_prev.max()),
        })

    def run(self, params0, data):
        """Fit all lanes to their own convergence, compacting the batch as
        lanes finish. Returns (FitResult, final_loss) with every tensor at
        the full lane count, positionally identical to the uncompacted
        lockstep loop's."""
        config = self.config
        n_restarts = int(tree_leaves(params0)[0].shape[0])
        full_blocks = (int(config.max_iterations)
                       // int(config.conv_test_freq))

        def objective_on(lane_data):
            return lambda params: self.objective_fn(params, lane_data)

        objective = objective_on(data)
        state = init_lockstep_state(objective, params0, config)
        _effective_tol(config, state.of_prev.dtype, params0)  # warn once
        initial_objective = state.of_prev
        out = _full_size_copy(state)
        ids = torch.arange(n_restarts, device=state.done.device)

        bucket = n_restarts
        data_bucket = data  # shrinks with the lanes under batched_data
        while True:
            target = self._next_bucket(bucket)
            floor = 0 if target is None else target
            state = run_lockstep_segment(
                objective_on(data_bucket), config,
                self.make_block_update(state.params, data_bucket),
                state, alive_floor=floor,
            )
            self._report(state, bucket)
            out = _scatter_lanes(out, ids, state)
            if target is None or state.iteration >= full_blocks * int(
                    config.conv_test_freq):
                break
            alive = torch.nonzero(~state.done).squeeze(1)  # one host sync
            if alive.numel() == 0:
                break
            state = _take_lanes(state, alive)
            ids = ids.index_select(0, alive)
            if self.batched_data:
                data_bucket = tree_map(
                    lambda leaf: leaf.index_select(0, alive), data_bucket)
            bucket = int(alive.numel())

        result = finish_lockstep(
            out, config, self.make_block_update(out.params, data),
            initial_objective,
        )
        return result, objective(result.params)

    def _next_bucket(self, bucket: int) -> int | None:
        """The alive-lane count at which the next segment stops to compact
        (half the bucket), or None when that would drop below min_bucket:
        the segment then runs to completion."""
        half = bucket // 2
        if half < self.min_bucket or half >= bucket:
            return None
        return half


def lockstep_fit(objective_fn, config: FitConfig,
                 make_block_update: BlockBuilder, params0, data):
    """The monolithic twin of CompactingRunner.run: one lockstep loop over
    all lanes (finished lanes frozen). Returns (FitResult, final_loss)."""
    def objective(params):
        return objective_fn(params, data)

    result = fit_loop_lockstep(objective, params0, config,
                               make_block_update(params0, data))
    return result, objective(result.params)


def klnmf_block_builder(update_fn,
                        sample_sharded: bool = False) -> BlockBuilder:
    """make_block_update of the KLNMF flavors: the CUDA kernel where
    cuda_klnmf.mu_block_supported holds for the bucket's tensors, else
    `update_fn` steps as plain torch ops (the rank-masked and the
    sample-sharded flavors always)."""
    from ..ops import cuda_klnmf

    def make_block_update(params, data):
        if cuda_klnmf.mu_block_supported(data["X"], params["W"],
                                         params["H"], data,
                                         mask=params.get("mask"),
                                         sample_sharded=sample_sharded):
            return lambda p, n: cuda_klnmf.fused_block_update(p, data, n)
        return plain_block_builder(update_fn)(params, data)

    return make_block_update


def plain_block_builder(update_fn) -> BlockBuilder:
    """make_block_update that steps a batched-native update_fn(params,
    data) n_steps times."""
    def make_block_update(params, data):
        def block(p, n_steps):
            for _ in range(int(n_steps)):
                p = update_fn(p, data)
            return p

        return block

    return make_block_update


def compacting_runner(config: FitConfig, masked: bool, min_bucket: int,
                      reduce_samples=None) -> CompactingRunner:
    """The runner of one KLNMF fit flavor (JAX:
    ``_cached_compacting_runner``; nothing is compiled here, so nothing is
    cached). reduce_samples completes the sums over D of a sample-sharded
    fit (ops.klnmf)."""
    from ..ops import klnmf as ops

    if masked:
        update_fn, objective_fn = ops.make_masked_step_functions(
            reduce_samples=reduce_samples)
    else:
        update_fn, objective_fn = ops.make_step_functions(
            reduce_samples=reduce_samples)
    return CompactingRunner(
        config, objective_fn,
        klnmf_block_builder(update_fn, reduce_samples is not None),
        min_bucket=min_bucket)


def mvnmf_compacting_runner(config: FitConfig, lam: float, delta: float,
                            min_bucket: int,
                            reduce_samples=None) -> CompactingRunner:
    """The runner of rank-masked MvNMF scan calls (params carry the
    per-lane line-search gamma and the rank mask; JAX:
    ``_cached_mvnmf_compacting_runner``). reduce_samples completes the
    sums over D of a sample-sharded scan (ops.mvnmf)."""
    from ..ops import mvnmf as mv_ops

    update_fn, objective_fn = mv_ops.make_masked_step_functions(
        lam, delta, reduce_samples=reduce_samples)
    return CompactingRunner(config, objective_fn,
                            plain_block_builder(update_fn),
                            min_bucket=min_bucket)


def corrnmf_compacting_runner(config: FitConfig,
                              min_bucket: int) -> CompactingRunner:
    """The runner of (rank- and dim-)masked CorrNMF scan calls (JAX:
    ``_cached_corrnmf_compacting_runner``): the per-lane step is the masked
    EM cycle (ops.corrnmf.make_masked_corrnmf_step), its objective promoted
    to float64 as in the monolithic scan, so convergence decisions match.
    A dropped lane also stops paying for its Newton steps."""
    from ..models.signature_nmf import promote_objective
    from ..ops import corrnmf as corr_ops

    update_fn, objective_fn = corr_ops.make_masked_corrnmf_step()
    objective = promote_objective(
        objective_fn, {"probe": torch.zeros((), dtype=torch.float32)}
    )
    return CompactingRunner(config, objective,
                            plain_block_builder(update_fn),
                            min_bucket=min_bucket)


def extraction_compacting_runner(config: FitConfig, promote: bool,
                                 min_bucket: int, family: str = "klnmf",
                                 lam: float = 1.0, delta: float = 1.0,
                                 n_given: int = 0,
                                 masked: bool = True,
                                 reduce_samples=None) -> CompactingRunner:
    """The runner of de novo extraction's discovery fit (JAX:
    ``_cached_extraction_compacting_runner``): KLNMF (or MvNMF) lanes where
    every lane fits its OWN bootstrap resample (batched_data=True).

    masked=True is the rank-masked flavor (the K-padded layout, with
    ``n_given`` frozen leading signatures); masked=False steps unpadded
    KLNMF lanes of one rank, whose blocks take the CUDA kernel with a
    per-lane X where cuda_klnmf.mu_block_supported holds. `promote`
    evaluates the convergence objective in float64
    (models.signature_nmf.promote_objective), as the lockstep loop does.
    lam/delta parameterize the MvNMF family only. reduce_samples completes
    the sums over D of sample-sharded lanes (plain updates then)."""
    if family == "mvnmf":
        from ..ops import mvnmf as mv_ops

        update_fn, objective_fn = mv_ops.make_masked_step_functions(
            lam, delta, n_given_signatures=n_given,
            reduce_samples=reduce_samples)
        make_block_update = plain_block_builder(update_fn)
    else:
        from ..ops import klnmf as ops

        if masked:
            update_fn, objective_fn = ops.make_masked_step_functions(
                n_given_signatures=n_given, reduce_samples=reduce_samples)
        else:
            update_fn, objective_fn = ops.make_step_functions(
                reduce_samples=reduce_samples)
        make_block_update = klnmf_block_builder(
            update_fn, reduce_samples is not None)
    if promote:
        from ..models.signature_nmf import promote_objective

        objective_fn = promote_objective(
            objective_fn, {"probe": torch.zeros((), dtype=torch.float32)})
    return CompactingRunner(config, objective_fn, make_block_update,
                            min_bucket=min_bucket, batched_data=True)


def mesh_restart_ways(mesh) -> int:
    """Ranks along the mesh's restart axis (1 without a mesh or without a
    'restarts' axis)."""
    return axis_size(mesh, RESTART_AXIS)


def resolve_compact(compact, config: FitConfig, mesh, n_restarts: int,
                    min_bucket: int, device=None) -> bool:
    """Auto policy for lane compaction (compact=None).

    Compaction is legal where a convergence rule can free lanes
    (min_iterations < max_iterations) and at least one halving exists
    (n_restarts >= 2 * the floor, where the floor is min_bucket or, under
    a mesh, the restart ways if more: the JAX package's rule). Auto takes
    it on a CUDA device, where it was measured (PCAWG SBS, NVIDIA H100
    80GB HBM3, 700 W; PERF.md): 2.2-2.8x faster for fit_best_of(MvNMF(5),
    R=50), 1.5x for a packed MvNMF rank scan, and within the spread of the
    monolithic wall on the KLNMF kernel path (0.47-0.86 s against
    0.52-0.66 s at R=100). On the CPU it stays opt-in. Per-lane results
    are identical either way; under a mesh each rank compacts its own
    lanes."""
    if mesh is not None:
        check_mesh(mesh)
    if compact is not None:
        return bool(compact)
    floor = max(1, int(min_bucket), mesh_restart_ways(mesh))
    return (
        config.min_iterations < config.max_iterations
        and n_restarts >= 2 * floor
        and device is not None and torch.device(device).type == "cuda"
    )


def lane_shards(sample_axes) -> tuple[dict, dict]:
    """on_mesh's `by_leaf` for lanes of a model whose unbatched state
    splits its samples as `sample_axes` says (a model's _sample_axes():
    leaf name -> axis, params and data): parameter leaves gain the leading
    lane axis, the data is shared by the lanes."""
    param_axes, data_axes = sample_axes
    return ({name: (0, axis + 1) for name, axis in param_axes.items()},
            {name: (None, axis) for name, axis in data_axes.items()})


# where the KLNMF fit's leaves split on a mesh, by leaf name: (params,
# data), each a KLNMF_LAYOUT entry (the per-sample weights split like X's
# columns). Leaves not named are lanes-first (params: W, a rank mask) or
# replicated (data).
KLNMF_SHARDS = (
    {"H": KLNMF_LAYOUT["H"]},
    {"X": KLNMF_LAYOUT["X"], "weights_kl": (None, 0),
     "weights_lhalf": (None, 0)},
)


def on_mesh(run, mesh, by_leaf: tuple[dict, dict] | None = None):
    """run(params0, data) -> (FitResult, losses) over this rank's block of
    the lanes (axis 0 of every parameter leaf) and, with `by_leaf`
    (KLNMF_SHARDS, lane_shards), of the samples. The run is given the
    rank's blocks; every field of its result is gathered back, so every
    rank returns the whole (FitResult, losses) of the meshless run. Every
    rank of the mesh calls it. Without a mesh it is `run` itself."""
    if mesh is None:
        return run
    param_dims, data_dims = by_leaf or ({}, {})
    lanes_first = KLNMF_LAYOUT["per_restart"]
    replicated = KLNMF_LAYOUT["replicated"]

    def dims(path):
        return by_leaf_name(path, param_dims, lanes_first)

    def sharded(params0, data):
        shapes = {path: leaf.shape
                  for path, leaf in tree_flatten(params0).items()}
        n_lanes = next(iter(shapes.values()))[0]
        result, losses = run(
            tree_unflatten({path: local_block(leaf, mesh, dims(path))
                            for path, leaf in tree_flatten(params0).items()}),
            tree_unflatten({
                path: local_block(leaf, mesh,
                                  by_leaf_name(path, data_dims, replicated))
                for path, leaf in tree_flatten(data).items()}),
        )

        def lanes(leaf):
            return gather_block(leaf, mesh, lanes_first,
                                (n_lanes,) + tuple(leaf.shape[1:]))

        params = tree_unflatten({
            path: gather_block(leaf, mesh, dims(path), shapes[path])
            for path, leaf in tree_flatten(result.params).items()})
        return (FitResult(params, *(lanes(getattr(result, field)) for field
                                    in FitResult._fields[1:])),
                lanes(losses))

    return sharded


def klnmf_mesh_run(make_run, mesh, n_lanes: int, n_samples: int):
    """The run of make_run(reduce_samples) -> run on `mesh`, for lanes in
    the KLNMF layout (W, H, X; MvNMF's too): the mesh must divide the
    lanes and samples (the JAX package's refusal), and a sample axis above
    1 shards the samples, whose sums over D make_run's step functions
    complete with parallel.mesh.sample_sum. Without a mesh,
    make_run(None)."""
    if mesh is None:
        return make_run(None)
    check_divides(mesh, n_lanes, n_samples)
    reduce = (samples_reducer(mesh) if axis_size(mesh, SAMPLE_AXIS) > 1
              else None)
    return on_mesh(make_run(reduce), mesh, KLNMF_SHARDS)


def fit_klnmf_restarts_compacting(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    dtype=torch.float32,
    min_bucket: int = 8,
    device=None,
    mesh=None,
):
    """Compacting twin of parallel.restarts.fit_klnmf_restarts (same seeds,
    same per-lane results). Under a `mesh` each rank compacts its own
    lanes (and samples). Returns a RestartResult."""
    result, losses = klnmf_restarts_compacting_device(
        X, n_signatures, n_restarts, seed=seed, config=config,
        weights_kl=weights_kl, weights_lhalf=weights_lhalf, dtype=dtype,
        min_bucket=min_bucket, device=device, mesh=mesh,
    )
    return finalize_compacting_restarts(result, losses)


def klnmf_restarts_compacting_device(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    dtype=torch.float32,
    min_bucket: int = 8,
    device=None,
    mesh=None,
):
    """Body of fit_klnmf_restarts_compacting: the (FitResult, losses) pair
    with every tensor still on the device."""
    from .restarts import _restart_inputs

    config = config or FitConfig()
    params0, data = _restart_inputs(X, n_signatures, n_restarts, seed,
                                    weights_kl, weights_lhalf, dtype, device)
    return klnmf_mesh_run(
        lambda reduce: compacting_runner(config, False, min_bucket,
                                         reduce).run,
        mesh, n_restarts, data["X"].shape[-1])(params0, data)


def finalize_compacting_restarts(result, losses):
    """Build a RestartResult from a (FitResult, losses) pair (losses and
    iteration counts to the host; W and H stay on the device)."""
    from .restarts import RestartResult

    losses_host = losses.cpu().numpy()
    return RestartResult(
        W=result.params["W"],
        H=result.params["H"],
        losses=losses_host,
        n_iterations=result.n_iterations.cpu().numpy(),
        best_index=int(losses_host.argmin()),
    )
