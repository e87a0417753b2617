"""The shared NMF convergence loop, held against salamander_tpu/engine/fit.py.

The rule is the reference's: update the parameters every iteration,
evaluate the objective every `conv_test_freq` iterations, declare
convergence when the relative objective change drops below `tol` after at
least `min_iterations`, hard-stop at `max_iterations`, and record the
objective trace. Iterations past the last full block of `conv_test_freq`
form a remainder tail that runs once and is never evaluated.

The loop is driven from the host block by block. A block is one fused
kernel launch (or `conv_test_freq` plain updates) followed by one objective
evaluation; the only device-to-host transfer per block is the test of
whether the fit (every lane of it) is done. Lanes that are done are frozen
on the device with `torch.where`, so a batched fit gives each lane the
result it would get alone.

History is a NaN-padded tensor of max_iterations // conv_test_freq entries
(the reference's `of_values[1:]`).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple

import torch

from .tree import tree_leaves, tree_map


class FitConfig(NamedTuple):
    """Convergence-rule hyperparameters shared by every model family.

    stop_on_nonfinite: fail fast when an evaluated objective is NaN/Inf.
    """

    min_iterations: int = 500
    max_iterations: int = 10000
    conv_test_freq: int = 10
    tol: float = 1e-7
    stop_on_nonfinite: bool = False


def tolerance_floor(dtype) -> float:
    """Smallest meaningful relative-change tolerance for an objective dtype.

    Below a dtype's own relative resolution successive objective values
    jitter by a few ulps forever and the fit silently runs to
    max_iterations. Sub-64-bit floating dtypes get a floor of 10 machine
    epsilons; float64 keeps the user's tolerance.
    """
    if dtype.is_floating_point and torch.finfo(dtype).bits < 64:
        return 10.0 * float(torch.finfo(dtype).eps)
    return 0.0


def _effective_tol(config: FitConfig, objective_dtype, params0,
                   warn: bool = True) -> float:
    """The user's tol floored at the resolution of BOTH the objective dtype
    and the parameter dtypes: float32 parameters keep injecting ~eps(float32)
    relative jitter into even a float64 objective."""
    tol = float(config.tol)
    floor = tolerance_floor(objective_dtype)
    for leaf in tree_leaves(params0):
        if leaf.dtype.is_floating_point:
            floor = max(floor, tolerance_floor(leaf.dtype))
    if tol < floor:
        if warn:
            warnings.warn(
                f"tol={tol:g} is below the convergence resolution of this "
                f"fit's dtype; using {floor:g} instead. Fit with "
                "dtype='float64' for tighter tolerances.",
                UserWarning,
            )
        return floor
    return tol


def effective_tolerance(config: FitConfig, objective_dtype, params0) -> float:
    """The tolerance the engine enforces, without its warning (recorded as
    model.history['tol_effective'])."""
    return _effective_tol(config, objective_dtype, params0, warn=False)


class FitResult(NamedTuple):
    params: dict  # a tree of tensors (engine.tree)
    initial_objective: torch.Tensor
    history: torch.Tensor        # (max_evals,) or (R, max_evals), NaN-padded
    n_evals: Any                 # int, or (R,) tensor for lockstep fits
    n_iterations: Any            # int, or (R,) tensor for lockstep fits


BlockUpdate = Callable[[dict, int], dict]


def _plain_block(update_fn) -> BlockUpdate:
    def block(params, n_steps: int):
        for _ in range(n_steps):
            params = update_fn(params)
        return params

    return block


def fit_loop(
    update_fn: Callable[[dict], dict],
    objective_fn: Callable[[dict], torch.Tensor],
    params0: dict,
    config: FitConfig,
    verbose: bool = False,
    verbosity_freq: int = 1000,
    block_update_fn: BlockUpdate | None = None,
) -> FitResult:
    """Run the convergence loop for ONE problem (the data lives inside the
    closures).

    block_update_fn(params, n_steps), when given, replaces the n_steps
    single updates of a block with one call - the hook for a fused kernel
    that keeps a whole block's intermediate state on chip."""
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    min_iterations = int(config.min_iterations)
    max_evals = max(1, max_iterations // freq)
    full_block_iterations = (max_iterations // freq) * freq
    remainder = max_iterations - full_block_iterations
    advance = block_update_fn or _plain_block(update_fn)

    of0 = objective_fn(params0)
    tol = _effective_tol(config, of0.dtype, params0)
    history = torch.full((max_evals,), float("nan"), dtype=of0.dtype,
                         device=of0.device)
    params, of_prev = params0, of0
    n_evals = iteration = 0
    done = False
    while not done and iteration < full_block_iterations:
        params = advance(params, freq)
        iteration += freq
        of_value = objective_fn(params)
        rel_change = torch.abs(of_prev - of_value) / torch.abs(of_prev)
        stop = (rel_change < tol) & (iteration >= min_iterations)
        if config.stop_on_nonfinite:
            stop = stop | ~torch.isfinite(of_value)
        history[n_evals] = of_value
        n_evals += 1
        of_prev = of_value
        done = bool(stop) or iteration >= max_iterations  # one host sync
        if verbose and (iteration // verbosity_freq) > (
            (iteration - freq) // verbosity_freq
        ):
            print(f"iteration: {iteration}; objective: {float(of_value):.2f}")

    if remainder > 0 and not done:
        params = advance(params, remainder)
        iteration += remainder

    return FitResult(params, of0, history, n_evals, iteration)


class LockstepState(NamedTuple):
    """Resumable state of the natively batched convergence loop.

    Every tensor except the two shared counters carries the leading restart
    (lane) axis R. `eval_idx` and `iteration` are host integers: every lane
    advances in lockstep blocks.
    """

    params: dict                # a tree of tensors (engine.tree)
    of_prev: torch.Tensor       # (R,) objective at each lane's last eval
    history: torch.Tensor       # (R, max_evals) NaN-padded traces
    n_evals: torch.Tensor       # (R,)
    eval_idx: int               # block evals performed so far
    iteration: int              # iterations performed so far
    n_iterations: torch.Tensor  # (R,) per-lane count, frozen when done
    done: torch.Tensor          # (R,) bool


def _masked_advance(block_update_fn: BlockUpdate, params, frozen, n_steps):
    """Advance every lane by n_steps, then restore the frozen lanes (on
    every leaf of the tree: a leaf left out would let a frozen lane
    drift)."""
    def restore(old, new):
        lanes = frozen.reshape((frozen.shape[0],) + (1,) * (old.dim() - 1))
        return torch.where(lanes, old, new)

    return tree_map(restore, params, block_update_fn(params, n_steps))


def init_lockstep_state(
    objective_fn: Callable[[dict], torch.Tensor],
    params0: dict,
    config: FitConfig,
) -> LockstepState:
    """Evaluate the initial objective and build the loop state."""
    max_evals = max(1, int(config.max_iterations) // int(config.conv_test_freq))
    of0 = objective_fn(params0)  # (R,)
    n_restarts = of0.shape[0]
    device = of0.device
    return LockstepState(
        params=params0,
        of_prev=of0,
        history=torch.full((n_restarts, max_evals), float("nan"),
                           dtype=of0.dtype, device=device),
        n_evals=torch.zeros(n_restarts, dtype=torch.int32, device=device),
        eval_idx=0,
        iteration=0,
        n_iterations=torch.zeros(n_restarts, dtype=torch.int32,
                                 device=device),
        done=torch.zeros(n_restarts, dtype=torch.bool, device=device),
    )


def run_lockstep_segment(
    objective_fn: Callable[[dict], torch.Tensor],
    config: FitConfig,
    block_update_fn: BlockUpdate,
    state: LockstepState,
    alive_floor: int = 0,
) -> LockstepState:
    """Advance the lockstep loop until every lane is done, max_iterations'
    full blocks are exhausted, or at most `alive_floor` lanes remain
    unconverged.

    With alive_floor=0 this runs the loop to the same exit as
    fit_loop_lockstep; a positive floor is the hook for lane compaction
    (gather the survivors into a smaller batch and resume there). The
    state's history tensor is updated in place.
    """
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    min_iterations = int(config.min_iterations)
    full_block_iterations = (max_iterations // freq) * freq
    tol = _effective_tol(config, state.of_prev.dtype, state.params,
                         warn=False)

    # one host sync per block: the count of lanes still running
    while (state.iteration < full_block_iterations
           and int((~state.done).sum()) > alive_floor):
        done_prev = state.done
        params = _masked_advance(block_update_fn, state.params, done_prev,
                                 freq)
        iteration = state.iteration + freq

        of_value = objective_fn(params)  # (R,)
        rel_change = torch.abs(state.of_prev - of_value) / torch.abs(
            state.of_prev
        )
        converged = (rel_change < tol) & (iteration >= min_iterations)
        done = done_prev | converged | (iteration >= max_iterations)
        if config.stop_on_nonfinite:
            done = done | ~torch.isfinite(of_value)

        record = ~done_prev  # lanes recording this eval
        column = state.history[:, state.eval_idx]
        state.history[:, state.eval_idx] = torch.where(
            record, of_value.to(state.history.dtype), column
        )
        state = LockstepState(
            params=params,
            of_prev=torch.where(record, of_value, state.of_prev),
            history=state.history,
            n_evals=state.n_evals + record.to(torch.int32),
            eval_idx=state.eval_idx + 1,
            iteration=iteration,
            n_iterations=torch.where(
                done_prev, state.n_iterations,
                torch.full_like(state.n_iterations, iteration),
            ),
            done=done,
        )
    return state


def finish_lockstep(
    state: LockstepState,
    config: FitConfig,
    block_update_fn: BlockUpdate,
    initial_objective,
) -> FitResult:
    """Apply the never-evaluated remainder tail to the lanes still running
    and assemble the FitResult."""
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    remainder = max_iterations - (max_iterations // freq) * freq
    params = state.params
    n_iterations = state.n_iterations
    if remainder > 0:
        params = _masked_advance(block_update_fn, params, state.done,
                                 remainder)
        n_iterations = torch.where(
            state.done, n_iterations,
            torch.full_like(n_iterations, max_iterations),
        )
    return FitResult(params, initial_objective, state.history,
                     state.n_evals, n_iterations)


def fit_loop_lockstep(
    objective_fn: Callable[[dict], torch.Tensor],
    params0: dict,
    config: FitConfig,
    block_update_fn: BlockUpdate,
) -> FitResult:
    """Natively batched twin of fit_loop.

    params0 carries a leading restart axis R; objective_fn maps batched
    params to (R,) objectives; block_update_fn advances ALL lanes by a step
    count. Finished lanes are frozen, so each lane gets the same eval
    points, history and iteration count as its own fit_loop.
    """
    state = init_lockstep_state(objective_fn, params0, config)
    _effective_tol(config, state.of_prev.dtype, params0)  # warn once
    final = run_lockstep_segment(objective_fn, config, block_update_fn,
                                 state, alive_floor=0)
    return finish_lockstep(final, config, block_update_fn, state.of_prev)


def make_fit_function(
    update_fn: Callable[[dict, dict], dict],
    objective_fn: Callable[[dict, dict], torch.Tensor],
    config: FitConfig,
    verbose: bool = False,
    verbosity_freq: int = 1000,
    block_update_fn: Callable[[dict, dict, int], dict] | None = None,
):
    """Build a single-problem fit function `(params0, data) -> FitResult`.

    update_fn/objective_fn take (params, data). block_update_fn(params,
    data, n_steps), when given, advances a whole block in one call (the
    fused kernel); otherwise a block is n_steps calls of update_fn.
    Batched multi-start fits call fit_loop_lockstep directly.
    """

    def run(params0, data):
        update = lambda p: update_fn(p, data)
        objective = lambda p: objective_fn(p, data)
        if block_update_fn is None:
            block = _plain_block(update)
        else:
            block = lambda p, n: block_update_fn(p, data, n)
        return fit_loop(update, objective, params0, config, verbose=verbose,
                        verbosity_freq=verbosity_freq,
                        block_update_fn=block)

    return run
