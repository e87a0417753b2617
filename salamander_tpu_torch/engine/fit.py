"""The shared NMF convergence loop, held against salamander_tpu/engine/fit.py.

The rule is the reference's: update the parameters every iteration,
evaluate the objective every `conv_test_freq` iterations, declare
convergence when the relative objective change drops below `tol` after at
least `min_iterations`, hard-stop at `max_iterations`, and record the
objective trace. Iterations past the last full block of `conv_test_freq`
form a remainder tail that runs once and is never evaluated.

The loop state lives on the device, as the JAX package's `_LoopState` and
`LockstepState` do: the iteration and evaluation counters, the objective
trace, the per-problem `done` flag. A block is one fused kernel launch (or
`conv_test_freq` plain updates) followed by one objective evaluation; a
finished problem (or lane) is frozen with `torch.where` on every leaf
(JAX's `_select`), so blocks run after it is done change nothing and a
batched fit gives each lane the result it would get alone.

The host drives the loop in SPANS of `SPAN` blocks and reads one flag a
span (is the fit done; are more lanes alive than the floor), where the
JAX package runs one `lax.while_loop` with no host round-trip. A span
never runs past the last full block, and no span before `min_iterations`
is tested (no problem can converge there) unless `stop_on_nonfinite` is
set. Where the block update's class says its spans may be captured
(``capturable``: one kernel launch a block, no host read, no collective,
as ops.cuda_klnmf.KernelBlock) and every parameter lies on a card, the
first full span runs eagerly and every later full span is the replay of
one CUDA graph captured from it: the graph reads and writes the loop
state's tensors in place. Every other block runs its spans eagerly. A
capture or replay that fails raises.

A block's objective comes from the block update's own launch where its
class says it gives one (``gives_objective``): the block is asked for it
in the dtype of the loop's objective (float64 where the objective is
promoted). Every other loop calls its objective function after the
block. The initial objective and the remainder tail are the same either
way. Which block a fit runs is the caller's choice (a KLNMF fit's:
ops.cuda_klnmf.klnmf_block); the engine reads only these two facts.

History is a NaN-padded tensor of max_iterations // conv_test_freq entries
(the reference's `of_values[1:]`).

Spans and counters (profiling.py): each span run is the span
``engine.span``, a capture ``engine.capture`` (capture_begin to
capture_end), each host read of the loop state ``engine.host_read``.
``engine.host_syncs`` counts those reads (one may fetch several scalars
once the device is done) and the synchronize before a capture;
``engine.lane_steps`` the lanes in the batch times the steps of every
block run, from shapes; ``engine.block_evals`` the blocks run (each
evaluates the objective once) and ``engine.block_evals_in_kernel`` those
whose objective came from the block update's launch; and, while
recording, ``engine.lane_steps_live`` the lanes' own iteration counts,
read once at a fit's end.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Any, Callable, NamedTuple

import torch

from .. import profiling
from .tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# blocks a span runs between two host reads of the loop state: chosen on an
# NVIDIA H100 from 4, 8, 16 and 32 by timing the headline and KLNMF(5).fit
# in turns (chip_smoke.py phase 5; PERF.md): the shortest was the fastest,
# a longer span costing more in its eager warm-up and capture than it
# saves in host reads
SPAN = 4

# CUDA graphs captured and replayed by the spans of capturable blocks
graph_counts = {"captures": 0, "replays": 0}

_EAGER_SPANS = False  # set by _eager_spans(): no span is captured


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


def _objective_in_block(block_update_fn) -> bool:
    """Whether each block's objective comes from the block update: its
    class says it gives one. Decided before the loop."""
    return bool(getattr(block_update_fn, "gives_objective", False))


def _advance(block_update_fn, objective_fn, in_block: bool, params,
             n_steps: int, dtype):
    """(params after a block, their objective): from the block's own
    launch where in_block, else objective_fn of the params."""
    if in_block:
        return block_update_fn(params, n_steps, objective=dtype)
    params = block_update_fn(params, n_steps)
    return params, objective_fn(params)


@contextlib.contextmanager
def _eager_spans():
    """Run every span eagerly, a capturable block's too: for holding
    graphed spans against eager ones on a card."""
    global _EAGER_SPANS
    before, _EAGER_SPANS = _EAGER_SPANS, True
    try:
        yield
    finally:
        _EAGER_SPANS = before


def _graphed(block_update_fn, params) -> bool:
    """Whether a loop's spans are captured: decided before the loop from
    the block's class (``capturable``) and the params' device."""
    return (not _EAGER_SPANS
            and getattr(block_update_fn, "capturable", False)
            and all(leaf.is_cuda for leaf in tree_leaves(params)))


@functools.lru_cache(maxsize=None)
def _capture_stream(device_index: int):
    return torch.cuda.Stream(device=device_index)


# within shared_span_pool(): the last released span graph of each card
# (device index -> CUDAGraph), kept until the next capture there shares
# its memory pool; None outside it
_handoff: dict | None = None


@contextlib.contextmanager
def shared_span_pool():
    """A scope in which the fits captured one after another on a card
    share one memory pool: a released span graph is kept, never replayed
    again, until the next capture there takes over its pool and resets
    it. With a pool for each capture, every released graph's memory stayed
    cached, the allocator cannot hand cached memory back to the card while
    a capture runs, and cell 7b's rank groups (96 x 200,000) ran an H100
    out of memory (PERF.md). When the outermost scope ends, the graph it
    kept is reset, so its pool is cached memory that
    torch.cuda.empty_cache() hands back. Outside a scope a released graph
    is reset at once."""
    global _handoff
    if _handoff is not None:  # nested: the outermost scope ends it
        yield
        return
    _handoff = {}
    try:
        yield
    finally:
        kept, _handoff = _handoff, None
        for graph in kept.values():
            graph.reset()


def _end_capture(graph, pool, device_index: int) -> None:
    """graph.capture_end() of a capture into `pool`. Where the capture
    failed (a host read in the span), capture_end raises before it tells
    the allocator that the capture ended: the allocator would go on
    counting a capture under way and free no cached memory for the rest
    of the process, empty_cache included (on an H100, fits after a failed
    capture left 3 GB that empty_cache could not hand back). End it there,
    and release the capture's hold on the pool."""
    try:
        graph.capture_end()
    except RuntimeError:
        torch._C._cuda_endAllocateToPool(device_index, pool)
        torch._C._cuda_releasePool(device_index, pool)
        raise


class _Spans:
    """Runs spans of `step` (one block: loop state -> loop state, a
    NamedTuple of tensors with a `params` tree).

    Eager, or with `graphed`: every span eager until one full span has run
    (the warm-up: the kernel library built, its launch attributes set),
    then each full span is a replay of one CUDA graph captured from a full
    span of `step`. The graph reads the state's tensors and copies the
    span's final state back into them, so a replayed span's state is those
    same tensors, and each later run() is given the state the last one
    returned. A span shorter than SPAN (the last) runs eagerly. Each
    replay adds the kernel launches its graph holds to the kernel's
    counts (ops.cuda_klnmf). release() ends the graph's use: it is reset,
    or within shared_span_pool() kept for the next capture's pool."""

    def __init__(self, step, graphed: bool, lane_steps: int = 0,
                 in_block: bool = False):
        profiling.end_prelude()  # the fit's first span is next
        self.step = step
        self.graphed = graphed
        self.lane_steps = lane_steps  # lanes x steps of one block
        self.in_block = in_block  # the blocks' objective from the launch
        self.warm = False
        self.graph = None
        self.device = None
        self.static: dict = {}
        self.launches: list = []

    def run(self, state, n_blocks: int):
        profiling.count("engine.lane_steps", self.lane_steps * n_blocks)
        profiling.count("engine.block_evals", n_blocks)
        if self.in_block:
            profiling.count("engine.block_evals_in_kernel", n_blocks)
        with profiling.span("engine.span"):
            return self._run(state, n_blocks)

    def _run(self, state, n_blocks: int):
        if not (self.graphed and self.warm and n_blocks == SPAN):
            for _ in range(n_blocks):
                state = self.step(state)
            self.warm = self.warm or n_blocks == SPAN
            return state
        from ..ops import cuda_klnmf

        if self.graph is None:
            self._capture(type(state), tree_flatten(state._asdict()))
        with torch.cuda.device(self.device):
            self.graph.replay()
        cuda_klnmf.count_replay(self.launches)
        graph_counts["replays"] += 1
        return type(state)(**tree_unflatten(self.static))

    def _capture(self, state_type, flat: dict) -> None:
        from ..ops import cuda_klnmf

        self.static = flat
        self.device = next(iter(flat.values())).device
        cuda_klnmf.captured_launches()  # drop any stale record
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end rather than torch.cuda.graph, whose empty_cache
        # before each capture hands the eager spans' memory back to the
        # card only for the capture to take it again: at a cell 7b rank
        # group's size that made graphed spans slower than eager ones
        # (chip_smoke.py phase 19c; PERF.md). Within shared_span_pool() the
        # capture shares the pool of the card's last released span graph
        previous = (None if _handoff is None
                    else _handoff.pop(self.device.index, None))
        profiling.count("engine.host_syncs")
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(
                _capture_stream(self.device.index)):
            pool = (torch.cuda.graph_pool_handle() if previous is None
                    else previous.pool())
            try:
                with profiling.span("engine.capture"):
                    graph.capture_begin(pool=pool)
                    try:
                        state = state_type(**tree_unflatten(flat))
                        for _ in range(SPAN):
                            state = self.step(state)
                        for path, leaf in tree_flatten(
                                state._asdict()).items():
                            if leaf is not flat[path]:
                                flat[path].copy_(leaf)
                        del state
                    finally:
                        _end_capture(graph, pool, self.device.index)
            finally:
                if previous is not None:
                    previous.reset()
        self.graph = graph
        self.launches = cuda_klnmf.captured_launches()
        graph_counts["captures"] += 1

    def release(self) -> None:
        if self.graph is not None and _handoff is None:
            self.graph.reset()
        elif self.graph is not None:
            stale = _handoff.pop(self.device.index, None)
            if stale is not None:
                stale.reset()
            _handoff[self.device.index] = self.graph
        self.graph, self.static, self.launches = None, {}, []


def _host_read():
    """The span of one host read of the loop state, counted as a host
    sync."""
    profiling.count("engine.host_syncs")
    return profiling.span("engine.host_read")


def _done(state) -> bool:
    with _host_read():
        return bool(state.done)


def _span_blocks(blocks: int, full_blocks: int) -> int:
    """Blocks of the next span: SPAN, or fewer at the last full block."""
    return min(SPAN, full_blocks - blocks)


def _tested(blocks: int, config: FitConfig) -> bool:
    """Whether the host reads the loop state after `blocks` blocks: not
    before min_iterations, where no problem can converge, unless a
    non-finite objective may stop the fit."""
    return (blocks * int(config.conv_test_freq) >= int(config.min_iterations)
            or config.stop_on_nonfinite)


def _plain_block(update_fn) -> BlockUpdate:
    """The plain block: n_steps calls of update_fn(params)."""
    def block(params, n_steps: int):
        for _ in range(int(n_steps)):
            params = update_fn(params)
        return params

    return block


class _LoopState(NamedTuple):
    """State of the single-problem loop, on the parameters' device (JAX:
    salamander_tpu/engine/fit.py::_LoopState)."""

    params: dict
    of_prev: torch.Tensor    # () objective at the last eval
    history: torch.Tensor    # (max_evals,) NaN-padded, written in place
    n_evals: torch.Tensor    # () int64
    iteration: torch.Tensor  # () int32
    done: torch.Tensor       # () bool


def _select(frozen, old, new):
    """torch.where(frozen, old, new) on every leaf of a tree (JAX:
    _select); `frozen` is a scalar or a (R,) lane mask."""
    def pick(a, b):
        mask = frozen.reshape(frozen.shape + (1,) * (a.dim() - frozen.dim()))
        return torch.where(mask, a, b)

    return tree_map(pick, old, new)


def _print_crossings(state: _LoopState, first: int, last: int, freq: int,
                     verbosity_freq: int) -> None:
    """The verbose lines of blocks first..last-1 that ran before the fit
    was done: 'iteration: N; objective: X' where a block crossed a
    verbosity_freq boundary, read from the device history."""
    with _host_read():
        values = state.history[first:min(last, int(state.n_evals))].tolist()
    for block, value in enumerate(values, start=first):
        iteration = (block + 1) * freq
        if iteration // verbosity_freq > (iteration - freq) // verbosity_freq:
            print(f"iteration: {iteration}; objective: {value:.2f}")


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
    that keeps a whole block's intermediate state on chip. The returned
    n_evals and n_iterations are host integers, read once at the end."""
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    min_iterations = int(config.min_iterations)
    max_evals = max(1, max_iterations // freq)
    full_blocks = max_iterations // freq
    remainder = max_iterations - full_blocks * freq
    advance = block_update_fn or _plain_block(update_fn)

    of0 = objective_fn(params0)
    tol = _effective_tol(config, of0.dtype, params0)
    device = of0.device
    in_block = _objective_in_block(advance)

    def step(state: _LoopState) -> _LoopState:
        params, of_value = _advance(advance, objective_fn, in_block,
                                    state.params, freq, of0.dtype)
        iteration = state.iteration + freq
        rel_change = torch.abs(state.of_prev - of_value) / torch.abs(
            state.of_prev)
        done = ((rel_change < tol) & (iteration >= min_iterations)) | (
            iteration >= max_iterations)
        if config.stop_on_nonfinite:
            done = done | ~torch.isfinite(of_value)
        index = state.n_evals.reshape(1)
        state.history.index_copy_(0, index, torch.where(
            state.done, state.history.index_select(0, index),
            of_value.to(state.history.dtype).reshape(1)))
        new = {"params": params, "of_prev": of_value,
               "n_evals": state.n_evals + 1, "iteration": iteration,
               "done": done}
        old = {name: getattr(state, name) for name in new}
        return _LoopState(history=state.history,
                          **_select(state.done, old, new))

    state = _LoopState(
        params=params0,
        of_prev=of0,
        history=torch.full((max_evals,), float("nan"), dtype=of0.dtype,
                           device=device),
        n_evals=torch.zeros((), dtype=torch.int64, device=device),
        iteration=torch.zeros((), dtype=torch.int32, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
    )
    spans = _Spans(step, _graphed(advance, params0), freq, in_block)
    blocks = 0
    try:
        while blocks < full_blocks:
            n_blocks = _span_blocks(blocks, full_blocks)
            state = spans.run(state, n_blocks)
            blocks += n_blocks
            if verbose:
                _print_crossings(state, blocks - n_blocks, blocks, freq,
                                 verbosity_freq)
            if _tested(blocks, config) and _done(state):  # one host sync
                break
    finally:
        spans.release()

    params = state.params
    with _host_read():
        n_evals, iteration = int(state.n_evals), int(state.iteration)
    if remainder > 0 and not _done(state):
        profiling.count("engine.lane_steps", remainder)
        params = advance(params, remainder)
        iteration += remainder
    if profiling.is_recording():
        profiling.count("engine.lane_steps_live", iteration)

    return FitResult(params, of0, state.history, n_evals, iteration)


class LockstepState(NamedTuple):
    """Resumable state of the natively batched convergence loop.

    Every tensor except the two shared counters carries the leading restart
    (lane) axis R. `eval_idx` and `iteration` are device scalars shared by
    the lanes: every lane advances in lockstep blocks, so they stay right
    across a compaction.
    """

    params: dict                # a tree of tensors (engine.tree)
    of_prev: torch.Tensor       # (R,) objective at each lane's last eval
    history: torch.Tensor       # (R, max_evals) NaN-padded traces
    n_evals: torch.Tensor       # (R,) int32
    eval_idx: torch.Tensor      # () int64: block evals performed so far
    iteration: torch.Tensor     # () int32: iterations performed so far
    n_iterations: torch.Tensor  # (R,) int32 per-lane count, frozen when done
    done: torch.Tensor          # (R,) bool


def _masked_advance(block_update_fn: BlockUpdate, params, frozen, n_steps):
    """Advance every lane by n_steps, then restore the frozen lanes (on
    every leaf of the tree: a leaf left out would let a frozen lane
    drift)."""
    return _select(frozen, params, block_update_fn(params, n_steps))


def _masked_block(block_update_fn: BlockUpdate, frozen) -> BlockUpdate:
    """block_update_fn with the frozen lanes restored after it. Asked for
    the objective, it returns the advanced lanes' values: a frozen lane's
    is never read (its history and of_prev keep their values)."""
    def block(params, n_steps, **objective):
        if not objective:
            return _masked_advance(block_update_fn, params, frozen, n_steps)
        new, of_value = block_update_fn(params, n_steps, **objective)
        return _select(frozen, params, new), of_value

    return block


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
        eval_idx=torch.zeros((), dtype=torch.int64, device=device),
        iteration=torch.zeros((), dtype=torch.int32, device=device),
        n_iterations=torch.zeros(n_restarts, dtype=torch.int32,
                                 device=device),
        done=torch.zeros(n_restarts, dtype=torch.bool, device=device),
    )


def _lockstep_step(objective_fn, config: FitConfig,
                   block_update_fn: BlockUpdate, tol: float):
    """One block of the lockstep loop: LockstepState -> LockstepState, the
    history written in place at the device's eval_idx."""
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    min_iterations = int(config.min_iterations)
    in_block = _objective_in_block(block_update_fn)

    def step(state: LockstepState) -> LockstepState:
        done_prev = state.done
        params, of_value = _advance(  # of_value (R,)
            _masked_block(block_update_fn, done_prev), objective_fn,
            in_block, state.params, freq, state.of_prev.dtype)
        iteration = state.iteration + freq

        rel_change = torch.abs(state.of_prev - of_value) / torch.abs(
            state.of_prev
        )
        converged = (rel_change < tol) & (iteration >= min_iterations)
        done = done_prev | converged | (iteration >= max_iterations)
        if config.stop_on_nonfinite:
            done = done | ~torch.isfinite(of_value)

        record = ~done_prev  # lanes recording this eval
        index = state.eval_idx.reshape(1)
        state.history.index_copy_(1, index, torch.where(
            record.unsqueeze(1),
            of_value.to(state.history.dtype).unsqueeze(1),
            state.history.index_select(1, index)))
        return LockstepState(
            params=params,
            of_prev=torch.where(record, of_value, state.of_prev),
            history=state.history,
            n_evals=state.n_evals + record.to(torch.int32),
            eval_idx=state.eval_idx + 1,
            iteration=iteration,
            n_iterations=torch.where(done_prev, state.n_iterations,
                                     iteration),
            done=done,
        )

    return step


def _alive(state: LockstepState) -> int:
    with _host_read():
        return int((~state.done).sum())


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

    The host reads the alive count once a span (and once at the start), so
    the segment may stop up to SPAN - 1 blocks after the floor is reached;
    the lanes done by then are frozen, so no lane's result depends on it.
    With alive_floor=0 this runs the loop to the same results as
    fit_loop_lockstep; a positive floor is the hook for lane compaction
    (gather the survivors into a smaller batch and resume there). The
    state's history tensor is updated in place.
    """
    full_blocks = int(config.max_iterations) // int(config.conv_test_freq)
    tol = _effective_tol(config, state.of_prev.dtype, state.params,
                         warn=False)
    with _host_read():  # the segment's one read of its counter
        blocks = int(state.eval_idx)
    if blocks >= full_blocks or _alive(state) <= alive_floor:
        return state
    spans = _Spans(_lockstep_step(objective_fn, config, block_update_fn,
                                  tol),
                   _graphed(block_update_fn, state.params),
                   int(state.done.shape[0]) * int(config.conv_test_freq),
                   _objective_in_block(block_update_fn))
    try:
        while blocks < full_blocks:
            n_blocks = _span_blocks(blocks, full_blocks)
            state = spans.run(state, n_blocks)
            blocks += n_blocks
            if _tested(blocks, config) and _alive(state) <= alive_floor:
                break
    finally:
        spans.release()
    return state


def finish_lockstep(
    state: LockstepState,
    config: FitConfig,
    block_update_fn: BlockUpdate,
    initial_objective,
) -> FitResult:
    """Apply the never-evaluated remainder tail to the lanes still running
    and assemble the FitResult. While recording, the lanes' iteration
    counts are read once (engine.lane_steps_live)."""
    freq = int(config.conv_test_freq)
    max_iterations = int(config.max_iterations)
    remainder = max_iterations - (max_iterations // freq) * freq
    params = state.params
    n_iterations = state.n_iterations
    if remainder > 0:
        profiling.count("engine.lane_steps",
                        int(state.done.shape[0]) * remainder)
        params = _masked_advance(block_update_fn, params, state.done,
                                 remainder)
        n_iterations = torch.where(
            state.done, n_iterations,
            torch.full_like(n_iterations, max_iterations),
        )
    if profiling.is_recording():
        profiling.count("engine.lane_steps_live", int(n_iterations.sum()))
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
    block_update_fn: BlockUpdate | None = None,
):
    """Build a single-problem fit function `(params0, data) -> FitResult`.

    update_fn/objective_fn take (params, data). block_update_fn(params,
    n_steps), when given, advances a whole block in one call and is bound
    to the data the fit runs on (a KLNMF fit's: the kernel's block where
    ops.cuda_klnmf.klnmf_block gives it); otherwise a block is n_steps
    calls of update_fn. Batched multi-start fits call fit_loop_lockstep
    directly.
    """

    def run(params0, data):
        return fit_loop(lambda p: update_fn(p, data),
                        lambda p: objective_fn(p, data), params0, config,
                        verbose=verbose, verbosity_freq=verbosity_freq,
                        block_update_fn=block_update_fn)

    return run
