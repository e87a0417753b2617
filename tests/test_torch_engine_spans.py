"""The convergence engine's spans (salamander_tpu_torch/engine/fit.py): the
loop state on the device, the host reading it once a span of SPAN blocks.

Every loop is run at SPAN 1, 3 and 8 on the same numpy-drawn float64
inputs: each gives the bits it gives at SPAN 1 (params, history, n_evals,
n_iterations), and matches the JAX package's fit_loop and
fit_loop_lockstep at the rtol of test_torch_engine.py (1e-10). The
configurations cover a remainder tail, fits that converge in the middle
of a span, stop_on_nonfinite, and a min_iterations several spans long.
On the CPU no span is captured as a CUDA graph; the card tests
(test_torch_cuda.py) hold graphed spans against eager ones."""

import functools

import jax
import numpy as np
import pytest
import torch

from salamander_tpu import engine as jax_engine
from salamander_tpu.ops import klnmf as jax_ops
from salamander_tpu_torch import engine
from salamander_tpu_torch.engine import FitConfig
from salamander_tpu_torch.engine import fit as fit_module
from salamander_tpu_torch.ops import cuda_klnmf
from salamander_tpu_torch.ops import klnmf as torch_ops
from salamander_tpu_torch.parallel.compaction import (
    CompactingRunner,
    klnmf_block_builder,
)

torch.set_num_threads(1)

RTOL = 1e-10  # as test_torch_engine.py: float64, the same arithmetic
SPANS = (1, 3, 8)
V, K, D, R = 16, 3, 24, 8

CONFIGS = {
    # lanes converge apart, most of them inside a span
    "converge": FitConfig(min_iterations=20, max_iterations=300,
                          conv_test_freq=10, tol=1e-5),
    # max_iterations not divisible by conv_test_freq: a never-evaluated tail
    "tail": FitConfig(min_iterations=10, max_iterations=73,
                      conv_test_freq=10, tol=1e-12),
    # 30 blocks before any lane may converge: ten spans of 3
    "long_min": FitConfig(min_iterations=300, max_iterations=600,
                          conv_test_freq=10, tol=1e-6),
    # lane 1 leaves float64 in its first block, long before min_iterations
    "nonfinite": FitConfig(min_iterations=100, max_iterations=200,
                           conv_test_freq=7, tol=1e-6,
                           stop_on_nonfinite=True),
}


@functools.lru_cache(maxsize=None)
def problem_arrays():
    rng = np.random.default_rng(3)
    truth = rng.dirichlet(0.3 * np.ones(V), K).T @ rng.gamma(2.0, 100.0,
                                                            (K, D))
    X = rng.poisson(truth).astype(float)
    W = np.ascontiguousarray(rng.dirichlet(np.ones(V), (R, K))
                             .transpose(0, 2, 1))
    H = rng.uniform(1.0, 30.0, (R, K, D))
    return X, W, H


@pytest.fixture(scope="module")
def problem():
    return problem_arrays()


@pytest.fixture
def span(request, monkeypatch):
    monkeypatch.setattr(fit_module, "SPAN", request.param)
    return request.param


def torch_fns(X, nonfinite: bool):
    """update, objective and block of the KL problem on X. With
    `nonfinite` the params carry a factor `scale` that multiplies H after
    each update and squares: 1e30 on lane 1 (infinite after four steps),
    1 elsewhere."""
    X_t = torch.from_numpy(X)

    def update(p):
        W, H = torch_ops.update_WH(X_t, p["W"], p["H"])
        if nonfinite:
            return {"W": W, "H": H * p["scale"],
                    "scale": p["scale"] * p["scale"]}
        return {"W": W, "H": H}

    def objective(p):
        return torch_ops.kl_divergence(X_t, p["W"], p["H"])

    def block(p, n_steps):
        for _ in range(n_steps):
            p = update(p)
        return p

    return update, objective, block


def jax_fns(X, nonfinite: bool):
    def update(p):
        W, H = jax_ops.update_WH(X, p["W"], p["H"])
        if nonfinite:
            return {"W": W, "H": H * p["scale"],
                    "scale": p["scale"] * p["scale"]}
        return {"W": W, "H": H}

    def objective(p):
        return jax_ops.kl_divergence(X, p["W"], p["H"])

    return update, objective


def params_of(W, H, name, lane=None):
    """numpy params of one lane (lane=int) or all lanes; the nonfinite
    case carries a growth factor, 1e30 on lane 1 and 1 elsewhere."""
    params = {"W": W, "H": H}
    if CONFIGS[name].stop_on_nonfinite:
        scale = np.ones((R, 1, 1))
        scale[1] = 1e30
        params["scale"] = scale
    if lane is not None:
        params = {key: value[lane] for key, value in params.items()}
    return params


def to_torch(params):
    return {key: torch.from_numpy(np.array(value))
            for key, value in params.items()}


@functools.lru_cache(maxsize=None)
def jax_single(name, lane):
    X, W, H = problem_arrays()
    update, objective = jax_fns(X, CONFIGS[name].stop_on_nonfinite)
    config = jax_engine.FitConfig(*CONFIGS[name])
    result = jax.jit(lambda p: jax_engine.fit_loop(update, objective, p,
                                                   config))(
        params_of(W, H, name, lane))
    return jax.tree.map(np.asarray, result)


@functools.lru_cache(maxsize=None)
def jax_lockstep(name):
    X, W, H = problem_arrays()
    update, objective = jax_fns(X, CONFIGS[name].stop_on_nonfinite)
    batched = jax.vmap(update)

    def block(p, steps):
        return jax.lax.fori_loop(0, steps, lambda _, q: batched(q), p)

    config = jax_engine.FitConfig(*CONFIGS[name])
    result = jax.jit(lambda p: jax_engine.fit_loop_lockstep(
        jax.vmap(objective), p, config, block))(params_of(W, H, name))
    return jax.tree.map(np.asarray, result)


def sentinel(history):
    history = np.asarray(history)
    return np.where(np.isnan(history), -1.0, history)


def assert_same_bits(a, b):
    """Two engine FitResults bit-equal in params, history, n_evals and
    n_iterations."""
    for key in a.params:
        torch.testing.assert_close(a.params[key], b.params[key], rtol=0,
                                   atol=0, equal_nan=True)
    torch.testing.assert_close(a.history, b.history, rtol=0, atol=0,
                               equal_nan=True)
    assert np.array_equal(np.asarray(a.n_evals), np.asarray(b.n_evals))
    assert np.array_equal(np.asarray(a.n_iterations),
                          np.asarray(b.n_iterations))


def assert_matches_jax(result, expected):
    assert np.array_equal(np.asarray(result.n_iterations),
                          expected.n_iterations)
    assert np.array_equal(np.asarray(result.n_evals), expected.n_evals)
    np.testing.assert_allclose(sentinel(result.history),
                               sentinel(expected.history), rtol=RTOL)
    for key in ("W", "H"):
        np.testing.assert_allclose(result.params[key].numpy(),
                                   expected.params[key], rtol=RTOL)


def run_single(problem, name, lane):
    X, W, H = problem
    update, objective, _ = torch_fns(X, CONFIGS[name].stop_on_nonfinite)
    return engine.fit_loop(update, objective,
                           to_torch(params_of(W, H, name, lane)),
                           CONFIGS[name])


def run_lockstep(problem, name):
    X, W, H = problem
    _, objective, block = torch_fns(X, CONFIGS[name].stop_on_nonfinite)
    return engine.fit_loop_lockstep(objective, to_torch(params_of(W, H,
                                                                  name)),
                                    CONFIGS[name], block)


def at_span_one(monkeypatch, run, *args):
    monkeypatch.setattr(fit_module, "SPAN", 1)
    return run(*args)


@pytest.mark.parametrize("span", SPANS, indirect=True)
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("lane", [0, 1, 2])
def test_fit_loop_spans(problem, span, name, lane, monkeypatch):
    result = run_single(problem, name, lane)
    assert_matches_jax(result, jax_single(name, lane))
    assert_same_bits(result, at_span_one(monkeypatch, run_single, problem,
                                         name, lane))


@pytest.mark.parametrize("span", SPANS, indirect=True)
@pytest.mark.parametrize("name", CONFIGS)
def test_fit_loop_lockstep_spans(problem, span, name, monkeypatch):
    result = run_lockstep(problem, name)
    assert_matches_jax(result, jax_lockstep(name))
    assert_same_bits(result, at_span_one(monkeypatch, run_lockstep,
                                         problem, name))


def test_cases_cover_what_they_name(problem):
    """The lanes stop inside spans of 3 and 8; a lane goes non-finite."""
    converge = jax_lockstep("converge").n_evals
    assert len(set(converge.tolist())) > 2
    assert any(n % 3 for n in converge) and any(n % 8 for n in converge)
    nonfinite = jax_lockstep("nonfinite")
    assert not np.isfinite(nonfinite.history[1, nonfinite.n_evals[1] - 1])
    assert nonfinite.n_evals[1] == 1 < np.delete(nonfinite.n_evals, 1).min()
    assert jax_lockstep("long_min").n_iterations.min() >= 300


@pytest.mark.parametrize("span", SPANS, indirect=True)
@pytest.mark.parametrize("name", ["converge", "long_min", "nonfinite"])
@pytest.mark.parametrize("floor", [1, 5])
def test_segment_alive_floor_spans(problem, span, name, floor, monkeypatch):
    """A segment stopped at a positive alive floor and resumed gives the
    bits of span 1 and of fit_loop_lockstep; it stops once the floor is
    reached, at most SPAN - 1 blocks late, and no earlier."""
    X, W, H = problem
    config = CONFIGS[name]
    _, objective, block = torch_fns(X, config.stop_on_nonfinite)
    params0 = to_torch(params_of(W, H, name))

    def run():
        state = engine.init_lockstep_state(objective, params0, config)
        paused = engine.run_lockstep_segment(objective, config, block, state,
                                             alive_floor=floor)
        paused_blocks = int(paused.eval_idx)
        resumed = engine.run_lockstep_segment(objective, config, block,
                                              paused)
        return (engine.finish_lockstep(resumed, config, block, state.of_prev),
                paused_blocks)

    result, paused_blocks = run()
    once, _ = at_span_one(monkeypatch, run)
    assert_same_bits(result, once)
    assert_matches_jax(result, jax_lockstep(name))
    n_evals = jax_lockstep(name).n_evals  # the block each lane stopped at
    full_blocks = config.max_iterations // config.conv_test_freq
    reached = min(int(np.sort(n_evals)[::-1][floor]), full_blocks)
    assert reached <= paused_blocks <= reached + span - 1 or \
        paused_blocks == full_blocks


@pytest.mark.parametrize("span", [3, 8], indirect=True)
def test_no_read_before_min_iterations(problem, span, monkeypatch):
    """The host reads the alive count at the segment's start and after
    each span that ends at or past min_iterations, never before."""
    X, W, H = problem
    config = CONFIGS["long_min"]
    _, objective, block = torch_fns(X, False)
    reads = []
    real = fit_module._alive

    def counting(state):
        reads.append(int(state.eval_idx))
        return real(state)

    monkeypatch.setattr(fit_module, "_alive", counting)
    engine.fit_loop_lockstep(objective, to_torch(params_of(W, H,
                                                           "long_min")),
                             config, block)
    min_blocks = config.min_iterations // config.conv_test_freq
    assert reads[0] == 0
    assert all(blocks >= min_blocks for blocks in reads[1:])
    assert all(later - earlier == span
               for earlier, later in zip(reads[1:], reads[2:-1]))


@pytest.mark.parametrize("span", SPANS, indirect=True)
@pytest.mark.parametrize("name", ["converge", "tail", "nonfinite"])
def test_compacting_runner_spans(problem, span, name, monkeypatch):
    """CompactingRunner.run (min_bucket 1: buckets of 8, 4, 2, 1 lanes)
    gives the bits of span 1 and matches JAX's fit_loop_lockstep."""
    X, W, H = problem
    config = CONFIGS[name]
    update_t, _, _ = torch_fns(X, config.stop_on_nonfinite)

    def objective(params, data):
        return torch_ops.kl_divergence(data["X"], params["W"], params["H"])

    def make_block(params, data):
        def block(p, n_steps):
            for _ in range(n_steps):
                p = update_t(p)
            return p
        return block

    def run():
        runner = CompactingRunner(config, objective, make_block,
                                  min_bucket=1)
        return runner.run(to_torch(params_of(W, H, name)),
                          {"X": torch.from_numpy(X)})[0]

    result = run()
    assert_same_bits(result, at_span_one(monkeypatch, run))
    assert_matches_jax(result, jax_lockstep(name))


@pytest.mark.parametrize("span", SPANS, indirect=True)
def test_fused_route_on_cpu_takes_the_spans(problem, span, monkeypatch):
    """KLNMF's fused route on the CPU: klnmf_block gives no kernel block
    (klnmf_block_builder's block is then the plain one); the kernel's
    block itself (cuda_klnmf.KernelBlock, whose plain version
    fused_mu_block_reference runs on the CPU) runs no graph through
    make_fit_function on the CPU, and takes spans of SPAN blocks up to the
    last full block."""
    X, W, H = problem
    config = CONFIGS["converge"]
    update_fn, objective_fn = torch_ops.make_step_functions()
    data = {"X": torch.from_numpy(X)}
    params = {"W": torch.from_numpy(W[0]), "H": torch.from_numpy(H[0])}
    assert cuda_klnmf.klnmf_block(params, data) is None
    builder = klnmf_block_builder(update_fn)
    assert not isinstance(builder(to_torch({"W": W, "H": H}), data),
                          cuda_klnmf.KernelBlock)  # not on a card: plain
    assert cuda_klnmf.KernelBlock.capturable

    spans = []
    real = fit_module._Spans.run

    def recording(self, state, n_blocks):
        spans.append((n_blocks, self.graphed))
        return real(self, state, n_blocks)

    monkeypatch.setattr(fit_module._Spans, "run", recording)
    fused = engine.make_fit_function(
        update_fn, objective_fn, config,
        block_update_fn=cuda_klnmf.KernelBlock(data))(params, data)
    monkeypatch.setattr(fit_module._Spans, "run", real)
    plain = at_span_one(monkeypatch, lambda: engine.make_fit_function(
        update_fn, objective_fn, config)(params, data))
    assert_same_bits(fused, plain)
    assert_matches_jax(fused, jax_single("converge", 0))
    assert not any(graphed for _, graphed in spans)
    assert all(n == span for n, _ in spans[:-1])
    blocks = sum(n for n, _ in spans)
    assert fused.n_evals <= blocks < fused.n_evals + span
    assert engine.graph_counts == {"captures": 0, "replays": 0}


@pytest.mark.parametrize("span", SPANS, indirect=True)
def test_verbose_lines_at_every_span(problem, span, capsys):
    """The verbose lines and their order do not depend on the span: each
    crossed verbosity_freq boundary once, read from the device history,
    none after the fit is done."""
    X, W, H = problem
    update, objective, _ = torch_fns(X, False)
    result = engine.fit_loop(
        update, objective, {"W": torch.from_numpy(W[0]),
                            "H": torch.from_numpy(H[0])},
        CONFIGS["converge"], verbose=True, verbosity_freq=30)
    lines = capsys.readouterr().out.splitlines()
    expected = [f"iteration: {i}; objective: "
                f"{float(result.history[i // 10 - 1]):.2f}"
                for i in range(30, result.n_iterations + 1, 30)]
    assert lines == expected


def test_freeze_keeps_a_done_problem(problem):
    """Blocks run after a problem is done change nothing (JAX's _select):
    the single-problem step on a done state returns it bit for bit."""
    X, W, H = problem
    update, objective, block = torch_fns(X, False)
    params = {"W": torch.from_numpy(W[0]), "H": torch.from_numpy(H[0])}
    frozen = fit_module._select(torch.tensor(True), params,
                                block(params, 10))
    moved = fit_module._select(torch.tensor(False), params,
                               block(params, 10))
    assert all(torch.equal(frozen[key], params[key]) for key in params)
    assert not torch.equal(moved["H"], params["H"])


def test_loop_state_lives_in_tensors(problem):
    """LockstepState's shared counters are device tensors, advanced by the
    step; the history column is written at the device's eval_idx."""
    X, W, H = problem
    _, objective, block = torch_fns(X, False)
    config = CONFIGS["converge"]
    state = engine.init_lockstep_state(
        objective, to_torch(params_of(W, H, "converge")), config)
    assert isinstance(state.eval_idx, torch.Tensor)
    assert isinstance(state.iteration, torch.Tensor)
    step = fit_module._lockstep_step(objective, config, block, config.tol)
    for _ in range(3):
        state = step(state)
    assert int(state.eval_idx) == 3 and int(state.iteration) == 30
    assert bool(torch.isfinite(state.history[:, :3]).all())
    assert bool(torch.isnan(state.history[:, 3:]).all())
