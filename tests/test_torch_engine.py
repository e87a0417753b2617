"""The port's convergence engine (salamander_tpu_torch/engine/fit.py)
against salamander_tpu/engine/fit.py at float64: equal iteration and
evaluation counts, histories at rtol 1e-10, the remainder tail, the
tolerance floor, and the lockstep loop against the per-lane loop."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salamander_tpu import engine as jax_engine
from salamander_tpu.ops import klnmf as jax_ops
from salamander_tpu_torch import engine
from salamander_tpu_torch.engine import FitConfig
from salamander_tpu_torch.ops import cuda_klnmf
from salamander_tpu_torch.ops import klnmf as torch_ops
from salamander_tpu_torch.parallel.compaction import klnmf_block_builder

torch.set_num_threads(1)

RTOL = 1e-10
V, K, D, R = 16, 3, 24, 4


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    # counts from a rank-K truth, so the lanes converge at different blocks
    truth = rng.dirichlet(0.3 * np.ones(V), K).T @ rng.gamma(2.0, 100.0,
                                                            (K, D))
    X = rng.poisson(truth).astype(float)
    W = np.ascontiguousarray(rng.dirichlet(np.ones(V), (R, K))
                             .transpose(0, 2, 1))
    H = rng.uniform(1.0, 30.0, (R, K, D))
    return X, W, H


def jax_config(config):
    return jax_engine.FitConfig(*config)


def torch_fns(X):
    X_t = torch.from_numpy(X)

    def update(p):
        W, H = torch_ops.update_WH(X_t, p["W"], p["H"])
        return {"W": W, "H": H}

    def objective(p):
        return torch_ops.kl_divergence(X_t, p["W"], p["H"])

    def block(p, n_steps):
        for _ in range(n_steps):
            p = update(p)
        return p

    return update, objective, block


def jax_fns(X):
    def update(p):
        W, H = jax_ops.update_WH(X, p["W"], p["H"])
        return {"W": W, "H": H}

    def objective(p):
        return jax_ops.kl_divergence(X, p["W"], p["H"])

    return update, objective


def nan_to_sentinel(history):
    history = np.asarray(history)
    return np.where(np.isnan(history), -1.0, history)


CONFIGS = [
    FitConfig(min_iterations=20, max_iterations=300, conv_test_freq=10,
              tol=1e-5),
    # max_iterations not divisible by conv_test_freq: a never-evaluated tail
    FitConfig(min_iterations=10, max_iterations=73, conv_test_freq=10,
              tol=1e-12),
    FitConfig(min_iterations=0, max_iterations=120, conv_test_freq=7,
              tol=1e-4),
]


@pytest.mark.parametrize("config", CONFIGS)
def test_fit_loop_matches_jax(problem, config):
    X, W, H = problem
    update_t, objective_t, _ = torch_fns(X)
    update_j, objective_j = jax_fns(X)
    params = {"W": torch.from_numpy(W[0]), "H": torch.from_numpy(H[0])}
    result = engine.fit_loop(update_t, objective_t, params, config)
    expected = jax.jit(lambda p: jax_engine.fit_loop(
        update_j, objective_j, p, jax_config(config)))(
        {"W": W[0], "H": H[0]})

    assert result.n_iterations == int(expected.n_iterations)
    assert result.n_evals == int(expected.n_evals)
    np.testing.assert_allclose(nan_to_sentinel(result.history),
                               nan_to_sentinel(expected.history), rtol=RTOL)
    for key in ("W", "H"):
        np.testing.assert_allclose(result.params[key].numpy(),
                                   np.asarray(expected.params[key]),
                                   rtol=RTOL)


@pytest.mark.parametrize("config", CONFIGS)
def test_lockstep_matches_jax(problem, config):
    X, W, H = problem
    _, objective_t, block_t = torch_fns(X)
    update_j, objective_j = jax_fns(X)
    batched_update = jax.vmap(update_j)

    def block_j(p, steps):
        return jax.lax.fori_loop(0, steps, lambda _, q: batched_update(q), p)

    result = engine.fit_loop_lockstep(
        objective_t, {"W": torch.from_numpy(W), "H": torch.from_numpy(H)},
        config, block_t)
    expected = jax.jit(lambda p: jax_engine.fit_loop_lockstep(
        jax.vmap(objective_j), p, jax_config(config), block_j))(
        {"W": W, "H": H})

    assert np.array_equal(result.n_iterations.numpy(),
                          np.asarray(expected.n_iterations))
    assert np.array_equal(result.n_evals.numpy(),
                          np.asarray(expected.n_evals))
    np.testing.assert_allclose(nan_to_sentinel(result.history),
                               nan_to_sentinel(expected.history), rtol=RTOL)
    np.testing.assert_allclose(result.params["H"].numpy(),
                               np.asarray(expected.params["H"]), rtol=RTOL)


def test_lockstep_matches_per_lane_loop(problem):
    """Frozen lanes make each lane's result its own fit_loop's."""
    X, W, H = problem
    update_t, objective_t, block_t = torch_fns(X)
    config = CONFIGS[0]
    lockstep = engine.fit_loop_lockstep(
        objective_t, {"W": torch.from_numpy(W), "H": torch.from_numpy(H)},
        config, block_t)
    iterations = set()
    for lane in range(R):
        single = engine.fit_loop(
            update_t, objective_t,
            {"W": torch.from_numpy(W[lane]), "H": torch.from_numpy(H[lane])},
            config)
        iterations.add(single.n_iterations)
        assert int(lockstep.n_iterations[lane]) == single.n_iterations
        assert int(lockstep.n_evals[lane]) == single.n_evals
        np.testing.assert_allclose(
            nan_to_sentinel(lockstep.history[lane]),
            nan_to_sentinel(single.history), rtol=RTOL)
        np.testing.assert_allclose(lockstep.params["W"][lane].numpy(),
                                   single.params["W"].numpy(), rtol=RTOL)
    assert len(iterations) > 1  # the lanes really converge apart


def test_segment_alive_floor_resumes_exactly(problem):
    """Stopping at an alive floor and resuming is the same loop."""
    X, W, H = problem
    _, objective_t, block_t = torch_fns(X)
    config = CONFIGS[0]
    params0 = {"W": torch.from_numpy(W), "H": torch.from_numpy(H)}
    state = engine.init_lockstep_state(objective_t, params0, config)
    paused = engine.run_lockstep_segment(objective_t, config, block_t,
                                         state, alive_floor=R - 1)
    assert int((~paused.done).sum()) <= R - 1
    assert paused.iteration < config.max_iterations
    resumed = engine.run_lockstep_segment(objective_t, config, block_t,
                                          paused)
    once = engine.fit_loop_lockstep(objective_t, params0, config, block_t)
    final = engine.finish_lockstep(resumed, config, block_t, state.of_prev)
    assert torch.equal(final.n_iterations, once.n_iterations)
    assert torch.equal(final.params["W"], once.params["W"])


def test_make_fit_function_with_block_update(problem):
    """A block update replaces the per-step loop (the fused-kernel hook),
    bound to the fit's data."""
    X, W, H = problem
    update_fn, objective_fn = torch_ops.make_step_functions()
    calls = []
    config = CONFIGS[1]
    data = {"X": torch.from_numpy(X)}
    params = {"W": torch.from_numpy(W[0]), "H": torch.from_numpy(H[0])}

    def block(params, n_steps):
        calls.append(n_steps)
        for _ in range(n_steps):
            params = update_fn(params, data)
        return params

    plain = engine.make_fit_function(update_fn, objective_fn, config)(
        params, data)
    fused = engine.make_fit_function(update_fn, objective_fn, config,
                                     block_update_fn=block)(params, data)
    assert calls == [10] * 7 + [3]  # full blocks, then the tail
    assert fused.n_iterations == plain.n_iterations == 73
    assert torch.equal(fused.params["H"], plain.params["H"])


def test_tolerance_floor_and_warning():
    params32 = {"W": torch.ones(2, 2, dtype=torch.float32)}
    params64 = {"W": torch.ones(2, 2, dtype=torch.float64)}
    for dtype, jnp_dtype in ((torch.float32, jnp.float32),
                             (torch.float64, jnp.float64)):
        assert engine.tolerance_floor(dtype) == \
            jax_engine.tolerance_floor(jnp_dtype)
    config = FitConfig(tol=1e-7)
    floor = 10 * float(np.finfo(np.float32).eps)
    with pytest.warns(UserWarning, match="below the convergence resolution"):
        assert engine.fit.effective_tolerance(config, torch.float64,
                                              params32) == floor
        engine.fit._effective_tol(config, torch.float64, params32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert engine.effective_tolerance(config, torch.float64,
                                          params64) == 1e-7


def test_stop_on_nonfinite():
    config = FitConfig(min_iterations=0, max_iterations=100,
                       conv_test_freq=5, tol=0.0, stop_on_nonfinite=True)
    result = engine.fit_loop(
        lambda p: {"x": p["x"] * 1e30}, lambda p: p["x"].sum(),
        {"x": torch.ones(2, dtype=torch.float64)}, config)
    assert result.n_iterations < 100
    assert not np.isfinite(result.history[result.n_evals - 1].item())


def test_params_round_trip_between_packages(problem):
    X, W, H = problem
    tensors = engine.params_from_numpy({"W": W, "H": H}, "cpu",
                                       torch.float32)
    assert tensors["W"].dtype == torch.float32
    assert tuple(tensors["H"].shape) == (R, K, D)
    back = engine.params_to_numpy(
        engine.params_from_numpy({"W": W, "H": H}))
    assert np.array_equal(back["W"], W) and np.array_equal(back["H"], H)


def test_verbose_prints_at_each_verbosity_boundary(problem, capsys):
    X, W, H = problem
    update_t, objective_t, _ = torch_fns(X)
    engine.fit_loop(
        update_t, objective_t,
        {"W": torch.from_numpy(W[0]), "H": torch.from_numpy(H[0])},
        FitConfig(min_iterations=100, max_iterations=100, conv_test_freq=7),
        verbose=True, verbosity_freq=30,
    )
    printed = [line.split(";")[0] for line in
               capsys.readouterr().out.splitlines()]
    # iterations only visit multiples of 7: print where a block crossed 30
    assert printed == ["iteration: 35", "iteration: 63", "iteration: 91"]


# ---------------------------------------------------------------------- #
# the block's own objective (the kernel's launch returns it)
# ---------------------------------------------------------------------- #


def counting(objective_fn, calls):
    """objective_fn(params, data) that records each call."""
    def objective(params, data):
        calls.append(1)
        return objective_fn(params, data)

    return objective


class FakeKernelBlock(cuda_klnmf.KernelBlock):
    """The kernel's block (its class: capturable, gives its objective) on
    the plain ops of update_fn: asked for the objective (the dtype
    recorded in `asked`), it returns the params' KL divergence in that
    dtype, as the launch does on a card."""

    def __init__(self, update_fn, data, asked):
        super().__init__(data)
        self.update_fn, self.asked = update_fn, asked

    def __call__(self, params, n_steps, objective=None):
        for _ in range(n_steps):
            params = self.update_fn(params, self.data)
        if objective is None:
            return params
        self.asked.append(objective)
        return params, cuda_klnmf.block_objective_of(
            self.data["X"], params["W"], params["H"], objective)


class NoObjectiveBlock(FakeKernelBlock):
    """FakeKernelBlock whose class gives no objective."""

    gives_objective = False


def counter_deltas(run):
    before = dict(engine.fit.profiling.counters)
    result = run()
    names = ("engine.block_evals", "engine.block_evals_in_kernel")
    return result, {name: engine.fit.profiling.counters.get(name, 0)
                    - before.get(name, 0) for name in names}


def float32_problem(problem, lanes):
    X, W, H = problem
    params = {"W": torch.from_numpy(W).float(),
              "H": torch.from_numpy(H).float()}
    if not lanes:
        params = {key: value[0] for key, value in params.items()}
    return params, {"X": torch.from_numpy(X).float()}


def run_loop(lanes, update_fn, objective_fn, make_block, params, data,
             config):
    """fit_loop (through make_fit_function) or fit_loop_lockstep (through
    compaction.lockstep_fit), and the lockstep loop's final done flags."""
    from salamander_tpu_torch.parallel.compaction import lockstep_fit

    if not lanes:
        result = engine.make_fit_function(
            update_fn, objective_fn, config,
            block_update_fn=make_block(params, data))(params, data)
        return result, None
    result, _ = lockstep_fit(objective_fn, config, make_block, params, data)

    def objective(p):
        return objective_fn(p, data)

    state = engine.init_lockstep_state(objective, params, config)
    state = engine.run_lockstep_segment(
        objective, config, make_block(params, data), state)
    return result, state.done


@pytest.mark.parametrize("promote", [False, True])
@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("config", CONFIGS)
def test_block_objective_equals_objective_fn(problem, config, lanes,
                                             promote):
    """A block whose class gives its objective gives the loop the params,
    history, n_evals, n_iterations and done of the objective_fn route,
    unbatched and in lockstep, promoted to float64 or not: the objective
    function then runs once (the initial objective; lockstep_fit adds the
    final losses), every block is counted in the kernel, and the block is
    asked in the loop objective's dtype."""
    from salamander_tpu_torch.models.signature_nmf import promote_objective

    params, data = float32_problem(problem, lanes)
    update_fn, objective_fn = torch_ops.make_step_functions()
    if promote:
        objective_fn = promote_objective(objective_fn, params)
    routes = {}
    for in_kernel in (False, True):
        calls, asked = [], []
        kind = FakeKernelBlock if in_kernel else NoObjectiveBlock
        routes[in_kernel] = counter_deltas(lambda: run_loop(
            lanes, update_fn, counting(objective_fn, calls),
            lambda p, d: kind(update_fn, d, asked), params, data,
            config)) + (len(calls), asked)
    (plain, plain_done), plain_counts, plain_calls, _ = routes[False]
    (fused, fused_done), counts, calls, asked = routes[True]

    assert fused.history.dtype == (torch.float64 if promote
                                   else torch.float32)
    for key in ("W", "H"):
        assert torch.equal(fused.params[key], plain.params[key])
    assert torch.equal(nan_to_sentinel_t(fused.history),
                       nan_to_sentinel_t(plain.history))
    assert torch.equal(torch.as_tensor(fused.n_evals),
                       torch.as_tensor(plain.n_evals))
    assert torch.equal(torch.as_tensor(fused.n_iterations),
                       torch.as_tensor(plain.n_iterations))
    if lanes:
        assert torch.equal(fused_done, plain_done)
    blocks = plain_counts["engine.block_evals"]
    assert blocks >= 1 and counts["engine.block_evals"] == blocks
    assert counts["engine.block_evals_in_kernel"] == blocks
    assert plain_counts["engine.block_evals_in_kernel"] == 0
    assert asked == [fused.history.dtype] * blocks
    # the initial objectives (and lockstep_fit's final losses) alone
    assert calls == (3 if lanes else 1)
    assert plain_calls == calls + blocks


def nan_to_sentinel_t(history):
    return torch.where(torch.isnan(history), -1.0, history)


def masked_klnmf(params):
    W, H, mask = torch_ops.pad_rank(params["W"], params["H"],
                                    params["W"].shape[-1] + 2)
    return torch_ops.make_masked_step_functions(), {
        "W": W, "H": H, "mask": mask.expand(W.shape[:1] + mask.shape)}


FALLBACKS = {
    # (step functions, params, data, sample_sharded, the route's refusal)
    "weighted": lambda params, data: (
        torch_ops.make_step_functions(), params,
        {**data, "weights_kl": torch.linspace(
            0.5, 1.5, data["X"].shape[-1], dtype=data["X"].dtype)}, False,
        "loss weights"),
    "rank_masked": lambda params, data: (
        *masked_klnmf(params), data, False, "rank mask"),
    "sample_sharded": lambda params, data: (
        torch_ops.make_step_functions(reduce_samples=lambda total: total),
        params, data, True, "sample-sharded"),
    # the block's class gives no objective
    "no_block_objective": lambda params, data: (
        torch_ops.make_step_functions(), params, data, False, None),
}


@pytest.mark.parametrize("case", FALLBACKS)
def test_objective_fn_where_the_block_cannot_give_it(problem, case):
    """cuda_klnmf.klnmf_block gives no kernel block for weighted,
    rank-masked and sample-sharded data, refused for that and not only for
    the CPU, so klnmf_block_builder gives the plain block; the loop then
    calls its objective_fn after every block, as it does after a block
    whose class gives no objective. No block is counted in the kernel."""
    from salamander_tpu_torch.parallel.compaction import lockstep_fit

    params, data = float32_problem(problem, True)
    assert cuda_klnmf.unsupported_reason(data["X"], params["W"],
                                         params["H"], data) == \
        "the tensors are not on a CUDA device"
    (update_fn, objective_fn), params, data, sharded, refusal = \
        FALLBACKS[case](params, data)
    calls, asked, routed = [], [], []

    def make_block(p, d):
        if refusal is None:
            return NoObjectiveBlock(update_fn, d, asked)
        routed.append(cuda_klnmf.klnmf_block(p, d, mask=p.get("mask"),
                                             sample_sharded=sharded))
        return klnmf_block_builder(update_fn, sharded)(p, d)

    if refusal is not None:
        assert refusal in cuda_klnmf.unsupported_reason(
            data["X"], params["W"], params["H"], data,
            mask=params.get("mask"), sample_sharded=sharded)
    (result, _), counts = counter_deltas(lambda: lockstep_fit(
        counting(objective_fn, calls), CONFIGS[0], make_block, params,
        data))
    assert routed == [None] * (refusal is not None)
    blocks = counts["engine.block_evals"]
    assert blocks >= 1 and counts["engine.block_evals_in_kernel"] == 0
    assert asked == []
    assert len(calls) == 2 + blocks
    assert int(result.n_evals.max()) <= blocks


# (dtype, given signatures, ranks, V, D, lanes, the kernel's refusal or
# None where it takes the fit on a card)
ROUTES = {
    "float64": (torch.float64, 0, [5], 96, 192, 20, "float32"),
    "given_signatures": (torch.float32, 1, [5], 96, 192, 20, "given"),
    "rank_above_k_max": (torch.float32, 0, [cuda_klnmf.K_MAX + 8], 96, 192,
                         20, "K_MAX"),
    "shared_memory": (torch.float32, 0, [3], 4096, 20, 1, "shared memory"),
    "pcawg_extract": (torch.float32, 0, range(2, 11), 96, 192, 20, None),
    "cell_7b": (torch.float32, 0, range(2, 11), 96, 200_000, 10, None),
}


def test_the_mark_follows_the_objective():
    """The kernel's block, whose class marks it as giving the objective,
    follows the objective it reproduces: klnmf_block, unsupported_reason
    and extraction._choose_layout give one answer, from one rule. Where
    the kernel refuses a fit (float64, given signatures, K above K_MAX, a
    lane no kernel holds): the plain block and the padded layout, on a
    card or not. At the PCAWG extraction cell's and cell 7b's shapes: the
    grouped layout on a card, and tensors the route refuses for their
    device alone, so on the CPU the plain block and the padded layout."""
    from salamander_tpu_torch import extraction

    for name, (dtype, n_given, ranks, V, D, lanes, refusal) in \
            ROUTES.items():
        for on_card in (True, False):
            layout = extraction._choose_layout(
                "klnmf", dtype, n_given, ranks, V, D,
                "cuda" if on_card else "cpu")
            takes = refusal is None and on_card
            assert layout == ("grouped" if takes else "padded"), name
            assert extraction._choose_layout(
                "mvnmf", dtype, n_given, ranks, V, D,
                "cuda" if on_card else "cpu") == "padded"
            for k in ranks:
                reason = cuda_klnmf.unsupported_fit_reason(
                    {dtype}, on_card, n_given, lanes, V, k, D)
                assert (reason is None) == takes, (name, k)
                if refusal is not None:
                    assert refusal in reason, (name, k)
        for k in ranks:  # the CPU's tensors, as zero-stride views
            params = {"W": torch.zeros((), dtype=dtype).expand(lanes, V, k),
                      "H": torch.zeros((), dtype=dtype).expand(lanes, k, D)}
            data = {"X": torch.zeros((), dtype=dtype).expand(lanes, V, D)}
            reason = cuda_klnmf.unsupported_reason(
                data["X"], params["W"], params["H"], data, n_given)
            if refusal is None:
                assert reason == "the tensors are not on a CUDA device"
            else:
                assert refusal in reason, (name, k)
            assert cuda_klnmf.klnmf_block(params, data, n_given) is None


CPU_REFUSAL = "the tensors are not on a CUDA device"


def lift_the_cpu_refusal(monkeypatch):
    """Let the kernel's route take on the CPU every fit it would take on a
    card: its block (cuda_klnmf.KernelBlock) then runs its plain version
    and gives its objective from the plain ops."""
    for name in ("unsupported_reason", "unsupported_fit_reason"):
        real = getattr(cuda_klnmf, name)

        def refusal(*args, real=real, **kwargs):
            reason = real(*args, **kwargs)
            return None if reason == CPU_REFUSAL else reason

        monkeypatch.setattr(cuda_klnmf, name, refusal)


def small_counts(seed=0, V=12, D=30, K=3):
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(V), size=K).T
    H = rng.gamma(2.0, 40.0, size=(K, D))
    return rng.poisson(W @ H).astype(np.float64) + 1.0


def _klnmf(**kwargs):
    import salamander_tpu_torch as sal

    return sal.KLNMF(n_signatures=3, min_iterations=20, max_iterations=300,
                     tol=1e-6, dtype="float32", device="cpu",
                     **kwargs)


def _frame(X):
    import pandas as pd

    return pd.DataFrame(X.T, index=[f"s{i}" for i in range(X.shape[1])],
                        columns=[f"v{j}" for j in range(X.shape[0])])


def _model_fit(weighted):
    import salamander_tpu_torch as sal

    X = small_counts()
    kwargs = {}
    if weighted:
        kwargs["fitting_kwargs"] = {"weights_kl": np.linspace(
            0.5, 1.5, X.shape[1])}
    model = _klnmf().fit(sal.AnnData(_frame(X)), **kwargs)
    return (np.asarray(model.history["objective_function"]),
            model.asignatures.X)


def _restarts(compact):
    import salamander_tpu_torch as sal

    result = sal.fit_klnmf_restarts(
        small_counts(), 3, 6, seed=0, config=FitConfig(20, 400, 10, 1e-6),
        compact=compact, device="cpu")
    return np.asarray(result.losses), np.asarray(result.n_iterations)


def _best_of():
    import salamander_tpu_torch as sal

    summary = sal.fit_best_of(_klnmf(init_method="random"),
                              sal.AnnData(_frame(small_counts())),
                              n_restarts=4, base_seed=0)
    return summary.losses, summary.history


def _bootstrap():
    import salamander_tpu_torch as sal

    model = _klnmf().fit(sal.AnnData(_frame(small_counts())))
    result = sal.bootstrap_stability(model, n_bootstraps=4, seed=3)
    return result.losses, result.similarities.to_numpy()


def _extract():
    import salamander_tpu_torch as sal

    result = sal.extract_signatures(
        _frame(small_counts()), ranks=[2, 3], n_bootstraps=4, seed=0,
        min_iterations=20, max_iterations=300, tol=1e-6, dtype="float32",
        fit_final=False, device="cpu")
    assert result.layout == "grouped"
    return (result.replicate_losses[2], result.replicate_losses[3],
            result.replicate_iterations[3])


# entry point -> (run, whether its blocks take the kernel's route where
# the kernel runs)
ENTRY_POINTS = {
    "klnmf_fit": (lambda: _model_fit(False), True),
    "klnmf_fit_weighted": (lambda: _model_fit(True), False),
    "fit_klnmf_restarts": (lambda: _restarts(False), True),
    "fit_klnmf_restarts_compacting": (lambda: _restarts(True), True),
    "fit_best_of": (_best_of, True),
    "bootstrap_stability": (_bootstrap, True),
    "extract_signatures": (_extract, True),
}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_every_kernel_block_is_paired_with_its_objective(entry,
                                                         monkeypatch):
    """Every kernel block a public entry point builds runs beside the loop
    objective it reproduces: with the CPU's refusal lifted, the blocks
    klnmf_block gives take their objective from the block (counted in the
    kernel), and the fit ends bit for bit where the plain route ends it. A
    weighted fit keeps the plain block and its own objective."""
    from salamander_tpu_torch import extraction

    run, takes = ENTRY_POINTS[entry]
    with monkeypatch.context() as plain_route:
        plain_route.setattr(extraction, "_choose_layout",
                            lambda *args: "grouped")
        plain, plain_counts = counter_deltas(run)
    lift_the_cpu_refusal(monkeypatch)
    fused, counts = counter_deltas(run)
    assert plain_counts["engine.block_evals_in_kernel"] == 0
    in_kernel = counts["engine.block_evals_in_kernel"]
    assert in_kernel == (counts["engine.block_evals"] if takes else 0)
    assert counts["engine.block_evals"] >= 1
    for got, want in zip(fused, plain):
        np.testing.assert_array_equal(got, want)
