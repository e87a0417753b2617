"""salamander_tpu_torch's ARDNMF against salamander_tpu's at float64 on the
CPU, same numpy inputs: the ops at rtol 1e-12 (both priors, given
columns, lanes), fits with both priors at equal counts and objective rtol
1e-8, the relevance readout and prune, warm-start validation with the same
error text, transform, fit_best_of per lane against the JAX package's and
compacted against monolithic, and the ARD params across engine.transfer."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import datasets as jax_datasets
from salamander_tpu import models as jax_models
from salamander_tpu.ops import ardnmf as J
from salamander_tpu.parallel.multistart import fit_best_of as jax_fit_best_of
from salamander_tpu_torch.engine import params_from_numpy, params_to_numpy
from salamander_tpu_torch.ops import ardnmf as T
from salamander_tpu_torch.parallel import multistart

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 32
PRIORS = ["L1", "L2"]


def t(array):
    return torch.as_tensor(np.array(array, dtype=float))


def close(actual, expected, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol)


@pytest.fixture(scope="module")
def frame():
    return jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]


@pytest.fixture(scope="module")
def planted():
    """A planted rank-3 Poisson cohort (30 channels x 120 samples)."""
    rng = np.random.default_rng(0)
    W = rng.dirichlet(np.full(30, 0.5), size=3).T
    H = rng.gamma(2.0, 1.0, size=(3, 120))
    H *= 20.0 * 30 / (W @ H).mean()
    return rng.poisson(W @ H).astype(np.float64).T


@pytest.fixture(scope="module")
def inputs(frame):
    rng = np.random.default_rng(1)
    X = np.ascontiguousarray(frame.to_numpy().T)
    W = rng.dirichlet(np.ones(96), 5).T
    H = rng.uniform(1.0, 200.0, (5, N_SAMPLES))
    lam = rng.uniform(0.5, 5.0, 5)
    return X, W, H, lam, np.array([5.0, 3.0])


def test_synthetic_catalog_is_bit_equal_to_jax():
    """The planted-rank catalog of the rank-inference cell, the same bits
    in both packages (with its truth)."""
    for kwargs in (dict(), dict(n_signatures=5, mean_mutations=800.0,
                                seed=3)):
        X = port.datasets.synthetic_catalog(96, 300, **kwargs)
        assert X.shape == (96, 300) and X.dtype == np.float64
        np.testing.assert_array_equal(
            X, jax_datasets.synthetic_catalog(96, 300, **kwargs))
    truth_t = port.datasets.synthetic_catalog(32, 50, return_truth=True)
    truth_j = jax_datasets.synthetic_catalog(32, 50, return_truth=True)
    for ours, theirs in zip(truth_t, truth_j):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("prior", PRIORS)
def test_ops_match_jax(inputs, prior):
    X, W, H, lam, ab = inputs
    args_j, args_t = (X, W, H, lam), (t(X), t(W), t(H), t(lam))
    close(T.update_H(*args_t, prior), J.update_H(*args_j, prior))
    for n_given in (0, 2, 5):
        close(T.update_W(*args_t, prior, n_given),
              J.update_W(*args_j, prior, n_given))
        for a, b in zip(T.init_params(t(W), t(H), t(ab), prior, n_given)
                        .values(),
                        J.init_params(W, H, ab, prior, n_given).values()):
            close(a, b)
    close(T.update_lambda(t(W), t(H), t(ab), prior),
          J.update_lambda(W, H, ab, prior))
    close(T.ard_objective(*args_t, t(ab), prior),
          J.ard_objective(*args_j, ab, prior))
    for a, b in zip(T.update_whl(*args_t, t(ab), prior, 1),
                    J.update_whl(*args_j, ab, prior, 1)):
        close(a, b)
    update_t, objective_t = T.make_step_functions(prior)
    update_j, objective_j = J.make_step_functions(prior)
    params = {"W": W, "H": H, "lam": lam}
    out_t = update_t({k: t(v) for k, v in params.items()},
                     {"X": t(X), "ard_ab": t(ab)})
    out_j = update_j(params, {"X": X, "ard_ab": ab})
    for key in params:
        close(out_t[key], out_j[key])
    close(objective_t(out_t, {"X": t(X), "ard_ab": t(ab)}),
          objective_j(out_j, {"X": X, "ard_ab": ab}))
    close(T.relevance_excess(lam, ab, prior, 96, N_SAMPLES),
          J.relevance_excess(lam, ab, prior, 96, N_SAMPLES))
    np.testing.assert_array_equal(
        T.active_components(lam, ab, prior, 96, N_SAMPLES, 0.5),
        J.active_components(lam, ab, prior, 96, N_SAMPLES, 0.5))
    assert T.default_b(prior, 7.5, 5, 3.5) == J.default_b(prior, 7.5, 5, 3.5)


def test_ops_batch_over_lanes(inputs):
    """Three restart lanes in one call equal the lanes one by one."""
    X, W, H, lam, ab = inputs
    scales = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    Ws = t(W) * scales[:, None, None]
    Hs = t(H) / scales[:, None, None]
    lams = t(lam) * scales[:, None]
    for prior in PRIORS:
        batched = T.update_whl(t(X), Ws, Hs, lams, t(ab), prior)
        objective = T.ard_objective(t(X), Ws, Hs, lams, t(ab), prior)
        init = T.init_params(Ws, Hs, t(ab), prior)
        for i in range(3):
            single = T.update_whl(t(X), Ws[i], Hs[i], lams[i], t(ab), prior)
            for a, b in zip(batched, single):
                close(a[i], b)
            close(objective[i],
                  T.ard_objective(t(X), Ws[i], Hs[i], lams[i], t(ab), prior))
            for key, value in T.init_params(Ws[i], Hs[i], t(ab),
                                            prior).items():
                close(init[key][i], value)


def test_errors_match_jax():
    for call in (lambda ops: ops.prior_constant("L3", 3, 4, 1.0),
                 lambda ops: ops.default_b("L1", 1.0, 3, 2.0),
                 lambda ops: ops.default_b("L2", 1.0, 3, 1.0),
                 lambda ops: ops.make_step_functions("L0")):
        with pytest.raises(ValueError) as port_error:
            call(T)
        with pytest.raises(ValueError) as jax_error:
            call(J)
        assert str(port_error.value) == str(jax_error.value)
    for kwargs in (dict(prior="L3"), dict(a=0.0), dict(b=-1.0)):
        with pytest.raises(ValueError) as port_error:
            port.ARDNMF(device="cpu", **kwargs)
        with pytest.raises(ValueError) as jax_error:
            jax_models.ARDNMF(**kwargs)
        assert str(port_error.value) == str(jax_error.value)


def fit_both(X, prior, **hyper):
    hyper = dict(dict(n_signatures=6, prior=prior, min_iterations=100,
                      max_iterations=1500, tol=1e-6), **hyper)
    model_j = jax_models.ARDNMF(**hyper)
    model_j.fit(jax_containers.AnnData(X.copy()), init_kwargs={"seed": 1})
    model_t = port.ARDNMF(device="cpu", **hyper)
    model_t.fit(port.AnnData(X.copy()), init_kwargs={"seed": 1})
    return model_j, model_t


@pytest.fixture(scope="module", params=PRIORS)
def fitted(request, planted):
    return fit_both(planted, request.param)


def test_fit_matches_jax(fitted):
    model_j, model_t = fitted
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=RTOL)
    assert model_t.b_resolved_ == model_j.b_resolved_
    close(model_t.lambdas, model_j.lambdas, rtol=1e-6)
    close(model_t.relevance, model_j.relevance, rtol=1e-6)
    close(model_t.objective_function(), model_j.objective_function(),
          rtol=RTOL)


def test_relevance_readout_and_prune_match_jax(fitted):
    model_j, model_t = fitted
    # a threshold between the second- and third-weakest components, so the
    # prune below drops two of them
    ratios = np.sort(model_t.relevance.to_numpy()) / model_t.relevance.max()
    cut = float(np.sqrt(ratios[1] * ratios[2]))
    for tol in (1e-2, cut):
        np.testing.assert_array_equal(model_t.active_signatures_mask(tol),
                                      model_j.active_signatures_mask(tol))
        assert model_t.active_signatures(tol) == \
            model_j.active_signatures(tol)
    assert model_t.n_active_signatures == model_j.n_active_signatures
    for normalize in (True, False):
        pruned_j = jax_models.ARDNMF.__new__(jax_models.ARDNMF)
        pruned_j.__dict__.update(model_j.__dict__)
        pruned_j.asignatures = model_j.asignatures.copy()
        pruned_j.adata = model_j.adata.copy()
        pruned_t = port.ARDNMF.__new__(port.ARDNMF)
        pruned_t.__dict__.update(model_t.__dict__)
        pruned_t.asignatures = model_t.asignatures.copy()
        pruned_t.adata = model_t.adata.copy()
        pruned_j.prune(cut, normalize=normalize)
        pruned_t.prune(cut, normalize=normalize)
        assert pruned_t.n_signatures == pruned_j.n_signatures == 4
        assert pruned_t.signature_names == pruned_j.signature_names
        close(pruned_t.asignatures.X, pruned_j.asignatures.X, rtol=1e-6)
        close(pruned_t.lambdas, pruned_j.lambdas, rtol=1e-6)


def test_warm_start_validation_matches_jax(fitted, planted):
    """The ARD-specific warm-start error (no resolved b) has the JAX
    package's text; a valid warm start continues the fit."""
    model_j, model_t = fitted
    errors = []
    for model in (model_j, model_t):
        b_resolved = model.b_resolved_
        model.b_resolved_ = float("nan")
        with pytest.raises(ValueError) as error:
            model.fit(model.adata, warm_start=True)
        errors.append(str(error.value))
        model.b_resolved_ = b_resolved
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="fitting keyword"):
        port.ARDNMF(device="cpu").fit(port.AnnData(planted.copy()),
                                      fitting_kwargs={"weights_kl": 1.0})


def test_given_signatures_and_transform_match_jax(planted):
    rng = np.random.default_rng(3)
    given = rng.dirichlet(np.ones(30), 1) * 50.0
    models = []
    for package in (jax_models, port):
        container = jax_containers if package is jax_models else port
        kwargs = {} if package is jax_models else {"device": "cpu"}
        model = package.ARDNMF(n_signatures=5, min_iterations=50,
                               max_iterations=600, tol=1e-6, **kwargs)
        model.fit(container.AnnData(planted.copy()), init_kwargs={"seed": 2},
                  given_parameters={
                      "asignatures": container.AnnData(given.copy())})
        models.append(model)
    model_j, model_t = models
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    close(model_t.history["objective_function"],
          model_j.history["objective_function"], rtol=RTOL)
    np.testing.assert_array_equal(model_t.asignatures.X[0], given[0])

    projector_j = model_j.transform(jax_containers.AnnData(planted[:40]))
    projector_t = model_t.transform(port.AnnData(planted[:40].copy()))
    assert projector_t.history["n_iterations"] == \
        projector_j.history["n_iterations"]
    close(projector_t.history["objective_function"],
          projector_j.history["objective_function"], rtol=RTOL)
    np.testing.assert_array_equal(projector_t.asignatures.X,
                                  model_t.asignatures.X)
    assert (projector_t.prior, projector_t.a, projector_t.b) == \
        (model_t.prior, model_t.a, model_t.b)


MS_HYPER = dict(n_signatures=4, init_method="random", min_iterations=30,
                max_iterations=400, tol=1e-4)
R = 6


@pytest.mark.parametrize("prior", PRIORS)
def test_fit_best_of_host_init_matches_jax(frame, prior):
    model_j = jax_models.ARDNMF(prior=prior, **MS_HYPER)
    summary_j = jax_fit_best_of(model_j, jax_containers.AnnData(frame.copy()),
                                R, base_seed=7, batched_init=False)
    model_t = port.ARDNMF(prior=prior, device="cpu", **MS_HYPER)
    summary_t = port.fit_best_of(model_t, port.AnnData(frame.copy()), R,
                                 base_seed=7, batched_init=False)
    np.testing.assert_array_equal(summary_t.n_iterations,
                                  summary_j.n_iterations)
    np.testing.assert_allclose(summary_t.losses, summary_j.losses, rtol=RTOL)
    assert summary_t.best_index == summary_j.best_index
    np.testing.assert_allclose(summary_t.signatures, summary_j.signatures,
                               rtol=1e-6)
    np.testing.assert_array_equal(model_t.active_signatures_mask(),
                                  model_j.active_signatures_mask())


@pytest.mark.parametrize("batched_init", ["auto", False])
def test_fit_best_of_compacted_equals_monolithic(frame, batched_init):
    runs = []
    for compact in (False, True):
        runs.append(port.fit_best_of(
            port.ARDNMF(device="cpu", **MS_HYPER),
            port.AnnData(frame.copy()), R, base_seed=3,
            batched_init=batched_init, compact=compact,
            compact_min_bucket=2))
    mono, packed = runs
    assert len(set(mono.n_iterations.tolist())) > 2
    np.testing.assert_array_equal(mono.losses, packed.losses)
    np.testing.assert_array_equal(mono.n_iterations, packed.n_iterations)
    np.testing.assert_array_equal(mono.signatures, packed.signatures)


def test_device_init_and_transfer(frame):
    """The device init is the batched init_params of random_init_batch
    draws; the ARD params cross engine.transfer both ways."""
    model = port.ARDNMF(device="cpu", **MS_HYPER)
    model._setup_adata(port.AnnData(frame.copy()))
    model._initialize(init_kwargs={"seed": 0})
    _, data = model._device_state()
    params = multistart._device_init_batch(model, data, 4, 5)
    assert set(params) == {"W", "H", "lam"}
    assert params["lam"].shape == (4, 4)
    W0, H0 = port.initialization.random_init_batch(
        torch.Generator().manual_seed(5), data["X"], 4, 4)
    for key, value in T.init_params(W0, H0, data["ard_ab"],
                                    "L1").items():
        assert torch.equal(params[key], value)
    host = params_to_numpy(params)
    back = params_from_numpy(host, device="cpu")
    for key in params:
        assert torch.equal(back[key], params[key])
    state = {k: np.asarray(v) for k, v in model._device_state()[0].items()}
    for key, value in params_from_numpy(state).items():
        np.testing.assert_array_equal(value.numpy(), state[key])
