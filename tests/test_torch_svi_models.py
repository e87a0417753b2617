"""fit_minibatch of the port's KLNMF, CorrNMFDet and MultimodalCorrNMF at
float64 on the CPU: the model API of tests/test_svi.py (containers filled,
trace length, step_freq, given parameters frozen, batch size clamped, the
newton_cg_compat and mesh refusals), and each entry point against the JAX
package at batch_size = n_samples. There every batch is a permutation of
all samples, so the two packages' different samplers change a result only
through the order of float64 sums: traces agree at rtol 1e-8 and
signatures at 1e-6 over 12 steps (both packages draw their CorrNMF
embeddings from numpy's global generator, seeded alike).
"""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import models as jax_models

torch.set_num_threads(1)


def make_synthetic(n_samples=60, n_features=24, n_signatures=3, seed=0):
    rng = np.random.default_rng(seed)
    signatures = rng.dirichlet(np.full(n_features, 0.5), size=n_signatures)
    exposures = rng.gamma(2.0, 50.0, size=(n_samples, n_signatures))
    X = rng.poisson(exposures @ signatures).astype(float)
    X[X == 0] = 1.0
    return X


def mm_counts(seed=0, n_samples=50):
    rng = np.random.default_rng(seed)
    mods = {}
    for name, n_features in (("sbs", 20), ("indel", 12)):
        signatures = rng.dirichlet(np.full(n_features, 0.5), size=2)
        exposures = rng.gamma(2.0, 40.0, size=(n_samples, 2))
        X = rng.poisson(exposures @ signatures).astype(float)
        X[X == 0] = 1.0
        mods[name] = X
    return mods


def mm_data(package, counts):
    return package.MuData({name: package.AnnData(X.copy())
                           for name, X in counts.items()})


def port_mm(**kwargs):
    return port.MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2,
                                  device="cpu", **kwargs)


# --------------------------------------------------------------------- #
# the model API
# --------------------------------------------------------------------- #


def test_fit_minibatch_model_api():
    X = make_synthetic(seed=5)
    model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2, device="cpu")
    np.random.seed(0)
    model.fit_minibatch(port.AnnData(X.copy()), batch_size=20, n_steps=120,
                        eval_freq=30, seed=1, init_kwargs={"seed": 2})
    assert model._is_fitted
    assert len(model.history["objective_function"]) == 4
    assert model.history["n_iterations"] == 120
    assert model.history["step_freq"] == 30
    exposures = model.adata.obsm["exposures"]
    assert exposures.shape == (X.shape[0], 2)
    assert np.all(np.isfinite(exposures))
    np.testing.assert_allclose(model.asignatures.X.sum(axis=1), 1.0,
                               rtol=1e-5)
    fresh = port.CorrNMFDet(n_signatures=2, dim_embeddings=2, device="cpu")
    fresh._setup_adata(port.AnnData(X.copy()))
    np.random.seed(0)
    fresh._initialize(init_kwargs={"seed": 2})
    assert model.objective_function() > fresh.objective_function()
    # the recorded trace ends at the absorbed state's ELBO
    np.testing.assert_allclose(model.history["objective_function"][-1],
                               model.objective_function(), rtol=1e-10)


def test_fit_minibatch_given_parameters_frozen():
    X = make_synthetic(seed=7)
    sig_scalings = np.array([-0.3, 0.4])
    model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2, device="cpu")
    model.fit_minibatch(
        port.AnnData(X.copy()), batch_size=16, n_steps=60, eval_freq=30,
        seed=4, init_kwargs={"seed": 3},
        given_parameters={"signature_scalings": sig_scalings,
                          "variance": 1.7})
    np.testing.assert_array_equal(
        np.asarray(model.asignatures.obs["scalings"], float), sig_scalings)
    assert model.variance == 1.7


def test_fit_minibatch_clamps_default_batch_size():
    """The defaults must work on cohorts smaller than batch_size=128."""
    model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2, device="cpu")
    model.fit_minibatch(port.AnnData(make_synthetic(seed=9)), n_steps=20,
                        eval_freq=10, init_kwargs={"seed": 0})
    assert model._is_fitted
    assert len(model.history["objective_function"]) == 2


def test_fit_minibatch_without_evaluations_records_an_empty_trace():
    model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2, device="cpu")
    model.fit_minibatch(port.AnnData(make_synthetic(seed=6)), batch_size=16,
                        n_steps=20, eval_freq=0, init_kwargs={"seed": 1})
    assert model.history["objective_function"] == []
    assert model.history["n_iterations"] == 20
    assert model.history["step_freq"] == 0


def test_fit_minibatch_rejects_newton_cg_compat():
    model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                            newton_cg_compat=True, device="cpu")
    with pytest.raises(ValueError, match="newton_cg_compat"):
        model.fit_minibatch(port.AnnData(make_synthetic(seed=2)))


def test_mm_fit_minibatch_rejects_newton_cg_compat():
    with pytest.raises(ValueError, match="newton_cg_compat"):
        port_mm(newton_cg_compat=True).fit_minibatch(
            mm_data(port, mm_counts(1)))


MODELS = {
    "klnmf": lambda: port.KLNMF(n_signatures=2, device="cpu"),
    "corrnmf": lambda: port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                                       device="cpu"),
    "mmcorrnmf": port_mm,
}


@pytest.mark.parametrize("family", list(MODELS))
def test_mesh_with_streaming_is_refused_as_in_the_jax_package(family):
    with pytest.raises(ValueError, match="mutually exclusive"):
        MODELS[family]().fit_minibatch(None, streaming=True, mesh=object())


@pytest.mark.parametrize("family", list(MODELS))
def test_mesh_alone_names_the_item_it_waits_for(family):
    with pytest.raises(NotImplementedError, match="item 17"):
        MODELS[family]().fit_minibatch(None, mesh=object())


@pytest.mark.parametrize("family", list(MODELS))
def test_fit_minibatch_without_a_card_needs_device_cpu(family):
    """device=None means the card: without one the constructor raises, so
    no minibatch fit moves to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    constructor = {"klnmf": port.KLNMF, "corrnmf": port.CorrNMFDet,
                   "mmcorrnmf": lambda: port.MultimodalCorrNMF([2, 2])}
    with pytest.raises(ValueError, match="device='cpu'"):
        constructor[family]()


def test_klnmf_fit_minibatch_model_api():
    X = make_synthetic(n_samples=60, n_features=24, seed=8)
    model = port.KLNMF(n_signatures=2, device="cpu")
    model.fit_minibatch(
        port.AnnData(X.copy()), batch_size=20, n_steps=120, eval_freq=30,
        seed=1, init_kwargs={"seed": 2}, fitting_kwargs={"weights_kl": 1.5})
    assert model._is_fitted
    trace = model.history["objective_function"]
    assert len(trace) == 4 and trace[-1] < trace[0]
    assert model.history["step_freq"] == 30
    np.testing.assert_allclose(model.asignatures.X.sum(axis=1), 1.0,
                               rtol=1e-5)
    assert np.all(np.isfinite(model.adata.obsm["exposures"]))
    np.testing.assert_allclose(trace[-1], model.objective_function(),
                               rtol=1e-10)


def test_klnmf_fit_minibatch_given_signatures_frozen():
    X = make_synthetic(n_samples=40, n_features=24, seed=3)
    donor = port.KLNMF(n_signatures=2, device="cpu")
    donor._setup_adata(port.AnnData(X.copy()))
    donor._initialize(init_kwargs={"seed": 7})
    given_sigs = donor.asignatures[:1].copy()
    model = port.KLNMF(n_signatures=3, device="cpu")
    model.fit_minibatch(
        port.AnnData(X.copy()), batch_size=16, n_steps=60, eval_freq=30,
        seed=0, given_parameters={"asignatures": given_sigs},
        init_kwargs={"seed": 4})
    np.testing.assert_array_equal(model.asignatures.X[0], given_sigs.X[0])
    assert not np.array_equal(model.asignatures.X[1], given_sigs.X[0])


def test_klnmf_fit_minibatch_rejects_unknown_fitting_kwargs():
    model = port.KLNMF(n_signatures=2, device="cpu")
    with pytest.raises(ValueError, match="fitting keyword"):
        model.fit_minibatch(port.AnnData(make_synthetic(seed=3)),
                            fitting_kwargs={"weights": 1.0})


def test_mm_fit_minibatch_model_api():
    model = port_mm()
    np.random.seed(0)
    model.fit_minibatch(mm_data(port, mm_counts(3)), batch_size=16,
                        n_steps=150, eval_freq=50, seed=2,
                        init_kwargs={"seed": 1})
    assert model._is_fitted
    hist = model.history["objective_function"]
    assert len(hist) == 3 and np.all(np.isfinite(hist))
    assert hist[-1] > hist[0]
    for name in model.mod_names:
        np.testing.assert_allclose(model.asignatures[name].X.sum(axis=1),
                                   1.0, rtol=1e-5)
        assert model.mdata[name].obsm["exposures"].shape == (50, 2)
    assert model.mdata.obsm["embeddings"].shape == (50, 2)
    np.testing.assert_allclose(hist[-1], model.objective_function(),
                               rtol=1e-10)


def test_mm_fit_minibatch_given_parameters_frozen():
    model = port_mm()
    sig_scalings = np.array([0.25, -0.5])
    model.fit_minibatch(
        mm_data(port, mm_counts(6)), batch_size=16, n_steps=60, eval_freq=30,
        seed=0, init_kwargs={"seed": 8},
        given_parameters={"sbs": {"signature_scalings": sig_scalings}})
    np.testing.assert_array_equal(
        np.asarray(model.asignatures["sbs"].obs["scalings"], float),
        sig_scalings)
    assert not np.array_equal(
        np.asarray(model.asignatures["indel"].obs["scalings"], float),
        sig_scalings)


def test_same_seed_gives_the_same_fit_and_another_seed_another():
    X = make_synthetic(seed=4)

    def fit(seed):
        model = port.KLNMF(n_signatures=2, device="cpu")
        model.fit_minibatch(port.AnnData(X.copy()), batch_size=16,
                            n_steps=30, eval_freq=0, seed=seed,
                            init_kwargs={"seed": 1})
        return model.asignatures.X

    np.testing.assert_array_equal(fit(3), fit(3))
    assert not np.array_equal(fit(3), fit(4))


# --------------------------------------------------------------------- #
# against the JAX package at batch_size = n_samples
# --------------------------------------------------------------------- #

FULL = dict(n_steps=12, eval_freq=3, seed=1)


def assert_same_minibatch_fit(model_j, model_t):
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    assert model_t.history["step_freq"] == model_j.history["step_freq"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=1e-8)


@pytest.mark.parametrize("fitting_kwargs", [
    None, {"weights_kl": 1.5, "weights_lhalf": 0.2}],
    ids=["plain", "weighted"])
def test_klnmf_fit_minibatch_matches_jax_at_full_batch(fitting_kwargs):
    X = make_synthetic(seed=8)
    kwargs = dict(batch_size=X.shape[0], h_inner_iters=2,
                  init_kwargs={"seed": 2}, fitting_kwargs=fitting_kwargs,
                  **FULL)
    model_j = jax_models.KLNMF(n_signatures=3)
    model_j.fit_minibatch(jax_containers.AnnData(X.copy()), **kwargs)
    model_t = port.KLNMF(n_signatures=3, device="cpu")
    model_t.fit_minibatch(port.AnnData(X.copy()), **kwargs)
    assert_same_minibatch_fit(model_j, model_t)
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=1e-8)
    np.testing.assert_allclose(model_t.adata.obsm["exposures"],
                               model_j.adata.obsm["exposures"], rtol=1e-8)


@pytest.mark.parametrize("given", [
    None, {"signature_scalings": np.array([0.1, -0.2, 0.3]),
           "variance": 1.3}],
    ids=["free", "given"])
def test_corrnmf_fit_minibatch_matches_jax_at_full_batch(given):
    X = make_synthetic(seed=5)
    kwargs = dict(batch_size=X.shape[0], delay=2.0,
                  init_kwargs={"seed": 2}, given_parameters=given, **FULL)
    np.random.seed(3)
    model_j = jax_models.CorrNMFDet(n_signatures=3, dim_embeddings=2)
    model_j.fit_minibatch(jax_containers.AnnData(X.copy()), **kwargs)
    np.random.seed(3)
    model_t = port.CorrNMFDet(n_signatures=3, dim_embeddings=2, device="cpu")
    model_t.fit_minibatch(port.AnnData(X.copy()), **kwargs)
    assert_same_minibatch_fit(model_j, model_t)
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=1e-6)
    np.testing.assert_allclose(model_t.adata.obsm["exposures"],
                               model_j.adata.obsm["exposures"], rtol=1e-5)
    np.testing.assert_allclose(model_t.variance, model_j.variance, rtol=1e-6)
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=1e-8)


def test_mm_fit_minibatch_matches_jax_at_full_batch():
    counts = mm_counts(3)
    kwargs = dict(batch_size=50, delay=2.0, init_kwargs={"seed": 1}, **FULL)
    np.random.seed(4)
    model_j = jax_models.MultimodalCorrNMF(ns_signatures=[2, 2],
                                           dim_embeddings=2)
    model_j.fit_minibatch(mm_data(jax_containers, counts), **kwargs)
    np.random.seed(4)
    model_t = port_mm()
    model_t.fit_minibatch(mm_data(port, counts), **kwargs)
    assert_same_minibatch_fit(model_j, model_t)
    for name in model_t.mod_names:
        np.testing.assert_allclose(model_t.asignatures[name].X,
                                   model_j.asignatures[name].X, rtol=1e-6)
        np.testing.assert_allclose(
            model_t.mdata[name].obsm["exposures"],
            model_j.mdata[name].obsm["exposures"], rtol=1e-5)
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=1e-8)
