"""MvNMF through the public API of both packages on a PCAWG SBS
sub-catalog, at float64: salamander_tpu_torch's MvNMF.fit, transform and
single-step helpers against salamander_tpu's on the same inputs, with
equal iteration counts, histories at rtol 1e-8 and equal gamma; and a JAX
fit's parameters, gamma included, carried into the port."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import datasets as jax_datasets
from salamander_tpu.models import MvNMF as JaxMvNMF
from salamander_tpu_torch.engine import params_from_numpy
from salamander_tpu_torch.models import MvNMF

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 32
HYPER = dict(n_signatures=3, min_iterations=40, max_iterations=400,
             tol=1e-5)


@pytest.fixture(scope="module")
def catalog():
    return jax_datasets.load_pcawg_sbs()


def containers_of(frame):
    return (jax_containers.AnnData(frame.copy()), port.AnnData(frame.copy()))


def assert_same_fit(model_t, model_j, rtol=RTOL):
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=rtol)
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=rtol)
    np.testing.assert_allclose(model_t.adata.obsm["exposures"],
                               model_j.adata.obsm["exposures"], rtol=rtol)
    assert model_t._gamma == model_j._gamma


@pytest.mark.parametrize("lam, delta, seed", [(1.0, 1.0, 3), (0.5, 2.0, 4)])
def test_fit_matches_jax(catalog, lam, delta, seed):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    hyper = dict(HYPER, init_method="random", lam=lam, delta=delta)
    model_j = JaxMvNMF(**hyper).fit(adata_j, init_kwargs={"seed": seed})
    model_t = MvNMF(device="cpu", **hyper).fit(adata_t,
                                               init_kwargs={"seed": seed})
    assert model_t.history["n_iterations"] < HYPER["max_iterations"]
    assert_same_fit(model_t, model_j)
    assert model_t.history["tol_effective"] == \
        model_j.history["tol_effective"]
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=RTOL)
    np.testing.assert_allclose(model_t.reconstruction_error,
                               model_j.reconstruction_error, rtol=RTOL)


def test_fit_with_given_signatures_matches_jax(catalog):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    spectra = catalog.iloc[N_SAMPLES:N_SAMPLES + 1]
    given_j, given_t = containers_of(
        spectra / spectra.sum(axis=1).to_numpy()[:, None])
    hyper = dict(HYPER, init_method="random")
    model_j = JaxMvNMF(**hyper).fit(
        adata_j, given_parameters={"asignatures": given_j},
        init_kwargs={"seed": 4})
    model_t = MvNMF(device="cpu", **hyper).fit(
        adata_t, given_parameters={"asignatures": given_t},
        init_kwargs={"seed": 4})
    assert_same_fit(model_t, model_j)
    assert np.array_equal(model_t.asignatures.X[:1], given_t.X)


def test_trial_batch_fit_matches_jax(catalog):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    hyper = dict(HYPER, init_method="random", max_iterations=120)
    model_j = JaxMvNMF(**hyper)
    model_t = MvNMF(device="cpu", **hyper)
    model_j._line_search_trial_batch = model_t._line_search_trial_batch = 4
    model_j.fit(adata_j, init_kwargs={"seed": 6})
    model_t.fit(adata_t, init_kwargs={"seed": 6})
    assert_same_fit(model_t, model_j)


def test_transform_matches_jax(catalog):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    hyper = dict(HYPER, init_method="random", lam=0.5)
    fitted_j = JaxMvNMF(**hyper).fit(adata_j, init_kwargs={"seed": 2})
    fitted_t = MvNMF(device="cpu", **hyper).fit(adata_t,
                                                init_kwargs={"seed": 2})
    new_j, new_t = containers_of(catalog.iloc[N_SAMPLES:N_SAMPLES + 16])
    projector_j = fitted_j.transform(new_j)
    projector_t = fitted_t.transform(new_t)
    assert projector_t.lam == 0.5 and projector_t.device == fitted_t.device
    np.testing.assert_allclose(projector_t.adata.obsm["exposures"],
                               projector_j.adata.obsm["exposures"],
                               rtol=RTOL)
    assert np.array_equal(projector_t.asignatures.X, fitted_t.asignatures.X)


def test_single_step_helpers_match_jax(catalog):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    models = []
    for cls, adata, device in ((JaxMvNMF, adata_j, {}),
                               (MvNMF, adata_t, {"device": "cpu"})):
        model = cls(n_signatures=2, init_method="random", **device)
        model._setup_adata(adata)
        model._initialize(init_kwargs={"seed": 1})
        model._setup_fitting_parameters()
        models.append(model)
    model_j, model_t = models
    for _ in range(3):
        for model in models:
            model._update_H()
            model._update_W()
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=RTOL)
    np.testing.assert_allclose(model_t.adata.obsm["exposures"],
                               model_j.adata.obsm["exposures"], rtol=RTOL)
    assert model_t._gamma == model_j._gamma
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=RTOL)


def test_jax_state_with_gamma_carries_into_the_port(catalog):
    """A JAX fit stopped early hands its engine params, gamma included, to
    the port through engine.transfer.params_from_numpy; the port's steps
    from there equal the JAX package's."""
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    model_j = JaxMvNMF(n_signatures=3, init_method="random",
                       min_iterations=30, max_iterations=30)
    model_j.fit(adata_j, init_kwargs={"seed": 9})
    params_j, data_j = model_j._device_state()
    params_j = {key: np.asarray(leaf) for key, leaf in params_j.items()}
    params_j["gamma"] = np.asarray(0.64)  # a mid-fit gamma
    params_t = params_from_numpy(params_j, device="cpu",
                                 dtype=torch.float64)
    assert params_t["gamma"].dim() == 0
    model_t = MvNMF(n_signatures=3, device="cpu")
    update_t, _ = model_t._build_step()
    update_j, _ = model_j._build_step()
    X = np.array(data_j["X"])
    for _ in range(5):
        params_t = update_t(params_t, {"X": torch.as_tensor(X)})
        params_j = update_j(params_j, {"X": X})
    for key in ("W", "H", "gamma"):
        np.testing.assert_allclose(params_t[key].numpy(),
                                   np.asarray(params_j[key]), rtol=RTOL)


def test_warm_start_resets_gamma(catalog):
    _, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    model = MvNMF(device="cpu", init_method="random", **HYPER)
    model.fit(adata_t, init_kwargs={"seed": 3})
    model._gamma = 0.25
    model.fit(adata_t, warm_start=True)
    assert model.history["n_iterations"] >= HYPER["min_iterations"]
    assert 0.0 < model._gamma <= 1.0


def test_float32_fit_stays_float32(catalog):
    _, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    model = MvNMF(device="cpu", dtype="float32", init_method="random",
                  n_signatures=2, min_iterations=20, max_iterations=60)
    model._setup_adata(adata_t)
    model._initialize(init_kwargs={"seed": 0})
    model._setup_fitting_parameters()
    params, _ = model._device_state()
    assert params["gamma"].dtype == torch.float32
    model.fit(adata_t, init_kwargs={"seed": 0})
    assert model.history["tol_effective"] > HYPER["tol"] / 100
    assert np.isfinite(model.asignatures.X).all()
    np.testing.assert_allclose(model.asignatures.X.sum(axis=1), 1.0,
                               rtol=1e-5)
