"""KLNMF through the public API of both packages on a PCAWG SBS
sub-catalog, at float64: salamander_tpu_torch's KLNMF.fit, transform and
multi-start runner against salamander_tpu's on the same inputs, with equal
iteration counts and parameters and histories at rtol 1e-8; and a fit
carried from the JAX package into the port mid-way."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import datasets as jax_datasets
from salamander_tpu.engine import FitConfig as JaxFitConfig
from salamander_tpu.models import KLNMF as JaxKLNMF
from salamander_tpu.parallel.restarts import (
    build_klnmf_restart_runner as jax_restart_runner,
)
from salamander_tpu_torch.engine import params_from_numpy, params_to_numpy
from salamander_tpu_torch.models.signature_nmf import resolve_device

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 48
HYPER = dict(n_signatures=3, min_iterations=50, max_iterations=400, tol=1e-5)


@pytest.fixture(scope="module")
def catalog():
    return jax_datasets.load_pcawg_sbs()


def containers_of(frame):
    return (jax_containers.AnnData(frame.copy()),
            port.AnnData(frame.copy()))


def assert_same_fit(model_t, model_j, rtol=RTOL):
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    assert len(model_t.history["objective_function"]) == \
        len(model_j.history["objective_function"])
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=rtol)
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=rtol)
    np.testing.assert_allclose(model_t.adata.obsm["exposures"],
                               model_j.adata.obsm["exposures"], rtol=rtol)
    assert list(model_t.signature_names) == list(model_j.signature_names)


def test_port_defaults_to_float64_on_the_cpu():
    model = port.KLNMF(n_signatures=2, device="cpu")
    assert model.device.type == "cpu" and model.dtype == "float64"
    assert port.KLNMF(n_signatures=2, device="cpu",
                      dtype="float32").dtype == "float32"
    with pytest.raises(ValueError, match="Unsupported"):
        port.KLNMF(n_signatures=2, device="cpu", dtype="float16")


@pytest.mark.parametrize("call", [
    lambda: resolve_device(None),
    lambda: port.KLNMF(2),
    lambda: port.fit_klnmf_restarts(np.ones((4, 6)), 2, 2),
])
def test_no_device_without_a_card_raises(monkeypatch, call):
    """device=None never means the CPU: without a card it asks for
    device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="pass device='cpu'"):
        call()


def test_resolve_device_takes_the_card_or_what_it_is_given(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert port.KLNMF(2, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None).type == "cuda"


# flat starts every signature equal: a saddle whose symmetry the last bit
# of a sum breaks differently in each package, so it is exercised only
# where the signatures are given (transform)
@pytest.mark.parametrize("init_method, converges", [
    ("nndsvd", False), ("nndsvda", False), ("custom", False),
    ("random", True),
])
def test_fit_matches_jax(catalog, init_method, converges):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    init_kwargs = None
    if init_method == "custom":
        rng = np.random.default_rng(11)
        init_kwargs = {
            "signatures_mat": rng.dirichlet(np.ones(96), 3),
            "exposures_mat": rng.uniform(10.0, 500.0, (N_SAMPLES, 3)),
        }
    elif init_method == "random":
        init_kwargs = {"seed": 4}
    model_j = JaxKLNMF(init_method=init_method, **HYPER).fit(
        adata_j, init_kwargs=init_kwargs)
    model_t = port.KLNMF(init_method=init_method, device="cpu",
                         **HYPER).fit(adata_t, init_kwargs=init_kwargs)
    assert_same_fit(model_t, model_j)
    assert model_t.history["tol_effective"] == \
        model_j.history["tol_effective"]
    np.testing.assert_allclose(model_t.reconstruction_error,
                               model_j.reconstruction_error, rtol=RTOL)
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=RTOL)


@pytest.mark.parametrize("case", ["given_signatures", "weights_kl",
                                  "weights_lhalf"])
def test_fit_options_match_jax(catalog, case):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    given_parameters = fitting_kwargs = None
    if case == "given_signatures":
        # two signatures from normalized sample spectra, frozen in the fit
        spectra = catalog.iloc[N_SAMPLES:N_SAMPLES + 2]
        given_j, given_t = containers_of(spectra / spectra.sum(axis=1)
                                         .to_numpy()[:, None])
        given_parameters = ({"asignatures": given_j},
                            {"asignatures": given_t})
    elif case == "weights_kl":
        weights = np.random.default_rng(5).uniform(0.5, 2.0, N_SAMPLES)
        fitting_kwargs = {"weights_kl": weights}
    else:
        fitting_kwargs = {"weights_lhalf": 30.0}
    given_j, given_t = given_parameters or (None, None)
    init_kwargs = {"seed": 2}
    model_j = JaxKLNMF(init_method="random", **HYPER).fit(
        adata_j, given_parameters=given_j, init_kwargs=init_kwargs,
        fitting_kwargs=fitting_kwargs)
    model_t = port.KLNMF(init_method="random", device="cpu", **HYPER).fit(
        adata_t, given_parameters=given_t, init_kwargs=init_kwargs,
        fitting_kwargs=fitting_kwargs)
    assert_same_fit(model_t, model_j)
    if case == "given_signatures":  # the same bits in both packages
        assert np.array_equal(model_t.asignatures.X[:2],
                              model_j.asignatures.X[:2])


def test_transform_matches_jax(catalog):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    model_j = JaxKLNMF(init_method="random", **HYPER).fit(
        adata_j, init_kwargs={"seed": 3})
    model_t = port.KLNMF(init_method="random", device="cpu", **HYPER).fit(
        adata_t, init_kwargs={"seed": 3})
    new_j, new_t = containers_of(catalog.iloc[N_SAMPLES:N_SAMPLES + 20])
    projected_j = model_j.transform(new_j)
    projected_t = model_t.transform(new_t)
    assert_same_fit(projected_t, projected_j, rtol=1e-7)
    assert np.array_equal(projected_t.asignatures.X, model_t.asignatures.X)


def test_restart_runner_matches_jax(catalog):
    X = np.ascontiguousarray(catalog.iloc[:N_SAMPLES].to_numpy().T,
                             dtype=float)
    rng = np.random.default_rng(9)
    W0 = np.ascontiguousarray(rng.dirichlet(np.ones(96), (4, 3))
                              .transpose(0, 2, 1))
    H0 = rng.uniform(10.0, 500.0, (4, 3, N_SAMPLES))
    config = (50, 400, 10, 1e-4)
    params_j, losses_j, n_iter_j = jax_restart_runner(JaxFitConfig(*config))(
        {"W": W0, "H": H0}, {"X": X})
    params_t, losses_t, n_iter_t = port.build_klnmf_restart_runner(
        port.FitConfig(*config))(params_from_numpy({"W": W0, "H": H0}),
                                 {"X": torch.from_numpy(X)})
    assert np.array_equal(n_iter_t.numpy(), np.asarray(n_iter_j))
    assert len(set(n_iter_t.tolist())) > 1
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=RTOL)
    for key in ("W", "H"):
        np.testing.assert_allclose(params_t[key].numpy(),
                                   np.asarray(params_j[key]), rtol=RTOL)


def test_fit_klnmf_restarts_on_cpu(catalog):
    X = catalog.iloc[:N_SAMPLES].to_numpy().T
    result = port.fit_klnmf_restarts(
        X, 3, 4, seed=1, config=port.FitConfig(20, 60, 10, 1e-6),
        dtype=torch.float64, device="cpu")
    assert result.W.shape == (4, 96, 3) and result.H.shape == (4, 3, 48)
    assert result.best_loss == result.losses.min()
    np.testing.assert_allclose(result.best_W.sum(axis=0), 1.0, rtol=1e-12)
    # lane compaction is ported: the same lanes; a mesh must be a mesh
    packed = port.fit_klnmf_restarts(
        X, 3, 4, seed=1, config=port.FitConfig(20, 60, 10, 1e-6),
        dtype=torch.float64, device="cpu", compact=True,
        compact_min_bucket=1)
    np.testing.assert_array_equal(packed.losses, result.losses)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.fit_klnmf_restarts(X, 3, 4, mesh=object(), device="cpu")


def test_fit_carried_from_jax_continues_like_jax(catalog):
    """Run the JAX package for 100 iterations, carry its parameters into
    the port, and continue there: the same as the JAX package continuing."""
    hyper = dict(HYPER, min_iterations=10, max_iterations=100)
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    model_j = JaxKLNMF(init_method="nndsvda", **hyper).fit(adata_j)

    params = params_from_numpy(
        {"W": model_j.asignatures.X.T, "H": model_j.adata.obsm["exposures"].T},
        device="cpu", dtype=torch.float64,
    )
    model_t = port.KLNMF(init_method="nndsvda", device="cpu", **hyper)
    model_t._setup_adata(adata_t)
    model_t.asignatures = port.AnnData(np.zeros((3, 96)))
    model_t.asignatures.var_names = adata_t.var_names
    model_t.asignatures.obs_names = model_j.signature_names
    model_t._absorb_params(params_to_numpy(params))

    model_j.fit(adata_j, warm_start=True)
    model_t.fit(adata_t, warm_start=True)
    assert_same_fit(model_t, model_j)


def test_container_views_match_jax(catalog):
    adata_j, adata_t = containers_of(catalog.iloc[:N_SAMPLES])
    hyper = dict(HYPER, max_iterations=60)
    model_j = JaxKLNMF(init_method="nndsvd", **hyper).fit(adata_j)
    model_t = port.KLNMF(init_method="nndsvd", device="cpu",
                         **hyper).fit(adata_t)
    for view in ("signatures", "exposures", "data_reconstructed"):
        frame_t, frame_j = getattr(model_t, view), getattr(model_j, view)
        assert list(frame_t.index) == list(frame_j.index)
        assert list(frame_t.columns) == list(frame_j.columns)
        np.testing.assert_allclose(frame_t.to_numpy(), frame_j.to_numpy(),
                                   rtol=RTOL)
    assert model_t.mutation_types == list(model_j.mutation_types)
    assert model_t.sample_names == list(model_j.sample_names)


def test_utils_match_jax(catalog):
    from salamander_tpu import utils as jax_utils
    from salamander_tpu_torch import utils

    signatures = catalog.iloc[:5] / catalog.iloc[:5].sum(axis=1).to_numpy()[
        :, None]
    shuffled = signatures.iloc[[3, 0, 4, 1, 2]]
    order = utils.match_signatures_pair(signatures, shuffled)
    assert np.array_equal(order, jax_utils.match_signatures_pair(signatures,
                                                                 shuffled))
    assert np.array_equal(shuffled.to_numpy()[order], signatures.to_numpy())
    matched = utils.match_to_catalog(shuffled, signatures)
    assert list(matched.index) == list(shuffled.index)
    W = np.random.default_rng(0).uniform(size=(96, 3))
    H = np.random.default_rng(1).uniform(size=(3, 8))
    for got, want in zip(utils.normalize_WH(W, H),
                         jax_utils.normalize_WH(W, H)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case, error", [
    ("warm_start_unfitted", ValueError),
    ("warm_start_given", ValueError),
    ("mesh", TypeError),
    ("negative_weights", ValueError),
], ids=["warm_start_unfitted-ValueError", "warm_start_given-ValueError",
        "mesh-NotImplementedError", "negative_weights-ValueError"])
def test_fit_refuses(catalog, case, error):
    _, adata = containers_of(catalog.iloc[:8])
    model = port.KLNMF(n_signatures=2, device="cpu", max_iterations=20)
    kwargs = {
        "warm_start_unfitted": {"warm_start": True},
        "warm_start_given": {"warm_start": True, "given_parameters": {
            "asignatures": adata[:1, :].copy()}},
        "mesh": {"mesh": object()},
        "negative_weights": {"fitting_kwargs": {"weights_kl": -1.0}},
    }[case]
    with pytest.raises(error):
        model.fit(adata, **kwargs)
