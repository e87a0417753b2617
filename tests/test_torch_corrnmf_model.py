"""salamander_tpu_torch's CorrNMFDet against salamander_tpu's at float64 on
the CPU, same numpy inits (the global numpy RNG seeds the embeddings in
both): fit, transform, a given-parameters fit and the newton_cg_compat host
loop at equal iteration counts and ELBO rtol 1e-8; the eager EM cycle; the
container surface; fit_best_of per lane against the JAX package's and
compacted against monolithic; and the CorrNMF params across
engine.transfer in both directions."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import datasets as jax_datasets
from salamander_tpu import models as jax_models
from salamander_tpu.initialization import initialize as jax_initialize
from salamander_tpu.parallel.multistart import fit_best_of as jax_fit_best_of
from salamander_tpu_torch.engine import params_from_numpy, params_to_numpy
from salamander_tpu_torch.initialization import initialize as port_initialize
from salamander_tpu_torch.ops import corrnmf as port_ops
from salamander_tpu_torch.parallel import multistart

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 32
HYPER = dict(n_signatures=2, dim_embeddings=2, min_iterations=50,
             max_iterations=200, tol=1e-6)


@pytest.fixture(scope="module")
def frame():
    return jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]


@pytest.fixture(scope="module")
def new_frame():
    return jax_datasets.load_pcawg_sbs().iloc[N_SAMPLES:N_SAMPLES + 16]


def fit_both(frame, seed=0, hyper=HYPER, **fit_kwargs):
    """The same fit in both packages from the same numpy seed."""
    np.random.seed(seed)
    model_j = jax_models.CorrNMFDet(**hyper)
    model_j.fit(jax_containers.AnnData(frame.copy()), **fit_kwargs)
    np.random.seed(seed)
    model_t = port.CorrNMFDet(device="cpu", **hyper)
    model_t.fit(port.AnnData(frame.copy()), **fit_kwargs)
    return model_j, model_t


def assert_same_fit(model_j, model_t, rtol=RTOL):
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=rtol)
    assert model_t.history["tol_effective"] == \
        model_j.history["tol_effective"]
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=1e-5)
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=rtol)


@pytest.fixture(scope="module")
def fitted(frame):
    return fit_both(frame)


@pytest.mark.parametrize("method", ["nndsvd", "random"])
def test_initialize_corrnmf_draws_equal_jax(frame, method):
    """The host initializer draws the same signatures and embeddings from
    the same global numpy seed in both packages."""
    outs = []
    for initialize, containers in ((jax_initialize, jax_containers),
                                   (port_initialize, port)):
        adata = containers.AnnData(frame.copy())
        np.random.seed(6)
        asignatures, variance = initialize.initialize_corrnmf(
            adata, 3, 2, method=method, seed=1)
        outs.append((asignatures, adata, variance))
    (sig_j, adata_j, var_j), (sig_t, adata_t, var_t) = outs
    np.testing.assert_array_equal(sig_t.X, sig_j.X)
    np.testing.assert_array_equal(sig_t.obsm["embeddings"],
                                  sig_j.obsm["embeddings"])
    np.testing.assert_array_equal(adata_t.obsm["embeddings"],
                                  adata_j.obsm["embeddings"])
    np.testing.assert_array_equal(adata_t.obs["scalings"],
                                  adata_j.obs["scalings"])
    assert var_t == var_j == 1.0


@pytest.mark.parametrize("given", [
    {"variance": -1.0},
    {"signature_scalings": np.zeros(4)},
    {"sample_embeddings": np.zeros((N_SAMPLES, 3))},
    {"unknown": 1},
], ids=["variance", "scalings-shape", "embeddings-shape", "unknown-key"])
def test_given_parameter_checks_match_jax(frame, given):
    errors = []
    for initialize, containers in ((jax_initialize, jax_containers),
                                   (port_initialize, port)):
        with pytest.raises((ValueError, TypeError)) as error:
            initialize.check_given_parameters_corrnmf(
                containers.AnnData(frame.copy()), 3, 2, given)
        errors.append((type(error.value), str(error.value)))
    assert errors[0] == errors[1]


def test_fit_matches_jax(fitted):
    model_j, model_t = fitted
    assert_same_fit(model_j, model_t)
    trace = np.asarray(model_t.history["objective_function"])
    assert np.all(np.diff(trace) >= -1e-8 * np.abs(trace[:-1]))
    assert model_t.exposures.shape == (N_SAMPLES, 2)
    assert model_t.variance > 0 and model_t._is_fitted


def test_eager_cycle_matches_jax(frame):
    """One reference-order EM cycle through the eager per-update methods
    (host float64) against the JAX package's."""
    models = []
    for package, container in ((jax_models, jax_containers), (port, port)):
        kwargs = {} if package is jax_models else {"device": "cpu"}
        model = package.CorrNMFDet(**HYPER, **kwargs)
        model._setup_adata(container.AnnData(frame.copy()))
        np.random.seed(4)
        model._initialize()
        model._update_parameters()
        models.append(model)
    model_j, model_t = models
    for getter in (lambda m: m.asignatures.X,
                   lambda m: m.asignatures.obs["scalings"],
                   lambda m: m.adata.obs["scalings"],
                   lambda m: m.asignatures.obsm["embeddings"],
                   lambda m: m.adata.obsm["embeddings"],
                   lambda m: m.variance):
        np.testing.assert_allclose(np.asarray(getter(model_t), dtype=float),
                                   np.asarray(getter(model_j), dtype=float),
                                   rtol=1e-7, atol=1e-9)


def test_transform_matches_jax(fitted, new_frame):
    """Both projectors start from the same fitted signature side (the JAX
    model's, copied into the port model) and the same seed."""
    model_j, model_t = fitted
    params = model_j._device_state()[0]
    model_t._absorb_params({k: np.asarray(v) for k, v in params.items()})
    np.random.seed(9)
    projector_j = model_j.transform(jax_containers.AnnData(new_frame.copy()))
    np.random.seed(9)
    projector_t = model_t.transform(port.AnnData(new_frame.copy()))
    assert_same_fit(projector_j, projector_t)
    np.testing.assert_array_equal(projector_t.asignatures.X,
                                  model_t.asignatures.X)
    assert projector_t.variance == model_t.variance
    assert projector_t.device == model_t.device
    assert projector_t.dtype == model_t.dtype
    with pytest.raises(ValueError, match="given_parameters"):
        model_t.transform(port.AnnData(new_frame.copy()),
                          given_parameters={})
    with pytest.raises(ValueError, match="fitted"):
        port.CorrNMFDet(device="cpu").transform(port.AnnData(new_frame))


def test_given_parameters_fit_matches_jax(frame):
    """One given signature, given signature scalings and variance: frozen
    in both packages, the rest fits to equal counts and ELBO."""
    rng = np.random.default_rng(2)
    given_sig = frame.iloc[:1].to_numpy() / frame.iloc[0].sum()
    given = {
        "signature_scalings": rng.normal(0, 0.3, 2),
        "variance": 0.8,
    }
    hyper = dict(HYPER, max_iterations=100)
    models = []
    for package in (jax_models, port):
        container = jax_containers if package is jax_models else port
        signatures = container.AnnData(given_sig.copy())
        signatures.var_names = list(frame.columns)
        kwargs = {} if package is jax_models else {"device": "cpu"}
        np.random.seed(5)
        model = package.CorrNMFDet(**hyper, **kwargs)
        model.fit(container.AnnData(frame.copy()),
                  given_parameters=dict(given, asignatures=signatures))
        models.append(model)
    model_j, model_t = models
    assert_same_fit(model_j, model_t)
    np.testing.assert_array_equal(model_t.asignatures.X[0], given_sig[0])
    np.testing.assert_array_equal(model_t.asignatures.obs["scalings"],
                                  given["signature_scalings"])
    assert model_t.variance == 0.8


def test_newton_cg_compat_fit_matches_jax(frame):
    """newton_cg_compat=True runs the reference's host loop with scipy's
    Newton-CG per embedding row, in both packages."""
    hyper = dict(HYPER, newton_cg_compat=True, min_iterations=10,
                 max_iterations=20)
    model_j, model_t = fit_both(frame, seed=3, hyper=hyper)
    assert model_t._fits_on_host
    assert_same_fit(model_j, model_t)
    assert model_t.history["tol_effective"] == hyper["tol"]


def test_container_surface_matches_jax(fitted):
    model_j, model_t = fitted
    for data in ("samples", "signatures"):
        model_j.compute_correlation_scaled(data)
        model_t.compute_correlation_scaled(data)
    np.testing.assert_allclose(model_t.adata.obsp["X_correlation"],
                               model_j.adata.obsp["X_correlation"],
                               rtol=1e-6)
    np.testing.assert_allclose(model_t.asignatures.obsp["correlation"],
                               model_j.asignatures.obsp["correlation"],
                               rtol=1e-6)
    model_j.compute_reconstruction_errors()
    model_t.compute_reconstruction_errors()
    np.testing.assert_allclose(model_t.adata.obs["reconstruction_error"],
                               model_j.adata.obs["reconstruction_error"],
                               rtol=1e-6)
    assert model_t.objective == "maximize"
    with pytest.raises(ValueError, match="value of 'data'"):
        model_t.compute_correlation_scaled("both")


def test_warm_start(frame):
    model = port.CorrNMFDet(device="cpu", **dict(HYPER, max_iterations=20,
                                                 min_iterations=10))
    with pytest.raises(ValueError, match="warm_start"):
        model.fit(port.AnnData(frame.copy()), warm_start=True)
    np.random.seed(1)
    adata = port.AnnData(frame.copy())
    model.fit(adata)
    first = model.history["objective_function"][-1]
    model.fit(adata, warm_start=True)
    assert model.history["objective_function"][-1] >= first - 1e-8 * abs(
        first)


@pytest.mark.parametrize("batched", [False, True])
def test_transfer_round_trip(frame, batched):
    """The CorrNMF params dict - 0-d (or per-lane) variance and the bool
    rank/dim masks of a padded state - crosses engine.transfer both ways
    unchanged."""
    np.random.seed(0)
    model = port.CorrNMFDet(device="cpu", **HYPER)
    model._setup_adata(port.AnnData(frame.copy()))
    model._initialize()
    params = port_ops.pad_rank_corrnmf(model._device_state()[0], 4, 3)
    if batched:
        params = {k: torch.stack([v, v]) for k, v in params.items()}
    host = params_to_numpy(params)
    assert host["variance"].shape == ((2,) if batched else ())
    assert host["mask"].dtype == np.bool_ and host["m_mask"].dtype == np.bool_
    back = params_from_numpy(host, device="cpu", dtype=torch.float32)
    for key, value in params.items():
        assert back[key].shape == value.shape
        if value.dtype == torch.bool:
            assert back[key].dtype == torch.bool
            assert torch.equal(back[key], value)
        else:
            assert back[key].dtype == torch.float32
            torch.testing.assert_close(back[key], value.float())
    # a JAX package state (numpy, python float variance) into the port
    model_j = jax_models.CorrNMFDet(**HYPER)
    model_j._setup_adata(jax_containers.AnnData(frame.copy()))
    np.random.seed(0)
    model_j._initialize()
    state_j = {k: np.asarray(v) for k, v in model_j._device_state()[0]
               .items()}
    into_port = params_from_numpy(state_j)
    assert into_port["variance"].dim() == 0
    for key, value in state_j.items():
        np.testing.assert_array_equal(into_port[key].numpy(), value)


MS_HYPER = dict(n_signatures=3, dim_embeddings=2, init_method="random",
                min_iterations=20, max_iterations=150, tol=1e-3)
R = 6


def test_fit_best_of_host_init_matches_jax(frame):
    summary_j = jax_fit_best_of(
        jax_models.CorrNMFDet(**MS_HYPER),
        jax_containers.AnnData(frame.copy()), R, base_seed=7,
        batched_init=False)
    model_t = port.CorrNMFDet(device="cpu", **MS_HYPER)
    summary_t = port.fit_best_of(model_t, port.AnnData(frame.copy()), R,
                                 base_seed=7, batched_init=False)
    np.testing.assert_array_equal(summary_t.n_iterations,
                                  summary_j.n_iterations)
    np.testing.assert_allclose(summary_t.losses, summary_j.losses, rtol=RTOL)
    assert summary_t.best_index == summary_j.best_index
    assert summary_t.signatures.shape == (R, 96, 3)
    np.testing.assert_allclose(summary_t.signatures, summary_j.signatures,
                               rtol=1e-4, atol=1e-9)
    assert model_t.history["multistart_losses"] == summary_t.losses.tolist()


@pytest.mark.parametrize("batched_init", ["auto", False])
def test_fit_best_of_compacted_equals_monolithic(frame, batched_init):
    runs = []
    for compact in (False, True):
        runs.append(port.fit_best_of(
            port.CorrNMFDet(device="cpu", **MS_HYPER),
            port.AnnData(frame.copy()), R, base_seed=3,
            batched_init=batched_init, compact=compact,
            compact_min_bucket=2))
    mono, packed = runs
    if batched_init == "auto":
        assert len(set(mono.n_iterations.tolist())) > 2  # lanes stop apart
    np.testing.assert_array_equal(mono.losses, packed.losses)
    np.testing.assert_array_equal(mono.n_iterations, packed.n_iterations)
    np.testing.assert_array_equal(mono.signatures, packed.signatures)


def test_device_init_batch(frame):
    model = port.CorrNMFDet(device="cpu", **MS_HYPER)
    model._setup_adata(port.AnnData(frame.copy()))
    model._initialize()
    _, data = model._device_state()
    params = multistart._device_init_batch(model, data, 4, 11)
    again = multistart._device_init_batch(model, data, 4, 11)
    assert params["signatures"].shape == (4, 3, 96)
    assert params["sample_embeddings"].shape == (4, N_SAMPLES, 2)
    torch.testing.assert_close(params["signatures"].sum(-1),
                               torch.ones(4, 3, dtype=torch.float64))
    assert torch.equal(params["variance"], torch.ones(4, dtype=torch.float64))
    torch.testing.assert_close(
        params["exposures"],
        port_ops.compute_exposures(params["signature_scalings"],
                                   params["sample_scalings"],
                                   params["signature_embeddings"],
                                   params["sample_embeddings"]))
    for key in params:
        assert torch.equal(params[key], again[key])
