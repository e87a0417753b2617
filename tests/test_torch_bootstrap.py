"""salamander_tpu_torch.parallel.bootstrap_stability against the JAX
package's at float64 on the CPU, for every family: the sample indices and
replicate inits are host numpy in both, so the replicate fits agree value
for value (losses and matched similarities at rtol 1e-8), MultimodalCorrNMF
with one resampled index set shared by its modalities, and the errors for
unfitted models and other classes."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import datasets as jax_datasets
from salamander_tpu import models as jax_models
from salamander_tpu.parallel import bootstrap_stability as jax_bootstrap

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 24
FAMILIES = {
    "KLNMF": dict(n_signatures=3, min_iterations=20, max_iterations=200,
                  tol=1e-4),
    "MvNMF": dict(n_signatures=3, lam=0.5, min_iterations=20,
                  max_iterations=120, tol=1e-4),
    "ARDNMF": dict(n_signatures=4, a=5.0, min_iterations=20,
                   max_iterations=200, tol=1e-4),
    "CorrNMFDet": dict(n_signatures=2, dim_embeddings=2, min_iterations=5,
                       max_iterations=20),
}


@pytest.fixture(scope="module")
def frame():
    return jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]


def fitted_pair(family, frame):
    hyper = FAMILIES[family]
    np.random.seed(1)
    model_j = getattr(jax_models, family)(**hyper)
    model_j.fit(jax_containers.AnnData(frame.copy()))
    np.random.seed(1)
    model_t = getattr(port, family)(device="cpu", **hyper)
    model_t.fit(port.AnnData(frame.copy()))
    return model_j, model_t


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bootstrap_stability_matches_jax(frame, family):
    model_j, model_t = fitted_pair(family, frame)
    result_j = jax_bootstrap(model_j, n_bootstraps=4, seed=3)
    result_t = port.bootstrap_stability(model_t, n_bootstraps=4, seed=3)
    np.testing.assert_allclose(result_t.losses, np.asarray(result_j.losses),
                               rtol=RTOL)
    assert list(result_t.similarities.columns) == \
        list(result_j.similarities.columns)
    np.testing.assert_allclose(result_t.similarities.to_numpy(),
                               result_j.similarities.to_numpy(), rtol=RTOL)
    np.testing.assert_allclose(result_t.stability.to_numpy(),
                               result_j.stability.to_numpy(), rtol=RTOL)
    np.testing.assert_allclose(result_t.signatures, result_j.signatures,
                               rtol=1e-6, atol=1e-12)
    assert result_t.signatures.shape == (4, model_t.n_signatures,
                                         frame.shape[1])


def test_bootstrap_stability_weighted_klnmf_matches_jax(frame):
    """Per-sample loss weights follow their samples into each replicate
    (a (B, D) weight tensor beside the (B, V, D) counts)."""
    hyper = FAMILIES["KLNMF"]
    weights = np.linspace(0.5, 2.0, N_SAMPLES)
    model_j = jax_models.KLNMF(**hyper)
    model_j.fit(jax_containers.AnnData(frame.copy()),
                fitting_kwargs={"weights_kl": weights})
    model_t = port.KLNMF(device="cpu", **hyper)
    model_t.fit(port.AnnData(frame.copy()),
                fitting_kwargs={"weights_kl": weights})
    result_j = jax_bootstrap(model_j, n_bootstraps=3, seed=5)
    result_t = port.bootstrap_stability(model_t, n_bootstraps=3, seed=5)
    np.testing.assert_allclose(result_t.losses, np.asarray(result_j.losses),
                               rtol=RTOL)
    np.testing.assert_allclose(result_t.similarities.to_numpy(),
                               result_j.similarities.to_numpy(), rtol=RTOL)


def test_bootstrap_leaves_the_global_rng_alone(frame):
    _, model_t = fitted_pair("KLNMF", frame)
    np.random.seed(99)
    state = np.random.get_state()[1].copy()
    port.bootstrap_stability(model_t, n_bootstraps=2, seed=0)
    assert np.array_equal(np.random.get_state()[1], state)


def test_bootstrap_requires_a_fitted_model():
    with pytest.raises(ValueError, match="fitted"):
        port.bootstrap_stability(port.KLNMF(2, device="cpu"), 2)


def test_bootstrap_multimodal_waits_for_its_slice():
    """MultimodalCorrNMF is ported: the joint bootstrap (one index set per
    replicate shared by all modalities, per-lane counts, matching per
    modality) agrees with the JAX package's."""
    features = {"sbs": 12, "indel": 9, "sv": 6}
    hyper = dict(ns_signatures=[3, 2, 2], dim_embeddings=2,
                 min_iterations=5, max_iterations=20)

    def mdata(containers):
        rng = np.random.default_rng(0)
        load = rng.gamma(2.0, 1.0, (20, 3))
        return containers.MuData({
            name: containers.AnnData(rng.poisson(
                60.0 * load @ rng.dirichlet(np.ones(n_features), 3)
            ).astype(float))
            for name, n_features in features.items()
        })

    np.random.seed(1)
    model_j = jax_models.MultimodalCorrNMF(**hyper).fit(mdata(jax_containers))
    np.random.seed(1)
    model_t = port.MultimodalCorrNMF(device="cpu", **hyper).fit(mdata(port))
    result_j = jax_bootstrap(model_j, n_bootstraps=4, seed=3)
    state = np.random.get_state()[1].copy()
    result_t = port.bootstrap_stability(model_t, n_bootstraps=4, seed=3)
    assert np.array_equal(np.random.get_state()[1], state)
    np.testing.assert_allclose(result_t.losses, np.asarray(result_j.losses),
                               rtol=RTOL)
    assert list(result_t.similarities.columns) == \
        list(result_j.similarities.columns)
    assert list(result_t.similarities.columns)[:3] == \
        ["sbs Sig1", "sbs Sig2", "sbs Sig3"]
    np.testing.assert_allclose(result_t.similarities.to_numpy(),
                               result_j.similarities.to_numpy(), rtol=RTOL)
    np.testing.assert_allclose(result_t.stability.to_numpy(),
                               result_j.stability.to_numpy(), rtol=RTOL)
    for (name, n_features), k in zip(features.items(), [3, 2, 2]):
        assert result_t.signatures[name].shape == (4, k, n_features)
        np.testing.assert_allclose(result_t.signatures[name],
                                   result_j.signatures[name], rtol=1e-6,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="fitted"):
        port.bootstrap_stability(
            port.MultimodalCorrNMF([2, 2], device="cpu"), 2)


def test_bootstrap_rejects_other_classes():
    with pytest.raises(ValueError, match="supports"):
        port.bootstrap_stability(object(), 2)
