"""Host-streaming minibatch fits of the port at float64 on the CPU: the
count matrix stays on the host and each minibatch is uploaded through the
ring of slots (ops/svi.py run_svi_streaming). The five cases of
tests/test_streaming.py: a streaming fit is BIT-equal to the resident one
at the same seed - the same index sequence from the same CPU generator, the
same epoch-boundary refreshes, the same core on tensors of the same shape -
for CorrNMFDet (a batch size that divides the cohort and one that does
not), weighted KLNMF and MultimodalCorrNMF; the chunked objective trace
matches the full-data one at rtol 1e-9 (the chunks sum in another order),
also with a ragged last chunk; and integer host counts are neither clipped
nor promoted in place.

Not mirrored: the test that a second streaming fit reuses compiled
programs (tests/test_streaming.py, its last test): nothing is compiled
here, so there is no cache to hold.
"""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port

torch.set_num_threads(1)


def make_counts(seed, shape=(57, 12), lam=30.0):
    return np.random.default_rng(seed).poisson(lam, shape).astype(float)


def fit_corrnmf(X, streaming, batch_size, **kwargs):
    model = port.CorrNMFDet(n_signatures=3, dim_embeddings=2, device="cpu")
    np.random.seed(5)  # the embedding init draws from numpy's global state
    model.fit_minibatch(
        port.AnnData(X.copy()), batch_size=batch_size, n_steps=37,
        eval_freq=10, seed=3, init_kwargs={"seed": 5}, streaming=streaming,
        **kwargs)
    return model


@pytest.mark.parametrize("batch_size", [10, 19])  # 19 divides neither epoch
def test_corrnmf_streaming_equals_resident_bitwise(batch_size):
    X = make_counts(0)
    resident = fit_corrnmf(X, False, batch_size)
    streamed = fit_corrnmf(X, True, batch_size)
    np.testing.assert_array_equal(resident.asignatures.X,
                                  streamed.asignatures.X)
    for key in ("exposures", "embeddings"):
        np.testing.assert_array_equal(resident.adata.obsm[key],
                                      streamed.adata.obsm[key])
    np.testing.assert_array_equal(resident.asignatures.obsm["embeddings"],
                                  streamed.asignatures.obsm["embeddings"])
    for container in ("adata", "asignatures"):
        np.testing.assert_array_equal(
            np.asarray(getattr(resident, container).obs["scalings"]),
            np.asarray(getattr(streamed, container).obs["scalings"]))
    assert resident.variance == streamed.variance
    np.testing.assert_allclose(
        np.asarray(resident.history["objective_function"]),
        np.asarray(streamed.history["objective_function"]), rtol=1e-9)
    assert len(streamed.history["objective_function"]) == 3


def test_corrnmf_streaming_small_eval_chunk():
    """eval_chunk smaller than (and not dividing) n_samples exercises the
    chunk loop and the shorter last chunk."""
    X = make_counts(2, shape=(23, 8))

    def fit(**kwargs):
        model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                                device="cpu")
        np.random.seed(2)
        model.fit_minibatch(
            port.AnnData(X.copy()), batch_size=7, n_steps=10, eval_freq=5,
            seed=1, init_kwargs={"seed": 2}, **kwargs)
        return model

    streamed, resident = fit(streaming=True, eval_chunk=9), fit()
    np.testing.assert_allclose(
        np.asarray(streamed.history["objective_function"]),
        np.asarray(resident.history["objective_function"]), rtol=1e-9)
    np.testing.assert_array_equal(streamed.asignatures.X,
                                  resident.asignatures.X)


def test_klnmf_streaming_equals_resident_bitwise_weighted():
    X = make_counts(1)
    weights = np.random.default_rng(9).uniform(0.5, 2.0, X.shape[0])

    def fit(streaming):
        model = port.KLNMF(n_signatures=3, device="cpu")
        model.fit_minibatch(
            port.AnnData(X.copy()), batch_size=10, n_steps=25, eval_freq=5,
            seed=2, init_kwargs={"seed": 7}, streaming=streaming,
            fitting_kwargs={"weights_kl": weights.copy(),
                            "weights_lhalf": 0.1})
        return model

    resident, streamed = fit(False), fit(True)
    np.testing.assert_array_equal(resident.asignatures.X,
                                  streamed.asignatures.X)
    np.testing.assert_array_equal(resident.adata.obsm["exposures"],
                                  streamed.adata.obsm["exposures"])
    np.testing.assert_allclose(
        np.asarray(resident.history["objective_function"]),
        np.asarray(streamed.history["objective_function"]), rtol=1e-9)


def test_mm_streaming_equals_resident_bitwise():
    def make_mdata(seed):
        rng = np.random.default_rng(seed)
        return port.MuData({
            "sbs": port.AnnData(rng.poisson(30.0, (41, 10)).astype(float)),
            "indel": port.AnnData(rng.poisson(10.0, (41, 7)).astype(float)),
        })

    def fit(streaming):
        model = port.MultimodalCorrNMF(ns_signatures=[2, 3],
                                       dim_embeddings=2, device="cpu")
        np.random.seed(6)
        model.fit_minibatch(
            make_mdata(4), batch_size=8, n_steps=23, eval_freq=7, seed=9,
            init_kwargs={"seed": 6}, streaming=streaming)
        return model

    resident, streamed = fit(False), fit(True)
    np.testing.assert_array_equal(resident.mdata.obsm["embeddings"],
                                  streamed.mdata.obsm["embeddings"])
    for name in ("sbs", "indel"):
        np.testing.assert_array_equal(resident.asignatures[name].X,
                                      streamed.asignatures[name].X)
        np.testing.assert_array_equal(
            resident.mdata[name].obsm["exposures"],
            streamed.mdata[name].obsm["exposures"])
    assert resident.variance == streamed.variance
    np.testing.assert_allclose(
        np.asarray(resident.history["objective_function"]),
        np.asarray(streamed.history["objective_function"]), rtol=1e-9)


def test_streaming_integer_host_storage_stays_compact():
    """Integer count matrices must NOT be clipped/promoted in place (a
    uint16 cohort would grow 4-8x on the host); the EPSILON clip applies per
    uploaded batch instead, with the values the resident fit clips in
    place."""
    X = np.random.default_rng(1).poisson(5.0, (33, 9)).astype(np.uint16)
    assert X.min() == 0

    def fit(adata, streaming):
        model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                                init_method="random", device="cpu")
        np.random.seed(1)
        model.fit_minibatch(adata, batch_size=8, n_steps=11, eval_freq=5,
                            seed=0, init_kwargs={"seed": 1},
                            streaming=streaming)
        return model

    adata = port.AnnData(X.copy())
    model = fit(adata, True)
    assert adata.X.dtype == np.uint16
    assert adata.X.min() == 0  # zeros NOT lifted on the host
    np.testing.assert_array_equal(adata.X, X)
    assert np.all(np.isfinite(model.adata.obsm["exposures"]))
    assert np.all(np.isfinite(model.history["objective_function"]))
    resident_adata = port.AnnData(X.copy())
    resident = fit(resident_adata, False)
    assert resident_adata.X.dtype == np.float64  # the resident fit promotes
    np.testing.assert_array_equal(model.asignatures.X, resident.asignatures.X)
    np.testing.assert_array_equal(model.adata.obsm["exposures"],
                                  resident.adata.obsm["exposures"])


def test_mm_streaming_integer_host_storage_stays_compact():
    rng = np.random.default_rng(3)
    counts = {"sbs": rng.poisson(4.0, (29, 10)).astype(np.uint16),
              "indel": rng.poisson(9.0, (29, 7)).astype(float)}
    mdata = port.MuData({k: port.AnnData(v.copy())
                         for k, v in counts.items()})
    model = port.MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2,
                                   init_method="random", device="cpu")
    model.fit_minibatch(mdata, batch_size=8, n_steps=9, eval_freq=3, seed=0,
                        init_kwargs={"seed": 1}, streaming=True)
    assert mdata["sbs"].X.dtype == np.uint16
    np.testing.assert_array_equal(mdata["sbs"].X, counts["sbs"])
    assert mdata["indel"].X.min() > 0  # float counts are clipped in place
    assert np.all(np.isfinite(model.history["objective_function"]))
