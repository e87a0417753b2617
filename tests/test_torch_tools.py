"""Analysis tools (dimensionality reductions and correlations) of
salamander_tpu_torch, mirroring tests/test_tools.py, and held against the
JAX package's tools on the same numpy inputs: correlation_numpy and the
PCA reduction equal at rtol 1e-12."""

import sys

import numpy as np
import pytest

from salamander_tpu import tools as jax_tl
from salamander_tpu_torch import tools as tl
from salamander_tpu_torch.containers import AnnData

RTOL = 1e-12


@pytest.fixture
def adata():
    rng = np.random.default_rng(0)
    adata = AnnData(np.abs(rng.normal(size=(30, 8))) + 0.1)
    adata.obsm["exposures"] = np.abs(rng.normal(size=(30, 5))) + 0.1
    return adata


def test_reduce_dimension_pca(adata):
    tl.reduce_dimension(adata, basis="exposures", method="pca")
    assert adata.obsm["X_pca"].shape == (30, 2)
    np.testing.assert_allclose(
        adata.obsm["X_pca"],
        jax_tl.reduce_dimension_numpy(adata.obsm["exposures"], method="pca"),
        rtol=RTOL, atol=1e-14)


def test_reduce_dimension_tsne(adata):
    tl.reduce_dimension(adata, basis="exposures", method="tsne")
    assert adata.obsm["X_tsne"].shape == (30, 2)


def test_reduce_dimension_skips_low_dim(adata):
    adata.obsm["flat"] = np.zeros((30, 2))
    with pytest.warns(UserWarning):
        tl.reduce_dimension(adata, basis="flat", method="pca")
    assert "X_pca" not in adata.obsm


def test_reduce_dimension_rejects_bad_method(adata):
    with pytest.raises(ValueError):
        tl.reduce_dimension_numpy(adata.obsm["exposures"], method="bogus")


def test_reduce_dimension_multiple_splits_back(adata):
    other = AnnData(np.ones((12, 8)))
    other.obsm["exposures"] = np.abs(
        np.random.default_rng(1).normal(size=(12, 5))
    )
    tl.reduce_dimension_multiple([adata, other], basis="exposures",
                                 method="pca")
    assert adata.obsm["X_pca"].shape == (30, 2)
    assert other.obsm["X_pca"].shape == (12, 2)
    joint = jax_tl.reduce_dimension_numpy(
        np.concatenate([adata.obsm["exposures"], other.obsm["exposures"]]),
        method="pca")
    np.testing.assert_allclose(
        np.concatenate([adata.obsm["X_pca"], other.obsm["X_pca"]]), joint,
        rtol=RTOL, atol=1e-14)


def test_umap_falls_back_to_pca_when_missing(adata):
    try:
        import umap  # noqa: F401
        pytest.skip("umap-learn installed; fallback not exercised")
    except ImportError:
        pass
    with pytest.warns(UserWarning, match="umap-learn"):
        tl.reduce_dimension(adata, basis="exposures", method="umap")
    assert adata.obsm["X_umap"].shape == (30, 2)


def test_correlation_stores_obsp(adata):
    tl.correlation(adata, basis="exposures")
    corr = adata.obsp["X_correlation"]
    assert corr.shape == (30, 30)
    assert np.allclose(np.diag(corr), 1.0)
    assert np.allclose(corr, corr.T)
    np.testing.assert_allclose(
        corr, jax_tl.correlation_numpy(adata.obsm["exposures"]), rtol=RTOL)


def test_basis_resolution_fallback(adata):
    tl.pca(adata, basis="exposures")
    # 'pca' resolves to 'X_pca' through the _get_basis convention
    tl.correlation(adata, basis="pca")
    assert adata.obsp["X_correlation"].shape == (30, 30)


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_correlation_numpy_matches_jax(method):
    data = np.random.default_rng(4).gamma(2.0, 3.0, size=(7, 40))
    np.testing.assert_allclose(
        tl.correlation_numpy(data, method=method),
        jax_tl.correlation_numpy(data, method=method), rtol=RTOL)


def test_pca_without_scikit_learn_takes_the_svd(monkeypatch, adata):
    """The card's machine has no scikit-learn: _pca then projects on the
    numpy SVD's leading right singular vectors, equal to scikit-learn's
    PCA up to each component's sign."""
    data = adata.obsm["exposures"]
    expected = jax_tl._pca(data)
    monkeypatch.setitem(sys.modules, "sklearn.decomposition", None)
    got = tl._pca(data)
    signs = np.sign(np.sum(got * expected, axis=0))
    np.testing.assert_allclose(got * signs, expected, rtol=1e-10,
                               atol=1e-12)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError):
        tl.reduce_dimension_numpy(data, method="tsne")
