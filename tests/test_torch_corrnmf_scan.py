"""salamander_tpu_torch.parallel.corrnmf_scan at float64 on the CPU: the
padded (rank- and dim-masked) CorrNMF scan against the unpadded one (per
rank losses at rtol 1e-6, the same best restart - the tolerance of
tests/test_rank_padding.py:206-242), the unpadded scan against the JAX
package's from the same host inits, packing and compaction invariance,
the fitted winner models, per-point checkpoint resume, and reference
defect (e): the JAX store identity leaves out the compute dtype."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import datasets as jax_datasets
from salamander_tpu.engine import FitConfig as JaxFitConfig
from salamander_tpu.parallel import rank_scan_corrnmf as jax_scan
from salamander_tpu_torch.engine import FitConfig
from salamander_tpu_torch.parallel import corrnmf_scan

torch.set_num_threads(1)

N_SAMPLES = 32
CONFIG = FitConfig(min_iterations=20, max_iterations=80, conv_test_freq=10,
                   tol=1e-3)
KWARGS = dict(n_restarts=2, base_seed=4, config=CONFIG, device="cpu")


@pytest.fixture(scope="module")
def X():
    frame = jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    return np.ascontiguousarray(frame.to_numpy())


@pytest.fixture(scope="module")
def unpadded(X):
    return port.rank_scan_corrnmf(X, [2, 3, 5], dim_embeddings=2,
                                  pad_ranks=False, **KWARGS)


def assert_same_points(a, b, rtol=1e-6):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key].n_iterations,
                                      b[key].n_iterations)
        np.testing.assert_allclose(a[key].losses, b[key].losses, rtol=rtol)
        assert a[key].best_index == b[key].best_index
        assert a[key].signatures.shape == b[key].signatures.shape
        for name, value in a[key].best_params.items():
            assert value.shape == b[key].best_params[name].shape, name


@pytest.mark.parametrize("layout", [
    dict(pack_points=True), dict(pack_points=False),
    dict(pack_points=True, compact=True, compact_min_bucket=1),
], ids=["packed", "per-point", "packed-compacted"])
def test_padded_scan_equals_unpadded(X, unpadded, layout):
    padded = port.rank_scan_corrnmf(X, [2, 3, 5], dim_embeddings=2,
                                    rank_bucket=4, **layout, **KWARGS)
    assert_same_points(padded, unpadded)
    assert len({int(n) for k in padded for n in padded[k].n_iterations}) > 1
    result = padded[3]
    assert result.signatures.shape == (2, 96, 3)
    assert result.best_params["signature_embeddings"].shape == (3, 2)
    assert result.best_params["exposures"].shape == (N_SAMPLES, 3)
    assert result.best_loss == result.losses.max()


def test_grid_scan_pads_the_embedding_dimension(X):
    """A (k, m) grid: m = 1 rides in an m = 2 bucket with a zero dimension
    that stays zero; results equal the unpadded grid's."""
    kwargs = dict(dim_embeddings_range=[1, 2], dim_bucket=2, **KWARGS)
    padded = port.rank_scan_corrnmf(X, [2, 3], rank_bucket=4, **kwargs)
    plain = port.rank_scan_corrnmf(X, [2, 3], pad_ranks=False, **kwargs)
    assert sorted(padded) == [(2, 1), (2, 2), (3, 1), (3, 2)]
    assert_same_points(padded, plain)
    assert padded[(3, 1)].best_params["sample_embeddings"].shape == \
        (N_SAMPLES, 1)


def test_unpadded_scan_matches_jax(X, unpadded):
    """Both packages draw every lane with the model's own host initializer
    (same seeds), so the per-point results agree."""
    expected = jax_scan(X, [2, 3, 5], dim_embeddings=2, n_restarts=2,
                        base_seed=4, config=JaxFitConfig(*CONFIG),
                        pad_ranks=False, build_models=False)
    for k in (2, 3, 5):
        np.testing.assert_array_equal(unpadded[k].n_iterations,
                                      expected[k].n_iterations)
        np.testing.assert_allclose(unpadded[k].losses, expected[k].losses,
                                   rtol=1e-6)
        assert unpadded[k].best_index == expected[k].best_index
        np.testing.assert_allclose(unpadded[k].signatures,
                                   expected[k].signatures, rtol=1e-4,
                                   atol=1e-9)


def test_winner_models(X, unpadded):
    result = unpadded[3]
    model = result.model
    assert isinstance(model, port.CorrNMFDet) and model._is_fitted
    best = result.best_index
    np.testing.assert_array_equal(model.asignatures.X,
                                  result.best_params["signatures"])
    assert model.history["n_iterations"] == result.n_iterations[best]
    assert len(model.history["objective_function"]) == result.n_evals[best]
    np.testing.assert_allclose(model.history["objective_function"][-1],
                               result.losses[best], rtol=1e-12)
    np.testing.assert_allclose(model.objective_function(),
                               result.losses[best], rtol=1e-12)
    bare = port.rank_scan_corrnmf(X, [2], dim_embeddings=2, pad_ranks=False,
                                  build_models=False, **KWARGS)
    assert bare[2].model is None
    np.testing.assert_array_equal(bare[2].losses, unpadded[2].losses)

    def factory(k, m):
        return port.CorrNMFDet(n_signatures=k, dim_embeddings=m,
                               init_method="nndsvda", device="cpu")

    custom = port.rank_scan_corrnmf(X, [2], dim_embeddings=2,
                                    model_factory=factory, **KWARGS)
    assert custom[2].model.init_method == "nndsvda"


def test_checkpointed_scan_resumes(X, unpadded, tmp_path, monkeypatch):
    first = port.rank_scan_corrnmf(X, [2, 3, 5], dim_embeddings=2,
                                   pad_ranks=False, checkpoint_dir=tmp_path,
                                   **KWARGS)
    assert_same_points(first, unpadded, rtol=0)
    (tmp_path / "point_k3_m2.npz").unlink()  # killed before k=3 was stored
    calls = []
    real = corrnmf_scan.rank_scan_corrnmf

    def counting(X_, ranks, *args, **kwargs):
        calls.append(list(ranks))
        return real(X_, ranks, *args, **kwargs)

    monkeypatch.setattr(corrnmf_scan, "rank_scan_corrnmf", counting)
    resumed = port.rank_scan_corrnmf(X, [2, 3, 5], dim_embeddings=2,
                                     pad_ranks=False,
                                     checkpoint_dir=tmp_path, **KWARGS)
    assert calls == [[3]]
    assert_same_points(resumed, unpadded, rtol=0)
    loaded = resumed[2]
    np.testing.assert_array_equal(loaded.model.asignatures.X,
                                  unpadded[2].model.asignatures.X)
    assert loaded.model.history["n_iterations"] == \
        unpadded[2].model.history["n_iterations"]


def test_defect_e_scan_identity_has_dtype(X, tmp_path):
    """Reference defect (corrnmf_scan.py:123-136): the JAX store identity
    leaves out the compute dtype, so a float32 rerun would load a float64
    store. Fixed here: the dtype is in the identity, and such a store is
    discarded with the 'different run' warning."""
    kwargs = dict(KWARGS, config=FitConfig(20, 20, 10, 1e-3))
    first = port.rank_scan_corrnmf(X, [2], dim_embeddings=2,
                                   checkpoint_dir=tmp_path, **kwargs)
    with pytest.warns(UserWarning, match="different run"):
        rerun = port.rank_scan_corrnmf(X, [2], dim_embeddings=2,
                                       checkpoint_dir=tmp_path,
                                       dtype="float32", **kwargs)
    assert rerun[2].model.dtype == "float32"
    assert rerun[2].best_params["signatures"].dtype == np.float32
    assert first[2].best_params["signatures"].dtype == np.float64


def test_arguments_are_checked(X):
    with pytest.raises(ValueError, match="dim_embeddings"):
        port.rank_scan_corrnmf(X, [2], **KWARGS)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.rank_scan_corrnmf(X, [2], dim_embeddings=2, mesh=object(),
                               **KWARGS)


def test_scan_under_a_mesh_matches_jax(X, unpadded):
    """mesh= (ROADMAP item 18) splits each call's lanes over the restart
    axis with the counts replicated: on a world of one the scan is the
    meshless one, bit for bit, and the JAX package's scan with its lanes
    on 2 restart ways agrees as the meshless scans do. The spawned world
    of test_torch_mesh_paths.py shards the lanes over ranks."""
    import jax
    import torch.distributed as dist

    from salamander_tpu.parallel import make_mesh as jax_make_mesh

    try:
        sharded = port.rank_scan_corrnmf(
            X, [2, 3, 5], dim_embeddings=2, pad_ranks=False,
            mesh=port.make_mesh(device="cpu"), **KWARGS)
    finally:
        dist.destroy_process_group()
    expected = jax_scan(X, [2, 3, 5], dim_embeddings=2, n_restarts=2,
                        base_seed=4, config=JaxFitConfig(*CONFIG),
                        pad_ranks=False, build_models=False,
                        mesh=jax_make_mesh(jax.devices()[:2], sample_ways=1))
    for k in (2, 3, 5):
        np.testing.assert_array_equal(sharded[k].losses, unpadded[k].losses)
        np.testing.assert_array_equal(sharded[k].n_iterations,
                                      expected[k].n_iterations)
        np.testing.assert_allclose(sharded[k].losses, expected[k].losses,
                                   rtol=1e-6)
        assert sharded[k].best_index == expected[k].best_index
