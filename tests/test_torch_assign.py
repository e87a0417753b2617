"""salamander_tpu_torch.assign and tools.decompose_signatures against the
JAX package's at float64 on the CPU (exposures and KLs at rtol 1e-8,
supports equal), and within the port: chunking, catalog orientation,
checkpoint resume, the compute dtype in the store identity (ROADMAP Queue
3 defect (f)), and the bootstrap of exposures."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import assign as jax_assign
from salamander_tpu import datasets as jax_datasets
from salamander_tpu import tools as jax_tools
from salamander_tpu_torch import assign
from salamander_tpu_torch.tools import decompose_signatures

torch.set_num_threads(1)

RTOL = 1e-8
CPU = dict(device="cpu")


def synthetic(seed=0, n_features=24, n_samples=8, n_catalog=6,
              active_per_sample=2, scale=2_000.0, noise=False):
    """tests/test_assign.py's well-separated catalog with KNOWN sparse
    supports (Poisson noise on the counts where `noise`)."""
    rng = np.random.default_rng(seed)
    W = np.full((n_features, n_catalog), 0.01)
    block = n_features // n_catalog
    for k in range(n_catalog):
        W[k * block:(k + 1) * block, k] += 1.0
    W /= W.sum(axis=0, keepdims=True)
    H = np.zeros((n_catalog, n_samples))
    supports = []
    for d in range(n_samples):
        active = rng.choice(n_catalog, size=active_per_sample, replace=False)
        supports.append(np.sort(active))
        H[active, d] = scale * (0.5 + rng.random(active_per_sample))
    X = W @ H
    if noise:
        X = rng.poisson(X).astype(np.float64) + np.finfo(np.float32).eps
    features = [f"f{v}" for v in range(n_features)]
    data = pd.DataFrame(X.T, index=[f"s{d}" for d in range(n_samples)],
                        columns=features)
    catalog = pd.DataFrame(W.T, index=[f"Sig{k}" for k in range(n_catalog)],
                           columns=features)
    return data, catalog, supports


def pcawg_cosmic(n_samples=24):
    return (jax_datasets.load_pcawg_sbs().iloc[:n_samples],
            jax_datasets.load_cosmic_sbs_catalog(), None)


def noisy_synthetic():
    """With Poisson noise (the exact factorization's KLs are cancellation
    noise around 0, no test of agreement)."""
    data, catalog, _ = synthetic(noise=True)
    return data, catalog, None


PROBLEMS = {"synthetic": noisy_synthetic, "pcawg_cosmic": pcawg_cosmic}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def problem(request):
    return PROBLEMS[request.param]()


@pytest.fixture(scope="module")
def small():
    return synthetic()


def assert_same_assignment(port_result, jax_result):
    pd.testing.assert_frame_equal(port_result.active, jax_result.active)
    np.testing.assert_array_equal(port_result.n_active.to_numpy(),
                                  jax_result.n_active.to_numpy())
    np.testing.assert_allclose(port_result.exposures.to_numpy(),
                               jax_result.exposures.to_numpy(), rtol=RTOL,
                               atol=1e-300)
    for key in ("kl_dense", "kl_sparse"):
        np.testing.assert_allclose(getattr(port_result, key).to_numpy(),
                                   getattr(jax_result, key).to_numpy(),
                                   rtol=RTOL)
    assert port_result.meta["n_rounds"] == int(jax_result.meta["n_rounds"])


def test_assign_exposures_matches_jax(problem):
    data, catalog, _ = problem
    expected = jax_assign.assign_exposures(data, catalog, max_iterations=3000)
    actual = assign.assign_exposures(data, catalog, max_iterations=3000,
                                     **CPU)
    assert list(actual.index) == list(expected.index)
    assert list(actual.columns) == list(expected.columns)
    np.testing.assert_allclose(actual.to_numpy(), expected.to_numpy(),
                               rtol=RTOL)


def test_assign_signatures_matches_jax(problem):
    data, catalog, supports = problem
    kwargs = dict(rel_tol=0.02, candidate_iters=20, polish_iterations=40,
                  max_iterations=3000)
    expected = jax_assign.assign_signatures(data, catalog, **kwargs)
    actual = port.assign_signatures(data, catalog, **kwargs, **CPU)
    assert isinstance(actual, port.AssignmentResult)
    assert_same_assignment(actual, expected)
    budget = 1.02 * actual.kl_dense.to_numpy()
    assert (actual.kl_sparse.to_numpy() <= budget).all()
    exposures, active = actual.exposures.to_numpy(), actual.active.to_numpy()
    assert (exposures[~active] == 0.0).all()
    assert (exposures[active] >= np.finfo(np.float32).eps).all()
    assert actual.n_active.min() < catalog.shape[0]


def test_decompose_signatures_matches_jax():
    catalog = jax_datasets.load_cosmic_sbs_catalog()
    rng = np.random.default_rng(2)
    rows = np.stack([
        0.6 * catalog.loc["SBS1"] + 0.4 * catalog.loc["SBS5"],
        0.7 * catalog.loc["SBS3"] + 0.2 * catalog.loc["SBS8"]
        + 0.1 * catalog.loc["SBS13"],
        catalog.loc["SBS2"].to_numpy() * 1.0,
    ]) + rng.uniform(0, 1e-4, (3, catalog.shape[1]))
    sigs = pd.DataFrame(rows, index=["A", "B", "C"], columns=catalog.columns)
    expected = jax_tools.decompose_signatures(sigs, catalog)
    actual = decompose_signatures(sigs, catalog, **CPU)
    pd.testing.assert_frame_equal(actual.active, expected.active)
    np.testing.assert_allclose(actual.weights.to_numpy(),
                               expected.weights.to_numpy(), rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_allclose(actual.cosine.to_numpy(),
                               expected.cosine.to_numpy(), rtol=RTOL)
    pd.testing.assert_frame_equal(
        actual.table.drop(columns="weight"),
        expected.table.drop(columns="weight"))
    np.testing.assert_allclose(actual.weights.sum(axis=1), 1.0, rtol=1e-12)
    assert set(actual.table.loc[actual.table.signature == "A",
                                "component"]) >= {"SBS1", "SBS5"}
    assert "DecompositionResult(3 signatures" in repr(actual)


def test_chunked_equals_unchunked_and_recovers_supports(small):
    data, catalog, supports = small
    whole = port.assign_signatures(data, catalog, **CPU)
    for d, support in enumerate(supports):
        assert list(np.flatnonzero(whole.active.to_numpy()[d])) == \
            list(support)
    chunked = port.assign_signatures(data, catalog, batch_size=3, **CPU)
    pd.testing.assert_frame_equal(whole.active, chunked.active)
    np.testing.assert_allclose(whole.exposures.to_numpy(),
                               chunked.exposures.to_numpy(), rtol=1e-6,
                               atol=1e-9)
    assert chunked.meta["batch_size"] == 3
    assert whole.meta["batch_size"] == data.shape[0]


def test_catalog_orientation_and_feature_order(small):
    data, catalog, _ = small
    result = port.assign_signatures(data, catalog, **CPU)
    perm = np.random.default_rng(7).permutation(catalog.shape[1])
    shuffled = port.assign_signatures(data, catalog.iloc[:, perm].T, **CPU)
    pd.testing.assert_frame_equal(result.active, shuffled.active)
    np.testing.assert_allclose(result.exposures.to_numpy(),
                               shuffled.exposures.to_numpy(), rtol=1e-10)
    adata = port.AnnData(data)
    from_anndata = port.assign_signatures(adata, port.AnnData(catalog), **CPU)
    pd.testing.assert_frame_equal(result.active, from_anndata.active)
    assert set(result.assigned_signatures()) <= set(catalog.index)


def test_input_validation_and_mesh(small):
    data, catalog, _ = small
    with pytest.raises(TypeError, match="AnnData-like container"):
        port.assign_signatures([[1.0]], catalog, **CPU)
    with pytest.raises(TypeError, match="DataFrame or an AnnData-like"):
        port.assign_signatures(data, catalog.to_numpy(), **CPU)
    with pytest.raises(ValueError, match="do not match"):
        port.assign_signatures(data, catalog.iloc[:, :-1], **CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.assign_exposures(data, catalog, mesh=object(), **CPU)
    before = data.copy()
    port.assign_exposures(data, catalog, max_iterations=20, **CPU)
    pd.testing.assert_frame_equal(data, before)


def test_assignment_on_a_mesh_matches_the_jax_mesh_run():
    """mesh= (ROADMAP item 18): on a world of one the assignment is the
    meshless one, bit for bit, and the JAX package's run on 4 sample ways
    of its virtual devices agrees at 1e-8 with equal supports. The spawned
    world of test_torch_mesh_paths.py shards the samples over ranks."""
    import jax
    import torch.distributed as dist

    from salamander_tpu.parallel import make_mesh as jax_make_mesh

    data, catalog, _ = noisy_synthetic()
    plain = port.assign_signatures(data, catalog, **CPU)
    dense_plain = port.assign_exposures(data, catalog, **CPU)
    try:
        mesh = port.make_mesh(device="cpu")
        sharded = port.assign_signatures(data, catalog, mesh=mesh, **CPU)
        dense = port.assign_exposures(data, catalog, mesh=mesh, **CPU)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(sharded.exposures.to_numpy(),
                                  plain.exposures.to_numpy())
    np.testing.assert_array_equal(dense.to_numpy(), dense_plain.to_numpy())
    jax_mesh = jax_make_mesh(jax.devices()[:4], sample_ways=4)
    assert_same_assignment(sharded, jax_assign.assign_signatures(
        data, catalog, mesh=jax_mesh))
    np.testing.assert_allclose(
        dense.to_numpy(),
        jax_assign.assign_exposures(data, catalog, mesh=jax_mesh).to_numpy(),
        rtol=RTOL)


def test_checkpoint_full_and_partial_resume(small, tmp_path, monkeypatch):
    data, catalog, _ = small
    baseline = port.assign_signatures(data, catalog, batch_size=3, **CPU)
    first = port.assign_signatures(data, catalog, batch_size=3,
                                   checkpoint_dir=tmp_path, **CPU)
    pd.testing.assert_frame_equal(first.exposures, baseline.exposures)
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "chunk_00000000.npz", "chunk_00000003.npz", "chunk_00000006.npz"]

    calls = []
    real = assign.ops.eliminate_signatures

    def counting(X, *args, **kwargs):
        calls.append(int(X.shape[1]))
        return real(X, *args, **kwargs)

    monkeypatch.setattr(assign.ops, "eliminate_signatures", counting)
    resumed = port.assign_signatures(data, catalog, batch_size=3,
                                     checkpoint_dir=tmp_path, **CPU)
    assert calls == []
    pd.testing.assert_frame_equal(resumed.exposures, baseline.exposures)
    (tmp_path / "chunk_00000003.npz").unlink()  # killed mid-run
    partial = port.assign_signatures(data, catalog, batch_size=3,
                                     checkpoint_dir=tmp_path, **CPU)
    assert calls == [3]
    pd.testing.assert_frame_equal(partial.exposures, baseline.exposures)
    pd.testing.assert_frame_equal(partial.active, baseline.active)


@pytest.mark.parametrize("pipeline", ["assign_signatures",
                                      "bootstrap_exposures"])
def test_store_identity_holds_the_compute_dtype(small, tmp_path, pipeline):
    """Defect (f): the JAX package's stores leave out the compute dtype, so
    a float32 rerun would resume float64 chunks. Here a float64 store is
    discarded, with the 'different run' warning, by a float32 rerun."""
    data, catalog, _ = small
    run = getattr(port, pipeline)
    kwargs = dict(checkpoint_dir=tmp_path, **CPU)
    if pipeline == "bootstrap_exposures":
        kwargs["n_replicates"] = 3
    wide = run(data, catalog, dtype="float64", **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run(data, catalog, dtype="float64", **kwargs)  # resumes silently
    with pytest.warns(UserWarning, match="different run"):
        narrow = run(data, catalog, dtype="float32", **kwargs)
    frame = "exposures" if pipeline == "assign_signatures" else "point"
    assert getattr(narrow, frame).to_numpy().dtype == np.float32
    assert getattr(wide, frame).to_numpy().dtype == np.float64


def test_bootstrap_point_equals_dense_refit(small):
    data, catalog, _ = small
    result = port.bootstrap_exposures(data, catalog, n_replicates=8, seed=0,
                                      **CPU)
    dense = port.assign_exposures(data, catalog, **CPU)

    def fractions(E):
        return E / E.sum(axis=1, keepdims=True)

    np.testing.assert_allclose(fractions(result.point.to_numpy()),
                               fractions(dense.to_numpy()), atol=1e-4)
    assert result.mean.shape == dense.shape
    assert set(result.quantiles) == {0.05, 0.5, 0.95}
    assert result.meta["n_replicates"] == 8
    assert (result.std.to_numpy() >= 0).all()


def test_bootstrap_respects_sparse_support(small):
    data, catalog, supports = small
    assignment = port.assign_signatures(data, catalog, **CPU)
    result = port.bootstrap_exposures(data, catalog, n_replicates=10,
                                      seed=3, active=assignment.active, **CPU)
    off = ~assignment.active.to_numpy()
    assert (result.point.to_numpy()[off] == 0.0).all()
    assert (result.mean.to_numpy()[off] == 0.0).all()
    assert (result.presence.to_numpy()[off] == 0.0).all()
    for d, support in enumerate(supports):
        assert (result.presence.to_numpy()[d, support] > 0.9).all()
    assert result.meta["sparse"] is True


def test_bootstrap_chunks_and_seeds(small):
    """Replicates draw from generators seeded by (seed, replicate) and
    converge each on their own: a rerun is identical, another seed is not,
    and a caller-given replicate_batch changes nothing."""
    data, catalog, _ = small
    first = port.bootstrap_exposures(data, catalog, n_replicates=9, seed=5,
                                     replicate_batch=4, **CPU)
    again = port.bootstrap_exposures(data, catalog, n_replicates=9, seed=5,
                                     replicate_batch=4, **CPU)
    other = port.bootstrap_exposures(data, catalog, n_replicates=9, seed=6,
                                     replicate_batch=4, **CPU)
    pd.testing.assert_frame_equal(first.mean, again.mean)
    assert not np.allclose(first.mean.to_numpy(), other.mean.to_numpy())
    assert assign.replicate_seed(5, 1) != assign.replicate_seed(5, 2)
    assert assign.replicate_seed(5, 1) != assign.replicate_seed(6, 1)
    whole = port.bootstrap_exposures(data, catalog, n_replicates=9, seed=5,
                                     **CPU)
    for frame in ("point", "mean", "std", "presence"):
        pd.testing.assert_frame_equal(getattr(first, frame),
                                      getattr(whole, frame))
    dense = port.assign_exposures(data, catalog, **CPU)
    pd.testing.assert_frame_equal(whole.point, dense)  # replicate 0 alone
    poisson = port.bootstrap_exposures(data, catalog, n_replicates=4,
                                       method="poisson", **CPU)
    assert np.isfinite(poisson.std.to_numpy()).all()
    with pytest.raises(ValueError, match="n_replicates"):
        port.bootstrap_exposures(data, catalog, n_replicates=1, **CPU)
    with pytest.raises(ValueError, match="active must be"):
        port.bootstrap_exposures(data, catalog, n_replicates=4,
                                 active=np.ones((3, 3), dtype=bool), **CPU)


def test_memory_model_sizes_chunks():
    """The memory model of a sample in an elimination round: a candidate
    step's five (K, K) exposures beside aux at (K, V), or the KL's (K, K)
    exposures beside three (K, V) products, whichever is more, the (K, K)
    bool masks, and the sample's own 2 V + 8 K elements; COSMIC-79 x
    100,000 samples come to ~16.5 GB in float32 at one chunk (an H100 run
    of cell 8b peaked at 16.40 GB)."""
    per_sample = assign.candidate_bytes_per_sample(96, 79, 4)
    assert per_sample == (4 * (5 * 79 * 79 + 79 * 96) + 79 * 79
                          + 4 * (2 * 96 + 8 * 79))
    assert 16.4e9 < per_sample * 100_000 < 16.5e9
    assert assign.candidate_bytes_per_sample(24, 6, 8) == \
        8 * (6 * 6 + 3 * 6 * 24) + 6 * 6 + 8 * (2 * 24 + 8 * 6)
    assert assign._memory_lanes(torch.device("cpu"), per_sample, 7) == 7


# ------------------------------------------------------------------ #
# the memory budget decides no result and no store
# ------------------------------------------------------------------ #


def test_memory_budget_is_a_function_of_the_device(monkeypatch):
    """A fixed share of the card's total memory: no free-memory figure is
    read, so the allocator's state cannot move a chunk boundary."""
    class Properties:
        total_memory = 80 * 2**30

    def no_free_memory(*args, **kwargs):
        raise AssertionError("the budget must not read free memory")

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Properties)
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_free_memory)
    budget = assign._memory_budget(torch.device("cuda"))
    assert budget == int(assign._DEVICE_MEMORY_SHARE * 80 * 2**30)
    assert assign._memory_budget(torch.device("cpu")) is None
    # cells 7b and 8b of the JAX benchmark (float32): COSMIC-79 x 100,000
    # samples' candidates, and 64 replicates of 96 x 100,000 counts
    per_sample = assign.candidate_bytes_per_sample(96, 79, 4)
    assert assign._memory_lanes(torch.device("cuda"), per_sample,
                                100_000) == 100_000


def _patched_budget(monkeypatch, n_bytes):
    monkeypatch.setattr(assign, "_memory_budget", lambda device: n_bytes)


def test_assign_signatures_equal_under_two_budgets(small, tmp_path,
                                                   monkeypatch):
    """The budget only bounds how many samples' candidates are evaluated
    at once (3 or 5 of the 8 here): supports, exposures and KLs are equal,
    and a store written under one budget resumes under the other."""
    data, catalog, _ = small
    per_sample = assign.candidate_bytes_per_sample(24, 6, 8)
    widths = []
    real = assign.ops.eliminate_signatures

    def recording(X, *args, **kwargs):
        widths.append(kwargs["candidate_chunk"])
        return real(X, *args, **kwargs)

    monkeypatch.setattr(assign.ops, "eliminate_signatures", recording)
    _patched_budget(monkeypatch, 3 * per_sample)
    tight = port.assign_signatures(data, catalog, checkpoint_dir=tmp_path,
                                   **CPU)
    _patched_budget(monkeypatch, 5 * per_sample)
    roomy = port.assign_signatures(data, catalog, **CPU)
    assert widths == [3, 5]
    pd.testing.assert_frame_equal(tight.active, roomy.active)
    np.testing.assert_allclose(tight.exposures.to_numpy(),
                               roomy.exposures.to_numpy(), rtol=1e-12,
                               atol=1e-300)
    for key in ("kl_dense", "kl_sparse"):
        np.testing.assert_allclose(getattr(tight, key).to_numpy(),
                                   getattr(roomy, key).to_numpy(),
                                   rtol=1e-12)
    assert tight.meta == roomy.meta
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "different run" warning
        resumed = port.assign_signatures(data, catalog,
                                         checkpoint_dir=tmp_path, **CPU)
    assert widths == [3, 5]  # nothing was computed again
    pd.testing.assert_frame_equal(resumed.exposures, tight.exposures)


def test_bootstrap_exposures_equal_under_two_budgets(small, tmp_path,
                                                     monkeypatch):
    """Replicates are drawn and refitted one by one in effect: two budgets
    that batch the 7 replicates by 2 and by 3 give the same frames, and a
    store that lost an entry is completed under the other budget."""
    data, catalog, _ = small
    per_replicate = 3.5 * 8 * 8 * (2 * 24 + 2 * 6)
    batches = []
    real = assign.ops.bootstrap_refit

    def recording(X, W, mask, generators, **kwargs):
        batches.append(len(generators))
        return real(X, W, mask, generators, **kwargs)

    monkeypatch.setattr(assign.ops, "bootstrap_refit", recording)
    kwargs = dict(n_replicates=7, seed=2, **CPU)
    _patched_budget(monkeypatch, int(2 * per_replicate) + 1)
    tight = port.bootstrap_exposures(data, catalog,
                                     checkpoint_dir=tmp_path, **kwargs)
    assert batches == [2, 2, 2, 1]
    _patched_budget(monkeypatch, int(3 * per_replicate) + 1)
    roomy = port.bootstrap_exposures(data, catalog, **kwargs)
    assert batches[4:] == [3, 3, 1]
    for frame in ("point", "mean", "std", "presence"):
        pd.testing.assert_frame_equal(getattr(tight, frame),
                                      getattr(roomy, frame))
    (tmp_path / "replicate_000004.npz").unlink()  # killed mid-run
    del batches[:]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        resumed = port.bootstrap_exposures(data, catalog,
                                           checkpoint_dir=tmp_path, **kwargs)
    assert batches == [1]
    pd.testing.assert_frame_equal(resumed.mean, tight.mean)


def test_refit_lanes_equal_each_lane_alone():
    """ops.refit_exposures_lanes: a lane's exposures are bit-equal
    whichever lanes share its batch, and equal to refit_exposures on its
    counts alone (a batched product may round its last bit another way)."""
    rng = np.random.default_rng(4)
    W = rng.dirichlet(np.ones(10), size=3).T
    X = rng.poisson(rng.uniform(5, 200, (4, 10, 6))).astype(np.float64)
    mask = torch.ones((3, 6), dtype=torch.bool)
    mask[1, 2] = False
    lanes = assign.ops.refit_exposures_lanes(
        torch.as_tensor(X), torch.as_tensor(W), mask, max_iterations=400)
    for b in range(4):
        alone, _ = assign.ops.refit_exposures(
            torch.as_tensor(X[b]), torch.as_tensor(W), mask,
            max_iterations=400)
        np.testing.assert_allclose(lanes[b].numpy(), alone.numpy(),
                                   rtol=1e-9)
        single = assign.ops.refit_exposures_lanes(
            torch.as_tensor(X[b:b + 1]), torch.as_tensor(W), mask,
            max_iterations=400)
        assert torch.equal(lanes[b], single[0])
    assert bool((lanes[:, 1, 2] == 0).all())
