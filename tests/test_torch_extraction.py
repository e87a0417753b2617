"""salamander_tpu_torch.extraction against salamander_tpu.extraction at
float64 on the CPU. The bootstrap resamples and the lane inits cannot
reproduce jax.random, so the discovery fit is fed the JAX package's
_prepare_lanes outputs (per-lane W, losses and iterations at rtol 1e-8
with equal counts), the host clustering is bit-equal on the same stacks,
and the rest pins the pipeline's own contracts: the grouped (kernel)
layout equals the padded one per lane, a rank's lanes do not depend on the
other ranks or the chunking, the planted rank is recovered, given
signatures, MvNMF and checkpoint resume."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import extraction as jax_ext
from salamander_tpu.engine import FitConfig as JaxFitConfig
from salamander_tpu.engine import make_fit_function
from salamander_tpu.models.signature_nmf import promote_objective
from salamander_tpu.ops import klnmf as jax_klnmf
from salamander_tpu.ops import mvnmf as jax_mvnmf
from salamander_tpu_torch import extraction
from salamander_tpu_torch.engine import FitConfig

torch.set_num_threads(1)

RTOL = 1e-8
EPS = float(np.finfo(np.float32).eps)
KWARGS = dict(seed=0, min_iterations=100, max_iterations=2000,
              device="cpu")


@pytest.fixture(scope="module")
def planted():
    """tests/test_extraction.py's Poisson counts with k_true = 3
    well-separated signatures (16 channels x 60 samples)."""
    rng = np.random.default_rng(7)
    n_features, n_samples, k_true = 16, 60, 3
    W = rng.dirichlet(np.full(n_features, 0.4), size=k_true)
    H = rng.gamma(2.0, 50.0, size=(n_samples, k_true))
    X = rng.poisson(H @ W).astype(float)
    data = pd.DataFrame(
        X,
        index=[f"s{i}" for i in range(n_samples)],
        columns=[f"v{j}" for j in range(n_features)],
    )
    return data, W


@pytest.fixture(scope="module")
def extracted(planted):
    data, _ = planted
    return port.extract_signatures(data, ranks=range(2, 5), n_bootstraps=6,
                                   **KWARGS)


# ------------------------------------------------------------------ #
# host clustering: bit-equal on the same stacks
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("k", [1, 3, 5])
def test_host_clustering_is_bit_equal(k):
    rng = np.random.default_rng(k)
    base = rng.dirichlet(np.ones(16), size=k)
    stack = np.stack([base[rng.permutation(k)]
                      + rng.uniform(0, 0.02, (k, 16)) for _ in range(7)])
    for a, b in zip(extraction._consensus_cluster(stack, 2),
                    jax_ext._consensus_cluster(stack, 2)):
        np.testing.assert_array_equal(a, b)
    matched = jax_ext._consensus_cluster(stack, 2)[1]
    np.testing.assert_array_equal(extraction._cluster_silhouettes(matched),
                                  jax_ext._cluster_silhouettes(matched))
    np.testing.assert_array_equal(extraction._unit_rows(stack),
                                  jax_ext._unit_rows(stack))


@pytest.mark.parametrize("min_sil, rule", [
    ([np.nan, 0.9, 0.5, 0.85], "largest"),
    ([np.nan, 0.9, 0.5, 0.85], "prefix"),
    ([0.95, 0.99, 0.97], "prefix"),
])
def test_suggest_rank_is_the_jax_rule(min_sil, rule):
    ranks = np.arange(1, len(min_sil) + 1)
    assert extraction._suggest_rank(ranks, min_sil, 0.8, rule) == \
        jax_ext._suggest_rank(ranks, min_sil, 0.8, rule)


# ------------------------------------------------------------------ #
# the discovery fit fed the JAX package's lanes
# ------------------------------------------------------------------ #


def jax_lanes(data, ranks, n_bootstraps, model="klnmf", n_given=0,
              W_given=None):
    X = jnp.asarray(np.maximum(data.to_numpy().T, EPS))
    key = jax.random.PRNGKey(4)
    X_boot = jax_ext._resample_all(X, key, n_bootstraps, "multinomial")
    lane_ranks = np.repeat(ranks, n_bootstraps)
    lane_replicates = np.tile(np.arange(n_bootstraps), len(ranks))
    params0, lane_data = jax_ext._prepare_lanes(
        X_boot, key, jnp.asarray(lane_ranks), jnp.asarray(lane_replicates),
        n_padded=n_given + max(ranks), with_gamma=model == "mvnmf",
        W_given=W_given, n_given=n_given,
    )
    return params0, lane_data, lane_ranks


def jax_discovery(params0, lane_data, config, model, n_given=0):
    if model == "mvnmf":
        update_fn, objective_fn = jax_mvnmf.make_masked_step_functions(
            0.5, 1.0, n_given_signatures=n_given)
    else:
        update_fn, objective_fn = jax_klnmf.make_masked_step_functions(
            n_given_signatures=n_given)
    promoted = promote_objective(objective_fn,
                                 jax.tree.map(lambda x: x[0], params0))
    run = make_fit_function(update_fn, promoted, JaxFitConfig(*config),
                            batched=True, batched_data=True)
    result = run(params0, lane_data)
    losses = jax.vmap(promoted, in_axes=(0, 0))(result.params, lane_data)
    return (np.asarray(result.params["W"]), np.asarray(losses),
            np.asarray(result.n_iterations))


def to_torch(tree):
    return {key: torch.as_tensor(np.array(value))
            for key, value in tree.items()}


@pytest.mark.parametrize("model, use_runner, n_given", [
    ("klnmf", False, 0), ("klnmf", True, 0), ("mvnmf", False, 0),
    ("klnmf", False, 1), ("mvnmf", True, 1),
])
def test_discovery_fit_fed_jax_lanes(planted, model, use_runner, n_given):
    data, W_true = planted
    W_given = None
    if n_given:
        W_given = np.maximum(W_true[:1].T, EPS)
        W_given = W_given / W_given.sum(0)
    config = FitConfig(min_iterations=50, max_iterations=400,
                       conv_test_freq=10, tol=1e-6)
    params0, lane_data, lane_ranks = jax_lanes(data, [2, 3], 4, model,
                                               n_given, W_given)
    W_j, losses_j, iterations_j = jax_discovery(params0, lane_data, config,
                                                model, n_given)
    W_t, losses_t, iterations_t = extraction._discovery_fit(
        to_torch(params0), to_torch(lane_data), config, model, 0.5, 1.0,
        n_given, use_runner)
    np.testing.assert_array_equal(iterations_t.numpy(), iterations_j)
    if not n_given:  # (with one frozen signature every lane hits the cap)
        assert len(set(iterations_j)) > 1
    np.testing.assert_allclose(losses_t.numpy(), losses_j, rtol=RTOL)
    np.testing.assert_allclose(W_t.numpy(), W_j, rtol=RTOL, atol=1e-300)
    if n_given:
        assert np.array_equal(W_t.numpy()[:, :, 0],
                              np.broadcast_to(W_given[:, 0], (8, 16)))


def test_lane_init_fed_jax_draws_matches_jax(planted):
    """_lane_init's arithmetic: from the exponential draws the JAX
    package's _lane_init makes, the same (W, H)."""
    data, _ = planted
    X = np.maximum(data.to_numpy().T, EPS)
    key = jax.random.PRNGKey(2)
    mask = np.arange(4) < 3
    W_j, H_j = jax_ext._lane_init(key, jnp.asarray(X), jnp.asarray(mask))
    key_w, key_h = jax.random.split(key)
    draws_w = np.stack([np.asarray(jax.random.exponential(
        jax.random.fold_in(key_w, j), (16,), jnp.float64)) for j in range(4)])
    draws_h = np.stack([np.asarray(jax.random.exponential(
        jax.random.fold_in(key_h, j), (60,), jnp.float64)) for j in range(4)])
    W_t, H_t = extraction._lane_init(
        torch.as_tensor(X)[None], torch.as_tensor(draws_w)[None],
        torch.as_tensor(draws_h)[None], torch.as_tensor(mask)[None])
    np.testing.assert_allclose(W_t[0].numpy(), np.asarray(W_j), rtol=1e-14)
    np.testing.assert_allclose(H_t[0].numpy(), np.asarray(H_j), rtol=1e-14)
    assert (H_t[0, 3] == 0).all()


# ------------------------------------------------------------------ #
# the port's own contracts
# ------------------------------------------------------------------ #


def test_grouped_layout_equals_padded_per_lane(planted):
    """The grouped layout (each rank's lanes unpadded: the kernel's route
    on a card) against the padded masked batch, on the same lanes."""
    data, _ = planted
    X = torch.as_tensor(np.maximum(data.to_numpy().T, EPS))
    X_boot = extraction._resample_all(X, torch.Generator().manual_seed(3),
                                      4, "multinomial")
    lane_ranks = np.repeat([2, 3, 4], 4)
    params0, lane_data = extraction._prepare_lanes(
        X_boot, 3, lane_ranks, np.tile(np.arange(4), 3), 4)
    config = FitConfig(min_iterations=50, max_iterations=600, tol=1e-6)
    padded = extraction._discovery_fit(params0, lane_data, config, "klnmf",
                                       1.0, 1.0, 0, False)
    for use_runner in (False, True):
        grouped = extraction._grouped_fit(params0, lane_data, lane_ranks,
                                          config, use_runner)
        np.testing.assert_array_equal(grouped[2].numpy(), padded[2].numpy())
        np.testing.assert_allclose(grouped[1].numpy(), padded[1].numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(grouped[0].numpy(), padded[0].numpy(),
                                   rtol=1e-10, atol=1e-300)


def test_grouped_pipeline_equals_padded(planted, monkeypatch):
    data, _ = planted
    kwargs = dict(ranks=[2, 3], n_bootstraps=4, fit_final=False, **KWARGS)
    padded = port.extract_signatures(data, **kwargs)
    assert padded.layout == "padded"
    monkeypatch.setattr(extraction, "_choose_layout",
                        lambda *args: "grouped")
    grouped = port.extract_signatures(data, **kwargs)
    assert grouped.layout == "grouped"
    for k in (2, 3):
        np.testing.assert_array_equal(grouped.replicate_iterations[k],
                                      padded.replicate_iterations[k])
        np.testing.assert_allclose(grouped.replicate_losses[k],
                                   padded.replicate_losses[k], rtol=1e-12)
    np.testing.assert_allclose(grouped.table.to_numpy(),
                               padded.table.to_numpy(), rtol=1e-8)


def test_layout_choice():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    assert extraction._choose_layout("klnmf", f32, 0, [2, 10], 96, 192,
                                     cuda) == "grouped"
    for args in (("mvnmf", f32, 0), ("klnmf", f64, 0), ("klnmf", f32, 1)):
        assert extraction._choose_layout(*args, [2, 10], 96, 192,
                                         cuda) == "padded"
    assert extraction._choose_layout("klnmf", f32, 0, [2], 96, 192,
                                     cpu) == "padded"
    assert extraction._choose_layout("klnmf", f32, 0, [40], 96, 192,
                                     cuda) == "padded"  # K above K_MAX


def test_recovers_planted_rank_and_signatures(planted, extracted):
    _, W_true = planted
    assert extracted.suggested_rank == 3
    consensus = extracted.consensus[3].to_numpy()
    units = consensus / np.linalg.norm(consensus, axis=1, keepdims=True)
    planted_units = W_true / np.linalg.norm(W_true, axis=1, keepdims=True)
    sim = planted_units @ units.T
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(1.0 - sim)
    assert np.all(sim[rows, cols] > 0.98)
    assert (extracted.table.loc[4, "min_stability"]
            < extracted.table.loc[3, "min_stability"])
    losses = extracted.table["best_loss"].to_numpy()
    assert np.all(np.diff(losses) < 0)
    for k in (2, 3, 4):
        assert extracted.consensus[k].shape == (k, 16)
        np.testing.assert_allclose(extracted.consensus[k].sum(axis=1), 1.0,
                                   rtol=1e-12)
        assert extracted.exposures[k].shape == (60, k)
        assert extracted.matched[k].shape == (6, k, 16)
        assert extracted.replicate_losses[k].shape == (6,)
    model = extracted.model
    assert type(model).__name__ == "KLNMF"
    np.testing.assert_allclose(model.signatures.to_numpy(),
                               extracted.consensus[3].to_numpy(), rtol=1e-6)


def test_lanes_do_not_depend_on_rank_sets_or_chunks(planted, extracted):
    """A rank's lanes depend only on (seed, rank, replicate): the same
    results whichever other ranks share the batch, however far it is
    padded, and however the lanes are chunked."""
    data, _ = planted
    kwargs = dict(n_bootstraps=6, fit_final=False, **KWARGS)
    solo = port.extract_signatures(data, ranks=[3], **kwargs)
    pair = port.extract_signatures(data, ranks=[2, 3], **kwargs)
    chunked = port.extract_signatures(data, ranks=[2, 3], max_lane_gb=1e-4,
                                      **kwargs)
    for other in (pair, chunked, extracted):
        np.testing.assert_array_equal(solo.replicate_iterations[3],
                                      other.replicate_iterations[3])
        np.testing.assert_allclose(solo.replicate_losses[3],
                                   other.replicate_losses[3], rtol=1e-12)
        np.testing.assert_allclose(solo.consensus[3].to_numpy(),
                                   other.consensus[3].to_numpy(),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(pair.replicate_losses[2],
                                  chunked.replicate_losses[2])
    pd.testing.assert_frame_equal(pair.table, chunked.table)
    with pytest.raises(ValueError, match="max_lane_gb"):
        port.extract_signatures(data, ranks=[2], max_lane_gb=0.0, **kwargs)


def test_compacted_equals_monolithic_and_residency(planted, monkeypatch):
    data, _ = planted
    kwargs = dict(ranks=[2, 3], n_bootstraps=8, fit_final=False,
                  max_lane_gb=1e-4, **dict(KWARGS, max_iterations=500))
    plain = port.extract_signatures(data, compact=False, **kwargs)
    compacted = port.extract_signatures(data, compact=True, **kwargs)
    monkeypatch.setattr(extraction, "_BOOT_RESIDENT_BUDGET_BYTES", 0)
    redrawn = port.extract_signatures(data, compact=False, **kwargs)
    for other in (compacted, redrawn):
        for k in (2, 3):
            np.testing.assert_array_equal(other.replicate_losses[k],
                                          plain.replicate_losses[k])
            np.testing.assert_array_equal(other.replicate_iterations[k],
                                          plain.replicate_iterations[k])
        pd.testing.assert_frame_equal(other.table, plain.table)


def test_given_signatures_semisupervised(planted):
    data, W_true = planted
    given = pd.DataFrame(W_true[:1], index=["Known1"], columns=data.columns)
    result = port.extract_signatures(data, ranks=[1, 2, 3], n_bootstraps=6,
                                     given_signatures=given, **KWARGS)
    assert result.suggested_rank == 2
    cons = result.consensus[2]
    assert list(cons.index) == ["Known1", "Sig1", "Sig2"]
    aligned = np.maximum(W_true[0], EPS)
    aligned = aligned / aligned.sum()
    np.testing.assert_array_equal(cons.to_numpy()[0], aligned)
    assert result.silhouettes[2].shape == (2,)
    assert result.exposures[2].shape == (data.shape[0], 3)
    np.testing.assert_array_equal(
        np.asarray(result.model.asignatures.X)[0], aligned)


def test_mvnmf_extraction(planted):
    data, W_true = planted
    result = port.extract_signatures(
        data, ranks=range(2, 5), n_bootstraps=4, model="mvnmf", lam=0.5,
        **dict(KWARGS, max_iterations=1500))
    assert result.suggested_rank == 3
    assert isinstance(result.model, port.MvNMF) and result.model.lam == 0.5
    consensus = result.consensus[3].to_numpy()
    H = result.exposures[3].to_numpy().T
    X = data.to_numpy().T.astype(np.float64)
    recon = consensus.T @ H
    positive = X > 0
    kl = float(np.sum(X[positive] * np.log(X[positive] / recon[positive]))
               - X.sum() + recon.sum())
    _, logdet = np.linalg.slogdet(consensus @ consensus.T + np.eye(3))
    np.testing.assert_allclose(result.table.loc[3, "best_loss"],
                               kl + 0.5 * logdet, rtol=1e-10)


def test_checkpoint_full_and_partial_resume(planted, tmp_path, monkeypatch):
    data, _ = planted
    kwargs = dict(ranks=[2, 3], n_bootstraps=4, fit_final=False,
                  max_lane_gb=1e-4, checkpoint_dir=tmp_path,
                  **dict(KWARGS, max_iterations=500))
    first = port.extract_signatures(data, **kwargs)
    entries = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert "rank_002.npz" in entries and "lane_000000.npz" in entries
    assert len([e for e in entries if e.startswith("lane_")]) == 8

    calls = {"fit": 0, "refit": 0}
    real_fit = extraction._discovery_fit
    from salamander_tpu_torch.ops import assign as port_assign

    real_refit = port_assign.refit_exposures

    def counting_fit(*args, **fkwargs):
        calls["fit"] += 1
        return real_fit(*args, **fkwargs)

    def counting_refit(*args, **rkwargs):
        calls["refit"] += 1
        return real_refit(*args, **rkwargs)

    monkeypatch.setattr(extraction, "_discovery_fit", counting_fit)
    monkeypatch.setattr(port_assign, "refit_exposures", counting_refit)
    resumed = port.extract_signatures(data, **kwargs)
    assert calls == {"fit": 0, "refit": 0}
    pd.testing.assert_frame_equal(resumed.table, first.table)
    (tmp_path / "lane_000000.npz").unlink()
    (tmp_path / "rank_003.npz").unlink()
    partial = port.extract_signatures(data, **kwargs)
    assert calls == {"fit": 1, "refit": 1}
    pd.testing.assert_frame_equal(partial.table, first.table)
    with pytest.warns(UserWarning, match="different run"):
        port.extract_signatures(data, **dict(kwargs, dtype="float32"))


def test_memory_budget_decides_no_result_and_no_store(planted, tmp_path,
                                                      monkeypatch):
    """Two memory budgets that chunk the lanes differently give equal
    results, and a store written under one resumes under the other (the
    budget is a function of the device, never of its free memory)."""
    from salamander_tpu_torch import assign

    data, _ = planted
    kwargs = dict(ranks=[2, 3], n_bootstraps=4, fit_final=False,
                  **dict(KWARGS, max_iterations=500))
    sizes = []
    real_chunk = extraction._lane_chunk_size

    def recording_chunk(*args, **ckwargs):
        sizes.append(real_chunk(*args, **ckwargs))
        return sizes[-1]

    monkeypatch.setattr(extraction, "_lane_chunk_size", recording_chunk)
    monkeypatch.setattr(assign, "_memory_budget", lambda device: 120_000)
    roomy = port.extract_signatures(data, checkpoint_dir=tmp_path, **kwargs)
    monkeypatch.setattr(assign, "_memory_budget", lambda device: 50_000)
    tight = port.extract_signatures(data, **kwargs)
    assert sizes[0] != sizes[1] and max(sizes) < 8
    for k in (2, 3):
        np.testing.assert_array_equal(roomy.replicate_losses[k],
                                      tight.replicate_losses[k])
        np.testing.assert_array_equal(roomy.replicate_iterations[k],
                                      tight.replicate_iterations[k])
    pd.testing.assert_frame_equal(roomy.table, tight.table)

    calls = []
    real_fit = extraction._discovery_fit
    monkeypatch.setattr(extraction, "_discovery_fit",
                        lambda *a, **k: calls.append(1) or real_fit(*a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "different run" warning
        resumed = port.extract_signatures(data, checkpoint_dir=tmp_path,
                                          **kwargs)
    assert calls == []
    pd.testing.assert_frame_equal(resumed.table, roomy.table)


def test_invalid_inputs(planted):
    data, _ = planted
    for bad, match in ((dict(ranks=[0]), "positive"),
                       (dict(ranks=[2], n_bootstraps=0), "n_bootstraps"),
                       (dict(ranks=[2], model="svd"), "model"),
                       (dict(ranks=[2], rank_rule="best"), "rank_rule"),
                       (dict(ranks=[61]), "exceeds")):
        with pytest.raises(ValueError, match=match):
            port.extract_signatures(data, **dict(dict(device="cpu"), **bad))
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.extract_signatures(data, ranks=[2], mesh=object(), device="cpu")


def test_extraction_on_a_mesh_of_one(planted):
    """mesh= (ROADMAP item 18) on a world of one is the meshless
    extraction, bit for bit (a lane's resample and start are keyed). The
    JAX package draws its resamples with jax.random, so its mesh run is
    no reference; the spawned world of test_torch_mesh_paths.py shards
    the lanes and samples over ranks."""
    import torch.distributed as dist

    data, _ = planted
    kwargs = dict(ranks=[2, 3], n_bootstraps=3, **KWARGS)
    plain = port.extract_signatures(data, **kwargs)
    try:
        sharded = port.extract_signatures(
            data, mesh=port.make_mesh(device="cpu"), **kwargs)
    finally:
        dist.destroy_process_group()
    pd.testing.assert_frame_equal(sharded.table, plain.table,
                                  check_exact=True)
    for k in (2, 3):
        np.testing.assert_array_equal(sharded.replicate_losses[k],
                                      plain.replicate_losses[k])
        np.testing.assert_array_equal(sharded.consensus[k].to_numpy(),
                                      plain.consensus[k].to_numpy())
