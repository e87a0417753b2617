"""salamander_tpu_torch.ops.assign against salamander_tpu.ops.assign at
float64 on the CPU: the same numpy inputs through both. Exposures and KLs
at rtol 1e-10 with equal masks, round counts and iteration counts, on the
24 x 8 x 6 synthetic problem of tests/test_assign.py and on PCAWG SBS (96
channels x 32 samples) against COSMIC v3.3.1 (79 signatures). The
resampler cannot reproduce jax.random, so its contract is tested instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salamander_tpu import datasets as jax_datasets
from salamander_tpu.assign import _align_catalog as jax_align_catalog
from salamander_tpu.ops import assign as jax_ops
from salamander_tpu_torch.ops import assign as ops
from salamander_tpu_torch.ops import klnmf as port_klnmf

torch.set_num_threads(1)

RTOL = 1e-10


def synthetic(seed=0, n_features=24, n_samples=8, n_catalog=6,
              active_per_sample=2, scale=2_000.0):
    """tests/test_assign.py's exactly factorizable counts over a
    well-separated catalog, with Poisson noise so supports are decided."""
    rng = np.random.default_rng(seed)
    W = np.full((n_features, n_catalog), 0.01)
    block = n_features // n_catalog
    for k in range(n_catalog):
        W[k * block:(k + 1) * block, k] += 1.0
    W /= W.sum(axis=0, keepdims=True)
    H = np.zeros((n_catalog, n_samples))
    for d in range(n_samples):
        active = rng.choice(n_catalog, size=active_per_sample, replace=False)
        H[active, d] = scale * (0.5 + rng.random(active_per_sample))
    X = rng.poisson(W @ H).astype(np.float64) + np.finfo(np.float32).eps
    return X, W


def pcawg_cosmic(n_samples=32):
    counts = jax_datasets.load_pcawg_sbs().iloc[:n_samples]
    W, _ = jax_align_catalog(jax_datasets.load_cosmic_sbs_catalog(),
                             counts.columns.astype(str))
    return np.ascontiguousarray(counts.to_numpy(dtype=np.float64).T), W


PROBLEMS = {"synthetic": synthetic, "pcawg_cosmic": pcawg_cosmic}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def problem(request):
    return PROBLEMS[request.param]()


def t(array):
    return torch.as_tensor(np.asarray(array))


def test_init_exposures(problem):
    X, W = problem
    mask = np.random.default_rng(1).random((W.shape[1], X.shape[1])) < 0.6
    np.testing.assert_array_equal(
        ops.init_exposures(t(X), t(W), t(mask)).numpy(),
        np.asarray(jax_ops.init_exposures(X, W, mask)))


@pytest.mark.parametrize("masked", [False, True])
def test_refit_exposures(problem, masked):
    X, W = problem
    K, D = W.shape[1], X.shape[1]
    mask = (np.random.default_rng(2).random((K, D)) < 0.5) if masked \
        else np.ones((K, D), dtype=bool)
    mask[0] = True
    H_j, n_j = jax.jit(jax_ops.refit_exposures,
                       static_argnames=("max_iterations", "conv_test_freq"))(
        X, W, mask, max_iterations=3000, tol=1e-9)
    H_t, n_t = ops.refit_exposures(t(X), t(W), t(mask),
                                   max_iterations=3000, tol=1e-9)
    assert n_t == int(n_j)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_array_equal(H_t.numpy() == 0, ~mask)


def test_eliminate_signatures(problem):
    X, W = problem
    kwargs = dict(candidate_iters=10, polish_iterations=20,
                  max_polish_iterations=2000)
    out_j = jax_ops.eliminate_signatures(X, W, 0.02, 0.0, **kwargs)
    out_t = ops.eliminate_signatures(t(X), t(W), 0.02, 0.0, **kwargs)
    assert out_t["n_rounds"] == int(out_j["n_rounds"])
    np.testing.assert_array_equal(out_t["mask"].numpy(),
                                  np.asarray(out_j["mask"]))
    np.testing.assert_array_equal(out_t["n_active"].numpy(),
                                  np.asarray(out_j["n_active"]))
    assert out_t["mask"].dtype == torch.int32
    for key in ("H", "kl_dense", "kl_sparse"):
        np.testing.assert_allclose(out_t[key].numpy(),
                                   np.asarray(out_j[key]), rtol=RTOL,
                                   atol=1e-300)
    # the budget holds exactly in the reported numbers
    budget = 1.02 * out_t["kl_dense"]
    assert bool((out_t["kl_sparse"] <= budget).all())
    # sparser than dense somewhere
    assert int(out_t["n_active"].min()) < W.shape[1]


def test_argmin_takes_the_first_minimum():
    """Two identical catalog columns tie exactly in every candidate KL:
    both packages remove the first of them."""
    X, W = synthetic(seed=4)
    W = np.concatenate([W, W[:, :1]], axis=1)  # column 6 repeats column 0
    kwargs = dict(candidate_iters=5, polish_iterations=5,
                  max_polish_iterations=200)
    out_j = jax_ops.eliminate_signatures(X, W, 0.5, 0.0, **kwargs)
    out_t = ops.eliminate_signatures(t(X), t(W), 0.5, 0.0, **kwargs)
    np.testing.assert_array_equal(out_t["mask"].numpy(),
                                  np.asarray(out_j["mask"]))
    cand = torch.tensor([[1.0, 3.0], [1.0, 2.0], [5.0, 2.0]])
    assert torch.argmin(cand, 0).tolist() == [0, 1]
    assert jnp.argmin(jnp.asarray(cand.numpy()), 0).tolist() == [0, 1]


def test_all_active_masked_step_is_update_H_bitwise(problem):
    X, W = problem
    rng = np.random.default_rng(5)
    H = rng.uniform(1.0, 100.0, (W.shape[1], X.shape[1]))
    mask = torch.ones(H.shape, dtype=torch.bool)
    np.testing.assert_array_equal(
        ops._masked_mu_step(t(X), t(W), t(H), mask).numpy(),
        port_klnmf.update_H(t(X), t(W), t(H)).numpy())


def test_finalize_contract_fallback_chain():
    """tests/test_assign.py:118 in the port: an over-budget final state
    falls back to the accepted state (same support), an over-budget
    accepted state to the dense refit (full support), and the reported
    kl_sparse is the SELECTED evaluation."""
    X, W = synthetic(seed=11)
    K, D = W.shape[1], X.shape[1]
    X_t, W_t = t(X), t(W)
    H_dense = ops.refit_exposures(X_t, W_t, torch.ones((K, D), dtype=bool),
                                  max_iterations=2000)[0]
    out = ops.eliminate_signatures(X_t, W_t, rel_tol=0.05,
                                   candidate_iters=30)
    mask = out["mask"].bool()
    H_good = out["H"]
    rel_tol, abs_tol = 0.05, 0.0

    H_bad_final = H_good.clone()
    H_bad_final[:, 0] *= 3.0
    m, H, kd, ks, _ = ops._finalize_contract(
        X_t, W_t, mask, H_bad_final, H_good, H_dense, rel_tol, abs_tol)
    assert bool((ks <= (1.0 + rel_tol) * kd + abs_tol).all())
    assert torch.equal(H[:, 0], H_good[:, 0])
    assert torch.equal(m, mask)

    H_bad_acc = H_good.clone()
    H_bad_acc[:, 0] *= 2.0
    m, H, kd, ks, n_active = ops._finalize_contract(
        X_t, W_t, mask, H_bad_final, H_bad_acc, H_dense, rel_tol, abs_tol)
    assert bool((ks <= (1.0 + rel_tol) * kd + abs_tol).all())
    assert float(ks[0]) == float(kd[0])
    assert bool(m[:, 0].all()) and int(n_active[0]) == K
    assert torch.equal(H[:, 0], H_dense[:, 0])
    assert torch.equal(m[:, 1:], mask[:, 1:])

    # the same chain in the JAX package, on the same states
    out_j = jax_ops._finalize_contract(
        X, W, mask.numpy(), H_bad_final.numpy(), H_bad_acc.numpy(),
        H_dense.numpy(), rel_tol, abs_tol)
    for port_value, jax_value in zip((m, H, kd, ks, n_active), out_j):
        np.testing.assert_allclose(port_value.numpy().astype(float),
                                   np.asarray(jax_value).astype(float),
                                   rtol=RTOL)


def test_bootstrap_refit_flat_refit_of_jax_resamples():
    """bootstrap_refit's flat refit fed the JAX resamples: the port's
    refit of the same (V, B*D) columns equals the JAX program's H."""
    X, W = synthetic(seed=6)
    K, D = W.shape[1], X.shape[1]
    mask = np.ones((K, D), dtype=bool)
    key = jax.random.PRNGKey(3)
    H_j = jax_ops.bootstrap_refit(X, W, mask, key, 5, max_iterations=2000)
    X_boot = np.asarray(jax_ops.resample_counts(jnp.asarray(X), key, 4))
    X_all = np.concatenate([X[None], X_boot], axis=0)
    X_flat = np.swapaxes(X_all, 0, 1).reshape(X.shape[0], 5 * D)
    H_flat, _ = ops.refit_exposures(t(X_flat), t(W),
                                    torch.ones((K, 5 * D), dtype=bool),
                                    max_iterations=2000)
    H_t = H_flat.reshape(K, 5, D).transpose(0, 1)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=RTOL)


def test_bootstrap_refit_shapes_and_point():
    X, W = synthetic(seed=6)
    K, D = W.shape[1], X.shape[1]
    mask = torch.ones((K, D), dtype=bool)

    def generators(seeds):
        return [None if seed is None else torch.Generator().manual_seed(seed)
                for seed in seeds]

    H = ops.bootstrap_refit(t(X), t(W), mask, generators([None, 0, 1, 2]),
                            max_iterations=500)
    assert tuple(H.shape) == (4, K, D)
    assert bool(torch.isfinite(H).all())
    # a None lane is the refit of X itself; a resample depends on its own
    # generator alone, not on the lanes that share its batch
    point, _ = ops.refit_exposures(t(X), t(W), mask, max_iterations=500)
    np.testing.assert_allclose(H[0].numpy(), point.numpy(), rtol=1e-9)
    alone = ops.bootstrap_refit(t(X), t(W), mask, generators([2]),
                                max_iterations=500)
    assert torch.equal(alone[0], H[3])


# ------------------------------------------------------------------ #
# the resampler's contract
# ------------------------------------------------------------------ #


def counts():
    rng = np.random.default_rng(8)
    X = rng.poisson(rng.uniform(0.0, 40.0, (12, 5))).astype(np.float64)
    X[:, 2] += 1.0
    X[3, :] = 0.0
    return X


def test_multinomial_totals_exact_and_zero_features_stay_zero():
    X = counts()
    draws = ops.resample_counts(t(X), torch.Generator().manual_seed(1), 50)
    assert tuple(draws.shape) == (50, 12, 5)
    np.testing.assert_array_equal(draws.sum(1).numpy(),
                                  np.broadcast_to(X.sum(0), (50, 5)))
    assert bool((draws[:, 3] == 0).all()) and bool((draws >= 0).all())
    assert bool((draws == torch.round(draws)).all())


def test_multinomial_mean_within_four_standard_errors():
    X = counts()
    n = 2000
    draws = ops.resample_counts(t(X), torch.Generator().manual_seed(2),
                                n).numpy()
    totals, p = X.sum(0), X / X.sum(0)
    standard_error = np.sqrt(totals * p * (1 - p) / n)
    deviation = np.abs(draws.mean(0) - X)
    assert (deviation <= 4 * standard_error + 1e-12).all()


def test_poisson_totals_vary():
    X = counts()
    draws = ops.resample_counts(t(X), torch.Generator().manual_seed(3), 20,
                                method="poisson")
    totals = draws.sum(1).numpy()
    assert len(np.unique(totals[:, 0])) > 1
    assert draws.dtype == torch.float64


def test_same_generator_seed_same_draws():
    X = t(counts())
    for method in ("multinomial", "poisson"):
        a = ops.resample_counts(X, torch.Generator().manual_seed(9), 6,
                                method)
        b = ops.resample_counts(X, torch.Generator().manual_seed(9), 6,
                                method)
        c = ops.resample_counts(X, torch.Generator().manual_seed(10), 6,
                                method)
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_unknown_method_error_text_matches_jax():
    X = counts()
    with pytest.raises(ValueError) as port_error:
        ops.resample_counts(t(X), torch.Generator(), 2, method="jackknife")
    with pytest.raises(ValueError) as jax_error:
        jax_ops.resample_counts(jnp.asarray(X), jax.random.PRNGKey(0), 2,
                                method="jackknife")
    assert str(port_error.value) == str(jax_error.value)
