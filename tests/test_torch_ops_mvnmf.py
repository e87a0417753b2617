"""salamander_tpu_torch.ops.mvnmf against salamander_tpu.ops.mvnmf on the
same numpy inputs at float64: every function, batched over lanes, at rtol
1e-10 (the batched torch.linalg Cholesky differs from the JAX package's
unrolled one only in rounding); the line search lane by lane against the
JAX serial search, gamma exactly; the rank-masked twins at rank k inside a
padded Kp."""

import numpy as np
import pytest
import torch

from salamander_tpu import datasets as jax_datasets
from salamander_tpu.ops import klnmf as jax_klnmf
from salamander_tpu.ops import mvnmf as jax_mvnmf
from salamander_tpu_torch.ops import klnmf as port_klnmf
from salamander_tpu_torch.ops import mvnmf

torch.set_num_threads(1)

RTOL = 1e-10
LAM, DELTA = 1.0, 1.0
N_SAMPLES = 32


@pytest.fixture(scope="module")
def X():
    frame = jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    return np.ascontiguousarray(frame.to_numpy().T, dtype=np.float64)


def lanes(X, K, R, seed):
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(X.shape[0]), (R, K)).transpose(0, 2, 1)
    H = rng.uniform(1.0, 200.0, (R, K, X.shape[1]))
    return np.ascontiguousarray(W), H


def t(array):
    return torch.as_tensor(np.asarray(array))


def per_lane(fn, *arrays):
    return np.stack([np.asarray(fn(*lane)) for lane in zip(*arrays)])


@pytest.mark.parametrize("K", [1, 3, 6])
def test_objective_and_volume_match_jax(X, K):
    W, H = lanes(X, K, 4, seed=K)
    np.testing.assert_allclose(
        mvnmf.volume_logdet(t(W), DELTA).numpy(),
        per_lane(lambda w: jax_mvnmf.volume_logdet(w, DELTA), W), rtol=RTOL)
    np.testing.assert_allclose(
        mvnmf.kl_divergence_penalized(t(X), t(W), t(H), LAM, 0.5).numpy(),
        per_lane(lambda w, h: jax_mvnmf.kl_divergence_penalized(
            X, w, h, LAM, 0.5), W, H), rtol=RTOL)
    # one problem without a lane axis gives a 0-d value
    single = mvnmf.kl_divergence_penalized(t(X), t(W[0]), t(H[0]), LAM,
                                           DELTA)
    assert single.dim() == 0


@pytest.mark.parametrize("K, n_given", [(3, 0), (4, 0), (4, 2), (3, 3)])
def test_update_W_unconstrained_matches_jax(X, K, n_given):
    W, H = lanes(X, K, 3, seed=10 + K)
    port = mvnmf.update_W_unconstrained(t(X), t(W), t(H), LAM, DELTA,
                                        n_given).numpy()
    expected = per_lane(lambda w, h: jax_mvnmf.update_W_unconstrained(
        X, w, h, LAM, DELTA, n_given), W, H)
    np.testing.assert_allclose(port, expected, rtol=RTOL)
    assert np.array_equal(port[:, :, :n_given], W[:, :, :n_given])


def run_in(X, W, H, n_iterations):
    """A few JAX MvNMF iterations so the state is typical."""
    gamma = 1.0
    for _ in range(n_iterations):
        H = jax_klnmf.update_H(X, W, H)
        W_unc = jax_mvnmf.update_W_unconstrained(X, W, H, LAM, DELTA)
        W, H, gamma = jax_mvnmf.line_search(X, W, H, LAM, DELTA, gamma,
                                            W_unc)
    return np.asarray(W), np.asarray(H), float(gamma)


@pytest.fixture(scope="module")
def search_lanes(X):
    """Five lanes of one line search: the genuine step, an adversarial
    step from gamma 1 and 0.3, gamma already below the floor, and a lane
    whose every trial is worse, so it backtracks to the gamma floor."""
    W, H = lanes(X, 3, 1, seed=5)
    W, H, _ = run_in(X, W[0], H[0], 10)
    rng = np.random.default_rng(7)
    W_bad = rng.dirichlet(np.ones(X.shape[0]) * 0.05, 3).T
    W_genuine = np.asarray(jax_mvnmf.update_W_unconstrained(
        X, W, jax_klnmf.update_H(X, W, H), LAM, DELTA))
    cases = [
        (W, H, W_genuine, 1.0),
        (W, H, W_bad, 1.0),
        (W, H, W_bad, 0.3),
        (W, H, W_bad, 1e-17),
        # columns summing to 0.5: every renormalized trial has a larger
        # volume term than the current point
        (0.5 * W, 2.0 * H, 0.5 * W, 1.0),
    ]
    return [np.stack(column) for column in zip(*cases)]


@pytest.mark.parametrize("trial_batch", [1, 3])
def test_line_search_lanes_equal_jax_serial(X, search_lanes, trial_batch):
    W, H, W_unc, gamma = search_lanes
    W_new, H_new, gamma_new = mvnmf.line_search(
        t(X), t(W), t(H), LAM, DELTA, t(gamma), t(W_unc),
        trial_batch=trial_batch)
    assert gamma_new.shape == (5,)
    for lane in range(5):
        W_j, H_j, g_j = jax_mvnmf.line_search(
            X, W[lane], H[lane], LAM, DELTA, gamma[lane], W_unc[lane])
        assert float(gamma_new[lane]) == float(g_j), lane
        np.testing.assert_allclose(W_new[lane].numpy(), W_j, rtol=RTOL)
        np.testing.assert_allclose(H_new[lane].numpy(), H_j, rtol=RTOL)
    # the floor lane ran 166 shrinks: 1.2 * 0.8**166 < 1e-16
    assert 0.0 < float(gamma_new[4]) < 1.2e-16
    assert float(gamma_new[3]) == 1.2 * 1e-17  # no trial below the floor


def test_line_search_batched_trials_match_jax_batched(X, search_lanes):
    W, H, W_unc, gamma = search_lanes
    out = mvnmf.line_search(t(X), t(W), t(H), LAM, DELTA, t(gamma),
                            t(W_unc), trial_batch=8)
    for lane in range(5):
        expected = jax_mvnmf.line_search(
            X, W[lane], H[lane], LAM, DELTA, gamma[lane], W_unc[lane],
            trial_batch=8)
        for port, jax_value in zip(out, expected):
            np.testing.assert_allclose(port[lane].numpy(),
                                       np.asarray(jax_value), rtol=RTOL)


def test_line_search_single_problem_and_never_worse(X, search_lanes):
    W, H, W_unc, _ = search_lanes
    before = float(mvnmf.kl_divergence_penalized(t(X), t(W[0]), t(H[0]),
                                                 LAM, DELTA))
    W_new, H_new, gamma = mvnmf.line_search(t(X), t(W[0]), t(H[0]), LAM,
                                            DELTA, 1.0, t(W_unc[0]))
    assert gamma.dim() == 0 and 0.0 < float(gamma) <= 1.0
    after = float(mvnmf.kl_divergence_penalized(t(X), W_new, H_new, LAM,
                                                DELTA))
    assert after <= before


def test_cholesky_never_raises_on_a_barely_indefinite_gram():
    """delta = 0 and two equal columns: the Gram is singular, and rounding
    leaves it indefinite. The JAX package floors the pivot; the port
    factors such a lane again with the floor on its diagonal, and leaves
    the healthy lane untouched."""
    column = np.full((8, 1), 1.0 / 8)
    W = np.stack([np.hstack([column, column]),
                  np.eye(8)[:, :2] * 0.5 + 0.0625])
    logdet = mvnmf.volume_logdet(t(W), 0.0)
    assert torch.isfinite(logdet).all()
    np.testing.assert_allclose(
        float(logdet[1]), float(jax_mvnmf.volume_logdet(W[1], 0.0)),
        rtol=RTOL)
    inverse = mvnmf._gram_inverse(mvnmf._gram(t(W), 0.0))
    assert torch.isfinite(inverse).all()


def padded_lanes(X, k, Kp, R, seed):
    W, H = lanes(X, k, R, seed)
    W_pad, H_pad, mask = port_klnmf.pad_rank(t(W), t(H), Kp)
    return W, H, W_pad, H_pad, mask.expand(R, Kp)


@pytest.mark.parametrize("k, Kp", [(2, 4), (3, 8), (4, 4)])
def test_masked_twins_equal_the_rank_k_values(X, k, Kp):
    W, H, W_pad, H_pad, mask = padded_lanes(X, k, Kp, 3, seed=20 + k)
    Xt = t(X)
    np.testing.assert_allclose(
        mvnmf.volume_logdet_masked(W_pad, DELTA, mask).numpy(),
        per_lane(lambda w: jax_mvnmf.volume_logdet(w, DELTA), W), rtol=RTOL)
    np.testing.assert_allclose(
        mvnmf.kl_divergence_penalized_masked(Xt, W_pad, H_pad, LAM, DELTA,
                                             mask).numpy(),
        per_lane(lambda w, h: jax_mvnmf.kl_divergence_penalized(
            X, w, h, LAM, DELTA), W, H), rtol=RTOL)
    W_unc, objective, _ = mvnmf.w_step_and_objective(Xt, W_pad, H_pad, LAM,
                                                     DELTA, mask=mask)
    np.testing.assert_allclose(
        objective.numpy(),
        per_lane(lambda w, h: jax_mvnmf.kl_divergence_penalized(
            X, w, h, LAM, DELTA), W, H), rtol=RTOL)
    np.testing.assert_allclose(
        W_unc[..., :k].numpy(),
        per_lane(lambda w, h: jax_mvnmf.update_W_unconstrained(
            X, w, h, LAM, DELTA), W, H), rtol=RTOL)
    assert torch.equal(W_unc[..., k:], W_pad[..., k:])
    gamma = torch.tensor([1.0, 0.5, 0.2], dtype=torch.float64)
    W_new, H_new, g_new = mvnmf.line_search_masked(
        Xt, W_pad, H_pad, LAM, DELTA, gamma, W_unc, mask)
    for lane in range(3):
        W_j, H_j, g_j = jax_mvnmf.line_search(
            X, W[lane], H[lane], LAM, DELTA, float(gamma[lane]),
            W_unc[lane, :, :k].numpy())
        assert float(g_new[lane]) == pytest.approx(float(g_j), rel=RTOL)
        np.testing.assert_allclose(W_new[lane, :, :k].numpy(), W_j,
                                   rtol=RTOL)
        np.testing.assert_allclose(H_new[lane, :k].numpy(), H_j, rtol=RTOL)
    assert torch.equal(H_new[:, k:], torch.zeros_like(H_new[:, k:]))
    assert torch.equal(W_new[..., k:], W_pad[..., k:])


def test_masked_step_functions_match_jax(X):
    """The engine step of the padded rank scans, against the JAX masked
    step on the same padded numpy lanes, over a few iterations."""
    W, H, W_pad, H_pad, mask = padded_lanes(X, 3, 4, 2, seed=31)
    update_t, objective_t = mvnmf.make_masked_step_functions(LAM, DELTA)
    update_j, objective_j = jax_mvnmf.make_masked_step_functions(LAM, DELTA)
    params_t = {"W": W_pad, "H": H_pad, "mask": mask,
                "gamma": torch.ones(2, dtype=torch.float64)}
    params_j = [{"W": W_pad[r].numpy(), "H": H_pad[r].numpy(),
                 "mask": mask[r].numpy(), "gamma": np.float64(1.0)}
                for r in range(2)]
    for _ in range(4):
        params_t = update_t(params_t, {"X": t(X)})
        params_j = [update_j(p, {"X": X}) for p in params_j]
    for r in range(2):
        for key in ("W", "H", "gamma"):
            np.testing.assert_allclose(params_t[key][r].numpy(),
                                       np.asarray(params_j[r][key]),
                                       rtol=RTOL)
        np.testing.assert_allclose(
            float(objective_t(params_t, {"X": t(X)})[r]),
            float(objective_j(params_j[r], {"X": X})), rtol=RTOL)
