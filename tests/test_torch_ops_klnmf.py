"""Every op of salamander_tpu_torch/ops/klnmf.py against
salamander_tpu/ops/klnmf.py on the same numpy inputs, at float64 and
rtol 1e-12 (the two differ only in summation order). Given signature
columns pass through bit-exactly."""

import jax
import numpy as np
import pytest
import torch

from salamander_tpu.ops import klnmf as jax_ops
from salamander_tpu_torch.ops import klnmf as torch_ops

torch.set_num_threads(1)

RTOL = 1e-12
V, K, D, R = 12, 3, 10, 4


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    X = rng.poisson(6.0, (V, D)).astype(float)
    X[0, :3] = 0.0  # exercise the X == 0 masking
    W = np.ascontiguousarray(rng.dirichlet(np.ones(V), K).T)
    H = rng.uniform(0.5, 30.0, (K, D))
    weights = {
        "weights_kl": rng.uniform(0.5, 2.0, D),
        "weights_lhalf": rng.uniform(0.1, 3.0, D),
        # quad << w^2: where the literal l1/2 closed form cancels
        "lhalf_small_quad": np.full(D, 1e5),
    }
    return X, W, H, weights


def to_torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def assert_same(actual, expected, rtol=RTOL):
    if isinstance(expected, (tuple, list)):
        for a, e in zip(actual, expected):
            assert_same(a, e, rtol)
        return
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=rtol, atol=0)


def weight_args(weights, kl, lhalf):
    w_kl = weights["weights_kl"] if kl else None
    w_lhalf = {None: None, "regular": weights["weights_lhalf"],
               "small_quad": weights["lhalf_small_quad"]}[lhalf]
    return w_kl, w_lhalf


@pytest.mark.parametrize("name", ["kl_divergence", "samplewise_kl_divergence"])
@pytest.mark.parametrize("weighted", [False, True])
def test_divergences(problem, name, weighted):
    X, W, H, weights = problem
    w = weights["weights_kl"] if weighted else None
    assert_same(getattr(torch_ops, name)(*to_torch(X, W, H, w)),
                getattr(jax_ops, name)(X, W, H, w))


@pytest.mark.parametrize("name", ["poisson_llh", "poisson_llh_wo_factorial"])
def test_poisson_likelihoods(problem, name):
    X, W, H, _ = problem
    assert_same(getattr(torch_ops, name)(*to_torch(X, W, H)),
                getattr(jax_ops, name)(X, W, H))


@pytest.mark.parametrize("kl", [False, True])
@pytest.mark.parametrize("lhalf", [None, "regular"])
def test_objective(problem, kl, lhalf):
    X, W, H, weights = problem
    w_kl, w_lhalf = weight_args(weights, kl, lhalf)
    assert_same(torch_ops.klnmf_objective(*to_torch(X, W, H, w_kl, w_lhalf)),
                jax_ops.klnmf_objective(X, W, H, w_kl, w_lhalf))


def test_lhalf_penalty_and_normalize(problem):
    X, W, H, weights = problem
    W_t, H_t, w_t = to_torch(W * 3.0, H, weights["weights_lhalf"])
    assert_same(torch_ops.lhalf_penalty(H_t, w_t),
                jax_ops.lhalf_penalty(H, weights["weights_lhalf"]))
    assert_same(torch_ops.normalize_wh(W_t, H_t),
                jax_ops.normalize_wh(W * 3.0, H))


@pytest.mark.parametrize("kl", [False, True])
@pytest.mark.parametrize("n_given", [0, 1, K])
def test_update_W(problem, kl, n_given):
    X, W, H, weights = problem
    w_kl = weights["weights_kl"] if kl else None
    actual = torch_ops.update_W(*to_torch(X, W, H, w_kl), n_given)
    expected = np.asarray(jax_ops.update_W(X, W, H, w_kl, n_given))
    assert_same(actual, expected)
    assert np.array_equal(actual.numpy()[:, :n_given], W[:, :n_given])


@pytest.mark.parametrize("kl", [False, True])
@pytest.mark.parametrize("lhalf", [None, "regular", "small_quad"])
def test_update_H(problem, kl, lhalf):
    X, W, H, weights = problem
    w_kl, w_lhalf = weight_args(weights, kl, lhalf)
    assert_same(torch_ops.update_H(*to_torch(X, W, H, w_kl, w_lhalf)),
                jax_ops.update_H(X, W, H, w_kl, w_lhalf))


@pytest.mark.parametrize("kl", [False, True])
@pytest.mark.parametrize("lhalf", [None, "regular", "small_quad"])
@pytest.mark.parametrize("n_given", [0, 1, K])
def test_update_WH(problem, kl, lhalf, n_given):
    X, W, H, weights = problem
    w_kl, w_lhalf = weight_args(weights, kl, lhalf)
    W_t, H_t = torch_ops.update_WH(*to_torch(X, W, H, w_kl, w_lhalf),
                                   n_given)
    W_j, H_j = jax_ops.update_WH(X, W, H, w_kl, w_lhalf, n_given)
    assert_same((W_t, H_t), (W_j, H_j))
    # given columns: the same bits in both packages, and unchanged
    assert np.array_equal(W_t.numpy()[:, :n_given],
                          np.asarray(W_j)[:, :n_given])
    assert np.array_equal(W_t.numpy()[:, :n_given], W[:, :n_given])


def test_batched_ops_match_jax_vmap(problem):
    """The leading restart axis is the JAX package's vmap axis."""
    X, _, _, weights = problem
    rng = np.random.default_rng(8)
    W = np.ascontiguousarray(rng.dirichlet(np.ones(V), (R, K))
                             .transpose(0, 2, 1))
    H = rng.uniform(0.5, 30.0, (R, K, D))
    w_kl, w_lhalf = weights["weights_kl"], weights["weights_lhalf"]
    X_t, W_t, H_t, kl_t, lh_t = to_torch(X, W, H, w_kl, w_lhalf)

    update = jax.vmap(lambda w, h: jax_ops.update_WH(X, w, h, w_kl, w_lhalf))
    assert_same(torch_ops.update_WH(X_t, W_t, H_t, kl_t, lh_t), update(W, H))
    objective = jax.vmap(
        lambda w, h: jax_ops.klnmf_objective(X, w, h, w_kl, w_lhalf))
    assert_same(torch_ops.klnmf_objective(X_t, W_t, H_t, kl_t, lh_t),
                objective(W, H))
    samplewise = jax.vmap(
        lambda w, h: jax_ops.samplewise_kl_divergence(X, w, h))
    assert_same(torch_ops.samplewise_kl_divergence(X_t, W_t, H_t),
                samplewise(W, H))


@pytest.mark.parametrize("n_given", [0, 1])
def test_step_functions(problem, n_given):
    X, W, H, weights = problem
    data_j = {"X": X, "weights_kl": weights["weights_kl"]}
    data_t = dict(zip(data_j, to_torch(*data_j.values())))
    params_t = dict(zip("WH", to_torch(W, H)))
    update_t, objective_t = torch_ops.make_step_functions(n_given)
    update_j, objective_j = jax_ops.make_step_functions(n_given)
    new_t, new_j = update_t(params_t, data_t), update_j({"W": W, "H": H},
                                                       data_j)
    assert_same((new_t["W"], new_t["H"]), (new_j["W"], new_j["H"]))
    assert_same(objective_t(params_t, data_t),
                objective_j({"W": W, "H": H}, data_j))


def test_pad_rank_and_masked_step_functions(problem):
    X, W, H, _ = problem
    W_p, H_p, mask = torch_ops.pad_rank(*to_torch(W, H), 5)
    W_pj, H_pj, mask_j = jax_ops.pad_rank(W, H, 5)
    assert np.array_equal(W_p.numpy(), np.asarray(W_pj))
    assert np.array_equal(H_p.numpy(), np.asarray(H_pj))
    assert np.array_equal(mask.numpy(), np.asarray(mask_j))

    params_t = {"W": W_p, "H": H_p, "mask": mask}
    params_j = {"W": W_pj, "H": H_pj, "mask": mask_j}
    data_t, data_j = {"X": torch.from_numpy(X)}, {"X": X}
    update_t, objective_t = torch_ops.make_masked_step_functions()
    update_j, objective_j = jax_ops.make_masked_step_functions()
    for _ in range(3):
        params_t = update_t(params_t, data_t)
        params_j = update_j(params_j, data_j)
    assert_same((params_t["W"], params_t["H"]),
                (params_j["W"], params_j["H"]))
    assert np.all(params_t["H"].numpy()[K:] == 0.0)
    # padded rank k problem == the unpadded one
    unpadded = (torch.from_numpy(W), torch.from_numpy(H))
    for _ in range(3):
        unpadded = torch_ops.update_WH(data_t["X"], *unpadded)
    assert_same(params_t["W"][:, :K], unpadded[0].numpy())
    assert_same(objective_t(params_t, data_t),
                objective_j(params_j, data_j))


def test_float32_matmuls_are_ieee_and_tf32_is_refused():
    """TF32 is Hopper's analogue of the bf16 pass that corrupted fits in
    the JAX package (salamander_tpu/ops/precision.py): the port runs at
    PyTorch's IEEE float32 defaults and refuses to fit under TF32."""
    from salamander_tpu_torch.ops.precision import require_ieee_float32

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    require_ieee_float32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            require_ieee_float32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="IEEE"):
            require_ieee_float32()
    finally:
        torch.set_float32_matmul_precision("highest")
    require_ieee_float32()
