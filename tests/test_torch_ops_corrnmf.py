"""salamander_tpu_torch.ops.corrnmf against salamander_tpu.ops.corrnmf at
float64 on the CPU, same numpy inputs (a 96 x 32 PCAWG sub-catalog): the
closed forms and the surrogate at rtol 1e-10, the batched Newton at
max_iter 3 and 100 for m = 1..4 (m = 4 is where the JAX package unrolls a
Cholesky), the pivot floor, the scipy Newton-CG host path at rtol 1e-12,
and the rank/dim-masked step against the JAX masked step and against the
port's own unpadded cycle."""

import jax
import numpy as np
import pytest
import torch

from salamander_tpu import datasets as jax_datasets
from salamander_tpu.ops import corrnmf as J
from salamander_tpu_torch.ops import corrnmf as T
from salamander_tpu_torch.ops.klnmf import EPSILON

torch.set_num_threads(1)

RTOL = 1e-10
N_SAMPLES = 32
SHAPES = [(3, 1), (3, 2), (4, 3), (4, 4)]


def t(array):
    return torch.as_tensor(np.array(array, dtype=float))


@pytest.fixture(scope="module")
def X():
    frame = jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    return np.ascontiguousarray(frame.to_numpy()).clip(EPSILON)


def draw_state(X, K, m, seed=0):
    rng = np.random.default_rng(seed + 10 * K + m)
    D, V = X.shape
    state = {
        "signatures": rng.dirichlet(np.ones(V), K),
        "signature_scalings": rng.normal(0.0, 0.5, K),
        "sample_scalings": np.log(X.sum(1)) - 2.0 + rng.normal(0, 0.1, D),
        "signature_embeddings": rng.normal(size=(K, m)),
        "sample_embeddings": rng.normal(size=(D, m)),
        "variance": 1.3,
    }
    state["exposures"] = np.asarray(J.compute_exposures(
        state["signature_scalings"], state["sample_scalings"],
        state["signature_embeddings"], state["sample_embeddings"]))
    state["aux"] = np.asarray(J.compute_aux(X, state["signatures"],
                                            state["exposures"]))
    return state


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"K{k}_m{m}" for k, m in SHAPES])
def state(request, X):
    return draw_state(X, *request.param)


def close(actual, expected, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol)


def test_closed_forms(X, state):
    s = state
    close(T.compute_exposures(t(s["signature_scalings"]),
                              t(s["sample_scalings"]),
                              t(s["signature_embeddings"]),
                              t(s["sample_embeddings"])), s["exposures"])
    close(T.compute_aux(t(X), t(s["signatures"]), t(s["exposures"])),
          s["aux"])
    for penalize in (True, False):
        close(T.elbo_corrnmf(t(X), t(s["signatures"]), t(s["exposures"]),
                             t(s["signature_embeddings"]),
                             t(s["sample_embeddings"]), s["variance"],
                             penalize_sample_embeddings=penalize),
              J.elbo_corrnmf(X, s["signatures"], s["exposures"],
                             s["signature_embeddings"],
                             s["sample_embeddings"], s["variance"],
                             penalize_sample_embeddings=penalize))
    close(T.update_signature_scalings(t(s["aux"]), t(s["sample_scalings"]),
                                      t(s["signature_embeddings"]),
                                      t(s["sample_embeddings"])),
          J.update_signature_scalings(s["aux"], s["sample_scalings"],
                                      s["signature_embeddings"],
                                      s["sample_embeddings"]))
    close(T.update_sample_scalings(t(X), t(s["signature_scalings"]),
                                   t(s["signature_embeddings"]),
                                   t(s["sample_embeddings"])),
          J.update_sample_scalings(X, s["signature_scalings"],
                                   s["signature_embeddings"],
                                   s["sample_embeddings"]))
    close(T.update_variance(t(s["signature_embeddings"]),
                            t(s["sample_embeddings"])),
          J.update_variance(s["signature_embeddings"],
                            s["sample_embeddings"]))


def test_surrogate_of_one_row(state):
    s = state
    other, row = s["sample_embeddings"], s["signature_embeddings"][0]
    scaling, scalings_other = s["signature_scalings"][0], s["sample_scalings"]
    aux_vector = s["aux"][0]
    args_j = (row, other, scaling, scalings_other, s["variance"])
    args_t = (t(row), t(other), t(scaling), t(scalings_other), s["variance"])
    for name in ("embedding_objective", "embedding_gradient",
                 "objective_function_embedding"):
        close(getattr(T, name)(*args_t, t(aux_vector)),
              getattr(J, name)(*args_j, aux_vector))
    close(T.embedding_hessian(*args_t), J.embedding_hessian(*args_j))
    summand = aux_vector @ other
    outer = np.einsum("Km,Kn->Kmn", other, other)
    close(T.gradient_embedding(*args_t, t(summand)),
          J.gradient_embedding(*args_j, summand))
    close(T.hessian_embedding(*args_t, t(outer)),
          J.hessian_embedding(*args_j, outer))


def both_sides(state, max_iter, xtol_total=None):
    """Signature-side and sample-side updates, JAX and port."""
    s = state
    sides = [
        ("signature_embeddings", "sample_embeddings", "signature_scalings",
         "sample_scalings", s["aux"]),
        ("sample_embeddings", "signature_embeddings", "sample_scalings",
         "signature_scalings", s["aux"].T),
    ]
    for own, other, scal, scal_other, aux in sides:
        expected = J.update_embeddings(
            s[own], s[other], s[scal], s[scal_other], s["variance"], aux,
            max_iter=max_iter, xtol_total=xtol_total)
        actual = T.update_embeddings(
            t(s[own]), t(s[other]), t(s[scal]), t(s[scal_other]),
            s["variance"], t(aux), max_iter=max_iter, xtol_total=xtol_total)
        yield np.asarray(actual), np.asarray(expected)


def test_update_embeddings_three_steps(state):
    """The sample side's fixed three steps (no early exit)."""
    for actual, expected in both_sides(state, 3):
        close(actual, expected)


def test_update_embeddings_to_convergence(state):
    """max_iter 100 with the early exit. The accepted Armijo step of a row
    whose Newton decrement has fallen to the objective's rounding level
    (~1e-13 relative) is decided by the last bit of a float sum, which
    runs in another order in each package; with a stop threshold above
    that band (m * 1e-3) every decision is clear and the rows agree at
    rtol 1e-10. At the default threshold (m * 1e-5) a row may take a
    half step where the other package takes a full one, a difference
    below the threshold itself."""
    dim = state["signature_embeddings"].shape[1]
    for actual, expected in both_sides(state, 100, xtol_total=dim * 1e-3):
        close(actual, expected)
    for actual, expected in both_sides(state, 100):
        close(actual, expected, rtol=1e-6)


def test_vector_scalings(state):
    """The multimodal joint sample update's (N, M) scaling form."""
    s = state
    rng = np.random.default_rng(5)
    scalings = s["sample_scalings"][:, None] + rng.normal(
        0, 0.1, s["aux"].T.shape)
    args = (s["sample_embeddings"], s["signature_embeddings"], scalings,
            s["signature_scalings"], s["variance"], s["aux"].T)
    close(T.update_embeddings(*[t(a) for a in args], max_iter=3),
          J.update_embeddings(*args, max_iter=3))


def test_lane_batching(X):
    """Two restart lanes (each with its own variance) in one call equal the
    lanes one by one (stop threshold above the rounding band, see
    test_update_embeddings_to_convergence)."""
    lanes = [draw_state(X, 3, 2, seed) for seed in (1, 2)]
    variance = torch.tensor([0.7, 1.9], dtype=torch.float64)
    keys = ("signature_embeddings", "sample_embeddings", "signature_scalings",
            "sample_scalings", "aux")
    stacked = {key: torch.stack([t(lane[key]) for lane in lanes])
               for key in keys}
    batched = T.update_embeddings(
        stacked["signature_embeddings"], stacked["sample_embeddings"],
        stacked["signature_scalings"], stacked["sample_scalings"], variance,
        stacked["aux"], max_iter=100, xtol_total=2e-3)
    for i, lane in enumerate(lanes):
        single = T.update_embeddings(
            t(lane["signature_embeddings"]), t(lane["sample_embeddings"]),
            t(lane["signature_scalings"]), t(lane["sample_scalings"]),
            float(variance[i]), t(lane["aux"]), max_iter=100,
            xtol_total=2e-3)
        close(batched[i], single, rtol=1e-12)


def test_solve_and_pivot_floor():
    """SPD systems solve as the JAX package's unrolled Cholesky does (m=4
    included); a barely indefinite Hessian - one float rounding can leave
    behind - is factored again with EPSILON * diag added, stays finite,
    and leaves its neighbours in the batch untouched."""
    rng = np.random.default_rng(0)
    dim = 4
    mats, vecs = [], []
    for i in range(3):
        A = rng.normal(size=(dim, dim))
        mats.append(A @ A.T + (1.0 + i) * np.eye(dim))
        vecs.append(rng.normal(size=dim))
    # rank-2 rates term + I/var, its smallest eigenvalue pushed just below
    # zero (the diagonal stays positive, as in any Newton Hessian)
    o = rng.normal(size=(2, dim))
    bad = 3e4 * np.outer(o[0], o[0]) + 2e4 * np.outer(o[1], o[1]) \
        + np.eye(dim)
    w, V = np.linalg.eigh(bad)
    bad -= (w[0] * (1.0 + 1e-9)) * np.outer(V[:, 0], V[:, 0])
    assert np.linalg.eigvalsh(bad).min() < 0 < np.diag(bad).min()
    mats.insert(1, bad)
    vecs.insert(1, rng.normal(size=dim))
    hess, grad = np.stack(mats), np.stack(vecs)

    _, info = torch.linalg.cholesky_ex(t(hess))
    assert info[1] != 0 and info[[0, 2, 3]].eq(0).all()
    solved = T._solve_spd(t(hess), t(grad)).numpy()
    assert np.isfinite(solved).all()
    # the floored row solves the shifted system (backward-stable residual)
    shifted = bad + np.diag(EPSILON * np.diag(bad))
    residual = shifted @ solved[1] - vecs[1]
    assert np.linalg.norm(residual) <= 1e-9 * np.linalg.norm(shifted) \
        * np.linalg.norm(solved[1])
    for i in (0, 2, 3):
        close(solved[i], J._cholesky_solve_unrolled(hess[i], grad[i]))
        close(solved[i], J._solve_spd_small(hess[i], grad[i]))


@pytest.mark.parametrize("side", ["signatures", "samples"])
def test_newton_cg_host_path(X, side):
    s = draw_state(X, 3, 2)
    if side == "signatures":
        args = (s["signature_embeddings"], s["sample_embeddings"],
                s["signature_scalings"], s["sample_scalings"],
                s["variance"], s["aux"])
        max_iter = None
    else:
        args = (s["sample_embeddings"], s["signature_embeddings"],
                s["sample_scalings"], s["signature_scalings"],
                s["variance"], s["aux"].T)
        max_iter = 3
    close(T.update_embeddings_newton_cg(*args, max_iter=max_iter),
          J.update_embeddings_newton_cg(*args, max_iter=max_iter),
          rtol=1e-12)


def test_clamp_away_from_zero():
    values = np.array([0.0, 1e-9, -1e-9, 0.5, -EPSILON / 2, 2 * EPSILON])
    close(T._clamp_away_from_zero(t(values)),
          J._clamp_away_from_zero(values), rtol=0)


PARAM_KEYS = ("signatures", "signature_scalings", "sample_scalings",
              "signature_embeddings", "sample_embeddings", "variance",
              "exposures")


def params_of(X, K, m, seed):
    """A CorrNMFDet._device_state-style parameter dict (numpy)."""
    s = draw_state(X, K, m, seed)
    s["variance"] = np.asarray(s["variance"])
    return {key: s[key] for key in PARAM_KEYS}


@pytest.mark.parametrize("K,m,Kp,mp", [(2, 2, 4, 2), (3, 1, 4, 2),
                                       (3, 2, 3, 3)],
                         ids=["K-pad", "K-and-m-pad", "m-pad"])
def test_masked_step(X, K, m, Kp, mp):
    """pad_rank_corrnmf + the masked step, cycle by cycle from one shared
    state: equal to the JAX masked step on the same padded numpy params
    and to the port's own unpadded CorrNMFDet cycle on the stripped
    params (ELBO at rtol 1e-9); padded rows and dims stay inert.
    Parameters are held at rtol 1e-6 / atol 1e-7: the last Newton step of
    a row can fall in the rounding band of
    test_update_embeddings_to_convergence (a difference below the 2e-5
    stop threshold)."""
    from salamander_tpu_torch.models import CorrNMFDet

    params = params_of(X, K, m, seed=3)
    padded = T.pad_rank_corrnmf({k: t(v) for k, v in params.items()},
                                Kp, mp)
    padded_j = J.pad_rank_corrnmf(params, Kp, mp)
    for key in padded:
        np.testing.assert_array_equal(padded[key].numpy(),
                                      np.asarray(padded_j[key]), key)
    update_t, objective_t = T.make_masked_corrnmf_step()
    update_j, objective_j = J.make_masked_corrnmf_step()
    update_j = jax.jit(update_j)
    plain_update, plain_objective = CorrNMFDet(
        n_signatures=K, dim_embeddings=m, device="cpu")._build_step()
    data_t, data_j = {"X": t(X)}, {"X": X}

    def strip(state):
        return {
            "signatures": state["signatures"][:K],
            "signature_scalings": state["signature_scalings"][:K],
            "sample_scalings": state["sample_scalings"],
            "signature_embeddings": state["signature_embeddings"][:K, :m],
            "sample_embeddings": state["sample_embeddings"][:, :m],
            "variance": state["variance"],
            "exposures": state["exposures"][:, :K],
        }

    for cycle in range(3):
        out = update_t(padded, data_t)
        out_j = update_j({k: v.numpy() for k, v in padded.items()}, data_j)
        plain = plain_update(strip(padded), data_t)
        elbo = objective_t(out, data_t)
        close(elbo, objective_j(out_j, data_j), rtol=1e-9)
        close(elbo, plain_objective(plain, data_t), rtol=1e-9)
        for key, value in strip(out).items():
            close(value, strip(out_j)[key], rtol=1e-6, atol=1e-7)
            close(value, plain[key], rtol=1e-6, atol=1e-7)
        assert torch.all(out["signature_embeddings"][K:] == 0)
        assert torch.all(out["sample_embeddings"][:, m:] == 0)
        assert torch.all(out["exposures"][:, K:] == 0)
        padded = out


def test_pad_rank_validates_and_batches(X):
    params = {k: t(v) for k, v in params_of(X, 3, 2, seed=1).items()}
    with pytest.raises(ValueError, match="n_padded"):
        T.pad_rank_corrnmf(params, 2)
    with pytest.raises(ValueError, match="dim_padded"):
        T.pad_rank_corrnmf(params, 4, 1)
    batched = {k: v.expand((3,) + v.shape) for k, v in params.items()}
    padded = T.pad_rank_corrnmf(batched, 4, 3)
    assert padded["mask"].shape == (3, 4) and padded["m_mask"].shape == (3, 3)
    single = T.pad_rank_corrnmf(params, 4, 3)
    for key in padded:
        assert torch.equal(padded[key][1], single[key]), key
