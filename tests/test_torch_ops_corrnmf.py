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


# ---------------------------------------------------------------------------
# the unrolled solve's kernel (ops/cuda_corrnmf.py): its route, and its
# per-row algorithm (csrc/corrnmf_newton.cu) held against the plain steps
# ---------------------------------------------------------------------------

from salamander_tpu_torch import profiling  # noqa: E402
from salamander_tpu_torch.ops import cuda_corrnmf  # noqa: E402


def solve_args(lanes=(), N=12, M=5, m=3, dtype=torch.float64, seed=0,
               per_other=False):
    """update_embeddings' arguments for random rows (the sample side: N
    rows against M signatures), aux given transposed as the models give
    it; the rows near the objective's minimum, so Newton steps matter."""
    rng = np.random.default_rng(seed)
    other = rng.normal(0.0, 0.6, lanes + (M, m))
    truth = rng.normal(0.0, 0.6, lanes + (N, m))
    row_scal = rng.normal(5.0, 0.5, lanes + ((N, M) if per_other else (N,)))
    other_scal = rng.normal(-1.0, 0.5, lanes + (M,))
    offset = (row_scal if per_other else row_scal[..., None]) \
        + other_scal[..., None, :]
    aux = np.exp(offset + truth @ np.swapaxes(other, -1, -2)) \
        * rng.gamma(20.0, 1 / 20.0, lanes + (N, M))
    start = truth + rng.normal(0.0, 0.3, truth.shape)
    variance = rng.uniform(0.5, 2.0, lanes) if lanes else 1.3

    def as_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    return (as_t(start), as_t(other), as_t(row_scal), as_t(other_scal),
            as_t(variance) if lanes else variance,
            as_t(np.swapaxes(aux, -1, -2)).mT)


@pytest.mark.parametrize("change, reason", [
    ({}, "not on a CUDA device"),
    ({"reduce_samples": lambda *parts: parts}, "reduce_samples"),
    ({"max_iter": T._UNROLL_NEWTON_LIMIT + 1}, "early-exit"),
    ({"m": cuda_corrnmf.DIM_MAX + 1}, "outside the compiled"),
    ({"M": cuda_corrnmf.OTHERS_MAX + 1}, "others a row, above"),
    ({"dtype": torch.float16}, "float32 or float64"),
    ({"dtype": torch.bfloat16}, "float32 or float64"),
])
def test_kernel_route_refusals(change, reason):
    """Each refusal of the kernel's route names its reason; CPU tensors,
    which every other case here also is, are the last check, so each
    other reason shows on the CPU."""
    args = solve_args(m=change.get("m", 3), M=change.get("M", 5),
                      dtype=change.get("dtype", torch.float64))
    max_iter = change.get("max_iter", 3)
    found = cuda_corrnmf.unsupported_reason(
        *args, max_iter, change.get("reduce_samples"))
    assert reason in found


def test_kernel_route_refuses_mixed_dtypes():
    start, *rest = solve_args()
    assert "one dtype" in cuda_corrnmf.unsupported_reason(
        start.float(), *rest, 3)


@pytest.mark.parametrize("lanes", [(), (2,)])
def test_cpu_unrolled_solve_runs_the_plain_steps(lanes):
    """On the CPU update_embeddings runs the plain steps: no launch, one
    unrolled solve counted and none in the kernel, and newton_solve's CPU
    route equals the plain loop bit for bit."""
    args = solve_args(lanes)
    launches = cuda_corrnmf.newton_solve.launches
    before = dict(profiling.counters)
    got = T.update_embeddings(*args, max_iter=3)

    def added(name):
        return profiling.counters.get(name, 0) - before.get(name, 0)

    assert cuda_corrnmf.newton_solve.launches == launches
    assert added("corrnmf.newton_solves.sample") == 1
    assert added("corrnmf.newton_solves_in_kernel") == 0
    assert added("corrnmf.newton_steps.sample") == 3
    plain, _ = T._newton_solve(*args, 3, None, None, False)
    assert torch.equal(got, plain)
    assert torch.equal(cuda_corrnmf.newton_solve(*args, 3), plain)
    assert cuda_corrnmf.newton_solve.launches == launches


WIDE = cuda_corrnmf.OTHERS_MAX + 1


@pytest.mark.parametrize("change, route", [
    ({}, "thread"),                                  # the sample side
    ({"M": cuda_corrnmf.OTHERS_MAX}, "thread"),
    ({"M": WIDE}, "wide"),                           # unrolled, wide rows
    ({"M": WIDE, "max_iter": 100}, "wide"),          # the signature side
    ({"M": 2000, "max_iter": 100, "dtype": torch.float32}, "wide"),
    ({"M": WIDE, "m": 1, "max_iter": 100}, "wide"),
    ({"max_iter": 100}, "plain"),                    # narrow early exit
    ({"M": cuda_corrnmf.OTHERS_MAX, "max_iter": 100}, "plain"),
    ({"m": cuda_corrnmf.DIM_MAX + 1}, "plain"),
    ({"M": WIDE, "m": cuda_corrnmf.DIM_MAX + 1, "max_iter": 100}, "plain"),
    ({"M": WIDE, "max_iter": 100, "dtype": torch.float16}, "plain"),
    ({"dtype": torch.bfloat16}, "plain"),
    ({"reduce_samples": lambda *parts: parts}, "plain"),
    ({"M": WIDE, "max_iter": 100, "reduce_samples": lambda *parts: parts},
     "plain"),
])
def test_route_by_what_the_call_shows(change, route, monkeypatch):
    """cuda_corrnmf.route picks each solve's route from its rows' width,
    its step cap, dtype, m and reduce_samples, as if the tensors lay on a
    card (its device check stubbed); on the CPU every solve is plain."""
    args = solve_args(M=change.get("M", 5), m=change.get("m", 3),
                      dtype=change.get("dtype", torch.float64))
    call = (*args, change.get("max_iter", 3), change.get("reduce_samples"))
    assert cuda_corrnmf.route(*call) == "plain"
    monkeypatch.setattr(cuda_corrnmf, "_device_refusal", lambda t: None)
    assert cuda_corrnmf.route(*call) == route


@pytest.mark.parametrize("change, reason", [
    ({}, "not on a CUDA device"),
    ({"max_iter": 100}, "not on a CUDA device"),
    ({"M": cuda_corrnmf.OTHERS_MAX}, "narrow rows"),
    ({"reduce_samples": lambda *parts: parts}, "reduce_samples"),
    ({"m": cuda_corrnmf.DIM_MAX + 1}, "outside the compiled"),
    ({"dtype": torch.float16}, "float32 or float64"),
])
def test_wide_kernel_route_refusals(change, reason):
    """Each refusal of the wide kernel names its reason (CPU tensors, the
    last check, show it on the CPU): it takes any step cap, but only rows
    with more than OTHERS_MAX others."""
    args = solve_args(m=change.get("m", 3), M=change.get("M", WIDE),
                      dtype=change.get("dtype", torch.float64))
    found = cuda_corrnmf.wide_unsupported_reason(
        *args, change.get("max_iter", 3), change.get("reduce_samples"))
    assert reason in found


@pytest.mark.parametrize("rows, M, dim, itemsize, plan", [
    (48, 20_000, 6, 4, (2, False)),    # the cell's SBS signature side
    (40, 20_000, 6, 4, (2, False)),    # its ID side
    (48, 20_000, 6, 8, (2, False)),
    (5, 4096, 2, 4, (4, True)),        # a minibatch signature side
    (5, 20_000, 2, 4, (8, True)),
    (5, 512, 2, 8, (1, True)),         # too few others to split
    (300, 20_000, 6, 4, (1, False)),   # rows enough for every SM
    (1, 200_000, 10, 8, (8, False)),
])
def test_wide_plan(rows, M, dim, itemsize, plan):
    """The wide launch's cluster fills the SMs (132 on an H100) with rows x
    cluster, at least 4 others a thread a CTA, and its slices are cached
    in shared memory where they fit."""
    assert tuple(cuda_corrnmf.wide_plan(rows, M, dim, itemsize, 132)) == plan


@pytest.mark.parametrize("N", [5, 6])
def test_cpu_wide_solve_counts_its_steps(N):
    """A wide signature-side solve (M = 2,000 samples a row, 2 lanes, m =
    6, a per-lane stop threshold) on the CPU runs the plain early-exit
    loop: counted as a wide solve and none in the kernel, no launch, one
    done read a step, and corrnmf.newton_steps.signature adds the most
    steps any row of any lane ran, as the wide kernel's route reads them;
    the rows stop at different steps, and wide_newton_solve's CPU route
    equals the plain loop bit for bit."""
    args = solve_args((2,), N=N, M=2000, m=6, seed=N)
    xtol = torch.tensor([6e-5, 6e-4], dtype=torch.float64)
    launches = cuda_corrnmf.wide_newton_solve.launches
    before = dict(profiling.counters)
    got = T.update_embeddings(*args, max_iter=100, xtol_total=xtol)

    added = {name: profiling.counters.get(name, 0) - before.get(name, 0)
             for name in ("corrnmf.newton_solves_wide",
                          "corrnmf.newton_solves_wide_in_kernel",
                          "corrnmf.newton_solves_in_kernel",
                          "corrnmf.newton_solves.signature",
                          "corrnmf.newton_steps.signature",
                          "ops.host_syncs")}
    rows, row_steps = cuda_corrnmf.wide_newton_solve(*args, 100, xtol)
    assert cuda_corrnmf.wide_newton_solve.launches == launches
    assert torch.equal(got, rows)
    assert row_steps.shape == (2, N)
    assert int(row_steps.min()) < int(row_steps.max())
    assert added == {"corrnmf.newton_solves_wide": 1,
                     "corrnmf.newton_solves_wide_in_kernel": 0,
                     "corrnmf.newton_solves_in_kernel": 0,
                     "corrnmf.newton_solves.signature": 0,  # not unrolled
                     "corrnmf.newton_steps.signature": int(row_steps.max()),
                     "ops.host_syncs": int(row_steps.max())}
    plain, steps = T._newton_solve(*args, 100, xtol, None, True)
    assert torch.equal(got, plain) and steps == int(row_steps.max())


def test_wide_solve_matches_the_jax_package():
    """The plain wide solve (5 rows against 2,000 others, m = 6, early
    exit) equals the JAX package's update_embeddings at float64: rtol
    1e-10 with the stop threshold above the rounding band, as
    test_update_embeddings_to_convergence sets it, and 1e-6 at the
    default threshold."""
    args = solve_args(N=5, M=2000, m=6, seed=11)
    arrays = [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]
    for xtol in (6 * 1e-3, None):
        got = T.update_embeddings(*args, max_iter=100, xtol_total=xtol)
        want = J.update_embeddings(*arrays, max_iter=100, xtol_total=xtol)
        close(got, want, rtol=RTOL if xtol else 1e-6)


def first_passing(passes):
    """The sequential search: the first t = 2^0, 2^-1, ... whose test
    passes, 2^-40 accepted regardless (the kernel's loop)."""
    t = 1.0
    for _ in range(T._N_BACKTRACK - 1):
        if passes(t):
            return t
        t *= 0.5
    return t


def row_sum(values, dt):
    """A sum over the others in their order, in the working dtype."""
    total = dt(0.0)
    for value in values:
        total = dt(total + value)
    return total


def sequential_t(b, d, rates, along, linear_term, variance, slope, offsets,
                 others, dt):
    """One row's Armijo pick by the sequential search, each candidate's
    test as the kernel writes it (float32: the change read term by term;
    float64: two whole objectives)."""
    var = dt(variance)
    if dt is np.float32:
        linear = row_sum((b / var - linear_term) * d, dt)
        quadratic = dt(row_sum(d * d, dt) / (dt(2.0) * var))
        base = dt(linear - dt(1e-4) * slope)
        return first_passing(lambda t: dt(
            row_sum(rates * np.expm1(dt(t) * along), dt)
            + dt(t) * (base + dt(t) * quadratic)) <= 0)

    def objective(x):
        return (-row_sum(linear_term * x, dt)
                + row_sum(np.exp(others @ x + offsets), dt)
                + row_sum(x * x, dt) / (dt(2.0) * var))

    f0 = objective(b)
    return first_passing(
        lambda t: objective(b + dt(t) * d) <= f0 + dt(1e-4) * dt(t) * slope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sequential_search_picks_the_vectorised_step(dtype):
    """The kernel's sequential first-pass search picks, row by row, the
    step that _newton_step's vectorised test and argmax (_first_passing)
    pick: on random rows near their optimum, on rows whose direction is
    turned uphill (only the floor 2^-40 passes), and on rows whose
    Hessian fails to factor and takes the diagonal floor (others all
    along one axis and a variance so large that the Hessian is rank 1 to
    rounding)."""
    dt = np.float32 if dtype == torch.float32 else np.float64
    N, M, m = 48, 7, 4
    b, others, scal, other_scal, variance, aux = solve_args(
        N=N, M=M, m=m, dtype=dtype, seed=3)
    # each row a lane of one row, so that each may have its own variance
    b, scal, aux = b[:, None], scal[:, None], aux[:, None]
    far = slice(12, 24)    # rows far from their optimum backtrack
    b[far] += torch.linspace(-2.0, 2.0, m, dtype=dtype)
    variance = torch.full((N, 1), variance, dtype=dtype)
    axis = torch.linspace(0.5, 1.5, m, dtype=dtype)
    others = others.expand(N, M, m).clone()
    flat = slice(32, 48)   # floor rows: rank-1 Hessians
    others[flat] = others[flat, :, :1] * axis
    variance[flat] = 1e30 if dtype == torch.float32 else 1e300
    var_rows = variance.unsqueeze(-1)
    offsets = scal.unsqueeze(-1) + other_scal.unsqueeze(-2)
    linear_term = aux @ others
    rates = torch.exp(offsets + b @ others.mT)             # (N, 1, M)
    grad = -linear_term + rates @ others + b / var_rows
    hess = ((rates.mT * others).mT @ others).unsqueeze(-3) \
        + torch.eye(m, dtype=dtype) / var_rows.unsqueeze(-1)
    assert torch.linalg.cholesky_ex(hess).info[flat].ne(0).any()
    direction = -T._solve_spd(hess, grad)
    uphill = slice(24, 32)
    direction[uphill] = -direction[uphill]
    slope = (grad * direction).sum(-1)
    ts = 0.5 ** torch.arange(T._N_BACKTRACK, dtype=dtype)
    if dtype == torch.float32:
        ok = T._armijo_by_change(b, direction, rates, others, linear_term,
                                 var_rows, ts, slope, None)
    else:
        ok = T._armijo_by_objective(b, direction, rates.sum(-1), others,
                                    offsets, linear_term, variance, ts,
                                    slope, None)
    vectorised = T._first_passing(ok, ts)[:, 0].numpy()
    along = direction @ others.mT
    sequential = np.array([sequential_t(
        b[n, 0].numpy(), direction[n, 0].numpy(), rates[n, 0].numpy(),
        along[n, 0].numpy(), linear_term[n, 0].numpy(),
        variance[n, 0].item(), dt(slope[n, 0].item()),
        offsets[n, 0].numpy(), others[n].numpy(), dt) for n in range(N)])
    np.testing.assert_array_equal(sequential, vectorised)
    assert (vectorised[uphill] == 0.5 ** 40).all()
    assert (vectorised[:24] > 0.5 ** 40).all()
    assert ((vectorised[far] < 1.0) & (vectorised[far] > 0.5 ** 40)).any()


def emulated_kernel(operands, max_iter):
    """csrc/corrnmf_newton.cu's loop, row by row in numpy scalars of the
    working dtype, on the operands the wrapper hands the launch
    (cuda_corrnmf.kernel_operands): the linear term once; per step the
    rates, gradient and Hessian, the Cholesky factor with
    ops/mvnmf.py::_cholesky's floor, two triangular solves, the
    sequential Armijo search, the update and the done test; then the
    clamp."""
    o = operands
    dt = np.float32 if o.b0.dtype == torch.float32 else np.float64
    L, N, m = o.b0.shape
    M = o.others.shape[1]
    eps = dt(EPSILON)
    scal, aux = o.scalings.numpy(), o.aux.numpy()
    out = np.empty_like(o.b0.numpy())

    def factor(h):
        a, ok = h.copy(), True
        for j in range(m):
            pivot = a[j, j] - row_sum(a[j, :j] * a[j, :j], dt)
            ok = ok and pivot > 0
            a[j, j] = np.sqrt(pivot)
            for i in range(j + 1, m):
                a[i, j] = (a[i, j] - row_sum(a[i, :j] * a[j, :j], dt)) \
                    / a[j, j]
        return a, ok

    for lane in range(L):
        var, xtol = dt(o.variance[lane].item()), dt(o.xtol[lane].item())
        others = o.others[lane].numpy()
        for n in range(N):
            offsets = (scal[lane, n] + o.scal_other[lane].numpy()).astype(dt)
            lin = np.zeros(m, dt)
            for i in range(M):
                lin = lin + aux[lane, n, i] * others[i]
            b = o.b0[lane, n].numpy().copy()
            for _ in range(max_iter):
                rates = np.array([np.exp(offsets[i] + others[i] @ b)
                                  for i in range(M)], dt)
                grad = np.zeros(m, dt)
                hess = np.zeros((m, m), dt)
                for i in range(M):
                    grad = grad + rates[i] * others[i]
                    hess = hess + np.outer(rates[i] * others[i], others[i])
                grad = (-lin + grad) + b / var
                hess = hess + np.eye(m, dtype=dt) / var
                chol, ok = factor(hess)
                if not ok:
                    chol, _ = factor(hess + np.diag(eps * np.diag(hess)))
                d = np.zeros(m, dt)
                for j in range(m):
                    d[j] = (grad[j] - row_sum(chol[j, :j] * d[:j], dt)) \
                        / chol[j, j]
                for j in reversed(range(m)):
                    d[j] = (d[j] - row_sum(chol[j + 1:, j] * d[j + 1:], dt)) \
                        / chol[j, j]
                d = -d
                t = dt(sequential_t(b, d, rates, others @ d, lin, var,
                                    row_sum(grad * d, dt), offsets, others,
                                    dt))
                update = t * d
                b = b + update
                if row_sum(np.abs(update), dt) < xtol:
                    break
            b[(b > 0) & (b < eps)] = eps
            b[(b < 0) & (b > -eps)] = -eps
            out[lane, n] = b
    return torch.as_tensor(out).reshape(o.lanes + (N, m))


@pytest.mark.parametrize("case", [
    "one fit", "lanes", "per-other scalings", "m-padded lanes", "float32"])
def test_kernel_algorithm_matches_the_plain_steps(case):
    """The kernel's per-row algorithm (emulated_kernel), on the operands
    the wrapper would launch with, against the plain unrolled solve: a
    fit without lane axes (0-d variance, one scaling a row, aux a
    transposed view), lanes with their own variances, the multimodal
    (N, M) scalings, an m-padded scan lane pair with a per-lane stop
    threshold whose padded dimensions stay exactly 0, and float32. rtol
    1e-9 in float64 (sums over M and m in another order); in float32 rtol
    2e-5 with an absolute floor of 2e-6 of the largest entry (the same
    rounding, ~1e-7, carried through three solves, and entries near 0)."""
    dtype = torch.float32 if case == "float32" else torch.float64
    lanes = () if case == "one fit" else (2,)
    args = list(solve_args(lanes, dtype=dtype, seed=7,
                           per_other=case == "per-other scalings"))
    xtol = None
    if case == "m-padded lanes":
        args[0][..., -1] = 0.0
        args[1][..., -1] = 0.0
        xtol = torch.tensor([2.0, 2.0], dtype=dtype) * T.XTOL
    operands = cuda_corrnmf.kernel_operands(*args, xtol)
    assert operands.aux.data_ptr() == args[5].data_ptr()  # no copy
    got = emulated_kernel(operands, 3)
    want = cuda_corrnmf.newton_solve_reference(*args, 3, xtol)
    assert got.shape == want.shape
    if dtype == torch.float32:
        close(got, want, rtol=2e-5, atol=2e-6 * float(want.abs().max()))
    else:
        close(got, want, rtol=1e-9)
    if case == "m-padded lanes":
        assert got[..., -1].eq(0).all() and want[..., -1].eq(0).all()


def test_m1_launches_exactly_at_two_columns():
    """The kernel is compiled for m >= 2; m = 1 launches with a zero
    column (cuda_corrnmf.padded_dim). The padded rows' first column is the
    unpadded rows' bit for bit, and the zero column stays 0."""
    args = solve_args((2,), m=1, seed=9)
    operands = cuda_corrnmf.kernel_operands(*args)
    one = emulated_kernel(operands, 3)
    two = emulated_kernel(cuda_corrnmf.padded_dim(operands, 2), 3)
    assert torch.equal(two[..., :1], one)
    assert two[..., 1].eq(0).all()
