"""salamander_tpu_torch/ops/svi.py against salamander_tpu/ops/svi.py at
float64 on the CPU.

The two packages cannot share a sampler (jax.random against a CPU
torch.Generator), so the three minibatch cores are held against the JAX
cores on the SAME numpy-drawn index sequences: 32 steps over several epochs
at a batch size that divides no epoch, the running sum-of-squares refreshed
at the same reshuffle positions. With the embeddings held fixed every
parameter and statistic agrees at rtol 1e-9 (measured ~1e-13). With them
free the embeddings agree at rtol 1e-6 plus atol 1e-8 on entries of scale
0.5 (the packages factor the Newton systems
differently: batched Cholesky here, unrolled Cramer there) and whatever is
computed from them at 1e-8 (measured up to 1.3e-9 after 32 steps). KLNMF,
which has no Newton solve, agrees at 1e-9 throughout. Then the anchors of
tests/test_svi.py on the port alone: one step at batch_size = D, delay = 1
equals one EM cycle (or serial Lee-Seung cycle) of the port; the scaled
minibatch statistics are unbiased; the epoch sampler covers every sample
and drops the last partial batch; the validation errors; the remainder
steps; and the full and streamed objectives against the JAX ones at rtol
1e-10. The upload ring is driven on its CPU path for its logic.

Not mirrored from tests/test_svi.py: the retrace/cache test (nothing is
compiled here, so the make_* functions are not cached), the two tests of
run_svi_guarded (it splits one compiled program to stay under
an accelerator's program time limit; the port's loop is host-driven) and
the two plot_history tests (the plots are not ported yet).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu.ops import svi as jax_svi
from salamander_tpu_torch.engine import (
    params_from_numpy,
    params_to_numpy,
    svi_state_from_numpy,
)
from salamander_tpu_torch.ops import klnmf as port_klops
from salamander_tpu_torch.ops import svi

torch.set_num_threads(1)

RTOL = 1e-9
RTOL_EMBEDDINGS = 1e-6
RTOL_DOWNSTREAM = 1e-8  # computed from embeddings that agree at 1e-6
D, V, K, M = 50, 16, 3, 2
N_STEPS = 32
BATCH = 7  # 7 steps an epoch (49 of 50 samples): divides no epoch


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return params_from_numpy(tree, device="cpu", dtype=torch.float64)


def make_counts(seed, shape=(D, V), lam=30.0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.poisson(lam, shape).astype(float),
                   np.finfo(np.float32).eps, None)


def corr_params(seed, n_samples=D, n_features=V, k=K, m=M):
    rng = np.random.default_rng(seed)
    return {
        "signatures": rng.dirichlet(np.ones(n_features), size=k),
        "signature_scalings": rng.normal(0.0, 0.3, k),
        "sample_scalings": rng.normal(3.0, 0.3, n_samples),
        "signature_embeddings": rng.normal(0.0, 0.5, (k, m)),
        "sample_embeddings": rng.normal(0.0, 0.5, (n_samples, m)),
        "variance": np.asarray(1.0),
    }


def mm_params(seed, n_samples=D, shapes=(("sbs", V, 3), ("indel", 11, 2))):
    rng = np.random.default_rng(seed)
    mods = {}
    for name, n_features, k in shapes:
        mods[name] = {
            "signatures": rng.dirichlet(np.ones(n_features), size=k),
            "signature_scalings": rng.normal(0.0, 0.3, k),
            "sample_scalings": rng.normal(3.0, 0.3, n_samples),
            "signature_embeddings": rng.normal(0.0, 0.5, (k, M)),
        }
    return {
        "mods": mods,
        "sample_embeddings": rng.normal(0.0, 0.5, (n_samples, M)),
        "variance": np.asarray(1.0),
    }


def index_sequence(seed, n_samples, batch_size, n_steps):
    """[(indices, reshuffled)]: the epoch sampler's semantics (reshuffle
    when fewer than batch_size samples remain) drawn with numpy."""
    rng = np.random.default_rng(seed)
    perm, cursor, out = None, n_samples, []
    for _ in range(n_steps):
        reshuffled = cursor + batch_size > n_samples
        if reshuffled:
            perm, cursor = rng.permutation(n_samples), 0
        out.append((perm[cursor:cursor + batch_size].copy(), reshuffled))
        cursor += batch_size
    return out


def drive(package, core, state, take_batch, sequence, refresh, as_index):
    for indices, reshuffled in sequence:
        if reshuffled and refresh:
            state = package.refresh_sample_usq(state)
        state = core(state, take_batch(indices), as_index(indices))
    return state


def drive_both(jax_core, port_core, jax_state, port_state, jax_batch,
               port_batch, sequence, refresh=True):
    """The same index sequence through both packages' cores."""
    state_j = drive(jax_svi, jax.jit(jax_core), jax_state, jax_batch,
                    sequence, refresh, lambda i: jnp.asarray(i, jnp.int32))
    state_t = drive(svi, port_core, port_state, port_batch, sequence,
                    refresh, torch.as_tensor)
    return state_j, state_t


def assert_trees_close(actual, expected, rtol=RTOL, embeddings=None):
    """Leaf by leaf; leaves whose path holds 'embeddings' at the looser
    tolerance of the Newton solves."""
    flat_a = port.engine.tree.tree_flatten(actual)
    flat_e = port.engine.tree.tree_flatten(
        jax.tree.map(np.asarray, expected))
    assert sorted(flat_a) == sorted(flat_e)  # jax sorts dict keys
    for path, leaf in flat_a.items():
        loose = "embeddings" in path or path == "variance"
        np.testing.assert_allclose(
            leaf, flat_e[path],
            rtol=(embeddings or RTOL_EMBEDDINGS) if loose else rtol,
            atol=1e-8 if loose else 1e-12, err_msg=path)


CORR_FLAGS = {
    "free": {},
    "given-and-fixed-variance": dict(n_given_signatures=1, fix_variance=True),
    "fixed-scalings": dict(fix_signature_scalings=True,
                           fix_sample_scalings=True),
    "fixed-embeddings": dict(fix_signature_embeddings=True,
                             fix_sample_embeddings=True),
}


@pytest.mark.parametrize("flags", list(CORR_FLAGS.values()),
                         ids=list(CORR_FLAGS))
def test_corrnmf_core_matches_jax_on_shared_indices(flags):
    X = make_counts(0)
    params = corr_params(1)
    config = dict(batch_size=BATCH, forgetting=0.7, delay=2.0)
    sequence = index_sequence(2, D, BATCH, N_STEPS)
    assert sum(reshuffled for _, reshuffled in sequence) >= 4
    X_j, X_t = jnp.asarray(X), torch.as_tensor(X)
    state_j, state_t = drive_both(
        jax_svi.make_svi_batch_step(D, jax_svi.SVIConfig(**config), **flags),
        svi.make_svi_batch_step(D, svi.SVIConfig(**config), **flags),
        jax_svi.svi_init(to_jax(params), streaming=True),
        svi.svi_init(to_torch(params), streaming=True),
        lambda i: X_j[i], lambda i: X_t[torch.as_tensor(i)], sequence)
    assert state_t.step == int(state_j.step) == N_STEPS
    rtol = RTOL if flags.get("fix_sample_embeddings") else RTOL_DOWNSTREAM
    assert_trees_close(params_to_numpy(state_t.params), state_j.params, rtol)
    for name in ("stat_observed", "stat_predicted", "stat_counts"):
        np.testing.assert_allclose(getattr(state_t, name).numpy(),
                                   np.asarray(getattr(state_j, name)),
                                   rtol=rtol, err_msg=name)
    np.testing.assert_allclose(float(state_t.stat_usq),
                               float(state_j.stat_usq), rtol=RTOL_EMBEDDINGS)
    if flags.get("n_given_signatures"):
        np.testing.assert_array_equal(
            state_t.params["signatures"][0].numpy(), params["signatures"][0])


KL_CASES = {
    "plain": dict(weights=(), h_inner_iters=1, n_given_signatures=0),
    "weighted": dict(weights=("weights_kl",), h_inner_iters=1,
                     n_given_signatures=0),
    "weighted-lhalf-inner2-given": dict(
        weights=("weights_kl", "weights_lhalf"), h_inner_iters=2,
        n_given_signatures=1),
    "all-given": dict(weights=("weights_lhalf",), h_inner_iters=1,
                      n_given_signatures=K),
}


@pytest.mark.parametrize("case", list(KL_CASES.values()), ids=list(KL_CASES))
def test_klnmf_core_matches_jax_on_shared_indices(case):
    rng = np.random.default_rng(3)
    X = make_counts(4).T                       # (V, D)
    params = {"W": rng.dirichlet(np.ones(V), size=K).T,
              "H": rng.gamma(2.0, 20.0, (K, D))}
    weights = {"weights_kl": rng.uniform(0.5, 2.0, D),
               "weights_lhalf": rng.uniform(0.1, 1.0, D)}
    weights = {name: weights[name] for name in case["weights"]}
    config = dict(batch_size=BATCH, forgetting=0.51, delay=3.0)
    kwargs = dict(n_given_signatures=case["n_given_signatures"],
                  h_inner_iters=case["h_inner_iters"])
    sequence = index_sequence(5, D, BATCH, N_STEPS)

    def jax_batch(i):
        return {"X": jnp.asarray(X[:, i]),
                **{k: jnp.asarray(w[i]) for k, w in weights.items()}}

    def port_batch(i):
        return {"X": torch.as_tensor(np.ascontiguousarray(X[:, i])),
                **{k: torch.as_tensor(w[i]) for k, w in weights.items()}}

    state_j, state_t = drive_both(
        jax_svi.make_klnmf_svi_batch_step(
            D, jax_svi.SVIConfig(**config), **kwargs),
        svi.make_klnmf_svi_batch_step(D, svi.SVIConfig(**config), **kwargs),
        jax_svi.klnmf_svi_init(to_jax(params), streaming=True),
        svi.klnmf_svi_init(to_torch(params), streaming=True),
        jax_batch, port_batch, sequence, refresh=False)
    assert_trees_close(params_to_numpy(state_t.params), state_j.params)
    np.testing.assert_allclose(state_t.stat_counts.numpy(),
                               np.asarray(state_j.stat_counts), rtol=RTOL)
    n_given = case["n_given_signatures"]
    np.testing.assert_array_equal(state_t.params["W"][:, :n_given].numpy(),
                                  params["W"][:, :n_given])


MM_FLAGS = {
    "free": dict(),
    "frozen": dict(
        mod_flags={"sbs": {"n_given": 1, "fix_sig_scalings": True},
                   "indel": {"fix_smp_scalings": True,
                             "fix_sig_embeddings": True,
                             "fix_signatures": True}},
        fix_variance=True),
    "fixed-samples": dict(fix_sample_embeddings=True),
    "fixed-embeddings": dict(
        mod_flags={"sbs": {"fix_sig_embeddings": True},
                   "indel": {"fix_sig_embeddings": True}},
        fix_sample_embeddings=True),
}


@pytest.mark.parametrize("flags", list(MM_FLAGS.values()), ids=list(MM_FLAGS))
def test_mm_core_matches_jax_on_shared_indices(flags):
    X = {"sbs": make_counts(6), "indel": make_counts(7, (D, 11), 12.0)}
    params = mm_params(8)
    names, ks = ["sbs", "indel"], [3, 2]
    config = dict(batch_size=BATCH, forgetting=0.7, delay=2.0)
    sequence = index_sequence(9, D, BATCH, N_STEPS)
    X_j = {k: jnp.asarray(v) for k, v in X.items()}
    X_t = {k: torch.as_tensor(v) for k, v in X.items()}
    state_j, state_t = drive_both(
        jax_svi.make_mm_svi_batch_step(
            D, names, ks, jax_svi.SVIConfig(**config), **flags),
        svi.make_mm_svi_batch_step(
            D, names, ks, svi.SVIConfig(**config), **flags),
        jax_svi.mm_svi_init(to_jax(params), streaming=True),
        svi.mm_svi_init(to_torch(params), streaming=True),
        lambda i: {k: v[i] for k, v in X_j.items()},
        lambda i: {k: v[torch.as_tensor(i)] for k, v in X_t.items()},
        sequence)
    rtol = RTOL if "mod_flags" in flags and flags.get(
        "fix_sample_embeddings") else RTOL_DOWNSTREAM
    assert_trees_close(params_to_numpy(state_t.params), state_j.params, rtol)
    assert_trees_close(params_to_numpy(state_t.stats), state_j.stats, rtol)
    np.testing.assert_allclose(float(state_t.stat_usq),
                               float(state_j.stat_usq), rtol=RTOL_EMBEDDINGS)


def test_mid_run_state_carries_across():
    """A JAX state after 6 steps, carried into the port as numpy arrays,
    continues there as it does in the JAX package."""
    X = make_counts(0)
    config = dict(batch_size=BATCH, delay=2.0)
    sequence = index_sequence(11, D, BATCH, 12)
    core_j = jax.jit(jax_svi.make_svi_batch_step(
        D, jax_svi.SVIConfig(**config)))
    core_t = svi.make_svi_batch_step(D, svi.SVIConfig(**config))
    X_j, X_t = jnp.asarray(X), torch.as_tensor(X)
    state_j = drive(jax_svi, core_j,
                    jax_svi.svi_init(to_jax(corr_params(1)), streaming=True),
                    lambda i: X_j[i], sequence[:6], True,
                    lambda i: jnp.asarray(i, jnp.int32))
    state_t = svi_state_from_numpy(jax.tree.map(np.asarray, state_j),
                                   device="cpu", dtype=torch.float64)
    assert isinstance(state_t, svi.SVIState)
    assert state_t.step == 6 and state_t.cursor == D
    np.testing.assert_array_equal(state_t.stat_counts.numpy(),
                                  np.asarray(state_j.stat_counts))
    state_j = drive(jax_svi, core_j, state_j, lambda i: X_j[i], sequence[6:],
                    True, lambda i: jnp.asarray(i, jnp.int32))
    state_t = drive(svi, core_t, state_t,
                    lambda i: X_t[torch.as_tensor(i)], sequence[6:], True,
                    torch.as_tensor)
    assert state_t.step == 12
    assert_trees_close(params_to_numpy(state_t.params), state_j.params,
                       RTOL_DOWNSTREAM)


# --------------------------------------------------------------------- #
# the anchors of tests/test_svi.py, on the port
# --------------------------------------------------------------------- #


def make_synthetic(n_samples=60, n_features=24, n_signatures=3, seed=0):
    rng = np.random.default_rng(seed)
    signatures = rng.dirichlet(np.full(n_features, 0.5), size=n_signatures)
    exposures = rng.gamma(2.0, 50.0, size=(n_samples, n_signatures))
    X = rng.poisson(exposures @ signatures).astype(float)
    X[X == 0] = 1.0
    return X


def generator(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def corr_model():
    """A port CorrNMFDet initialized on synthetic counts (not fitted)."""
    model = port.CorrNMFDet(n_signatures=3, dim_embeddings=2, device="cpu")
    model._setup_adata(port.AnnData(make_synthetic()))
    np.random.seed(11)
    model._initialize(init_kwargs={"seed": 11})
    model._setup_fitting_parameters()
    return model


@pytest.fixture(scope="module")
def kl_model():
    model = port.KLNMF(n_signatures=3, device="cpu")
    model._setup_adata(port.AnnData(make_synthetic(seed=1)))
    model._initialize(init_kwargs={"seed": 5})
    model._setup_fitting_parameters()
    return model


def test_full_batch_rho_one_equals_em_cycle(corr_model):
    params, data = corr_model._device_state()
    update_fn, _ = corr_model._build_step()
    expected = update_fn(params, data)
    n_samples = int(corr_model.adata.n_obs)
    config = svi.SVIConfig(batch_size=n_samples, delay=1.0,
                           signature_newton_iters=100)
    state = svi.make_svi_step(n_samples, config)(
        svi.svi_init(params), data["X"], generator(3))
    for name in ("signatures", "signature_scalings", "sample_scalings",
                 "signature_embeddings", "sample_embeddings", "variance"):
        np.testing.assert_allclose(
            state.params[name].numpy(), expected[name].numpy(),
            rtol=1e-8, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_klnmf_full_batch_rho_one_equals_serial_cycle(kl_model, weighted):
    """B=D, rho=1, h_inner_iters=1 == update_H followed by update_W (the
    serial Lee-Seung cycle of the port), including weighted KL."""
    params, data = kl_model._device_state()
    n_samples = int(kl_model.adata.n_obs)
    if weighted:
        data = dict(data, weights_kl=torch.as_tensor(
            np.random.default_rng(0).uniform(0.5, 2.0, n_samples)))
    H_new = port_klops.update_H(data["X"], params["W"], params["H"],
                                data.get("weights_kl"))
    W_new = port_klops.update_W(data["X"], params["W"], H_new,
                                data.get("weights_kl"))
    step_fn = svi.make_klnmf_svi_step(
        n_samples, svi.SVIConfig(batch_size=n_samples, delay=1.0))
    state = step_fn(svi.klnmf_svi_init(params), data, generator())
    np.testing.assert_allclose(state.params["H"].numpy(), H_new.numpy(),
                               rtol=1e-10, err_msg="H")
    np.testing.assert_allclose(state.params["W"].numpy(), W_new.numpy(),
                               rtol=1e-10, err_msg="W")


def test_klnmf_full_batch_anchor_with_lhalf_sparsity(kl_model):
    params, data = kl_model._device_state()
    n_samples = int(kl_model.adata.n_obs)
    data = dict(data, weights_lhalf=torch.as_tensor(
        np.random.default_rng(2).uniform(0.1, 1.0, n_samples)))
    H_new = port_klops.update_H(data["X"], params["W"], params["H"],
                                weights_lhalf=data["weights_lhalf"])
    W_new = port_klops.update_W(data["X"], params["W"], H_new)
    step_fn = svi.make_klnmf_svi_step(
        n_samples, svi.SVIConfig(batch_size=n_samples, delay=1.0))
    state = step_fn(svi.klnmf_svi_init(params), data, generator())
    np.testing.assert_allclose(state.params["H"].numpy(), H_new.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(state.params["W"].numpy(), W_new.numpy(),
                               rtol=1e-10)


def make_mm_model(seed=0, n_samples=50):
    rng = np.random.default_rng(seed)
    mods = {}
    for name, n_features in (("sbs", 20), ("indel", 12)):
        signatures = rng.dirichlet(np.full(n_features, 0.5), size=2)
        exposures = rng.gamma(2.0, 40.0, size=(n_samples, 2))
        X = rng.poisson(exposures @ signatures).astype(float)
        X[X == 0] = 1.0
        mods[name] = X
    mdata = port.MuData({name: port.AnnData(X) for name, X in mods.items()})
    model = port.MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2,
                                   device="cpu")
    return model, mdata


def test_mm_full_batch_rho_one_equals_em_cycle():
    model, mdata = make_mm_model()
    model._setup_mdata(mdata)
    np.random.seed(4)
    model._initialize(init_kwargs={"seed": 4})
    params, data = model._device_state()
    update_fn, _ = model._build_step()
    expected = update_fn(params, data)
    n_samples = int(model.mdata.n_obs)
    config = svi.SVIConfig(batch_size=n_samples, delay=1.0,
                           signature_newton_iters=100)
    step_fn = svi.make_mm_svi_step(n_samples, model.mod_names,
                                   model.ns_signatures, config)
    state = step_fn(svi.mm_svi_init(params), data["X"], generator(9))
    np.testing.assert_allclose(
        state.params["sample_embeddings"].numpy(),
        expected["sample_embeddings"].numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(state.params["variance"]),
                               float(expected["variance"]), rtol=1e-10)
    for name in model.mod_names:
        for field in ("signatures", "signature_scalings", "sample_scalings",
                      "signature_embeddings"):
            np.testing.assert_allclose(
                state.params["mods"][name][field].numpy(),
                expected["mods"][name][field].numpy(),
                rtol=1e-8, atol=1e-10, err_msg=f"{name}/{field}")


def test_minibatch_statistics_are_unbiased(corr_model):
    """The scaled minibatch sufficient statistics average to the full-batch
    statistics (Monte Carlo over 512 batches of 12)."""
    params, data = corr_model._device_state()
    n_samples = int(corr_model.adata.n_obs)
    gen = generator(1)

    def one_step_stats(batch_size):
        config = svi.SVIConfig(batch_size=batch_size, delay=1.0)
        state = svi.make_svi_step(n_samples, config)(
            svi.svi_init(params), data["X"], gen)
        return state.stat_observed, state.stat_predicted, state.stat_counts

    exact = one_step_stats(n_samples)
    sampled = [one_step_stats(12) for _ in range(512)]
    for index, name in enumerate(("observed", "predicted", "counts")):
        mean = torch.stack([stats[index] for stats in sampled]).mean(0)
        np.testing.assert_allclose(mean.numpy(), exact[index].numpy(),
                                   rtol=0.05, err_msg=name)


def test_epoch_sampler_covers_every_sample(corr_model):
    """Minibatches are cut from a per-epoch permutation: one epoch of steps
    refreshes the local parameters of EVERY sample exactly once."""
    params, data = corr_model._device_state()
    n_samples, batch = int(corr_model.adata.n_obs), 12  # 60 = 5 * 12
    step_fn = svi.make_svi_step(n_samples, svi.SVIConfig(batch_size=batch))
    state = svi.svi_init(params)
    assert state.cursor == n_samples and state.step == 0
    before = params["sample_scalings"].numpy().copy()
    gen = generator(100)
    seen = []
    for i in range(n_samples // batch):
        state = step_fn(state, data["X"], gen)
        assert state.cursor == (i + 1) * batch
        seen.append(state.perm[i * batch:(i + 1) * batch].numpy())
    assert sorted(np.concatenate(seen).tolist()) == list(range(n_samples))
    assert np.all(state.params["sample_scalings"].numpy() != before)
    np.testing.assert_allclose(
        float(state.stat_usq),
        float((state.params["sample_embeddings"] ** 2).sum()), rtol=1e-10)


def test_epoch_sampler_drops_the_last_partial_batch(corr_model):
    """B = 25 of 60: every epoch is two steps over 50 distinct samples, and
    the third step reshuffles (one generator draw an epoch)."""
    params, data = corr_model._device_state()
    n_samples, batch = int(corr_model.adata.n_obs), 25
    step_fn = svi.make_svi_step(n_samples, svi.SVIConfig(batch_size=batch))
    state, gen, twin = svi.svi_init(params), generator(7), generator(7)
    for epoch in range(3):
        expected = svi.draw_permutation(twin, n_samples)
        for i in range(2):
            state = step_fn(state, data["X"], gen)
            assert state.cursor == (i + 1) * batch
        np.testing.assert_array_equal(state.perm.numpy(), expected.numpy())
    assert state.step == 6
    assert len(set(state.perm[:50].tolist())) == 50


def test_batch_size_validation():
    with pytest.raises(ValueError, match="batch_size"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=11))
    with pytest.raises(ValueError, match="batch_size"):
        svi.make_svi_step(10, svi.SVIConfig(batch_size=0))
    with pytest.raises(ValueError, match="h_inner_iters"):
        svi.make_klnmf_svi_step(10, svi.SVIConfig(batch_size=5),
                                h_inner_iters=0)


@pytest.mark.parametrize("build, config, match", [
    (lambda c: svi.make_svi_step(10, c),
     dict(batch_size=5, delay=0.0), "delay"),
    (lambda c: svi.make_mm_svi_step(10, ["a"], [2], c),
     dict(batch_size=5, delay=0.5), "delay"),
    (lambda c: svi.make_svi_step(10, c),
     dict(batch_size=5, forgetting=0.5), "forgetting"),
    (lambda c: svi.make_klnmf_svi_step(10, c),
     dict(batch_size=5, forgetting=1.5), "forgetting"),
    (lambda c: svi.make_svi_step(10, c),
     dict(batch_size=5, signature_newton_iters=0), "Newton"),
], ids=["delay-0", "mm-delay-half", "forgetting-half", "forgetting-1.5",
        "newton-0"])
def test_schedule_validation(build, config, match):
    """The same four ValueErrors as the JAX package, with its messages."""
    with pytest.raises(ValueError, match=match) as error:
        build(svi.SVIConfig(**config))
    with pytest.raises(ValueError) as jax_error:
        jax_svi._validate_config(jax_svi.SVIConfig(**config), 10)
    assert str(error.value) == str(jax_error.value)


def test_run_svi_eval_freq_validation_and_disable(corr_model):
    params, data = corr_model._device_state()
    step_fn = svi.make_svi_step(int(corr_model.adata.n_obs),
                                svi.SVIConfig(batch_size=16))
    state0 = svi.svi_init(params)
    with pytest.raises(ValueError, match="eval_freq"):
        svi.run_svi(step_fn, state0, data["X"], generator(), n_steps=10,
                    eval_freq=-1)
    with pytest.raises(ValueError, match="n_steps"):
        svi.run_svi(step_fn, state0, data["X"], generator(), n_steps=0,
                    eval_freq=5)
    state, history = svi.run_svi(step_fn, state0, data["X"], generator(),
                                 n_steps=25, eval_freq=0)
    assert history.shape == (0,) and history.dtype == torch.float64
    assert state.step == 25


def test_run_svi_remainder_steps(corr_model):
    """n_steps not divisible by eval_freq: the remainder steps still run."""
    params, data = corr_model._device_state()
    step_fn = svi.make_svi_step(int(corr_model.adata.n_obs),
                                svi.SVIConfig(batch_size=16))
    state, history = svi.run_svi(step_fn, svi.svi_init(params), data["X"],
                                 generator(), n_steps=47, eval_freq=20)
    assert history.shape == (2,)
    assert state.step == 47


def test_minibatch_steps_raise_full_elbo(corr_model):
    params, data = corr_model._device_state()
    step_fn = svi.make_svi_step(int(corr_model.adata.n_obs),
                                svi.SVIConfig(batch_size=16))
    state0 = svi.svi_init(params)
    elbo0 = float(svi.full_elbo(state0.params, data["X"]))
    state, history = svi.run_svi(step_fn, state0, data["X"], generator(),
                                 n_steps=300, eval_freq=50)
    history = history.numpy()
    assert history.shape == (6,) and np.all(np.isfinite(history))
    assert float(svi.full_elbo(state.params, data["X"])) > elbo0
    assert history[-1] > history[0]


def test_klnmf_minibatch_steps_reduce_objective(kl_model):
    params, data = kl_model._device_state()
    state0 = svi.klnmf_svi_init(params)
    obj0 = float(svi.klnmf_full_objective(state0.params, data))
    step_fn = svi.make_klnmf_svi_step(
        int(kl_model.adata.n_obs), svi.SVIConfig(batch_size=16, delay=20.0),
        h_inner_iters=2)
    state, trace = svi.run_svi(step_fn, state0, data, generator(),
                               n_steps=400, eval_freq=100,
                               elbo_fn=svi.klnmf_full_objective)
    trace = trace.numpy()
    assert trace.shape == (4,) and np.all(np.isfinite(trace))
    assert float(svi.klnmf_full_objective(state.params, data)) < obj0
    assert trace[-1] < trace[0]


# --------------------------------------------------------------------- #
# objectives, full and streamed, against the JAX package
# --------------------------------------------------------------------- #


def test_full_elbo_matches_jax():
    X, params = make_counts(0), corr_params(1)
    np.testing.assert_allclose(
        float(svi.full_elbo(to_torch(params), torch.as_tensor(X))),
        float(jax_svi.full_elbo(to_jax(params), jnp.asarray(X))), rtol=1e-10)


def kl_problem():
    rng = np.random.default_rng(3)
    X = make_counts(4).T
    X[:, 3] = 0.0  # the x ln x limit
    params = {"W": rng.dirichlet(np.ones(V), size=K).T,
              "H": rng.gamma(2.0, 20.0, (K, D))}
    data = {"X": X, "weights_kl": rng.uniform(0.5, 2.0, D),
            "weights_lhalf": rng.uniform(0.1, 1.0, D)}
    return params, data


@pytest.mark.parametrize("weights", [(), ("weights_kl",),
                                     ("weights_kl", "weights_lhalf")],
                         ids=["plain", "kl", "kl-lhalf"])
def test_klnmf_full_objective_matches_jax(weights):
    params, data = kl_problem()
    data = {k: v for k, v in data.items() if k == "X" or k in weights}
    np.testing.assert_allclose(
        float(svi.klnmf_full_objective(to_torch(params), to_torch(data))),
        float(jax_svi.klnmf_full_objective(to_jax(params), to_jax(data))),
        rtol=1e-10)


def test_mm_full_elbo_matches_jax():
    X = {"sbs": make_counts(6), "indel": make_counts(7, (D, 11), 12.0)}
    params = mm_params(8)
    np.testing.assert_allclose(
        float(svi.mm_full_elbo(to_torch(params), to_torch(X))),
        float(jax_svi.mm_full_elbo(to_jax(params), to_jax(X))), rtol=1e-10)


@pytest.mark.parametrize("chunk_size", [9, 50, 8192],
                         ids=["ragged", "one-chunk", "clamped"])
def test_streamed_corrnmf_elbo_matches_jax_and_the_full_elbo(chunk_size):
    X, params = make_counts(0), corr_params(1)
    streamed = svi.make_streamed_objective(
        svi.corrnmf_elbo_stream_chunk, svi.corrnmf_elbo_stream_rest,
        lambda i: X[i], D, chunk_size=chunk_size)
    streamed_j = jax_svi.make_streamed_objective(
        jax_svi.corrnmf_elbo_stream_chunk, jax_svi.corrnmf_elbo_stream_rest,
        lambda i: X[i], D, chunk_size=chunk_size)
    value = float(streamed(to_torch(params)))
    np.testing.assert_allclose(value, float(streamed_j(to_jax(params))),
                               rtol=1e-10)
    np.testing.assert_allclose(
        value, float(svi.full_elbo(to_torch(params), torch.as_tensor(X))),
        rtol=1e-10)


def test_streamed_klnmf_objective_matches_jax_and_the_full_objective():
    params, data = kl_problem()

    def get_chunk(i):
        return {"X": np.ascontiguousarray(data["X"][:, i]),
                "weights_kl": data["weights_kl"][i],
                "weights_lhalf": data["weights_lhalf"][i]}

    streamed = svi.make_streamed_objective(
        svi.klnmf_objective_stream_chunk, svi.klnmf_objective_stream_rest,
        get_chunk, D, chunk_size=13)
    streamed_j = jax_svi.make_streamed_objective(
        jax_svi.klnmf_objective_stream_chunk,
        jax_svi.klnmf_objective_stream_rest, get_chunk, D, chunk_size=13)
    value = float(streamed(to_torch(params)))
    np.testing.assert_allclose(value, float(streamed_j(to_jax(params))),
                               rtol=1e-10)
    np.testing.assert_allclose(
        value,
        float(svi.klnmf_full_objective(to_torch(params), to_torch(data))),
        rtol=1e-10)


def test_streamed_mm_elbo_matches_jax_and_the_full_elbo():
    X = {"sbs": make_counts(6), "indel": make_counts(7, (D, 11), 12.0)}
    params = mm_params(8)

    def get_chunk(i):
        return {name: counts[i] for name, counts in X.items()}

    streamed = svi.make_streamed_objective(
        svi.mm_elbo_stream_chunk, svi.mm_elbo_stream_rest, get_chunk, D,
        chunk_size=17)
    streamed_j = jax_svi.make_streamed_objective(
        jax_svi.mm_elbo_stream_chunk, jax_svi.mm_elbo_stream_rest, get_chunk,
        D, chunk_size=17)
    value = float(streamed(to_torch(params)))
    np.testing.assert_allclose(value, float(streamed_j(to_jax(params))),
                               rtol=1e-10)
    np.testing.assert_allclose(
        value, float(svi.mm_full_elbo(to_torch(params), to_torch(X))),
        rtol=1e-10)


# --------------------------------------------------------------------- #
# the upload ring on its CPU path, and run_svi_streaming against
# run_svi
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("prefetch", [1, 2, 4])
@pytest.mark.parametrize("n_items", [1, 3, 11])
def test_prefetched_ring_yields_every_item_in_order(prefetch, n_items):
    """Slots are reused (prefetch + 1 of them), items differ in shape: each
    must arrive whole, in order, with its extra, while later uploads
    overwrite the slots of items already consumed."""
    rng = np.random.default_rng(0)
    items = [({"batch": {"X": rng.normal(size=(3, 4 + i % 3))},
               "indices": np.arange(i, i + 4)}, f"extra-{i}")
             for i in range(n_items)]
    ring = svi._UploadRing(prefetch + 1, "cpu")
    received = []
    for tree, extra in svi._prefetched(iter(items), ring, prefetch):
        assert tree["batch"]["X"].is_contiguous()
        received.append((tree["batch"]["X"].numpy().copy(),
                         tree["indices"].numpy().copy(), extra))
    assert len(received) == n_items
    for (X, indices, extra), (tree, expected) in zip(received, items):
        np.testing.assert_array_equal(X, tree["batch"]["X"])
        np.testing.assert_array_equal(indices, tree["indices"])
        assert extra == expected
    assert len(ring.slots) == prefetch + 1


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_run_svi_streaming_equals_run_svi_bitwise(corr_model, prefetch):
    """The streaming loop and the resident one from equal generators:
    bit-equal parameters at every prefetch depth, evaluations at the same
    step positions."""
    params, data = corr_model._device_state()
    n_samples = int(corr_model.adata.n_obs)
    config = svi.SVIConfig(batch_size=25, delay=2.0)  # drop-last epochs
    X_host = data["X"].numpy()
    resident, trace = svi.run_svi(
        svi.make_svi_step(n_samples, config), svi.svi_init(params),
        data["X"], generator(4), n_steps=23, eval_freq=5)
    streamed, trace_s = svi.run_svi_streaming(
        svi.make_svi_batch_step(n_samples, config),
        svi.svi_init(params, streaming=True), lambda i: X_host[i],
        n_samples, 25, generator(4), n_steps=23, eval_freq=5,
        objective_fn=lambda p: svi.full_elbo(p, data["X"]),
        refresh_fn=svi.refresh_sample_usq, prefetch=prefetch)
    assert streamed.step == resident.step == 23
    assert streamed.perm.shape == (0,)
    for name, leaf in resident.params.items():
        np.testing.assert_array_equal(streamed.params[name].numpy(),
                                      leaf.numpy(), err_msg=name)
    np.testing.assert_array_equal(streamed.stat_usq.numpy(),
                                  resident.stat_usq.numpy())
    np.testing.assert_array_equal(trace_s.numpy(), trace.numpy())
    assert trace.shape == (4,)


def test_run_svi_streaming_validation(corr_model):
    params, _ = corr_model._device_state()
    core = svi.make_svi_batch_step(60, svi.SVIConfig(batch_size=16))
    state0 = svi.svi_init(params, streaming=True)
    for kwargs, match in ((dict(n_steps=0), "n_steps"),
                          (dict(n_steps=5, eval_freq=-1), "eval_freq"),
                          (dict(n_steps=5, batch_size=61), "batch_size"),
                          (dict(n_steps=5, prefetch=0), "prefetch")):
        kwargs = {"batch_size": 16, **kwargs}
        with pytest.raises(ValueError, match=match):
            svi.run_svi_streaming(core, state0, lambda i: None, 60,
                                  generator=generator(), **kwargs)
