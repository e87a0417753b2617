"""salamander_tpu_torch's MultimodalCorrNMF against salamander_tpu's at
float64 on the CPU, from the same numpy-drawn counts (3 modalities, V =
12/9/6, D = 20, ns_signatures [3, 2, 2], m = 2) and the same global numpy
seed: the host inits bit-equal, one EM cycle per leaf at rtol 1e-10 (the
embeddings, which come out of a Newton solve stopped at xtol 1e-5, and the
variance computed from them at 1e-8), every eager update method and the
ELBO at 1e-10 from a bit-equal state, fit, transform, warm start, the
newton_cg_compat host loop and each nested given_parameters key at equal
iteration counts and ELBO rtol 1e-8 (the fitted leaves, tens of cycles
downstream, at 1e-6), the batched device init's contract, and the error
messages."""

import re

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import models as jax_models
from salamander_tpu.initialization import initialize as jax_initialize
from salamander_tpu_torch.engine import params_from_numpy, params_to_numpy
from salamander_tpu_torch.engine.tree import tree_flatten, tree_leaves
from salamander_tpu_torch.initialization import initialize as port_initialize
from salamander_tpu_torch.initialization.methods import mm_corrnmf_init_batch

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 20
FEATURES = {"sbs": 12, "indel": 9, "sv": 6}
HYPER = dict(ns_signatures=[3, 2, 2], dim_embeddings=2, min_iterations=20,
             max_iterations=60, tol=1e-6)
PACKAGES = ((jax_models, jax_containers, {}), (port, port, {"device": "cpu"}))


def counts(seed=0, n_samples=N_SAMPLES):
    """Poisson counts around a planted low-rank rate, one frame per
    modality, sample names shared."""
    rng = np.random.default_rng(seed)
    load = rng.gamma(2.0, 1.0, (n_samples, 3))
    out = {}
    for name, n_features in FEATURES.items():
        basis = rng.dirichlet(np.ones(n_features), 3)
        out[name] = rng.poisson(60.0 * load @ basis).astype(float)
    return out


def mdata_of(containers, seed=0, n_samples=N_SAMPLES):
    return containers.MuData({
        name: containers.AnnData(X.copy())
        for name, X in counts(seed, n_samples).items()
    })


def build(package, containers, extra, hyper=HYPER):
    return package.MultimodalCorrNMF(**hyper, **extra), mdata_of(containers)


def fit_both(seed=0, hyper=HYPER, given=None, **fit_kwargs):
    """The same fit in both packages from the same numpy seed. `given`
    builds the nested given_parameters from a package's containers."""
    models = []
    for package, containers, extra in PACKAGES:
        model, mdata = build(package, containers, extra, hyper)
        if given is not None:
            fit_kwargs["given_parameters"] = given(containers)
        np.random.seed(seed)
        models.append(model.fit(mdata, **fit_kwargs))
    return models


LEAVES = {
    "signatures": lambda m, n: m.asignatures[n].X,
    "signature_scalings": lambda m, n: m.asignatures[n].obs["scalings"],
    "sample_scalings": lambda m, n: m.mdata[n].obs["scalings"],
    "signature_embeddings": lambda m, n: m.asignatures[n].obsm["embeddings"],
    "exposures": lambda m, n: m.mdata[n].obsm["exposures"],
}


def assert_same_state(model_j, model_t, rtol, atol=0.0, newton_rtol=None):
    """Every leaf of the state; `newton_rtol` (default rtol) holds the
    embeddings and the variance, the outputs of the Newton solves."""
    newton_rtol = rtol if newton_rtol is None else newton_rtol
    for name in FEATURES:
        for leaf, getter in LEAVES.items():
            np.testing.assert_allclose(
                np.asarray(getter(model_t, name), dtype=float),
                np.asarray(getter(model_j, name), dtype=float),
                rtol=newton_rtol if leaf == "signature_embeddings" else rtol,
                atol=atol, err_msg=f"{name}/{leaf}")
    np.testing.assert_allclose(model_t.mdata.obsm["embeddings"],
                               model_j.mdata.obsm["embeddings"],
                               rtol=newton_rtol, atol=atol)
    np.testing.assert_allclose(model_t.variance, model_j.variance,
                               rtol=newton_rtol)


def assert_same_fit(model_j, model_t, rtol=RTOL):
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=rtol)
    np.testing.assert_allclose(model_t.objective_function(),
                               model_j.objective_function(), rtol=rtol)
    # tens of cycles downstream; embeddings near zero carry the Newton
    # solves' absolute error
    assert_same_state(model_j, model_t, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def fitted():
    return fit_both()


def initialized_pair(seed=4, hyper=HYPER):
    models = []
    for package, containers, extra in PACKAGES:
        model, mdata = build(package, containers, extra, hyper)
        model._setup_mdata(mdata)
        np.random.seed(seed)
        model._initialize()
        models.append(model)
    return models


def perturbed_pair(seed=8):
    """Bit-equal states off the init values: the zero scalings replaced by
    the same numpy draws in both packages, exposures recomputed."""
    models = initialized_pair(seed=seed)
    for model in models:
        rng = np.random.default_rng(seed)
        for name, k in zip(FEATURES, [3, 2, 2]):
            model.asignatures[name].obs["scalings"] = rng.normal(0, 0.3, k)
            model.mdata[name].obs["scalings"] = rng.normal(0, 0.3, N_SAMPLES)
        model.compute_exposures()
    return models


# ------------------------------------------------------------------ #
# initialization
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("method", ["nndsvd", "random"])
def test_initialize_mmcorrnmf_draws_equal_jax(method):
    """Per-modality inits first, then one draw for the shared sample
    embeddings: the global numpy RNG is consumed in the same order."""
    outs = []
    for initialize, containers in ((jax_initialize, jax_containers),
                                   (port_initialize, port)):
        mdata = mdata_of(containers)
        np.random.seed(6)
        asignatures, variance = initialize.initialize_mmcorrnmf(
            mdata, [3, 2, 2], 2, method=method, seed=1)
        outs.append((asignatures, mdata, variance))
    (sig_j, mdata_j, var_j), (sig_t, mdata_t, var_t) = outs
    for name in FEATURES:
        np.testing.assert_array_equal(sig_t[name].X, sig_j[name].X)
        np.testing.assert_array_equal(sig_t[name].obsm["embeddings"],
                                      sig_j[name].obsm["embeddings"])
        assert list(sig_t[name].obs_names) == list(sig_j[name].obs_names)
        assert sig_t[name].obs_names[0] == f"{name} Sig1"
    np.testing.assert_array_equal(mdata_t.obsm["embeddings"],
                                  mdata_j.obsm["embeddings"])
    assert var_t == var_j == 1.0


def test_given_names_keep_theirs_and_generated_get_the_prefix():
    outs = []
    for initialize, containers in ((jax_initialize, jax_containers),
                                   (port_initialize, port)):
        mdata = mdata_of(containers)
        given = mdata["sbs"][:1, :].copy()
        given.X = given.X / given.X.sum(axis=1, keepdims=True)
        given.obs_names = ["Known"]
        np.random.seed(2)
        asignatures, _ = initialize.initialize_mmcorrnmf(
            mdata, [3, 2, 2], 2,
            given_parameters={"sbs": {"asignatures": given}})
        outs.append(list(asignatures["sbs"].obs_names))
    assert outs[0] == outs[1] == ["Known", "sbs Sig1", "sbs Sig2"]


@pytest.mark.parametrize("given", [
    {"sbs": {"sample_embeddings": np.zeros((N_SAMPLES, 2))}},
    {"indel": {"variance": 1.0}},
    {"unknown": 1},
    {"sbs": {"unknown": 1}},
    {"sv": {"signature_scalings": np.zeros(5)}},
], ids=["mod-sample-embeddings", "mod-variance", "unknown-key",
        "mod-unknown-key", "scalings-shape"])
def test_given_parameter_checks_match_jax(given):
    errors = []
    for initialize, containers in ((jax_initialize, jax_containers),
                                   (port_initialize, port)):
        with pytest.raises((KeyError, ValueError, TypeError)) as error:
            initialize.check_given_parameters_mmcorrnmf(
                mdata_of(containers), [3, 2, 2], 2, given)
        errors.append((type(error.value), str(error.value)))
    assert errors[0] == errors[1]


def test_device_init_batch_contract():
    """jax.random cannot be reproduced, so the contract is held: shapes,
    signature rows summing to one, ONE shared sample-embedding draw behind
    every modality's exposures, zero scalings, unit variance, and a seed
    reproducing its draw."""
    model, mdata = build(port, port, {"device": "cpu"})
    model._setup_mdata(mdata)
    model._initialize()
    _, data = model._device_state()

    def draw(seed):
        generator = torch.Generator().manual_seed(seed)
        return mm_corrnmf_init_batch(generator, data["X"], model.mod_names,
                                     [3, 2, 2], 2, 5)

    params = draw(3)
    assert list(params) == ["mods", "sample_embeddings", "variance"]
    assert params["sample_embeddings"].shape == (5, N_SAMPLES, 2)
    assert torch.equal(params["variance"], torch.ones(5, dtype=torch.float64))
    for (name, n_features), k in zip(FEATURES.items(), [3, 2, 2]):
        mod = params["mods"][name]
        assert mod["signatures"].shape == (5, k, n_features)
        torch.testing.assert_close(mod["signatures"].sum(-1),
                                   torch.ones(5, k, dtype=torch.float64))
        assert not mod["signature_scalings"].any()
        assert not mod["sample_scalings"].any()
        expected = torch.exp(mod["signature_embeddings"]
                             @ params["sample_embeddings"].mT).mT
        torch.testing.assert_close(mod["exposures"], expected)
    again, other = draw(3), draw(4)
    for a, b, c in zip(tree_leaves(params), tree_leaves(again),
                       tree_leaves(other)):
        assert torch.equal(a, b)
    assert not torch.equal(params["sample_embeddings"],
                           other["sample_embeddings"])
    lanes = params["mods"]["sbs"]["signatures"]
    assert not torch.equal(lanes[0], lanes[1])


# ------------------------------------------------------------------ #
# one cycle, the eager methods, the ELBO
# ------------------------------------------------------------------ #


def test_one_cycle_matches_jax_per_leaf():
    model_j, model_t = initialized_pair()
    assert_same_state(model_j, model_t, rtol=0.0)  # the inits are bit-equal
    model_j._update_parameters()
    model_t._update_parameters()
    assert_same_state(model_j, model_t, rtol=1e-10, newton_rtol=1e-8)


def test_elbo_and_reconstruction_error_match_jax():
    values = []
    for model in perturbed_pair():
        values.append((model.objective_function(),
                       model.reconstruction_error,
                       *model.reconstruction_errors.values()))
    np.testing.assert_allclose(values[1], values[0], rtol=1e-10)


def _after(method, seed=8):
    """Each reference-named update applied to the same state."""
    models = perturbed_pair(seed=seed)
    for model in models:
        auxs = model._compute_auxs()
        if method in ("update_signature_scalings", "update_embeddings",
                      "update_signature_embeddings",
                      "update_sample_embeddings"):
            getattr(model, method)(auxs)
        else:
            getattr(model, method)()
    return models


@pytest.mark.parametrize("method", [
    "update_sample_scalings", "update_signature_scalings",
    "update_signature_embeddings", "update_sample_embeddings",
    "update_embeddings", "update_variance", "update_signatures",
])
def test_eager_update_changes_state_as_in_jax(method):
    model_j, model_t = _after(method)
    assert_same_state(model_j, model_t, rtol=1e-10, newton_rtol=1e-8)


def test_compute_aux_and_exposures_match_jax():
    model_j, model_t = initialized_pair(seed=1)
    for name in FEATURES:
        np.testing.assert_allclose(model_t._compute_auxs()[name],
                                   np.asarray(model_j._compute_auxs()[name]),
                                   rtol=1e-12)
        assert list(model_t.exposures[name].columns) == \
            list(model_j.exposures[name].columns)
    assert model_t.mod_names == model_j.mod_names == list(FEATURES)
    assert model_t.signature_names == model_j.signature_names
    assert model_t.sample_names == model_j.sample_names


def test_step_is_lane_batched_native():
    """Two different states stacked on a lane axis: the batched step and
    objective give each lane what it gets alone, with shared data and with
    per-lane data."""
    model = build(port, port, {"device": "cpu"})[0]
    states, datas = [], []
    for seed in (1, 2):
        model._setup_mdata(mdata_of(port, seed=seed))
        np.random.seed(seed)
        model._initialize()
        params, data = model._device_state()
        states.append(params)
        datas.append(data)
    update_fn, objective_fn = model._build_step()
    from salamander_tpu_torch.engine.tree import tree_map

    stacked = tree_map(lambda a, b: torch.stack([a, b]), *states)
    for data in (datas[0], tree_map(lambda a, b: torch.stack([a, b]),
                                    *datas)):
        batched = update_fn(stacked, data)
        elbo = objective_fn(batched, data)
        assert elbo.shape == (2,) and batched["variance"].shape == (2,)
        for lane in range(2):
            lane_data = data if data is datas[0] else datas[lane]
            # lane 1 under the shared data fits lane 0's counts
            alone = update_fn(states[lane], lane_data)
            for (path, a), b in zip(tree_flatten(alone).items(),
                                    tree_leaves(batched)):
                # the Newton solves amplify the last bits in which a
                # batched product differs from an unbatched one
                torch.testing.assert_close(b[lane], a, rtol=1e-6,
                                           atol=1e-8, msg=path)
            torch.testing.assert_close(elbo[lane],
                                       objective_fn(alone, lane_data),
                                       rtol=1e-12, atol=0)


# ------------------------------------------------------------------ #
# fits
# ------------------------------------------------------------------ #


def test_fit_matches_jax(fitted):
    model_j, model_t = fitted
    assert_same_fit(model_j, model_t)
    trace = np.asarray(model_t.history["objective_function"])
    assert np.all(np.diff(trace) >= -1e-8 * np.abs(trace[:-1]))
    assert model_t._is_fitted and model_t.variance > 0
    assert model_t.history["step_freq"] == 10
    np.testing.assert_allclose(model_t.reconstruction_error,
                               model_j.reconstruction_error, rtol=RTOL)
    assert list(model_t.mdata.obs.columns) == list(model_j.mdata.obs.columns)


def test_final_elbo_equals_objective_function_on_absorbed_state():
    """A fresh fit: reading reconstruction errors would recompute the
    exposures from the final embeddings and move the ELBO."""
    model_t, mdata = build(port, port, {"device": "cpu"})
    np.random.seed(0)
    model_t.fit(mdata)
    assert model_t.history["n_iterations"] % 10 == 0
    np.testing.assert_allclose(model_t.history["objective_function"][-1],
                               model_t.objective_function(), rtol=1e-10)


def test_fit_float32_runs_and_promotes_the_objective():
    model, mdata = build(port, port, {"device": "cpu", "dtype": "float32"})
    np.random.seed(0)
    model.fit(mdata)
    assert model.asignatures["sbs"].X.dtype == np.float32
    assert np.asarray(model.history["objective_function"]).dtype == np.float64
    assert model.history["tol_effective"] == pytest.approx(
        10 * np.finfo(np.float32).eps)
    assert np.isfinite(model.objective_function())


def test_newton_cg_compat_fit_matches_jax():
    hyper = dict(HYPER, newton_cg_compat=True, min_iterations=10,
                 max_iterations=20)
    model_j, model_t = fit_both(seed=3, hyper=hyper)
    assert_same_fit(model_j, model_t)
    assert model_t.history["n_iterations"] == 20


def test_warm_start_matches_jax(fitted):
    """A second fit continuing from the first one's state, in both."""
    hyper = dict(HYPER, min_iterations=10, max_iterations=30)
    models = fit_both(seed=5, hyper=hyper)
    mdatas = [model.mdata for model in models]
    for model, mdata in zip(models, mdatas):
        before = model.objective_function()
        model.fit(mdata, warm_start=True)
        assert model.objective_function() >= before - 1e-8 * abs(before)
    assert_same_fit(*models)
    model_t = models[1]
    with pytest.raises(ValueError, match="cannot be combined"):
        model_t.fit(mdatas[1], warm_start=True,
                    given_parameters={"variance": 1.0})
    fresh, mdata = build(port, port, {"device": "cpu"})
    with pytest.raises(ValueError, match="resumes from the state"):
        fresh.fit(mdata, warm_start=True)


def test_transform_matches_jax(fitted):
    """Both projectors start from the same fitted signature side (the JAX
    model's parameters carried across engine.transfer) and seed."""
    model_j, model_t = fitted
    params_j = model_j._device_state()[0]
    carried = params_from_numpy(params_j, device="cpu")
    assert carried["mods"]["sv"]["signatures"].dtype == torch.float64
    model_t._absorb_params(params_to_numpy(carried))
    np.random.seed(9)
    projector_j = model_j.transform(mdata_of(jax_containers, seed=7,
                                             n_samples=12))
    np.random.seed(9)
    projector_t = model_t.transform(mdata_of(port, seed=7, n_samples=12))
    assert_same_fit(projector_j, projector_t)
    for name in FEATURES:
        np.testing.assert_array_equal(projector_t.asignatures[name].X,
                                      model_t.asignatures[name].X)
        np.testing.assert_array_equal(
            projector_t.asignatures[name].obsm["embeddings"],
            model_t.asignatures[name].obsm["embeddings"])
    assert projector_t.variance == model_t.variance
    assert projector_t.device == model_t.device
    assert projector_t.dtype == model_t.dtype
    assert projector_t.mdata.n_obs == 12 and model_t.mdata.n_obs == N_SAMPLES
    with pytest.raises(ValueError, match="given_parameters"):
        model_t.transform(mdata_of(port), given_parameters={})
    with pytest.raises(ValueError, match="fitted"):
        build(port, port, {"device": "cpu"})[0].transform(mdata_of(port))


def _given_signatures(n_given):
    def given(containers):
        sigs = mdata_of(containers)["sbs"][:n_given, :].copy()
        sigs.X = sigs.X / sigs.X.sum(axis=1, keepdims=True)
        return {"sbs": {"asignatures": sigs}}
    return given


GIVEN = {
    "asignatures-some": _given_signatures(2),
    "asignatures-all": _given_signatures(3),
    "signature_scalings": lambda c: {
        "indel": {"signature_scalings": np.array([0.3, -0.2])}},
    "signature_embeddings": lambda c: {
        "sv": {"signature_embeddings": np.array([[0.5, -0.1], [0.2, 0.4]])}},
    "sample_scalings": lambda c: {
        "sbs": {"sample_scalings": np.linspace(-0.5, 0.5, N_SAMPLES)}},
    "sample_embeddings": lambda c: {
        "sample_embeddings": np.random.default_rng(1).normal(
            size=(N_SAMPLES, 2))},
    "variance": lambda c: {"variance": 3.0},
}


@pytest.mark.parametrize("key", sorted(GIVEN))
def test_given_parameters_isolated_and_match_jax(key):
    """Each nested given key alone: frozen where it was given and nowhere
    else (the JAX package's tests/test_model_mmcorrnmf.py cases), with the
    rest of the fit equal to the JAX package's."""
    hyper = dict(HYPER, min_iterations=10, max_iterations=20)
    model_j, model_t = fit_both(seed=2, hyper=hyper, given=GIVEN[key])
    assert_same_fit(model_j, model_t)
    given = GIVEN[key](port)
    if key.startswith("asignatures"):
        sigs = given["sbs"]["asignatures"]
        n_given = sigs.n_obs
        np.testing.assert_array_equal(
            model_t.asignatures["sbs"].X[:n_given], sigs.X)
        assert model_t._mod_flags(given)["sbs"]["fix_signatures"] == \
            (n_given == 3)
        if n_given < 3:
            free = model_t.asignatures["sbs"].X[n_given:].copy()
            model_t._update_parameters(given)
            assert not np.allclose(free,
                                   model_t.asignatures["sbs"].X[n_given:])
            np.testing.assert_array_equal(
                model_t.asignatures["sbs"].X[:n_given], sigs.X)
    elif key == "signature_scalings":
        np.testing.assert_array_equal(
            model_t.asignatures["indel"].obs["scalings"],
            given["indel"][key])
        assert not np.allclose(model_t.asignatures["sv"].obs["scalings"],
                               given["indel"][key])
    elif key == "signature_embeddings":
        np.testing.assert_array_equal(
            model_t.asignatures["sv"].obsm["embeddings"], given["sv"][key])
        assert not np.allclose(
            model_t.asignatures["indel"].obsm["embeddings"], given["sv"][key])
    elif key == "sample_scalings":
        np.testing.assert_array_equal(model_t.mdata["sbs"].obs["scalings"],
                                      given["sbs"][key])
        assert not np.allclose(model_t.mdata["indel"].obs["scalings"],
                               given["sbs"][key])
    elif key == "sample_embeddings":
        np.testing.assert_array_equal(model_t.mdata.obsm["embeddings"],
                                      given[key])
    else:
        assert model_t.variance == 3.0


# ------------------------------------------------------------------ #
# correlations, errors, what is not ported
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("data", ["samples", "signatures"])
def test_correlation_matches_jax(fitted, data):
    model_j, model_t = fitted
    frame_j, frame_t = model_j.correlation(data), model_t.correlation(data)
    assert list(frame_t.index) == list(frame_j.index)
    np.testing.assert_allclose(frame_t.to_numpy(), frame_j.to_numpy(),
                               rtol=1e-6, atol=1e-8)
    size = N_SAMPLES if data == "samples" else 7
    assert frame_t.shape == (size, size)
    with pytest.raises(ValueError):
        model_t.correlation("features")


def test_setup_errors_match_jax():
    for package, containers, extra in PACKAGES:
        model = package.MultimodalCorrNMF([2, 2], **extra)
        with pytest.raises(ValueError, match="2 many modalities"):
            model.fit(mdata_of(containers))
    errors = []
    for package, containers, extra in PACKAGES:
        model = package.MultimodalCorrNMF([3, 2, 2], **extra)
        mdata = mdata_of(containers)
        mdata["indel"].obs_names = [f"other{d}" for d in range(N_SAMPLES)]
        with pytest.raises(ValueError) as error:
            model.fit(mdata)
        errors.append(str(error.value))
        with pytest.raises(ValueError, match="not supported"):
            package.MultimodalCorrNMF(
                [3, 2, 2], init_method="custom", **extra
            ).fit(mdata_of(containers))
    assert errors[0] == errors[1]
    assert "sample names" in errors[1]


def test_device_none_needs_a_card_and_dtype_follows_the_device():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            port.MultimodalCorrNMF([2, 2])
    model = port.MultimodalCorrNMF([2, 3], device="cpu")
    assert model.dtype == "float64" and model.dim_embeddings == 3
    assert model.mod_names == ["mod1", "mod2"] and model.objective == "maximize"
    assert np.isnan(model.signature_correlation).all()
    with pytest.raises(ValueError, match="Unsupported model dtype"):
        port.MultimodalCorrNMF([2, 2], dtype="float16", device="cpu")


@pytest.mark.parametrize("method,item", [
    ("fit_minibatch", 18), ("plot_history", 6), ("plot_signatures", 6),
    ("plot_exposures", 6), ("plot_correlation", 6), ("plot_embeddings", 6),
], ids=["fit_minibatch-17", "plot_history-6", "plot_signatures-6",
        "plot_exposures-6", "plot_correlation-6", "plot_embeddings-6"])
def test_unported_methods_name_their_roadmap_item(fitted, method, item):
    """Nothing waits any more. fit_minibatch's mesh came with item 18:
    with streaming=True it raises the JAX package's refusal. The plots
    (item 6) came with plot.py: each draws what the JAX package's method
    draws, or raises what it raises."""
    model_j, model_t = fitted
    if item == 18:
        with pytest.raises(ValueError) as expected:
            getattr(model_j, method)(mdata=None, streaming=True,
                                     mesh=object())
        with pytest.raises(ValueError, match=re.escape(
                str(expected.value))):
            getattr(model_t, method)(mdata=None, streaming=True,
                                     mesh=object())
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kwargs = {"method": "pca"} if method == "plot_embeddings" else {}
    try:
        try:
            expected = getattr(model_j, method)(**kwargs)
        except Exception as err:  # the port must raise the same
            with pytest.raises(type(err), match=re.escape(str(err))):
                getattr(model_t, method)(**kwargs)
            return
        got = getattr(model_t, method)(**kwargs)
        assert type(got) is type(expected)
    finally:
        plt.close("all")


def test_mesh_names_its_roadmap_item():
    """fit(mesh=) was ROADMAP item 18, now done: on a world of one it is
    the meshless fit, bit for bit, and agrees with the JAX package's fit on
    4 sample ways of its virtual devices; with newton_cg_compat it raises
    the JAX package's refusal. The spawned world of
    test_torch_mesh_paths.py shards the samples over ranks."""
    import jax
    import torch.distributed as dist

    from salamander_tpu.parallel import make_mesh as jax_make_mesh

    model_t, mdata = build(port, port, {"device": "cpu"})
    np.random.seed(0)
    plain = model_t.fit(mdata).history["objective_function"]
    model_t, mdata = build(port, port, {"device": "cpu"})
    compat, compat_data = build(port, port, {"device": "cpu",
                                             "newton_cg_compat": True})
    try:
        mesh = port.make_mesh(device="cpu")
        np.random.seed(0)
        model_t.fit(mdata, mesh=mesh)
        with pytest.raises(ValueError, match="newton_cg_compat"):
            compat.fit(compat_data, mesh=mesh)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(model_t.history["objective_function"],
                                  plain)
    model_j, mdata_j = build(jax_models, jax_containers, {})
    np.random.seed(0)
    model_j.fit(mdata_j, mesh=jax_make_mesh(jax.devices()[:4],
                                            sample_ways=4))
    assert model_t.history["n_iterations"] == model_j.history["n_iterations"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=RTOL)
