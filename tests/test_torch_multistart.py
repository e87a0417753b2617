"""salamander_tpu_torch.parallel.multistart and .compaction: fit_best_of
against the JAX package's on the same host (numpy) inits at float64
(losses at rtol 1e-8, equal iteration counts), and within the port:
compacted against monolithic per lane identical, the device init
deterministic per base_seed, a killed-then-resumed checkpointed run equal
to an uninterrupted one, and the four reference defects of ROADMAP
Queue 3 in this code, each with the port's choice. The same for
MultimodalCorrNMF, whose parameters are a nested dict and whose data is a
MuData (3 modalities, V = 12/9/6, D = 20, ns_signatures [3, 2, 2], m =
2)."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import containers as jax_containers
from salamander_tpu import datasets as jax_datasets
from salamander_tpu import models as jax_models
from salamander_tpu.parallel.multistart import fit_best_of as jax_fit_best_of
from salamander_tpu_torch.engine import FitConfig
from salamander_tpu_torch.ops import mvnmf as port_mvnmf
from salamander_tpu_torch.parallel import compaction, multistart

torch.set_num_threads(1)

RTOL = 1e-8
N_SAMPLES = 32
R = 8
HYPER = dict(n_signatures=3, init_method="random", min_iterations=20,
             max_iterations=300, tol=1e-4)


@pytest.fixture(scope="module")
def frame():
    return jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]


def port_model(family, **overrides):
    return getattr(port, family)(device="cpu", **dict(HYPER, **overrides))


def best_of(family, frame, **kwargs):
    model = port_model(family, **kwargs.pop("hyper", {}))
    summary = port.fit_best_of(model, port.AnnData(frame.copy()), R,
                               base_seed=kwargs.pop("base_seed", 7),
                               **kwargs)
    return model, summary


def assert_same_lanes(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.n_iterations, b.n_iterations)
    np.testing.assert_array_equal(a.n_evals, b.n_evals)
    np.testing.assert_array_equal(a.history, b.history)
    np.testing.assert_array_equal(a.signatures, b.signatures)
    assert a.best_index == b.best_index


@pytest.mark.parametrize("family", ["KLNMF", "MvNMF"])
def test_host_init_matches_jax(frame, family):
    """batched_init=False: the host numpy inits are bit-equal across the
    packages, so the fits agree lane by lane."""
    model_j = getattr(jax_models, family)(**HYPER)
    summary_j = jax_fit_best_of(model_j, jax_containers.AnnData(frame.copy()),
                                R, base_seed=7, batched_init=False)
    model_t, summary_t = best_of(family, frame, batched_init=False)
    assert len(set(summary_t.n_iterations)) > 2  # lanes stop apart
    np.testing.assert_array_equal(summary_t.n_iterations,
                                  summary_j.n_iterations)
    np.testing.assert_allclose(summary_t.losses, summary_j.losses,
                               rtol=RTOL)
    assert summary_t.best_index == summary_j.best_index
    np.testing.assert_allclose(summary_t.signatures, summary_j.signatures,
                               rtol=1e-6)
    np.testing.assert_allclose(model_t.asignatures.X, model_j.asignatures.X,
                               rtol=1e-6)
    assert model_t.history["n_iterations"] == \
        model_j.history["n_iterations"]
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=RTOL)
    assert model_t.history["multistart_losses"] == \
        summary_t.losses.tolist()
    assert model_t.history["tol_effective"] == \
        model_j.history["tol_effective"]
    if family == "MvNMF":
        assert model_t._gamma == model_j._gamma


@pytest.mark.parametrize("family", ["KLNMF", "MvNMF"])
@pytest.mark.parametrize("batched_init", ["auto", False])
def test_compacted_equals_monolithic(frame, family, batched_init):
    _, mono = best_of(family, frame, batched_init=batched_init,
                      compact=False)
    _, packed = best_of(family, frame, batched_init=batched_init,
                        compact=True, compact_min_bucket=2)
    assert len(set(mono.n_iterations)) > 2
    assert_same_lanes(mono, packed)


@pytest.mark.parametrize("family", ["KLNMF", "MvNMF"])
def test_device_init_is_deterministic_per_base_seed(frame, family):
    _, first = best_of(family, frame, base_seed=3)
    _, again = best_of(family, frame, base_seed=3)
    _, other = best_of(family, frame, base_seed=4)
    assert_same_lanes(first, again)
    assert not np.array_equal(first.losses, other.losses)
    assert len(set(first.losses.tolist())) == R  # lanes differ
    model = port_model(family)
    model._setup_adata(port.AnnData(frame.copy()))
    model._initialize(init_kwargs={"seed": 0})
    model._setup_fitting_parameters()
    _, data = model._device_state()
    params0 = multistart._device_init_batch(model, data, R, 3)
    assert params0["W"].shape == (R, 96, 3)
    torch.testing.assert_close(params0["W"].sum(1),
                               torch.ones(R, 3, dtype=torch.float64))
    if family == "MvNMF":
        assert torch.equal(params0["gamma"],
                           torch.ones(R, dtype=torch.float64))


def test_unported_family_and_mesh_raise(frame):
    """Every family of the JAX package is batched, MultimodalCorrNMF
    included; a class that fit_best_of does not know still raises."""
    assert set(multistart.PORTED_FAMILIES) == {
        "KLNMF", "MvNMF", "ARDNMF", "CorrNMFDet", "MultimodalCorrNMF"}
    model = port.MultimodalCorrNMF(device="cpu", **MM_HYPER)
    summary = port.fit_best_of(model, mm_mdata(port), 2, base_seed=1)
    assert model._is_fitted and summary.losses.shape == (2,)
    assert model.objective_function() == pytest.approx(
        summary.losses[summary.best_index], rel=1e-10)

    class SomeOtherNMF(port.KLNMF):
        pass

    with pytest.raises(NotImplementedError, match="SomeOtherNMF"):
        port.fit_best_of(SomeOtherNMF(device="cpu"),
                         port.AnnData(frame.copy()), 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        port.fit_best_of(model, mm_mdata(port), 2, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        port.fit_best_of(port_model("KLNMF"), port.AnnData(frame.copy()), 2,
                         mesh=object())
    with pytest.raises(ValueError, match="batched_init=True"):
        port.fit_best_of(port_model("KLNMF", init_method="nndsvd"),
                         port.AnnData(frame.copy()), 2, batched_init=True)


# ------------------------------------------------------------------ #
# MultimodalCorrNMF: a nested parameter tree over a MuData
# ------------------------------------------------------------------ #

MM_FEATURES = {"sbs": 12, "indel": 9, "sv": 6}
MM_HYPER = dict(ns_signatures=[3, 2, 2], dim_embeddings=2,
                init_method="random", min_iterations=10, max_iterations=150,
                tol=3e-3)


def mm_mdata(containers, n_samples=20):
    rng = np.random.default_rng(0)
    load = rng.gamma(2.0, 1.0, (n_samples, 3))
    return containers.MuData({
        name: containers.AnnData(rng.poisson(
            60.0 * load @ rng.dirichlet(np.ones(n_features), 3)
        ).astype(float))
        for name, n_features in MM_FEATURES.items()
    })


def mm_best_of(n_restarts=R, **kwargs):
    model = port.MultimodalCorrNMF(device="cpu", **MM_HYPER)
    summary = port.fit_best_of(model, mm_mdata(port), n_restarts,
                               base_seed=kwargs.pop("base_seed", 7),
                               **kwargs)
    return model, summary


def assert_same_mm_lanes(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.n_iterations, b.n_iterations)
    np.testing.assert_array_equal(a.history, b.history)
    assert a.best_index == b.best_index
    for name in MM_FEATURES:
        np.testing.assert_array_equal(a.signatures[name], b.signatures[name])


def test_multimodal_host_init_matches_jax():
    """batched_init=False: the host inits are bit-equal across the
    packages (each restart reseeds the global numpy RNG), so the joint
    fits agree lane by lane."""
    model_j = jax_models.MultimodalCorrNMF(**MM_HYPER)
    summary_j = jax_fit_best_of(model_j, mm_mdata(jax_containers), R,
                                base_seed=7, batched_init=False)
    model_t, summary_t = mm_best_of(batched_init=False)
    assert len(set(summary_t.n_iterations)) > 1  # lanes stop apart
    np.testing.assert_array_equal(summary_t.n_iterations,
                                  summary_j.n_iterations)
    np.testing.assert_allclose(summary_t.losses, summary_j.losses,
                               rtol=RTOL)
    assert summary_t.best_index == summary_j.best_index
    for (name, n_features), k in zip(MM_FEATURES.items(), [3, 2, 2]):
        assert summary_t.signatures[name].shape == (R, n_features, k)
        np.testing.assert_allclose(summary_t.signatures[name],
                                   summary_j.signatures[name], rtol=1e-5)
        np.testing.assert_allclose(model_t.asignatures[name].X,
                                   model_j.asignatures[name].X, rtol=1e-5)
    np.testing.assert_allclose(model_t.history["objective_function"],
                               model_j.history["objective_function"],
                               rtol=RTOL)
    assert model_t.history["n_iterations"] == \
        model_j.history["n_iterations"]
    assert model_t.history["tol_effective"] == \
        model_j.history["tol_effective"]
    np.testing.assert_allclose(model_t.variance, model_j.variance, rtol=1e-6)


@pytest.mark.parametrize("batched_init", ["auto", False])
def test_multimodal_compacted_equals_monolithic(batched_init):
    """A frozen or compacted lane keeps EVERY leaf of the nested tree: a
    leaf missed by the freeze (a modality's exposures, say) would let the
    lane drift and the layouts disagree."""
    _, mono = mm_best_of(batched_init=batched_init, compact=False)
    _, packed = mm_best_of(batched_init=batched_init, compact=True,
                           compact_min_bucket=2)
    assert len(set(mono.n_iterations)) > 1
    assert_same_mm_lanes(mono, packed)


def test_multimodal_device_init_is_deterministic_per_base_seed():
    _, first = mm_best_of(base_seed=3)
    _, again = mm_best_of(base_seed=3)
    _, other = mm_best_of(base_seed=4)
    assert_same_mm_lanes(first, again)
    assert not np.array_equal(first.losses, other.losses)
    assert len(set(first.losses.tolist())) == R
    with pytest.raises(ValueError, match="batched_init=True"):
        port.fit_best_of(
            port.MultimodalCorrNMF(device="cpu",
                                   **dict(MM_HYPER, init_method="nndsvd")),
            mm_mdata(port), 2, batched_init=True)


def test_multimodal_checkpoint_resume_and_store_identity(tmp_path,
                                                         monkeypatch):
    import json

    _, baseline = mm_best_of(restart_chunk=3)
    _, first = mm_best_of(restart_chunk=3, checkpoint_dir=tmp_path)
    assert_same_mm_lanes(baseline, first)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["model"] == "MultimodalCorrNMF"
    assert meta["ns_signatures"] == [3, 2, 2] and meta["n_signatures"] is None
    assert meta["dim_embeddings"] == 2 and meta["dtype"] == "float64"
    with np.load(tmp_path / "restarts_0_3.npz") as archive:
        assert "p_mods/indel/exposures" in archive.files
        assert "p_sample_embeddings" in archive.files
    (tmp_path / "restarts_3_6.npz").unlink()  # killed mid-run
    runs = []
    real = multistart.lockstep_fit

    def counting(objective_fn, config, make_block_update, params0, data):
        runs.append(int(params0["variance"].shape[0]))
        return real(objective_fn, config, make_block_update, params0, data)

    monkeypatch.setattr(multistart, "lockstep_fit", counting)
    model, resumed = mm_best_of(restart_chunk=3, checkpoint_dir=tmp_path)
    assert runs == [3]
    assert_same_mm_lanes(baseline, resumed)
    assert model.history["n_iterations"] == \
        int(baseline.n_iterations[baseline.best_index])
    # another modality's counts, same shapes: a different run
    other = mm_mdata(port)
    other["sv"].X = other["sv"].X + 1.0
    with pytest.warns(UserWarning, match="different run"):
        port.fit_best_of(port.MultimodalCorrNMF(device="cpu", **MM_HYPER),
                         other, R, base_seed=7, restart_chunk=3,
                         checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="given_parameters"):
        port.fit_best_of(port.MultimodalCorrNMF(device="cpu", **MM_HYPER),
                         mm_mdata(port), 2,
                         given_parameters={"variance": 1.0},
                         checkpoint_dir=tmp_path)


def test_stores_of_the_flat_families_keep_their_entry_names(frame, tmp_path):
    """The tree helpers leave a flat family's store as it was: entries
    p_W, p_H (and p_gamma), so a checkpoint written before the nested
    trees still loads."""
    best_of("MvNMF", frame, restart_chunk=4, checkpoint_dir=tmp_path)
    with np.load(tmp_path / "restarts_0_4.npz") as archive:
        assert {"p_W", "p_H", "p_gamma", "losses", "history", "n_evals",
                "n_iterations", "initial_objective"} == set(archive.files)


def test_verbose_prints_one_line_per_segment(frame, capsys):
    best_of("KLNMF", frame, compact=True, compact_min_bucket=2, verbose=1)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if "lanes alive" in line]
    assert 2 <= len(lines) <= 3  # buckets 8, 4 and 2 lanes
    assert lines[0].endswith(f"/{R}")


def test_checkpoint_resume_equals_uninterrupted(frame, tmp_path,
                                                monkeypatch):
    _, baseline = best_of("MvNMF", frame, restart_chunk=3)
    _, first = best_of("MvNMF", frame, restart_chunk=3,
                       checkpoint_dir=tmp_path)
    assert_same_lanes(baseline, first)
    entries = sorted(path.name for path in tmp_path.glob("*.npz"))
    assert entries == ["restarts_0_3.npz", "restarts_3_6.npz",
                       "restarts_6_8.npz"]
    # a kill before the last chunk was written: only that chunk reruns
    (tmp_path / "restarts_3_6.npz").unlink()
    runs = []
    real = multistart.lockstep_fit

    def counting(objective_fn, config, make_block_update, params0, data):
        runs.append(int(params0["W"].shape[0]))
        return real(objective_fn, config, make_block_update, params0, data)

    monkeypatch.setattr(multistart, "lockstep_fit", counting)
    model, resumed = best_of("MvNMF", frame, restart_chunk=3,
                             checkpoint_dir=tmp_path)
    assert runs == [3]
    assert_same_lanes(baseline, resumed)
    assert model.history["n_iterations"] == \
        int(baseline.n_iterations[baseline.best_index])


def test_defect_a_checkpoint_identity_has_dtype_and_trial_batch(
        frame, tmp_path):
    """Reference defect (multistart.py:133): the JAX run identity leaves out
    the dtype and MvNMF's line-search trial batch, so a float32 rerun
    would load a float64 store. Fixed here: both are in the identity, and
    such a store is discarded."""
    best_of("MvNMF", frame, hyper={"dtype": "float64"},
            checkpoint_dir=tmp_path)
    with pytest.warns(UserWarning, match="different run"):
        _, rerun = best_of("MvNMF", frame, hyper={"dtype": "float32"},
                           checkpoint_dir=tmp_path)
    assert rerun.history.dtype == np.float64  # promoted objective
    model = port_model("MvNMF")
    model._line_search_trial_batch = 4
    with pytest.warns(UserWarning, match="different run"):
        port.fit_best_of(model, port.AnnData(frame.copy()), R, base_seed=7,
                         checkpoint_dir=tmp_path)


def test_defect_d_checkpoint_identity_has_ard_hyperparameters(frame,
                                                              tmp_path):
    """Reference defect (multistart.py:127-145): the JAX run identity
    records ARDNMF's prior but not a and b, so a rerun with another a (or
    b) would load the earlier run's chunks. Fixed here: a, the resolved b,
    the prior and dim_embeddings are in the identity, and such a store is
    discarded."""
    hyper = {"a": 3.0, "max_iterations": 60}
    best_of("ARDNMF", frame, hyper=hyper, checkpoint_dir=tmp_path)
    other_a = dict(hyper, a=4.0)
    with pytest.warns(UserWarning, match="different run"):
        _, rerun = best_of("ARDNMF", frame, hyper=other_a,
                           checkpoint_dir=tmp_path)
    _, fresh = best_of("ARDNMF", frame, hyper=other_a)
    assert_same_lanes(rerun, fresh)
    with pytest.warns(UserWarning, match="different run"):
        best_of("ARDNMF", frame, hyper=dict(other_a, b=5.0),
                checkpoint_dir=tmp_path)


def test_defect_b_checkpoint_rejects_given_parameters(frame, tmp_path):
    """Reference behaviour (multistart.py:443-452), matched knowingly:
    given values cannot be fingerprinted into the run identity, so
    checkpoint_dir with given_parameters raises the same ValueError as in
    the JAX package."""
    given = port.AnnData(frame.iloc[:1].copy() / frame.iloc[0].sum())
    given_j = jax_containers.AnnData(frame.iloc[:1].copy()
                                     / frame.iloc[0].sum())
    with pytest.raises(ValueError) as port_error:
        port.fit_best_of(port_model("KLNMF"), port.AnnData(frame.copy()), 2,
                         given_parameters={"asignatures": given},
                         checkpoint_dir=tmp_path)
    with pytest.raises(ValueError) as jax_error:
        jax_fit_best_of(jax_models.KLNMF(**HYPER),
                        jax_containers.AnnData(frame.copy()), 2,
                        given_parameters={"asignatures": given_j},
                        checkpoint_dir=tmp_path / "jax")
    assert str(port_error.value) == str(jax_error.value)


def test_defect_c_no_runner_cache_to_go_stale(frame, monkeypatch):
    """Reference defect (multistart.py:392): the JAX runner-cache key leaves
    out MvNMF's trial batch, so a second call with another trial batch
    reuses the first call's program. The port has no runner cache: every
    call builds its steps from the model, so a second call with another
    trial batch runs the batched search."""
    assert not hasattr(multistart, "_RUNNER_CACHE")
    calls = []
    real = port_mvnmf._batched_search

    def counting(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(port_mvnmf, "_batched_search", counting)
    hyper = {"max_iterations": 40}
    _, serial = best_of("MvNMF", frame, hyper=hyper)
    assert calls == []
    model = port_model("MvNMF", **hyper)
    model._line_search_trial_batch = 3
    port.fit_best_of(model, port.AnnData(frame.copy()), R, base_seed=7)
    assert calls and set(calls) == {3}


@pytest.mark.parametrize("n_restarts", [8, 7])
def test_fit_klnmf_restarts_compact_matches_plain(frame, n_restarts):
    X = frame.to_numpy().T
    config = FitConfig(min_iterations=20, max_iterations=305,
                       conv_test_freq=10, tol=1e-4)
    kwargs = dict(seed=2, config=config, dtype=torch.float64, device="cpu")
    plain = port.fit_klnmf_restarts(X, 3, n_restarts, compact=False,
                                    **kwargs)
    packed = port.fit_klnmf_restarts(X, 3, n_restarts, compact=True,
                                     compact_min_bucket=2, **kwargs)
    np.testing.assert_array_equal(plain.losses, packed.losses)
    np.testing.assert_array_equal(plain.n_iterations, packed.n_iterations)
    assert torch.equal(plain.W, packed.W) and torch.equal(plain.H, packed.H)
    assert 305 in plain.n_iterations  # a lane ran the remainder tail


def test_next_bucket_schedule_and_auto_policy():
    config = FitConfig(min_iterations=10, max_iterations=100)
    runner = compaction.CompactingRunner(config, None, None, min_bucket=4)
    schedule, bucket = [], 100
    while (bucket := runner._next_bucket(bucket)) is not None:
        schedule.append(bucket)
    assert schedule == [50, 25, 12, 6]
    fixed = FitConfig(min_iterations=100, max_iterations=100)
    resolve = compaction.resolve_compact
    assert resolve(None, config, None, 16, 8, "cuda")
    assert not resolve(None, config, None, 15, 8, "cuda")
    assert not resolve(None, fixed, None, 100, 8, "cuda")
    assert not resolve(None, config, None, 100, 8, "cpu")
    assert resolve(True, fixed, None, 2, 8, "cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        resolve(None, config, object(), 100, 8, "cuda")
