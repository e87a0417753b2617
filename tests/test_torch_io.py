"""Checkpoints of salamander_tpu_torch (io.save_model / load_model,
save_extraction / load_extraction) and its profiling helpers, mirroring
the checkpoint, extraction and profiling cases of
tests/test_io_multistart.py for every family (KLNMF with loss weights,
MvNMF, CorrNMFDet, ARDNMF, MultimodalCorrNMF), on PCAWG sub-catalogs on
the CPU.

The archive format is shared with the JAX package (format version 1), so
checkpoints cross packages in both directions: a model saved by one loads
in the other with every array, name and history entry exactly equal (the
loaded model's payload equals the saved one's, key for key). A port model
loaded from a JAX checkpoint continues fit(warm_start=True) in float64 to
the JAX package's continuation: equal iteration counts, the objective
trace at rtol 1e-8, the parameters at rtol 1e-8 (those of the CorrNMF
families, which come out of Newton solves stopped at a tolerance, at rtol
1e-5 and atol 1e-6, as test_torch_corrnmf_model.py holds the signatures)."""

import json
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import salamander_tpu as jax_sal
import salamander_tpu_torch as port
from salamander_tpu import io as jax_io
from salamander_tpu_torch import io, profiling

torch.set_num_threads(1)

N_SAMPLES = 40
RTOL = 1e-8
FAMILIES = ["klnmf", "mvnmf", "corrnmf", "ardnmf", "mmcorrnmf"]
HYPER = {
    "klnmf": ("KLNMF", dict(n_signatures=3)),
    "mvnmf": ("MvNMF", dict(n_signatures=2, lam=0.5, delta=2.0)),
    "corrnmf": ("CorrNMFDet", dict(n_signatures=2, dim_embeddings=2)),
    "ardnmf": ("ARDNMF", dict(n_signatures=4)),
    "mmcorrnmf": ("MultimodalCorrNMF", dict(ns_signatures=[2, 2],
                                            dim_embeddings=2)),
}
FIT_KWARGS = {"klnmf": dict(fitting_kwargs={"weights_kl": 2.0,
                                            "weights_lhalf": 0.1})}


@pytest.fixture(scope="module")
def counts():
    return port.datasets.load_pcawg_sbs().iloc[:N_SAMPLES]


@pytest.fixture(scope="module")
def counts2():
    return port.datasets.load_pcawg_indel().iloc[:N_SAMPLES]


def container(package, family, counts, counts2):
    if family == "mmcorrnmf":
        return package.MuData({"a": package.AnnData(counts.copy()),
                               "b": package.AnnData(counts2.copy())})
    return package.AnnData(counts.copy())


def fitted(package, family, counts, counts2, iterations=20, **extra):
    """A short fit of `family` in `package` (float64), from a fixed
    global numpy seed (the CorrNMF inits draw from it)."""
    name, hyper = HYPER[family]
    model = getattr(package.models, name)(
        **hyper, min_iterations=iterations, max_iterations=iterations,
        dtype="float64", **extra)
    np.random.seed(0)
    model.fit(container(package, family, counts, counts2),
              **FIT_KWARGS.get(family, {}))
    return model


def roundtrip(model, tmp_path):
    path = str(tmp_path / "model.npz")
    io.save_model(model, path)
    return io.load_model(path, device="cpu")


def assert_same_payload(payload, expected):
    """Two save_model payloads hold the same keys, meta and arrays."""
    assert sorted(payload) == sorted(expected)
    assert json.loads(str(payload["meta"])) == \
        json.loads(str(expected["meta"]))
    for key in expected:
        if key == "meta":
            continue
        assert payload[key].dtype == expected[key].dtype, key
        np.testing.assert_array_equal(payload[key], expected[key],
                                      err_msg=key)


# ---------------------------------------------------------------------- #
# checkpointing (the port alone)
# ---------------------------------------------------------------------- #

def test_checkpoint_klnmf(counts, tmp_path):
    model = port.KLNMF(n_signatures=3, min_iterations=20, max_iterations=20,
                       device="cpu")
    model.fit(port.AnnData(counts), init_kwargs={"seed": 1})
    loaded = roundtrip(model, tmp_path)
    assert isinstance(loaded, port.KLNMF)
    assert loaded.device.type == "cpu"
    assert np.array_equal(loaded.asignatures.X, model.asignatures.X)
    assert np.array_equal(
        loaded.adata.obsm["exposures"], model.adata.obsm["exposures"]
    )
    assert loaded.history["objective_function"] == [
        float(v) for v in model.history["objective_function"]]
    assert list(loaded.signature_names) == list(model.signature_names)
    # the restored model keeps working: objective + more fitting
    assert np.isclose(loaded.objective_function(), model.objective_function())
    loaded.fit(loaded.adata, warm_start=True)
    assert loaded.history["n_iterations"] == 20


def test_checkpoint_mvnmf(counts, tmp_path):
    model = port.MvNMF(n_signatures=2, lam=0.5, delta=2.0,
                       min_iterations=10, max_iterations=10, device="cpu")
    model.fit(port.AnnData(counts))
    loaded = roundtrip(model, tmp_path)
    assert loaded.lam == 0.5 and loaded.delta == 2.0
    assert np.isclose(loaded._gamma, model._gamma)
    assert np.array_equal(loaded.asignatures.X, model.asignatures.X)


def test_checkpoint_corrnmf(counts, tmp_path):
    np.random.seed(0)
    model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                            min_iterations=10, max_iterations=10,
                            device="cpu")
    model.fit(port.AnnData(counts))
    loaded = roundtrip(model, tmp_path)
    assert np.isclose(loaded.variance, model.variance)
    assert np.array_equal(
        loaded.adata.obsm["embeddings"], model.adata.obsm["embeddings"]
    )
    assert np.array_equal(
        np.asarray(loaded.asignatures.obs["scalings"]),
        np.asarray(model.asignatures.obs["scalings"]),
    )
    assert np.isclose(loaded.objective_function(), model.objective_function())


def test_checkpoint_ardnmf(counts, tmp_path):
    model = port.ARDNMF(n_signatures=4, min_iterations=20,
                        max_iterations=20, device="cpu")
    model.fit(port.AnnData(counts))
    loaded = roundtrip(model, tmp_path)
    assert loaded.b_resolved_ == model.b_resolved_
    pd.testing.assert_series_equal(loaded.relevance, model.relevance)
    assert loaded.n_active_signatures == model.n_active_signatures
    assert np.isclose(loaded.objective_function(), model.objective_function())


def test_checkpoint_multimodal(counts, counts2, tmp_path):
    mdata = port.MuData({"a": port.AnnData(counts.copy()),
                         "b": port.AnnData(counts2.copy())})
    np.random.seed(1)
    model = port.MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2,
                                   min_iterations=5, max_iterations=5,
                                   device="cpu")
    model.fit(mdata)
    loaded = roundtrip(model, tmp_path)
    assert loaded.mod_names == model.mod_names
    for name in model.mod_names:
        assert np.array_equal(
            loaded.asignatures[name].X, model.asignatures[name].X
        )
    assert np.array_equal(
        loaded.mdata.obsm["embeddings"], model.mdata.obsm["embeddings"]
    )
    assert np.isclose(loaded.objective_function(), model.objective_function())


def test_extraction_roundtrip(counts, tmp_path):
    """save_extraction/load_extraction round-trip every ExtractionResult
    field exactly, including the embedded fitted model."""
    result = port.extract_signatures(
        counts, ranks=[2, 3], n_bootstraps=4, seed=0,
        min_iterations=50, max_iterations=500, dtype=np.float64,
        device="cpu",
    )
    path = str(tmp_path / "extraction.npz")
    port.save_extraction(result, path)
    loaded = port.load_extraction(path, device="cpu")

    pd.testing.assert_frame_equal(loaded.table, result.table)
    assert loaded.suggested_rank == result.suggested_rank
    assert loaded.layout == result.layout
    for k in (2, 3):
        pd.testing.assert_frame_equal(loaded.consensus[k], result.consensus[k])
        pd.testing.assert_frame_equal(loaded.exposures[k], result.exposures[k])
        for field in ("silhouettes", "matched", "replicate_losses",
                      "replicate_iterations"):
            np.testing.assert_array_equal(getattr(loaded, field)[k],
                                          getattr(result, field)[k])
    if result.suggested_rank is not None:
        assert type(loaded.model).__name__ == type(result.model).__name__
        assert_same_payload(io._model_payload(loaded.model),
                            io._model_payload(result.model))
    # fit_final=False round-trips model=None
    result_nofit = port.extract_signatures(
        counts, ranks=[2], n_bootstraps=2, seed=0, fit_final=False,
        min_iterations=50, max_iterations=200, dtype=np.float64,
        device="cpu",
    )
    path2 = str(tmp_path / "extraction2.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # single-rank silhouette warning
        port.save_extraction(result_nofit, path2)
        loaded2 = port.load_extraction(path2, device="cpu")
    assert loaded2.model is None
    io.save_model(result.model, str(tmp_path / "plain_model.npz"))
    with pytest.raises(ValueError, match="not a save_extraction"):
        port.load_extraction(str(tmp_path / "plain_model.npz"))


def test_checkpoint_rejects_unknown(tmp_path):
    with pytest.raises(TypeError):
        io.save_model(object(), str(tmp_path / "x.npz"))


def test_checkpoint_preserves_klnmf_weights(counts, tmp_path):
    """Loss weights are model state: the restored objective must match."""
    model = port.KLNMF(n_signatures=2, min_iterations=10, max_iterations=10,
                       device="cpu")
    model.fit(
        port.AnnData(counts),
        fitting_kwargs={"weights_kl": 2.0, "weights_lhalf": 0.1},
    )
    loaded = roundtrip(model, tmp_path)
    assert loaded.weights_kl is not None
    assert loaded.weights_lhalf is not None
    assert np.isclose(loaded.objective_function(), model.objective_function())


def test_npz_roundtrip_with_string_obs(counts, tmp_path):
    """plot_embeddings adds string obs columns; npz round-trip must survive."""
    adata = port.AnnData(counts)
    adata.obs["color_embeddings"] = ["black"] * adata.n_obs
    path = str(tmp_path / "strings.npz")
    adata.write_npz(path)
    loaded = port.AnnData.read_npz(path)
    assert list(loaded.obs["color_embeddings"]) == ["black"] * adata.n_obs


def test_load_takes_the_card_unless_told(counts, tmp_path, monkeypatch):
    """The device is where a model runs, not what it is: it is no key of
    the archive, and load_model's device=None means the card, which
    raises without one."""
    model = port.KLNMF(n_signatures=2, min_iterations=5, max_iterations=5,
                       device="cpu")
    model.fit(port.AnnData(counts))
    path = str(tmp_path / "model.npz")
    io.save_model(model, path)
    with np.load(path) as archive:
        meta = json.loads(str(archive["meta"]))
    assert "device" not in meta["hyperparameters"]
    assert meta["format_version"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="pass device='cpu'"):
        io.load_model(path)
    assert io.load_model(path, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------- #
# across packages
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("family", FAMILIES)
def test_jax_checkpoint_loads_in_the_port(family, counts, counts2,
                                          tmp_path):
    jax_model = fitted(jax_sal, family, counts, counts2)
    path = str(tmp_path / "jax.npz")
    jax_io.save_model(jax_model, path)
    model = io.load_model(path, device="cpu")
    assert type(model).__name__ == type(jax_model).__name__
    assert model.device.type == "cpu" and model.dtype == "float64"
    assert_same_payload(io._model_payload(model),
                        jax_io._model_payload(jax_model))
    assert model.history == {
        key: (np.asarray(value).tolist() if np.ndim(value)
              else np.asarray(value).item())
        for key, value in jax_model.history.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_port_checkpoint_loads_in_jax(family, counts, counts2, tmp_path):
    model = fitted(port, family, counts, counts2, device="cpu")
    path = str(tmp_path / "port.npz")
    io.save_model(model, path)
    jax_model = jax_io.load_model(path)
    assert type(jax_model).__name__ == type(model).__name__
    assert_same_payload(jax_io._model_payload(jax_model),
                        io._model_payload(model))


@pytest.mark.parametrize("family", FAMILIES)
def test_warm_start_from_a_jax_checkpoint_matches_jax(family, counts,
                                                      counts2, tmp_path):
    jax_model = fitted(jax_sal, family, counts, counts2)
    path = str(tmp_path / "jax.npz")
    jax_io.save_model(jax_model, path)
    model = io.load_model(path, device="cpu")
    jax_model = jax_io.load_model(path)
    for m in (model, jax_model):
        m.min_iterations, m.max_iterations, m.tol = 30, 400, 1e-6
        data = m.mdata if family == "mmcorrnmf" else m.adata
        m.fit(data, warm_start=True)
    assert model.history["n_iterations"] == jax_model.history["n_iterations"]
    np.testing.assert_allclose(model.history["objective_function"],
                               jax_model.history["objective_function"],
                               rtol=RTOL)
    # the histories are compared above (the port's multimodal fit also
    # records tol_effective)
    payload, expected = (
        {key: value for key, value in payload_of(m).items()
         if key != "meta" and not key.startswith("history/")}
        for payload_of, m in ((io._model_payload, model),
                              (jax_io._model_payload, jax_model)))
    assert sorted(payload) == sorted(expected)
    tolerance = (dict(rtol=1e-5, atol=1e-6)
                 if family in ("corrnmf", "mmcorrnmf") else dict(rtol=RTOL))
    for key, value in expected.items():
        if value.dtype.kind == "f":
            np.testing.assert_allclose(payload[key], value, err_msg=key,
                                       **tolerance)
        else:
            np.testing.assert_array_equal(payload[key], value, err_msg=key)


def test_extraction_archives_cross_packages(counts, tmp_path):
    """An extraction saved by either package loads in the other with every
    table, frame and array equal, and the embedded model's payload
    equal."""
    kwargs = dict(ranks=[2, 3], n_bootstraps=3, seed=0, min_iterations=30,
                  max_iterations=200, dtype=np.float64)
    results = {
        "port": port.extract_signatures(counts, device="cpu", **kwargs),
        "jax": jax_sal.extract_signatures(counts, **kwargs),
    }
    save = {"port": io.save_extraction, "jax": jax_io.save_extraction}
    load = {"port": lambda path: io.load_extraction(path, device="cpu"),
            "jax": jax_io.load_extraction}
    payload = {"port": io._model_payload, "jax": jax_io._model_payload}
    for source, target in (("jax", "port"), ("port", "jax")):
        result = results[source]
        path = str(tmp_path / f"{source}.npz")
        save[source](result, path)
        loaded = load[target](path)
        pd.testing.assert_frame_equal(loaded.table, result.table,
                                      check_exact=True)
        assert loaded.suggested_rank == result.suggested_rank
        for k in (2, 3):
            pd.testing.assert_frame_equal(loaded.consensus[k],
                                          result.consensus[k],
                                          check_exact=True)
            pd.testing.assert_frame_equal(loaded.exposures[k],
                                          result.exposures[k],
                                          check_exact=True)
            for field in ("silhouettes", "matched", "replicate_losses",
                          "replicate_iterations"):
                np.testing.assert_array_equal(getattr(loaded, field)[k],
                                              getattr(result, field)[k])
        assert (loaded.model is None) == (result.model is None)
        if result.model is not None:
            assert_same_payload(payload[target](loaded.model),
                                payload[source](result.model))


# ---------------------------------------------------------------------- #
# profiling
# ---------------------------------------------------------------------- #

def test_profiling_timings(counts):
    model = port.KLNMF(n_signatures=2, min_iterations=5, max_iterations=5,
                       device="cpu")
    model, timings = profiling.timed_fit(model, port.AnnData(counts))
    assert "fit" in timings.phases
    assert timings.phases["fit"] > 0
    assert timings.counts["fit"] == 1
    assert "fit" in timings.report()


def test_phase_synchronizes_the_card_and_raises_its_errors(monkeypatch):
    """A phase on a CUDA device ends with torch.cuda.synchronize on it;
    a failed synchronization is raised, not swallowed (the JAX package's
    _block_on_device swallows every exception)."""
    seen = []

    def failing_sync(device=None):
        seen.append(device)
        raise RuntimeError("device-side assert")

    monkeypatch.setattr(torch.cuda, "synchronize", failing_sync)
    timings = profiling.Timings()
    with pytest.raises(RuntimeError, match="device-side assert"):
        with profiling.phase(timings, "work", device="cuda:0"):
            pass
    assert seen == [torch.device("cuda:0")]
    assert timings.counts == {}  # a failed phase records no time
    # the CPU has nothing to wait for
    with profiling.phase(timings, "cpu work", device="cpu"):
        pass
    assert len(seen) == 1 and timings.counts["cpu work"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as profiler:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = list((tmp_path / "trace").glob("*.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(event.get("name", "")) for event in events)
    assert len(profiler.key_averages()) > 0
