"""The port's spans and counters (salamander_tpu_torch/profiling.py) on the
paths of its public entries, at tiny sizes on the CPU.

Each entry runs once with nothing recording and once inside
``profiling.recording()``: off, the record gains nothing and no profiler
range is opened; on, the spans of one call share its id and nest
inside their parents, the outputs are bit-equal to the run with recording
off, and the engine's and the plain ops' host syncs count the same. A
fixed-window fit steps no frozen lane; a torch.profiler run holds every
span of the record as a ``salamander.*`` range, nested the same way; the
record keeps the last RING calls."""

import functools

import numpy as np
import pandas as pd
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu_torch import extraction, profiling
from salamander_tpu_torch.engine import FitConfig

torch.set_num_threads(1)

V, D, K_TRUE = 16, 40, 3
# lanes converge apart, from 210 to 400 iterations
CONFIG = FitConfig(min_iterations=20, max_iterations=400, conv_test_freq=10,
                   tol=1e-4)
COUNTERS = ("engine.host_syncs", "ops.host_syncs", "engine.lane_steps")


@functools.lru_cache(maxsize=None)
def planted():
    """Poisson counts of K_TRUE well-separated signatures, samples x
    features."""
    rng = np.random.default_rng(11)
    W = rng.dirichlet(np.full(V, 0.4), size=K_TRUE)
    H = rng.gamma(2.0, 50.0, size=(D, K_TRUE))
    X = rng.poisson(H @ W).astype(float) + 1.0
    return pd.DataFrame(X, index=[f"s{i}" for i in range(D)],
                        columns=[f"v{j}" for j in range(V)])


def catalog_case():
    """A block catalog of six signatures and samples of two each."""
    rng = np.random.default_rng(5)
    n_catalog, n_samples = 6, 10
    W = np.full((V, n_catalog), 0.01)
    for k in range(n_catalog):
        W[k * 2:(k + 1) * 2, k] += 1.0
    W /= W.sum(axis=0, keepdims=True)
    H = np.zeros((n_catalog, n_samples))
    for d in range(n_samples):
        active = rng.choice(n_catalog, 2, replace=False)
        H[active, d] = 500 + 500 * rng.random(2)
    X = rng.poisson(W @ H).astype(float) + 1e-6
    features = [f"v{j}" for j in range(V)]
    data = pd.DataFrame(X.T, index=[f"s{d}" for d in range(n_samples)],
                        columns=features)
    catalog = pd.DataFrame(W.T, index=[f"Sig{k}" for k in range(n_catalog)],
                           columns=features)
    return data, catalog


def cohort() -> np.ndarray:
    """planted() in kernel orientation, features x samples."""
    return np.array(planted().to_numpy().T)


def restarts(compact: bool):
    result = port.fit_klnmf_restarts(
        cohort(), 3, 12, seed=5, config=CONFIG,
        dtype=torch.float64, device="cpu", compact=compact,
        compact_min_bucket=2)
    return {"W": result.W.numpy(), "H": result.H.numpy(),
            "losses": result.losses, "n_iterations": result.n_iterations}


def extract(layout: str, monkeypatch):
    if layout == "grouped":
        monkeypatch.setattr(extraction, "_choose_layout",
                            lambda *args: "grouped")
    result = port.extract_signatures(
        planted(), ranks=[2, 3], n_bootstraps=4, seed=3, min_stability=0.0,
        min_iterations=20, max_iterations=300, compact=True, device="cpu")
    assert result.layout == layout and result.suggested_rank == 3
    out = {"exposures": result.model.exposures.to_numpy(),
           "signatures": result.model.signatures.to_numpy()}
    for k in (2, 3):
        out.update({f"losses{k}": result.replicate_losses[k],
                    f"iterations{k}": result.replicate_iterations[k],
                    f"consensus{k}": result.consensus[k].to_numpy(),
                    f"refit{k}": result.exposures[k].to_numpy(),
                    f"silhouettes{k}": result.silhouettes[k]})
    return out


def assign():
    data, catalog = catalog_case()
    result = port.assign_signatures(data, catalog, rel_tol=0.05,
                                    device="cpu", dtype="float64")
    return {"exposures": result.exposures.to_numpy(),
            "active": result.active.to_numpy(),
            "kl_dense": result.kl_dense.to_numpy(),
            "kl_sparse": result.kl_sparse.to_numpy(),
            "n_rounds": np.asarray(result.meta["n_rounds"])}


RUNS = {
    "restarts": ("restarts.fit", lambda mp: restarts(False)),
    "restarts_compacting": ("restarts.fit", lambda mp: restarts(True)),
    "extraction_padded": ("extraction.extract",
                          lambda mp: extract("padded", mp)),
    "extraction_grouped": ("extraction.extract",
                           lambda mp: extract("grouped", mp)),
    "assign": ("assign.assign", lambda mp: assign()),
}


def counted(run, monkeypatch):
    """run's outputs and the change of the counters over it."""
    before = dict(profiling.counters)
    out = run(monkeypatch)
    return out, {name: profiling.counters.get(name, 0) - before.get(name, 0)
                 for name in set(profiling.counters) | set(before)}


def off_and_on(name, monkeypatch):
    """(outputs, counter changes) off, then on, and the call recorded."""
    root, run = RUNS[name]
    off = counted(run, monkeypatch)
    with profiling.recording():
        on = counted(run, monkeypatch)
    (call,) = profiling.calls(1)
    assert call["name"] == root
    return off, on, call


def by_name(call, name):
    return [span for span in call["spans"] if span[0] == name]


def check_nesting(call):
    spans = call["spans"]
    assert spans[0][3] is None
    assert {span[4] for span in spans} == {call["id"]}
    for index, (_, start, end, parent, _) in enumerate(spans):
        assert start <= end
        if index:
            assert parent is not None and parent < index
            assert spans[parent][1] <= start and end <= spans[parent][2]


# --------------------------------------------------------------------- #
# off: nothing recorded, nothing of torch.profiler called
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(RUNS))
def test_off_records_nothing_and_calls_no_profiler(name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler called while nothing records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    before = profiling.calls()
    out, changes = counted(RUNS[name][1], monkeypatch)
    assert profiling.calls() == before
    # the recording's own read of the lanes' iterations is not made
    assert changes.get("engine.lane_steps_live", 0) == 0
    assert changes.get("engine.host_syncs", 0) + changes.get(
        "ops.host_syncs", 0) > 0


def test_off_span_is_one_shared_object():
    assert not profiling.is_recording()
    assert profiling.span("a") is profiling.span("b")


# --------------------------------------------------------------------- #
# on: one call, nested spans, bit-equal outputs, the same host syncs
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(RUNS))
def test_recording_changes_no_output_and_no_host_sync(name, monkeypatch):
    (out_off, changes_off), (out_on, changes_on), call = off_and_on(
        name, monkeypatch)
    assert out_on.keys() == out_off.keys()
    for key in out_off:
        np.testing.assert_array_equal(out_on[key], out_off[key], err_msg=key)
    for counter in COUNTERS:
        assert changes_on.get(counter, 0) == changes_off.get(counter, 0), \
            counter
        assert call["counts"].get(counter, 0) == changes_on.get(counter, 0)
    check_nesting(call)


def test_restarts_spans(monkeypatch):
    _, (out, changes), call = off_and_on("restarts", monkeypatch)
    check_nesting(call)
    (init,) = by_name(call, "restarts.init")
    engine_spans = by_name(call, "engine.span")
    assert init[3] == 0 and engine_spans
    assert all(span[3] == 0 for span in engine_spans)
    assert init[2] <= engine_spans[0][1]
    # the segment's first two reads lie in the init, the rest between spans
    reads = by_name(call, "engine.host_read")
    assert [span[3] for span in reads[:2]] == [1, 1]
    assert call["counts"]["engine.host_syncs"] == len(reads)
    assert call["counts"]["engine.lane_steps_live"] == int(
        out["n_iterations"].sum())
    assert call["counts"]["engine.lane_steps"] >= int(
        out["n_iterations"].sum())


def test_compaction_reads_and_steps_fewer_lanes(monkeypatch):
    _, (out, _), call = off_and_on("restarts_compacting", monkeypatch)
    _, (plain, _), plain_call = off_and_on("restarts", monkeypatch)
    np.testing.assert_array_equal(out["n_iterations"],
                                  plain["n_iterations"])
    counts, plain_counts = call["counts"], plain_call["counts"]
    assert counts["engine.lane_steps_live"] == \
        plain_counts["engine.lane_steps_live"]
    assert counts["engine.lane_steps"] < plain_counts["engine.lane_steps"]
    assert counts["engine.host_syncs"] == len(by_name(call,
                                                      "engine.host_read"))


@pytest.mark.parametrize("layout", ["padded", "grouped"])
def test_extraction_spans(layout, monkeypatch):
    _, _, call = off_and_on(f"extraction_{layout}", monkeypatch)
    check_nesting(call)
    names = {span[0] for span in call["spans"]}
    for phase in ("resample", "consensus", "consensus_refit", "fit_final"):
        assert f"extraction.{phase}" in names
    assert len(by_name(call, "extraction.consensus")) == 2
    assert len(by_name(call, "extraction.consensus_refit")) == 2
    fits = {"padded": "extraction.discovery",
            "grouped": "extraction.rank_group"}
    assert len(by_name(call, fits[layout])) == (1 if layout == "padded"
                                                else 2)
    other = fits["grouped" if layout == "padded" else "padded"]
    assert not by_name(call, other)
    # every engine span lies in a discovery fit or in the final fit
    parents = {call["spans"][span[3]][0]
               for span in by_name(call, "engine.span")}
    assert parents == {fits[layout], "extraction.fit_final"}
    # the consensus refits read on the host, as the final fit does
    assert call["counts"]["ops.host_syncs"] > 0


def test_assign_spans(monkeypatch):
    _, (out, changes), call = off_and_on("assign", monkeypatch)
    check_nesting(call)
    refits = by_name(call, "assign.refit")
    rounds = by_name(call, "assign.round")
    assert len(refits) == 2 and len(rounds) == int(out["n_rounds"]) > 0
    assert all(span[3] == 0 for span in refits + rounds)
    assert refits[0][2] <= rounds[0][1] and rounds[-1][2] <= refits[1][1]
    assert "engine.host_syncs" not in call["counts"]
    # a read each block of the two refits, one before each round and one
    # closing each round
    assert call["counts"]["ops.host_syncs"] > 1 + len(rounds)


def test_fixed_window_steps_no_frozen_lane():
    config = FitConfig(min_iterations=55, max_iterations=55,
                       conv_test_freq=10, tol=1e-7)
    with profiling.recording():
        result = port.fit_klnmf_restarts(
            cohort(), 3, 6, seed=1, config=config,
            dtype=torch.float64, device="cpu", compact=False)
    counts = profiling.calls(1)[0]["counts"]
    assert counts["engine.lane_steps_live"] == counts["engine.lane_steps"] \
        == 6 * 55 == int(result.n_iterations.sum())


# --------------------------------------------------------------------- #
# the profiler's trace holds the record
# --------------------------------------------------------------------- #


def test_profiler_trace_holds_every_span_nested_alike():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.is_recording()
        assign()
        restarts(True)
    assert not profiling.is_recording()
    found = [event for event in prof.profiler.kineto_results.events()
             if event.name().startswith(profiling.PREFIX)]
    # host ranges, not user annotations: nothing is drawn on a device's
    # timeline that a reading of device time would count as work
    assert not any(event.is_user_annotation() for event in found)
    events = [(event.name(), event.start_ns(),
               event.start_ns() + event.duration_ns()) for event in found]
    calls = profiling.calls(2)
    assert [call["name"] for call in calls] == ["assign.assign",
                                                "restarts.fit"]
    spans = [span for call in calls for span in call["spans"]]
    assert len(events) == len(spans)
    matched = {}
    for name in {span[0] for span in spans}:
        mine = sorted((span[1], span[2], (span[4], i))
                      for call in calls
                      for i, span in enumerate(call["spans"])
                      if span[0] == name)
        theirs = sorted((start, end) for event_name, start, end in events
                        if event_name == profiling.PREFIX + name)
        assert len(mine) == len(theirs), name
        for (start, end, key), (t_start, t_end) in zip(mine, theirs):
            # the record's clock is the trace's; its span lies in the range
            assert t_start <= start <= end <= t_end, name
            matched[key] = (t_start, t_end)
    for call in calls:
        for i, span in enumerate(call["spans"]):
            if span[3] is not None:
                outer = matched[(call["id"], span[3])]
                inner = matched[(call["id"], i)]
                assert outer[0] <= inner[0] and inner[1] <= outer[1]


# --------------------------------------------------------------------- #
# the recorder itself
# --------------------------------------------------------------------- #


@profiling.entry("test.call")
def _entry(i, inner=None):
    with profiling.span("test.inner"):
        profiling.count("test.n", i)
        if inner is not None:
            _entry(inner)


def test_ring_keeps_the_last_calls():
    with profiling.recording():
        for i in range(profiling.RING + 6):
            _entry(i)
    kept = profiling.calls(profiling.RING + 10)
    assert len(kept) == profiling.RING == 64
    assert [call["counts"]["test.n"] for call in kept] == list(
        range(6, profiling.RING + 6))
    assert [call["id"] for call in kept] == sorted(call["id"]
                                                   for call in kept)
    assert len(profiling.calls(3)) == 3 and profiling.calls(0) == []


def test_nested_entry_is_a_span_of_the_open_call():
    with profiling.recording():
        _entry(1, inner=2)
    (call,) = profiling.calls(1)
    assert [span[0] for span in call["spans"]] == [
        "test.call", "test.inner", "test.call", "test.inner"]
    assert [span[3] for span in call["spans"]] == [None, 0, 1, 2]
    assert call["counts"] == {"test.n": 3}


def test_counts_attributed_only_while_recording():
    before = profiling.counters.get("test.n", 0)
    _entry(5)
    assert profiling.counters["test.n"] == before + 5
    with profiling.recording():
        _entry(7)
    assert profiling.calls(1)[0]["counts"] == {"test.n": 7}
    assert profiling.counters["test.n"] == before + 12


@profiling.entry("test.prelude")
def _prelude(end_early: bool):
    profiling.prelude("test.init")
    profiling.prelude("test.second")  # one prelude at a time
    with profiling.span("test.read"):
        pass
    if end_early:
        profiling.end_prelude()
    with profiling.span("test.body"):
        profiling.end_prelude()  # not the innermost span: stays open


@pytest.mark.parametrize("end_early", [True, False])
def test_prelude_lasts_until_ended_or_its_parent_ends(end_early):
    with profiling.recording():
        _prelude(end_early)
    (call,) = profiling.calls(1)
    check_nesting(call)
    names = [span[0] for span in call["spans"]]
    assert names == ["test.prelude", "test.init", "test.read", "test.body"]
    init, read, body = call["spans"][1:]
    assert init[3] == 0 and read[3] == 1
    assert body[3] == (0 if end_early else 1)
    if end_early:
        assert init[2] <= body[1]
    profiling.end_prelude()  # outside a call: nothing
    profiling.prelude("test.outside")
    assert profiling.calls(1)[0]["id"] == call["id"]
