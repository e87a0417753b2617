"""The readers of the program's own record (portbench/program_record.py):
each on a hand-made record, None where the program keeps none, and every
one of a cell's in a tiny traced run of that cell on the CPU."""

import json

import pytest

from portbench import manifest, program_record, run

SEED = 2**31 + 4321
CELLS = ["pcawg_sbs-restarts100", "pcawg_sbs-extract",
         "pancancer_sbs_20k-extract", "pancancer_sbs_20k-assign"]
PREFIXES = ("capture_ms_per_fit", "fit_init_ms", "host_syncs_per_job",
            "frozen_lane_share", "consensus_share", "refit_share",
            "round_span_ms")
MS = 1_000_000  # ns


def span(name, start_ms, end_ms, parent, call):
    return (name, start_ms * MS, end_ms * MS, parent, call)


RECORD = [
    {"id": 7, "name": "restarts.fit",
     "spans": [span("restarts.fit", 0, 100, None, 7),
               span("restarts.init", 0, 12, 0, 7),
               span("engine.span", 12, 14, 0, 7),
               span("engine.capture", 14, 17, 4, 7)],
     "counts": {"engine.host_syncs": 5, "engine.lane_steps": 1000,
                "engine.lane_steps_live": 800}},
    {"id": 8, "name": "restarts.fit",
     "spans": [span("restarts.fit", 100, 200, None, 8),
               span("restarts.init", 100, 108, 0, 8),
               span("engine.capture", 110, 115, 0, 8),
               span("extraction.consensus", 150, 170, 0, 8),
               span("assign.refit", 120, 130, 0, 8),
               span("assign.round", 130, 134, 0, 8),
               span("assign.round", 134, 140, 0, 8)],
     "counts": {"engine.host_syncs": 3, "ops.host_syncs": 4,
                "engine.lane_steps": 1000, "engine.lane_steps_live": 700}},
]


@pytest.fixture
def record(monkeypatch):
    from salamander_tpu_torch import profiling

    monkeypatch.setattr(profiling, "calls", lambda n: RECORD[-n:])
    return {"traced": [{"untraced": {"wall_s": 0.25}},
                       {"untraced": {"wall_s": 0.15}}]}


def read(name, ctx):
    return manifest.reader(name).read(ctx)


def test_readers_on_a_hand_made_record(record):
    assert program_record.calls(record) == RECORD
    assert read("capture_ms_per_fit.restarts", record) == pytest.approx(4.0)
    assert read("fit_init_ms.restarts", record) == pytest.approx(10.0)
    assert read("host_syncs_per_job.assign", record) == pytest.approx(6.0)
    assert read("frozen_lane_share.pcawg_extract", record) == \
        pytest.approx(25.0)
    assert read("consensus_share.cohort_extract", record) == \
        pytest.approx(5.0)  # 20 ms of 0.4 s
    assert read("refit_share.assign", record) == pytest.approx(2.5)
    assert read("round_span_ms.assign", record) == pytest.approx(5.0)


def test_readers_take_only_the_traced_calls(record):
    record["traced"] = record["traced"][1:]
    assert program_record.calls(record) == RECORD[1:]
    assert read("fit_init_ms.restarts", record) == pytest.approx(8.0)
    assert read("host_syncs_per_job.assign", record) == pytest.approx(7.0)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_no_record_reads_none(prefix, monkeypatch):
    from salamander_tpu_torch import profiling

    ctx = {"traced": [{"untraced": {"wall_s": 1.0}}]}
    assert read(prefix, {"traced": None}) is None
    monkeypatch.delattr(profiling, "calls")
    assert read(prefix, ctx) is None
    monkeypatch.setattr(profiling, "calls", lambda n: [], raising=False)
    assert read(prefix, ctx) is None  # fewer calls than traced jobs


def new_metrics(cell):
    book = manifest.load()
    return [metric for metric in manifest.metrics(
        book, manifest.cell(book, cell), "per_layer")
        if metric["name"].split(".")[0] in PREFIXES]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_every_new_metric(tiny_root, cell):
    result = run.run_cell(cell, SEED, 0.5, True, device="cpu",
                          root=tiny_root)
    assert result["correct"] is True, result["check"]
    metrics = new_metrics(cell)
    assert metrics
    for metric in metrics:
        value = result["metrics"][metric["name"]]["value"]
        assert value >= 0, metric["name"]
        if metric["unit"] == "%":
            assert 0 <= value <= 100, (metric["name"], value)
    json.dumps(result)


def test_every_new_metric_is_read_in_its_cell():
    named = {metric["name"] for cell in CELLS for metric in new_metrics(cell)}
    assert len(named) == 11
    assert {name.split(".")[0] for name in named} == set(PREFIXES)
