"""BENCHMARK.json against the contract's form, and every file it names."""

import hashlib
import json

import pytest

from portbench import manifest

BOOK = manifest.load()
METRICS = BOOK["end_to_end"] + BOOK["per_layer"]


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [w["name"] for w in BOOK["workloads"]]
                         + [c["name"] for c in BOOK["configs"]])
def test_names(name):
    assert manifest.NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_form(metric):
    assert manifest.UNIT.match(metric["unit"])
    assert len(metric["unit"]) <= 16
    assert metric["better"] in ("lower", "higher")
    assert manifest.reader_path(metric["name"]).exists()
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_reader_of_a_suffixed_name_is_its_prefix(tmp_path):
    folder = tmp_path / "portbench" / "metrics"
    folder.mkdir(parents=True)
    for name in ("share", "share.own"):
        (folder / f"{name}.py").write_text(f"def read(ctx):\n"
                                           f"    return {name!r}\n")
    assert manifest.reader("share.cell_a", tmp_path).read({}) == "share"
    assert manifest.reader("share.own", tmp_path).read({}) == "share.own"
    assert manifest.reader("share", tmp_path).read({}) == "share"


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [item["name"] for item in BOOK[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", BOOK["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    assert cell["chips"] == 1
    traffic = manifest.traffic(cell)
    manifest.job_kind(traffic["entry"])
    config = manifest.config(BOOK, cell)  # checks the data's sha256
    assert config["name"] == cell["config"]
    limits = json.loads((manifest.ROOT / "portbench" / "limits"
                         / f"{cell['name']}.json").read_text())["limits"]
    assert limits
    e2e = {m["name"] for m in manifest.metrics(BOOK, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics(BOOK, cell, "per_layer")
    assert layer
    for metric in layer:
        assert metric["moves"] in e2e


def test_per_layer_moves_reported_wherever_listed():
    cells = {w["name"] for w in BOOK["workloads"]}
    for metric in BOOK["per_layer"]:
        assert set(metric["workloads"]) <= cells
        moved = next(m for m in BOOK["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(
            moved.get("workloads", cells))


def test_paths_and_command():
    assert BOOK["paths"] == ["portbench"]
    assert BOOK["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BOOK["run_seconds"] <= 51
    for config in BOOK["configs"]:
        assert config["file"].startswith("portbench/")
        assert len(config["source"]) <= 200


def test_data_copies_match_recorded_digest():
    for config in BOOK["configs"]:
        found = json.loads((manifest.ROOT / config["file"]).read_text())
        for data in found["data"].values():
            digest = hashlib.sha256(
                (manifest.ROOT / data["file"]).read_bytes()).hexdigest()
            assert digest == data["sha256"]
