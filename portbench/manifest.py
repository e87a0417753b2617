"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file holds
its sizes and data, and a traffic mix, ``portbench/traffic/<traffic>.json``,
which names the job kind (a module of ``portbench/entries``) and its
parameters. Every metric, end-to-end or per-layer, is read by
``portbench/metrics/<name>.py``, or where there is no such file by the
reader of its name up to the first dot (``mu_kernel_roofline.restarts``
by ``metrics/mu_kernel_roofline.py``). A later cell or metric is new
files and new entries; no file here changes.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as handle:
        return json.load(handle)


def cell(manifest: dict, name: str) -> dict:
    for entry in manifest["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, entry: dict, root: Path = ROOT) -> dict:
    """The configuration file of a cell, its data files checked against
    the sha256 it records."""
    for item in manifest["configs"]:
        if item["name"] == entry["config"]:
            with open(Path(root) / item["file"]) as handle:
                found = json.load(handle)
            for data in found.get("data", {}).values():
                path = Path(root) / data["file"]
                digest = hashlib.sha256(path.read_bytes()).hexdigest()
                if digest != data["sha256"]:
                    raise ValueError(f"{path}: sha256 {digest} is not the "
                                     f"recorded {data['sha256']}")
            return found
    raise KeyError(f"no configuration {entry['config']!r}")


def traffic(entry: dict, root: Path = ROOT) -> dict:
    path = Path(root) / "portbench" / "traffic" / f"{entry['traffic']}.json"
    with open(path) as handle:
        return json.load(handle)


def metrics(manifest: dict, entry: dict, kind: str) -> list[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it under ``workloads``, or list no cells."""
    return [metric for metric in manifest[kind]
            if entry["name"] in metric.get("workloads", [entry["name"]])]


def reader_path(name: str, root: Path = ROOT) -> Path:
    """portbench/metrics/<name>.py, else the file named by `name` up to its
    first dot."""
    folder = Path(root) / "portbench" / "metrics"
    path = folder / f"{name}.py"
    return path if path.exists() else folder / f"{name.split('.')[0]}.py"


def reader(name: str, root: Path = ROOT):
    """The module of the metric's reader (reader_path): its read(ctx)
    returns the metric's value, or None where the run has nothing to
    read."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_kind(name: str):
    """The module of portbench/entries/<name>.py."""
    return importlib.import_module(f"portbench.entries.{name}")
