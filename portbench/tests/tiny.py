"""A copy of the benchmark's files at sizes a CPU test run holds: the same
cells, configurations, traffic mixes and readers, with fewer lanes,
iterations and samples."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TRAFFIC = {
    "restarts100": {"n_restarts": 4, "fit_config": [50, 50, 10, 1e-7],
                    "warm_config": [20, 20, 10, 1e-7], "check_jobs": 2,
                    "profiled_jobs": 1},
    "extract_b20": {"ranks": [2, 3], "n_bootstraps": 3,
                    "fit_config": [20, 60, 10, 1e-7],
                    "warm_config": [10, 20, 10, 1e-7]},
    "extract_b10": {"ranks": [2, 3], "n_bootstraps": 3,
                    "fit_config": [20, 60, 10, 1e-7],
                    "warm_config": [10, 20, 10, 1e-7]},
    "assign": {},
}
COHORT_SAMPLES = 100
# a share of 100 samples moves by 0.01 a sample, where the card's 20,000
# hold the cell's limit of 0.018 (PERF.md): the tiny copy allows 5 samples;
# 4 lanes cannot reach the card's counts of 5 and 10 of 100 lanes apart,
# and at 50 steps no sound lane is apart: the tiny copy allows none
LIMITS = {"pancancer_sbs_20k-assign": {"support_differs": 0.05},
          "pcawg_sbs-restarts100": {"lanes_apart_loss": 0.0,
                                    "lanes_apart_factors": 0.0}}


def make(tmp: Path) -> Path:
    """The tiny copy under tmp; returns its root."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, changes in TRAFFIC.items():
        path = root / "portbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(changes)
        path.write_text(json.dumps(traffic))
    for cell, changes in LIMITS.items():
        path = root / "portbench" / "limits" / f"{cell}.json"
        limits = json.loads(path.read_text())
        limits["limits"].update(changes)
        path.write_text(json.dumps(limits))
    path = root / "portbench" / "configs" / "pancancer_sbs_20k.json"
    config = json.loads(path.read_text())
    config["cohort"]["n_samples"] = COHORT_SAMPLES
    path.write_text(json.dumps(config))
    return root
