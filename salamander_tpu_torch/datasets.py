"""Dataset access: the PCAWG-breast catalogs, held against
salamander_tpu/datasets.py (its COSMIC and synthetic loaders come with the
slices that use them).

The port ships no copy of the CSV assets. Search order: $SALAMANDER_DATA
(override), then the JAX package's data directory beside this package in
the checkout (``salamander_tpu/data``, found by file path - importing
salamander_tpu would import jax). All loaders return
(n_samples, n_features)-oriented DataFrames ready for AnnData(...) (the
files store features x samples).
"""

from __future__ import annotations

import os
from pathlib import Path

import pandas as pd

_SEARCH_PATHS = [
    os.environ.get("SALAMANDER_DATA"),
    str(Path(__file__).resolve().parents[1] / "salamander_tpu" / "data"),
]

FILES = {
    "pcawg_sbs": "pcawg_breast_sbs.csv",
    "pcawg_indel": "pcawg_breast_indel.csv",
    "pcawg_sv": "pcawg_breast_sv.csv",
}


def _resolve(filename: str) -> Path:
    for base in _SEARCH_PATHS:
        if base is None:
            continue
        path = Path(base) / filename
        if path.exists():
            return path
    raise FileNotFoundError(
        f"Dataset file '{filename}' not found; searched {_SEARCH_PATHS}. "
        "Set SALAMANDER_DATA to a directory containing the catalog CSVs."
    )


def _load_csv(key: str) -> pd.DataFrame:
    return pd.read_csv(_resolve(FILES[key]), index_col=0).T


def load_pcawg_sbs() -> pd.DataFrame:
    """PCAWG breast-cancer SBS-96 counts (192 samples x 96 channels)."""
    return _load_csv("pcawg_sbs")


def load_pcawg_indel() -> pd.DataFrame:
    """PCAWG breast-cancer ID-83 counts (192 samples x 83 channels)."""
    return _load_csv("pcawg_indel")


def load_pcawg_sv() -> pd.DataFrame:
    """PCAWG breast-cancer SV-32 counts (192 samples x 32 channels)."""
    return _load_csv("pcawg_sv")
