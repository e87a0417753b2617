"""Dataset access: the PCAWG-breast catalogs, the COSMIC SBS and indel
signature catalogs and the synthetic COSMIC-scale catalog, held against
salamander_tpu/datasets.py (its HRDetect loader comes with the slice that
uses it).

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

import numpy as np
import pandas as pd

_SEARCH_PATHS = [
    os.environ.get("SALAMANDER_DATA"),
    str(Path(__file__).resolve().parents[1] / "salamander_tpu" / "data"),
]

FILES = {
    "pcawg_sbs": "pcawg_breast_sbs.csv",
    "pcawg_indel": "pcawg_breast_indel.csv",
    "pcawg_sv": "pcawg_breast_sv.csv",
    "cosmic_sbs": "COSMIC_v3.3.1_SBS_GRCh38.csv",
    "cosmic_indel": "COSMIC_v3.4_ID_GRCh37.txt",
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
    # the COSMIC .txt catalog is comma-separated despite its suffix
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


def load_cosmic_sbs_catalog() -> pd.DataFrame:
    """COSMIC v3.3.1 SBS signature catalog (signatures x 96 channels);
    the file stores channels x signatures."""
    return _load_csv("cosmic_sbs")


def load_cosmic_indel_catalog() -> pd.DataFrame:
    """COSMIC v3.4 indel signature catalog (signatures x 83 channels)."""
    return _load_csv("cosmic_indel")


def synthetic_catalog(
    n_features: int = 96,
    n_samples: int = 10_000,
    n_signatures: int = 8,
    mean_mutations: float = 5_000.0,
    seed: int = 0,
    return_truth: bool = False,
):
    """A COSMIC-scale synthetic Poisson count catalog for benchmarking
    (copied, so the same seed gives the same catalog as the JAX package).

    Signatures are Dirichlet(0.3) draws (sparse, signature-like); sample
    loads are gamma-distributed; counts ~ Poisson(W @ H). Shapes follow the
    kernel orientation X: (n_features, n_samples).
    """
    rng = np.random.default_rng(seed)
    signatures = rng.dirichlet(0.3 * np.ones(n_features), size=n_signatures).T
    weights = rng.dirichlet(np.ones(n_signatures), size=n_samples).T
    loads = rng.gamma(2.0, mean_mutations / 2.0, size=n_samples)
    expected = signatures @ (weights * loads)
    X = rng.poisson(expected).astype(np.float64)
    X = np.clip(X, np.finfo(np.float32).eps, None)
    if return_truth:
        return X, signatures, weights * loads
    return X
