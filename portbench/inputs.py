"""The inputs a cell hands the program and the reference alike, made from
its configuration file and the seed: the vendored catalogs (sha256 checked
by manifest.config) and the planted-COSMIC cohort generator."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from .manifest import ROOT


def frame(config: dict, key: str, root: Path = ROOT) -> pd.DataFrame:
    """A vendored CSV as stored: channels as rows."""
    return pd.read_csv(Path(root) / config["data"][key]["file"], index_col=0)


def catalog(config: dict, root: Path = ROOT) -> pd.DataFrame:
    """The configuration's signature catalog, signatures x channels."""
    return frame(config, config["catalog"], root).T


def planted_cohort(config: dict, seed: int, root: Path = ROOT,
                   n_samples: int | None = None) -> pd.DataFrame:
    """Samples x channels counts of the planted-COSMIC cohort.

    Frozen copy of chip_smoke.py:3349-3366 (``cohort_8b``, the JAX suite's
    config 8b): the catalog's columns normalized, the planted signatures'
    exposures gamma(shape, scale), Poisson counts, zeros set to
    ``zero_to``. One change: the planted signatures are the configuration's
    fixed list (the suite's draw at seed 0), not a draw of each seed, so
    that every seed asks for the same kind of work."""
    spec = config["cohort"]
    n = int(spec["n_samples"] if n_samples is None else n_samples)
    cosmic = catalog(config, root)
    W = cosmic.to_numpy().T
    W = W / W.sum(axis=0, keepdims=True)
    rng = np.random.default_rng(int(seed))
    H = np.zeros((W.shape[1], n))
    planted = [list(cosmic.index).index(name) for name in spec["planted"]]
    H[planted] = rng.gamma(spec["gamma_shape"], spec["gamma_scale"],
                           size=(len(planted), n))
    X = rng.poisson(W @ H).astype(np.float64)
    X[X == 0] = spec["zero_to"]
    return pd.DataFrame(X.T, columns=cosmic.columns)


def counts(config: dict, seed: int, root: Path = ROOT) -> pd.DataFrame:
    """The configuration's cohort, samples x channels: the vendored
    catalog as it is, or the planted cohort drawn from the seed."""
    if "cohort" in config:
        return planted_cohort(config, seed, root)
    return frame(config, config["counts"], root).T
