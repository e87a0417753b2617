"""The multimodal cohort a configuration with ``modalities`` plants: the
counts of every modality of the same samples, drawn from the seed.

Each sample carries the processes that the configuration lists with
``always`` and each other process independently with probability
``p_active``; an active process has one activity a ~ Gamma(shape, scale)
per sample (``activity_gamma``), and each of its signatures in a modality
the exposure a * Gamma(shape, scale) of that modality
(``exposure_gamma``), summed where processes share a signature. Counts
are Poisson(E W), zeros set to ``zero_to``. The signatures are the
catalogs' columns, normalized."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from .inputs import frame
from .manifest import ROOT


def planted(config: dict, modality: str, root: Path = ROOT) -> pd.DataFrame:
    """The planted signatures of `modality`, channels x signatures,
    columns summing to one, in the configuration's order."""
    spec = config["modalities"][modality]
    catalog = frame(config, spec["catalog"], root)[spec["planted"]]
    return catalog / catalog.sum(axis=0)


def cohort(config: dict, seed: int, root: Path = ROOT,
           n_samples: int | None = None) -> dict[str, pd.DataFrame]:
    """{modality: samples x channels counts} in the configuration's
    modality order (module docstring)."""
    spec = config["cohort"]
    n = int(spec["n_samples"] if n_samples is None else n_samples)
    processes = spec["processes"]
    rng = np.random.default_rng(int(seed))
    activity = rng.gamma(*spec["activity_gamma"], size=(n, len(processes)))
    active = rng.random((n, len(processes))) < spec["p_active"]
    active[:, [p.get("always", False) for p in processes]] = True
    activity = activity * active
    out = {}
    for modality, (shape, scale) in spec["exposure_gamma"].items():
        signatures = planted(config, modality, root)
        names = list(signatures.columns)
        E = np.zeros((n, len(names)))
        for p, process in enumerate(processes):
            for name in process[modality]:
                E[:, names.index(name)] += activity[:, p] * rng.gamma(
                    shape, scale, size=n)
        X = rng.poisson(E @ signatures.to_numpy().T).astype(np.float64)
        X[X == 0] = spec["zero_to"]
        out[modality] = pd.DataFrame(X, columns=signatures.index)
    return out
