"""Dataset loaders of salamander_tpu_torch against the JAX package's: the
same vendored CSVs give equal frames (values, index, columns, dtypes)."""

import pandas as pd
import pytest

from salamander_tpu import datasets as jax_datasets
from salamander_tpu_torch import datasets


def test_hrdetect_equals_jax():
    counts, labels = datasets.load_hrdetect()
    assert counts.shape == (311, 96)
    assert len(labels) == 311
    jax_counts, jax_labels = jax_datasets.load_hrdetect()
    pd.testing.assert_frame_equal(counts, jax_counts, check_exact=True)
    pd.testing.assert_frame_equal(labels, jax_labels, check_exact=True)


@pytest.mark.parametrize("loader", [
    "load_pcawg_sbs", "load_pcawg_indel", "load_pcawg_sv",
    "load_cosmic_sbs_catalog", "load_cosmic_indel_catalog",
])
def test_loaders_equal_jax(loader):
    pd.testing.assert_frame_equal(getattr(datasets, loader)(),
                                  getattr(jax_datasets, loader)(),
                                  check_exact=True)


def test_missing_file_error(monkeypatch):
    monkeypatch.setattr(datasets, "_SEARCH_PATHS", ["/nonexistent"])
    with pytest.raises(FileNotFoundError):
        datasets.load_hrdetect()
