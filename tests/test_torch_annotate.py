"""Catalog annotation of de novo signatures (tools.annotate_signatures) in
salamander_tpu_torch, mirroring the annotate_signatures cases of
tests/test_annotate.py, and held against the JAX package: on shared
frames the tables are equal (names exactly, similarities at rtol 1e-12);
on models fitted by both packages from the same nndsvd start (float64,
CPU) the matched names and the renames are equal and the similarities
agree at rtol 1e-8 (the fits agree at 1e-8). decompose_signatures is
covered in test_torch_assign.py."""

import numpy as np
import pandas as pd
import pytest

import salamander_tpu as jax_sal
from salamander_tpu import tools as jax_tl
from salamander_tpu.containers import AnnData as JaxAnnData
from salamander_tpu_torch import tools as tl
from salamander_tpu_torch.containers import AnnData
from salamander_tpu_torch.models import KLNMF

NAMES = ["matched", "runner_up", "novel"]
VALUES = ["similarity", "runner_up_similarity"]


@pytest.fixture(scope="module")
def catalog():
    n_features, n_entries = 24, 8
    C = np.full((n_entries, n_features), 0.01)
    block = n_features // n_entries
    for k in range(n_entries):
        C[k, k * block:(k + 1) * block] += 1.0
    C = C / C.sum(axis=1, keepdims=True)
    return pd.DataFrame(
        C, index=[f"SBS{k+1}" for k in range(n_entries)],
        columns=[f"f{v}" for v in range(n_features)],
    )


def _perturbed(catalog, rows, scale, seed=1):
    rng = np.random.default_rng(seed)
    S = catalog.to_numpy()[rows] + scale * rng.random(
        (len(rows), catalog.shape[1])
    )
    S = S / S.sum(axis=1, keepdims=True)
    return pd.DataFrame(
        S, index=[f"denovo{i}" for i in range(len(rows))],
        columns=catalog.columns,
    )


def assert_same_table(table, expected, rtol=1e-12):
    assert list(table.index) == list(expected.index)
    assert list(table.columns) == list(expected.columns)
    for column in NAMES:
        assert list(table[column]) == list(expected[column]), column
    np.testing.assert_allclose(table[VALUES].to_numpy(),
                               expected[VALUES].to_numpy(), rtol=rtol)


def test_recovers_identity_matches(catalog):
    rows = [3, 0, 5]
    sigs = _perturbed(catalog, rows, 0.02)
    table = tl.annotate_signatures(sigs, catalog)
    assert list(table["matched"]) == ["SBS4", "SBS1", "SBS6"]
    assert (table["similarity"] > 0.99).all()
    assert not table["novel"].any()
    assert (table["runner_up_similarity"] < table["similarity"]).all()
    assert list(table.index) == ["denovo0", "denovo1", "denovo2"]
    assert_same_table(table, jax_tl.annotate_signatures(sigs, catalog))


def test_novel_flag_below_threshold(catalog):
    rng = np.random.default_rng(7)
    flat = rng.random((1, catalog.shape[1]))
    flat = flat / flat.sum()
    sigs = pd.DataFrame(flat, index=["weird"], columns=catalog.columns)
    table = tl.annotate_signatures(sigs, catalog, min_similarity=0.95)
    assert bool(table["novel"].iloc[0])
    assert_same_table(table, jax_tl.annotate_signatures(
        sigs, catalog, min_similarity=0.95))


def test_unique_prevents_double_claim(catalog):
    # two noisy copies of the SAME catalog entry: independent argmax gives
    # both to SBS3, Hungarian must split them
    sigs = _perturbed(catalog, [2, 2], 0.15, seed=3)
    plain = tl.annotate_signatures(sigs, catalog)
    assert list(plain["matched"]) == ["SBS3", "SBS3"]
    uniq = tl.annotate_signatures(sigs, catalog, unique=True)
    assert sorted(uniq["matched"]) != ["SBS3", "SBS3"]
    assert "SBS3" in list(uniq["matched"])
    assert_same_table(uniq, jax_tl.annotate_signatures(sigs, catalog,
                                                       unique=True))
    with pytest.raises(ValueError, match="catalog size"):
        tl.annotate_signatures(
            _perturbed(catalog, list(range(8)) + [0], 0.05), catalog,
            unique=True,
        )


def test_feature_order_and_orientation_invariance(catalog):
    sigs = _perturbed(catalog, [1, 4], 0.02)
    base = tl.annotate_signatures(sigs, catalog)
    shuffled = catalog.iloc[:, ::-1].T  # features x signatures, reversed
    other = tl.annotate_signatures(sigs, shuffled)
    pd.testing.assert_frame_equal(base, other)
    assert_same_table(other, jax_tl.annotate_signatures(sigs, shuffled))
    with pytest.raises(ValueError, match="do not match"):
        tl.annotate_signatures(sigs, catalog.iloc[:, :-1])
    with pytest.raises(TypeError, match="DataFrame"):
        tl.annotate_signatures(sigs, catalog.to_numpy())


def _fitted_pair(frame, hyper, seed):
    """The same KLNMF fit in both packages (float64, CPU)."""
    model = KLNMF(**hyper, device="cpu", dtype="float64")
    model.fit(AnnData(frame.copy()), init_kwargs={"seed": seed})
    jax_model = jax_sal.models.KLNMF(**hyper, dtype="float64")
    jax_model.fit(JaxAnnData(frame.copy()), init_kwargs={"seed": seed})
    return model, jax_model


def test_model_rename_propagates(catalog):
    # plant exactly two catalog signatures, fit at k=2, rename
    rng = np.random.default_rng(5)
    W = catalog.to_numpy()[[2, 6]].T  # (V, 2)
    H = rng.gamma(2.0, 500.0, size=(2, 40))
    X = np.maximum(np.round(W @ H).T, 1.0)  # samples x features
    frame = pd.DataFrame(
        X, index=[f"s{d}" for d in range(40)], columns=catalog.columns
    )
    model, jax_model = _fitted_pair(
        frame, dict(n_signatures=2, min_iterations=200, max_iterations=2000),
        seed=0)
    table = tl.annotate_signatures(model, catalog, rename=True)
    assert sorted(table["matched"]) == ["SBS3", "SBS7"]
    assert sorted(model.signature_names) == sorted(table.index)
    # renames propagate to the exposures surface
    assert sorted(model.exposures.columns) == sorted(table.index)
    jax_table = jax_tl.annotate_signatures(jax_model, catalog, rename=True)
    assert_same_table(table, jax_table, rtol=1e-8)
    assert model.signature_names == jax_model.signature_names


def test_rename_requires_model(catalog):
    sigs = _perturbed(catalog, [0], 0.02)
    with pytest.raises(ValueError, match="fitted model"):
        tl.annotate_signatures(sigs, catalog, rename=True)


def test_duplicate_rename_suffixes(catalog):
    sigs = _perturbed(catalog, [2, 2], 0.1, seed=9)
    # a model with two signatures both near SBS3: the renames are
    # deduplicated with ".1" suffixes
    frame = pd.DataFrame(
        np.maximum(np.round(
            sigs.to_numpy().T @ np.random.default_rng(2).gamma(
                2.0, 500.0, size=(2, 30))).T, 1.0),
        columns=catalog.columns,
    )
    model, jax_model = _fitted_pair(
        frame, dict(n_signatures=2, min_iterations=100, max_iterations=500),
        seed=1)
    table = tl.annotate_signatures(model, catalog, rename=True)
    names = list(table.index)
    assert len(set(names)) == 2  # deduplicated even if both match SBS3
    jax_table = jax_tl.annotate_signatures(jax_model, catalog, rename=True)
    assert_same_table(table, jax_table, rtol=1e-8)
