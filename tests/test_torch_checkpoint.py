"""salamander_tpu_torch.checkpoint against salamander_tpu.checkpoint: the
same fingerprint string for the same arrays, and stores each package can
read from the other."""

import json

import numpy as np
import pytest

from salamander_tpu import checkpoint as jax_checkpoint
from salamander_tpu_torch import checkpoint


def arrays_of(seed):
    rng = np.random.default_rng(seed)
    return [
        rng.poisson(30.0, (96, 48)).astype(np.float64),
        rng.uniform(size=(7,)).astype(np.float32),
        np.arange(12, dtype=np.int64).reshape(3, 4),
        np.asfortranarray(rng.uniform(size=(5, 6))),
        rng.uniform(size=(6, 5)).T,  # a transposed view
    ]


@pytest.mark.parametrize("count", [1, 2, 5])
def test_data_fingerprint_equals_jax(count):
    arrays = arrays_of(count)[:count]
    port = checkpoint.data_fingerprint(*arrays)
    assert port == jax_checkpoint.data_fingerprint(*arrays)
    assert len(port) == 64


def test_data_fingerprint_sees_dtype_shape_and_order():
    X = np.arange(12.0).reshape(3, 4)
    reference = checkpoint.data_fingerprint(X)
    assert checkpoint.data_fingerprint(X.astype(np.float32)) != reference
    assert checkpoint.data_fingerprint(X.reshape(4, 3)) != reference
    Y = X + 1
    assert checkpoint.data_fingerprint(X, Y) != \
        checkpoint.data_fingerprint(Y, X)


@pytest.mark.parametrize("writer, reader", [
    (checkpoint, jax_checkpoint), (jax_checkpoint, checkpoint),
])
def test_store_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader):
    meta = {"task": "t", "n": 3, "data": "abc"}
    payload = {"W": np.arange(6.0).reshape(2, 3), "k": np.asarray(4)}
    writer.ChunkStore(tmp_path, meta).save("part", match={"guard": [1, 2]},
                                           **payload)
    store = reader.ChunkStore(tmp_path, meta)
    loaded = store.load("part", match={"guard": [1, 2]})
    assert set(loaded) == {"W", "k"}
    np.testing.assert_array_equal(loaded["W"], payload["W"])
    assert store.load("part", match={"guard": [1, 3]}) is None
    assert store.load("absent") is None


def test_store_with_other_meta_is_discarded(tmp_path):
    checkpoint.ChunkStore(tmp_path, {"run": 1}).save("a", x=np.ones(2))
    with pytest.warns(UserWarning, match="different run"):
        store = checkpoint.ChunkStore(tmp_path, {"run": 2})
    assert store.load("a") is None
    assert json.loads((tmp_path / "meta.json").read_text()) == {"run": 2}


def test_corrupt_entry_and_match_collision(tmp_path):
    store = checkpoint.ChunkStore(tmp_path, {"run": 1})
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert store.load("bad") is None
    with pytest.raises(ValueError, match="collides"):
        store.save("c", match={"x": 1}, x=np.ones(1))
