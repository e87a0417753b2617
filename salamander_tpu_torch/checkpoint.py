"""Preemption-safe chunk stores, held against salamander_tpu/checkpoint.py
(copied: host code on numpy, so a fingerprint of the same arrays is the
same string in both packages).

A long multi-start fit or rank scan is split at the chunk boundaries its
driver already has. A ``ChunkStore`` is one directory per run holding

- ``meta.json`` — the run's full identity (data fingerprint + every
  argument that selects the computation), and
- one ``<name>.npz`` per completed chunk of work, written ATOMICALLY
  (tmp file + ``os.replace``), so a kill at any point leaves a loadable
  store and re-running with identical arguments resumes past completed
  work.

Entries can carry ``match`` guards — arrays that must compare equal at
load time — so stale entries are recomputed instead of trusted. A store
whose meta does not match the current run is warned about, wiped and
rebuilt: results from two different runs are never mixed.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
import zipfile
from pathlib import Path

import numpy as np

__all__ = ["ChunkStore", "data_fingerprint"]


def data_fingerprint(*arrays) -> str:
    """sha256 over the raw bytes + shape + dtype of the given arrays — the
    identity of a run's numeric inputs (order-sensitive)."""
    digest = hashlib.sha256()
    for array in arrays:
        contiguous = np.ascontiguousarray(array)
        digest.update(contiguous.tobytes())
        digest.update(str(contiguous.shape).encode())
        digest.update(str(contiguous.dtype).encode())
    return digest.hexdigest()


class ChunkStore:
    """One resumable run's directory: meta.json + atomic npz entries."""

    def __init__(self, directory, meta: dict):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        meta_path = self.dir / "meta.json"
        existing = None
        if meta_path.exists():
            try:
                existing = json.loads(meta_path.read_text())
            except (OSError, json.JSONDecodeError):
                existing = None
        if existing != meta:
            if existing is not None:
                warnings.warn(
                    f"checkpoint at {self.dir} was written by a different "
                    "run (data, arguments or chunk layout differ) - "
                    "discarding it and starting fresh",
                    UserWarning,
                )
            for stale in self.dir.glob("*.npz"):
                stale.unlink()
            tmp = meta_path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(meta, indent=1))
            os.replace(tmp, meta_path)

    def load(self, name: str, match: dict | None = None):
        """The entry's arrays as a dict, or None when absent/corrupt/stale.

        ``match``: arrays that must compare exactly equal to the stored
        ones for the entry to count (guards against results computed from
        different intermediate state)."""
        path = self.dir / f"{name}.npz"
        if not path.exists():
            return None
        try:
            with np.load(path) as archive:
                loaded = {key: archive[key] for key in archive.files}
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return None
        for key, expected in (match or {}).items():
            stored = loaded.pop(key, None)
            if stored is None or not np.array_equal(
                stored, np.asarray(expected)
            ):
                return None
        return loaded

    def save(self, name: str, match: dict | None = None, **arrays) -> None:
        """Write an entry atomically; ``match`` guards are stored alongside
        the payload (keys must not collide)."""
        payload = {key: np.asarray(value) for key, value in arrays.items()}
        for key, value in (match or {}).items():
            if key in payload:
                raise ValueError(f"match key {key!r} collides with payload")
            payload[key] = np.asarray(value)
        path = self.dir / f"{name}.npz"
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **payload)
        os.replace(tmp, path)
