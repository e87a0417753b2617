"""Lightweight annotated-data containers (AnnData/MuData work-alikes),
copied from salamander_tpu/containers.py.

The reference framework stores all model state inside anndata.AnnData /
mudata.MuData objects (see reference models/signature_nmf.py:182-224). Those
packages are heavyweight and not needed for the compute, so this module provides small,
dependency-free equivalents covering the API surface the framework uses:

  AnnData: X, n_obs/n_vars, obs/var (pandas DataFrames), obsm/obsp (aligned
           dict-of-arrays), obs_names/var_names, to_df(), copy(), row/col
           subsetting, npz round-trip.
  MuData:  a dict of AnnData modalities sharing sample (obs) names, with
           global obs/obsm/obsp and update().

If the real anndata/mudata packages are installed, objects of those types are
accepted anywhere these are (duck-typed: the framework only uses the shared
API above).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import pandas as pd


class AxisArrays(dict):
    """A dict of arrays whose first dimension is aligned to an axis length
    (both of the first two for pairwise arrays, e.g. obsp)."""

    def __init__(self, axis_len_getter, pairwise: bool = False):
        super().__init__()
        self._axis_len = axis_len_getter
        self._pairwise = pairwise

    def __setitem__(self, key: str, value) -> None:
        value = np.asarray(value)
        expected = self._axis_len()
        if expected is not None and value.shape[0] != expected:
            raise ValueError(
                f"Value for key '{key}' has leading dimension {value.shape[0]}, "
                f"expected {expected}."
            )
        if self._pairwise and (
            value.ndim < 2 or value.shape[1] != expected
        ):
            raise ValueError(
                f"Pairwise value for key '{key}' must be of shape "
                f"({expected}, {expected}); got {value.shape}."
            )
        super().__setitem__(key, value)


# ---------------------------------------------------------------------------
# scverse on-disk encodings (anndata spec v0.1.0 / element encodings v0.2.0),
# shared by AnnData.write_h5ad and MuData.write_h5mu.
# ---------------------------------------------------------------------------

def _h5_write_string_array(group, name, values):
    import h5py

    dataset = group.create_dataset(
        name, data=np.asarray(values, dtype=object),
        dtype=h5py.string_dtype(encoding="utf-8"),
    )
    dataset.attrs["encoding-type"] = "string-array"
    dataset.attrs["encoding-version"] = "0.2.0"
    return dataset


def _h5_write_array(group, name, values):
    values = np.asarray(values)
    if values.dtype == object or values.dtype.kind in "US":
        return _h5_write_string_array(group, name, values.astype(str))
    dataset = group.create_dataset(name, data=values)
    dataset.attrs["encoding-type"] = "array"
    dataset.attrs["encoding-version"] = "0.2.0"
    return dataset


def _h5_write_dataframe(handle, name, frame):
    import h5py

    group = handle.create_group(name)
    group.attrs["encoding-type"] = "dataframe"
    group.attrs["encoding-version"] = "0.2.0"
    group.attrs["_index"] = "_index"
    group.attrs.create(
        "column-order",
        data=np.asarray([str(c) for c in frame.columns], dtype=object),
        dtype=h5py.string_dtype(encoding="utf-8"),
    )
    _h5_write_string_array(group, "_index", frame.index.astype(str))
    for column in frame.columns:
        _h5_write_array(group, str(column), frame[column].to_numpy())


def _h5_write_mappings(handle, mappings):
    for mapping_name, mapping in mappings:
        group = handle.create_group(mapping_name)
        group.attrs["encoding-type"] = "dict"
        group.attrs["encoding-version"] = "0.1.0"
        for key, value in mapping.items():
            _h5_write_array(group, key, value)


def _h5_write_anndata(handle, adata) -> None:
    """Write one AnnData into an open h5py Group/File with anndata encodings."""
    handle.attrs["encoding-type"] = "anndata"
    handle.attrs["encoding-version"] = "0.1.0"
    x_dataset = handle.create_dataset("X", data=adata.X)
    x_dataset.attrs["encoding-type"] = "array"
    x_dataset.attrs["encoding-version"] = "0.2.0"
    _h5_write_dataframe(handle, "obs", adata.obs)
    _h5_write_dataframe(handle, "var", adata.var)
    _h5_write_mappings(handle, [
        ("obsm", adata.obsm), ("obsp", adata.obsp), ("varm", adata.varm),
    ])


def _h5_decode(values):
    values = values[...]
    if values.dtype.kind in "OS":
        return np.array(
            [v.decode() if isinstance(v, bytes) else str(v) for v in values]
        )
    return values


def _h5_read_dataframe(group):
    index_key = group.attrs.get("_index", "_index")
    index = _h5_decode(group[index_key])
    frame = pd.DataFrame(index=pd.Index(index))
    order = group.attrs.get("column-order", [])
    columns = [c.decode() if isinstance(c, bytes) else str(c) for c in order]
    for column in columns:
        if column in group:
            frame[column] = _h5_decode(group[column])
    return frame


def _h5_read_anndata(cls, handle):
    adata = cls(
        np.asarray(handle["X"][...]),
        _h5_read_dataframe(handle["obs"]),
        _h5_read_dataframe(handle["var"]),
    )
    for mapping_name, mapping in [
        ("obsm", adata.obsm), ("obsp", adata.obsp), ("varm", adata.varm),
    ]:
        if mapping_name in handle:
            for key in handle[mapping_name]:
                mapping[key] = np.asarray(handle[mapping_name][key][...])
    return adata


class AnnData:
    """An annotated data matrix: X of shape (n_obs, n_vars) plus metadata."""

    def __init__(
        self,
        X: np.ndarray | pd.DataFrame | None = None,
        obs: pd.DataFrame | None = None,
        var: pd.DataFrame | None = None,
    ):
        if isinstance(X, pd.DataFrame):
            if obs is None:
                obs = pd.DataFrame(index=X.index.astype(str))
            if var is None:
                var = pd.DataFrame(index=X.columns.astype(str))
            X = X.to_numpy()
        if X is None:
            X = np.empty((0, 0))
        self._X = np.asarray(X)

        n_obs, n_vars = self._X.shape
        if obs is None:
            obs = pd.DataFrame(index=[str(i) for i in range(n_obs)])
        if var is None:
            var = pd.DataFrame(index=[str(i) for i in range(n_vars)])
        self.obs = obs
        self.var = var
        self.obsm = AxisArrays(lambda: self.n_obs)
        self.obsp = AxisArrays(lambda: self.n_obs, pairwise=True)
        self.varm = AxisArrays(lambda: self.n_vars)
        self.uns: dict[str, Any] = {}

    # -- core matrix ------------------------------------------------------
    @property
    def X(self) -> np.ndarray:
        return self._X

    @X.setter
    def X(self, value) -> None:
        value = np.asarray(value)
        if value.shape != self._X.shape:
            raise ValueError(
                f"Cannot replace X of shape {self._X.shape} "
                f"with array of shape {value.shape}."
            )
        self._X = value

    @property
    def shape(self) -> tuple[int, int]:
        return self._X.shape

    @property
    def n_obs(self) -> int:
        return self._X.shape[0]

    @property
    def n_vars(self) -> int:
        return self._X.shape[1]

    # -- names ------------------------------------------------------------
    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names) -> None:
        self.obs.index = pd.Index([str(n) for n in names])

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, names) -> None:
        self.var.index = pd.Index([str(n) for n in names])

    # -- conversion / copying ----------------------------------------------
    def to_df(self) -> pd.DataFrame:
        return pd.DataFrame(self._X, index=self.obs_names, columns=self.var_names)

    def copy(self) -> "AnnData":
        out = AnnData(self._X.copy(), self.obs.copy(), self.var.copy())
        for key, value in self.obsm.items():
            out.obsm[key] = value.copy()
        for key, value in self.obsp.items():
            out.obsp[key] = value.copy()
        for key, value in self.varm.items():
            out.varm[key] = value.copy()
        out.uns = dict(self.uns)
        return out

    # -- subsetting ---------------------------------------------------------
    def _resolve_obs_indexer(self, idx) -> np.ndarray:
        if isinstance(idx, slice):
            return np.arange(self.n_obs)[idx]
        idx = np.asarray(idx)
        if idx.dtype == bool:
            return np.where(idx)[0]
        if idx.dtype.kind in "US":
            lookup = {name: i for i, name in enumerate(self.obs_names)}
            return np.array([lookup[str(name)] for name in idx], dtype=int)
        return idx.astype(int)

    def __getitem__(self, key) -> "AnnData":
        if not isinstance(key, tuple):
            key = (key, slice(None))
        rows, cols = key
        row_idx = self._resolve_obs_indexer(rows)
        if isinstance(cols, slice):
            col_idx = np.arange(self.n_vars)[cols]
        else:
            col_idx = np.asarray(cols).astype(int)
        out = AnnData(
            self._X[np.ix_(row_idx, col_idx)],
            self.obs.iloc[row_idx].copy(),
            self.var.iloc[col_idx].copy(),
        )
        for k, v in self.obsm.items():
            out.obsm[k] = v[row_idx]
        for k, v in self.obsp.items():
            out.obsp[k] = v[np.ix_(row_idx, row_idx)]
        for k, v in self.varm.items():
            out.varm[k] = v[col_idx]
        return out

    def __repr__(self) -> str:
        parts = [f"AnnData object with n_obs x n_vars = {self.n_obs} x {self.n_vars}"]
        if len(self.obs.columns):
            parts.append(f"    obs: {list(self.obs.columns)}")
        if len(self.obsm):
            parts.append(f"    obsm: {list(self.obsm)}")
        if len(self.obsp):
            parts.append(f"    obsp: {list(self.obsp)}")
        return "\n".join(parts)

    # -- persistence ---------------------------------------------------------
    def write_npz(self, path: str) -> None:
        """Serialize to a flat .npz archive (checkpoint-friendly)."""
        payload: dict[str, np.ndarray] = {
            "X": self._X,
            "obs_names": np.asarray(self.obs_names, dtype=object).astype(str),
            "var_names": np.asarray(self.var_names, dtype=object).astype(str),
        }
        for key, value in self.obsm.items():
            payload[f"obsm:{key}"] = value
        for key, value in self.obsp.items():
            payload[f"obsp:{key}"] = value
        for col in self.obs.columns:
            values = self.obs[col].to_numpy()
            if values.dtype == object:  # keep the archive pickle-free
                values = values.astype(str)
            payload[f"obs:{col}"] = values
        np.savez_compressed(path, **payload)

    def write_h5ad(self, path: str) -> None:
        """Write an anndata-compatible .h5ad file (on-disk spec v0.1.0
        encodings: dataframe groups for obs/var, array groups for obsm/obsp),
        so fitted containers open in the scverse ecosystem."""
        import h5py

        with h5py.File(path, "w") as handle:
            _h5_write_anndata(handle, self)

    @classmethod
    def read_h5ad(cls, path: str) -> "AnnData":
        """Read an .h5ad file written by write_h5ad (or by anndata, for the
        dense-X subset of the format this framework uses)."""
        import h5py

        with h5py.File(path, "r") as handle:
            return _h5_read_anndata(cls, handle)

    @classmethod
    def read_npz(cls, path: str) -> "AnnData":
        with np.load(path, allow_pickle=False) as archive:
            adata = cls(archive["X"])
            adata.obs_names = archive["obs_names"]
            adata.var_names = archive["var_names"]
            for key in archive.files:
                if key.startswith("obsm:"):
                    adata.obsm[key[5:]] = archive[key]
                elif key.startswith("obsp:"):
                    adata.obsp[key[5:]] = archive[key]
                elif key.startswith("obs:"):
                    adata.obs[key[4:]] = archive[key]
        return adata


def concat(adatas: Iterable[AnnData], join: str = "outer") -> AnnData:
    """Concatenate AnnData objects along the observation axis.

    'outer' unions the variable names (missing entries zero-filled), 'inner'
    intersects them, matching the anndata.concat semantics the reference uses
    when stitching given signatures onto initialized ones
    (reference initialization/initialize.py:211-218).
    """
    adatas = list(adatas)
    if join == "inner":
        var_names = list(adatas[0].var_names)
        for a in adatas[1:]:
            keep = set(a.var_names)
            var_names = [v for v in var_names if v in keep]
    else:
        var_names = []
        seen: set[str] = set()
        for a in adatas:
            for v in a.var_names:
                if v not in seen:
                    seen.add(v)
                    var_names.append(v)

    blocks = []
    for a in adatas:
        df = a.to_df()
        block = np.zeros((a.n_obs, len(var_names)), dtype=a.X.dtype)
        pos = {v: j for j, v in enumerate(var_names)}
        cols = [pos[v] for v in a.var_names if v in pos]
        keep_vars = [v for v in a.var_names if v in pos]
        block[:, cols] = df[keep_vars].to_numpy()
        blocks.append(block)

    out = AnnData(np.concatenate(blocks, axis=0))
    out.var_names = var_names
    out.obs_names = np.concatenate([np.asarray(a.obs_names) for a in adatas])

    # keep obs columns present in every input
    shared_cols = set(adatas[0].obs.columns)
    for a in adatas[1:]:
        shared_cols &= set(a.obs.columns)
    for col in shared_cols:
        out.obs[col] = np.concatenate([np.asarray(a.obs[col]) for a in adatas])

    # keep obsm keys present in every input
    shared_obsm = set(adatas[0].obsm)
    for a in adatas[1:]:
        shared_obsm &= set(a.obsm)
    for key in shared_obsm:
        out.obsm[key] = np.concatenate([a.obsm[key] for a in adatas], axis=0)
    return out


class MuData:
    """A container of AnnData modalities over the same samples."""

    def __init__(self, mod: Mapping[str, AnnData]):
        self.mod: dict[str, AnnData] = dict(mod)
        self.obs = pd.DataFrame(index=self._shared_obs_names())
        self.obsm = AxisArrays(lambda: self.n_obs)
        self.obsp = AxisArrays(lambda: self.n_obs, pairwise=True)
        self.uns: dict[str, Any] = {}

    def _shared_obs_names(self) -> pd.Index:
        for adata in self.mod.values():
            if adata.n_obs > 0:
                return adata.obs_names
        return pd.Index([])

    def __getitem__(self, mod_name: str) -> AnnData:
        return self.mod[mod_name]

    @property
    def n_mod(self) -> int:
        return len(self.mod)

    @property
    def mod_names(self) -> list[str]:
        return list(self.mod)

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names) -> None:
        self.obs.index = pd.Index([str(n) for n in names])

    @property
    def n_obs(self) -> int:
        return len(self.obs.index)

    def update(self) -> None:
        """Pull per-modality obs columns into the global obs frame
        (prefixed 'mod:column', mirroring mudata's update())."""
        names = self._shared_obs_names()
        if len(self.obs.index) != len(names) or not self.obs.index.equals(names):
            self.obs = self.obs.reindex(names)
        for mod_name, adata in self.mod.items():
            for col in adata.obs.columns:
                self.obs[f"{mod_name}:{col}"] = np.asarray(adata.obs[col])

    def copy(self) -> "MuData":
        out = MuData({k: v.copy() for k, v in self.mod.items()})
        out.obs = self.obs.copy()
        for key, value in self.obsm.items():
            out.obsm[key] = value.copy()
        for key, value in self.obsp.items():
            out.obsp[key] = value.copy()
        return out

    def write_h5mu(self, path: str) -> None:
        """Write a mudata-compatible .h5mu file (MuData on-disk spec v0.1.0:
        a root 'MuData' group with global obs/obsm/obsp and one anndata-encoded
        group per modality under mod/), so joint multimodal fits open in the
        scverse ecosystem (reference stores its state in mudata.MuData,
        models/mmcorrnmf.py:59-67, but never persists it)."""
        import h5py

        with h5py.File(path, "w") as handle:
            handle.attrs["encoding-type"] = "MuData"
            handle.attrs["encoding-version"] = "0.1.0"
            _h5_write_dataframe(handle, "obs", self.obs)
            # mudata expects a global var frame; ours is the concatenation of
            # the modality var names (disjoint feature spaces)
            var_names = np.concatenate(
                [np.asarray(a.var_names, dtype=object) for a in self.mod.values()]
            ) if self.mod else np.empty((0,), dtype=object)
            _h5_write_dataframe(
                handle, "var", pd.DataFrame(index=pd.Index(var_names))
            )
            _h5_write_mappings(handle, [
                ("obsm", self.obsm), ("obsp", self.obsp),
            ])
            mod_group = handle.create_group("mod")
            mod_group.attrs["encoding-type"] = "dict"
            mod_group.attrs["encoding-version"] = "0.1.0"
            mod_group.attrs.create(
                "mod-order",
                data=np.asarray(list(self.mod), dtype=object),
                dtype=h5py.string_dtype(encoding="utf-8"),
            )
            for name, adata in self.mod.items():
                _h5_write_anndata(mod_group.create_group(name), adata)

    @classmethod
    def read_h5mu(cls, path: str) -> "MuData":
        """Read an .h5mu file written by write_h5mu (or by mudata, for the
        dense-X subset of the format this framework uses)."""
        import h5py

        with h5py.File(path, "r") as handle:
            mod_group = handle["mod"]
            order = [
                n.decode() if isinstance(n, bytes) else str(n)
                for n in mod_group.attrs.get("mod-order", list(mod_group))
            ]
            mods = {
                name: _h5_read_anndata(AnnData, mod_group[name])
                for name in order if name in mod_group
            }
            mdata = cls(mods)
            if "obs" in handle:
                obs = _h5_read_dataframe(handle["obs"])
                if len(obs.index) == mdata.n_obs:
                    mdata.obs = obs
            for mapping_name, mapping in [
                ("obsm", mdata.obsm), ("obsp", mdata.obsp),
            ]:
                if mapping_name in handle:
                    for key in handle[mapping_name]:
                        mapping[key] = np.asarray(
                            handle[mapping_name][key][...]
                        )
        return mdata

    def __repr__(self) -> str:
        lines = [f"MuData object with n_obs = {self.n_obs}, n_mod = {self.n_mod}"]
        for name, adata in self.mod.items():
            lines.append(f"  {name}: {adata.n_obs} x {adata.n_vars}")
        return "\n".join(lines)
