"""h5ad (AnnData on HDF5) input and output, without pandas or anndata.

Own copy of the JAX package's ``cnmf_torch_tpu/utils/anndata_lite.py``,
carried onto the port's :class:`~.io.Counts`: ``X`` (dense, or CSR/CSC on
disk read back as CSR), the ``obs``/``var`` indices as ``obs_names`` /
``var_names``, their string, numeric, categorical and nullable columns as
plain dicts of numpy arrays (``Counts.obs`` / ``Counts.var``) and the
dense ``obsm`` arrays. The files it writes follow the same subset of the
AnnData on-disk spec (the ``anndata`` 0.1.0 encoding), so either package
(and anndata itself) reads the other's.

``h5py`` is imported inside the functions that need it, through
``importlib``: a machine without it imports this module, and reading or
writing an ``.h5ad`` there raises an ``ImportError`` that names h5py and
the file. The port's own intermediates stay ``.npz`` (``utils/paths.py``);
this module is the h5ad input of ``load_counts`` and a writer for the
interop tests.

``CNMF_H5_COMPRESSION`` (``none``, the default, ``gzip`` at level 1 or
``lzf``) compresses the written ``X``, as in the JAX package.
"""

from __future__ import annotations

import importlib

import numpy as np
import scipy.sparse as sp

from .io import Counts, atomic_artifact

__all__ = ["read_h5ad", "write_h5ad", "peek_h5ad_shape",
           "peek_h5ad_var_names", "var_names_make_unique"]


def _h5py(filename: str):
    try:
        return importlib.import_module("h5py")
    except ImportError as exc:
        raise ImportError(
            f"{filename}: reading or writing .h5ad needs the h5py package, "
            "which is not installed; convert the counts to a .df.npz "
            "DataFrame, tab-delimited text or a 10x .mtx directory") from exc


def var_names_make_unique(names, join: str = "-") -> np.ndarray:
    """anndata's deduplication: a repeated name's later occurrences get
    ``name{join}{i}`` (i = 1, 2, ...), skipping any suffixed name already
    present (``['GENE', 'GENE-1', 'GENE']`` -> ``['GENE', 'GENE-1',
    'GENE-2']``)."""
    names = [str(v) for v in names]
    existing = set(names)
    seen: dict[str, int] = {}
    out = []
    for name in names:
        if name in seen:
            i = seen[name] + 1
            while f"{name}{join}{i}" in existing:
                i += 1
            seen[name] = i
            cand = f"{name}{join}{i}"
            existing.add(cand)
            out.append(cand)
        else:
            seen[name] = 0
            out.append(name)
    return np.asarray(out)


# -- writing -----------------------------------------------------------------

def _write_string_array(h5py, group, name, values):
    ds = group.create_dataset(name, data=np.asarray(values, dtype=object),
                              dtype=h5py.string_dtype(encoding="utf-8"))
    ds.attrs["encoding-type"] = "string-array"
    ds.attrs["encoding-version"] = "0.2.0"
    return ds


def _write_dataframe(h5py, parent, name: str, index, columns: dict):
    g = parent.create_group(name)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["_index"] = "_index"
    g.attrs["column-order"] = (
        np.asarray(list(columns), dtype=object) if columns
        else np.asarray([], dtype=h5py.string_dtype(encoding="utf-8")))
    _write_string_array(h5py, g, "_index", np.asarray(index).astype(str))
    for col, vals in columns.items():
        vals = np.asarray(vals)
        if vals.dtype.kind in "OUS":
            _write_string_array(h5py, g, str(col), vals.astype(str))
        else:
            ds = g.create_dataset(str(col), data=vals)
            ds.attrs["encoding-type"] = "array"
            ds.attrs["encoding-version"] = "0.2.0"


def _x_compression() -> dict:
    """``CNMF_H5_COMPRESSION``: ``none`` (default, as anndata writes),
    ``gzip`` (level 1) or ``lzf``; anything else raises."""
    from .envknobs import env_str

    mode = env_str("CNMF_H5_COMPRESSION", "none").lower()
    if mode in ("", "none", "0", "off", "false"):
        return {}
    if mode == "lzf":
        return {"compression": "lzf"}
    if mode == "gzip":
        return {"compression": "gzip", "compression_opts": 1}
    raise ValueError(
        f"CNMF_H5_COMPRESSION={mode!r} not recognized; use 'none', 'gzip', "
        "or 'lzf'")


def _write_X(parent, X):
    comp = _x_compression()
    if sp.issparse(X):
        X = X.tocsr()
        g = parent.create_group("X")
        g.attrs["encoding-type"] = "csr_matrix"
        g.attrs["encoding-version"] = "0.1.0"
        g.attrs["shape"] = np.asarray(X.shape, dtype=np.int64)
        g.create_dataset("data", data=X.data, **comp)
        g.create_dataset("indices", data=X.indices, **comp)
        g.create_dataset("indptr", data=X.indptr, **comp)
    else:
        ds = parent.create_dataset("X", data=np.asarray(X), **comp)
        ds.attrs["encoding-type"] = "array"
        ds.attrs["encoding-version"] = "0.2.0"


def write_h5ad(filename: str, counts: Counts):
    """Write ``counts`` as an h5ad file, atomically (a temp file renamed
    into place), then call the fault harness's torn-file hook as every
    artifact writer of the port does."""
    from ..runtime.faults import maybe_tear

    h5py = _h5py(filename)
    with atomic_artifact(filename) as tmp:
        with h5py.File(tmp, "w") as f:
            f.attrs["encoding-type"] = "anndata"
            f.attrs["encoding-version"] = "0.1.0"
            _write_X(f, counts.X)
            _write_dataframe(h5py, f, "obs", counts.obs_names, counts.obs)
            _write_dataframe(h5py, f, "var", counts.var_names, counts.var)
            for aux in ("uns", "obsm", "varm", "obsp", "varp", "layers"):
                g = f.create_group(aux)
                g.attrs["encoding-type"] = "dict"
                g.attrs["encoding-version"] = "0.1.0"
            for key, val in counts.obsm.items():
                ds = f["obsm"].create_dataset(key, data=np.asarray(val))
                ds.attrs["encoding-type"] = "array"
                ds.attrs["encoding-version"] = "0.2.0"
    maybe_tear(filename)


# -- reading -----------------------------------------------------------------

def _decode(v):
    return v.decode("utf-8") if isinstance(v, bytes) else v


def _read_array_like(h5py, node):
    """A dataset, or an encoded group (categorical, nullable integer or
    boolean), as a 1-D numpy array (object dtype for strings and for
    nullable columns, whose masked entries are ``None``)."""
    if isinstance(node, h5py.Dataset):
        vals = node[()]
        if vals.dtype.kind in "OS":
            vals = np.asarray([_decode(v) for v in vals], dtype=object)
        return vals
    enc = _decode(node.attrs.get("encoding-type", ""))
    if enc == "categorical":
        codes = np.asarray(node["codes"][()])
        cats = np.asarray(_read_array_like(h5py, node["categories"]),
                          dtype=object)
        out = np.empty(codes.shape, dtype=object)
        ok = codes >= 0
        out[ok] = cats[codes[ok]]
        out[~ok] = None
        return out
    if enc in ("nullable-integer", "nullable-boolean"):
        arr = node["values"][()].astype(object)
        arr[node["mask"][()].astype(bool)] = None
        return arr
    raise ValueError(f"unsupported h5ad column encoding: {enc!r}")


def _read_dataframe(h5py, g):
    """``(index, {column: values})`` of an encoded dataframe group."""
    index_name = _decode(g.attrs.get("_index", "_index"))
    index = np.asarray([str(v) for v in _read_array_like(h5py,
                                                         g[index_name])])
    cols = {}
    for col in (_decode(c) for c in g.attrs.get("column-order", [])):
        if col in g:
            cols[col] = _read_array_like(h5py, g[col])
    return index, cols


def _read_X(h5py, node):
    if isinstance(node, h5py.Dataset):
        return node[()]
    enc = _decode(node.attrs.get("encoding-type", ""))
    shape = tuple(int(s) for s in node.attrs["shape"])
    data = node["data"][()]
    indices = node["indices"][()]
    indptr = node["indptr"][()]
    if enc == "csr_matrix":
        return sp.csr_matrix((data, indices, indptr), shape=shape)
    if enc == "csc_matrix":
        return sp.csc_matrix((data, indices, indptr), shape=shape).tocsr()
    raise ValueError(f"unsupported X encoding: {enc!r}")


def read_h5ad(filename: str) -> Counts:
    """An h5ad file as :class:`Counts`: ``X`` dense or CSR as stored, the
    names from the ``obs``/``var`` indices (``"0", "1", ...`` when a group
    is absent), their columns, and the dense ``obsm`` entries."""
    h5py = _h5py(filename)
    with h5py.File(filename, "r") as f:
        X = _read_X(h5py, f["X"])
        n, g = X.shape
        obs_names, obs = (_read_dataframe(h5py, f["obs"]) if "obs" in f
                          else (np.asarray([str(i) for i in range(n)]), {}))
        var_names, var = (_read_dataframe(h5py, f["var"]) if "var" in f
                          else (np.asarray([str(j) for j in range(g)]), {}))
        obsm = {}
        if "obsm" in f:
            for key, node in f["obsm"].items():
                if isinstance(node, h5py.Dataset):
                    obsm[key] = node[()]
    if len(obs_names) != n or len(var_names) != g:
        raise ValueError(
            f"{filename}: obs/var ({len(obs_names)}, {len(var_names)}) do "
            f"not match X {X.shape}")
    return Counts(X, obs_names, var_names, obs=obs, var=var, obsm=obsm)


def peek_h5ad_shape(filename: str) -> tuple[int, int]:
    """``X``'s (n_obs, n_var) from the file's metadata alone."""
    h5py = _h5py(filename)
    with h5py.File(filename, "r") as f:
        node = f["X"]
        if isinstance(node, h5py.Dataset):
            return tuple(int(s) for s in node.shape)
        return tuple(int(s) for s in node.attrs["shape"])


def peek_h5ad_var_names(filename: str):
    """The var (gene) index from the file's metadata alone, or ``None``
    when the file has no ``var`` group."""
    h5py = _h5py(filename)
    with h5py.File(filename, "r") as f:
        if "var" not in f:
            return None
        g = f["var"]
        index_name = _decode(g.attrs.get("_index", "_index"))
        return [str(_decode(v)) for v in _read_array_like(h5py,
                                                          g[index_name])]
