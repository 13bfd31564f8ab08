"""Artifact serializers and count-matrix loaders, without pandas.

A :class:`Frame` (values, index, columns) stands in for the DataFrame. It is
written in the same ``data``/``index``/``columns`` ``.npz`` container as the
JAX package's ``save_df_to_npz`` (``cnmf_torch_tpu/utils/io.py``), so either
package's ``load_df_from_npz`` reads the other's artifacts. Matrices that
the JAX package keeps as h5ad (normalized counts, TPM) are stored here as a
scipy-style sparse (or dense) ``.npz`` with the row and column names beside
it (:func:`save_matrix` / :func:`load_matrix`).

Counts input in this slice: ``.df.npz`` DataFrames and tab-delimited text.
"""

from __future__ import annotations

import contextlib
import csv
import errno
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

__all__ = ["Frame", "Counts", "atomic_artifact", "check_dir_exists",
           "save_df_to_npz", "save_df_to_text", "load_df_from_npz",
           "load_df_from_text", "save_matrix", "load_matrix", "load_counts"]


@dataclass
class Frame:
    """A labelled 2-D array: ``values`` (rows x columns), ``index`` (row
    labels) and ``columns`` (column labels), all numpy."""

    values: np.ndarray
    index: np.ndarray
    columns: np.ndarray

    def __post_init__(self):
        self.values = np.asarray(self.values)
        self.index = np.asarray(self.index)
        self.columns = np.asarray(self.columns)
        if self.values.shape != (len(self.index), len(self.columns)):
            raise ValueError(
                f"values {self.values.shape} do not match index "
                f"({len(self.index)}) x columns ({len(self.columns)})")

    @property
    def shape(self):
        return self.values.shape

    def column(self, name) -> np.ndarray:
        hits = np.flatnonzero(self.columns == name)
        if hits.size != 1:
            raise KeyError(name)
        return self.values[:, hits[0]]


@dataclass
class Counts:
    """A cells x genes matrix (dense ndarray or scipy CSR) with its cell
    (``obs_names``) and gene (``var_names``) labels."""

    X: object
    obs_names: np.ndarray
    var_names: np.ndarray


@contextlib.contextmanager
def atomic_artifact(path: str):
    """Yield a same-directory temp path; on success ``os.replace`` it onto
    ``path`` so readers never see a half-written artifact."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", dir=d)
    os.close(fd)
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def check_dir_exists(path: str):
    """mkdir -p semantics."""
    try:
        os.makedirs(path)
    except OSError as exc:
        if exc.errno != errno.EEXIST:
            raise


def _label_array(labels) -> np.ndarray:
    a = np.asarray(labels)
    if a.dtype.kind == "O":
        if all(isinstance(v, (int, np.integer)) for v in a):
            return a.astype(np.int64)
        return a.astype(str)
    return a


def save_df_to_npz(obj: Frame, filename: str, compress: bool | None = None):
    """The ``data``/``index``/``columns`` npz container; compressed below
    2 MB of values, stored above (as the JAX serializer does)."""
    if compress is None:
        compress = obj.values.nbytes <= (2 << 20)
    writer = np.savez_compressed if compress else np.savez
    with atomic_artifact(filename) as tmp:
        with open(tmp, "wb") as fh:
            writer(fh, data=obj.values, index=_label_array(obj.index),
                   columns=_label_array(obj.columns))


def load_df_from_npz(filename: str) -> Frame:
    with np.load(filename, allow_pickle=True) as f:
        return Frame(f["data"], f["index"], f["columns"])


def _fmt(v) -> str:
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def save_df_to_text(obj: Frame, filename: str):
    """Tab-delimited text with a header row and the index in column 0."""
    with atomic_artifact(filename) as tmp:
        with open(tmp, "w") as f:
            f.write("\t".join([""] + [_fmt(c) for c in obj.columns]) + "\n")
            for name, row in zip(obj.index, obj.values):
                f.write("\t".join([_fmt(name)] + [_fmt(v) for v in row])
                        + "\n")


def load_df_from_text(filename: str) -> Frame:
    with open(filename, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    header = rows[0][1:]
    index = [r[0] for r in rows[1:]]
    values = np.asarray([[float(v) for v in r[1:]] for r in rows[1:]],
                        dtype=np.float64).reshape(len(index), len(header))
    return Frame(values, np.asarray(index), np.asarray(header))


def save_matrix(filename: str, X, obs_names, var_names):
    """A cells x genes matrix (scipy sparse or dense) plus its names."""
    names = dict(obs_names=np.asarray(obs_names).astype(str),
                 var_names=np.asarray(var_names).astype(str))
    with atomic_artifact(filename) as tmp:
        with open(tmp, "wb") as fh:
            if sp.issparse(X):
                Xc = X.tocsr()
                np.savez(fh, format="csr", data=Xc.data, indices=Xc.indices,
                         indptr=Xc.indptr, shape=np.asarray(Xc.shape),
                         **names)
            else:
                np.savez(fh, format="dense", dense=np.asarray(X), **names)


def load_matrix(filename: str) -> Counts:
    with np.load(filename, allow_pickle=False) as f:
        if str(f["format"]) == "csr":
            X = sp.csr_matrix((f["data"], f["indices"], f["indptr"]),
                              shape=tuple(int(v) for v in f["shape"]))
        else:
            X = f["dense"]
        return Counts(X, f["obs_names"], f["var_names"])


def load_counts(counts_fn: str, densify: bool = False) -> Counts:
    """Extension-dispatched counts loader: ``.npz`` DataFrames (the
    ``save_df_to_npz`` container) and tab-delimited text. The matrix comes
    back as CSR unless ``densify``."""
    if counts_fn.endswith((".h5ad", ".mtx", ".mtx.gz")):
        raise NotImplementedError(
            f"{counts_fn}: .h5ad and .mtx input is not ported yet; convert "
            "to a .df.npz DataFrame or tab-delimited text")
    df = (load_df_from_npz(counts_fn) if counts_fn.endswith(".npz")
          else load_df_from_text(counts_fn))
    X = df.values if densify else sp.csr_matrix(df.values)
    return Counts(X, df.index.astype(str), df.columns.astype(str))
