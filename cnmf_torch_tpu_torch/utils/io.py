"""Artifact serializers and count-matrix loaders, without pandas.

A :class:`Frame` (values, index, columns) stands in for the DataFrame. It is
written in the same ``data``/``index``/``columns`` ``.npz`` container as the
JAX package's ``save_df_to_npz`` (``cnmf_torch_tpu/utils/io.py``), so either
package's ``load_df_from_npz`` reads the other's artifacts. Matrices that
the JAX package keeps as h5ad (normalized counts, TPM) are stored here as a
scipy-style sparse (or dense) ``.npz`` with the row and column names beside
it (:func:`save_matrix` / :func:`load_matrix`).

Counts input (:func:`load_counts`): ``.df.npz`` DataFrames, tab-delimited
text, a 10x-Genomics ``.mtx[.gz]`` directory (:func:`read_10x_mtx`, through
the native reader of ``native/``) and ``.h5ad`` (``utils/anndata_lite.py``,
on a machine with h5py).

Each labelled-matrix writer (:func:`save_df_to_npz`, :func:`save_df_to_text`,
:func:`save_matrix`) calls the fault harness's torn-file hook after its
atomic write lands, as the JAX package's writers do; it is a no-op unless
``CNMF_TPU_FAULT_SPEC`` holds a ``torn`` clause.
"""

from __future__ import annotations

import contextlib
import csv
import errno
import gzip
import os
import tempfile
import zipfile
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..runtime.faults import maybe_tear

__all__ = ["Frame", "Counts", "atomic_artifact", "check_dir_exists",
           "save_df_to_npz", "save_df_to_text", "load_df_from_npz",
           "load_df_from_text", "save_matrix", "load_matrix", "peek_matrix",
           "read_10x_mtx", "load_counts"]


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
    (``obs_names``) and gene (``var_names``) labels, and the annotation
    columns an h5ad or 10x input carries (``obs`` / ``var``: column name ->
    1-D array; ``obsm``: name -> per-cell matrix)."""

    X: object
    obs_names: np.ndarray
    var_names: np.ndarray
    obs: dict = field(default_factory=dict)
    var: dict = field(default_factory=dict)
    obsm: dict = field(default_factory=dict)

    @property
    def shape(self):
        return self.X.shape

    def take(self, rows=None, cols=None) -> "Counts":
        """The cells ``rows`` and genes ``cols`` (boolean masks or
        positions; ``None`` keeps all) as a new :class:`Counts`, with the
        ``obs``/``obsm`` rows and ``var`` entries carried along."""
        n, g = self.X.shape
        r = np.arange(n) if rows is None else _positions_of(rows, n)
        c = np.arange(g) if cols is None else _positions_of(cols, g)
        X = self.X[r][:, c]
        return Counts(X, np.asarray(self.obs_names)[r],
                      np.asarray(self.var_names)[c],
                      obs={k: np.asarray(v)[r] for k, v in self.obs.items()},
                      var={k: np.asarray(v)[c] for k, v in self.var.items()},
                      obsm={k: np.asarray(v)[r]
                            for k, v in self.obsm.items()})


def _positions_of(sel, length: int) -> np.ndarray:
    sel = np.asarray(sel)
    if sel.dtype == bool:
        if sel.shape != (length,):
            raise IndexError(f"boolean mask of {sel.shape} for an axis of "
                             f"{length}")
        return np.flatnonzero(sel)
    return sel.astype(np.int64)


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
    maybe_tear(filename)


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
    maybe_tear(filename)


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
    maybe_tear(filename)


def load_matrix(filename: str) -> Counts:
    with np.load(filename, allow_pickle=False) as f:
        if str(f["format"]) == "csr":
            X = sp.csr_matrix((f["data"], f["indices"], f["indptr"]),
                              shape=tuple(int(v) for v in f["shape"]))
        else:
            X = f["dense"]
        return Counts(X, f["obs_names"], f["var_names"])


def peek_matrix(filename: str):
    """``(shape, var_names)`` of a :func:`save_matrix` file without
    reading its values (a dense matrix's shape from its ``.npy`` header)."""
    with np.load(filename, allow_pickle=False) as f:
        var = f["var_names"]
        if str(f["format"]) == "csr":
            return tuple(int(v) for v in f["shape"]), var
    with zipfile.ZipFile(filename) as z, z.open("dense.npy") as fh:
        fmt = np.lib.format
        read = (fmt.read_array_header_1_0
                if fmt.read_magic(fh) == (1, 0)
                else fmt.read_array_header_2_0)
        shape, _, _ = read(fh)
    return tuple(int(v) for v in shape), var


def _find_10x_sidecar(counts_dir: str, stems) -> str | None:
    for stem in stems:
        for suffix in ("", ".gz"):
            p = os.path.join(counts_dir, stem + suffix)
            if os.path.exists(p):
                return p
    return None


def _read_tsv(path: str) -> list[list[str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        return [row for row in csv.reader(f, delimiter="\t") if row]


def read_10x_mtx(path: str) -> Counts:
    """A 10x-Genomics directory: ``matrix.mtx[.gz]`` (genes x cells on
    disk), ``features.tsv[.gz]`` or ``genes.tsv[.gz]``, and
    ``barcodes.tsv[.gz]``, as cells x genes CSR with f64 values (the JAX
    package's ``read_10x_mtx``). Gene names come from the symbol column
    when the features file has one, else from the id column (then also
    ``var["gene_ids"]``); the matrix goes through ``native.read_mtx``."""
    from ..native import read_mtx

    mtx_fn = _find_10x_sidecar(path, ["matrix.mtx"])
    if mtx_fn is None:
        raise FileNotFoundError(f"no matrix.mtx[.gz] in {path}")
    X = read_mtx(mtx_fn).T.tocsr()
    genes_fn = _find_10x_sidecar(path, ["features.tsv", "genes.tsv"])
    barcodes_fn = _find_10x_sidecar(path, ["barcodes.tsv"])
    if genes_fn is None or barcodes_fn is None:
        raise FileNotFoundError(
            f"missing features/genes or barcodes tsv in {path}")
    genes = _read_tsv(genes_fn)
    barcodes = _read_tsv(barcodes_fn)
    with_symbols = len(genes[0]) > 1 if genes else False
    var_names = np.asarray([r[1] if with_symbols else r[0] for r in genes])
    var = ({"gene_ids": np.asarray([r[0] for r in genes], dtype=object)}
           if with_symbols else {})
    obs_names = np.asarray([r[0] for r in barcodes])
    if X.shape != (len(obs_names), len(var_names)):
        raise ValueError(
            f"{path}: matrix {X.shape[::-1]} (genes x cells) does not match "
            f"{len(var_names)} features x {len(obs_names)} barcodes")
    return Counts(X, obs_names, var_names, var=var)


def load_counts(counts_fn: str, densify: bool = False) -> Counts:
    """Extension-dispatched counts loader (the JAX package's): ``.h5ad``
    (its ``X`` as stored), ``.mtx`` / ``.mtx.gz`` (the 10x directory that
    holds the file), ``.npz`` DataFrames (the ``save_df_to_npz`` container)
    and tab-delimited text. A sparse matrix comes back as CSR unless
    ``densify``; an npz or text matrix is made CSR unless ``densify``."""
    if counts_fn.endswith(".h5ad"):
        from .anndata_lite import read_h5ad

        counts = read_h5ad(counts_fn)
    elif counts_fn.endswith((".mtx", ".mtx.gz")):
        counts = read_10x_mtx(os.path.dirname(counts_fn))
    else:
        df = (load_df_from_npz(counts_fn) if counts_fn.endswith(".npz")
              else load_df_from_text(counts_fn))
        X = df.values if densify else sp.csr_matrix(df.values)
        return Counts(X, df.index.astype(str), df.columns.astype(str))
    if sp.issparse(counts.X) and densify:
        counts.X = np.asarray(counts.X.todense())
    return counts
