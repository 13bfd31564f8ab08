"""What the tutorials share: the command line, a text table of a
:class:`~..utils.io.Frame`'s first rows, and the ``.h5ad`` writes, which
fall back to a format the port reads natively on a machine without h5py
(``ROADMAP.md`` D20)."""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import numpy as np

from ..utils.io import Counts, Frame, atomic_artifact, save_df_to_npz


def run_cli(main, doc: str):
    """``python -m ...`` entry: ``[output_dir] [--device DEVICE]``."""
    parser = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    parser.add_argument("output_dir", nargs="?", default=None,
                        help="run directory (default: a new temp dir)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    args = parser.parse_args()
    return main(args.output_dir, device=args.device)


def head_text(frame: Frame, n: int = 5) -> str:
    """The first ``n`` rows as an aligned text table, index first."""
    rows = [[""] + [str(c) for c in frame.columns]]
    rows += [[str(i)] + [str(v) for v in r]
             for i, r in zip(frame.index[:n], frame.values[:n])]
    widths = [max(len(r[j]) for r in rows) for j in range(len(rows[0]))]
    return "\n".join("  ".join(v.rjust(w) for v, w in zip(r, widths))
                     for r in rows)


def have_h5py() -> bool:
    """False only when ``import h5py`` raises ``ImportError``; any other
    error raises."""
    try:
        importlib.import_module("h5py")
    except ImportError:
        return False
    return True


def _say_fallback(h5ad_path: str, written: str):
    print(f"h5py is not installed: wrote {written} in place of {h5ad_path}",
          file=sys.stderr)


def write_10x_trio(out_dir: str, X, barcodes, features, field=None):
    """``X`` (cells x genes) as a 10x directory that Seurat::ReadMtx and
    the port's reader read: ``matrix.mtx`` (genes x cells, through
    ``scipy.io.mmwrite`` with ``field``), ``barcodes.tsv`` and a one-column
    ``features.tsv``. Returns the three paths."""
    import scipy.io
    import scipy.sparse as sp

    os.makedirs(out_dir, exist_ok=True)
    paths = tuple(os.path.join(out_dir, f)
                  for f in ("matrix.mtx", "barcodes.tsv", "features.tsv"))
    scipy.io.mmwrite(paths[0], sp.csc_matrix(X.T), field=field)
    for path, labels in zip(paths[1:], (barcodes, features)):
        with atomic_artifact(path) as tmp:
            with open(tmp, "w") as f:
                f.write("\n".join(map(str, labels)) + "\n")
    return paths


def write_counts(h5ad_path: str, counts: Counts) -> str:
    """Integer counts as ``h5ad_path``, or without h5py as the 10x
    directory ``<stem>_10x/`` beside it (``matrix.mtx``, read through the
    port's native reader). Returns the path ``prepare`` takes."""
    if have_h5py():
        from ..utils.anndata_lite import write_h5ad

        write_h5ad(h5ad_path, counts)
        return h5ad_path
    import scipy.sparse as sp

    X = sp.csr_matrix(counts.X)
    if not np.array_equal(X.data, np.round(X.data)) or (X.data < 0).any():
        raise ValueError(f"{h5ad_path}: a 10x matrix holds non-negative "
                         "integer counts")
    mtx = write_10x_trio(h5ad_path[:-len(".h5ad")] + "_10x", X,
                         counts.obs_names, counts.var_names,
                         field="integer")[0]
    _say_fallback(h5ad_path, mtx)
    return mtx


def npz_in_place_of_h5ad(h5ad_path: str, counts: Counts) -> str:
    """On a machine without h5py: a float matrix (the preprocess sidecar's
    hand-off) as a dense ``.df.npz`` beside ``h5ad_path`` (the port's own
    frame container), said on stderr. Returns the path ``prepare``
    takes."""
    import scipy.sparse as sp

    X = counts.X.toarray() if sp.issparse(counts.X) else np.asarray(counts.X)
    path = h5ad_path[:-len(".h5ad")] + ".df.npz"
    save_df_to_npz(Frame(X, counts.obs_names, counts.var_names), path)
    _say_fallback(h5ad_path, path)
    return path


def ensure_dir(output_dir, prefix: str) -> str:
    import tempfile

    output_dir = output_dir or tempfile.mkdtemp(prefix=prefix)
    os.makedirs(output_dir, exist_ok=True)
    return output_dir
