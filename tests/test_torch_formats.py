"""Counts input in the two forms most single-cell data arrives in: a 10x
``.mtx[.gz]`` directory and an ``.h5ad`` file.

- ``load_counts`` on 10x directories (a ``features.tsv`` with symbols, a
  two-column ``genes.tsv``, an id-only ``genes.tsv``; gzipped or not;
  duplicate symbols) equals the JAX package's ``load_counts``: the CSR
  arrays bit for bit and the names.
- h5ad cross-reading both ways, dense and sparse, with
  ``CNMF_H5_COMPRESSION`` off and on: the port reads what the JAX
  package's ``write_h5ad`` wrote and the JAX package reads the port's.
- Without h5py, reading an h5ad raises an ``ImportError`` naming h5py.
- ``prepare`` from ``.mtx`` and from ``.h5ad`` writes bit for bit the
  normalized counts, HVG list and TPM statistics of ``prepare`` from the
  ``.npz`` of the same counts, and matches the JAX package's ``prepare``
  from the same file at the port's golden prepare tolerances
  (``tests/test_torch_pipeline.py``: the HVG list exact, RMS < 1e-4 for the
  TPM statistics, here also for the normalized counts).
"""

import gzip
import os
import sys

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from cnmf_torch_tpu import cNMF as JaxCNMF
from cnmf_torch_tpu import load_df_from_npz as jax_load_df
from cnmf_torch_tpu.utils import anndata_lite as jad
from cnmf_torch_tpu.utils import io as jio
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.utils import anndata_lite as tad
from cnmf_torch_tpu_torch.utils import io as tio
from cnmf_torch_tpu_torch.utils.io import Counts, load_matrix

RMS_TOL = 1e-4


def _counts(n=90, g=140, seed=3):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(4) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(4, g)) * 50.0 / g
    X = rng.poisson(usage @ spectra * 250.0).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1.0
    return X


def _write_10x(d, X, genes_rows, gz, genes_stem="features.tsv"):
    os.makedirs(d, exist_ok=True)
    suffix = ".gz" if gz else ""
    opener = gzip.open if gz else open
    mtx = os.path.join(d, "matrix.mtx")
    scipy.io.mmwrite(mtx, sp.coo_matrix(X.T), field="integer")
    if gz:
        with open(mtx, "rb") as f, gzip.open(mtx + ".gz", "wb") as o:
            o.write(f.read())
        os.unlink(mtx)
    with opener(os.path.join(d, genes_stem + suffix), "wt") as f:
        f.write("".join("\t".join(r) + "\n" for r in genes_rows))
    with opener(os.path.join(d, "barcodes.tsv" + suffix), "wt") as f:
        f.write("".join(f"AAAC-{i}\n" for i in range(X.shape[0])))
    return os.path.join(d, "matrix.mtx" + suffix)


def _gene_rows(g, layout, dup):
    syms = [f"G{j}" for j in range(g)]
    if dup:
        syms[5] = syms[9] = syms[2]
    ids = [f"ENSG{j:05d}" for j in range(g)]
    if layout == "features":
        return [[i, s, "Gene Expression"] for i, s in zip(ids, syms)]
    if layout == "genes2":
        return [[i, s] for i, s in zip(ids, syms)]
    return [[i] for i in ids]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("layout", ["features", "genes2", "genes1"])
def test_load_counts_10x_equals_jax(tmp_path, layout, gz, dup):
    X = _counts()
    fn = _write_10x(str(tmp_path / "tenx"), X,
                    _gene_rows(X.shape[1], layout, dup), gz,
                    "features.tsv" if layout == "features" else "genes.tsv")
    got = tio.load_counts(fn)
    want = jio.load_counts(fn)
    assert sp.isspmatrix_csr(got.X) and sp.isspmatrix_csr(want.X)
    for attr in ("data", "indices", "indptr"):
        a, b = getattr(got.X, attr), getattr(want.X, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert got.X.shape == want.X.shape == X.shape
    assert list(got.var_names) == [str(v) for v in want.var_names]
    assert list(got.obs_names) == [str(v) for v in want.obs_names]
    if layout != "genes1":
        assert list(got.var["gene_ids"]) == list(want.var["gene_ids"])
    np.testing.assert_array_equal(got.X.toarray(), X)
    dense = tio.load_counts(fn, densify=True)
    np.testing.assert_array_equal(dense.X, jio.load_counts(
        fn, densify=True).X)


def test_a_10x_directory_needs_its_sidecars(tmp_path):
    X = _counts(n=10, g=12)
    fn = _write_10x(str(tmp_path / "t"), X, _gene_rows(12, "features",
                                                       False), False)
    os.unlink(tmp_path / "t" / "barcodes.tsv")
    with pytest.raises(FileNotFoundError, match="barcodes"):
        tio.load_counts(fn)
    with pytest.raises(FileNotFoundError, match="matrix.mtx"):
        tio.read_10x_mtx(str(tmp_path))


def _jax_adata(X, sparse):
    import pandas as pd

    n, g = X.shape
    obs = pd.DataFrame({"batch": np.where(np.arange(n) % 2, "a", "b"),
                        "depth": X.sum(1)},
                       index=pd.Index([f"cell{i}" for i in range(n)]))
    var = pd.DataFrame({"gene_ids": [f"ENSG{j}" for j in range(g)]},
                       index=pd.Index([f"G{j}" for j in range(g)]))
    return jad.AnnDataLite(sp.csr_matrix(X) if sparse else X, obs=obs,
                           var=var)


@pytest.mark.parametrize("compression", ["none", "gzip", "lzf"])
@pytest.mark.parametrize("sparse", [True, False])
def test_h5ad_cross_reads_both_ways(tmp_path, monkeypatch, sparse,
                                    compression):
    monkeypatch.setenv("CNMF_H5_COMPRESSION", compression)
    X = _counts(n=30, g=25).astype(np.float32)
    # the JAX package writes, the port reads
    jfn = str(tmp_path / "jax.h5ad")
    jad.write_h5ad(jfn, _jax_adata(X, sparse))
    got = tad.read_h5ad(jfn)
    assert sp.issparse(got.X) == sparse
    np.testing.assert_array_equal(
        got.X.toarray() if sparse else got.X, X)
    assert got.X.dtype == np.float32
    assert list(got.obs_names) == [f"cell{i}" for i in range(30)]
    assert list(got.var_names) == [f"G{j}" for j in range(25)]
    assert list(got.obs["batch"]) == list(np.where(np.arange(30) % 2,
                                                   "a", "b"))
    np.testing.assert_array_equal(got.obs["depth"], X.sum(1))
    assert list(got.var["gene_ids"]) == [f"ENSG{j}" for j in range(25)]
    assert tad.peek_h5ad_shape(jfn) == (30, 25)
    assert tad.peek_h5ad_var_names(jfn) == [f"G{j}" for j in range(25)]
    # the port writes, the JAX package reads
    tfn = str(tmp_path / "port.h5ad")
    tad.write_h5ad(tfn, got)
    back = jad.read_h5ad(tfn)
    np.testing.assert_array_equal(
        back.X.toarray() if sparse else back.X, X)
    assert list(back.obs_names) == list(got.obs_names)
    assert list(back.var_names) == list(got.var_names)
    assert list(back.obs["batch"]) == list(got.obs["batch"])
    assert list(back.var["gene_ids"]) == list(got.var["gene_ids"])
    # and load_counts reads either as the JAX package's load_counts does
    for fn in (jfn, tfn):
        a, b = tio.load_counts(fn), jio.load_counts(fn)
        assert sp.issparse(a.X) == sp.issparse(b.X)
        np.testing.assert_array_equal(
            a.X.toarray() if sparse else a.X,
            b.X.toarray() if sparse else b.X)


def test_h5ad_compression_knob_rejects_unknown_words(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_H5_COMPRESSION", "zstd")
    with pytest.raises(ValueError, match="CNMF_H5_COMPRESSION"):
        tad.write_h5ad(str(tmp_path / "x.h5ad"),
                       Counts(np.ones((2, 2), np.float32),
                              np.asarray(["a", "b"]), np.asarray(["c", "d"])))
    assert not os.path.exists(tmp_path / "x.h5ad")


def test_var_names_make_unique_as_jax():
    names = ["GENE", "GENE-1", "GENE", "X", "X", "X", "GENE"]
    adata = jad.AnnDataLite(np.zeros((1, len(names))))
    import pandas as pd

    adata.var.index = pd.Index(names)
    adata.var_names_make_unique()
    assert list(tad.var_names_make_unique(names)) == list(adata.var_names)


def test_reading_h5ad_without_h5py_names_h5py(tmp_path, monkeypatch):
    fn = str(tmp_path / "c.h5ad")
    tad.write_h5ad(fn, Counts(np.ones((2, 3), np.float32),
                              np.asarray(["a", "b"]),
                              np.asarray(["x", "y", "z"])))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py") as exc:
        tio.load_counts(fn)
    assert fn in str(exc.value)


def _prepare_outputs(obj):
    with open(obj.paths["nmf_genes_list"]) as f:
        hvgs = f.read()
    norm = load_matrix(obj.paths["normalized_counts"])
    with np.load(obj.paths["tpm_stats"], allow_pickle=True) as f:
        stats = {k: f[k] for k in f.files}
    return hvgs, norm, stats


@pytest.fixture(scope="module")
def three_inputs(tmp_path_factory):
    """One counts matrix as ``.df.npz``, a gzipped 10x directory and an
    ``.h5ad``, with the same cell and gene names."""
    d = tmp_path_factory.mktemp("inputs")
    X = _counts(n=120, g=200, seed=8)
    n, g = X.shape
    cells = [f"AAAC-{i}" for i in range(n)]
    genes = [f"G{j}" for j in range(g)]
    npz = str(d / "counts.df.npz")
    save_df_to_npz(Frame(X, np.asarray(cells), np.asarray(genes)), npz)
    mtx = _write_10x(str(d / "tenx"), X,
                     [[f"ENSG{j}", genes[j], "Gene Expression"]
                      for j in range(g)], gz=True)
    h5 = str(d / "counts.h5ad")
    tad.write_h5ad(h5, Counts(sp.csr_matrix(X), np.asarray(cells),
                              np.asarray(genes)))
    return {"npz": npz, "mtx": mtx, "h5ad": h5}


PREP = dict(components=[3], n_iter=2, seed=5, num_highvar_genes=60,
            beta_loss="kullback-leibler")


@pytest.mark.parametrize("kind", ["mtx", "h5ad"])
def test_prepare_from_mtx_and_h5ad_equals_npz_and_jax(tmp_path,
                                                      three_inputs, kind):
    base = cNMF(str(tmp_path), "npz", device="cpu")
    base.prepare(three_inputs["npz"], **PREP)
    obj = cNMF(str(tmp_path), kind, device="cpu")
    obj.prepare(three_inputs[kind], **PREP)
    hv0, n0, st0 = _prepare_outputs(base)
    hv1, n1, st1 = _prepare_outputs(obj)
    assert hv1 == hv0
    for attr in ("data", "indices", "indptr"):
        a, b = getattr(n1.X, attr), getattr(n0.X, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert list(n1.obs_names) == list(n0.obs_names)
    assert list(n1.var_names) == list(n0.var_names)
    for key in st0:
        assert st1[key].dtype == st0[key].dtype
        assert np.array_equal(st1[key], st0[key]), key
    # the JAX package's prepare from the same file
    ref = JaxCNMF(output_dir=str(tmp_path / "jax"), name=kind)
    ref.prepare(three_inputs[kind], **PREP)
    with open(ref.paths["nmf_genes_list"]) as f:
        assert f.read() == hv1
    want = jax_load_df(ref.paths["tpm_stats"])
    got = jax_load_df(obj.paths["tpm_stats"])
    assert list(got.index) == list(want.index)
    assert np.sqrt(np.mean((got.values - want.values) ** 2)) < RMS_TOL
    jnorm = jad.read_h5ad(ref.paths["normalized_counts"])
    assert list(jnorm.var_names) == list(n1.var_names)
    diff = n1.X.toarray() - jnorm.X.toarray()
    assert np.sqrt(np.mean(diff ** 2)) < RMS_TOL


def test_prepare_reads_an_h5ad_tpm_as_stored(tmp_path, three_inputs):
    """``--tpm`` takes the same formats; an h5ad or 10x TPM stays sparse
    even under ``densify`` (the JAX package's rule)."""
    obj = cNMF(str(tmp_path), "tpm", device="cpu")
    obj.prepare(three_inputs["npz"], tpm_fn=three_inputs["h5ad"],
                densify=True, **PREP)
    assert sp.issparse(load_matrix(obj.paths["tpm"]).X)
