"""The port's preprocess sidecar (``models/preprocess.py``) against the
JAX package's on the CPU: the quantile ceiling, ``filter_adata``, the
CITE-seq split, ``preprocess_for_cnmf`` with and without Harmony (the
three files, each ``.h5ad`` read back by JAX's ``read_h5ad``),
``select_features_MI`` against JAX's (which calls scikit-learn), the
hand-off to the port's ``prepare -> consensus``, and the ``Counts``
slicing helper. Inputs are made with numpy from a seed; each tolerance is
stated where it is used."""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.models.preprocess import Preprocess as JaxPreprocess
from cnmf_torch_tpu.models.preprocess import \
    stdscale_quantile_celing as jax_ceiling
from cnmf_torch_tpu.ops.kmeans import kmeans as jax_kmeans
from cnmf_torch_tpu.utils.anndata_lite import AnnDataLite
from cnmf_torch_tpu.utils.anndata_lite import read_h5ad as jax_read_h5ad
from cnmf_torch_tpu_torch import Preprocess, cNMF
from cnmf_torch_tpu_torch.models.preprocess import stdscale_quantile_celing
from cnmf_torch_tpu_torch.ops import harmony as th
from cnmf_torch_tpu_torch.utils.io import Counts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _dense(X):
    return X.toarray() if sp.issparse(X) else np.asarray(X)


def _dataset(seed=3, n=240, g=300, n_adt=20):
    """Low-rank Poisson counts of three donors with a multiplicative donor
    effect per gene, two ``MT-`` genes, two dotted names, and an ADT
    block; as the JAX package's ``AnnDataLite`` and as the port's
    ``Counts``."""
    rng = np.random.default_rng(seed)
    batch = np.tile([0, 1, 2], n // 3)
    usage = rng.dirichlet(np.ones(4) * 0.4, size=n)
    spectra = rng.gamma(0.4, 1.0, size=(4, g)) * 40.0 / g
    effect = rng.lognormal(0.0, 0.5, size=(3, g))
    X = rng.poisson(usage @ spectra * 400.0 * effect[batch]).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1.0
    names = ([f"g{j}" for j in range(g - 4)]
             + ["MT-A", "MT-B", "A.1", "B.2"])
    cells = [f"c{i}" for i in range(n)]
    obs = {"batch": np.asarray([f"d{b}" for b in batch], dtype=object)}
    var = {"feature_types": np.asarray(["Gene Expression"] * (g - n_adt)
                                       + ["Antibody Capture"] * n_adt,
                                       dtype=object)}
    jax = AnnDataLite(sp.csr_matrix(X), obs=pd.DataFrame(obs, index=cells),
                      var=pd.DataFrame(var, index=names))
    port = Counts(sp.csr_matrix(X), np.asarray(cells), np.asarray(names),
                  obs=dict(obs), var=dict(var))
    return jax, port


FILTER = dict(min_cells_per_gene=5, min_counts_per_cell=50,
              filter_mito_genes=True, filter_mito_thresh=0.5)


@pytest.fixture(scope="module")
def filtered():
    jax, port = _dataset()
    return (JaxPreprocess(0).filter_adata(jax, **FILTER),
            Preprocess(0, device="cpu").filter_adata(port, **FILTER))


def test_counts_take_carries_the_annotations():
    c = Counts(np.arange(12.0).reshape(3, 4), np.asarray(["a", "b", "c"]),
               np.asarray(["w", "x", "y", "z"]),
               obs={"o": np.asarray([1, 2, 3])},
               var={"v": np.asarray([4, 5, 6, 7])},
               obsm={"m": np.arange(6).reshape(3, 2)})
    t = c.take(rows=np.asarray([True, False, True]), cols=[3, 1])
    np.testing.assert_array_equal(t.X, [[3.0, 1.0], [11.0, 9.0]])
    assert list(t.obs_names) == ["a", "c"] and list(t.var_names) == ["z",
                                                                     "x"]
    np.testing.assert_array_equal(t.obs["o"], [1, 3])
    np.testing.assert_array_equal(t.var["v"], [7, 5])
    np.testing.assert_array_equal(t.obsm["m"], [[0, 1], [4, 5]])
    with pytest.raises(IndexError):
        c.take(rows=np.asarray([True, False]))


@pytest.mark.parametrize("quantile", [0.99, 0.5])
def test_quantile_ceiling_sparse_matches_dense_and_jax(quantile):
    """The sparse quantile path equals the dense one at rtol 1e-12, and
    both equal JAX's at rtol 1e-12 (f64 scaling)."""
    rng = np.random.default_rng(4)
    X = rng.random((60, 25))
    X[X < 0.6] = 0.0
    got = {}
    for fmt, M in (("dense", X.copy()), ("csr", sp.csr_matrix(X))):
        c = Counts(M, np.arange(60).astype(str), np.arange(25).astype(str))
        got[fmt] = _dense(stdscale_quantile_celing(
            c, quantile_thresh=quantile, device="cpu").X)
        want = _dense(jax_ceiling(AnnDataLite(M.copy()),
                                  quantile_thresh=quantile).X)
        np.testing.assert_allclose(got[fmt], want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got["csr"], got["dense"], rtol=1e-12,
                               atol=1e-14)


def test_quantile_ceiling_refuses_negative_sparse_values():
    X = sp.csr_matrix(np.random.default_rng(5).normal(size=(30, 10)))
    with pytest.raises(ValueError, match="negative"):
        stdscale_quantile_celing(Counts(X, np.arange(30).astype(str),
                                        np.arange(10).astype(str)),
                                 quantile_thresh=0.99, device="cpu")


def test_filter_adata_matches_jax(filtered):
    """The same cells, genes, values and ``n_counts``/``pct_mito``
    columns (exact: integer counts)."""
    jf, tf = filtered
    assert list(tf.obs_names) == list(jf.obs.index)
    assert list(tf.var_names) == list(jf.var.index)
    assert not any("MT-" in v or "." in v for v in tf.var_names)
    assert (tf.X != jf.X).nnz == 0
    np.testing.assert_array_equal(tf.obs["n_counts"], jf.obs["n_counts"])
    np.testing.assert_array_equal(tf.obs["pct_mito"], jf.obs["pct_mito"])
    assert list(tf.obs) == list(jf.obs.columns)


def _jax_kmeans(X, k, n_init=10, max_iter=300, tol=1e-4, seed=1,
                device="cuda"):
    labels, centers, inertia = jax_kmeans(np.asarray(X), k, n_init=n_init,
                                          max_iter=max_iter, seed=seed)
    return np.asarray(labels), np.asarray(centers), float(inertia)


@pytest.mark.parametrize("harmony", [None, "batch"],
                         ids=["no_harmony", "harmony"])
def test_preprocess_for_cnmf_matches_jax(filtered, tmp_path, monkeypatch,
                                         harmony):
    """The CITE-seq split and both lanes against JAX's sidecar (with
    Harmony, the port's k-means init is JAX's, the one draw the packages
    cannot share): the same HVGs; the corrected matrix exactly (no
    Harmony) or within 1e-4 of the largest value (Harmony, f32); the
    TP10K exactly; the RNA block of TP10K summing to 1e4 and the ADT block
    too; the three files written, each ``.h5ad`` read by JAX's
    ``read_h5ad`` with the port's values, columns and ``obsm``."""
    jf, tf = filtered
    if harmony:
        monkeypatch.setattr(th, "kmeans", _jax_kmeans)
    kw = dict(feature_type_col="feature_types", harmony_vars=harmony,
              n_top_rna_genes=100, max_iter_harmony=5)
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    jr, jt, jh = JaxPreprocess(0).preprocess_for_cnmf(
        jf, save_output_base=jbase, **kw)
    tr, tt, hvgs = Preprocess(0, device="cpu").preprocess_for_cnmf(
        tf, save_output_base=tbase, **kw)
    assert hvgs == jh and len(hvgs) == 100
    jX, tX = _dense(jr.X), _dense(tr.X)
    assert tX.dtype == jX.dtype and tX.shape == (len(tf.obs_names), 100)
    if harmony:
        assert (tX >= 0).all()
        np.testing.assert_allclose(tX, jX, rtol=0,
                                   atol=1e-4 * np.abs(jX).max())
    else:
        np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(_dense(tt.X), _dense(jt.X))
    assert list(tt.var_names) == list(jt.var.index)
    n_rna = int((tf.var["feature_types"] != "Antibody Capture").sum())
    T = _dense(tt.X)
    np.testing.assert_allclose(T[:, :n_rna].sum(1), 1e4, rtol=1e-5)
    np.testing.assert_allclose(T[:, n_rna:].sum(1), 1e4, rtol=1e-5)
    for suffix in (".Corrected.HVG.Varnorm.h5ad", ".TP10K.h5ad",
                   ".Corrected.HVGs.txt"):
        assert os.path.exists(tbase + suffix)
    with open(tbase + ".Corrected.HVGs.txt") as f:
        assert f.read().split("\n") == hvgs
    back = jax_read_h5ad(tbase + ".Corrected.HVG.Varnorm.h5ad")
    ref = jax_read_h5ad(jbase + ".Corrected.HVG.Varnorm.h5ad")
    np.testing.assert_array_equal(_dense(back.X), tX)
    assert list(back.var.columns) == list(ref.var.columns)
    assert list(back.obs.columns) == list(ref.obs.columns)
    assert sorted(back.obsm) == sorted(ref.obsm)
    for key in back.obsm:
        np.testing.assert_allclose(back.obsm[key], ref.obsm[key], rtol=0,
                                   atol=1e-3 * np.abs(ref.obsm[key]).max())
    np.testing.assert_array_equal(back.var["highly_variable"].values,
                                  ref.var["highly_variable"].values)
    tp = jax_read_h5ad(tbase + ".TP10K.h5ad")
    np.testing.assert_array_equal(_dense(tp.X), T)
    assert list(tp.var.index) == list(jt.var.index)


def test_preprocess_without_the_split_renames_duplicates():
    """One dense RNA matrix and no feature-type column: duplicate gene
    names are made unique and kept in ``features_renamed``, as JAX does;
    the matrix within rtol 1e-12 of JAX's."""
    rng = np.random.default_rng(6)
    X = rng.poisson(20.0, size=(60, 30)).astype(float)
    names = [f"f{i}" for i in range(29)] + ["f0"]
    jr, _, jh = JaxPreprocess(0).preprocess_for_cnmf(
        AnnDataLite(X.copy(), var=pd.DataFrame(index=names)),
        n_top_rna_genes=10)
    tr, tt, hvgs = Preprocess(0, device="cpu").preprocess_for_cnmf(
        Counts(X.copy(), np.arange(60).astype(str), np.asarray(names)),
        n_top_rna_genes=10)
    assert hvgs == jh
    assert list(tt.var_names) == list(tt.var["features_renamed"])
    assert tt.var_names[-1] == "f0-1"
    # dense moments: f64 sums in another order
    np.testing.assert_allclose(_dense(tr.X), _dense(jr.X), rtol=1e-12)


def test_an_rna_adt_pair_must_share_cells():
    X = np.ones((4, 3))
    rna = Counts(X, np.asarray(["a", "b", "c", "d"]), np.arange(3).astype(str))
    adt = Counts(X, np.asarray(["a", "b", "x", "d"]), np.arange(3).astype(str))
    with pytest.raises(Exception, match="Inconsistency"):
        Preprocess(0, device="cpu").preprocess_for_cnmf([rna, adt])
    with pytest.raises(Exception, match="same number of cells"):
        Preprocess(0, device="cpu").preprocess_for_cnmf([rna, adt.take(
            rows=[0, 1])])


def test_select_features_mi_matches_jax(filtered):
    """MI within 1e-6 of JAX's (scikit-learn's estimator), the same top-20
    set, and the same ranks wherever the MI is positive (ties at zero are
    ordered by pandas' unstable sort there)."""
    jf, tf = filtered
    cluster = np.random.default_rng(7).integers(0, 3, size=len(tf.obs_names))
    jm = JaxPreprocess(0).select_features_MI(jf, cluster, n_top_features=20)
    tm = Preprocess(0, device="cpu").select_features_MI(tf, cluster,
                                                        n_top_features=20)
    np.testing.assert_allclose(tm.var["MI"], jm.var["MI"].values, rtol=0,
                               atol=1e-6)
    top = set(np.asarray(tm.var_names)[tm.var["highly_variable"]])
    assert top == set(jm.var.index[jm.var["highly_variable"].values])
    assert len(top) == 20
    pos = tm.var["MI"] > 0
    np.testing.assert_array_equal(tm.var["MI_Rank"][pos],
                                  jm.var["MI_Rank"].values[pos])
    np.testing.assert_allclose(tm.var["MI_diff"][pos],
                               jm.var["MI_diff"].values[pos], atol=1e-6,
                               equal_nan=True)


def test_preprocess_hands_off_to_prepare_and_consensus(tmp_path):
    """The three files feed the port's ``prepare(counts_fn, tpm_fn,
    genes_file)`` and the run goes through factorize and combine to
    consensus."""
    rng = np.random.default_rng(8)
    n, g = 120, 200
    usage = rng.dirichlet(np.ones(3) * 0.4, size=n)
    spectra = rng.gamma(0.4, 1.0, size=(3, g)) * 40.0 / g
    X = rng.poisson(usage @ spectra * 300.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    counts = Counts(sp.csr_matrix(X), np.asarray([f"c{i}" for i in range(n)]),
                    np.asarray([f"g{j}" for j in range(g)]))
    base = str(tmp_path / "pp")
    rna, tp10k, hvgs = Preprocess(0, device="cpu").preprocess_for_cnmf(
        counts, n_top_rna_genes=100, save_output_base=base)
    assert rna.shape == (n, 100) and len(hvgs) == 100
    assert tp10k.shape == (n, g)
    obj = cNMF(output_dir=str(tmp_path), name="pp_run", device="cpu")
    obj.prepare(base + ".Corrected.HVG.Varnorm.h5ad",
                tpm_fn=base + ".TP10K.h5ad",
                genes_file=base + ".Corrected.HVGs.txt",
                components=[3], n_iter=4, seed=4, batch_size=64,
                max_NMF_iter=50)
    obj.factorize()
    obj.combine()
    obj.consensus(3, density_threshold=2.0, show_clustering=False,
                  build_ref=False)
    assert os.path.exists(obj.paths["consensus_usages"] % (3, "2_0"))


def test_preprocess_writes_figures_into_plot_dir(tmp_path):
    X = np.random.default_rng(9).poisson(10.0, size=(50, 30)).astype(float)
    pp = Preprocess(random_seed=0, plot_dir=str(tmp_path / "plots"),
                    device="cpu")
    pp.filter_adata(Counts(X, np.arange(50).astype(str),
                           np.arange(30).astype(str)),
                    min_cells_per_gene=1, min_counts_per_cell=1,
                    makeplots=True)
    assert [p.name for p in (tmp_path / "plots").glob("*.png")] == [
        "log10_n_counts.png"]
