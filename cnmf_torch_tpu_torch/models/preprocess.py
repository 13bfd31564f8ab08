"""The preprocess sidecar: QC filtering, normalization, batch correction.

Port of ``cnmf_torch_tpu/models/preprocess.py`` on the port's
:class:`~..utils.io.Counts` (``obs``/``var``/``obsm`` dicts in place of
AnnData's frames). It writes the three files ``cNMF.prepare`` reads: the
HVG-filtered, variance-normalized and optionally Harmony-corrected RNA
counts, the library-size-normalized TP10K (RNA, and a CITE-seq run's ADT
block normalized on its own and hstacked back) and the HVG list. Row
totals, TP10K and the unit-variance scaling are ``ops/stats.py``; the
seurat_v3 HVGs, PCA, Harmony with its gene-space MOE ridge and the
mutual-information ranking run in torch on ``device``
(``ops/seurat_v3.py``, ``ops/pca.py``, ``ops/harmony.py``,
``ops/mutual_info.py``).

``save_output_base`` writes ``.h5ad`` files (``utils/anndata_lite.py``),
which needs h5py; without it the write raises an ``ImportError`` naming
h5py. Figures (``makeplots=True``) follow the plots' rule: skipped with a
warning that names them when matplotlib is missing (``ROADMAP.md`` D17).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..ops.harmony import _moe_ridge, _ridge_matrix, run_harmony
from ..ops.mutual_info import mutual_info_classif
from ..ops.pca import pca
from ..ops.seurat_v3 import seurat_v3_hvg
from ..ops.stats import normalize_total, row_sums, scale_columns
from ..utils.anndata_lite import var_names_make_unique, write_h5ad
from ..utils.io import Counts, atomic_artifact
from . import plots

__all__ = ["Preprocess", "stdscale_quantile_celing"]


def stdscale_quantile_celing(_adata: Counts, max_value=None,
                             quantile_thresh=None, device="cuda") -> Counts:
    """Unit-variance scaling without centering (ddof 1, zero-variance genes
    unchanged), then a ceiling at ``max_value`` and at the
    ``quantile_thresh`` quantile of the whole matrix, implicit zeros
    included. Sets ``_adata.X`` and returns ``_adata``; the name keeps the
    reference's spelling."""
    X, _ = scale_columns(_adata.X, ddof=1, zero_std_to_one=True,
                         device=resolve_device(device))
    if max_value is not None:
        if sp.issparse(X):
            X.data[X.data > max_value] = max_value
        else:
            X[X > max_value] = max_value
    if quantile_thresh is not None:
        if sp.issparse(X):
            # the quantile of the dense value distribution without
            # densifying: the implicit zeros shift the position. This
            # assumes no stored value is negative (scaled counts).
            nnz_vals = np.sort(X.tocsr().data)
            if nnz_vals.size and nnz_vals[0] < 0:
                raise ValueError(
                    "stdscale_quantile_celing: sparse input contains "
                    "negative values; the sparse quantile path assumes "
                    "nonnegative data (densify first for signed data)")
            n_total = X.shape[0] * X.shape[1]
            pos = quantile_thresh * (n_total - 1)
            n_zeros = n_total - len(nnz_vals)

            def dense_val(i):
                return 0.0 if i < n_zeros else nnz_vals[int(i - n_zeros)]

            lo, hi = int(np.floor(pos)), int(np.ceil(pos))
            frac = pos - lo
            threshval = dense_val(lo) * (1 - frac) + dense_val(hi) * frac
            X.data[X.data > threshval] = threshval
        else:
            threshval = np.quantile(np.asarray(X).reshape(-1),
                                    quantile_thresh)
            X[X > threshval] = threshval
    _adata.X = X
    return _adata


def _dense(X) -> np.ndarray:
    return X.toarray() if sp.issparse(X) else np.asarray(X)


def _concat_columns(a: dict, b: dict, na: int, nb: int) -> dict:
    """Two annotation dicts stacked row-wise; a column missing on one side
    is filled with NaN there (``pd.concat``'s union)."""
    out = {}
    for col in list(a) + [c for c in b if c not in a]:
        parts = [np.asarray(d[col]) if col in d
                 else np.full(n, np.nan, dtype=object)
                 for d, n in ((a, na), (b, nb))]
        out[col] = np.concatenate(parts)
    return out


class Preprocess:
    """The optional upstream pipeline that writes the three files
    ``prepare()`` reads (counts, TPM and genes)."""

    def __init__(self, random_seed=None, plot_dir=None, device="cuda"):
        """``plot_dir``: where ``makeplots=True`` figures are saved as PNGs;
        with ``None`` they stay open on the pyplot stack for the caller.
        ``random_seed`` seeds Harmony's k-means and permutations and the
        mutual-information jitter (0 when ``None``)."""
        self.device = resolve_device(device)
        self.random_seed = 0 if random_seed is None else int(random_seed)
        self.plot_dir = plot_dir

    def _normalized(self, c: Counts, target_sum) -> Counts:
        return Counts(normalize_total(c.X, target_sum, device=self.device),
                      c.obs_names, c.var_names, obs=dict(c.obs),
                      var=dict(c.var))

    # ------------------------------------------------------------------

    def filter_adata(self, _adata: Counts, filter_mito_thresh=None,
                     min_cells_per_gene=10, min_counts_per_cell=500,
                     filter_mito_genes=False, filter_dot_genes=True,
                     makeplots=False) -> Counts:
        """QC filter: genes by the cells they occur in, cells by their
        counts (``obs["n_counts"]``), optionally cells by their
        mitochondrial fraction (genes named ``MT-``, ``obs["pct_mito"]``),
        and optionally the mitochondrial genes and the genes with a dot in
        their name."""
        X = _adata.X
        if min_cells_per_gene is not None:
            if sp.issparse(X):
                cells_per_gene = np.asarray((X > 0).sum(axis=0)).ravel()
            else:
                cells_per_gene = (np.asarray(X) > 0).sum(axis=0)
            _adata = _adata.take(cols=cells_per_gene >= min_cells_per_gene)

        _adata.obs = dict(_adata.obs)
        _adata.obs["n_counts"] = row_sums(_adata.X, device=self.device)
        if makeplots:
            self._hist(np.log10(np.maximum(_adata.obs["n_counts"], 1)),
                       "log10 n_counts")

        if min_counts_per_cell is not None:
            _adata = _adata.take(
                rows=_adata.obs["n_counts"] >= min_counts_per_cell)

        names = [str(x) for x in _adata.var_names]
        mt = np.asarray(["MT-" in x for x in names], dtype=bool)
        if filter_mito_thresh is not None:
            num_mito = (row_sums(_adata.take(cols=mt).X, device=self.device)
                        if mt.any() else np.zeros(_adata.shape[0]))
            pct_mito = num_mito / _adata.obs["n_counts"]
            _adata.obs = dict(_adata.obs)
            _adata.obs["pct_mito"] = pct_mito
            if makeplots:
                self._hist(pct_mito, "pct_mito")
            _adata = _adata.take(rows=pct_mito < filter_mito_thresh)

        drop = np.zeros(len(names), dtype=bool)
        if filter_dot_genes:
            drop |= np.asarray(["." in x for x in names], dtype=bool)
        if filter_mito_genes:
            drop |= mt
        return _adata.take(cols=~drop)

    # ------------------------------------------------------------------

    def preprocess_for_cnmf(self, _adata, feature_type_col=None,
                            adt_feature_name="Antibody Capture",
                            harmony_vars=None, n_top_rna_genes=2000,
                            librarysize_targetsum=1e4,
                            max_scaled_thresh=None, quantile_thresh=0.9999,
                            makeplots=False, theta=1,
                            save_output_base=None, max_iter_harmony=20):
        """HVG-filtered, variance-normalized, optionally Harmony-corrected
        RNA counts and the library-size-normalized (RNA [+ADT]) TP10K.
        ``_adata`` is one :class:`Counts` (split on ``feature_type_col``
        when given) or an ``(RNA, ADT)`` pair. Returns ``(adata_RNA, tp10k,
        hvgs)``; ``save_output_base`` also writes
        ``<base>.Corrected.HVG.Varnorm.h5ad``, ``<base>.TP10K.h5ad`` and
        ``<base>.Corrected.HVGs.txt``."""
        if isinstance(_adata, Counts) and feature_type_col is not None:
            ft = np.asarray(_adata.var[feature_type_col])
            adata_ADT = _adata.take(cols=ft == adt_feature_name)
            adata_RNA = _adata.take(cols=ft != adt_feature_name)
        elif isinstance(_adata, Counts):
            adata_RNA = _adata
            adata_RNA.var_names = var_names_make_unique(adata_RNA.var_names)
            adata_RNA.var = dict(adata_RNA.var)
            adata_RNA.var["features_renamed"] = np.asarray(
                adata_RNA.var_names, dtype=object)
            adata_ADT = None
        elif len(_adata) == 2:
            adata_RNA, adata_ADT = _adata[0], _adata[1]
            if adata_ADT.shape[0] != adata_RNA.shape[0]:
                raise Exception(
                    "ADT and RNA AnnDatas don't have the same number of cells")
            if np.any(np.asarray(adata_ADT.obs_names)
                      != np.asarray(adata_RNA.obs_names)):
                raise Exception(
                    "Inconsistency of the index for the ADT and RNA AnnDatas")
        else:
            raise Exception("data should either be an AnnData object or a "
                            "list of 2 AnnData objects")

        tp10k = self._normalized(adata_RNA, librarysize_targetsum)
        adata_RNA, hvgs = self.normalize_batchcorrect(
            adata_RNA, harmony_vars=harmony_vars,
            n_top_genes=n_top_rna_genes,
            librarysize_targetsum=librarysize_targetsum,
            max_scaled_thresh=max_scaled_thresh,
            quantile_thresh=quantile_thresh, theta=theta,
            makeplots=makeplots, max_iter_harmony=max_iter_harmony)

        if adata_ADT is not None:
            where = {str(v): i for i, v in enumerate(adata_ADT.obs_names)}
            adata_ADT = adata_ADT.take(rows=[where[str(v)] for v in
                                             adata_RNA.obs_names])
            adata_ADT = self._normalized(adata_ADT, librarysize_targetsum)
            merge_var = _concat_columns(tp10k.var, adata_ADT.var,
                                        tp10k.shape[1], adata_ADT.shape[1])
            if sp.issparse(tp10k.X) or sp.issparse(adata_ADT.X):
                Xm = sp.hstack([sp.csr_matrix(tp10k.X),
                                sp.csr_matrix(adata_ADT.X)]).tocsr()
            else:
                Xm = np.hstack([tp10k.X, adata_ADT.X])
            tp10k = Counts(Xm, tp10k.obs_names,
                           np.concatenate([np.asarray(tp10k.var_names),
                                           np.asarray(adata_ADT.var_names)]),
                           obs=tp10k.obs, var=merge_var)

        if save_output_base is not None:
            write_h5ad(save_output_base + ".Corrected.HVG.Varnorm.h5ad",
                       adata_RNA)
            write_h5ad(save_output_base + ".TP10K.h5ad", tp10k)
            with atomic_artifact(
                    save_output_base + ".Corrected.HVGs.txt") as tmp:
                with open(tmp, "w") as f:
                    f.write("\n".join(hvgs))

        return adata_RNA, tp10k, hvgs

    # ------------------------------------------------------------------

    def normalize_batchcorrect(self, _adata: Counts,
                               normalize_librarysize=False,
                               harmony_vars=None, n_top_genes=None,
                               librarysize_targetsum=1e4,
                               max_scaled_thresh=None,
                               quantile_thresh=0.9999, theta=1,
                               makeplots=False, max_iter_harmony=20):
        """seurat_v3 HVGs on the raw counts, unit-variance scaling with the
        quantile ceiling, and with ``harmony_vars`` the PCA of the scaled
        TP10K handed to Harmony, whose MOE ridge then corrects the gene
        matrix itself, negatives clipped to zero. Returns ``(counts,
        hvgs)``."""
        dev = self.device
        if n_top_genes is not None:
            hvg_stats = seurat_v3_hvg(_adata.X, n_top_genes=n_top_genes,
                                      device=dev)
            _adata.var = dict(_adata.var)
            _adata.var.update(hvg_stats)
        elif "highly_variable" not in _adata.var:
            raise Exception(
                "If a numeric value for n_top_genes is not provided, you "
                "must include a highly_variable column in _adata")

        hv_mask = np.asarray(_adata.var["highly_variable"]).astype(bool)

        if harmony_vars is not None:
            anorm = self._normalized(_adata, librarysize_targetsum)
            anorm = anorm.take(cols=hv_mask)
            stdscale_quantile_celing(anorm, max_value=max_scaled_thresh,
                                     quantile_thresh=quantile_thresh,
                                     device=dev)

            _adata = _adata.take(cols=hv_mask)
            stdscale_quantile_celing(_adata, max_value=max_scaled_thresh,
                                     quantile_thresh=quantile_thresh,
                                     device=dev)
            if makeplots:
                self._count_hist(anorm)

            X_pca, _, _ = pca(anorm.X, n_comps=50, zero_center=True,
                              device=dev)
            _adata.obsm["X_pca"] = X_pca

            src = anorm if normalize_librarysize else _adata
            X_corr, pca_harmony = self.harmony_correct_X(
                _dense(src.X), src.obs, _adata.obsm["X_pca"], harmony_vars,
                max_iter_harmony=max_iter_harmony, theta=theta)
            _adata.X = X_corr
            _adata.obsm["X_pca_harmony"] = pca_harmony
        else:
            if normalize_librarysize:
                _adata = self._normalized(_adata, librarysize_targetsum)
            _adata = _adata.take(cols=hv_mask)
            stdscale_quantile_celing(_adata, max_value=max_scaled_thresh,
                                     quantile_thresh=quantile_thresh,
                                     device=dev)
            if makeplots:
                self._count_hist(_adata)
        return _adata, [str(v) for v in _adata.var_names]

    # ------------------------------------------------------------------

    def harmony_correct_X(self, X, obs, pca_embedding, harmony_vars,
                          theta=1, max_iter_harmony=20):
        """Harmony's correction learned on the PCs (``obs``: the batch
        columns), then its MOE ridge applied to the cells x genes matrix
        ``X`` on the card, negatives clipped to zero. Returns ``(X_corr,
        X_pca_harmony)`` as numpy."""
        dev = self.device
        res = run_harmony(pca_embedding, obs, harmony_vars, theta=theta,
                          max_iter_harmony=max_iter_harmony,
                          random_state=self.random_seed, device=dev)

        def on(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dev)

        Z = _moe_ridge(on(X).T.contiguous(), on(res.R), on(res.Phi_moe),
                       _ridge_matrix(res.lamb, dev))
        X_corr = torch.clamp_min(Z, 0.0).T.contiguous().cpu().numpy()
        return X_corr, res.Z_corr.T

    # ------------------------------------------------------------------

    def select_features_MI(self, _adata: Counts, cluster,
                           max_scaled_thresh=None, quantile_thresh=0.9999,
                           n_top_features=70, makeplots=False) -> Counts:
        """Rank the features by their mutual information with the label
        ``cluster`` (``ops/mutual_info.py``, scikit-learn's estimator with
        3 neighbours) on the TPM scaled to unit variance, and mark the top
        ``n_top_features`` as ``highly_variable``. Adds ``MI``,
        ``MI_Rank`` and ``MI_diff`` (the step from the next better rank)
        to ``var``."""
        _adata = self._normalized(_adata, 1e6)
        stdscale_quantile_celing(_adata, max_value=max_scaled_thresh,
                                 quantile_thresh=quantile_thresh,
                                 device=self.device)
        mi = mutual_info_classif(_dense(_adata.X), cluster, n_neighbors=3,
                                 random_state=self.random_seed,
                                 device=self.device)
        order = np.argsort(-mi, kind="stable")
        rank = np.empty(len(mi))
        rank[order] = np.arange(len(mi))
        mi_diff = np.empty(len(mi))
        mi_diff[order] = np.concatenate([[np.nan], np.diff(mi[order])])

        if makeplots:
            self._mi_plot(rank[order], mi[order], n_top_features)

        _adata.var = dict(_adata.var)
        _adata.var.update(MI=mi, MI_Rank=rank, MI_diff=mi_diff,
                          highly_variable=rank < n_top_features)
        return _adata

    # -- plotting helpers (host) ------------------------------------------

    def _pyplot(self, slug: str):
        """pyplot, or ``None`` after the missing-matplotlib warning."""
        path = (os.path.join(self.plot_dir, slug + ".png")
                if self.plot_dir is not None else slug + " (no plot_dir)")
        return plots.pyplot_or_skip(path)

    def _finish_fig(self, plt, fig, slug: str):
        """Save to ``plot_dir`` when it is set, else leave the figure open
        on the pyplot stack for interactive display."""
        if self.plot_dir is not None:
            os.makedirs(self.plot_dir, exist_ok=True)
            plots._save_fig_atomic(
                fig, os.path.join(self.plot_dir, slug + ".png"), dpi=150)
            plt.close(fig)

    def _hist(self, values, title):
        slug = title.replace(" ", "_")
        plt = self._pyplot(slug)
        if plt is None:
            return
        fig, ax = plt.subplots()
        ax.hist(np.asarray(values), bins=100)
        ax.set_title(title)
        self._finish_fig(plt, fig, slug)

    def _count_hist(self, adata: Counts, num_cells=1000):
        y = _dense(adata.X[:num_cells, :]).reshape(-1)
        self._hist(y[y > 0],
                   "Quantile thresholded normalized count distribution")

    def _mi_plot(self, ranks, mi, n_top_features):
        plt = self._pyplot("MI_rank")
        if plt is None:
            return
        fig, ax = plt.subplots(1, 1, figsize=(10, 3), dpi=100)
        ax.scatter(ranks, mi)
        ax.set_ylabel("MI", fontsize=11)
        ax.set_xlabel("MI Rank", fontsize=11)
        ylim = ax.get_ylim()
        ax.vlines(x=n_top_features, ymin=ylim[0], ymax=ylim[1],
                  linestyle="--", color="k")
        ax.set_ylim(ylim)
        self._finish_fig(plt, fig, "MI_rank")
