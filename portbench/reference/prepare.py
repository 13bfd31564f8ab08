"""The normalization that cNMF's ``prepare`` applies, in plain NumPy.

From raw counts: TPM, the TPM moments, the over-dispersed genes by the
Fano factor over the expected-Fano line (cNMF's ``get_highvar_genes``)
and the HVG counts scaled to unit variance without centering. Everything
in float64; the scaled matrix is stored as float32, as the solver reads
it.
"""

from __future__ import annotations

import numpy as np


def highvar_genes(mean: np.ndarray, var: np.ndarray,
                  numgenes: int) -> np.ndarray:
    """Indices, in column order, of the ``numgenes`` genes with the largest
    ratio of Fano factor to the expected Fano factor ``A^2 mean + B^2``:
    ``A`` the smallest coefficient of variation of the 20 genes of largest
    mean, ``B^2`` the median Fano factor of the genes inside the 10-90%
    quantile box of mean and Fano factor."""
    with np.errstate(divide="ignore", invalid="ignore"):
        fano = var / mean
        top20 = np.argsort(-mean, kind="stable")[:min(20, mean.shape[0])]
        a = np.min(np.sqrt(var[top20]) / mean[top20])
        m_lo, m_hi = np.nanquantile(mean, [0.10, 0.90])
        f_lo, f_hi = np.nanquantile(fano, [0.10, 0.90])
        box = (fano > f_lo) & (fano < f_hi) & (mean > m_lo) & (mean < m_hi)
        b2 = np.median(fano[box])
        ratio = fano / (a * a * mean + b2)
    score = np.where(np.isnan(ratio), -np.inf, ratio)
    top = np.argsort(-score, kind="stable")[:min(int(numgenes), mean.shape[0])]
    return np.sort(top)


def normalize(counts: np.ndarray, numgenes: int):
    """``(X (cells, hvgs) float32, hvg column indices)``: the HVG counts
    divided by their column's sample standard deviation (a zero deviation
    divides by 1)."""
    c = np.asarray(counts, dtype=np.float64)
    tpm = c * (1e6 / c.sum(axis=1, keepdims=True))
    hvg = highvar_genes(tpm.mean(axis=0), tpm.var(axis=0), numgenes)
    sub = c[:, hvg]
    std = sub.std(axis=0, ddof=1)
    std[std == 0] = 1.0
    return (sub / std).astype(np.float32), hvg
