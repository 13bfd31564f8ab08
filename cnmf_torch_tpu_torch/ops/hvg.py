"""Over-dispersed gene selection by Fano factor, pandas-free.

Port of ``cnmf_torch_tpu/ops/hvg.py``: genes are scored by their Fano
factor over an expected-Fano line ``A^2 * mean + B^2`` (``A`` from the
top-20-mean genes' coefficient of variation, ``B`` from the winsorized
median Fano) and the top ``numgenes`` by that ratio are kept, or those
above a threshold. The scoring is O(genes) ranking work in exact host
float64; the moment pass runs on the device (``ops/stats.py``).
"""

from __future__ import annotations

import numpy as np

from .stats import column_mean_var

__all__ = ["highvar_genes"]


def highvar_genes(X, expected_fano_threshold=None, minimal_mean: float = 0.5,
                  numgenes: int | None = None, precomputed_moments=None,
                  device="cuda"):
    """Returns ``(gene_stats, params)``: ``gene_stats`` is a dict of
    per-gene arrays (mean, var, fano, expected_fano, high_var,
    fano_ratio); ``params`` holds A, B, T and minimal_mean."""
    if precomputed_moments is not None:
        mean, var = precomputed_moments
    else:
        mean, var = column_mean_var(X, ddof=0, device=device)
    mean = np.asarray(mean, dtype=np.float64)
    var = np.asarray(var, dtype=np.float64)
    has_threshold = bool(expected_fano_threshold)
    if numgenes is not None:
        numgenes = min(int(numgenes), X.shape[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        fano = var / mean
        top20 = np.argsort(-mean, kind="stable")[: min(20, mean.shape[0])]
        A = float(np.min(np.sqrt(var[top20]) / mean[top20]))
        w_mean_low, w_mean_high = np.nanquantile(mean, [0.10, 0.90])
        w_fano_low, w_fano_high = np.nanquantile(fano, [0.10, 0.90])
        box = ((fano > w_fano_low) & (fano < w_fano_high)
               & (mean > w_mean_low) & (mean < w_mean_high))
        boxed = fano[box]
        B = float(np.sqrt(np.median(boxed)))
        expected_fano = (A ** 2) * mean + (B ** 2)
        fano_ratio = fano / expected_fano
    if numgenes is not None:
        score = np.where(np.isnan(fano_ratio), -np.inf, fano_ratio)
        idx = np.argsort(-score, kind="stable")[:numgenes]
        high_var = np.zeros(mean.shape, dtype=bool)
        high_var[idx] = True
        T = None
    else:
        T = (float(expected_fano_threshold) if has_threshold
             else float(1.0 + boxed.std(ddof=1)))
        with np.errstate(invalid="ignore"):
            high_var = (fano_ratio > T) & (mean > minimal_mean)
    gene_stats = {"mean": mean, "var": var, "fano": fano,
                  "expected_fano": expected_fano, "high_var": high_var,
                  "fano_ratio": fano_ratio}
    params = {"A": A, "B": B, "T": T, "minimal_mean": minimal_mean}
    return gene_stats, params
