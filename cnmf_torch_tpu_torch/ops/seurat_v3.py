"""seurat_v3 highly-variable-gene selection (variance-stabilizing transform).

Port of ``cnmf_torch_tpu/ops/seurat_v3.py`` (Stuart et al. 2019): fit a
mean-variance trend in log10 space, standardize each gene's counts by the
trend's std with values clipped at sqrt(N), and rank genes by the second
moment of the clipped standardized values about the raw mean.

The trend is the JAX package's tricube-weighted local quadratic fit on a
256-point quantile grid of the sorted log-means (host numpy, O(genes)).
The column moments and, for a dense matrix, the clipped statistic run in
torch on ``device``; a CSR matrix keeps the JAX package's host
``bincount`` over its stored values.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from .stats import column_mean_var

__all__ = ["seurat_v3_hvg"]

_GRID = 256
_SPAN = 0.3


def _loess_trend(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Tricube-weighted local quadratic fit of y on x, evaluated at x, via a
    quantile grid and interpolation."""
    order = np.argsort(x)
    xs, ys = x[order], y[order]
    n = len(xs)
    window = max(int(np.ceil(_SPAN * n)), 8)
    grid_idx = np.unique(
        np.linspace(0, n - 1, min(_GRID, n)).astype(int))
    fitted_grid = np.empty(len(grid_idx))
    for j, gi in enumerate(grid_idx):
        lo = max(0, min(gi - window // 2, n - window))
        sel = slice(lo, lo + window)
        xw, yw = xs[sel], ys[sel]
        d = np.abs(xw - xs[gi])
        dmax = d.max() if d.max() > 0 else 1.0
        w = (1.0 - (d / dmax) ** 3) ** 3
        A = np.stack([np.ones_like(xw), xw, xw * xw], axis=1)
        Aw = A * w[:, None]
        beta, *_ = np.linalg.lstsq(Aw.T @ A, Aw.T @ yw, rcond=None)
        fitted_grid[j] = beta[0] + beta[1] * xs[gi] + beta[2] * xs[gi] ** 2
    return np.interp(x, xs[grid_idx], fitted_grid)


def _clipped_std_var_dense(X, mean, reg_std, clip):
    """sum(min(z, clip)^2) / (N - 1) per column with z = (X - mean) /
    reg_std: the second moment about the raw mean, not re-centered on the
    clipped mean (scanpy's formula, algebraically)."""
    Z = torch.clamp_max((X - mean[None, :]) / reg_std[None, :], clip)
    return (Z * Z).sum(0) / (X.shape[0] - 1)


def seurat_v3_hvg(X, n_top_genes: int = 2000, device="cuda") -> dict:
    """Score the genes of a cells x genes count matrix (dense or CSR).
    Returns the columns ``means``, ``variances``, ``variances_norm``,
    ``highly_variable_rank`` (NaN outside the top ``n_top_genes``) and
    ``highly_variable``, in that order, as a dict of numpy arrays aligned
    to the input's columns."""
    dev = resolve_device(device)
    n, g = X.shape
    mean, var = column_mean_var(X, ddof=1, device=dev)

    not_const = var > 0
    est_var = np.zeros(g)
    x_log = np.log10(np.maximum(mean[not_const], 1e-30))
    y_log = np.log10(var[not_const])
    est_var[not_const] = _loess_trend(x_log, y_log)
    reg_std = np.sqrt(10.0 ** est_var)
    reg_std[~not_const] = 1.0

    clip = np.sqrt(n)
    if sp.issparse(X):
        # the stored values, then the implicit zeros, which standardize to
        # -mean/reg_std (never clipped: the means are positive)
        Xcsr = X.tocsr()
        z0 = -mean / reg_std
        s2 = np.zeros(g)
        nnz = np.zeros(g)
        block = 262_144
        for start in range(0, n, block):
            b = Xcsr[start:min(start + block, n)]
            if b.nnz == 0:
                continue
            zb = np.minimum(
                (b.data - mean[b.indices]) / reg_std[b.indices], clip)
            s2 += np.bincount(b.indices, weights=zb * zb, minlength=g)
            nnz += np.bincount(b.indices, minlength=g)
        s2 += (n - nnz) * z0 * z0
        var_std = s2 / (n - 1)
    else:
        f32 = torch.float32
        var_std = _clipped_std_var_dense(
            torch.as_tensor(np.asarray(X)).to(device=dev, dtype=f32),
            torch.as_tensor(mean).to(device=dev, dtype=f32),
            torch.as_tensor(reg_std).to(device=dev, dtype=f32),
            float(np.float32(clip))).cpu().numpy().astype(np.float64)
    var_std[~not_const] = 0.0

    n_top = min(int(n_top_genes), g)
    # ties keep the input order, as scanpy breaks them
    rank_order = np.argsort(-var_std, kind="stable")
    ranks = np.full(g, np.nan)
    ranks[rank_order[:n_top]] = np.arange(n_top)
    return {"means": mean, "variances": var, "variances_norm": var_std,
            "highly_variable_rank": ranks,
            "highly_variable": ~np.isnan(ranks)}
