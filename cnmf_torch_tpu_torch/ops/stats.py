"""Row totals, TPM scaling, column moments and unit-variance gene scaling.

Port of ``cnmf_torch_tpu/ops/stats.py`` as torch on the device. The
moments are accumulated in float64 (the JAX package keeps them in host
float64 for the same reason: the tpm_stats artifact and the Fano HVG
ranking must match the reference's f64 numerics). A CSR matrix never
densifies: its ``data``/``indices`` go to the device and per-column sums
are ``index_add_`` scatters; dense matrices reduce in row blocks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["row_sums", "cell_scale_factors", "normalize_total",
           "column_moments_staged", "column_mean_var", "scale_columns"]

_BLOCK_ROWS = 65_536


def _csr_parts(X, device):
    Xc = X.tocsr()
    data = torch.as_tensor(Xc.data).to(device=device, dtype=torch.float64)
    idx = torch.as_tensor(Xc.indices.astype(np.int64)).to(device)
    row_nnz = torch.as_tensor(np.diff(Xc.indptr).astype(np.int64)).to(device)
    return Xc, data, idx, row_nnz


def row_sums(X, device="cuda") -> np.ndarray:
    """Per-row totals (counts per cell), float64."""
    n = X.shape[0]
    if sp.issparse(X):
        _, data, _, row_nnz = _csr_parts(X, device)
        rows = torch.repeat_interleave(
            torch.arange(n, device=device), row_nnz)
        out = torch.zeros(n, dtype=torch.float64, device=device)
        out.index_add_(0, rows, data)
        return out.cpu().numpy()
    Xt = torch.as_tensor(np.asarray(X)).to(device=device, dtype=torch.float64)
    return Xt.sum(1).cpu().numpy()


def cell_scale_factors(totals, target_sum: float) -> np.ndarray:
    """Per-cell multipliers bringing each total to ``target_sum``; zero
    totals get 1 (left at zero)."""
    totals = np.asarray(totals, dtype=np.float64)
    return np.where(totals > 0,
                    target_sum / np.where(totals > 0, totals, 1.0), 1.0)


def normalize_total(X, target_sum: float = 1e6, totals=None, device="cuda"):
    """Scale each cell to ``target_sum`` total counts; f32 values, each the
    f32 product of the f32 count and the f32 cell factor."""
    if totals is None:
        totals = row_sums(X, device)
    scale = torch.as_tensor(cell_scale_factors(totals, target_sum)).to(
        device=device, dtype=torch.float32)
    if sp.issparse(X):
        Xc = X.tocsr()
        data = torch.as_tensor(Xc.data).to(device=device,
                                           dtype=torch.float32)
        per_nnz = torch.repeat_interleave(
            scale, torch.as_tensor(np.diff(Xc.indptr).astype(np.int64)).to(
                device))
        return sp.csr_matrix(((data * per_nnz).cpu().numpy(),
                              Xc.indices, Xc.indptr), shape=Xc.shape)
    Xt = torch.as_tensor(np.asarray(X)).to(device=device, dtype=torch.float32)
    return (Xt * scale[:, None]).cpu().numpy()


def column_moments_staged(X, row_scale=None, device="cuda"):
    """Population (ddof=0) column moments of ``X`` and, with ``row_scale``,
    of ``diag(row_scale) @ X``, in one pass (two-pass centered sums in
    float64). Returns ``((mean, var), (scaled_mean, scaled_var) | None)``
    as numpy."""
    n, g = X.shape
    f64 = torch.float64
    scale = (None if row_scale is None else torch.as_tensor(
        np.asarray(row_scale, dtype=np.float64)).to(device))
    if sp.issparse(X):
        _, data, idx, row_nnz = _csr_parts(X, device)
        views = [data]
        if scale is not None:
            views.append(data * torch.repeat_interleave(scale, row_nnz))
        nnz_col = torch.zeros(g, dtype=f64, device=device)
        nnz_col.index_add_(0, idx, torch.ones_like(data))
        out = []
        for d in views:
            s1 = torch.zeros(g, dtype=f64, device=device).index_add_(0, idx, d)
            mean = s1 / n
            dev_ = d - mean[idx]
            ssq = torch.zeros(g, dtype=f64, device=device).index_add_(
                0, idx, dev_ * dev_)
            # implicit zeros each contribute mean^2 to the centered sums
            ssq = ssq + (n - nnz_col) * mean * mean
            out.append((mean.cpu().numpy(),
                        torch.clamp_min(ssq / n, 0.0).cpu().numpy()))
    else:
        Xd = np.asarray(X)
        s1 = [torch.zeros(g, dtype=f64, device=device) for _ in range(2)]

        def blocks():
            for lo in range(0, n, _BLOCK_ROWS):
                b = torch.as_tensor(Xd[lo:lo + _BLOCK_ROWS]).to(
                    device=device, dtype=f64)
                if scale is None:
                    yield b, None
                else:
                    yield b, b * scale[lo:lo + b.shape[0], None]

        for b, bs in blocks():
            s1[0] += b.sum(0)
            if bs is not None:
                s1[1] += bs.sum(0)
        means = [s / n for s in s1]
        ssq = [torch.zeros(g, dtype=f64, device=device) for _ in range(2)]
        for b, bs in blocks():
            ssq[0] += ((b - means[0]) ** 2).sum(0)
            if bs is not None:
                ssq[1] += ((bs - means[1]) ** 2).sum(0)
        out = [(means[i].cpu().numpy(),
                torch.clamp_min(ssq[i] / n, 0.0).cpu().numpy())
               for i in range(1 if scale is None else 2)]
    return out[0], (out[1] if scale is not None else None)


def column_mean_var(X, ddof: int = 0, device="cuda"):
    """Per-column mean and variance (population for ``ddof=0``)."""
    (mean, var), _ = column_moments_staged(X, device=device)
    if ddof:
        var = var * (np.float64(X.shape[0]) / (X.shape[0] - ddof))
    return mean, var


def scale_columns(X, ddof: int = 1, zero_std_to_one: bool = True,
                  precomputed_var=None, out_dtype=np.float64, device="cuda"):
    """Scale columns to unit variance WITHOUT centering; each quotient is
    computed in float64 and stored as ``out_dtype``. ``zero_std_to_one``
    leaves zero-variance columns unchanged (sparse semantics); otherwise
    they divide by zero (the reference's dense path). Returns
    ``(scaled, std)``."""
    if precomputed_var is not None:
        var = np.asarray(precomputed_var, dtype=np.float64)
    else:
        (_, var), _ = column_moments_staged(X, device=device)
        n = X.shape[0]
        if ddof and n > ddof:
            var = var * (n / (n - ddof))
    std = np.sqrt(var)
    div = std.copy()
    if zero_std_to_one:
        div[div == 0] = 1.0
    div_t = torch.as_tensor(div).to(device)
    out_t = torch.from_numpy(np.empty(0, dtype=out_dtype)).dtype
    if sp.issparse(X):
        Xc, data, idx, _ = _csr_parts(X, device)
        vals = (data / div_t[idx]).to(out_t).cpu().numpy()
        out = sp.csr_matrix((vals, Xc.indices.copy(), Xc.indptr.copy()),
                            shape=Xc.shape)
    else:
        Xt = torch.as_tensor(np.asarray(X)).to(device=device,
                                               dtype=torch.float64)
        out = (Xt / div_t[None, :]).to(out_t).cpu().numpy()
    return out, std
