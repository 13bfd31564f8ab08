"""Row totals, TPM scaling, column moments and unit-variance gene scaling.

Port of ``cnmf_torch_tpu/ops/stats.py`` as torch on the device. The
moments are accumulated in float64 (the JAX package keeps them in host
float64 for the same reason: the tpm_stats artifact and the Fano HVG
ranking must match the reference's f64 numerics). A CSR matrix never
densifies: its ``data``/``indices`` go to the device, and its row and
column sums are ordered segment sums (the values sorted by column for
the column sums), never atomic scatters, so a rerun on the card gives
the same bits and the CPU the bits of a sequential sum; dense matrices
reduce in row blocks.
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


def _segment_sums(values, lengths):
    """Sums of consecutive runs of ``values`` (``lengths`` each, 0 for an
    empty run), each run summed in order with no atomics."""
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)


def row_sums(X, device="cuda") -> np.ndarray:
    """Per-row totals (counts per cell), float64."""
    if sp.issparse(X):
        _, data, _, row_nnz = _csr_parts(X, device)
        return _segment_sums(data, row_nnz).cpu().numpy()
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
        Xc, data, idx, row_nnz = _csr_parts(X, device)
        # the stored values in column order (rows ascending within a
        # column): each column's sums are one segment
        order = torch.as_tensor(np.argsort(Xc.indices, kind="stable")).to(
            device)
        col_nnz = np.bincount(Xc.indices, minlength=g)
        col_len = torch.as_tensor(col_nnz.astype(np.int64)).to(device)
        nnz_col = torch.as_tensor(col_nnz.astype(np.float64)).to(device)
        idx = idx[order]
        views = [data[order]]
        if scale is not None:
            views.append((data * torch.repeat_interleave(scale, row_nnz))[
                order])
        out = []
        for d in views:
            mean = _segment_sums(d, col_len) / n
            dev_ = d - mean[idx]
            ssq = _segment_sums(dev_ * dev_, col_len)
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
