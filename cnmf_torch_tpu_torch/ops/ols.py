"""Batched ordinary least squares over row blocks, in float64 on the device.

Port of ``cnmf_torch_tpu/ops/ols.py`` (its default float64 path): solves
``Beta = (X^T X)^{-1} X^T Y`` for every column of ``Y`` at once from the
``k x k`` and ``k x g`` sufficient statistics accumulated over row blocks.
With ``normalize_y`` the columns of ``Y`` are z-scored by their global
population moments (variance floored at 1e-12) through the centering
identity ``X^T((Y - mean) / std) = (X^T Y - (X^T 1) mean^T) / std``, so the
z-scored matrix is never built. A sparse ``Y`` is densified one row block
at a time on the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["ols_all_cols"]


def ols_all_cols(X, Y, batch_size: int = 65536, normalize_y: bool = False,
                 device="cuda") -> np.ndarray:
    """OLS coefficients ``(n_predictors, n_targets)`` as numpy float64."""
    n, k = X.shape
    nY, g = Y.shape
    if n != nY:
        raise ValueError("X and Y must have the same number of rows.")
    f64 = torch.float64
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float64)).to(device)
    XtX = torch.zeros((k, k), dtype=f64, device=device)
    XtY = torch.zeros((k, g), dtype=f64, device=device)
    s1 = torch.zeros(g, dtype=f64, device=device)
    s2 = torch.zeros(g, dtype=f64, device=device)
    for start in range(0, n, int(batch_size)):
        yb = Y[start:start + int(batch_size)]
        yb = yb.toarray() if sp.issparse(yb) else np.asarray(yb)
        yb = torch.as_tensor(np.asarray(yb, dtype=np.float64)).to(device)
        xb = Xt[start:start + int(batch_size)]
        XtX += xb.T @ xb
        XtY += xb.T @ yb
        if normalize_y:
            s1 += yb.sum(0)
            s2 += (yb * yb).sum(0)
    if normalize_y:
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 1e-12)
        XtY = (XtY - Xt.sum(0)[:, None] * mean[None, :]) / torch.sqrt(var)
    # lstsq on the host: rank-deficient XtX is solved in the least-squares
    # sense like the reference's numpy call (k is small)
    beta, *_ = np.linalg.lstsq(XtX.cpu().numpy(), XtY.cpu().numpy(),
                               rcond=None)
    return beta
