"""Principal component analysis: device matmuls, host eigensolve.

Port of ``cnmf_torch_tpu/ops/pca.py``. The factorization comes from the
Gram matrix over the smaller side (g x g or n x n): the Gram, the
projection and, for n < g, the components are full-f32 torch matmuls on
``device`` (``resolve_device`` keeps TF32 off); the eigensolve runs on the
host in float64 (``np.linalg.eigh``), as in the JAX package. Signs follow
scanpy's and scikit-learn's ``svd_flip`` (each component's largest
|loading| positive).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

__all__ = ["pca"]


def _centered(X, zero_center: bool):
    return X - X.mean(0, keepdim=True) if zero_center else X


def pca(X, n_comps: int = 50, zero_center: bool = True, device="cuda"):
    """Returns ``(X_pca (n, n_comps), components (n_comps, g),
    explained_variance_ratio (n_comps,))`` as numpy (f32, f32, f64)."""
    dev = resolve_device(device)
    if sp.issparse(X):
        X = X.toarray()
    X = np.asarray(X, dtype=np.float32)
    n, g = X.shape
    n_comps = int(min(n_comps, min(X.shape) - 1 if zero_center
                      else min(X.shape)))
    Xc = _centered(torch.as_tensor(X).to(dev), bool(zero_center))

    small_side = "g" if g <= n else "n"
    G = (Xc.T @ Xc) if small_side == "g" else (Xc @ Xc.T)
    evals, evecs = np.linalg.eigh(G.cpu().numpy().astype(np.float64))
    S = np.sqrt(np.clip(evals[::-1][:n_comps], 0.0, None))

    if small_side == "g":
        V = np.ascontiguousarray(evecs[:, ::-1][:, :n_comps])      # (g, k)
        Vt = V.T
        X_pca = (Xc @ torch.as_tensor(V.astype(np.float32)).to(dev)
                 ).cpu().numpy().astype(np.float64)                 # = U S
    else:
        U = np.ascontiguousarray(evecs[:, ::-1][:, :n_comps])      # (n, k)
        # rank-overflow guard: S ~ 0 columns would divide f32 noise by eps
        ok = S > 1e-6 * max(S[0] if S.size else 0.0, 1e-30)
        U_over_S = np.where(ok[None, :], U / np.maximum(S, 1e-30)[None, :],
                            0.0)
        Vt = (torch.as_tensor(U_over_S.astype(np.float32)).to(dev).T @ Xc
              ).cpu().numpy().astype(np.float64)
        Vt = np.where(ok[:, None], Vt, 0.0)
        X_pca = U * S[None, :]

    # svd_flip: each component's largest-|value| loading positive
    max_idx = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(Vt[np.arange(n_comps), max_idx])
    signs[signs == 0] = 1.0
    Vt = Vt * signs[:, None]
    X_pca = X_pca * signs[None, :]
    explained_var = (S ** 2) / max(n - 1, 1)

    if zero_center:
        total_var = float(np.var(X, axis=0, ddof=1).sum())
    else:
        # the uncentered energy includes the mean, so the ratio's
        # denominator is the uncentered second moment
        total_var = float((np.asarray(X, np.float64) ** 2).sum()
                          / max(X.shape[0] - 1, 1))
    ratio = np.asarray(explained_var, dtype=np.float64) / max(total_var, 1e-30)
    return np.asarray(X_pca, np.float32), np.asarray(Vt, np.float32), ratio
