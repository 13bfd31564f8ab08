"""Multi-init Lloyd k-means with k-means++ seeding, in torch.

Port of ``cnmf_torch_tpu/ops/kmeans.py``: ``n_init`` restarts, each seeded
by k-means++ and refined by Lloyd iterations until sklearn's center-shift
criterion (``tol`` times the mean per-feature variance) or ``max_iter``;
the restart with the least inertia wins. Random draws come from one CPU
``torch.Generator`` seeded with ``seed``, so a seed gives the same
clustering on the CPU and on the card. The contract with the JAX package
is the same cluster medians up to a permutation of labels (its threefry
draws cannot be reproduced here).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["kmeans"]


def _sq_dists(X, C):
    x2 = (X * X).sum(1)[:, None]
    c2 = (C * C).sum(1)[None, :]
    return torch.clamp_min(x2 + c2 - 2.0 * (X @ C.T), 0.0)


def _kmeanspp(X, k: int, gen):
    n = X.shape[0]
    first = int(torch.randint(n, (1,), generator=gen))
    centers = [X[first]]
    min_d2 = ((X - X[first][None, :]) ** 2).sum(1)
    for _ in range(k - 1):
        w = min_d2.double().cpu()
        if float(w.sum()) <= 1e-30:
            # every row already sits on a center: draw uniformly
            w = torch.ones_like(w)
        idx = int(torch.multinomial(w / w.sum(), 1, generator=gen))
        c = X[idx]
        centers.append(c)
        min_d2 = torch.minimum(min_d2, ((X - c[None, :]) ** 2).sum(1))
    return torch.stack(centers)


def _lloyd(X, C, max_iter: int, shift_tol: float):
    k = C.shape[0]
    for _ in range(max_iter):
        labels = torch.argmin(_sq_dists(X, C), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(X.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ X
        newC = torch.where(counts[:, None] > 0,
                           sums / torch.clamp_min(counts, 1.0)[:, None], C)
        shift = float(((newC - C) ** 2).sum())
        C = newC
        if not shift > shift_tol:
            break
    d2 = _sq_dists(X, C)
    return torch.argmin(d2, dim=1), C, float(d2.min(1).values.sum())


def kmeans(X, k: int, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4, seed: int = 1, device="cuda"):
    """Cluster the rows of ``X``; returns ``(labels, centers, inertia)`` as
    numpy (labels int64, centers f32) and a float."""
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float32)).to(device)
    k = int(k)
    gen = torch.Generator().manual_seed(int(seed))
    shift_tol = float(tol) * float(Xt.var(0, unbiased=False).mean())
    best = None
    for _ in range(int(n_init)):
        C0 = _kmeanspp(Xt, k, gen)
        labels, C, inertia = _lloyd(Xt, C0, int(max_iter), shift_tol)
        if best is None or inertia < best[2]:
            best = (labels, C, inertia)
    labels, C, inertia = best
    return labels.cpu().numpy(), C.cpu().numpy(), inertia
