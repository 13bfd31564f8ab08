"""Pairwise distances, KNN local density and silhouette, in torch.

Port of ``cnmf_torch_tpu/ops/metrics.py`` (f32 on the device, the same
formulas).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pairwise_euclidean", "local_density", "silhouette_score"]


def _as_f32(A, device):
    return torch.as_tensor(np.asarray(A, dtype=np.float32)).to(device)


def _pairwise(A):
    sq = (A * A).sum(1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (A @ A.T), 0.0)
    # exact-zero self distances (the quadratic form leaves f32 residue)
    d2 = d2 * (1.0 - torch.eye(A.shape[0], dtype=A.dtype, device=A.device))
    return torch.sqrt(d2)


def pairwise_euclidean(A, device="cuda") -> np.ndarray:
    """Full pairwise euclidean distance matrix (R x R)."""
    return _pairwise(_as_f32(A, device)).cpu().numpy()


def local_density(l2_spectra, n_neighbors: int, device="cuda"):
    """Per-row mean distance to the ``n_neighbors`` nearest rows (self
    excluded: the n+1 smallest include the zero self distance). Returns
    ``(density (R,), D (R, R))`` as numpy."""
    D = _pairwise(_as_f32(l2_spectra, device))
    n_neighbors = int(n_neighbors)
    small = torch.topk(D, n_neighbors + 1, dim=1, largest=False).values
    dens = small.sum(1) / n_neighbors
    return dens.cpu().numpy(), D.cpu().numpy()


def silhouette_score(X, labels, k: int | None = None, device="cuda") -> float:
    """Mean silhouette coefficient, euclidean metric; singletons score 0
    and empty clusters are excluded from the nearest-other minimum."""
    lab = torch.as_tensor(np.asarray(labels, dtype=np.int64)).to(device)
    if k is None:
        k = int(lab.max().item()) + 1
    D = _pairwise(_as_f32(X, device))
    onehot = torch.nn.functional.one_hot(lab, k).to(D.dtype)
    counts = onehot.sum(0)
    sums = D @ onehot
    own_count = counts[lab]
    own_sum = sums.gather(1, lab[:, None])[:, 0]
    a = own_sum / torch.clamp_min(own_count - 1.0, 1.0)
    mean_other = sums / torch.clamp_min(counts[None, :], 1.0)
    mask = onehot.bool() | (counts[None, :] == 0)
    b = torch.where(mask, torch.full_like(mean_other, float("inf")),
                    mean_other).min(1).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30)
    s = torch.where(own_count <= 1.0, torch.zeros_like(s), s)
    return float(s.mean().item())
