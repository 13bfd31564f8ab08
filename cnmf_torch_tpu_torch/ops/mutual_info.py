"""Mutual information of continuous features with a discrete label.

The port's own copy of the estimator scikit-learn's
``mutual_info_classif`` applies to continuous features (Ross 2014,
``sklearn/feature_selection/_mutual_info.py``: ``_estimate_mi`` and
``_compute_mi_cd``), without scikit-learn. For each feature and each cell
whose label occurs more than once: the distance ``r`` to its k-th nearest
neighbour among the cells of its own label (``k = min(n_neighbors,
count - 1)``), made one float smaller with ``nextafter``; the number
``m`` of cells of any such label within ``r`` of it (itself included);
then ``MI = psi(N) + <psi(k)> - <psi(count)> - <psi(m)>``, clipped at 0.

As scikit-learn does, each feature is first divided by its standard
deviation (``scale(with_mean=False)``) and then jittered by
``1e-10 * max(1, mean|x|) * standard_normal``. That step runs on the host
in float64, its draws from ``numpy.random.RandomState(random_state)`` in
scikit-learn's order, so a seed gives scikit-learn's inputs bit for bit.

In one dimension the neighbour search is a sort. :func:`mutual_info_classif`
does it for all features at once in torch on ``device``: the k-th
neighbour distance from a window of k sorted values on each side, and the
count within ``r`` from two binary searches over the sorted column with
the exact predicate ``|x_q - x_i| <= r``.
:func:`mutual_info_classif_plain` is the plain version: one feature at a
time, brute-force distances in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["mutual_info_classif", "mutual_info_classif_plain"]


def _scaled_jittered(X, random_state=None) -> np.ndarray:
    """scikit-learn's preparation of continuous features: a float64 copy,
    each column divided by its standard deviation (near-constant columns
    by 1), then ``1e-10 * max(1, mean|x|)`` times a standard normal draw of
    ``RandomState(random_state)``, drawn as an (n, p) block."""
    X = np.array(X, dtype=np.float64)
    scale = np.nanstd(X, axis=0)
    scale[scale < 10 * np.finfo(scale.dtype).eps] = 1.0
    X /= scale
    means = np.maximum(1, np.mean(np.abs(X), axis=0))
    rng = np.random.RandomState(random_state)
    X += 1e-10 * means * rng.standard_normal(size=X.shape)
    return X


def _label_groups(y):
    """Per-cell label codes, counts of the cell's label, and the mask of
    cells whose label occurs more than once."""
    _, codes, counts = np.unique(np.asarray(y), return_inverse=True,
                                 return_counts=True)
    label_counts = counts[codes]
    return codes, label_counts, label_counts > 1


def _first_true(S, pred, n_rows: int):
    """Per (cell, feature), the first row q of the column-sorted ``S`` with
    ``pred(S[q])`` true (``n_rows`` when none); ``pred`` is false then true
    down each sorted column."""
    shape = S.shape
    lo = torch.zeros(shape, dtype=torch.int64, device=S.device)
    hi = torch.full(shape, n_rows, dtype=torch.int64, device=S.device)
    for _ in range(max(1, int(n_rows).bit_length())):
        active = lo < hi
        mid = (lo + hi) // 2
        p = pred(S.gather(0, torch.clamp_max(mid, n_rows - 1)))
        hi = torch.where(active & p, mid, hi)
        lo = torch.where(active & ~p, mid + 1, lo)
    return lo


def _kth_neighbour_radius(sub, k: int):
    """Distance from each row of ``sub`` (m x p) to its k-th nearest other
    row, per column: the k nearest lie within k sorted places on either
    side."""
    s, order = torch.sort(sub, dim=0)
    m = s.shape[0]
    inf = torch.full_like(s, float("inf"))
    cand = []
    for j in range(1, k + 1):
        left = torch.cat([inf[:j], s[j:] - s[:-j]]) if j < m else inf
        right = torch.cat([s[j:] - s[:-j], inf[:j]]) if j < m else inf
        cand += [left, right]
    r_sorted = torch.kthvalue(torch.stack(cand), k, dim=0).values
    return torch.empty_like(r_sorted).scatter_(0, order, r_sorted)


def mutual_info_classif(X, y, n_neighbors: int = 3, random_state=None,
                        device="cuda") -> np.ndarray:
    """MI of each column of the cells x features matrix ``X`` (dense) with
    the discrete label ``y``, in nats, as scikit-learn's
    ``mutual_info_classif(X, y, discrete_features=False, n_neighbors=...,
    random_state=...)`` computes it. Returns a float64 numpy vector."""
    dev = resolve_device(device)
    Xj = _scaled_jittered(X, random_state)
    codes, label_counts, keep = _label_groups(y)
    n_m = int(keep.sum())
    if n_m == 0:
        return np.zeros(Xj.shape[1])
    x = torch.as_tensor(Xj[keep]).to(dev)
    codes, label_counts = codes[keep], label_counts[keep]
    radius = torch.empty_like(x)
    k_all = np.empty(n_m)
    for code in np.unique(codes):
        rows = np.flatnonzero(codes == code)
        k = min(int(n_neighbors), len(rows) - 1)
        rows_t = torch.as_tensor(rows).to(dev)
        radius[rows_t] = _kth_neighbour_radius(x[rows_t], k)
        k_all[rows] = k
    radius = torch.nextafter(radius, torch.zeros_like(radius))

    S, _ = torch.sort(x, dim=0)
    lower = _first_true(S, lambda v: x - v <= radius, n_m)
    upper = _first_true(S, lambda v: v - x > radius, n_m)
    m_all = (upper - lower).to(torch.float64)

    psi = torch.special.digamma
    const = (psi(torch.tensor(float(n_m), dtype=torch.float64))
             + psi(torch.as_tensor(k_all)).mean()
             - psi(torch.as_tensor(label_counts, dtype=torch.float64)).mean())
    mi = const.to(dev) - psi(m_all).mean(0)
    return torch.clamp_min(mi, 0.0).cpu().numpy()


def mutual_info_classif_plain(X, y, n_neighbors: int = 3,
                              random_state=None) -> np.ndarray:
    """The plain version of :func:`mutual_info_classif`: one feature at a
    time, brute-force pairwise distances in numpy."""
    from scipy.special import digamma

    Xj = _scaled_jittered(X, random_state)
    codes, label_counts, keep = _label_groups(y)
    out = np.zeros(Xj.shape[1])
    if not keep.any():
        return out
    codes, label_counts = codes[keep], label_counts[keep]
    n_m = int(keep.sum())
    for f in range(Xj.shape[1]):
        c = Xj[keep, f]
        radius = np.empty(n_m)
        k_all = np.empty(n_m)
        for code in np.unique(codes):
            rows = np.flatnonzero(codes == code)
            k = min(int(n_neighbors), len(rows) - 1)
            d = np.abs(c[rows][:, None] - c[rows][None, :])
            np.fill_diagonal(d, np.inf)
            radius[rows] = np.nextafter(np.sort(d, axis=1)[:, k - 1], 0)
            k_all[rows] = k
        m_all = (np.abs(c[None, :] - c[:, None]) <= radius[:, None]).sum(1)
        mi = (digamma(n_m) + np.mean(digamma(k_all))
              - np.mean(digamma(label_counts)) - np.mean(digamma(m_all)))
        out[f] = max(0.0, mi)
    return out
