"""Carry state from the JAX package into the port.

The JAX package's arrays arrive as numpy (``np.asarray`` of a
``jax.Array``); these functions turn them into what the port's solvers
take, so both packages can be fed the same start: an ELL encoding's four
leaves, stacked replicate inits, a usage-refit init, k-means cluster ids,
and labelled frames (merged spectra, consensus artifacts). torch cannot
reproduce JAX's threefry streams, so a parity test draws its inits on the
JAX side and converts them here. Online sweeps take a pre-chunked encoding
(3-D leaves) and batch sweeps a whole one (2-D leaves); both pass through
:func:`ell_matrix` unchanged. This module imports neither package's JAX
code.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.sparse import EllMatrix
from .utils.io import Frame

__all__ = ["ell_matrix", "replicate_inits", "fit_h_init", "cluster_labels",
           "frame"]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32)).to(device)


def ell_matrix(vals, cols, g: int, rows_t=None, perm_t=None,
               device="cpu") -> EllMatrix:
    """An ELL encoding from its four numpy leaves (``vals``, ``cols`` and,
    for W-side statistics, ``rows_t``/``perm_t``), staged on ``device``."""
    return EllMatrix(np.asarray(vals), np.asarray(cols), int(g),
                     None if rows_t is None else np.asarray(rows_t),
                     None if perm_t is None else np.asarray(perm_t)
                     ).to(device)


def replicate_inits(H0, W0, device="cpu"):
    """Stacked replicate inits ``(H0 (R, n, k), W0 (R, k, g))`` as f32
    tensors (the layout ``replicate_sweep(inits=...)`` and
    ``nmf_fit_online`` take once H0 is chunked)."""
    H0, W0 = _f32(H0, device), _f32(W0, device)
    if H0.ndim != 3 or W0.ndim != 3 or H0.shape[0] != W0.shape[0]:
        raise ValueError(f"expected (R, n, k) and (R, k, g) inits, got "
                         f"{tuple(H0.shape)} and {tuple(W0.shape)}")
    return H0, W0


def fit_h_init(H, device="cpu") -> torch.Tensor:
    """A usage-refit init ``(n, k)`` as an f32 tensor."""
    return _f32(H, device)


def cluster_labels(labels, reference) -> np.ndarray:
    """``labels`` renamed with the cluster ids of ``reference``, a
    clustering of the same rows; raises unless the two are the same
    partition. The consensus refits pair the k-th median spectrum with the
    k-th column of their init, so two runs agree only when their clusters
    carry the same ids, not just the same members."""
    labels, reference = np.asarray(labels), np.asarray(reference)
    mapping = {}
    for c in np.unique(labels):
        ids = np.unique(reference[labels == c])
        if ids.size != 1:
            raise ValueError("the two clusterings are different partitions")
        mapping[c] = ids[0]
    if len(set(mapping.values())) != len(mapping):
        raise ValueError("the two clusterings are different partitions")
    return np.asarray([mapping[c] for c in labels], dtype=reference.dtype)


def frame(values, index, columns) -> Frame:
    """A labelled matrix (merged spectra, consensus spectra or usages) from
    a DataFrame's ``values``, ``index`` and ``columns``."""
    return Frame(np.asarray(values), np.asarray(index), np.asarray(columns))
