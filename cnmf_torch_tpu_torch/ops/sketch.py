"""Sketched consensus: a seeded Gaussian projection of the replicate
spectra before the distance-bearing consensus stages.

Port of ``cnmf_torch_tpu/ops/sketch.py``. The consensus clustering stage
(the KNN local-density filter, k-means and the silhouette) reduces over
the full HVG-wide spectra, ``O(R^2 g)`` in distance work for ``R`` stacked
replicate spectra. A Gaussian projection to ``dim`` columns (entries
``N(0, 1/dim)``) keeps every pairwise distance to Johnson-Lindenstrauss
tolerance, after which those stages cost ``O(R^2 dim)``. The cluster
medians are always taken from the full-width spectra within the final
clusters; only the geometry that picks the clusters is compressed.

:func:`resolve_consensus_sketch` reads the same knobs as the JAX package
(``CNMF_TPU_SKETCH`` ``0``/``1``/``auto``, ``CNMF_TPU_SKETCH_DIM``) with
the same fallback width and refusals. :func:`project_rows` draws its
matrix from a ``torch.Generator`` (torch cannot reproduce JAX's threefry
stream), and takes ``projection=`` to use a given matrix instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..utils.envknobs import env_int, env_str
from .recipe import SKETCH_DIM_ENV, SKETCH_ENV

__all__ = ["ConsensusSketch", "resolve_consensus_sketch", "project_rows",
           "projection_matrix", "DEFAULT_CONSENSUS_DIM",
           "CONSENSUS_AUTO_MIN_RATIO"]

# default projection width of the consensus spectra
DEFAULT_CONSENSUS_DIM = 256

# the auto mode engages only when R >= ratio * dim: below that the R x R
# distance pass is cheaper than the projection
CONSENSUS_AUTO_MIN_RATIO = 4


@dataclass(frozen=True)
class ConsensusSketch:
    """One resolved consensus-sketch decision: ``engaged`` (project before
    the distance stages), ``dim`` (the projection width when engaged) and
    ``source`` (``off`` / ``env`` / ``auto``)."""

    engaged: bool
    dim: int
    source: str

    def as_context(self) -> dict:
        return {"sketch": bool(self.engaged),
                "sketch_dim": int(self.dim) if self.engaged else 0,
                "sketch_source": self.source}


def resolve_consensus_sketch(n_rows: int, n_cols: int) -> ConsensusSketch:
    """The consensus sketch for ``n_rows`` stacked replicate spectra of
    width ``n_cols``. Never engages where the projection would not shrink
    the distance reductions (``dim >= n_cols``)."""
    raw = env_str(SKETCH_ENV, "0").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return ConsensusSketch(False, 0, "off")
    raw_dim = env_str(SKETCH_DIM_ENV, "auto").strip().lower()
    dim = (0 if raw_dim in ("", "auto")
           else (env_int(SKETCH_DIM_ENV, 0, lo=0) or 0))
    dim = int(dim or DEFAULT_CONSENSUS_DIM)
    if dim >= n_cols and DEFAULT_CONSENSUS_DIM < n_cols:
        # the knob is shared with the solver's sampled-row count: a
        # solver-sized pin must not turn a forced consensus sketch off,
        # so the default width takes its place
        dim = DEFAULT_CONSENSUS_DIM
    if raw == "auto":
        engaged = (n_rows >= CONSENSUS_AUTO_MIN_RATIO * dim
                   and n_cols > dim)
        return ConsensusSketch(engaged, dim if engaged else 0, "auto")
    if raw in ("1", "on", "true", "yes", "force"):
        if n_cols <= dim:
            # projecting up never pays: the exact stage runs instead
            return ConsensusSketch(False, 0, "env")
        return ConsensusSketch(True, dim, "env")
    raise ValueError(f"{SKETCH_ENV}={raw!r}: expected 0, 1, or auto")


def projection_matrix(g: int, dim: int, seed: int = 0) -> torch.Tensor:
    """The ``(g, dim)`` f32 projection, entries ``N(0, 1/dim)``, drawn from
    a CPU ``torch.Generator`` seeded with ``seed`` (the same matrix on
    every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    return (torch.randn((int(g), int(dim)), generator=gen,
                        dtype=torch.float32) * (1.0 / np.sqrt(dim)))


def project_rows(A, dim: int, seed: int = 0, projection=None,
                 device="cuda") -> np.ndarray:
    """The rows of ``A (R, g)`` projected to ``dim`` columns on ``device``
    (squared distances kept in expectation). The fixed default seed keeps
    repeated consensus runs deterministic. ``projection``: a ``(g, dim)``
    matrix to use in place of the seeded draw. Returns host f32; ``A`` as
    it is when ``dim >= g``."""
    dev = resolve_device(device)
    A = np.asarray(A, dtype=np.float32)
    if dim >= A.shape[1]:
        return A
    P = (projection_matrix(A.shape[1], dim, seed) if projection is None
         else torch.as_tensor(np.array(projection, np.float32)))
    if tuple(P.shape) != (A.shape[1], int(dim)):
        raise ValueError(f"projection has shape {tuple(P.shape)}, expected "
                         f"({A.shape[1]}, {int(dim)})")
    out = torch.as_tensor(A).to(dev) @ P.to(dev)
    return out.cpu().numpy()
