"""The frozen counts model: a copy of ``chip_smoke.py:synthetic_counts``
(itself ``bench.py:synthetic_pbmc_like``'s low-rank Poisson model), kept
here so that a change to the program cannot change the benchmark's data."""

from __future__ import annotations

import numpy as np


def synthetic_counts(n: int, g: int, k_true: int = 14, scale: float = 60.0,
                     seed: int = 14) -> np.ndarray:
    """Cells x genes Poisson counts of a planted gene-expression-program
    model: Dirichlet(0.2) usages, Gamma(0.25) spectra scaled to 40 counts
    a unit of usage over ``g`` genes, times ``scale``. Every cell keeps at
    least one count."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k_true) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(k_true, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * scale).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return counts
