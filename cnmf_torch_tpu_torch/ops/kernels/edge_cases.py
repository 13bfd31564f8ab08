"""Edge shapes and inputs at which the ELL kernels are held against their
plain versions on the card: one table and one input builder for the card
tests (``tests/test_torch_cuda.py``) and the edge sweep of
``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import sparse

# (n, g, k, R): ragged row and gene tails (n is no multiple of the warps
# of a block); k=20 at g=3000 puts the f32 W table above a block's shared
# memory (the bf16 one fits) and k=64 at g=2000 both, so the device-memory
# path runs too; k in {1, 8, 13, 16, 17, 32, 64} covers the packed table's
# padding edges (8 bf16 or 4 f32 components a 16-byte chunk) and each
# k <= 16, 32, 64 instance; R=1 and R=20 (blocks walking rows across
# replicates)
EDGE_SHAPES = [(130, 100, 5, 3), (997, 611, 13, 2), (640, 3000, 20, 2),
               (300, 700, 40, 2), (257, 300, 1, 1), (301, 500, 8, 20),
               (129, 400, 16, 2), (200, 400, 17, 1), (150, 500, 32, 3),
               (120, 2000, 64, 2), (1001, 2000, 13, 20)]


def edge_inputs(n, g, k, R, density, seed, device, zero_rows=0,
                full_row=False, gene_edges=False, gene0=False, tiny=False,
                negative=False):
    """The ELL encoding of a random ``n x g`` matrix (gamma values) and
    random positive ``H (R, n, k)`` and ``W (R, k, g)``, made from
    ``seed``. ``zero_rows``: the first rows are all zero. ``full_row``:
    the last row gets the most nonzeros and the encoding is exactly that
    wide, so one row fills the whole width ``w`` (no multiple of 4, so
    ``wh_at_nz`` takes its slot-at-a-time path). ``gene_edges``: gene 0
    is absent from every row, gene ``g - 1`` is stored in every row but
    the zero rows, and the transpose side is exactly as wide as the longest
    gene, so gene ``g - 1`` fills the whole width ``wt``. ``gene0``: genes
    0 and 1 are stored in every other row but the zero rows, so column 0
    holds stored slots beside the padding. ``tiny``: the three rows after
    the zero rows get ``H`` scaled by 1e-9, so ``WH/X < 1e-6`` at their
    slots (the KL term's split-log regime). ``negative``: the first stored
    value of the middle row is negative (the KL objective skips it)."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=density, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: (rng.gamma(2.0, 1.0, s) + 0.1))
    if zero_rows or full_row or gene_edges or gene0:
        X = X.tolil()
        if gene_edges:
            X[:, 0] = 0.0
            X[:, g - 1] = 1.5
        if gene0:
            X[::2, 0] = 1.5
            X[::2, 1] = 2.5
        X[:zero_rows, :] = 0.0
        if full_row:
            most = int(np.diff(X.tocsr().indptr).max()) + 5
            if most % 4 == 0:
                most += 1
            X[n - 1, :] = 0.0
            X[n - 1, rng.choice(g, min(most, g), replace=False)] = 1.5
        X = X.tocsr()
        X.eliminate_zeros()
    if negative:
        mid = n // 2
        if X.indptr[mid + 1] == X.indptr[mid]:
            raise ValueError("edge_inputs: the middle row stores no value")
        X.data[X.indptr[mid]] = -1.5
    width = int(np.diff(X.indptr).max()) if full_row else None
    t_width = (int(np.diff(X.tocsc().indptr).max()) if gene_edges
               else None)
    x = sparse.csr_to_ell(X, width=width, t_width=t_width).to(device)
    H = torch.as_tensor(rng.random((R, n, k), np.float32) + 0.1).to(device)
    W = torch.as_tensor(rng.random((R, k, g), np.float32) + 0.1).to(device)
    if tiny:
        H[:, zero_rows:zero_rows + 3] *= 1e-9
    return x, H, W
