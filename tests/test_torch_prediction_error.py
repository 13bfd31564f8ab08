"""The K-selection prediction error ``||X - HW||_F^2`` of the port.

The resident path (``models/cnmf.py:_frobenius_prediction_error``) and the
streamed one (``cNMF._streamed_prediction_errors``, the store as the only
copy) both take the squares of X and their sum in f64, so where the two
solve the same usages their errors agree to f64 rounding. An f32 sum of
f32 squares was off by about 1e-6 of ``||X||^2``, which the cancellation
``x_sq - 2 cross + hw_sq`` amplifies by ``||X||^2 / error``.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.models.cnmf import _frobenius_prediction_error

# f64 rounding of sums over about 10^6 terms, with the cancellation's gain
RTOL = 1e-11


def _dense_error(X, H, W) -> float:
    D = np.asarray(X.toarray() if sp.issparse(X) else X, np.float64)
    R = D - np.asarray(H, np.float64) @ np.asarray(W, np.float64)
    return float(np.sum(R * R))


def _low_rank(n=4_000, g=300, k=6, seed=3):
    """Normalized-count-like f32 CSR (non-integer values, ~10% nonzeros)
    close to a rank-``k`` product, so the error is a few percent of
    ``||X||^2`` and the cancellation amplifies a rounded ``x_sq``."""
    rng = np.random.default_rng(seed)
    H = rng.gamma(1.0, 1.0, size=(n, k))
    W = rng.gamma(0.5, 1.0, size=(k, g)) * (rng.random((k, g)) < 0.3)
    D = H @ W
    D[D < np.quantile(D, 0.9)] = 0.0
    D = (D * rng.uniform(0.95, 1.05, size=D.shape)).astype(np.float32)
    return sp.csr_matrix(D), H.astype(np.float32), W.astype(np.float32)


@pytest.mark.parametrize("layout", ["csr", "csc", "duplicates"])
def test_a_sparse_matrix_takes_its_squares_in_f64(layout):
    X, H, W = _low_rank()
    want = _dense_error(X, H, W)
    x_sq32 = float(X.multiply(X).sum())
    assert abs(x_sq32 - float(np.sum(X.data.astype(np.float64) ** 2))) \
        > RTOL * want  # an f32 sum would fail the band below
    if layout == "csc":
        X = X.tocsc()
    elif layout == "duplicates":
        # every stored value split in two entries of one slot
        coo = X.tocoo()
        half = coo.data / np.float32(2)
        X = sp.csr_matrix((np.concatenate([half, coo.data - half]),
                           (np.concatenate([coo.row, coo.row]),
                            np.concatenate([coo.col, coo.col]))),
                          shape=X.shape)
        X.has_canonical_format = False
    got = _frobenius_prediction_error(X, H, W)
    assert abs(got - want) <= RTOL * want, (got, want)


def test_a_dense_matrix_matches_the_sparse_one():
    X, H, W = _low_rank()
    a = _frobenius_prediction_error(X, H, W)
    b = _frobenius_prediction_error(X.toarray(), H, W)
    assert abs(a - b) <= RTOL * a


def test_the_streamed_errors_equal_the_resident_ones(tmp_path, monkeypatch):
    """Resident, then the same run store-only: K-selection streams, its
    usages solved chunk for chunk as the resident refit solves them (bit
    for bit here), so only the sums' order separates the errors."""
    rng = np.random.default_rng(7)
    n, g = 600, 400
    usage = rng.dirichlet(np.ones(5) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(5, g)) * 50.0 / g
    counts = rng.poisson(usage @ spectra * 40.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp_path, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    monkeypatch.setenv("CNMF_TPU_OOC", "0")
    obj = cNMF(str(tmp_path), "run", device="cpu")
    obj.prepare(fn, components=[3, 4], n_iter=3, seed=14,
                num_highvar_genes=200, beta_loss="frobenius",
                batch_size=200, max_NMF_iter=100)
    obj.factorize()
    obj.combine()
    resident = obj.k_selection_stats().values
    norm = obj._read_norm_counts()
    assert sp.issparse(norm.X)
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    # blocks of one 200-row chunk: three slabs
    monkeypatch.setenv("CNMF_TPU_OOC_BUDGET_BYTES", str(6 * 200 * 200 * 4))
    obj.save_norm_counts(norm)
    assert obj._consensus_stream_store() is not None
    streamed = obj.k_selection_stats().values
    assert obj.stream_stats["kselection_stream"].slabs == 3
    np.testing.assert_array_equal(resident[:, :3], streamed[:, :3])
    gap = np.abs(resident[:, 3] - streamed[:, 3]) / np.abs(resident[:, 3])
    assert gap.max() <= RTOL, gap
