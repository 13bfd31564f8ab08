"""The parameters the port takes from the JAX package's signatures, held
against the JAX package on the CPU.

* ``local_density(D=)`` and ``silhouette_score(D=)``: a distance matrix
  the caller already has gives the bits of the call without it, and the
  JAX package's result from the same matrix within f32 rounding (1e-6
  relative: the two packages sum in their own orders).
* ``ols_all_cols(precision=)``: ``'float64'`` within 1e-10 relative of
  JAX's, ``'float32'`` (JAX's atlas-scale lane) within 1e-4 relative of
  JAX's ``'float32'``.
* ``block_rows`` of ``row_sums``, ``column_mean_var`` and
  ``column_moments_staged``: 1, 7 and the default agree within 1e-12
  relative, with each other and with JAX's. The dense matrix is small
  counts over 64 rows, so JAX's f32 block reductions are exact and the
  comparison holds at f64 rounding. The default is JAX's, and the port's
  f64 device blocks stop at ``_DEVICE_BLOCK_ROWS`` rows whatever is asked.
* ``nmf_fit_batch(update_W_flag=False)``: W comes back bit for bit as
  given; H within 1e-4 relative of JAX's from the same ``(X, H0, W0)``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import metrics as jmetrics
from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import ols as jols
from cnmf_torch_tpu.ops import stats as jstats
from cnmf_torch_tpu_torch.ops import metrics as tmetrics
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import ols as tols
from cnmf_torch_tpu_torch.ops import stats as tstats


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _spectra(seed, reps=6, k=4, g=40):
    rng = np.random.default_rng(seed)
    base = rng.gamma(0.5, 1.0, (k, g))
    rows = np.abs(np.concatenate(
        [base * (1 + 0.05 * rng.standard_normal((k, g)))
         for _ in range(reps)]))
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# D=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_neighbors", [2, 5])
def test_local_density_takes_the_caller_s_distances(n_neighbors):
    A = _spectra(7)
    dens, D = tmetrics.local_density(A, n_neighbors, device="cpu")
    dens_d, D_d = tmetrics.local_density(A, n_neighbors, D=D, device="cpu")
    assert np.array_equal(dens_d, dens) and np.array_equal(D_d, D)
    jdens, jD = jmetrics.local_density(A, n_neighbors, D=D)
    assert np.array_equal(np.asarray(jD), D)
    # the same neighbours from the same matrix; the two packages add the
    # n+1 smallest in their own orders, so the f32 sums differ in the
    # last bit at most
    np.testing.assert_allclose(dens_d, np.asarray(jdens), rtol=1e-6)


def test_silhouette_takes_the_caller_s_distances():
    A = _spectra(8)
    labels = np.tile(np.arange(4), 6)
    labels[:2] = 3
    _, D = tmetrics.local_density(A, 2, device="cpu")
    got = tmetrics.silhouette_score(A, labels, 4, device="cpu")
    got_d = tmetrics.silhouette_score(A, labels, 4, D=D, device="cpu")
    assert got_d == got
    want = jmetrics.silhouette_score(A, labels, 4, D=D)
    assert got_d == pytest.approx(want, rel=1e-6, abs=1e-7)
    # the score reads the matrix it is given: another one moves it, as it
    # moves JAX's
    D2 = np.sqrt(D)
    got2 = tmetrics.silhouette_score(A, labels, 4, D=D2, device="cpu")
    assert got2 != pytest.approx(got, rel=1e-3)
    assert got2 == pytest.approx(
        jmetrics.silhouette_score(A, labels, 4, D=D2), rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# precision=
# ---------------------------------------------------------------------------

def _ols_inputs(sparse_y):
    rng = np.random.default_rng(12)
    X = rng.random((150, 5))
    Y = rng.poisson(2.0, (150, 40)).astype(np.float64)
    Y[:, 3] = 0.0
    return X, (sp.csr_matrix(Y) if sparse_y else Y)


@pytest.mark.parametrize("sparse_y", [False, True])
@pytest.mark.parametrize("normalize_y", [False, True])
def test_ols_float64_is_the_default_and_matches_jax(sparse_y, normalize_y):
    X, Y = _ols_inputs(sparse_y)
    got = tols.ols_all_cols(X, Y, batch_size=64, normalize_y=normalize_y,
                            precision="float64", device="cpu")
    dflt = tols.ols_all_cols(X, Y, batch_size=64, normalize_y=normalize_y,
                             device="cpu")
    assert np.array_equal(got, dflt)
    want = jols.ols_all_cols(X, Y, batch_size=64, normalize_y=normalize_y,
                             precision="float64")
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("precision", ["float32", "f32"])
@pytest.mark.parametrize("sparse_y", [False, True])
@pytest.mark.parametrize("normalize_y", [False, True])
def test_ols_float32_lane_matches_jax(precision, sparse_y, normalize_y):
    X, Y = _ols_inputs(sparse_y)
    got = tols.ols_all_cols(X, Y, batch_size=64, normalize_y=normalize_y,
                            precision=precision, device="cpu")
    want = jols.ols_all_cols(X, Y, batch_size=64, normalize_y=normalize_y,
                             precision=precision)
    assert got.dtype == np.float64 and got.shape == (5, 40)
    assert _rel(got, want) <= 1e-4
    f64 = jols.ols_all_cols(X, Y, batch_size=64, normalize_y=normalize_y)
    # the f32 lane is a different computation from the f64 one
    assert not np.array_equal(got, f64)


# ---------------------------------------------------------------------------
# block_rows
# ---------------------------------------------------------------------------

def _counts(sparse):
    rng = np.random.default_rng(21)
    X = rng.integers(0, 4, (64, 20)).astype(np.float32)
    X[rng.random((64, 20)) < 0.5] = 0.0
    X[:, 5] = 0.0
    return sp.csr_matrix(X) if sparse else X


BLOCKS = [1, 7, None]


def _kw(block_rows):
    return {} if block_rows is None else {"block_rows": block_rows}


@pytest.mark.parametrize("sparse", [False, True])
def test_row_sums_do_not_depend_on_block_rows(sparse):
    X = _counts(sparse)
    outs = [tstats.row_sums(X, device="cpu", **_kw(b)) for b in BLOCKS]
    for b, out in zip(BLOCKS, outs):
        np.testing.assert_allclose(out, outs[-1], rtol=1e-12)
        np.testing.assert_allclose(
            out, np.asarray(jstats.row_sums(X, **_kw(b))), rtol=1e-12)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("sparse", [False, True])
def test_column_mean_var_does_not_depend_on_block_rows(sparse, ddof):
    X = _counts(sparse)
    ref = tstats.column_mean_var(X, ddof=ddof, device="cpu")
    for b in BLOCKS:
        mean, var = tstats.column_mean_var(X, ddof=ddof, device="cpu",
                                           **_kw(b))
        jmean, jvar = jstats.column_mean_var(X, ddof=ddof, **_kw(b))
        for got, want in ((mean, ref[0]), (var, ref[1]),
                          (mean, jmean), (var, jvar)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("sparse", [False, True])
def test_column_moments_staged_do_not_depend_on_block_rows(sparse):
    X = _counts(sparse)
    scale = 1e4 / np.maximum(np.asarray(X.sum(1)).ravel(), 1.0)
    ref = tstats.column_moments_staged(X, row_scale=scale, device="cpu")
    for b in BLOCKS:
        got = tstats.column_moments_staged(X, row_scale=scale, device="cpu",
                                           **_kw(b))
        want = jstats.column_moments_staged(X, row_scale=scale, **_kw(b))
        for i in range(2):
            for j in range(2):
                np.testing.assert_allclose(got[i][j], ref[i][j], rtol=1e-12)
                np.testing.assert_allclose(got[i][j], want[i][j],
                                           rtol=1e-12)


def test_the_default_block_is_the_jax_package_s():
    assert tstats._BLOCK_ROWS == jstats._BLOCK_ROWS == 262_144


@pytest.mark.parametrize("block_rows", [3, tstats._DEVICE_BLOCK_ROWS,
                                        tstats._BLOCK_ROWS])
def test_a_device_block_stops_at_the_f64_cap(block_rows):
    n = tstats._DEVICE_BLOCK_ROWS + 5
    X = np.ones((n, 2), np.float32)
    X[-1] = 3.0
    sizes = [(lo, b.shape[0]) for lo, b in
             tstats._row_blocks(X, block_rows, "cpu")]
    step = min(block_rows, tstats._DEVICE_BLOCK_ROWS)
    assert all(size <= step for _, size in sizes)
    assert [lo for lo, _ in sizes] == list(range(0, n, step))
    assert sum(size for _, size in sizes) == n
    np.testing.assert_array_equal(
        tstats.row_sums(X, block_rows=block_rows, device="cpu"),
        X.astype(np.float64).sum(1))


# ---------------------------------------------------------------------------
# update_W_flag=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_a_fixed_w_batch_solve_matches_jax(beta):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n, g, k, R = 60, 30, 4, 3
    X = (rng.gamma(1.0, 1.0, (n, k)) @ rng.gamma(1.0, 1.0, (k, g))
         + 0.1 * rng.random((n, g))).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (R, n, k)).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (R, k, g)).astype(np.float32)
    H, W, err = tnmf.nmf_fit_batch(torch.as_tensor(X), torch.as_tensor(H0),
                                   torch.as_tensor(W0), beta=beta,
                                   max_iter=60, update_W_flag=False)
    assert np.array_equal(W.numpy(), W0)
    _, W_free, _ = tnmf.nmf_fit_batch(torch.as_tensor(X),
                                      torch.as_tensor(H0),
                                      torch.as_tensor(W0), beta=beta,
                                      max_iter=60)
    assert not np.array_equal(W_free.numpy(), W0)
    for r in range(R):
        Hj, Wj, ej = jnmf.nmf_fit_batch(jnp.asarray(X), jnp.asarray(H0[r]),
                                        jnp.asarray(W0[r]), beta=beta,
                                        max_iter=60, update_W_flag=False)
        assert np.array_equal(np.asarray(Wj), W0[r])
        assert _rel(H[r].numpy(), np.asarray(Hj)) <= 1e-4
        assert float(err[r]) == pytest.approx(float(ej), rel=1e-4)
