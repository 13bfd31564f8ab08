"""Consensus metrics, k-means and OLS of the port against the JAX package.

Distances, KNN local density and silhouette are f32 on both sides. A
distance comes from the quadratic form ``|a|^2 + |b|^2 - 2 a.b``, whose f32
rounding bounds its absolute error near ``eps32 * |a|^2 / d``: at unit-norm
rows that is ``atol 2e-5`` on a distance of ~0.01, beside ``rtol 1e-5``;
the silhouette averages such small within-cluster distances (``rtol
1e-4``). The OLS accumulates in float64 on both sides (``rtol 1e-8``).
k-means draws from a torch generator where the JAX package draws
threefry, so the contract is the JAX package's own: the same cluster
medians up to a permutation of labels.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

# the JAX package's ops/__init__ re-exports functions under these module
# names, so the modules are fetched by path
jkmeans = importlib.import_module("cnmf_torch_tpu.ops.kmeans")
jmetrics = importlib.import_module("cnmf_torch_tpu.ops.metrics")
jols = importlib.import_module("cnmf_torch_tpu.ops.ols")
from cnmf_torch_tpu_torch.ops import kmeans as tkmeans
from cnmf_torch_tpu_torch.ops import metrics as tmetrics
from cnmf_torch_tpu_torch.ops import ols as tols

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each (one spinning thread per core) would oversubscribe
    the cores and slow every worker."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)



def _replicate_spectra(k=4, reps=8, g=60, noise=0.05, seed=0):
    """``reps`` noisy copies of ``k`` spectra, L2-normalized rows, the
    shape consensus clusters."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(0.5, 1.0, (k, g))
    rows = np.concatenate([base * (1 + noise * rng.standard_normal((k, g)))
                           for _ in range(reps)])
    rows = np.abs(rows)
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("n_neighbors", [2, 5])
def test_local_density_matches_jax(n_neighbors):
    A = _replicate_spectra(seed=1)
    dens, D = tmetrics.local_density(A, n_neighbors, device="cpu")
    jdens, jD = jmetrics.local_density(A, n_neighbors)
    np.testing.assert_allclose(D, jD, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(dens, jdens, rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(np.diag(D), 0.0)


def test_silhouette_matches_jax():
    A = _replicate_spectra(seed=2)
    labels = np.tile(np.arange(4), 8)
    labels[:3] = 3          # a few misassigned rows
    got = tmetrics.silhouette_score(A, labels, 4, device="cpu")
    want = jmetrics.silhouette_score(A, labels, 4)
    assert got == pytest.approx(want, rel=1e-4)
    # a singleton cluster scores 0 and an empty one is skipped
    lab = labels.copy()
    lab[5] = 4
    assert tmetrics.silhouette_score(A, lab, 6, device="cpu") == \
        pytest.approx(jmetrics.silhouette_score(A, lab, 6), rel=1e-4)


def test_pairwise_euclidean_matches_jax():
    A = _replicate_spectra(seed=3)
    np.testing.assert_allclose(tmetrics.pairwise_euclidean(A, device="cpu"),
                               jmetrics.pairwise_euclidean(A), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("sparse_y", [False, True])
@pytest.mark.parametrize("normalize_y", [False, True])
def test_ols_all_cols_matches_jax(sparse_y, normalize_y):
    rng = np.random.default_rng(4)
    X = rng.random((90, 4))
    Y = rng.poisson(2.0, (90, 30)).astype(np.float64)
    Y[:, 7] = 0.0            # a zero-variance column
    if sparse_y:
        Y = sp.csr_matrix(Y)
    got = tols.ols_all_cols(X, Y, batch_size=32, normalize_y=normalize_y,
                            device="cpu")
    want = jols.ols_all_cols(X, Y, batch_size=32, normalize_y=normalize_y)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def _medians(A, labels, k):
    return np.stack([np.median(A[labels == c], axis=0) for c in range(k)])


@pytest.mark.parametrize("k,seed", [(4, 5), (6, 6)])
def test_kmeans_medians_match_jax_up_to_permutation(k, seed):
    A = _replicate_spectra(k=k, reps=7, seed=seed)
    labels, centers, inertia = tkmeans.kmeans(A, k, n_init=10, seed=1,
                                              device="cpu")
    jlabels, _, jinertia = jkmeans.kmeans(A, k, n_init=10, seed=1)
    assert sorted(np.unique(labels)) == list(range(k))
    assert inertia == pytest.approx(jinertia, rel=1e-4)
    got = _medians(A, labels, k)
    want = _medians(A, jlabels, k)
    # match each cluster to its nearest JAX cluster: a permutation
    d = ((got[:, None, :] - want[None, :, :]) ** 2).sum(-1)
    perm = d.argmin(axis=1)
    assert sorted(perm) == list(range(k))
    np.testing.assert_allclose(got, want[perm], rtol=1e-6, atol=1e-7)
    assert centers.shape == (k, A.shape[1])


def test_kmeans_is_seeded():
    A = _replicate_spectra(seed=7)
    a = tkmeans.kmeans(A, 4, seed=3, device="cpu")
    b = tkmeans.kmeans(A, 4, seed=3, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
