"""The port's MU solver against the JAX package's, from the same start.

Inputs are made with numpy from a seed and handed to both packages. The
port carries a leading replicate axis (``H (R, n, k)``, ``W (R, k, g)``);
the JAX functions solve one replicate. On the CPU every ELL statistic of
the port runs its plain torch version.

Bands: one update step at ``rtol 2e-5`` in f32 and ``rtol 2e-2`` in bf16
(one bf16 rounding of the ratio chain); objectives at ``rtol 1e-5``; the
online solver's final objective at ``rtol 1e-4`` in f32 and within 5% with
the bf16 chain (the band of ``cnmf_torch_tpu/ops/nmf.py:330-332``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu_torch import convert
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each (one spinning thread per core) would oversubscribe
    the cores and slow every worker."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)



def _fixture(n=150, g=80, k=4, R=3, seed=0, density=0.08):
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=density, format="lil",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1)
    X[:3, :] = 0.0
    X = X.tocsr().astype(np.float32)
    X.eliminate_zeros()
    H = rng.random((R, n, k), np.float32) + 0.1
    W = rng.random((R, k, g), np.float32) + 0.1
    return X, H, W


def _t(a):
    return torch.as_tensor(np.array(a))


def _lanes(X, ell: bool):
    """(jax X, torch X) for one lane: ELL encodings or dense arrays."""
    if ell:
        e = jsp.csr_to_ell(X)
        return (jsp.ell_device_put(e),
                convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t))
    Xd = X.toarray()
    return jnp.asarray(Xd), _t(Xd)


STEP_CASES = [(2.0, False, False), (1.0, False, False), (1.0, False, True),
              (1.0, True, False), (1.0, True, True)]


@pytest.mark.parametrize("beta,ell,bf16", STEP_CASES)
def test_update_steps_match_jax(beta, ell, bf16):
    X, H, W = _fixture()
    xj, xt = _lanes(X, ell)
    l1, l2 = 0.01, 0.02
    Hn = tnmf._update_H(xt, _t(H), _t(W), beta, l1, l2, bf16_ratio=bf16)
    Wn = tnmf._update_W(xt, _t(H), _t(W), beta, l1, l2, bf16_ratio=bf16)
    band = dict(rtol=2e-2, atol=1e-6) if bf16 else dict(rtol=2e-5,
                                                          atol=1e-6)
    for r in range(H.shape[0]):
        np.testing.assert_allclose(
            Hn[r], jnmf._update_H(xj, H[r], W[r], beta, l1, l2,
                                  bf16_ratio=bf16), **band)
        np.testing.assert_allclose(
            Wn[r], jnmf._update_W(xj, H[r], W[r], beta, l1, l2,
                                  bf16_ratio=bf16), **band)


@pytest.mark.parametrize("beta,ell", [(2.0, False), (1.0, False),
                                      (1.0, True)])
def test_beta_divergence_matches_jax(beta, ell):
    X, H, W = _fixture(seed=1)
    xj, xt = _lanes(X, ell)
    got = tnmf.beta_divergence(xt, _t(H), _t(W), beta=beta)
    for r in range(H.shape[0]):
        want = float(jnmf.beta_divergence(xj, H[r], W[r], beta=beta))
        assert float(got[r]) == pytest.approx(want, rel=1e-5)


def _online_inputs(X, H, W, chunk, ell):
    """Chunked data for both packages plus the per-lane chunked inits."""
    n, k = H.shape[1], H.shape[2]
    if ell:
        e, pad = jsp.ell_chunk_rows(X, chunk)
        xj = jsp.ell_device_put(e)
        xt = convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)
    else:
        Xd = X.toarray()
        C = -(-n // chunk)
        pad = C * chunk - n
        Xp = np.pad(Xd, ((0, pad), (0, 0)))
        xj = jnp.asarray(Xp.reshape(C, chunk, -1))
        xt = _t(Xp.reshape(C, chunk, -1))
    C = -(-n // chunk)
    Hc = np.pad(H, ((0, 0), (0, pad), (0, 0))).reshape(-1, C, chunk, k)
    return xj, xt, Hc


# (beta, ell, bf16, use_pallas on the JAX side, rtol of the final objective)
ONLINE_CASES = [(2.0, False, False, False, 1e-4),
                (1.0, True, False, False, 1e-4),
                (1.0, True, False, True, 1e-4),
                (1.0, True, True, False, 5e-2)]


@pytest.mark.parametrize("beta,ell,bf16,pallas,rtol", ONLINE_CASES)
def test_nmf_fit_online_matches_jax(beta, ell, bf16, pallas, rtol):
    X, H, W = _fixture(R=2, seed=2)
    xj, xt, Hc = _online_inputs(X, H, W, 64, ell)
    h_tol, n_passes, h_tol_start = jnmf.resolve_online_schedule(beta)
    assert (h_tol, n_passes, h_tol_start) == \
        tnmf.resolve_online_schedule(beta)
    kw = dict(beta=beta, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start, bf16_ratio=bf16)
    _, W_t, err_t = tnmf.nmf_fit_online(xt, _t(Hc), _t(W), **kw)
    for r in range(H.shape[0]):
        _, W_j, err_j = jnmf.nmf_fit_online(xj, Hc[r], W[r],
                                            use_pallas=pallas, **kw)
        assert float(err_t[r]) == pytest.approx(float(err_j), rel=rtol)
        assert np.isfinite(np.asarray(W_t[r])).all()


@pytest.mark.parametrize("beta,ell,bf16", [(1.0, True, True),
                                           (1.0, False, False),
                                           (2.0, False, False)])
def test_batched_sweep_equals_solo_solves(beta, ell, bf16):
    """R lanes in one batched solve equal R solo solves: a lane that
    stopped keeps its state while the others go on."""
    X, H, W = _fixture(R=3, seed=3)
    _, xt, Hc = _online_inputs(X, H, W, 64, ell)
    h_tol, n_passes, h_tol_start = tnmf.resolve_online_schedule(beta)
    kw = dict(beta=beta, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start, bf16_ratio=bf16)
    trace = []
    Hb, Wb, eb = tnmf.nmf_fit_online(xt, _t(Hc), _t(W), trace=trace, **kw)
    for r in range(3):
        solo = []
        Hs, Ws, es = tnmf.nmf_fit_online(xt, _t(Hc[r:r + 1]),
                                         _t(W[r:r + 1]), trace=solo, **kw)
        np.testing.assert_allclose(Wb[r], Ws[0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(Hb[r], Hs[0], rtol=1e-5, atol=1e-7)
        assert float(eb[r]) == pytest.approx(float(es[0]), rel=1e-6)
        # the lane ran as many passes as its solo solve
        lane = np.stack(trace)[:, r]
        assert len(np.unique(lane[len(solo) - 1:])) == 1


@pytest.mark.parametrize("beta,ell", [(1.0, True), (2.0, False),
                                      (1.0, False)])
def test_fit_h_with_explicit_init_matches_jax(beta, ell):
    X, H, W = _fixture(R=1, seed=4)
    e = jsp.csr_to_ell(X, transpose=False)
    if ell:
        xj, xt = e, convert.ell_matrix(e.vals, e.cols, e.g)
    else:
        xj = xt = X.toarray()
    # h_tol 0 runs exactly chunk_max_iter inner steps in both packages
    kw = dict(chunk_size=64, chunk_max_iter=30, h_tol=0.0, beta=beta)
    got = tnmf.fit_h(xt, W[0], H_init=H[0], device="cpu", **kw)
    want = jnmf.fit_h(xj, W[0], H_init=H[0], **kw)
    assert got.shape == (X.shape[0], W.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_inits_are_seeded_and_device_independent():
    H1, W1 = tnmf.random_init(7, 20, 30, 4, x_mean=2.0)
    H2, W2 = tnmf.random_init(7, 20, 30, 4, x_mean=2.0)
    assert torch.equal(H1, H2) and torch.equal(W1, W2)
    assert float(H1.min()) >= 0.0
    # the scale of the |N(0, 1)| draw is sqrt(mean(X) / k)
    assert float(H1.std()) == pytest.approx(
        np.sqrt(2.0 / 4) * np.sqrt(1 - 2 / np.pi), rel=0.35)
    U = tnmf.fit_h_default_init(50, 3)
    assert torch.equal(U, tnmf.fit_h_default_init(50, 3))
    assert 0.0 <= float(U.min()) and float(U.max()) < 1.0


def test_beta2_trace_identity_and_online_lane_above_threshold_match_jax():
    """The default loss on large inputs: above ``_DENSE_ERR_ELEMS`` both
    packages take the objective from the trace identity (no ``n x g``
    residual), per replicate and per online chunk. Objective at ``rtol
    1e-5``; a 2-chunk online solve whose chunks are above the threshold at
    ``rtol 1e-4``."""
    rng = np.random.default_rng(3)
    n, g, k, chunk = 4098, 2048, 3, 2049
    assert chunk * g > tnmf._DENSE_ERR_ELEMS
    X = (rng.random((n, 5)) @ rng.random((5, g))
         + 0.1 * rng.random((n, g))).astype(np.float32)
    H = (rng.random((2, n, k)) + 0.1).astype(np.float32)
    W = (rng.random((2, k, g)) + 0.1).astype(np.float32)
    got = tnmf.beta_divergence(_t(X), _t(H), _t(W), beta=2.0)
    for r in range(2):
        want = float(jnmf.beta_divergence(jnp.asarray(X), H[r], W[r], 2.0))
        assert float(got[r]) == pytest.approx(want, rel=1e-5)
    Xc = X.reshape(2, chunk, g)
    Hc = H.reshape(2, 2, chunk, k)
    h_tol, n_passes, h_tol_start = tnmf.resolve_online_schedule(2.0)
    kw = dict(beta=2.0, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start)
    _, _, err_t = tnmf.nmf_fit_online(_t(Xc), _t(Hc), _t(W), **kw)
    for r in range(2):
        _, _, err_j = jnmf.nmf_fit_online(jnp.asarray(Xc), Hc[r], W[r], **kw)
        assert float(err_t[r]) == pytest.approx(float(err_j), rel=1e-4)
