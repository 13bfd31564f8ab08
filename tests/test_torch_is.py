"""The port's Itakura-Saito (beta=0) and generic-beta solvers against the
JAX package's: the objective, the update steps (dense f32, dense bf16 and
the ELL hybrid), the online, batch (``amu``) and usage-refit solves, and
the sweep's memory budget and lane label for the IS hybrid.

Inputs are made with numpy from a seed and handed to both packages. The
objective and step tests take random sparse data with three all-zero rows,
the regime where the naive IS objective is ``-inf``; the solves take
Poisson counts of a low-rank model (``tests/test_sparse.py``'s
``_lowrank_sparse``). An online IS solve whose chunks are small against
the genes' counts drives WH to the EPS floor at stored counts, in both
packages alike (``tests/test_sparse.py:test_run_nmf_sparse_is_online_
pathology_parity``), so the online parity runs one chunk of 120 rows, and
two chunks of 64 rows only at 60% density in f32;
``test_online_is_multichunk_collapse_matches_jax`` holds the port to JAX
inside that regime (two chunks at 8% and 35% density). Bands: objectives
at ``rtol 1e-5``; one update step
at ``rtol 2e-5`` in f32 and ``rtol 2e-2`` in bf16 (one bf16 rounding of
the ratio chain); the f32 solves at ``rtol 1e-4``; the online solve under
the bf16 ratio chain within 5% (the band of the KL chain's tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu.ops.pallas import kernel_label as jax_kernel_label
from cnmf_torch_tpu.ops.recipe import resolve_recipe as jax_resolve_recipe
from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu_torch import convert
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.ops.kernels import kernel_label
from cnmf_torch_tpu_torch.ops.recipe import resolve_recipe
from cnmf_torch_tpu_torch.parallel import replicates as trep


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share the cores; one torch thread each."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _fixture(n=120, g=72, k=4, R=3, seed=0, density=0.08):
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


def _lowrank(n=120, g=72, k=4, R=2, seed=0, density=0.08):
    """Poisson counts of a low-rank model at about ``density`` nonzeros
    (CSR) and stacked inits."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(k, g)) * 40.0 / g
    lam = usage @ spectra
    X = rng.poisson(lam * -np.log(1.0 - density) / lam.mean()).astype(
        np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    H = rng.random((R, n, k), np.float32) + 0.1
    W = rng.random((R, k, g), np.float32) + 0.1
    return sp.csr_matrix(X), H, W


def _t(a):
    return torch.as_tensor(np.array(a))


def _lanes(X, ell: bool):
    if ell:
        e = jsp.csr_to_ell(X)
        return (jsp.ell_device_put(e),
                convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t))
    Xd = X.toarray()
    return jnp.asarray(Xd), _t(Xd)


@pytest.mark.parametrize("ell", [False, True])
def test_is_objective_matches_jax_and_is_finite(ell):
    X, H, W = _fixture(seed=1)
    xj, xt = _lanes(X, ell)
    got = tnmf.beta_divergence(xt, _t(H), _t(W), beta=0.0)
    assert torch.isfinite(got).all()
    for r in range(H.shape[0]):
        want = float(jnmf.beta_divergence(xj, H[r], W[r], beta=0.0))
        assert np.isfinite(want)
        assert float(got[r]) == pytest.approx(want, rel=1e-5)


def test_is_objective_dense_and_ell_agree():
    X, H, W = _fixture(seed=2)
    _, xd = _lanes(X, False)
    _, xe = _lanes(X, True)
    np.testing.assert_allclose(
        tnmf.beta_divergence(xe, _t(H), _t(W), beta=0.0).numpy(),
        tnmf.beta_divergence(xd, _t(H), _t(W), beta=0.0).numpy(), rtol=1e-5)


def test_is_per_elem_matches_jax_in_both_regimes():
    x = np.asarray([1e-16, 1e-16, 0.5, 2.0, 3.0, 1e-3], np.float32)
    wh = np.asarray([1.0, 1e-16, 0.5, 2.1, 1e-9, 5.0], np.float32)
    got = tsp.is_per_elem(_t(x), _t(wh)).numpy()
    want = np.asarray(jsp.is_per_elem(jnp.asarray(x), jnp.asarray(wh)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


STEP_CASES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("ell,bf16", STEP_CASES)
def test_is_update_steps_match_jax(ell, bf16):
    X, H, W = _fixture(seed=3)
    xj, xt = _lanes(X, ell)
    l1, l2 = 0.01, 0.02
    Hn = tnmf._update_H(xt, _t(H), _t(W), 0.0, l1, l2, bf16_ratio=bf16)
    Wn = tnmf._update_W(xt, _t(H), _t(W), 0.0, l1, l2, bf16_ratio=bf16)
    band = dict(rtol=2e-2, atol=1e-6) if bf16 else dict(rtol=2e-5,
                                                          atol=1e-6)
    for r in range(H.shape[0]):
        np.testing.assert_allclose(
            Hn[r], jnmf._update_H(xj, H[r], W[r], 0.0, l1, l2,
                                  bf16_ratio=bf16), **band)
        np.testing.assert_allclose(
            Wn[r], jnmf._update_W(xj, H[r], W[r], 0.0, l1, l2,
                                  bf16_ratio=bf16), **band)


@pytest.mark.parametrize("bf16", [False, True])
def test_ell_is_stats_match_jax(bf16):
    X, H, W = _fixture(seed=4)
    xj, xt = _lanes(X, True)
    hn, hd = tsp.ell_is_h_stats(xt, _t(H), _t(W), bf16)
    wn, wd = tsp.ell_is_w_stats(xt, _t(H), _t(W), bf16)
    band = dict(rtol=2e-2, atol=1e-5) if bf16 else dict(rtol=2e-5,
                                                          atol=1e-6)
    for r in range(H.shape[0]):
        jhn, jhd = jsp.ell_is_h_stats(xj, H[r], W[r], bf16)
        jwn, jwd = jsp.ell_is_w_stats(xj, H[r], W[r], bf16)
        for got, want in [(hn, jhn), (hd, jhd), (wn, jwn), (wd, jwd)]:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                       **band)


def _online_inputs(X, H, chunk, ell):
    n, k = H.shape[1], H.shape[2]
    if ell:
        e, pad = jsp.ell_chunk_rows(X, chunk)
        xj = jsp.ell_device_put(e)
        xt = convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)
    else:
        C = -(-n // chunk)
        pad = C * chunk - n
        Xp = np.pad(X.toarray(), ((0, pad), (0, 0)))
        xj = jnp.asarray(Xp.reshape(C, chunk, -1))
        xt = _t(Xp.reshape(C, chunk, -1))
    C = -(-n // chunk)
    Hc = np.pad(H, ((0, 0), (0, pad), (0, 0))).reshape(-1, C, chunk, k)
    return xj, xt, Hc


@pytest.mark.parametrize("ell,bf16,rtol,chunk", [(False, False, 1e-4, 120),
                                                 (True, False, 1e-4, 120),
                                                 (True, True, 5e-2, 120),
                                                 (False, True, 5e-2, 120),
                                                 (False, False, 1e-4, 64),
                                                 (True, False, 1e-4, 64)])
def test_online_is_solve_matches_jax(ell, bf16, rtol, chunk):
    if chunk == 120:
        X, H, W = _lowrank(seed=5)
    else:
        X, H, W = _lowrank(n=128, g=32, seed=6, density=0.6)
    xj, xt, Hc = _online_inputs(X, H, chunk, ell)
    h_tol, n_passes, h_tol_start = jnmf.resolve_online_schedule(0.0)
    kw = dict(beta=0.0, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start, bf16_ratio=bf16)
    _, W_t, err_t = tnmf.nmf_fit_online(xt, _t(Hc), _t(W), **kw)
    for r in range(2):
        _, _, err_j = jnmf.nmf_fit_online(xj, Hc[r], W[r], **kw)
        assert np.isfinite(float(err_j))
        assert float(err_t[r]) == pytest.approx(float(err_j), rel=rtol)
        assert torch.isfinite(W_t[r]).all()


def _collapsed(err, n, g):
    """A lane whose final objective averages above 1e3 an entry: WH reached
    the EPS floor at stored counts (a stored count over a floored WH adds
    about ``x / 1e-16``; an entry of a fit off the floor adds tens at
    most, a zero count about 35). NaN counts as collapsed."""
    return ~(np.asarray(err) <= 1e3 * n * g)


@pytest.mark.parametrize("density", [0.08, 0.35])
@pytest.mark.parametrize("ell,bf16", STEP_CASES)
def test_online_is_multichunk_collapse_matches_jax(ell, bf16, density):
    """Two 64-row chunks of 8%- and 35%-dense counts: the regime where the
    online IS solver drives WH to the EPS floor at stored counts
    (objectives near 1e16-1e17, or NaN) in the JAX package. The port
    collapses in the same lanes: each lane's class (collapsed or not) is
    JAX's. In f32 every per-pass and final objective, collapsed lanes
    included, is within ``rtol 1e-4`` of JAX's. Under the bf16 ratio chain
    the first three passes are within 5%, and so is the final objective of
    a lane that did not collapse; a collapsed lane's final value counts
    which stored entries reached the floor, which one bf16 rounding
    decides, so only its class is held."""
    R = 4
    X, H, W = _lowrank(n=128, g=72, R=R, seed=6, density=density)
    xj, xt, Hc = _online_inputs(X, H, 64, ell)
    h_tol, n_passes, h_tol_start = jnmf.resolve_online_schedule(0.0)
    kw = dict(beta=0.0, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start, bf16_ratio=bf16)
    passes = []
    _, _, err_t = tnmf.nmf_fit_online(xt, _t(Hc), _t(W), trace=passes,
                                      **kw)
    trace_t = np.stack(passes)          # (passes, R)
    err_t = err_t.numpy()
    rtol = 5e-2 if bf16 else 1e-4
    for r in range(R):
        _, _, err_j, tel = jnmf.nmf_fit_online(xj, Hc[r], W[r],
                                               telemetry=True, **kw)
        # JAX pads a lane's trace with NaN after its last pass
        trace_j = np.asarray(tel.trace)
        n_cmp = 3 if bf16 else int((~np.isnan(trace_j)).sum())
        np.testing.assert_allclose(trace_t[:n_cmp, r], trace_j[:n_cmp],
                                   rtol=rtol)
        collapsed = _collapsed(err_t[r], 128, 72)
        assert collapsed == _collapsed(float(err_j), 128, 72)
        if not bf16 or not collapsed:
            assert err_t[r] == pytest.approx(float(err_j), rel=rtol,
                                             nan_ok=True)
    # the fixtures are in the regime: most lanes collapse in both packages
    assert _collapsed(err_t, 128, 72).sum() >= R // 2


@pytest.mark.parametrize("ell", [False, True])
def test_batch_is_amu_solve_matches_jax(ell, monkeypatch):
    """Under ``CNMF_TPU_ACCEL=auto`` batch IS resolves to ``amu`` in both
    packages; from the same inits the solves agree."""
    monkeypatch.delenv("CNMF_TPU_ACCEL", raising=False)
    X, H, W = _lowrank(seed=6)
    rec = resolve_recipe(0.0, "batch", ell=ell, n=120, g=72, k=4,
                         ell_width=16 if ell else None)
    rec_j = jax_resolve_recipe(0.0, "batch", ell=ell, n=120, g=72, k=4,
                               ell_width=16 if ell else None)
    assert rec.algo == rec_j.algo == "amu"
    assert rec.inner_repeats == rec_j.inner_repeats
    xj, xt = _lanes(X, ell)
    trace = []
    _, W_t, err_t = tnmf.nmf_fit_batch(
        xt, _t(H), _t(W), beta=0.0, tol=1e-4, max_iter=120,
        inner_repeats=rec.inner_repeats, trace=trace)
    assert (trace[0].inner_iters >= trace[0].iters).all()
    for r in range(2):
        _, _, err_j = jnmf.nmf_fit_batch(
            xj, H[r], W[r], beta=0.0, tol=1e-4, max_iter=120,
            inner_repeats=rec.inner_repeats)
        assert float(err_t[r]) == pytest.approx(float(err_j), rel=1e-4)


def test_is_batch_sweep_runs_amu_on_the_ell_hybrid(monkeypatch):
    """A sparse IS sweep in batch mode: the ELL hybrid under ``amu``, from
    JAX's own inits, the objectives of JAX's sweep."""
    monkeypatch.delenv("CNMF_TPU_ACCEL", raising=False)
    X, _, _ = _lowrank(n=150, g=200, seed=7, density=0.03)
    assert tnmf.run_nmf_use_ell(X, 0.0)
    seeds, k = [3, 4], 3
    kw = dict(beta_loss="itakura-saito", mode="batch", batch_max_iter=100)
    _, _, errs_j = jrep.replicate_sweep(X, seeds, k, **kw)
    H0, W0 = jrep._stacked_inits(jsp.ell_device_put(jsp.csr_to_ell(X)), k,
                                 seeds, "random", n_rows=150)
    trace = []
    spectra, _, errs_t = trep.replicate_sweep(
        X, seeds, k, inits=(np.asarray(H0), np.asarray(W0)), trace=trace,
        device="cpu", **kw)
    assert spectra.shape == (2, k, 200)
    assert trace[0].inner_iters is not None
    np.testing.assert_allclose(errs_t, np.asarray(errs_j), rtol=1e-4)


@pytest.mark.parametrize("ell", [False, True])
def test_fit_h_is_matches_jax(ell):
    X, H, W = _fixture(R=1, seed=8)
    xin = tsp.csr_to_ell(X, transpose=False) if ell else X.toarray()
    xin_j = (jsp.ell_device_put(jsp.csr_to_ell(X, transpose=False)) if ell
             else X.toarray())
    got = tnmf.fit_h(xin, W[0], H_init=H[0], chunk_size=50,
                     chunk_max_iter=40, h_tol=0.0, beta=0.0, device="cpu")
    want = np.asarray(jnmf.fit_h(xin_j, W[0], H_init=H[0], chunk_size=50,
                                 chunk_max_iter=40, h_tol=0.0, beta=0.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="beta in"):
        tnmf.fit_h(tsp.csr_to_ell(X), W[0], beta=2.0, device="cpu")


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_generic_beta_dense_solve_matches_jax(monkeypatch, mode):
    X, H, W = _fixture(R=1, seed=9, density=0.3)
    Xd = X.toarray() + 0.05
    monkeypatch.setattr(jnmf, "init_factors", lambda *a, **k: (
        jnp.asarray(H[0]), jnp.asarray(W[0])))
    monkeypatch.setattr(tnmf, "random_init", lambda *a, device="cpu", **k: (
        _t(H[0]), _t(W[0])))
    kw = dict(n_components=4, beta_loss=1.5, mode=mode, batch_max_iter=150,
              online_chunk_size=48)
    H_t, W_t, e_t = tnmf.run_nmf(Xd, device="cpu", **kw)
    H_j, W_j, e_j = jnmf.run_nmf(Xd, **kw)
    assert np.isfinite(e_t) and H_t.shape == (120, 4)
    assert e_t == pytest.approx(e_j, rel=1e-4)


def test_run_nmf_is_on_both_lanes_matches_jax(monkeypatch):
    X, H, W = _lowrank(R=1, seed=10)
    monkeypatch.setattr(jnmf, "random_init", lambda *a, **k: (
        jnp.asarray(H[0]), jnp.asarray(W[0])))
    monkeypatch.setattr(jnmf, "init_factors", lambda *a, **k: (
        jnp.asarray(H[0]), jnp.asarray(W[0])))
    monkeypatch.setattr(tnmf, "random_init", lambda *a, device="cpu", **k: (
        _t(H[0]), _t(W[0])))
    monkeypatch.setenv("CNMF_TPU_BF16_RATIO", "0")
    for Xin in (X, X.toarray()):
        kw = dict(n_components=4, beta_loss="itakura-saito", mode="online")
        _, _, e_t = tnmf.run_nmf(Xin, device="cpu", **kw)
        _, _, e_j = jnmf.run_nmf(Xin, **kw)
        assert e_t == pytest.approx(e_j, rel=1e-4)


def test_auto_replicates_per_batch_charges_the_is_hybrid():
    """JAX's budget rule: the IS hybrid's dense ``WH`` and ``1/WH`` add
    ``2 * chunk * genes`` a replicate on the ELL lane."""
    kw = dict(n=10_000, g=2000, k=13, chunk=5_000, budget_elems=1 << 31)
    for beta in (1.0, 0.0):
        for width in (184, None):
            got = trep.auto_replicates_per_batch(
                beta=beta, ell_width=width, device="cpu", **kw)
            want = jrep.auto_replicates_per_batch(
                beta=beta, ell_width=width, n_dev=1, **kw)
            assert got == want
    assert (trep.auto_replicates_per_batch(beta=0.0, ell_width=184,
                                           device="cpu", **kw)
            < trep.auto_replicates_per_batch(beta=1.0, ell_width=184,
                                             device="cpu", **kw))


@pytest.mark.parametrize("beta", [1.0, 0.0, 2.0])
@pytest.mark.parametrize("use_ell", [True, False])
def test_kernel_label_follows_the_jax_rule(beta, use_ell):
    """JAX labels the fused-kernel lane only for ELL KL (``use_pallas`` is
    ``use_ell and beta == 1``); the port labels its CUDA lane so, and the
    IS hybrid ``ell-torch`` on every device."""
    use_ell = use_ell and beta != 2.0
    jax_label = jax_kernel_label(use_ell, use_ell and beta == 1.0, False)
    port = kernel_label(use_ell, "cuda:0", False, beta)
    assert (port == "ell-cuda") == (jax_label == "ell-pallas")
    assert (port == "ell-torch") == (jax_label == "ell-jnp")
    assert kernel_label(use_ell, "cpu", False, beta) == (
        "ell-torch" if use_ell else "dense")
