"""The port's HALS solvers (``algo='halsvar'``, the ``hals`` recipe) against
the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
port solves ``R`` replicates at once, JAX one. Bands: one sweep at ``rtol
1e-5``; the batch and online solves at ``rtol 1e-4`` in the final
objective (f32; the column updates run in JAX's order 0..k-1), the batch
telemetry's iteration counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe
from cnmf_torch_tpu_torch.parallel import replicates as trep


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share the cores; one torch thread each."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _dense(n=64, g=40, k=4, R=3, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, 4)) @ rng.random((4, g))
         + 0.05 * rng.random((n, g))).astype(np.float32)
    X = X / X.std(axis=0, ddof=1)
    H = (rng.random((R, n, k)) + 0.1).astype(np.float32)
    W = (rng.random((R, k, g)) + 0.1).astype(np.float32)
    return X, H, W


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.05, 0.1)])
def test_hals_sweep_matches_jax(l1, l2):
    X, H, W = _dense(seed=1)
    G = _t(W) @ _t(W).mT
    C = _t(X) @ _t(W).mT
    got = tnmf._hals_sweep(_t(H), G, C, l1, l2)
    for r in range(H.shape[0]):
        want = jnmf._hals_sweep(jnp.asarray(H[r]), jnp.asarray(G[r].numpy()),
                                jnp.asarray(C[r].numpy()), l1, l2)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # the sweep writes a fresh tensor
    np.testing.assert_array_equal(_t(H).numpy(), H)


@pytest.mark.parametrize("reg", [(0.0, 0.0, 0.0, 0.0), (0.0, 0.1, 0.0, 0.5)])
def test_batch_hals_matches_jax(reg):
    X, H, W = _dense(seed=2)
    l1_H, l2_H, l1_W, l2_W = reg
    trace = []
    _, W_t, e_t = tnmf.nmf_fit_batch_hals(
        _t(X), _t(H), _t(W), tol=1e-4, max_iter=120, l1_H=l1_H, l2_H=l2_H,
        l1_W=l1_W, l2_W=l2_W, trace=trace)
    assert (trace[0].inner_iters == trace[0].iters).all()
    for r in range(H.shape[0]):
        _, W_j, e_j, tm = jnmf.nmf_fit_batch_hals(
            jnp.asarray(X), jnp.asarray(H[r]), jnp.asarray(W[r]), tol=1e-4,
            max_iter=120, l1_H=l1_H, l2_H=l2_H, l1_W=l1_W, l2_W=l2_W,
            telemetry=True)
        assert float(e_t[r]) == pytest.approx(float(e_j), rel=1e-4)
        np.testing.assert_allclose(W_t[r].numpy(), np.asarray(W_j),
                                   rtol=1e-3, atol=1e-4)
        assert int(trace[0].iters[r]) == int(tm.iters)


def test_online_hals_matches_jax():
    X, H, W = _dense(n=100, seed=3)
    chunk, C = 32, 4
    Xp = np.pad(X, ((0, C * chunk - 100), (0, 0)))
    Hc = np.pad(H, ((0, 0), (0, C * chunk - 100), (0, 0))).reshape(
        3, C, chunk, 4)
    kw = dict(beta=2.0, tol=1e-4, h_tol=3e-3, chunk_max_iter=200,
              n_passes=20, algo="halsvar")
    _, W_t, e_t = tnmf.nmf_fit_online(_t(Xp.reshape(C, chunk, -1)), _t(Hc),
                                      _t(W), **kw)
    for r in range(3):
        _, W_j, e_j = jnmf.nmf_fit_online(
            jnp.asarray(Xp.reshape(C, chunk, -1)), jnp.asarray(Hc[r]),
            jnp.asarray(W[r]), **kw)
        assert float(e_t[r]) == pytest.approx(float(e_j), rel=1e-4)
        np.testing.assert_allclose(W_t[r].numpy(), np.asarray(W_j),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_run_nmf_halsvar_matches_jax(monkeypatch, mode):
    X, H, W = _dense(n=80, R=1, seed=4)
    monkeypatch.setattr(jnmf, "init_factors", lambda *a, **k: (
        jnp.asarray(H[0]), jnp.asarray(W[0])))
    monkeypatch.setattr(tnmf, "random_init", lambda *a, device="cpu", **k: (
        _t(H[0]), _t(W[0])))
    kw = dict(n_components=4, algo="halsvar", mode=mode,
              online_chunk_size=32, batch_max_iter=200, random_state=5)
    H_t, W_t, e_t = tnmf.run_nmf(X, device="cpu", **kw)
    H_j, W_j, e_j = jnmf.run_nmf(X, **kw)
    assert (H_t >= 0).all() and (W_t >= 0).all()
    assert H_t.shape == (80, 4) and W_t.shape == (4, 40)
    assert e_t == pytest.approx(e_j, rel=1e-4)


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_hals_recipe_dispatches_through_the_sweep(mode):
    """The design of ``tests/test_accel.py:test_hals_recipe_dispatches_
    through_sweeps``: the ``hals`` recipe runs the HALS solvers in a sweep;
    from explicit inits each replicate's objective is JAX's HALS solve's."""
    X, H, W = _dense(n=96, g=40, R=2, seed=5)
    trace = []
    spectra, _, errs = trep.replicate_sweep(
        X, [1, 2], 4, mode=mode, online_chunk_size=32, batch_max_iter=300,
        recipe=SolverRecipe("hals", 1, False, "caller"), inits=(H, W),
        trace=trace, device="cpu")
    assert spectra.shape == (2, 4, 40) and np.isfinite(errs).all()
    if mode == "batch":
        assert (trace[0].inner_iters == trace[0].iters).all()
    h_tol, n_passes, _ = jnmf.resolve_online_schedule(2.0)
    for r in range(2):
        if mode == "batch":
            _, _, e_j = jnmf.nmf_fit_batch_hals(
                jnp.asarray(X), jnp.asarray(H[r]), jnp.asarray(W[r]),
                tol=1e-4, max_iter=300)
        else:
            _, _, e_j = jnmf.nmf_fit_online(
                jnp.asarray(X.reshape(3, 32, 40)),
                jnp.asarray(H[r].reshape(3, 32, 4)), jnp.asarray(W[r]),
                beta=2.0, tol=1e-4, h_tol=h_tol, chunk_max_iter=1000,
                n_passes=n_passes, algo="halsvar")
        assert float(errs[r]) == pytest.approx(float(e_j), rel=1e-4)


def test_hals_refuses_other_losses():
    """The designs of ``tests/test_accel.py:test_hals_recipe_rejects_kl``
    and ``tests/test_nmf.py:test_halsvar_solver``: JAX's messages."""
    X, H, W = _dense(n=30, g=20, R=1, seed=6)
    with pytest.raises(ValueError, match="[Ff]robenius"):
        trep.replicate_sweep(X, [1], 3, beta_loss="kullback-leibler",
                             mode="batch", device="cpu",
                             recipe=SolverRecipe("hals", 1, False, "caller"))
    for mode in ("batch", "online"):
        with pytest.raises(ValueError, match="Frobenius"):
            tnmf.run_nmf(X, 4, algo="halsvar", beta_loss="kullback-leibler",
                         mode=mode, device="cpu")
    with pytest.raises(ValueError, match="hals recipe"):
        tnmf.run_nmf(X, 4, beta_loss="itakura-saito", device="cpu",
                     recipe=SolverRecipe("hals", 1, False, "caller"))
    with pytest.raises(ValueError, match="Frobenius"):
        tnmf.nmf_fit_online(_t(X[None]), _t(H[:, None]), _t(W), beta=1.0,
                            algo="halsvar")
    with pytest.raises(NotImplementedError):
        tnmf.run_nmf(X, 4, algo="bpp", device="cpu")
