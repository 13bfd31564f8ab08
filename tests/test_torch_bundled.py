"""The port's bundle-packed beta=2 batch solver against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. Bands:
the stack round-trips exactly, and equal to JAX's bit for bit (they are
permutations); one packed update at ``rtol 1e-5``; a whole solve at ``rtol
1e-4`` in objectives and spectra with the same iteration counts; and the
port's bundled solve against its own per-replicate ``nmf_fit_batch`` at
``rtol 1e-4`` (the masked cross-replicate terms are exact zeros; only the
matmuls' summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.parallel import replicates as trep


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share the cores; one torch thread each."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _dense(n=48, g=36, k=4, R=5, seed=0):
    """A nonnegative low-rank-plus-noise matrix and stacked inits."""
    rng = np.random.default_rng(seed)
    X = (rng.random((n, 3)) @ rng.random((3, g))
         + 0.05 * rng.random((n, g))).astype(np.float32)
    H = (rng.random((R, n, k)) + 0.1).astype(np.float32)
    W = (rng.random((R, k, g)) + 0.1).astype(np.float32)
    return X, H, W


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("R,k", [(5, 30), (8, 32), (3, 4), (1, 64)])
def test_bundle_stacks_round_trip_and_match_jax(R, k):
    _, H, W = _dense(n=10, g=7, k=k, R=R, seed=R + k)
    per_b = tnmf.bundle_width(k)
    assert per_b == jnmf.bundle_width(k)
    Hb, Wb = tnmf.bundle_stacks(_t(H), _t(W), per_b)
    Hj, Wj = jnmf.bundle_stacks(jnp.asarray(H), jnp.asarray(W), per_b)
    np.testing.assert_array_equal(Hb.numpy(), np.asarray(Hj))
    np.testing.assert_array_equal(Wb.numpy(), np.asarray(Wj))
    assert Hb.shape[0] == -(-R // per_b)
    H2, W2 = tnmf.unbundle_stacks(Hb, Wb, R, k)
    np.testing.assert_array_equal(H2.numpy(), H)
    np.testing.assert_array_equal(W2.numpy(), W)


def test_bundle_mask_matches_jax():
    for per_b, k in [(4, 30), (32, 4), (1, 7)]:
        np.testing.assert_array_equal(
            tnmf._bundle_mask(per_b, k).numpy(),
            np.asarray(jnmf._bundle_mask(per_b, k)))


def test_one_bundled_update_matches_jax():
    X, H, W = _dense(R=7, k=5, seed=1)
    per_b = tnmf.bundle_width(5)
    Hb, Wb = tnmf.bundle_stacks(_t(H), _t(W), per_b)
    mask = tnmf._bundle_mask(per_b, 5)
    reg = (0.01, 0.02, 0.03, 0.01)
    Hn, Wn = tnmf.bundled_beta2_update(_t(X), Hb, Wb, mask, *reg)
    Hj, Wj = jnmf.bundled_beta2_update(
        jnp.asarray(X), jnp.asarray(Hb.numpy()), jnp.asarray(Wb.numpy()),
        jnp.asarray(mask.numpy()), *reg)
    np.testing.assert_allclose(Hn.numpy(), np.asarray(Hj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(Wn.numpy(), np.asarray(Wj), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("R,k,max_iter", [(5, 30, 60), (11, 5, 60),
                                          (3, 4, 25)])
def test_bundled_solve_matches_jax(R, k, max_iter):
    X, H, W = _dense(R=R, k=k, seed=2 + R)
    trace = []
    H_t, W_t, e_t = tnmf.nmf_fit_batch_bundled(
        _t(X), _t(H), _t(W), tol=1e-4, max_iter=max_iter, trace=trace)
    H_j, W_j, e_j, tm = jnmf.nmf_fit_batch_bundled(
        jnp.asarray(X), jnp.asarray(H), jnp.asarray(W), tol=1e-4,
        max_iter=max_iter, telemetry=True)
    assert H_t.shape == (R, 48, k) and W_t.shape == (R, k, 36)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-4)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(trace[0].iters, np.asarray(tm.iters))
    assert not trace[0].nonfinite.any()
    n_eval = trace[0].trace.shape[1]
    np.testing.assert_allclose(trace[0].trace[:, :1],
                               np.asarray(tm.trace)[:, :1], rtol=1e-4)
    assert n_eval == int(np.asarray(tm.iters).max()) // tnmf.EVAL_EVERY


def test_bundled_solve_matches_per_replicate_solve():
    """The design of ``tests/test_nmf.py:test_bundled_batch_solver_matches_
    vmapped``: R not a bundle multiple, the port's bundled solve against
    its own per-replicate batch solver, with the same stopping."""
    X, H, W = _dense(n=60, g=40, R=11, k=5, seed=4)
    t1, t2 = [], []
    Hb, Wb, eb = tnmf.nmf_fit_batch_bundled(_t(X), _t(H), _t(W), tol=1e-4,
                                            max_iter=60, trace=t1)
    Hv, Wv, ev = tnmf.nmf_fit_batch(_t(X), _t(H), _t(W), beta=2.0, tol=1e-4,
                                    max_iter=60, trace=t2)
    np.testing.assert_allclose(Hb.numpy(), Hv.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(Wb.numpy(), Wv.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(eb.numpy(), ev.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(t1[0].iters, t2[0].iters)


def test_batch_sweep_selects_the_bundled_solver(monkeypatch):
    """JAX's ``stacked_solver`` rule (batch, beta=2, plain MU, one inner
    repeat) with at least ``BUNDLE_MIN_WIDTH`` replicates a bundle, where
    JAX takes two: k=22 fits 5 a bundle, k=128 one, and the amu recipe
    repeats H: all three keep ``nmf_fit_batch``."""
    X, _, _ = _dense(n=30, g=20)
    calls = []
    real = tnmf.nmf_fit_batch_bundled

    def spy(*a, **kw):
        calls.append(a[1].shape[-1])
        return real(*a, **kw)

    monkeypatch.setattr(trep, "nmf_fit_batch_bundled", spy)
    monkeypatch.delenv("CNMF_TPU_ACCEL", raising=False)
    spectra, _, errs = trep.replicate_sweep(X, [1, 2, 3], 4, mode="batch",
                                            batch_max_iter=20, device="cpu")
    assert calls == [4] and spectra.shape == (3, 4, 20)
    trep.replicate_sweep(X, [1, 2], 4, mode="online", device="cpu")
    monkeypatch.setenv("CNMF_TPU_ACCEL", "1")
    trep.replicate_sweep(X, [1, 2], 4, mode="batch", batch_max_iter=20,
                         device="cpu")
    assert calls == [4]
    monkeypatch.delenv("CNMF_TPU_ACCEL")
    assert tnmf.bundle_width(21) == trep.BUNDLE_MIN_WIDTH
    assert tnmf.bundle_width(22) == trep.BUNDLE_MIN_WIDTH - 1
    trep.replicate_sweep(X, [1, 2], 22, mode="batch", batch_max_iter=20,
                         device="cpu")
    assert calls == [4]
    assert tnmf.bundle_width(128) == 1
