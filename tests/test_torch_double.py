"""``fp_precision="double"``: the whole batch solve in f64, against the
JAX package under ``enable_x64``.

The port's batch solvers keep the dtype of their operands (no f32
constant or mask forces a cast), so f64 ``X``, ``H0`` and ``W0`` give an
f64 solve; ``run_nmf(fp_precision="double")`` makes them so and runs the
plain updates, as the JAX package does. Both sides start from the same
inits (numpy, from a seed; ``run_nmf``'s random draw is replaced by the
same arrays in both packages, since torch cannot reproduce threefry).

Tolerance: final objectives and factors at ``rtol 1e-9`` (the same f64
math in another summation order, over up to 300 iterations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.utils.jax_compat import enable_x64
from cnmf_torch_tpu_torch.ops import nmf as tnmf

F64 = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _problem(n=70, g=50, k=4, seed=0):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k) * 0.4, size=n)
    spectra = rng.gamma(0.5, 1.0, size=(k, g)) * 20.0 / g
    X = rng.poisson(usage @ spectra * 60.0).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1.0
    avg = np.sqrt(X.mean() / k)
    H0 = avg * (rng.random((n, k)) + 0.1)
    W0 = avg * (rng.random((k, g)) + 0.1)
    return X, H0, W0


def _jax_fit(fit, X, H0, W0, **kw):
    with enable_x64():
        H, W, err = fit(jnp.asarray(X, jnp.float64),
                        jnp.asarray(H0, jnp.float64),
                        jnp.asarray(W0, jnp.float64), **kw)
        return np.asarray(H), np.asarray(W), float(err)


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 1.5])
def test_nmf_fit_batch_f64_matches_jax(beta):
    X, H0, W0 = _problem(seed=int(beta * 2))
    kw = dict(tol=1e-6, max_iter=300)
    Hj, Wj, errj = _jax_fit(jnmf.nmf_fit_batch, X, H0, W0, beta=beta, **kw)
    H, W, err = tnmf.nmf_fit_batch(torch.as_tensor(X),
                                   torch.as_tensor(H0)[None],
                                   torch.as_tensor(W0)[None], beta=beta, **kw)
    assert H.dtype == W.dtype == err.dtype == torch.float64
    assert float(err[0]) == pytest.approx(errj, rel=1e-9)
    np.testing.assert_allclose(W[0].numpy(), Wj, **F64)
    np.testing.assert_allclose(H[0].numpy(), Hj, **F64)


def test_nmf_fit_batch_hals_f64_matches_jax():
    X, H0, W0 = _problem(seed=3)
    kw = dict(tol=1e-6, max_iter=300, l1_H=0.01, l2_W=0.02)
    Hj, Wj, errj = _jax_fit(jnmf.nmf_fit_batch_hals, X, H0, W0, **kw)
    H, W, err = tnmf.nmf_fit_batch_hals(torch.as_tensor(X),
                                        torch.as_tensor(H0)[None],
                                        torch.as_tensor(W0)[None], **kw)
    assert W.dtype == torch.float64
    assert float(err[0]) == pytest.approx(errj, rel=1e-9)
    np.testing.assert_allclose(W[0].numpy(), Wj, **F64)


@pytest.mark.parametrize("loss,algo", [("frobenius", "mu"),
                                       ("kullback-leibler", "mu"),
                                       ("frobenius", "halsvar")])
def test_run_nmf_double_matches_jax(monkeypatch, loss, algo):
    """The whole ``run_nmf`` contract: f64 outputs, plain updates (the
    accel knob forced on changes nothing), the same solve as JAX's."""
    X, H0, W0 = _problem(seed=5)
    monkeypatch.setenv("CNMF_TPU_ACCEL", "1")
    monkeypatch.setattr(jnmf, "random_init",
                        lambda *a, **k: (jnp.asarray(H0), jnp.asarray(W0)))
    monkeypatch.setattr(tnmf, "random_init",
                        lambda *a, device="cpu", **k: (torch.as_tensor(H0),
                                                       torch.as_tensor(W0)))
    kw = dict(beta_loss=loss, algo=algo, mode="batch", batch_max_iter=200,
              fp_precision="double", tol=1e-6)
    H, W, err = tnmf.run_nmf(X.astype(np.float32), 4, device="cpu", **kw)
    Hj, Wj, errj = jnmf.run_nmf(X.astype(np.float32), 4, **kw)
    assert H.dtype == W.dtype == np.float64
    assert err == pytest.approx(errj, rel=1e-9)
    np.testing.assert_allclose(W, np.asarray(Wj), **F64)


def test_double_against_float_from_the_same_init():
    X, H0, W0 = _problem(seed=7)
    kw = dict(beta=1.0, tol=1e-4, max_iter=200)
    _, _, e64 = tnmf.nmf_fit_batch(torch.as_tensor(X),
                                   torch.as_tensor(H0)[None],
                                   torch.as_tensor(W0)[None], **kw)
    _, _, e32 = tnmf.nmf_fit_batch(torch.as_tensor(X).float(),
                                   torch.as_tensor(H0).float()[None],
                                   torch.as_tensor(W0).float()[None], **kw)
    assert e32.dtype == torch.float32
    assert float(e32[0]) == pytest.approx(float(e64[0]), rel=1e-3)


def test_online_double_is_refused_with_jax_message():
    X = np.ones((6, 5), np.float32)
    with pytest.raises(NotImplementedError) as got:
        tnmf.run_nmf(X, 2, fp_precision="double", mode="online",
                     device="cpu")
    with pytest.raises(NotImplementedError) as want:
        jnmf.run_nmf(X, 2, fp_precision="double", mode="online")
    assert str(got.value) == str(want.value)
