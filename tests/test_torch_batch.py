"""The port's batch KL path against the JAX package's, from the same start.

Covers the two Diagonalized-Newton statistics (``wh_at_nz``,
``h_newton_stats``: the plain torch versions that the CUDA kernels are
held against on the card), the DNA H step, the batch solver under the
``mu``, ``amu`` and ``dna`` recipes, ``run_nmf`` and ``replicate_sweep`` in
batch mode, factorize from a parameters file that says ``mode: batch``,
and the online solver with a forced ``dna`` recipe.

Inputs are made with numpy from a seed and handed to both packages; the
port carries the replicate axis, the JAX functions solve one replicate.
The statistics are held against both the JAX jnp oracles and the Pallas
kernels in interpret mode; whole solves against the jnp lane.

Bands: statistics at ``rtol 2e-5`` (same f32 math, another summation
order); the DNA step's H at ``rtol 2e-5`` with the per-row Newton/MU
choice equal; whole solves' final objectives at ``rtol 1e-4`` with equal
iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import pallas_kl as pk
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu_torch import convert
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.ops.kernels.edge_cases import (EDGE_SHAPES,
                                                         edge_inputs)
from cnmf_torch_tpu_torch.parallel import replicates as trep

F32 = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each (one spinning thread per core) would oversubscribe
    the cores and slow every worker."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def accel_env(monkeypatch):
    for name in ("CNMF_TPU_ACCEL", "CNMF_TPU_KL_NEWTON",
                 "CNMF_TPU_INNER_REPEATS", "CNMF_TPU_SKETCH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CNMF_TPU_AUTOTUNE", "0")
    return monkeypatch


def _t(a):
    return torch.as_tensor(np.array(a))


def _stat_fixture(n=150, g=80, k=4, R=3, seed=0, zero_rows=4):
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=0.08, format="lil",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1)
    X[:zero_rows, :] = 0.0
    X = X.tocsr().astype(np.float32)
    X.eliminate_zeros()
    H = rng.random((R, n, k), np.float32) + 0.1
    W = rng.random((R, k, g), np.float32) + 0.1
    return X, H, W


def _counts(n=150, g=80, k=4, R=3, seed=0, scale=1.5):
    """Low-rank Poisson counts (Dirichlet usages, gamma spectra, as
    ``bench.py`` draws them) and positive inits for ``R`` lanes."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(k, g)) * 40.0 / g
    X = rng.poisson(usage @ spectra * scale).astype(np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    avg = np.sqrt(X.mean() / k)
    H = (avg * (rng.random((R, n, k)) + 0.2)).astype(np.float32)
    W = (avg * (rng.random((R, k, g)) + 0.2)).astype(np.float32)
    return sp.csr_matrix(X), H, W


def _ell_pair(X):
    e = jsp.csr_to_ell(X)
    return (jsp.ell_device_put(e),
            convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t))


def _lanes(X, ell):
    if ell:
        return _ell_pair(X)
    Xd = X.toarray()
    return jnp.asarray(Xd), _t(Xd)


# ---------------------------------------------------------------------------
# the two statistics of the DNA lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,g,k,R", [(150, 80, 4, 3), (130, 100, 5, 2)])
def test_wh_at_nz_matches_jax(n, g, k, R):
    X, H, W = _stat_fixture(n, g, k, R)
    xj, xt = _ell_pair(X)
    got = tsp.ell_wh_at_nz(xt, _t(H), _t(W))
    assert got.shape == (R, n, xt.width) and got.dtype == torch.float32
    assert torch.equal(kl_ell.kl_wh_at_nz(xt, _t(H), _t(W)), got)
    for r in range(R):
        np.testing.assert_allclose(got[r], jsp.ell_wh_at_nz(xj, H[r], W[r]),
                                   **F32)
        np.testing.assert_allclose(got[r], pk.pallas_wh_at_nz(xj, H[r], W[r]),
                                   **F32)


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
@pytest.mark.parametrize("case", ["gene0", "full_row"])
def test_wh_at_nz_edge_inputs_match_jax(n, g, k, R, case):
    """The inputs of the card test ``test_wh_at_nz_matches_plain``: three
    all-zero rows and, in turn, genes 0 and 1 stored in every other row at
    a width that is a multiple of 4 (the kernel's four-slot path) or one
    row filling a width that is not (its one-slot path). The plain
    ``wh_at_nz`` (what a CPU tensor runs, and what the kernel is held
    against) agrees with the JAX oracle on the same encoding; with gene 1's
    W column set to gene 0's, every slot of a row at column 0 or 1 holds
    the same bits, the property the card test asks of the kernel."""
    x, H, W = edge_inputs(n, g, k, R, 0.06, 7, "cpu", zero_rows=3,
                          **{case: True})
    w = x.cols.shape[1]
    if case == "full_row":
        assert int((x.vals[-1] > 0).sum()) == w and w % 4
    else:
        assert w % 4 == 0 and bool(((x.cols == 0) & (x.vals > 0)).any())
    assert bool((x.vals[:3] == 0).all())
    W[:, :, 1] = W[:, :, 0]
    got = kl_ell.wh_at_nz(x.cols, H, W)
    xj = jsp.EllMatrix(jnp.asarray(x.vals.numpy()),
                       jnp.asarray(x.cols.numpy()), g)
    for r in range(R):
        np.testing.assert_allclose(
            got[r], jsp.ell_wh_at_nz(xj, jnp.asarray(H[r].numpy()),
                                     jnp.asarray(W[r].numpy())), **F32)
    at = x.cols <= 1
    assert bool(((x.cols == 0).any(1) & (x.cols == 1).any(1)).any())
    ref = torch.where(at, got, torch.tensor(-np.inf))
    ref = ref.amax(-1, keepdim=True).expand_as(got)
    assert torch.equal(got[:, at], ref[:, at])


# the card tests' edge shapes small enough for interpret mode: with three
# all-zero rows and a row that fills the whole ELL width, the inputs at
# which the kernel is held against the plain version on the card
NEWTON_EDGE = [pytest.param(*shape, True,
                            id="edge-" + "-".join(map(str, shape)))
               for shape in EDGE_SHAPES if shape[0] <= 300 and shape[1] <= 700]


@pytest.mark.parametrize("n,g,k,R,edge", [
    pytest.param(150, 80, 4, 3, False, id="150-80-4-3"),
    pytest.param(130, 100, 5, 2, False, id="130-100-5-2")] + NEWTON_EDGE)
def test_h_newton_stats_match_jax(n, g, k, R, edge):
    if edge:
        x, Ht, Wt = edge_inputs(n, g, k, R, 0.06, 5, "cpu", zero_rows=3,
                                full_row=True)
        assert int((x.vals[-1] > 0).sum()) == x.vals.shape[1]
        xt, H, W, zero_rows = x, Ht.numpy(), Wt.numpy(), 3
        xj = jsp.EllMatrix(jnp.asarray(x.vals.numpy()),
                           jnp.asarray(x.cols.numpy()), g)
    else:
        X, H, W = _stat_fixture(n, g, k, R, seed=1)
        xj, xt = _ell_pair(X)
        zero_rows = 4
    numer, denom, hess = tsp.ell_kl_h_newton_stats(xt, _t(H), _t(W))
    kn, kd, kh = kl_ell.kl_h_newton_stats(xt, _t(H), _t(W))
    assert torch.equal(kn, numer) and torch.equal(kh, hess)
    assert torch.equal(kd, denom)
    for r in range(R):
        jn, jd, jh = jsp.ell_kl_h_newton_stats(xj, H[r], W[r])
        pn, pd, ph = pk.pallas_kl_h_newton_stats(xj, H[r], W[r])
        for got, want in [(numer[r], jn), (numer[r], pn), (hess[r], jh),
                          (hess[r], ph), (denom[r], jd), (denom[r], pd)]:
            np.testing.assert_allclose(got, want, **F32)
    # all-zero cells: exact +0.0 in both outputs (the DNA step keeps
    # zero-padded components at zero through grad = hess = 0)
    for out in (numer, hess):
        zero = out[:, :zero_rows]
        assert torch.all(zero == 0) and not torch.signbit(zero).any()


def test_h_newton_stats_agree_where_wh_underflows():
    """A row whose WH underflows has ``r2 ~ X / EPS^2``: the Hessian may
    overflow, and the port must do what the JAX oracle does (no fast
    math on the card either)."""
    X, H, W = _stat_fixture(40, 30, 3, 1, seed=2, zero_rows=0)
    H[0, :5] = 1e-30
    xj, xt = _ell_pair(X)
    numer, _, hess = tsp.ell_kl_h_newton_stats(xt, _t(H), _t(W))
    jn, _, jh = jsp.ell_kl_h_newton_stats(xj, H[0], W[0])
    np.testing.assert_array_equal(np.isinf(hess[0].numpy()), np.isinf(jh))
    fin = np.isfinite(jh)
    np.testing.assert_allclose(hess[0].numpy()[fin], np.asarray(jh)[fin],
                               **F32)
    np.testing.assert_allclose(numer[0], jn, rtol=2e-5)


def test_cpu_wrappers_refuse_what_the_kernels_refuse():
    X, H, W = _stat_fixture(40, 30, 3, 2, seed=3)
    _, xt = _ell_pair(X)
    kl_ell.reset_launches()
    kl_ell.kl_h_newton_stats(xt, _t(H), _t(W))
    kl_ell.kl_wh_at_nz(xt, _t(H), _t(W))
    assert sum(kl_ell.launches.values()) == 0
    assert set(kl_ell.KERNELS) >= {"h_newton_stats", "wh_at_nz"}
    with pytest.raises(TypeError):
        kl_ell.h_newton_stats(xt.vals.to(torch.bfloat16), xt.cols, _t(H),
                              _t(W))
    with pytest.raises(ValueError, match="contiguous"):
        kl_ell.wh_at_nz(xt.cols, _t(H).transpose(1, 2).contiguous()
                        .transpose(1, 2), _t(W))
    with pytest.raises(ValueError, match="shape"):
        kl_ell.wh_at_nz(xt.cols[:-1], _t(H), _t(W))


# ---------------------------------------------------------------------------
# the DNA step
# ---------------------------------------------------------------------------

def _newton_rows(H_new, H_mu):
    """Which rows took the Newton candidate (differ from the MU one)."""
    return ~np.all(np.asarray(H_new) == np.asarray(H_mu), axis=-1)


@pytest.mark.parametrize("ell", [True, False])
@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.01, 0.02)])
def test_dna_h_step_matches_jax(ell, l1, l2):
    X, H, W = _counts(seed=4)
    xj, xt = _lanes(X, ell)
    H_t, fb_t = tnmf._dna_h_step(xt, _t(H), _t(W), l1, l2)
    if ell:
        numer, denom, _ = tsp.ell_kl_h_newton_stats(xt, _t(H), _t(W))
    for r in range(H.shape[0]):
        H_j, fb_j = jnmf._dna_h_step(xj, H[r], W[r], l1, l2)
        np.testing.assert_allclose(H_t[r], H_j, **F32)
        if ell:
            jn, jd, _ = jsp.ell_kl_h_newton_stats(xj, H[r], W[r])
            mu_j = jnmf._apply_rate(H[r], jn, jd, l1, l2)
            mu_t = tnmf._apply_rate(_t(H[r]), numer[r], denom[r], l1, l2)
        else:
            mu_j = jnmf._update_H(xj, H[r], W[r], 1.0, l1, l2)
            mu_t = tnmf._update_H(xt, _t(H[r:r + 1]), _t(W[r:r + 1]), 1.0,
                                  l1, l2)[0]
        take_t = _newton_rows(H_t[r], mu_t)
        take_j = _newton_rows(H_j, mu_j)
        np.testing.assert_array_equal(take_t, take_j)
        assert float(fb_t[r]) == pytest.approx(float(fb_j), abs=1e-7)
        assert 0.0 < float(fb_t[r]) < 1.0


def test_dna_w_step_matches_jax():
    X, H, W = _counts(seed=5)
    xj, xt = _lanes(X, False)
    W_t, fb_t = tnmf._dna_w_step(xt, _t(H), _t(W), 0.0, 0.0)
    for r in range(H.shape[0]):
        W_j, fb_j = jnmf._dna_w_step(xj, H[r], W[r], 0.0, 0.0)
        np.testing.assert_allclose(W_t[r], W_j, **F32)
        assert float(fb_t[r]) == pytest.approx(float(fb_j), abs=1e-7)


# ---------------------------------------------------------------------------
# the batch solver
# ---------------------------------------------------------------------------

# (recipe, beta, ell): the ELL KL lane under all three recipes, the dense
# lanes at beta in {2, 1}
SOLVE_CASES = [("mu", 1.0, True), ("amu", 1.0, True), ("dna", 1.0, True),
               ("mu", 2.0, False), ("mu", 1.0, False), ("dna", 1.0, False),
               ("amu", 2.0, False)]


def _recipe_kw(name):
    return {"mu": {}, "amu": {"inner_repeats": 3},
            "dna": {"kl_newton": True}}[name]


@pytest.mark.parametrize("recipe,beta,ell", SOLVE_CASES)
def test_nmf_fit_batch_matches_jax(recipe, beta, ell):
    # a fixture whose lanes converge without crossing a saddle: where a
    # trajectory plateaus and then escapes (a component dying or
    # splitting), f32 summation-order differences decide when, and two
    # correct solvers part by up to 1% (seen with other seeds under amu)
    X, H, W = _counts(seed=34)
    xj, xt = _lanes(X, ell)
    kw = dict(beta=beta, tol=1e-4, max_iter=150, l1_H=0.0, l2_H=0.0,
              **_recipe_kw(recipe))
    trace = []
    _, W_t, err_t = tnmf.nmf_fit_batch(xt, _t(H), _t(W), trace=trace, **kw)
    tm_t = trace[0]
    for r in range(H.shape[0]):
        _, W_j, err_j, tm_j = jnmf.nmf_fit_batch(xj, H[r], W[r],
                                                 telemetry=True, **kw)
        assert float(err_t[r]) == pytest.approx(float(err_j), rel=1e-4)
        assert int(tm_t.iters[r]) == int(tm_j.iters)
        n_eval = int(tm_j.iters) // tnmf.EVAL_EVERY
        np.testing.assert_allclose(tm_t.trace[r, :n_eval],
                                   np.asarray(tm_j.trace)[:n_eval],
                                   rtol=1e-4)
        if recipe != "mu":
            assert int(tm_t.inner_iters[r]) == int(tm_j.inner_iters)
        if recipe == "dna":
            # once a row has converged its two candidates tie to rounding
            # and either may win, so over a whole solve the mean fraction
            # moves (test_dna_h_step_matches_jax holds one step's choices
            # equal); a broken Hessian would drive it to 1
            assert float(tm_t.dna_fallback[r]) == pytest.approx(
                float(tm_j.dna_fallback), abs=5e-2)
        assert np.isfinite(np.asarray(W_t[r])).all()
    if recipe == "mu":
        assert tm_t.inner_iters is None and tm_t.dna_fallback is None


@pytest.mark.parametrize("recipe,ell", [("dna", True), ("amu", True),
                                        ("dna", False)])
def test_batched_batch_solve_equals_solo_solves(recipe, ell):
    """R lanes in one batched solve equal R solo solves: a lane that
    stopped keeps its state while the others go on."""
    X, H, W = _counts(seed=7)
    _, xt = _lanes(X, ell)
    # lanes that stop at different iterations
    W[1] *= 3.0
    kw = dict(beta=1.0, tol=1e-3, max_iter=120, **_recipe_kw(recipe))
    trace = []
    Hb, Wb, eb = tnmf.nmf_fit_batch(xt, _t(H), _t(W), trace=trace, **kw)
    iters = []
    for r in range(3):
        solo = []
        Hs, Ws, es = tnmf.nmf_fit_batch(xt, _t(H[r:r + 1]), _t(W[r:r + 1]),
                                        trace=solo, **kw)
        np.testing.assert_allclose(Wb[r], Ws[0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(Hb[r], Hs[0], rtol=1e-5, atol=1e-7)
        assert float(eb[r]) == pytest.approx(float(es[0]), rel=1e-6)
        assert trace[0].iters[r] == solo[0].iters[0]
        iters.append(int(solo[0].iters[0]))
        # NaN once the lane has stopped
        n_eval = iters[-1] // tnmf.EVAL_EVERY
        assert np.isfinite(trace[0].trace[r, :n_eval]).all()
        assert np.isnan(trace[0].trace[r, n_eval:]).all()
    assert len(set(iters)) > 1, iters


@pytest.mark.parametrize("ell", [True, False])
def test_dna_is_monotone_and_takes_fewer_iterations_than_mu(ell):
    """The DNA composite with its MU fallback is monotone, and it reaches
    a fixed KL objective in fewer outer iterations than plain MU (the JAX
    package's ``tests/test_accel.py`` holds the same properties)."""
    X, H, W = _counts(n=200, g=90, k=5, R=1, seed=1, scale=6.0)
    _, xt = _lanes(X, ell)
    traces = {}
    for name, kl_newton in (("mu", False), ("dna", True)):
        trace = []
        _, _, err = tnmf.nmf_fit_batch(xt, _t(H), _t(W), beta=1.0, tol=0.0,
                                       max_iter=300, kl_newton=kl_newton,
                                       trace=trace)
        traces[name] = (trace[0].trace[0], float(err[0]))
    tr = traces["dna"][0]
    assert (np.diff(tr) <= np.abs(tr[:-1]) * 1e-6).all(), tr
    target = min(traces["mu"][1], traces["dna"][1]) * 1.001

    def first_hit(tr):
        hit = np.nonzero(tr <= target)[0]
        return (hit[0] + 1) if len(hit) else len(tr)

    assert first_hit(traces["mu"][0]) >= 1.5 * first_hit(traces["dna"][0])


# ---------------------------------------------------------------------------
# entry points: run_nmf, replicate_sweep, factorize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta_loss,recipe", [
    ("kullback-leibler", "dna"), ("kullback-leibler", "mu"),
    ("frobenius", "mu")])
def test_run_nmf_batch_matches_jax(accel_env, beta_loss, recipe):
    """Both packages draw their init inside ``run_nmf``; the test hands
    the same init to both through their ``random_init``."""
    X, H, W = _counts(n=160, g=320, R=1, seed=8)
    if recipe == "mu":
        accel_env.setenv("CNMF_TPU_ACCEL", "0")
    accel_env.setattr(jnmf, "random_init",
                      lambda *a, **k: (jnp.asarray(H[0]), jnp.asarray(W[0])))
    accel_env.setattr(tnmf, "random_init",
                      lambda *a, device="cpu", **k: (_t(H[0]), _t(W[0])))
    kw = dict(n_components=4, beta_loss=beta_loss, mode="batch",
              batch_max_iter=200, random_state=3)
    if beta_loss == "kullback-leibler":
        assert tnmf.run_nmf_use_ell(X, 1.0) and jnmf.run_nmf_use_ell(X, 1.0)
    H_t, W_t, err_t = tnmf.run_nmf(X, device="cpu", **kw)
    H_j, W_j, err_j = jnmf.run_nmf(X, **kw)
    assert H_t.shape == np.asarray(H_j).shape == (160, 4)
    assert W_t.shape == np.asarray(W_j).shape == (4, 320)
    assert err_t == pytest.approx(err_j, rel=1e-4)


def test_run_nmf_ell_init_scale_is_the_host_mean_as_in_jax(accel_env):
    """On the ELL lane both packages scale ``run_nmf``'s random init by
    the host mean ``X.sum() / (n g)``. ``x_mean`` (factorize's sequential
    lane passes the batched sweep's f32 device sum, ``sweep_x_mean``)
    replaces it, and departs from it by the rounding of one f32 sum."""
    X, _, _ = _counts(n=160, g=320, R=1, seed=8)
    n, g = X.shape
    seen = {}

    def spy(mod, key):
        real = mod.random_init

        def draw(seed, n_, g_, k_, x_mean, *a, **kw):
            seen.setdefault(key, []).append(float(x_mean))
            return real(seed, n_, g_, k_, x_mean, *a, **kw)
        return draw

    accel_env.setattr(jnmf, "random_init", spy(jnmf, "jax"))
    accel_env.setattr(tnmf, "random_init", spy(tnmf, "torch"))
    kw = dict(n_components=4, beta_loss="kullback-leibler", mode="batch",
              batch_max_iter=5, random_state=3)
    assert tnmf.run_nmf_use_ell(X, 1.0)
    tnmf.run_nmf(X, device="cpu", **kw)
    jnmf.run_nmf(X, **kw)
    host = float(X.sum()) / (n * g)
    assert seen["torch"] == [host]
    assert np.float32(seen["jax"][0]) == np.float32(host)
    sweep = tnmf.sweep_x_mean(tsp.csr_to_ell(X).to("cpu"), n, g)
    assert abs(sweep - host) <= 1e-6 * host
    tnmf.run_nmf(X, device="cpu", x_mean=sweep, **kw)
    assert seen["torch"][1] == sweep


def test_run_nmf_online_with_forced_dna_matches_jax(accel_env):
    X, H, W = _counts(n=160, g=320, R=1, seed=9)
    accel_env.setenv("CNMF_TPU_ACCEL", "1")
    accel_env.setattr(jnmf, "random_init",
                      lambda *a, **k: (jnp.asarray(H[0]), jnp.asarray(W[0])))
    accel_env.setattr(tnmf, "random_init",
                      lambda *a, device="cpu", **k: (_t(H[0]), _t(W[0])))
    kw = dict(n_components=4, beta_loss="kullback-leibler", mode="online",
              online_chunk_size=64)
    _, _, err_t = tnmf.run_nmf(X, device="cpu", **kw)
    _, _, err_j = jnmf.run_nmf(X, **kw)
    assert err_t == pytest.approx(err_j, rel=1e-4)


def test_run_nmf_refuses_what_is_not_ported():
    """What neither package implements: an f64 online solve (JAX's
    message), an unknown init, precision or mode."""
    X = np.ones((6, 5), np.float32)
    with pytest.raises(NotImplementedError, match="double"):
        tnmf.run_nmf(X, 2, fp_precision="double", mode="online",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="double"):
        jnmf.run_nmf(X, 2, fp_precision="double", mode="online")
    for kw in (dict(init="svd"), dict(fp_precision="half"),
               dict(mode="sideways")):
        with pytest.raises(ValueError):
            tnmf.run_nmf(X, 2, device="cpu", **kw)


def test_the_sketch_recipe_still_raises(accel_env):
    """``CNMF_TPU_SKETCH=1`` resolves the sketch recipe for KL in both
    packages; the port's solvers run it for KL and still raise where the
    JAX package does: another loss, or mixed with the dna/amu recipes."""
    from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe, resolve_recipe

    accel_env.setenv("CNMF_TPU_SKETCH", "1")
    assert resolve_recipe(1.0, "batch", n=160).algo == "sketch"
    X, H, W = _counts(n=160, g=320, R=1, seed=9)
    _, _, err = tnmf.run_nmf(X, 3, beta_loss="kullback-leibler",
                             mode="batch", device="cpu", batch_max_iter=20)
    assert np.isfinite(err)
    sk = SolverRecipe("sketch", 1, False, "caller", sketch_dim=32,
                      sketch_exact_every=4)
    with pytest.raises(ValueError, match="beta=1"):
        trep.replicate_sweep(X, [1], 3, beta_loss="frobenius",
                             mode="batch", recipe=sk, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        tnmf.nmf_fit_batch(_t(X.toarray()), _t(H), _t(W), beta=1.0,
                           kl_newton=True, sketch_dim=32)
    with pytest.raises(ValueError, match="beta=1"):
        tnmf.nmf_fit_online(_t(X.toarray()[None]), _t(H[:, None]), _t(W),
                            beta=2.0, sketch_dim=32)


def _jax_sweep_inits(X, k, seeds):
    """The inits JAX's batch sweep draws for ``seeds`` on an ELL input."""
    H0, W0 = jrep._stacked_inits(jsp.ell_device_put(jsp.csr_to_ell(X)), k,
                                 seeds, "random", n_rows=X.shape[0])
    return np.asarray(H0), np.asarray(W0)


@pytest.mark.parametrize("recipe", ["dna", "amu", "mu"])
def test_replicate_sweep_batch_matches_jax(accel_env, recipe):
    X, _, _ = _counts(n=160, g=320, R=1, seed=10)
    assert tnmf.run_nmf_use_ell(X, 1.0)
    env = {"dna": {}, "amu": {"CNMF_TPU_KL_NEWTON": "0"},
           "mu": {"CNMF_TPU_ACCEL": "0"}}[recipe]
    for name, value in env.items():
        accel_env.setenv(name, value)
    seeds, k = [11, 12, 13], 4
    kw = dict(beta_loss="kullback-leibler", mode="batch",
              batch_max_iter=200, return_usages=True)
    spectra_j, usages_j, errs_j = jrep.replicate_sweep(X, seeds, k, **kw)
    trace = []
    spectra_t, usages_t, errs_t = trep.replicate_sweep(
        X, seeds, k, inits=_jax_sweep_inits(X, k, seeds), trace=trace,
        device="cpu", **kw)
    assert spectra_t.shape == (3, k, 320) and usages_t.shape == (3, 160, k)
    np.testing.assert_allclose(errs_t, np.asarray(errs_j), rtol=1e-4)
    tm = trace[0]
    assert (tm.dna_fallback is not None) == (recipe == "dna")
    assert (tm.inner_iters is not None) == (recipe != "mu")


def test_convert_carries_batch_state():
    """A whole (unchunked) JAX encoding and stacked ``(R, n, k)`` batch
    inits cross into the port as they are."""
    X, H, W = _counts(seed=13)
    e = jsp.csr_to_ell(X)
    xt = convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)
    assert xt.vals.shape == (150, e.width) and xt.rows_t.dtype == torch.int32
    for a, b in [(xt.vals, e.vals), (xt.cols, e.cols), (xt.rows_t, e.rows_t),
                 (xt.perm_t, e.perm_t)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    H0, W0 = convert.replicate_inits(jnp.asarray(H), jnp.asarray(W))
    assert H0.shape == (3, 150, 4) and W0.shape == (3, 4, 80)
    _, _, err = tnmf.nmf_fit_batch(xt, H0, W0, beta=1.0, max_iter=20,
                                   kl_newton=True)
    assert torch.isfinite(err).all()


def test_replicate_sweep_batch_staging_rules(accel_env):
    X, _, _ = _counts(n=120, g=90, R=1, seed=11, scale=0.7)
    chunked, _ = tsp.ell_chunk_rows(X, 64)
    with pytest.raises(ValueError, match="unchunked"):
        trep.replicate_sweep(chunked, [1], 3, beta_loss="kullback-leibler",
                             mode="batch", device="cpu")
    with pytest.raises(ValueError, match="pre-chunked"):
        trep.replicate_sweep(tsp.csr_to_ell(X), [1], 3,
                             beta_loss="kullback-leibler", mode="online",
                             device="cpu")
    # a beta=2 batch sweep runs the bundled solver
    trace = []
    spectra, _, errs = trep.replicate_sweep(
        X.toarray(), [1, 2], 3, mode="batch", batch_max_iter=30,
        trace=trace, device="cpu")
    assert spectra.shape == (2, 3, 90) and np.isfinite(errs).all()
    assert trace[0].inner_iters is None and trace[0].iters.shape == (2,)
    # a caller-staged unchunked encoding runs with its true cell count
    spectra, _, errs = trep.replicate_sweep(
        tsp.csr_to_ell(X), [1, 2], 3, beta_loss="kullback-leibler",
        mode="batch", batch_max_iter=30, n_rows=120, device="cpu")
    assert spectra.shape == (2, 3, 90) and np.isfinite(errs).all()


def test_auto_replicates_per_batch_charges_the_dna_buffers():
    kw = dict(n=10_000, g=2000, k=13, beta=1.0, chunk=10_000,
              budget_elems=1 << 31, device="cpu")
    for width in (184, None):
        plain = trep.auto_replicates_per_batch(ell_width=width, **kw)
        dna = trep.auto_replicates_per_batch(ell_width=width,
                                             kl_newton=True, **kw)
        assert 1 <= dna < plain
        assert dna == jrep.auto_replicates_per_batch(
            ell_width=width, kl_newton=True, n_dev=1, **{
                a: b for a, b in kw.items() if a != "device"})


@pytest.mark.parametrize("bf16", [False, True])
def test_online_solver_with_forced_dna_matches_jax(accel_env, bf16):
    """``CNMF_TPU_ACCEL=1`` resolves the dna recipe for online KL in both
    packages; the chunk usage solves then run DNA steps in f32 (the bf16
    chain is forced off even when asked for)."""
    accel_env.setenv("CNMF_TPU_ACCEL", "1")
    for mod in ("cnmf_torch_tpu.ops.recipe",
                "cnmf_torch_tpu_torch.ops.recipe"):
        rec = __import__(mod, fromlist=["x"]).resolve_recipe(1.0, "online")
        assert rec.label == "dna" and rec.kl_newton
    X, H, W = _counts(R=2, seed=12, scale=0.7)
    e, pad = jsp.ell_chunk_rows(X, 64)
    xj = jsp.ell_device_put(e)
    xt = convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)
    n, k = H.shape[1], H.shape[2]
    C = e.vals.shape[0]
    Hc = np.pad(H, ((0, 0), (0, pad), (0, 0))).reshape(-1, C, 64, k)
    h_tol, n_passes, h_tol_start = tnmf.resolve_online_schedule(1.0)
    kw = dict(beta=1.0, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start, bf16_ratio=bf16,
              kl_newton=True)
    _, W_t, err_t = tnmf.nmf_fit_online(xt, _t(Hc), _t(W), **kw)
    for r in range(2):
        _, W_j, err_j = jnmf.nmf_fit_online(xj, Hc[r], W[r], **kw)
        assert float(err_t[r]) == pytest.approx(float(err_j), rel=1e-4)
    with pytest.raises(ValueError, match="kl_newton"):
        tnmf.nmf_fit_online(xt, _t(Hc), _t(W), beta=2.0, kl_newton=True)


def test_factorize_runs_the_parameters_files_mode(tmp_path, accel_env):
    """``prepare`` writes ``mode: online``; a user who edits the
    parameters file to ``batch`` gets the batch sweep under the dna
    recipe, recorded in ``factorize_info`` and the provenance."""
    import json

    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

    # the low-rank Poisson model of bench.py: 200 HVGs of 1,000 genes hold
    # ~5% nonzeros at row width 24 <= 200/8, so the ELL lane engages
    rng = np.random.default_rng(7)
    usage = rng.dirichlet(np.ones(6) * 0.2, size=400)
    spectra = rng.gamma(0.25, 1.0, size=(6, 1000)) * 40.0 / 1000
    counts = rng.poisson(usage @ spectra * 10.0).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, np.array([f"c{i}" for i in range(400)]),
                         np.array([f"g{j}" for j in range(1000)])), fn)
    obj = cNMF(str(tmp_path), "b", device="cpu")
    obj.prepare(fn, components=[3, 4], n_iter=3, seed=1,
                num_highvar_genes=200, beta_loss="kullback-leibler")
    params = obj.paths["nmf_run_parameters"]
    with open(params) as f:
        kw = json.load(f)
    assert kw["mode"] == "online"
    kw["mode"] = "batch"
    with open(params, "w") as f:
        json.dump(kw, f)
    obj.factorize()
    info = obj.factorize_info
    assert (info["mode"], info["lane"], info["solver_recipe"],
            info["kernel"]) == ("batch", "ell", "dna", "ell-torch")
    assert not info["bf16_ratio"]
    for k in (3, 4):
        tm = info["trace"][k][0]
        assert tm.trace.shape[0] == 3 and np.isfinite(info["errs"][k]).all()
        assert ((info["dna_fallback"][k] > 0)
                & (info["dna_fallback"][k] < 1)).all()
    with open(obj.paths["factorize_provenance"] % 0) as f:
        prov = json.load(f)["effective_params"]
    assert prov["solver_recipe"] == "dna" and prov["mode"] == "batch"
    obj.combine()
    assert obj.ledger_components() == [3, 4]
