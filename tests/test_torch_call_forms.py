"""The JAX package's one-replicate call form in the port (fault F9).

The port's solvers and ELL statistics are batched: ``H (R, n, k)`` and
``W (R, k, g)``. The JAX package's public counterparts take one
replicate, ``H (n, k)`` and ``W (k, g)``, and return unbatched shapes with
the objective a scalar. Each port function here also answers that call.
For every case the same numpy inputs (from a seed) go through the port's
one-replicate call, the port's batched call at R=1 and the JAX function;
the one-replicate result must equal the batched lane bit for bit, carry
JAX's shapes, and agree with JAX within the case's band. Mixed ranks (one
factor batched, the other not) raise. JAX's Pallas wrappers run at their
CPU default, as ``tests/test_pallas.py`` runs them.

Bands: statistics at ``tests/test_pallas.py``'s (``rtol 2e-5`` f32,
``2e-2`` bf16); objectives at ``rtol 1e-5``; whole solves' factors within
``1e-4`` of their largest value (measured on these fixtures, largest
gap over H and W: batch ``mu`` 3.0e-6, ``amu`` 8.7e-6, the sketch fed
JAX's draws 1.3e-5, Itakura-Saito on the ELL lane 1.5e-5, online 9.7e-6);
the ``dna`` recipe and dense Itakura-Saito batch solves within ``1e-3``
of it (measured 3.1e-4 and 1.6e-4: dna's per-row Newton/MU choice ties
at rounding once a row has converged, so two correct solvers part, as
``tests/test_torch_batch.py`` notes, and their objectives still agree
to 1.9e-7); HALS at the band of its parity test
(``tests/test_torch_hals.py``: ``rtol 1e-3, atol 1e-4`` on the factors,
the objective at ``rtol 1e-4``).
"""

import ast
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import pallas_kl as pk
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu_torch import convert
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.ops.kernels import kl_ell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32 = dict(rtol=2e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=1e-6)
OBJ_RTOL = 1e-5
FACTOR_BAND = 1e-4          # of the factor's largest value
PARTING_BAND = 1e-3         # dna, dense IS batch (see the docstring)
ITERS = 150                 # the perf gate's count; tol=0 pins it
N, G, K, CHUNK = 96, 64, 7, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _counts(seed=0, scale=1.2):
    """Low-rank Poisson counts (17% nonzeros) and positive factors at the
    data's scale, ``X (N, G)``, ``H (N, K)``, ``W (K, G)``."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(K) * 0.3, size=N)
    spectra = rng.gamma(0.3, 1.0, size=(K, G)) * 40.0 / G
    X = rng.poisson(usage @ spectra * scale).astype(np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    avg = np.sqrt(X.mean() / K)
    H = (avg * (rng.random((N, K)) + 0.2)).astype(np.float32)
    W = (avg * (rng.random((K, G)) + 0.2)).astype(np.float32)
    return X, H, W


def _t(a):
    return torch.as_tensor(np.array(a))


def _lane(X, lane, chunk=None):
    """(JAX X, port X): dense arrays or ELL encodings, row-chunked when
    ``chunk`` is given."""
    if lane == "ell":
        if chunk:
            e, _ = jsp.ell_chunk_rows(sp.csr_matrix(X), chunk)
        else:
            e = jsp.csr_to_ell(sp.csr_matrix(X))
        return (jsp.ell_device_put(e),
                convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t))
    if chunk:
        X = X.reshape(-1, chunk, X.shape[1])
    return jnp.asarray(X), _t(X)


def _items(out):
    return out if isinstance(out, tuple) else (out,)


def _same_bits(one, batched):
    """The one-replicate result is lane 0 of the batched one, bit for
    bit, in JAX's unbatched shape."""
    for a, b in zip(_items(one), _items(batched)):
        assert tuple(a.shape) == tuple(b.shape[1:])
        assert torch.equal(a, b[0])


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

_IDX = np.array([5, 0, 17, 17, 95, 40, 62, 3, 88, 21, 9, 9, 70, 33, 51, 12])

# case -> (port function, JAX function, port kwargs, JAX kwargs, band)
STATS = {
    "ell_kl_h_stats": (tsp.ell_kl_h_stats, jsp.ell_kl_h_stats, {}, {}, F32),
    "ell_kl_h_stats-bf16": (tsp.ell_kl_h_stats, jsp.ell_kl_h_stats,
                            {"bf16": True}, {"bf16_ratio": True}, BF16),
    "ell_wh_at_nz": (tsp.ell_wh_at_nz, jsp.ell_wh_at_nz, {}, {}, F32),
    "ell_kl_h_newton_stats": (tsp.ell_kl_h_newton_stats,
                              jsp.ell_kl_h_newton_stats, {}, {}, F32),
    "ell_kl_w_numer": (tsp.ell_kl_w_numer, jsp.ell_kl_w_numer, {}, {}, F32),
    "ell_kl_w_numer-bf16": (tsp.ell_kl_w_numer, jsp.ell_kl_w_numer,
                            {"bf16": True}, {"bf16_ratio": True}, BF16),
    "ell_kl_w_stats": (tsp.ell_kl_w_stats, jsp.ell_kl_w_stats, {}, {}, F32),
    "ell_kl_w_stats-bf16": (tsp.ell_kl_w_stats, jsp.ell_kl_w_stats,
                            {"bf16": True}, {"bf16_ratio": True}, BF16),
    "ell_kl_w_stats_rows": (tsp.ell_kl_w_stats_rows,
                            jsp.ell_kl_w_stats_rows, {"idx": _IDX},
                            {"idx": jnp.asarray(_IDX)}, F32),
    "ell_is_h_stats": (tsp.ell_is_h_stats, jsp.ell_is_h_stats, {}, {}, F32),
    "ell_is_h_stats-bf16": (tsp.ell_is_h_stats, jsp.ell_is_h_stats,
                            {"bf16": True}, {"bf16_ratio": True}, BF16),
    "ell_is_w_stats": (tsp.ell_is_w_stats, jsp.ell_is_w_stats, {}, {}, F32),
    "ell_is_w_stats-bf16": (tsp.ell_is_w_stats, jsp.ell_is_w_stats,
                            {"bf16": True}, {"bf16_ratio": True}, BF16),
    "ell_beta_err-kl": (tsp.ell_beta_err, jsp.ell_beta_err, {"beta": 1.0},
                        {"beta": 1.0}, F32),
    "ell_beta_err-is": (tsp.ell_beta_err, jsp.ell_beta_err, {"beta": 0.0},
                        {"beta": 0.0}, F32),
    # the kernels' wrappers, against the Pallas kernels they replace
    "kl_h_stats": (kl_ell.kl_h_stats, pk.pallas_kl_h_stats, {}, {}, F32),
    "kl_h_stats-bf16": (kl_ell.kl_h_stats, pk.pallas_kl_h_stats,
                        {"bf16": True}, {"bf16_ratio": True}, BF16),
    "kl_w_numer": (kl_ell.kl_w_numer, pk.pallas_kl_w_numer, {}, {}, F32),
    "kl_w_stats": (kl_ell.kl_w_stats, pk.pallas_kl_w_stats, {}, {}, F32),
    "kl_w_stats-bf16": (kl_ell.kl_w_stats, pk.pallas_kl_w_stats,
                        {"bf16": True}, {"bf16_ratio": True}, BF16),
    "kl_w_stats_rows": (kl_ell.kl_w_stats_rows, jsp.ell_kl_w_stats_rows,
                        {"idx": _IDX}, {"idx": jnp.asarray(_IDX)}, F32),
    "kl_beta_err": (kl_ell.kl_beta_err, pk.pallas_kl_beta_err, {}, {}, F32),
    "kl_h_newton_stats": (kl_ell.kl_h_newton_stats,
                          pk.pallas_kl_h_newton_stats, {}, {}, F32),
    "kl_wh_at_nz": (kl_ell.kl_wh_at_nz, pk.pallas_wh_at_nz, {}, {}, F32),
}


@pytest.mark.parametrize("case", sorted(STATS))
def test_statistic_takes_the_one_replicate_call(case):
    port_fn, jax_fn, pkw, jkw, band = STATS[case]
    X, H, W = _counts(seed=1)
    xj, xt = _lane(X, "ell")
    one = port_fn(xt, _t(H), _t(W), **pkw)
    batched = port_fn(xt, _t(H)[None], _t(W)[None], **pkw)
    want = jax_fn(xj, jnp.asarray(H), jnp.asarray(W), **jkw)
    _same_bits(one, batched)
    assert len(_items(one)) == len(_items(want))
    for got, ref in zip(_items(one), _items(want)):
        assert tuple(got.shape) == tuple(np.shape(ref))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **band)


@pytest.mark.parametrize("beta,lane", [(2.0, "dense"), (1.0, "dense"),
                                       (0.0, "dense"), (1.0, "ell"),
                                       (0.0, "ell")])
def test_beta_divergence_takes_the_one_replicate_call(beta, lane):
    X, H, W = _counts(seed=2)
    xj, xt = _lane(X, lane)
    one = tnmf.beta_divergence(xt, _t(H), _t(W), beta=beta)
    batched = tnmf.beta_divergence(xt, _t(H)[None], _t(W)[None], beta=beta)
    want = jnmf.beta_divergence(xj, jnp.asarray(H), jnp.asarray(W),
                                beta=beta)
    _same_bits(one, batched)
    assert one.shape == () == np.shape(want)
    assert float(one) == pytest.approx(float(want), rel=OBJ_RTOL)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _close_factor(got, want, band):
    want = np.asarray(want, np.float64)
    gap = np.max(np.abs(got.numpy().astype(np.float64) - want))
    assert gap <= band * np.max(np.abs(want)), (gap, np.max(np.abs(want)))


def _jax_rows(steps, m, n):
    """JAX's sketch draws, ``randint(fold_in(key(0), it))`` (torch cannot
    reproduce threefry, so the port takes them as ``sketch_rows``)."""
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.key(0), s), (m,), 0, n))
        for s in range(steps)])


_SKETCH = dict(sketch_dim=24, sketch_exact_every=4)
# (recipe, beta, lane) -> the recipe's keyword arguments
BATCH = {
    ("mu", 2.0, "dense"): {},
    ("mu", 1.0, "dense"): {},
    ("mu", 1.0, "ell"): {},
    ("mu", 0.0, "dense"): {},
    ("mu", 0.0, "ell"): {},
    ("amu", 1.0, "dense"): {"inner_repeats": 3},
    ("amu", 1.0, "ell"): {"inner_repeats": 3},
    ("amu", 2.0, "dense"): {"inner_repeats": 3},
    ("dna", 1.0, "dense"): {"kl_newton": True},
    ("dna", 1.0, "ell"): {"kl_newton": True},
    ("sketch", 1.0, "dense"): _SKETCH,
    ("sketch", 1.0, "ell"): _SKETCH,
}


@pytest.mark.parametrize("recipe,beta,lane", sorted(BATCH))
def test_nmf_fit_batch_takes_the_one_replicate_call(recipe, beta, lane):
    X, H, W = _counts()
    xj, xt = _lane(X, lane)
    kw = dict(beta=beta, tol=0.0, max_iter=ITERS, **BATCH[recipe, beta,
                                                          lane])
    port_kw = dict(kw)
    if recipe == "sketch":
        port_kw["sketch_rows"] = _jax_rows(ITERS, _SKETCH["sketch_dim"], N)
    trace, trace_b = [], []
    one = tnmf.nmf_fit_batch(xt, _t(H), _t(W), trace=trace, **port_kw)
    batched = tnmf.nmf_fit_batch(xt, _t(H)[None], _t(W)[None],
                                 trace=trace_b, **port_kw)
    Hj, Wj, ej, tm = jnmf.nmf_fit_batch(xj, jnp.asarray(H), jnp.asarray(W),
                                        telemetry=True, **kw)
    _same_bits(one, batched)
    H1, W1, e1 = one
    assert (H1.shape, W1.shape, e1.shape) == ((N, K), (K, G), ())
    assert float(e1) == pytest.approx(float(ej), rel=OBJ_RTOL)
    parting = recipe == "dna" or (beta, lane) == (0.0, "dense")
    band = PARTING_BAND if parting else FACTOR_BAND
    _close_factor(H1, Hj, band)
    _close_factor(W1, Wj, band)
    # the trace gets the lane's record, unbatched
    assert len(trace) == 1 and trace[0].iters.shape == ()
    assert int(trace[0].iters) == int(tm.iters)
    np.testing.assert_array_equal(trace[0].trace, trace_b[0].trace[0])


def test_nmf_fit_batch_hals_takes_the_one_replicate_call():
    X, H, W = _counts(seed=3)
    kw = dict(tol=0.0, max_iter=50, l2_W=0.1)
    one = tnmf.nmf_fit_batch_hals(_t(X), _t(H), _t(W), **kw)
    batched = tnmf.nmf_fit_batch_hals(_t(X), _t(H)[None], _t(W)[None], **kw)
    Hj, Wj, ej = jnmf.nmf_fit_batch_hals(jnp.asarray(X), jnp.asarray(H),
                                         jnp.asarray(W), **kw)
    _same_bits(one, batched)
    H1, W1, e1 = one
    assert (H1.shape, W1.shape, e1.shape) == ((N, K), (K, G), ())
    assert float(e1) == pytest.approx(float(ej), rel=1e-4)
    np.testing.assert_allclose(W1.numpy(), np.asarray(Wj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(H1.numpy(), np.asarray(Hj), rtol=1e-3,
                               atol=1e-4)


# (beta, lane, algo)
ONLINE = [(2.0, "dense", "mu"), (1.0, "dense", "mu"), (1.0, "ell", "mu"),
          (0.0, "ell", "mu"), (2.0, "dense", "halsvar")]


@pytest.mark.parametrize("beta,lane,algo", ONLINE)
def test_nmf_fit_online_takes_the_one_replicate_call(beta, lane, algo):
    X, H, W = _counts(seed=4)
    xj, xt = _lane(X, lane, CHUNK)
    Hc = H.reshape(-1, CHUNK, K)
    h_tol, n_passes, h_tol_start = tnmf.resolve_online_schedule(beta)
    kw = dict(beta=beta, tol=1e-4, h_tol=h_tol, chunk_max_iter=200,
              n_passes=n_passes, h_tol_start=h_tol_start, algo=algo)
    trace, passes, trace_b, passes_b = [], [], [], []
    one = tnmf.nmf_fit_online(xt, _t(Hc), _t(W), trace=trace,
                              lane_passes=passes, **kw)
    batched = tnmf.nmf_fit_online(xt, _t(Hc)[None], _t(W)[None],
                                  trace=trace_b, lane_passes=passes_b, **kw)
    Hj, Wj, ej, tm = jnmf.nmf_fit_online(xj, jnp.asarray(Hc),
                                         jnp.asarray(W), telemetry=True,
                                         **kw)
    _same_bits(one, batched)
    H1, W1, e1 = one
    assert (H1.shape, W1.shape, e1.shape) == (Hc.shape, (K, G), ())
    assert float(e1) == pytest.approx(float(ej), rel=OBJ_RTOL)
    _close_factor(H1, Hj, FACTOR_BAND)
    _close_factor(W1, Wj, FACTOR_BAND)
    # one scalar objective a pass, and the passes as JAX counts them
    assert [np.shape(e) for e in trace] == [()] * len(trace_b)
    np.testing.assert_array_equal(trace, [e[0] for e in trace_b])
    assert passes[0].shape == () and int(passes[0]) == int(tm.iters)


# ---------------------------------------------------------------------------
# mixed ranks
# ---------------------------------------------------------------------------

def _calls():
    """(name, call(x_dense, x_ell, x_chunks, H, W))."""
    first = {}      # one case a statistic
    for case in sorted(STATS):
        fn, _, kw, _, _ = STATS[case]
        first.setdefault(f"{fn.__module__.rsplit('.', 1)[1]}.{fn.__name__}",
                         (fn, kw))
    out = [(n, lambda xd, xe, xc, H, W, f=f, kw=kw: f(xe, H, W, **kw))
           for n, (f, kw) in sorted(first.items())]
    out += [
        ("beta_divergence",
         lambda xd, xe, xc, H, W: tnmf.beta_divergence(xd, H, W)),
        ("nmf_fit_batch",
         lambda xd, xe, xc, H, W: tnmf.nmf_fit_batch(xd, H, W, max_iter=2)),
        ("nmf_fit_batch_hals",
         lambda xd, xe, xc, H, W: tnmf.nmf_fit_batch_hals(xd, H, W,
                                                          max_iter=2)),
        ("nmf_fit_online",
         lambda xd, xe, xc, H, W: tnmf.nmf_fit_online(
             xc, H.reshape(*H.shape[:-2], -1, CHUNK, K), W, n_passes=1)),
    ]
    return out


@pytest.mark.parametrize("name,call", _calls(), ids=[n for n, _ in _calls()])
@pytest.mark.parametrize("batched", ["H", "W"])
def test_mixed_ranks_raise(name, call, batched):
    X, H, W = _counts(seed=5)
    xd, xe, xc = _t(X), _lane(X, "ell")[1], _t(X.reshape(-1, CHUNK, G))
    Ht, Wt = _t(H), _t(W)
    if batched == "H":
        Ht = Ht[None]
    else:
        Wt = Wt[None]
    with pytest.raises(ValueError, match=r"H \(.*\) with W \("):
        call(xd, xe, xc, Ht, Wt)


# ---------------------------------------------------------------------------
# the walk: no function of that call form left out
# ---------------------------------------------------------------------------

_FIRST = ({"X", "x", "Xc"}, {"H", "H0", "Hc0"}, {"W", "W0"})
# port function -> why it keeps the batched form only
EXCEPTIONS = {
    "nmf_fit_batch_bundled": ("batched in both packages: JAX's packs "
                              "H0 (R, n, k) and W0 (R, k, g) into bundles "
                              "too, so it has no one-replicate call"),
}
COVERED = ({STATS[c][0].__name__ for c in STATS}
           | {"beta_divergence", "nmf_fit_batch", "nmf_fit_batch_hals",
              "nmf_fit_online"})


def _factor_functions(pkg: str, subdirs=("ops", "parallel", "serving")):
    """Public top-level functions under ``pkg``'s ``subdirs`` whose first
    three parameters are ``(X|x|Xc, H|H0|Hc0, W|W0)``."""
    names = set()
    for sub in subdirs:
        for d, _, files in os.walk(os.path.join(ROOT, pkg, sub)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                with open(os.path.join(d, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in tree.body:
                    if (not isinstance(node, ast.FunctionDef)
                            or node.name.startswith("_")):
                        continue
                    a = [p.arg for p in node.args.posonlyargs
                         + node.args.args][:3]
                    if len(a) == 3 and all(p in s for p, s in
                                           zip(a, _FIRST)):
                        names.add(node.name)
    return names


def _renamed():
    spec = importlib.util.spec_from_file_location(
        "_surface", os.path.join(ROOT, "tests", "test_torch_surface.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RENAMED


def test_every_one_replicate_function_is_a_case_or_an_exception():
    renamed = _renamed()
    jax_side = {renamed.get(n, n) for n in _factor_functions(
        "cnmf_torch_tpu")}
    port_side = _factor_functions("cnmf_torch_tpu_torch")
    assert {"nmf_fit_online", "kl_h_stats", "ell_beta_err"} <= jax_side
    assert jax_side <= port_side, sorted(jax_side - port_side)
    left_out = sorted(port_side - COVERED - set(EXCEPTIONS))
    assert not left_out, f"neither a case nor an exception: {left_out}"
    stale = sorted(set(EXCEPTIONS) - port_side)
    assert not stale and not set(EXCEPTIONS) & COVERED, stale
    for reason in EXCEPTIONS.values():
        assert len(reason) > 20
