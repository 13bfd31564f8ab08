"""The environment knobs the port honours, against the JAX package's
readings of the same environment.

Each test sets the environment with ``monkeypatch`` and calls the port's
resolver and the JAX package's on the same arguments; the two must give
the same answer (or raise the same error):

* ``CNMF_TPU_BF16_RATIO``: the bf16 ratio chain of online KL/IS
  (``ops/nmf.py:resolve_bf16_ratio``), announced once per process;
* ``CNMF_TPU_SPARSE_BETA``: the ELL lane (``ops/sparse.py:
  resolve_sparse_beta``), and the lane rule of ``cNMF.factorize`` (the
  JAX planner's ``resolve_encoding``: sparse input, beta in {1, 0},
  random init, plain MU), through a factorize that builds its own
  encoding;
* ``CNMF_TPU_BUDGET_ELEMS``: the replicate slice size
  (``parallel/replicates.py:auto_replicates_per_batch``).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu.runtime.planner import InputStats, resolve_encoding
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.parallel import replicates as trep
from cnmf_torch_tpu_torch.utils.io import load_matrix

KNOBS = ("CNMF_TPU_BF16_RATIO", "CNMF_TPU_SPARSE_BETA",
         "CNMF_TPU_BUDGET_ELEMS")


@pytest.fixture(autouse=True)
def knob_env(monkeypatch):
    """Every test starts with the three knobs unset, the JAX planner's
    autotuner off and the bf16 announcement already made in both packages
    (a test that checks the announcement resets it)."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CNMF_TPU_AUTOTUNE", "0")
    monkeypatch.setattr(tnmf, "_bf16_ratio_announced", True)
    monkeypatch.setattr(jnmf, "_bf16_ratio_announced", True)
    return monkeypatch


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


# ---------------------------------------------------------------------------
# CNMF_TPU_BF16_RATIO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("mode", ["online", "batch"])
@pytest.mark.parametrize("beta", [1.0, 0.0, 2.0])
def test_bf16_ratio_knob_matches_jax(knob_env, env, mode, beta):
    _set(knob_env, "CNMF_TPU_BF16_RATIO", env)
    want = jnmf.resolve_bf16_ratio(beta, mode)
    assert tnmf.resolve_bf16_ratio(beta, mode) is want
    assert want is (beta != 2.0 and mode == "online" and env != "0")
    # an explicit override wins over the knob in both packages
    for override in (False, True):
        assert (tnmf.resolve_bf16_ratio(beta, mode, override)
                is jnmf.resolve_bf16_ratio(beta, mode, override)
                is override)


def test_bf16_ratio_is_announced_once(knob_env, capsys):
    knob_env.setattr(tnmf, "_bf16_ratio_announced", False)
    knob_env.setenv("CNMF_TPU_BF16_RATIO", "0")
    assert tnmf.resolve_bf16_ratio(1.0, "online") is False
    assert capsys.readouterr().out == ""
    knob_env.delenv("CNMF_TPU_BF16_RATIO")
    for _ in range(3):
        assert tnmf.resolve_bf16_ratio(1.0, "online") is True
    assert tnmf.resolve_bf16_ratio(0.0, "online") is True
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    msg = lines[0]
    assert "bf16 ratio chain" in msg and "CNMF_TPU_BF16_RATIO=0" in msg
    # no device speed: the port states no TPU number
    rest = msg.replace("CNMF_TPU_BF16_RATIO", "")
    assert "TPU" not in rest.upper() and "v5e" not in rest


# ---------------------------------------------------------------------------
# CNMF_TPU_SPARSE_BETA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,beta,density,width,g,override,want", [
    ("0", 1.0, 0.05, 10, 200, None, False),     # dense at a sparse input
    ("1", 1.0, 0.3, 60, 200, None, True),       # ELL, past both guards
    ("1", 0.0, 0.3, 60, 200, None, True),
    ("1", 2.0, 0.01, 1, 200, None, False),      # only beta in {1, 0}
    ("0.2", 1.0, 0.15, 10, 200, None, True),    # the threshold moves
    ("0.2", 1.0, 0.25, 10, 200, None, False),
    ("0.2", 1.0, 0.15, 30, 200, None, False),   # the width guard stays
    ("0.2", 1.0, None, None, None, None, False),
    ("-3", 1.0, 0.05, 10, 200, None, False),
    ("7", 1.0, 0.5, 60, 200, None, True),
    (None, 1.0, 0.15, 10, 200, None, False),    # the default threshold
    ("0", 1.0, 0.05, 10, 200, True, True),      # override wins
    ("1", 1.0, 0.05, 10, 200, False, False),
])
def test_sparse_beta_knob_matches_jax(knob_env, env, beta, density, width,
                                      g, override, want):
    _set(knob_env, "CNMF_TPU_SPARSE_BETA", env)
    args = (beta, density, width, g, override)
    assert jsp.resolve_sparse_beta(*args) is want
    assert tsp.resolve_sparse_beta(*args) is want


@pytest.mark.parametrize("env", ["dense", "0.1.2", "1e"])
def test_sparse_beta_knob_rejects_what_jax_rejects(knob_env, env):
    knob_env.setenv("CNMF_TPU_SPARSE_BETA", env)
    with pytest.raises(ValueError) as jerr:
        jsp.resolve_sparse_beta(1.0, 0.05, 10, 200)
    with pytest.raises(ValueError) as terr:
        tsp.resolve_sparse_beta(1.0, 0.05, 10, 200)
    assert str(terr.value) == str(jerr.value)
    assert "CNMF_TPU_SPARSE_BETA" in str(terr.value)


def _csr(n, g, density, seed):
    rng = np.random.default_rng(seed)
    return sp.random(n, g, density=density, format="csr",
                     random_state=int(rng.integers(1 << 31)),
                     data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1
                     ).astype(np.float32)


def _encoding(X, beta, init="random", algo="mu"):
    """The JAX planner's lane for this matrix (no measured crossover)."""
    n, g = X.shape
    stats = InputStats(n=n, g=g, beta=beta, init=init, algo=algo,
                       sparse=sp.issparse(X),
                       density=X.nnz / (n * g) if sp.issparse(X) else None,
                       ell_width=(tsp.ell_row_width(X) if sp.issparse(X)
                                  else None))
    return resolve_encoding(stats, tuned={})[0]


@pytest.mark.parametrize("env", [None, "0", "1", "0.2"])
@pytest.mark.parametrize("algo", ["mu", "halsvar"])
@pytest.mark.parametrize("init", ["random", "nndsvd"])
@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_lane_rule_matches_the_jax_planner(knob_env, env, algo, init, beta):
    """The rule ``cNMF.factorize`` applies (``run_nmf_use_ell``) against
    the JAX planner's ``resolve_encoding``: only plain-MU random-init
    solves of sparse beta in {1, 0} inputs take the ELL lane, and the
    knob then decides, on a 5% and a 15% dense matrix."""
    _set(knob_env, "CNMF_TPU_SPARSE_BETA", env)
    for X in (_csr(200, 400, 0.05, 1), _csr(200, 400, 0.15, 2)):
        want = _encoding(X, beta, init, algo)
        assert tnmf.run_nmf_use_ell(X, beta, init=init, algo=algo) is want
        if algo != "mu" or init != "random" or beta == 2.0:
            assert want is False
    # a dense input never takes the ELL lane
    Xd = _csr(50, 400, 0.05, 3).toarray()
    assert tnmf.run_nmf_use_ell(Xd, 1.0) is _encoding(Xd, 1.0) is False


def _counts_file(d, scale, seed=7, n=300, g=800):
    """Low-rank Poisson counts (the model of ``bench.py``) written as a
    ``.df.npz``; ``scale`` sets how dense the HVG matrix is."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(5) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(5, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * scale).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(d, f"counts_{scale:g}.df.npz")
    save_df_to_npz(Frame(counts, np.array([f"c{i}" for i in range(n)]),
                         np.array([f"g{j}" for j in range(g)])), fn)
    return fn


@pytest.fixture(scope="module")
def prepared_runs(tmp_path_factory):
    """Two prepared KL runs: a sparse HVG matrix (5% nonzeros) that the
    default rule puts on the ELL lane, and a dense one (80%) whose rows
    are also too wide for it."""
    runs = {}
    for label, scale in (("sparse", 8.0), ("dense", 400.0)):
        d = str(tmp_path_factory.mktemp(label))
        obj = cNMF(d, "knob", device="cpu")
        obj.prepare(_counts_file(d, scale), components=[3], n_iter=2,
                    seed=5, beta_loss="kullback-leibler",
                    num_highvar_genes=160, batch_size=128, max_NMF_iter=40)
        runs[label] = obj
    return runs


@pytest.mark.parametrize("data,env,lane", [
    ("sparse", None, "ell"), ("sparse", "0", "dense"),
    ("sparse", "0.01", "dense"), ("dense", None, "dense"),
    ("dense", "0.9", "dense"), ("dense", "1", "ell")])
def test_factorize_lane_follows_the_knob(knob_env, prepared_runs, data,
                                         env, lane):
    """``cNMF.factorize`` builds its own encoding from the normalized
    matrix, so the knob reaches it; its lane is the JAX planner's for the
    same matrix under the same environment, and the sweep runs on it."""
    obj = prepared_runs[data]
    X = load_matrix(obj.paths["normalized_counts"]).X
    density = X.nnz / np.prod(X.shape)
    # the two matrices sit where the cases need them: under both guards,
    # and under a 0.9 threshold but with rows too wide (the width guard)
    if data == "sparse":
        assert density <= 0.10 and 8 * tsp.ell_row_width(X) <= X.shape[1]
    else:
        assert 0.10 < density <= 0.9
        assert 8 * tsp.ell_row_width(X) > X.shape[1]
    _set(knob_env, "CNMF_TPU_SPARSE_BETA", env)
    assert _encoding(X, 1.0) is (lane == "ell")
    obj.factorize()
    info = obj.factorize_info
    assert info["lane"] == lane and info["mode"] == "online"
    assert info["kernel"] == ("ell-torch" if lane == "ell" else "dense-bf16")
    (trace,) = info["trace"][3]
    assert np.isfinite(trace).all() and np.isfinite(info["errs"][3]).all()


# ---------------------------------------------------------------------------
# CNMF_TPU_BUDGET_ELEMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [str(1 << 22), str(1 << 26)])
@pytest.mark.parametrize("width,kl_newton", [(None, False), (184, False),
                                             (184, True)])
def test_budget_knob_sets_the_slice_size(knob_env, budget, width,
                                         kl_newton):
    kw = dict(n=10_000, g=2000, k=13, beta=1.0, chunk=5000,
              ell_width=width, kl_newton=kl_newton)
    default = trep.auto_replicates_per_batch(device="cpu", **kw)
    knob_env.setenv("CNMF_TPU_BUDGET_ELEMS", budget)
    got = trep.auto_replicates_per_batch(device="cpu", **kw)
    assert got == jrep.auto_replicates_per_batch(n_dev=1, **kw)
    assert got != default
    # the knob is read before the card is asked for its free memory
    assert trep._device_budget_elems("cuda") == int(budget)
    # an explicit budget still wins
    assert trep.auto_replicates_per_batch(
        device="cpu", budget_elems=1 << 28, **kw) == default


def test_budget_knob_rejects_what_jax_rejects(knob_env):
    knob_env.setenv("CNMF_TPU_BUDGET_ELEMS", "lots")
    with pytest.raises(ValueError) as jerr:
        jrep._device_budget_elems()
    with pytest.raises(ValueError) as terr:
        trep._device_budget_elems("cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each would oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)
