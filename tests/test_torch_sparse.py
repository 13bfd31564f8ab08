"""The port's ELL encoding and plain KL statistics against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX functions and
their counterparts in ``cnmf_torch_tpu_torch`` (on the CPU, where every
kernel wrapper takes its plain torch version). The JAX side runs both its
jnp oracles (``ops/sparse.py``) and its Pallas kernels
(``ops/pallas_kl.py``, interpret mode on the CPU, as ``tests/test_pallas.py``
runs them).

Bands (those of ``tests/test_pallas.py``): f32 statistics at ``rtol 2e-5,
atol 1e-6`` (same math, another summation order); the bf16 chain at
``rtol 2e-2`` against the JAX bf16 oracle.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import pallas_kl as pk
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu_torch import convert
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.ops.kernels import kl_ell, kernel_label

F32 = dict(rtol=2e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=1e-6)

# (n, g, k, R): ragged 128-row and 128-gene tiles on the Pallas side
SHAPES = [(130, 100, 5, 2), (97, 61, 3, 3)]

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each (one spinning thread per core) would oversubscribe
    the cores and slow every worker."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)



def _fixture(n, g, k, R, seed=0, zero_rows=4, zero_genes=5, density=0.08):
    """Sparse counts with ``zero_rows`` all-zero cells and ``zero_genes``
    trailing genes with no nonzero (padded to the sentinel on the
    transpose side), plus positive factors for ``R`` replicates."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=density, format="lil",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1)
    X[:zero_rows, :] = 0.0
    X[:, g - zero_genes:] = 0.0
    X = X.tocsr().astype(np.float32)
    X.eliminate_zeros()
    H = rng.random((R, n, k), np.float32) + 0.1
    W = rng.random((R, k, g), np.float32) + 0.1
    return X, H, W


def _jax_ell(X):
    return jsp.ell_device_put(jsp.csr_to_ell(X))


def _torch_ell(X):
    e = jsp.csr_to_ell(X)
    return convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("n,g,k,R", SHAPES)
def test_csr_to_ell_equals_jax(n, g, k, R, transpose):
    X, _, _ = _fixture(n, g, k, R)
    want = jsp.csr_to_ell(X, transpose=transpose)
    got = tsp.csr_to_ell(X, transpose=transpose)
    assert got.g == want.g
    for leaf in ("vals", "cols", "rows_t", "perm_t"):
        a, b = getattr(got, leaf), getattr(want, leaf)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b, err_msg=leaf)
    assert tsp.ell_row_width(X) == jsp.ell_row_width(X)


@pytest.mark.parametrize("chunk", [32, 64, 500])
def test_ell_chunk_rows_equals_jax(chunk):
    X, _, _ = _fixture(130, 100, 5, 1, seed=3)
    want, want_pad = jsp.ell_chunk_rows(X, chunk)
    got, got_pad = tsp.ell_chunk_rows(X, chunk)
    assert got_pad == want_pad
    for leaf in ("vals", "cols", "rows_t", "perm_t"):
        np.testing.assert_array_equal(getattr(got, leaf),
                                      getattr(want, leaf), err_msg=leaf)


@pytest.mark.parametrize("chunk", [None, 32, 500])
def test_ell_rows_store_their_nonzeros_first(chunk):
    """Every row keeps its stored values (> 0) in its first slots and its
    padding (value 0) after them, also where the CSR input carries
    explicit zeros: the CUDA ``h_stats`` ends a row at its first window of
    32 padded slots, which is exact only under this layout."""
    X, _, _ = _fixture(130, 100, 5, 1, seed=5)
    X = X.tolil()
    X[10, :7] = 0.0           # explicit zeros inside a row's CSR entries
    X = X.tocsr()
    X.data[X.indptr[20]:X.indptr[21]][::2] = 0.0
    assert (X.data == 0).any()
    encodings = ([tsp.csr_to_ell(X), jsp.csr_to_ell(X)] if chunk is None
                 else [tsp.ell_chunk_rows(X, chunk)[0],
                       jsp.ell_chunk_rows(X, chunk)[0]])
    for e in encodings:
        stored = np.asarray(e.vals).reshape(-1, e.vals.shape[-1]) > 0
        # once a slot is padding, every later slot of the row is too
        assert not (np.diff(stored.astype(np.int8), axis=1) > 0).any()
        assert int(stored.sum()) == int((X.data != 0).sum())


@pytest.mark.parametrize("chunk", [None, 32, 500])
def test_ell_genes_store_their_nonzeros_first(chunk):
    """Every gene keeps its stored slots (``perm_t`` below the sentinel
    ``n*w``) first in its transpose slot list and the sentinel after them:
    the CUDA ``w_numer`` ends a gene at its first window of 32 padded
    slots, which is exact only under this layout."""
    X, _, _ = _fixture(130, 100, 5, 1, seed=7)
    encodings = ([tsp.csr_to_ell(X), jsp.csr_to_ell(X)] if chunk is None
                 else [tsp.ell_chunk_rows(X, chunk)[0],
                       jsp.ell_chunk_rows(X, chunk)[0]])
    for e in encodings:
        n, w = np.asarray(e.vals).shape[-2:]
        perm_t = np.asarray(e.perm_t).reshape(-1, e.perm_t.shape[-1])
        stored = perm_t < n * w
        assert (perm_t[~stored] == n * w).all()
        # once a slot is padding, every later slot of the gene is too
        assert not (np.diff(stored.astype(np.int8), axis=1) > 0).any()
        assert int(stored.sum()) == X.nnz


@pytest.mark.parametrize("bf16,vals_bf16", [(False, False), (True, False),
                                            (True, True)])
def test_w_numer_on_cpu_is_the_plain_composition(bf16, vals_bf16):
    """On CPU tensors the fused W numerator's wrapper takes its plain
    version, which equals the row-side ratio then the transpose reduce
    (``ell_kl_w_numer``) bit for bit and counts no launch."""
    X, H, W = _fixture(97, 61, 4, 3, seed=8)
    xt = _torch_ell(X)
    vals = xt.vals.to(torch.bfloat16) if vals_bf16 else xt.vals
    H, W = _t(H), _t(W)
    kl_ell.reset_launches()
    got = kl_ell.w_numer(vals, xt.cols, xt.rows_t, xt.perm_t, H, W, bf16)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 61)
    assert torch.equal(got, tsp.ell_kl_w_numer(xt.with_vals(vals), H, W,
                                               bf16))
    assert torch.equal(got, kl_ell.kl_w_numer(xt.with_vals(vals), H, W,
                                              bf16))
    assert kl_ell.launches["w_numer"] == 0
    assert torch.all(got[:, :, -5:] == 0)


@pytest.mark.parametrize("case,error", [
    ("vals f64", TypeError), ("bf16 vals in f32 mode", TypeError),
    ("rows_t int64", TypeError), ("cols int64", TypeError),
    ("H f64", TypeError),
    ("perm_t narrower than rows_t", ValueError),
    ("W of other genes", ValueError), ("vals of other rows", ValueError),
    ("H not contiguous", ValueError), ("no transpose set", ValueError),
    ("k too large", ValueError)])
def test_w_numer_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    X, H, W = _fixture(64, 40, 3, 2, seed=9)
    xt = _torch_ell(X)
    args = dict(vals=xt.vals, cols=xt.cols, rows_t=xt.rows_t,
                perm_t=xt.perm_t, H=_t(H), W=_t(W), bf16=False)
    k = kl_ell.MAX_K + 1
    args.update({
        "vals f64": dict(vals=xt.vals.double()),
        "bf16 vals in f32 mode": dict(vals=xt.vals.to(torch.bfloat16)),
        "rows_t int64": dict(rows_t=xt.rows_t.long()),
        "cols int64": dict(cols=xt.cols.long()),
        "H f64": dict(H=args["H"].double()),
        "perm_t narrower than rows_t": dict(perm_t=xt.perm_t[:, :-1]
                                            .contiguous()),
        "W of other genes": dict(W=args["W"][:, :, :-1].contiguous()),
        "vals of other rows": dict(vals=xt.vals[:-1].contiguous()),
        "H not contiguous": dict(H=args["H"].transpose(1, 2).contiguous()
                                 .transpose(1, 2)),
        "no transpose set": dict(rows_t=None, perm_t=None),
        "k too large": dict(H=torch.ones((2, 64, k)),
                            W=torch.ones((2, k, 40))),
    }[case])
    with pytest.raises(error):
        kl_ell.w_numer(**args)


@pytest.mark.parametrize("beta,density,width,g,want", [
    (1.0, 0.05, 10, 200, True), (1.0, 0.2, 10, 200, False),
    (1.0, 0.05, 30, 200, False), (2.0, 0.01, 1, 200, False),
    (1.0, None, None, None, False)])
def test_resolve_sparse_beta_matches_jax_rule(beta, density, width, g,
                                             want):
    assert tsp.resolve_sparse_beta(beta, density, width, g) is want
    assert jsp.resolve_sparse_beta(beta, density, width, g) is want


@pytest.mark.parametrize("n,g,k,R", SHAPES)
def test_h_stats_f32_matches_jax(n, g, k, R):
    X, H, W = _fixture(n, g, k, R)
    xj, xt = _jax_ell(X), _torch_ell(X)
    numer, denom = tsp.ell_kl_h_stats(xt, _t(H), _t(W))
    for r in range(R):
        jn, jd = jsp.ell_kl_h_stats(xj, H[r], W[r])
        pn, _ = pk.pallas_kl_h_stats(xj, H[r], W[r])
        np.testing.assert_allclose(numer[r], jn, **F32)
        np.testing.assert_allclose(numer[r], pn, **F32)
        np.testing.assert_allclose(denom[r], jd, rtol=1e-6)
    # all-zero cells have no support: their numerator is exactly 0
    assert torch.all(numer[:, :4] == 0)


@pytest.mark.parametrize("n,g,k,R", SHAPES)
def test_h_stats_bf16_matches_jax(n, g, k, R):
    X, H, W = _fixture(n, g, k, R, seed=1)
    xj, xt = _jax_ell(X), _torch_ell(X)
    vals = xt.vals.to(torch.bfloat16)
    numer = kl_ell.h_stats(vals, xt.cols, _t(H), _t(W), bf16=True)
    for r in range(R):
        jn, _ = jsp.ell_kl_h_stats(xj, H[r], W[r], bf16_ratio=True)
        pn, _ = pk.pallas_kl_h_stats(xj, H[r], W[r], bf16_ratio=True)
        np.testing.assert_allclose(numer[r], jn, **BF16)
        np.testing.assert_allclose(numer[r], pn, **BF16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,g,k,R", SHAPES)
def test_w_stats_match_jax(n, g, k, R, bf16):
    X, H, W = _fixture(n, g, k, R, seed=2)
    xj, xt = _jax_ell(X), _torch_ell(X)
    numer, denom = tsp.ell_kl_w_stats(xt, _t(H), _t(W), bf16)
    assert torch.equal(numer, tsp.ell_kl_w_numer(xt, _t(H), _t(W), bf16))
    band = BF16 if bf16 else F32
    for r in range(R):
        jn = jsp.ell_kl_w_numer(xj, H[r], W[r], bf16_ratio=bf16)
        pn, pd = pk.pallas_kl_w_stats(xj, H[r], W[r], bf16_ratio=bf16)
        np.testing.assert_allclose(numer[r], jn, **band)
        np.testing.assert_allclose(numer[r], pn, **band)
        np.testing.assert_allclose(denom[r], pd, rtol=1e-6)
    # genes with no nonzero gather only the zero sentinel slot
    assert torch.all(numer[:, :, -5:] == 0)


@pytest.mark.parametrize("n,g,k,R", SHAPES)
def test_beta_err_matches_jax(n, g, k, R):
    X, H, W = _fixture(n, g, k, R, seed=4)
    xj, xt = _jax_ell(X), _torch_ell(X)
    got = tsp.ell_beta_err(xt, _t(H), _t(W))
    for r in range(R):
        want = float(jsp.ell_beta_err(xj, H[r], W[r], 1.0))
        kern = float(pk.pallas_kl_beta_err(xj, H[r], W[r]))
        assert float(got[r]) == pytest.approx(want, rel=2e-5)
        assert float(got[r]) == pytest.approx(kern, rel=2e-5)


@pytest.mark.parametrize("n,g,k,R", SHAPES)
def test_beta_err_rows_match_jax(n, g, k, R):
    """Each row's term of ``beta_err_partials`` (on the CPU, its plain
    version ``ell_beta_err_rows``) plus that row's ``sum WH`` is the JAX
    objective of the row's one-row encoding, from its oracle and from its
    Pallas kernel in interpret mode: at the four all-zero rows (exactly
    +0.0), at a row whose H is scaled by 1e-9 (every slot in the split-log
    regime, WH/X < 1e-6) and at a few others."""
    X, H, W = _fixture(n, g, k, R, seed=10)
    tiny = 5
    H[:, tiny] *= np.float32(1e-9)
    xt = _torch_ell(X)
    Ht, Wt = _t(H), _t(W)
    kl_ell.reset_launches()
    rows = kl_ell.beta_err_partials(xt.vals, xt.cols, Ht, Wt)
    assert rows.dtype == torch.float32 and rows.shape == (R, n)
    assert kl_ell.launches["beta_err_partials"] == 0
    assert torch.equal(rows, tsp.ell_beta_err_rows(xt.vals, xt.cols, Ht, Wt))
    assert torch.equal(rows.sum(1),
                       tsp.ell_beta_err_nz(xt.vals, xt.cols, Ht, Wt))
    assert torch.all(rows[:, :4] == 0)
    assert not torch.signbit(rows[:, :4]).any()
    stored = xt.vals[tiny] > 0
    wh = tsp.ell_wh_slots(xt.cols, Ht, Wt)[:, tiny][:, stored]
    assert bool(stored.any())
    assert bool((wh / xt.vals[tiny][stored] < 1e-6).all())
    for i in (0, 3, tiny, n // 2, n - 1):
        xj = _jax_ell(X[i:i + 1])
        for r in range(R):
            got = float(rows[r, i] + Ht[r, i] @ Wt[r].sum(1))
            want = float(jsp.ell_beta_err(xj, H[r, i:i + 1], W[r], 1.0))
            kern = float(pk.pallas_kl_beta_err(xj, H[r, i:i + 1], W[r]))
            assert got == pytest.approx(want, rel=2e-5)
            assert got == pytest.approx(kern, rel=2e-5)


def test_kl_nz_term_matches_jax_in_both_regimes():
    rng = np.random.default_rng(5)
    xp = rng.gamma(2.0, 1.0, 64).astype(np.float32) + 0.1
    # ratios from ~1e-9 (the split-log regime) to ~10
    whs = (xp * np.logspace(-9, 1, 64)).astype(np.float32)
    got = tsp.kl_nz_term(_t(xp), _t(whs))
    want = jsp.kl_nz_term(xp, whs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_cpu_wrappers_take_the_plain_versions(bf16):
    X, H, W = _fixture(64, 40, 3, 2, seed=6)
    xt = _torch_ell(X)
    H, W = _t(H), _t(W)
    kl_ell.reset_launches()
    for got, want in [(kl_ell.kl_h_stats(xt, H, W, bf16),
                       tsp.ell_kl_h_stats(xt, H, W, bf16)),
                      (kl_ell.kl_w_stats(xt, H, W, bf16),
                       tsp.ell_kl_w_stats(xt, H, W, bf16))]:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(kl_ell.kl_beta_err(xt, H, W),
                       tsp.ell_beta_err(xt, H, W))
    # a CPU tensor never counts as a kernel launch
    assert sum(kl_ell.launches.values()) == 0
    assert kernel_label(True, "cpu") == "ell-torch"
    assert kernel_label(True, "cuda:0") == "ell-cuda"
    assert kernel_label(False, "cuda", bf16_ratio=True) == "dense-bf16"
    with pytest.raises(ValueError):
        kl_ell.kl_w_numer(tsp.csr_to_ell(X, transpose=False).to("cpu"), H, W)
    # the CPU holds callers to the kernels' layout too
    with pytest.raises(ValueError, match="contiguous"):
        kl_ell.h_stats(xt.vals, xt.cols,
                       H.transpose(1, 2).contiguous().transpose(1, 2), W)
    k = kl_ell.MAX_K + 1
    with pytest.raises(ValueError, match="k <="):
        kl_ell.h_stats(xt.vals, xt.cols, torch.ones((1, 64, k)),
                       torch.ones((1, k, 40)))
