"""The nndsvd family of inits in the port, against the JAX package.

The port computes the SVD with ``torch.linalg.svd`` and draws the
``nndsvdar`` fill from a ``torch.Generator``; torch cannot reproduce
JAX's threefry stream, so the fill is compared through its zero set and
range, and exactly where the port is fed JAX's uniforms (``uniforms=``).
The fixture is a nonnegative rank-5 matrix plus noise whose top singular
values are well separated (consecutive ratios at most 0.73), so the SVD
and the positive/negative split of each pair agree between the two
libraries (the split does not depend on the SVD's signs).

Tolerances: the bases, and the filled inits where both are fed the same
uniforms, at ``rtol 1e-4`` (f32 SVDs of two libraries); the zero sets
exactly; whole batch solves from JAX's nndsvd inits (carried across by
``convert.py``) at ``rtol 1e-4`` on the final objective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu_torch import Frame, cNMF, convert, save_df_to_npz
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.parallel import replicates as trep

BASE = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _fixture(n=90, g=70, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.gamma(1.0, 1.0, (n, 5))
    B = rng.gamma(1.0, 1.0, (5, g))
    s = np.asarray([1.0, 0.6, 0.35, 0.2, 0.1])
    return ((A * s) @ B + 0.01 * rng.random((n, g))).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_nndsvd_base_matches_jax(k):
    X = _fixture()
    H, W = tnmf.nndsvd_base(torch.as_tensor(X), k)
    Hj, Wj = jnmf.nndsvd_init(jnp.asarray(X), k, variant="nndsvd")
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), **BASE)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **BASE)
    # the same zero set: exact zeros where a split kept the other part
    np.testing.assert_array_equal(H.numpy() == 0, np.asarray(Hj) == 0)
    np.testing.assert_array_equal(W.numpy() == 0, np.asarray(Wj) == 0)
    assert (H.numpy() == 0).any() and (H.numpy() >= 0).all()


def test_nndsvda_matches_jax():
    X = _fixture()
    H, W = tnmf.nndsvd_init(torch.as_tensor(X), 4, "nndsvda")
    Hj, Wj = jnmf.nndsvd_init(jnp.asarray(X), 4, variant="nndsvda")
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), **BASE)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **BASE)
    assert (H.numpy() > 0).all() and (W.numpy() > 0).all()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_nndsvdar_zero_set_and_fill_range(seed):
    X = _fixture()
    base_H, base_W = jnmf.nndsvd_init(jnp.asarray(X), 4, variant="nndsvd")
    H, W = tnmf.init_factors(torch.as_tensor(X), 4, "nndsvd", seed)
    Hj, Wj = jnmf.init_factors(jnp.asarray(X), 4, "nndsvd",
                               jax.random.key(seed))
    fill = float(X.mean()) / 100.0
    for got, want, base in ((H.numpy(), np.asarray(Hj), base_H),
                            (W.numpy(), np.asarray(Wj), base_W)):
        zero = np.asarray(base) == 0
        # JAX fills exactly its base's zeros, and so does the port
        np.testing.assert_allclose(got[~zero], want[~zero], **BASE)
        assert ((got[zero] >= 0) & (got[zero] < fill * (1 + 1e-6))).all()
        assert ((want[zero] >= 0) & (want[zero] < fill * (1 + 1e-6))).all()
        assert len(np.unique(got[zero])) > 1


def test_nndsvdar_fed_jax_uniforms_equals_jax():
    X = _fixture()
    key = jax.random.key(11)
    Hj, Wj = jnmf.nndsvd_init(jnp.asarray(X), 4, variant="nndsvdar",
                              key=key)
    kh, kw = jax.random.split(key)
    uniforms = (np.asarray(jax.random.uniform(kh, Hj.shape)),
                np.asarray(jax.random.uniform(kw, Wj.shape)))
    H, W = tnmf.nndsvd_init(torch.as_tensor(X), 4, "nndsvdar",
                            uniforms=uniforms)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), **BASE)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **BASE)


@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_batch_solve_from_jax_nndsvd_inits_matches_jax(beta):
    X = _fixture()
    H0, W0 = jnmf.nndsvd_init(jnp.asarray(X), 4, variant="nndsvdar",
                              key=jax.random.key(5))
    Hj, Wj, errj = jnmf.nmf_fit_batch(jnp.asarray(X), H0, W0, beta=beta,
                                      tol=1e-4, max_iter=200)
    Hi, Wi = convert.replicate_inits(np.asarray(H0)[None],
                                     np.asarray(W0)[None])
    H, W, err = tnmf.nmf_fit_batch(torch.as_tensor(X), Hi, Wi, beta=beta,
                                   tol=1e-4, max_iter=200)
    assert float(err[0]) == pytest.approx(float(errj), rel=1e-4)
    np.testing.assert_allclose(W[0].numpy(), np.asarray(Wj), rtol=1e-3,
                               atol=1e-4)


def test_sweep_inits_distinct_and_sequential_equal():
    """Within a K the replicates differ (their seeded fills); a replicate
    of the batched sweep starts where ``run_nmf`` starts for its seed."""
    X = _fixture()
    seeds = [3, 4, 5]
    Xt = torch.as_tensor(X)
    base = tnmf.nndsvd_base(Xt, 4)
    H0, W0 = trep.stacked_inits(float(Xt.mean()), 90, 70, 4, seeds, "cpu",
                                "nndsvd", base)
    assert not torch.equal(H0[0], H0[1]) and not torch.equal(W0[1], W0[2])
    for r, s in enumerate(seeds):
        h, w = tnmf.init_factors(torch.as_tensor(X), 4, "nndsvd", s)
        assert torch.equal(h, H0[r]) and torch.equal(w, W0[r])
    spectra, _, errs = trep.replicate_sweep(X, seeds, 4, init="nndsvd",
                                            mode="batch", device="cpu")
    for r, s in enumerate(seeds):
        _, W, err = tnmf.run_nmf(X, 4, init="nndsvd", mode="batch",
                                 random_state=s, device="cpu")
        assert err == pytest.approx(float(errs[r]), rel=1e-5)
        np.testing.assert_allclose(W, spectra[r], rtol=1e-4, atol=1e-6)


def test_nndsvda_sweep_warns_and_is_degenerate():
    X = _fixture()
    with pytest.warns(UserWarning, match="nndsvda"):
        spectra, _, _ = trep.replicate_sweep(X, [1, 2], 3, init="nndsvda",
                                             mode="batch", device="cpu")
    np.testing.assert_array_equal(spectra[0], spectra[1])


def test_ell_sweeps_refuse_nndsvd_as_jax_does():
    X = sp.csr_matrix(np.where(_fixture() > 4.0, _fixture(), 0.0))
    e = tsp.csr_to_ell(X)
    with pytest.raises(ValueError) as got:
        trep.replicate_sweep(e, [1], 3, init="nndsvd", mode="batch",
                             beta_loss="kullback-leibler", n_rows=90,
                             device="cpu")
    with pytest.raises(ValueError) as want:
        jrep._stacked_inits(jsp.ell_device_put(jsp.csr_to_ell(X)), 3, [1],
                            "nndsvd", n_rows=90)
    assert str(got.value) == str(want.value)
    # a sparse host matrix under init='nndsvd' takes the dense lane
    assert not tnmf.run_nmf_use_ell(X, 1.0, init="nndsvd")
    spectra, _, errs = trep.replicate_sweep(
        X, [1, 2], 3, init="nndsvd", mode="batch",
        beta_loss="kullback-leibler", device="cpu")
    assert np.isfinite(errs).all() and not np.array_equal(spectra[0],
                                                          spectra[1])


def test_factorize_with_nndsvd(tmp_path):
    counts = np.round(_fixture(n=60, g=80) * 3)
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(60)]),
                         np.asarray([f"g{j}" for j in range(80)])), fn)
    obj = cNMF(str(tmp_path), "nnd", device="cpu")
    obj.prepare(fn, components=[3, 4], n_iter=3, seed=2, init="nndsvd",
                num_highvar_genes=40, batch_size=64, max_NMF_iter=50)
    with pytest.raises(ValueError, match="init='random'"):
        obj.factorize(packed=True)
    obj.factorize()
    assert not obj.factorize_info["packed"]
    for k in (3, 4):
        errs = obj.factorize_info["errs"][k]
        assert np.isfinite(errs).all() and len(set(errs.tolist())) == 3
    obj.combine()
