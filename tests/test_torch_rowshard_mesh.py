"""The row-sharded solver across cells shards (``parallel/rowshard.py``
over ``parallel/mesh.py``), on the CPU, against the JAX package's
``nmf_fit_rowsharded`` on as many of its 8 virtual devices.

Both start from JAX's init (``init_factors``, the padded matrix's rows):
W and H within ``rtol 1e-4``, the objective within ``1e-4``, on 1, 2 and 4
shards, beta in {2, 1}, dense and the ELL lane (a CSR input under the
ELL rule: one global row width, a transpose set a shard). A row count
that is not a multiple of the shards is padded, as JAX pads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh as JMesh

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.parallel import rowshard as jrs
from cnmf_torch_tpu_torch.ops.sparse import EllMatrix
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.parallel.mesh import Mesh

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _lowrank(n=301, g=200, k=4, scale=0.7, seed=0):
    """~5% nonzeros and rows of at most 24 stored values: the ELL rule's
    side; 301 rows pad to 302 and 304 on 2 and 4 shards."""
    rng = np.random.default_rng(seed)
    U = rng.dirichlet(np.ones(k) * 0.3, size=n)
    S = rng.gamma(0.3, 1.0, size=(k, g)) * 50.0 / g
    X = rng.poisson(U @ S * scale).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    return X


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_init(X, k, seed, shards):
    n, g = X.shape
    Xd = X.toarray() if sp.issparse(X) else X
    n_pad = n + (-n) % shards
    Xp = np.pad(Xd, ((0, n_pad - n), (0, 0)))
    H0, W0 = jnmf.random_init(jax.random.key(seed), n_pad, g, k,
                              jnp.mean(jnp.asarray(Xp)))
    return np.asarray(H0), np.asarray(W0)


def _meshes(shards):
    return (JMesh(np.asarray(jax.devices()[:shards]), ("cells",)),
            Mesh(["cpu"] * shards, ("cells",)))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_the_sharded_solve_matches_jax(shards, beta_loss, kind):
    X = _lowrank()
    X = sp.csr_matrix(X) if kind == "csr" else X
    jmesh, tmesh = _meshes(shards)
    Hj, Wj, ej = jrs.nmf_fit_rowsharded(X, 4, jmesh, beta_loss=beta_loss,
                                        seed=3, n_passes=8)
    payloads = []
    Ht, Wt, et = trs.nmf_fit_rowsharded(
        X, 4, beta_loss=beta_loss, n_passes=8, mesh=tmesh,
        init_factors=_jax_init(X, 4, 3, shards),
        telemetry_sink=payloads.append)
    assert Ht.shape == Hj.shape == (301, 4)
    assert _rel(Wt, Wj) < RTOL and _rel(Ht, Hj) < RTOL
    assert abs(et - ej) / abs(ej) < RTOL
    lane = ("ell-torch" if kind == "csr" and beta_loss != "frobenius"
            else "dense")
    assert payloads[0]["kernel"] == lane


@pytest.mark.parametrize("shards", [2, 4])
def test_the_ell_staging_has_one_width_and_a_transpose_set_a_shard(shards):
    X = sp.csr_matrix(_lowrank())
    _, tmesh = _meshes(shards)
    staged, pad = trs.stream_ell_to_mesh(X, tmesh)
    assert isinstance(staged, trs.RowShards) and pad == (-301) % shards
    assert len(staged.parts) == shards
    assert all(isinstance(p, EllMatrix) for p in staged.parts)
    assert len({p.width for p in staged.parts}) == 1
    assert len({p.rows_t.shape for p in staged.parts}) == 1
    rows = staged.rows_per
    for s, part in enumerate(staged.parts):
        block = sp.vstack([X, sp.csr_matrix((pad, X.shape[1]))]).tocsr()[
            s * rows:(s + 1) * rows].toarray()
        dense = np.zeros_like(block)
        vals, cols = part.vals.numpy(), part.cols.numpy()
        for r in range(rows):
            keep = vals[r] > 0
            dense[r, cols[r][keep]] = vals[r][keep]
        np.testing.assert_array_equal(dense, block)
    # the global transpose width is JAX's
    jx, jpad = jrs.stream_ell_to_mesh(X, _meshes(shards)[0], "cells")
    assert jpad == pad
    assert staged.parts[0].rows_t.shape[-1] == jx.rows_t.shape[-1]


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_a_one_shard_mesh_is_the_one_device_solve(kind):
    X = _lowrank(seed=1)
    X = sp.csr_matrix(X) if kind == "csr" else X
    init = _jax_init(X, 4, 5, 1)
    a = trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler",
                               n_passes=5, init_factors=init, device="cpu")
    b = trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler",
                               n_passes=5, init_factors=init,
                               mesh=Mesh(["cpu"], ("cells",)))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_fit_h_rowsharded_over_shards_matches_jax(shards, beta):
    X = sp.csr_matrix(_lowrank(seed=2))
    rng = np.random.default_rng(4)
    W = rng.random((4, 200)).astype(np.float32) + 0.1
    jmesh, tmesh = _meshes(shards)
    Hj = jrs.fit_h_rowsharded(X, W, jmesh, beta=beta, chunk_max_iter=50)
    n_pad = 301 + (-301) % shards
    H0 = np.asarray(jax.random.uniform(jax.random.key(0), (n_pad, 4)))
    Ht = trs.fit_h_rowsharded(X, W, beta=beta, chunk_max_iter=50, H0=H0,
                              mesh=tmesh)
    assert Ht.shape == Hj.shape
    assert _rel(Ht, Hj) < 1e-3


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_the_staged_spectra_refit_over_shards_is_the_one_shard_refit(beta):
    X = _lowrank(seed=3)
    H = np.random.default_rng(5).random((301, 4)).astype(np.float32) + 0.1
    one = trs.refit_w_rowsharded(X, H, beta=beta, max_iter=30, stage=True,
                                 device="cpu")
    two = trs.refit_w_rowsharded(X, H, beta=beta, max_iter=30, stage=True,
                                 mesh=Mesh(["cpu"] * 2, ("cells",)))
    assert _rel(two, one) < 1e-4


def test_a_store_streams_only_each_shards_slabs(tmp_path):
    from cnmf_torch_tpu_torch.utils import shardstore as tss

    X = sp.csr_matrix(_lowrank(seed=6))
    tss.write_shard_store(str(tmp_path / "s.store"), X, slab_rows=50)
    store = tss.open_shard_store(str(tmp_path / "s.store"))
    tmesh = Mesh(["cpu"] * 4, ("cells",))
    for stage in (trs.stream_rows_to_mesh, trs.stream_ell_to_mesh):
        a, pa = stage(store, tmesh)
        b, pb = stage(X, tmesh)
        assert pa == pb
        for x, y in zip(a.parts, b.parts):
            if isinstance(x, EllMatrix):
                for leaf in ("vals", "cols", "rows_t", "perm_t"):
                    assert torch.equal(getattr(x, leaf), getattr(y, leaf))
            else:
                assert torch.equal(x, y)
    Ha, Wa, ea = trs.nmf_fit_rowsharded(store, 4,
                                        beta_loss="kullback-leibler",
                                        n_passes=4, seed=1, mesh=tmesh)
    Hb, Wb, eb = trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler",
                                        n_passes=4, seed=1, mesh=tmesh)
    np.testing.assert_array_equal(Wa, Wb)
    assert ea == eb


def test_the_slab_looped_tier_runs_over_shards(tmp_path, monkeypatch):
    from cnmf_torch_tpu_torch.utils import shardstore as tss

    X = _lowrank(seed=7)
    tss.write_shard_store(str(tmp_path / "d.store"), X, slab_rows=40)
    store = tss.open_shard_store(str(tmp_path / "d.store"))
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", str(40 * 200 * 4))
    tmesh = Mesh(["cpu"] * 2, ("cells",))
    assert trs.store_dispatch(store, 2.0, mesh=tmesh) == (False, True)
    H, W, err = trs.nmf_fit_rowsharded(store, 4, beta_loss="frobenius",
                                       n_passes=6, seed=2, mesh=tmesh)
    Hr, Wr, er = trs.nmf_fit_rowsharded(X, 4, beta_loss="frobenius",
                                        n_passes=6, seed=2, mesh=tmesh)
    assert H.shape == (301, 4) and np.isfinite(W).all()
    # the slab loop is the online block-coordinate pass: solver tolerance
    assert abs(err - er) / er < 5e-2
