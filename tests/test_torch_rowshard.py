"""The port's row-sharded solvers (``parallel/rowshard.py``) and the atlas
path of ``cNMF``, against the JAX package on a one-device mesh.

The JAX side runs on ``Mesh(jax.devices()[:1], ("cells",))`` with its
Pallas switch left at ``auto`` (the jnp ELL chain on the CPU); the port
runs its plain statistics on the CPU. Inputs come from a numpy seed, and
the port starts from the JAX package's threefry draws (``init_factors``,
``H0``, ``W0``), which torch cannot reproduce. Tolerances:

* solvers (``nmf_fit_rowsharded`` dense and ELL, beta in {2, 1, 0}, the
  slab-looped tier from the JAX tier's own init;
  ``fit_h_rowsharded``; ``refit_w_rowsharded`` staged and streamed):
  ``rtol 1e-4`` on W (max |a - b| / max |a|), H and the objective, on
  low-rank fixtures that cross no saddle;
* the dna recipe: ``rtol 1e-3`` (its per-row choice between the Newton
  and the MU candidate flips where f32 rounding ties them);
* the gram nndsvd init: ``rtol 1e-3`` (an f32 eigendecomposition);
* ``fit_h_slabbed``: bit for bit the port's ``fit_h``;
* store-backed factorize: byte for byte the in-memory one; the
  slab-looped tier within 10% of the resident objective (the JAX
  package's ``test_rowshard_slab_loop_solver_tolerance``);
* the pipeline at a lowered ``rowshard_threshold`` (prepare, factorize,
  combine, consensus, k_selection_plot) against the JAX package's
  artifacts from the same ledger with the inits carried over:
  ``rtol 1e-3`` (60 passes and the refits' h_tol 0.05 stops amplify f32
  rounding), and so the streamed consensus and K-selection (the store as
  the only copy, ``CNMF_TPU_OOC=1``) against the JAX package's streamed
  ones (readings: at most 6.9e-7 for the artifacts, 6.1e-6 for the
  K-selection statistics);
* the streamed consensus against the port's resident one: ``1.5e-2``
  for the artifacts and ``4e-3`` for the prediction errors, from the
  readings 8.7e-3 (``consensus_usages``) and 1.9e-3, which the JAX
  package's streamed-against-resident gaps equal to four digits (the
  resident refit solves the whole shard to h_tol 0.05, the streamed one
  each chunk, so they stop at different iterations).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.parallel import rowshard as jrs
from cnmf_torch_tpu.utils import shardstore as jss
from cnmf_torch_tpu_torch import Frame, cNMF, convert, save_df_to_npz
from cnmf_torch_tpu_torch import load_df_from_npz as port_load_df
from cnmf_torch_tpu_torch.models import cnmf as tmodel
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.parallel.mesh import Mesh as TMesh
from cnmf_torch_tpu_torch.utils import shardstore as tss

RTOL = 1e-4
PIPE_RTOL = 1e-3
STREAM_RTOL = 1.5e-2
STREAM_ERR_RTOL = 4e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("cells",))


def _lowrank(n=300, g=200, k=4, scale=0.7, seed=0):
    """Low-rank Poisson counts; by default ~5% nonzeros and rows of at
    most 24 stored values (g / 8 = 25): the ELL rule's side."""
    rng = np.random.default_rng(seed)
    U = rng.dirichlet(np.ones(k) * 0.3, size=n)
    S = rng.gamma(0.3, 1.0, size=(k, g)) * 50.0 / g
    X = rng.poisson(U @ S * scale).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    return X


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _jax_init(X, k, seed):
    n, g = X.shape
    Xd = X.toarray() if sp.issparse(X) else X
    H0, W0 = jnmf.random_init(jax.random.key(seed), n, g, k,
                              jnp.mean(jnp.asarray(Xd)))
    return np.asarray(H0), np.asarray(W0)


def _input(kind):
    X = _lowrank()
    return sp.csr_matrix(X) if kind == "csr" else X


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler",
                                       "itakura-saito"])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_nmf_fit_rowsharded_matches_jax(mesh, beta_loss, kind):
    X = _input(kind)
    Hj, Wj, ej = jrs.nmf_fit_rowsharded(X, 4, mesh, beta_loss=beta_loss,
                                        seed=3, n_passes=10)
    Ht, Wt, et = trs.nmf_fit_rowsharded(X, 4, beta_loss=beta_loss, seed=3,
                                        n_passes=10,
                                        init_factors=_jax_init(X, 4, 3),
                                        device="cpu")
    assert Ht.shape == Hj.shape and Wt.shape == Wj.shape
    assert _rel(Wj, Wt) < RTOL and _rel(Hj, Ht) < RTOL
    assert abs(et - ej) / abs(ej) < RTOL


@pytest.mark.parametrize("beta_loss", ["kullback-leibler", "itakura-saito"])
def test_the_csr_input_takes_the_ell_lane_in_both_packages(mesh, beta_loss):
    X = sp.csr_matrix(_lowrank())
    payloads = []
    trs.nmf_fit_rowsharded(X, 4, beta_loss=beta_loss, seed=3, n_passes=2,
                           init_factors=_jax_init(X, 4, 3),
                           telemetry_sink=payloads.append, device="cpu")
    assert payloads[0]["kernel"] == "ell-torch"
    assert jrs.resolve_sparse_beta(
        1.0 if beta_loss == "kullback-leibler" else 0.0,
        density=X.nnz / (X.shape[0] * X.shape[1]),
        width=jrs.ell_row_width(X), g=X.shape[1])


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_the_dna_recipe_matches_jax(mesh, kind):
    from cnmf_torch_tpu.ops.recipe import SolverRecipe as JRecipe

    X = _input(kind)
    Hj, Wj, ej = jrs.nmf_fit_rowsharded(
        X, 4, mesh, beta_loss="kullback-leibler", seed=3, n_passes=6,
        recipe=JRecipe("dna", 1, True, "caller"))
    Ht, Wt, et = trs.nmf_fit_rowsharded(
        X, 4, beta_loss="kullback-leibler", seed=3, n_passes=6,
        recipe=SolverRecipe("dna", 1, True, "caller"),
        init_factors=_jax_init(X, 4, 3), device="cpu")
    assert _rel(Wj, Wt) < 1e-3 and abs(et - ej) / abs(ej) < 1e-3


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_the_sketch_recipe_is_deterministic_and_exact_on_exact_passes(kind):
    X = _input(kind)
    recipe = SolverRecipe("sketch", 1, False, "caller", sketch_dim=64,
                          sketch_exact_every=3)
    runs = [trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler",
                                   seed=3, n_passes=7, recipe=recipe,
                                   init_factors=_jax_init(X, 4, 3),
                                   device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    # one exact pass is plain MU's first pass
    one = trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler", seed=3,
                                 n_passes=1, recipe=recipe,
                                 init_factors=_jax_init(X, 4, 3),
                                 device="cpu")
    plain = trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler",
                                   seed=3, n_passes=1,
                                   init_factors=_jax_init(X, 4, 3),
                                   device="cpu")
    np.testing.assert_array_equal(one[1], plain[1])
    assert abs(runs[0][2] - plain[2]) / plain[2] < 0.5


def test_gram_nndsvd_matches_jax():
    X = _lowrank(n=200, g=60, scale=30.0, seed=4)
    for variant in ("nndsvd", "nndsvda"):
        Hj, Wj = jnmf.nndsvd_init_gram(jnp.asarray(X), 4, variant=variant)
        Ht, Wt = tnmf.nndsvd_init_gram(torch.as_tensor(X), 4, variant)
        assert _rel(Hj, Ht.numpy()) < 1e-3 and _rel(Wj, Wt.numpy()) < 1e-3


def test_the_nndsvd_init_runs_row_sharded(mesh):
    X = _lowrank(n=200, g=60, scale=30.0, seed=4)
    _, W, err = trs.nmf_fit_rowsharded(X, 4, init="nndsvd", seed=2,
                                       n_passes=4, device="cpu")
    assert np.isfinite(err) and (W >= 0).all()
    with pytest.raises(ValueError, match="ELL-encoded rowshard solves"):
        trs.nmf_fit_rowsharded(*trs.stream_ell_to_mesh(
            sp.csr_matrix(X), "cpu")[:1], 4, init="nndsvd", device="cpu")


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_fit_h_rowsharded_matches_jax(mesh, beta, kind):
    X = _input(kind)
    W = np.abs(np.random.default_rng(8).normal(size=(4, X.shape[1]))
               ).astype(np.float32) + 0.05
    Hj = jrs.fit_h_rowsharded(X, W, mesh, beta=beta, chunk_max_iter=100)
    H0 = np.asarray(jax.random.uniform(jax.random.key(0), (X.shape[0], 4)))
    Ht = trs.fit_h_rowsharded(X, W, beta=beta, chunk_max_iter=100, H0=H0,
                              device="cpu")
    assert _rel(Hj, Ht) < RTOL


@pytest.mark.parametrize("beta,stage", [(2.0, "auto"), (1.0, True),
                                        (1.0, False), (0.0, True),
                                        (0.0, False)])
def test_refit_w_rowsharded_matches_jax(mesh, beta, stage):
    X = sp.csr_matrix(_lowrank())
    H = np.abs(np.random.default_rng(9).normal(size=(X.shape[0], 4))
               ).astype(np.float32) + 0.05
    kw = dict(beta=beta, max_iter=60, stage=stage, row_block=70)
    Wj = jrs.refit_w_rowsharded(X, H, mesh=mesh, **kw)
    W0 = np.asarray(jax.random.uniform(jax.random.key(0), (4, X.shape[1])))
    Wt = trs.refit_w_rowsharded(X, H, W0=W0, device="cpu", **kw)
    assert _rel(Wj, Wt) < RTOL


def test_unsupported_losses_and_layouts_raise():
    X = _lowrank(n=40, g=30)
    with pytest.raises(ValueError, match="beta in"):
        trs.nmf_fit_rowsharded(X, 3, beta_loss=1.5, device="cpu")
    with pytest.raises(ValueError, match="beta in"):
        trs.refit_w_rowsharded(X, np.ones((40, 3), np.float32), beta=0.5,
                               device="cpu")
    with pytest.raises(ValueError, match="requires beta=1"):
        trs.nmf_fit_rowsharded(X, 3, recipe=SolverRecipe("dna", 1, True),
                               device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh axis"):
        trs.stream_rows_to_mesh(X, TMesh(["cpu"] * 3, ("cells",)),
                                pad_multiple=4)


# ---------------------------------------------------------------------------
# fit_h_slabbed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0])
@pytest.mark.parametrize("block", [40, 120, 1000])
def test_fit_h_slabbed_is_fit_h_bit_for_bit(beta, block):
    X = _lowrank(n=290)
    W = np.abs(np.random.default_rng(8).normal(size=(4, X.shape[1]))
               ).astype(np.float32) + 0.05
    want = tnmf.fit_h(X, W, chunk_size=40, chunk_max_iter=100, beta=beta,
                      device="cpu")
    seen = []
    got = tnmf.fit_h_slabbed(
        ((lo, min(lo + block, 290), X[lo:lo + block])
         for lo in range(0, 290, block)), 290, W, chunk_size=40,
        chunk_max_iter=100, beta=beta,
        collect=lambda lo, hi, xb, hb: seen.append((lo, hi, hb.shape)),
        device="cpu")
    np.testing.assert_array_equal(got, want)
    assert [s[:2] for s in seen] == [(lo, min(lo + block, 290))
                                     for lo in range(0, 290, block)]


def test_fit_h_slabbed_refuses_a_misaligned_block():
    X = _lowrank(n=100)
    W = np.ones((4, X.shape[1]), np.float32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tnmf.fit_h_slabbed([(0, 30, X[:30]), (30, 100, X[30:])], 100, W,
                           chunk_size=20, device="cpu")


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_a_store_backed_solve_is_the_in_memory_solve(tmp_path, kind):
    X = _input(kind)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=70)
    store = tss.open_shard_store(tmp_path / "st")
    init = _jax_init(X, 4, 3)
    kw = dict(beta_loss="kullback-leibler", n_passes=5, init_factors=init,
              device="cpu")
    a = trs.nmf_fit_rowsharded(X, 4, **kw)
    b = trs.nmf_fit_rowsharded(store, 4, **kw)
    for u, v in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(u, v)
    assert a[2] == b[2]


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler",
                                       "itakura-saito"])
def test_the_slab_looped_tier_matches_jax(tmp_path, mesh, monkeypatch,
                                          beta_loss):
    X = _lowrank(n=256, g=32, scale=40.0)
    jss.write_shard_store(tmp_path / "st", X, slab_rows=60)
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", "2048")
    jstore = jss.open_shard_store(tmp_path / "st")
    Hj, Wj, ej = jrs.nmf_fit_rowsharded(jstore, 5, mesh,
                                        beta_loss=beta_loss, seed=3,
                                        n_passes=6)
    # the JAX tier's own init: (n_pad, k) at the manifest's mean
    n, g = X.shape
    group = max(8, 2048 // (g * 4))
    n_pad = -(-n // group) * group
    H0, W0 = jnmf.random_init(jax.random.key(3), n_pad, g, 5,
                              jnp.float32(jstore.value_sum / (n_pad * g)))
    tstore = tss.open_shard_store(tmp_path / "st")
    Ht, Wt, et = trs.nmf_fit_rowsharded(
        tstore, 5, beta_loss=beta_loss, seed=3, n_passes=6,
        init_factors=(np.asarray(H0), np.asarray(W0)), device="cpu")
    assert _rel(Wj, Wt) < RTOL and _rel(Hj, Ht) < RTOL
    assert abs(et - ej) / abs(ej) < RTOL


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_the_slab_looped_tier_is_within_solver_tolerance(tmp_path,
                                                         monkeypatch,
                                                         beta_loss):
    # the JAX package's fixture of this test
    X = np.abs(np.random.default_rng(0).random((256, 32))).astype(
        np.float32)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=60)
    store = tss.open_shard_store(tmp_path / "st")
    _, W1, e1 = trs.nmf_fit_rowsharded(X, 5, beta_loss=beta_loss, seed=3,
                                       n_passes=6, device="cpu")
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", "2048")
    H2, W2, e2 = trs.nmf_fit_rowsharded(store, 5, beta_loss=beta_loss,
                                        seed=3, n_passes=6, device="cpu")
    assert H2.shape == (256, 5) and W2.shape == W1.shape
    assert np.isfinite(e2) and (H2 >= 0).all() and (W2 >= 0).all()
    assert abs(e2 - e1) / max(abs(e1), 1e-9) < 0.1


def test_the_slab_looped_tier_resumes_bit_for_bit(tmp_path, monkeypatch):
    from cnmf_torch_tpu_torch.runtime.checkpoint import PassCheckpointer

    X = _lowrank(n=256, g=32, scale=40.0)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=60)
    store = tss.open_shard_store(tmp_path / "st")
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", "2048")
    meta = {"k": 5, "iter": 0, "seed": 3, "attempt": 0,
            "digest": "store:" + store.store_digest, "beta": 2.0,
            "params": "t"}
    reads = {"n": 0}
    orig = tss.ShardStore.read_slab

    def counting(self, i, **kw):
        reads["n"] += 1
        return orig(self, i, **kw)

    monkeypatch.setattr(tss.ShardStore, "read_slab", counting)
    full = PassCheckpointer(str(tmp_path / "full.npz"), 1, meta=meta)
    H1, W1, e1 = trs.nmf_fit_rowsharded(store, 5, seed=3, n_passes=5,
                                        checkpoint=full, device="cpu")
    full_reads = reads["n"]
    part = PassCheckpointer(str(tmp_path / "part.npz"), 1, meta=meta)
    trs.nmf_fit_rowsharded(store, 5, seed=3, n_passes=2, checkpoint=part,
                           device="cpu")
    reads["n"] = 0
    resumed = PassCheckpointer(str(tmp_path / "part.npz"), 1, meta=meta,
                               resume=True)
    H2, W2, e2 = trs.nmf_fit_rowsharded(store, 5, seed=3, n_passes=5,
                                        checkpoint=resumed, device="cpu")
    np.testing.assert_array_equal(H1, H2)
    np.testing.assert_array_equal(W1, W2)
    assert e1 == e2
    assert 0 < reads["n"] <= (full_reads * 3) // 5 + 1


class _Streams:
    """An event sink that keeps each stream context's ``StreamStats``."""

    enabled = True

    def __init__(self):
        self.streams = {}

    def emit(self, event_type, **fields):
        pass

    def emit_stream(self, context, stats):
        self.streams[context] = stats


def test_the_slab_looped_tier_stays_under_the_host_budget(tmp_path,
                                                          monkeypatch):
    X = _lowrank(n=256, g=32, scale=40.0)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=30)
    store = tss.open_shard_store(tmp_path / "st")
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", "4096")
    monkeypatch.setenv("CNMF_TPU_OOC_BUDGET_BYTES", "1")
    sink = _Streams()
    trs.nmf_fit_rowsharded(store, 5, seed=3, n_passes=2, events=sink,
                           store_slab_loop=True, device="cpu")
    stats = sink.streams["rowshard_ooc_passes"]
    assert 0 < stats.host_peak_bytes <= store.max_slab_bytes
    assert stats.disk_nbytes > 0


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_the_staging_of_a_host_matrix_is_one_stream_event(kind):
    X = _input(kind)
    sink = _Streams()
    trs.nmf_fit_rowsharded(X, 4, beta_loss="kullback-leibler", seed=3,
                           n_passes=2, events=sink, device="cpu")
    st = sink.streams["rowshard_staging"]
    assert set(sink.streams) == {"rowshard_staging"} and st.nbytes > 0
    # the ELL encoding (csr) or the slab preparation (dense) on the host
    assert st.host_prep_s > 0 and st.wall_s >= st.host_prep_s


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler",
                                       "itakura-saito"])
@pytest.mark.parametrize("tier", ["resident", "slab_loop"])
def test_the_dense_pass_in_row_blocks_is_the_whole_pass(
        tmp_path, monkeypatch, beta_loss, tier):
    """The dense pass's elementwise work in row blocks (37 rows here, a
    block of ``DENSE_BLOCK_ELEMS`` elements on an atlas) against the
    same pass as one block: only the f32 summation order of the W
    statistics and the objective differs, so W, H and the objective
    agree to ``rtol 1e-5`` after 6 passes."""
    X = _lowrank()
    init = _jax_init(X, 4, 3)
    if tier == "slab_loop":
        tss.write_shard_store(tmp_path / "st", X, slab_rows=50)
        X = tss.open_shard_store(tmp_path / "st")
        monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", str(150 * 200 * 4))
    kw = dict(beta_loss=beta_loss, seed=3, n_passes=6, init_factors=init,
              store_slab_loop=tier == "slab_loop", device="cpu")
    Ha, Wa, ea = trs.nmf_fit_rowsharded(X, 4, **kw)
    monkeypatch.setattr(trs, "DENSE_BLOCK_ELEMS", 37 * 200)
    Hb, Wb, eb = trs.nmf_fit_rowsharded(X, 4, **kw)
    assert _rel(Wa, Wb) < 1e-5 and _rel(Ha, Hb) < 1e-5
    assert abs(ea - eb) / abs(ea) < 1e-5


def test_store_dispatch_charges_the_dense_pass_scratch(tmp_path,
                                                       monkeypatch):
    """A dense shard is charged X and ``DENSE_SCRATCH_BLOCKS`` blocks of
    scratch: a budget that X alone fits but X with its scratch does not
    runs the slab-looped tier."""
    X = _lowrank()
    tss.write_shard_store(tmp_path / "st", X, slab_rows=50)
    store = tss.open_shard_store(tmp_path / "st")
    x_bytes = 300 * 200 * 4
    need = x_bytes + trs.DENSE_SCRATCH_BLOCKS * x_bytes
    for budget, slab_loop in ((x_bytes, True), (need - 1, True),
                              (need, False)):
        monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", str(budget))
        assert trs.store_dispatch(store, 1.0, force_dense=True) \
            == (False, slab_loop), budget
    monkeypatch.setattr(trs, "DENSE_BLOCK_ELEMS", 50 * 200)
    need = x_bytes + trs.DENSE_SCRATCH_BLOCKS * 50 * 200 * 4
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", str(need))
    assert trs.store_dispatch(store, 1.0, force_dense=True) == (False, False)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _counts_file(tmp_path, n=300, g=400, seed=7):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(5) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(5, g)) * 50.0 / g
    counts = rng.poisson(usage @ spectra * 40.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp_path, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


PREP = dict(components=[4, 5], n_iter=6, seed=14, num_highvar_genes=120,
            beta_loss="kullback-leibler", batch_size=64, max_NMF_iter=200)


def _jax_random_init(seed, n, g, k, x_mean, device="cpu"):
    H, W = jnmf.random_init(jax.random.key(seed), n, g, k,
                            jnp.float32(x_mean))
    return (convert.fit_h_init(np.asarray(H), device),
            convert.fit_h_init(np.asarray(W), device))


def _jax_default_init(n, k, seed=0, device="cpu"):
    return convert.fit_h_init(
        np.asarray(jax.random.uniform(jax.random.key(seed), (n, k))),
        device)


def _kmeans_with_jax_ids(X, k, **kw):
    import importlib

    from cnmf_torch_tpu_torch.ops import kmeans as tkmeans

    jkmeans = importlib.import_module("cnmf_torch_tpu.ops.kmeans")
    labels, centers, inertia = tkmeans.kmeans(X, k, **kw)
    ref, _, _ = jkmeans.kmeans(X, k, n_init=10, seed=1)
    return convert.cluster_labels(labels, ref), centers, inertia


@pytest.fixture(scope="module")
def atlas_runs(tmp_path_factory):
    """The port's and the JAX package's pipelines at a lowered
    ``rowshard_threshold`` (100 cells) on the same ledger, the port fed
    the JAX package's threefry inits and cluster ids; then the port again
    with the store as the only copy (``CNMF_TPU_OOC=1``), and the JAX
    package so too."""
    import cnmf_torch_tpu.parallel as jpar
    from cnmf_torch_tpu import cNMF as JaxCNMF

    d = str(tmp_path_factory.mktemp("atlas"))
    fn = _counts_file(d)
    one = Mesh(np.asarray(jax.devices()[:1]), ("cells",))
    orig_refit_w = trs.refit_w_rowsharded

    def refit_w_from_jax_init(X, H, **kw):
        W0 = np.asarray(jax.random.uniform(
            jax.random.key(0), (np.asarray(H).shape[1], X.shape[1])))
        return orig_refit_w(X, H, W0=W0, **kw)

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trs, "random_init", _jax_random_init)
        mp.setattr(tnmf, "fit_h_default_init", _jax_default_init)
        mp.setattr(trs, "refit_w_rowsharded", refit_w_from_jax_init)
        mp.setattr(tmodel, "kmeans", _kmeans_with_jax_ids)
        mp.setenv("CNMF_TPU_OOC", "0")
        port = cNMF(d, "port", device="cpu", rowshard_threshold=100)
        port.prepare(fn, **PREP)
        port.factorize()
        port.combine()
        port.consensus(4, density_threshold=2.0, show_clustering=False)
        runs["port_stats"] = port.k_selection_plot()
        runs["port"] = port
        mp.setenv("CNMF_TPU_OOC", "1")
        ooc = cNMF(d, "ooc", device="cpu", rowshard_threshold=100)
        ooc.prepare(fn, **PREP)
        ooc.factorize()
        ooc.combine()
        ooc.consensus(4, density_threshold=2.0, show_clustering=False)
        runs["ooc_stats"] = ooc.k_selection_plot()
        runs["ooc"] = ooc
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpar, "default_mesh", lambda axis_name="cells": one)
        mp.setenv("CNMF_TPU_OOC", "0")
        mp.setenv("CNMF_WARM_CONSENSUS", "0")
        ref = JaxCNMF(output_dir=d, name="jax", rowshard_threshold=100)
        ref.prepare(fn, **PREP)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref.factorize(mesh=one)
            ref.combine()
            ref.consensus(4, density_threshold=2.0, show_clustering=False)
            runs["jax_stats"] = ref.k_selection_plot(close_fig=True)
        runs["jax"] = ref
        mp.setenv("CNMF_TPU_OOC", "1")
        jooc = JaxCNMF(output_dir=d, name="jaxooc", rowshard_threshold=100)
        jooc.prepare(fn, **PREP)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jooc.factorize(mesh=one)
            jooc.combine()
            jooc.consensus(4, density_threshold=2.0, show_clustering=False)
            runs["jaxooc_stats"] = jooc.k_selection_plot(close_fig=True)
        runs["jaxooc"] = jooc
    return runs


def test_the_threshold_engages_the_row_sharded_solver(atlas_runs):
    info = atlas_runs["port"].factorize_info
    assert info["mode"] == "rowshard" and info["kernel"] == "dense"
    assert info["solver_recipe"] == "mu" and info["n_passes"] == 60
    with open(atlas_runs["port"].paths["factorize_provenance"] % 0) as f:
        import json

        prov = json.load(f)
    assert prov["engaged_path"] == "rowshard"


@pytest.mark.parametrize("k", [4, 5])
def test_pipeline_iter_spectra_match_jax(atlas_runs, k):
    from cnmf_torch_tpu.utils.io import load_df_from_npz as jload

    for it in range(6):
        a = jload(atlas_runs["jax"].paths["iter_spectra"] % (k, it)).values
        b = port_load_df(atlas_runs["port"].paths["iter_spectra"]
                         % (k, it)).values
        assert _rel(a, b) < PIPE_RTOL, (k, it)


@pytest.mark.parametrize("key", ["consensus_spectra", "consensus_usages",
                                 "gene_spectra_tpm", "gene_spectra_score",
                                 "starcat_spectra"])
def test_pipeline_consensus_artifacts_match_jax(atlas_runs, key):
    from cnmf_torch_tpu.utils.io import load_df_from_npz as jload

    a = jload(atlas_runs["jax"].paths[key] % (4, "2_0")).values
    b = port_load_df(atlas_runs["port"].paths[key] % (4, "2_0")).values
    assert a.shape == b.shape and _rel(a, b) < PIPE_RTOL


def test_pipeline_k_selection_matches_jax(atlas_runs):
    a = np.asarray(atlas_runs["jax_stats"][["k", "silhouette",
                                            "prediction_error"]].values,
                   np.float64)
    b = np.asarray(atlas_runs["port_stats"].values, np.float64)[:, [0, 2, 3]]
    assert _rel(a, b) < PIPE_RTOL


@pytest.mark.parametrize("k", [4, 5])
def test_a_store_backed_factorize_is_byte_for_byte_in_memory(atlas_runs, k):
    assert not os.path.exists(atlas_runs["ooc"].paths["normalized_counts"])
    for it in range(6):
        with open(atlas_runs["port"].paths["iter_spectra"] % (k, it),
                  "rb") as a, \
                open(atlas_runs["ooc"].paths["iter_spectra"] % (k, it),
                     "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("key", ["consensus_spectra", "consensus_usages",
                                 "gene_spectra_tpm", "gene_spectra_score",
                                 "starcat_spectra"])
def test_streamed_consensus_matches_jax(atlas_runs, key):
    from cnmf_torch_tpu.utils.io import load_df_from_npz as jload

    for run in ("ooc", "jaxooc"):
        assert not os.path.exists(atlas_runs[run].paths["normalized_counts"])
    a = jload(atlas_runs["jaxooc"].paths[key] % (4, "2_0")).values
    b = port_load_df(atlas_runs["ooc"].paths[key] % (4, "2_0")).values
    assert a.shape == b.shape and _rel(a, b) < PIPE_RTOL


def test_streamed_k_selection_matches_jax(atlas_runs):
    a = np.asarray(atlas_runs["jaxooc_stats"][["k", "silhouette",
                                               "prediction_error"]].values,
                   np.float64)
    b = np.asarray(atlas_runs["ooc_stats"].values, np.float64)[:, [0, 2, 3]]
    assert _rel(a, b) < PIPE_RTOL


@pytest.mark.parametrize("key", ["consensus_spectra", "consensus_usages",
                                 "gene_spectra_tpm", "gene_spectra_score",
                                 "starcat_spectra"])
def test_streamed_consensus_is_within_its_band(atlas_runs, key):
    a = port_load_df(atlas_runs["port"].paths[key] % (4, "2_0")).values
    b = port_load_df(atlas_runs["ooc"].paths[key] % (4, "2_0")).values
    assert _rel(a, b) < STREAM_RTOL
    peaks = atlas_runs["ooc"].stream_stats
    assert set(peaks) == {"consensus_stream", "kselection_stream"}
    assert all(0 < st.host_peak_bytes for st in peaks.values())


def test_streamed_k_selection_is_within_its_band(atlas_runs):
    a = np.asarray(atlas_runs["port_stats"].values, np.float64)
    b = np.asarray(atlas_runs["ooc_stats"].values, np.float64)
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    assert _rel(a[:, 3], b[:, 3]) < STREAM_ERR_RTOL


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("small"))
    fn = _counts_file(d, n=80, g=100)
    obj = cNMF(d, "s", device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=1, num_highvar_genes=40,
                beta_loss="kullback-leibler", batch_size=40,
                max_NMF_iter=100)
    return obj


@pytest.mark.parametrize("kw,mode", [
    ({}, "online"), ({"rowshard": True}, "rowshard"),
    ({"rowshard_threshold": 50}, "rowshard"),
    ({"rowshard_threshold": 50, "rowshard": False}, "online"),
    ({"mesh_shape": "1d"}, "rowshard"),
    ({"mesh_shape": "rowshard"}, "rowshard"),
    ({"rowshard_threshold": 50, "batched": False}, "online")])
def test_the_auto_rule_and_its_overrides(small_run, kw, mode):
    small_run.factorize(**kw)
    assert small_run.factorize_info["mode"] == mode


@pytest.mark.parametrize("shape", ["2d", "grid2d", "grid"])
def test_the_multi_device_layouts_raise(small_run, shape):
    """The multi-device layouts run (tests/test_torch_multihost.py,
    test_torch_grid2d.py); a request that names two layouts raises before
    any file is read, as in the JAX package."""
    other = "grid2d" if shape == "2d" else "2d"
    with pytest.raises(ValueError, match="conflicting execution layouts"):
        small_run.factorize(mesh_shape=shape, mesh=other)


def test_an_unknown_layout_raises(small_run):
    with pytest.raises(ValueError, match="expected '1d'"):
        small_run.factorize(mesh_shape="3d")


@pytest.mark.parametrize("argv,mode", [
    (["--rowshard"], "rowshard"), (["--no-rowshard"], "online"),
    (["--rowshard-threshold", "50"], "rowshard"), ([], "online")])
def test_the_cli_flags(small_run, monkeypatch, argv, mode):
    from cnmf_torch_tpu_torch.cli import main

    seen = {}
    orig = tmodel.cNMF._factorize_impl

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        seen["mode"] = self.factorize_info["mode"]
        return out

    monkeypatch.setattr(tmodel.cNMF, "_factorize_impl", spy)
    main(["factorize", "--output-dir", small_run.output_dir, "--name", "s",
          "--device", "cpu"] + argv)
    assert seen["mode"] == mode


def test_the_cli_store_uri(small_run, monkeypatch, tmp_path):
    from cnmf_torch_tpu_torch.cli import main

    # the CLI exports the knob into os.environ; an empty value set here
    # first makes the teardown restore the knob's absence
    from cnmf_torch_tpu_torch.utils.netstore import ObjectStoreServer

    monkeypatch.setenv("CNMF_TPU_STORE_URI", "")
    # an unsupported scheme fails before any work
    with pytest.raises(ValueError, match="expected empty"):
        main(["factorize", "--output-dir", small_run.output_dir, "--name",
              "s", "--device", "cpu", "--store-uri", "ftp://localhost:9/x"])
    # an object store with no store of this run: factorize probes it
    # through the remote backend and reads the matrix file
    with ObjectStoreServer() as srv:
        main(["factorize", "--output-dir", small_run.output_dir, "--name",
              "s", "--device", "cpu", "--store-uri", srv.url + "/x"])
    assert os.environ["CNMF_TPU_STORE_URI"].endswith("/x")
    monkeypatch.setenv("CNMF_TPU_STORE_URI", "")
    main(["factorize", "--output-dir", small_run.output_dir, "--name", "s",
          "--device", "cpu", "--store-uri", f"file://{tmp_path}"])
    assert os.environ["CNMF_TPU_STORE_URI"] == f"file://{tmp_path}"
