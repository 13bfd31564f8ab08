"""The sketch recipe and sketched consensus in the port, against the JAX
package.

torch cannot reproduce JAX's threefry draws, so the port takes each of
its random draws as an explicit override, and these tests feed it the
JAX package's: the sampled row indices of every sketched W update
(``sketch_rows``: ``randint(fold_in(key(0), it))`` in batch,
``randint(fold_in(key(1), pass * chunks + chunk))`` online) and the
consensus projection matrix (``normal(key(0), (g, dim)) / sqrt(dim)``).

Covered: the sampled-row KL statistics (``ell_kl_w_stats_rows``, with
repeated rows, and the dense sampled statistics) and ``ell_take_rows``'s
transpose index set; ``_apply_rate_sketched``; whole sketched batch and
online solves (dense and ELL lanes); ``resolve_consensus_sketch`` under
each setting of the knobs; consensus with the sketch engaged (fault F2:
the port's consensus used to ignore ``CNMF_TPU_SKETCH``) and the
K-selection statistics' one sweep-level decision; the refusals.

Tolerances: statistics at ``rtol 2e-5`` (f32, another summation order);
whole solves' final objectives at ``rtol 1e-4`` with the iteration count
fixed (``tol=-1``); the consensus clusters equal and its spectra at
``rtol 1e-5``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu import cNMF as JaxCNMF
from cnmf_torch_tpu import save_df_to_npz as jax_save_df
from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sketch as jsketch
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu_torch import Frame, cNMF, convert, save_df_to_npz
from cnmf_torch_tpu_torch.models import cnmf as tmodel
from cnmf_torch_tpu_torch.ops import kmeans as tkmeans
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sketch as tsketch
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.parallel import replicates as trep

# the package re-exports the function under the module's name
jkmeans = importlib.import_module("cnmf_torch_tpu.ops.kmeans")

F32 = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def sketch_env(monkeypatch):
    for name in ("CNMF_TPU_SKETCH", "CNMF_TPU_SKETCH_DIM",
                 "CNMF_TPU_SKETCH_EXACT_EVERY", "CNMF_TPU_ACCEL",
                 "CNMF_TPU_KL_NEWTON", "CNMF_TPU_INNER_REPEATS",
                 "CNMF_TPU_SPARSE_BETA"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _counts(n=120, g=60, k=4, seed=0, scale=1.2):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(k, g)) * 40.0 / g
    X = rng.poisson(usage @ spectra * scale).astype(np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    avg = np.sqrt(X.mean() / k)
    H = (avg * (rng.random((n, k)) + 0.2)).astype(np.float32)
    W = (avg * (rng.random((k, g)) + 0.2)).astype(np.float32)
    return X, H, W


def _jax_rows(stream, steps, m, n):
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.key(stream), s), (m,), 0, n))
        for s in range(steps)])


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ell_kl_w_stats_rows_matches_jax(seed):
    X, H, W = _counts(seed=seed)
    e = jsp.csr_to_ell(sp.csr_matrix(X))
    xj = jsp.ell_device_put(e)
    xt = convert.ell_matrix(e.vals, e.cols, e.g)
    idx = np.random.default_rng(seed).integers(0, X.shape[0], 40)
    idx[:5] = idx[5]                      # repeated rows count twice
    nj, dj = jsp.ell_kl_w_stats_rows(xj, jnp.asarray(H), jnp.asarray(W),
                                     jnp.asarray(idx))
    for fn in (tsp.ell_kl_w_stats_rows, kl_ell.kl_w_stats_rows):
        n_, d_ = fn(xt, _t(H)[None], _t(W)[None], torch.as_tensor(idx))
        np.testing.assert_allclose(n_[0].numpy(), np.asarray(nj), **F32)
        np.testing.assert_allclose(d_[0].numpy(), np.asarray(dj), **F32)


def test_ell_take_rows_builds_the_rows_transpose_set():
    X, H, W = _counts(seed=4)
    e = tsp.csr_to_ell(sp.csr_matrix(X))
    xt = convert.ell_matrix(e.vals, e.cols, e.g)
    idx = torch.as_tensor([7, 3, 3, 110, 0, 64])
    sub = tsp.ell_take_rows(xt, idx)
    # the same encoding as csr_to_ell gives the sampled rows on the host
    want = tsp.csr_to_ell(sp.csr_matrix(X[idx.numpy()]), width=sub.width,
                          t_width=sub.t_width)
    np.testing.assert_array_equal(sub.vals.numpy(), want.vals)
    np.testing.assert_array_equal(sub.rows_t.numpy(), want.rows_t)
    np.testing.assert_array_equal(sub.perm_t.numpy(), want.perm_t)
    # and the same again: nothing in it depends on the run
    again = tsp.ell_take_rows(xt, idx)
    assert torch.equal(sub.perm_t, again.perm_t)


def test_dense_sampled_update_matches_jax():
    X, H, W = _counts(seed=5)
    idx = np.random.default_rng(5).integers(0, X.shape[0], 32)
    l1, l2 = 0.05, 0.1
    Xs, Hs = X[idx], H[idx]
    WHs = np.maximum(Hs @ W, tnmf.EPS)
    numer = jnp.asarray(Hs.T @ (Xs / WHs))
    denom = jnp.broadcast_to(jnp.asarray(Hs.sum(axis=0))[:, None], W.shape)
    sc = 32 / X.shape[0]
    want = jnmf._apply_rate_sketched(jnp.asarray(W), numer, denom, l1 * sc,
                                     l2 * sc)
    got = tnmf._sketched_w_update(_t(X), _t(H)[None], _t(W)[None],
                                  torch.as_tensor(idx), l1, l2, X.shape[0])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **F32)


def test_apply_rate_sketched_matches_jax():
    rng = np.random.default_rng(8)
    W = rng.random((4, 30)).astype(np.float32) + 0.1
    numer = rng.random((4, 30)).astype(np.float32)
    numer[numer < 0.3] = 0.0              # columns the sample missed
    denom = rng.random((4, 30)).astype(np.float32)
    denom[0, :3] = 0.0                    # an underflowing denominator
    for l1, l2 in ((0.0, 0.0), (0.1, 0.2)):
        want = jnmf._apply_rate_sketched(jnp.asarray(W), jnp.asarray(numer),
                                         jnp.asarray(denom), l1, l2)
        got = tnmf._apply_rate_sketched(_t(W), _t(numer), _t(denom), l1, l2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        held = numer == 0
        np.testing.assert_array_equal(got.numpy()[held], W[held])


# ---------------------------------------------------------------------------
# whole solves fed JAX's index sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", ["dense", "ell"])
def test_sketched_batch_solve_matches_jax(lane):
    X, H, W = _counts(seed=6)
    n, m, E, iters = X.shape[0], 32, 4, 60
    kw = dict(beta=1.0, tol=-1.0, max_iter=iters, l1_W=0.01)
    if lane == "ell":
        e = jsp.csr_to_ell(sp.csr_matrix(X))
        xj = jsp.ell_device_put(e)
        xt = convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)
    else:
        xj, xt = jnp.asarray(X), _t(X)
    Hj, Wj, errj = jnmf.nmf_fit_batch(xj, jnp.asarray(H), jnp.asarray(W),
                                      sketch_dim=m, sketch_exact_every=E,
                                      **kw)
    rows = _jax_rows(0, iters, m, n)
    tm: list = []
    _, Wt, err = tnmf.nmf_fit_batch(xt, _t(H)[None], _t(W)[None],
                                    sketch_dim=m, sketch_exact_every=E,
                                    sketch_rows=rows, trace=tm, **kw)
    assert int(tm[0].iters[0]) == iters
    assert float(err[0]) == pytest.approx(float(errj), rel=1e-4)
    np.testing.assert_allclose(Wt[0].numpy(), np.asarray(Wj), rtol=2e-3,
                               atol=1e-5)
    # the sketch moved the solve: the exact recipe ends elsewhere
    _, _, err_mu = tnmf.nmf_fit_batch(xt, _t(H)[None], _t(W)[None], **kw)
    assert float(err_mu[0]) != float(err[0])


@pytest.mark.parametrize("lane", ["dense", "ell"])
def test_sketched_online_solve_matches_jax(lane):
    X, H, W = _counts(n=128, seed=7)
    chunk, m, E, passes = 64, 24, 3, 7
    C = X.shape[0] // chunk
    h_tol, _, h_tol_start = tnmf.resolve_online_schedule(1.0)
    kw = dict(beta=1.0, tol=-1.0, h_tol=h_tol, chunk_max_iter=50,
              n_passes=passes, h_tol_start=h_tol_start, sketch_dim=m,
              sketch_exact_every=E)
    Hc = H.reshape(C, chunk, -1)
    if lane == "ell":
        e, _ = jsp.ell_chunk_rows(sp.csr_matrix(X), chunk)
        xj = jsp.ell_device_put(e)
        xt = convert.ell_matrix(e.vals, e.cols, e.g, e.rows_t, e.perm_t)
    else:
        xj = jnp.asarray(X.reshape(C, chunk, -1))
        xt = _t(X.reshape(C, chunk, -1))
    _, Wj, errj = jnmf.nmf_fit_online(xj, jnp.asarray(Hc), jnp.asarray(W),
                                      **kw)
    rows = _jax_rows(1, passes * C, m, chunk)
    tr: list = []
    _, Wt, err = tnmf.nmf_fit_online(xt, _t(Hc)[None], _t(W)[None],
                                     sketch_rows=rows, trace=tr, **kw)
    assert len(tr) == passes
    # the inner usage solves stop on a relative-change tolerance, so the
    # objective is the quantity held (as for the unsketched online lane)
    assert float(err[0]) == pytest.approx(float(errj), rel=1e-4)


def test_sketched_solves_are_deterministic(sketch_env):
    """Two runs of the recipe from the port's own draws are bit-identical
    (the sampled statistics use no floating-point atomics)."""
    X, _, _ = _counts(seed=9)
    sketch_env.setenv("CNMF_TPU_SKETCH", "1")
    sketch_env.setenv("CNMF_TPU_SKETCH_DIM", "40")
    sketch_env.setenv("CNMF_TPU_SPARSE_BETA", "1")
    runs = [trep.replicate_sweep(sp.csr_matrix(X), [3, 4], 4,
                                 beta_loss="kullback-leibler", mode=mode,
                                 batch_max_iter=40, online_chunk_size=60,
                                 device="cpu")
            for mode in ("batch", "batch", "online", "online")]
    for a, b in ((runs[0], runs[1]), (runs[2], runs[3])):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
    assert np.isfinite(runs[0][2]).all() and np.isfinite(runs[2][2]).all()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_match_jax():
    X, H, W = _counts(seed=10)
    for kw in (dict(beta=2.0, sketch_dim=8),
               dict(beta=1.0, sketch_dim=8, kl_newton=True),
               dict(beta=1.0, sketch_dim=8, inner_repeats=3)):
        with pytest.raises(ValueError) as got:
            tnmf.nmf_fit_batch(_t(X), _t(H)[None], _t(W)[None], **kw)
        with pytest.raises(ValueError) as want:
            jnmf.nmf_fit_batch(jnp.asarray(X), jnp.asarray(H),
                               jnp.asarray(W), **kw)
        assert str(got.value) == str(want.value)
    Xc = X.reshape(2, 60, -1)
    for kw in (dict(beta=2.0, sketch_dim=8),
               dict(beta=1.0, sketch_dim=8, kl_newton=True)):
        with pytest.raises(ValueError) as got:
            tnmf.nmf_fit_online(_t(Xc), _t(H.reshape(2, 60, -1))[None],
                                _t(W)[None], **kw)
        with pytest.raises(ValueError) as want:
            jnmf.nmf_fit_online(jnp.asarray(Xc),
                                jnp.asarray(H.reshape(2, 60, -1)),
                                jnp.asarray(W), **kw)
        assert str(got.value) == str(want.value)
    from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe

    sk = SolverRecipe("sketch", 1, False, "caller", sketch_dim=8,
                      sketch_exact_every=2)
    with pytest.raises(ValueError, match="sketch recipe"):
        trep.replicate_sweep_packed(X, [3, 4], [1, 2], mode="batch",
                                    beta_loss="kullback-leibler", recipe=sk,
                                    device="cpu")


# ---------------------------------------------------------------------------
# sketched consensus
# ---------------------------------------------------------------------------

RESOLVE_ENVS = [{}, {"CNMF_TPU_SKETCH": "0"}, {"CNMF_TPU_SKETCH": "1"},
                {"CNMF_TPU_SKETCH": "on"},
                {"CNMF_TPU_SKETCH": "auto"},
                {"CNMF_TPU_SKETCH": "1", "CNMF_TPU_SKETCH_DIM": "64"},
                {"CNMF_TPU_SKETCH": "1", "CNMF_TPU_SKETCH_DIM": "2048"},
                {"CNMF_TPU_SKETCH": "auto", "CNMF_TPU_SKETCH_DIM": "16"},
                {"CNMF_TPU_SKETCH": "auto", "CNMF_TPU_SKETCH_DIM": "auto"},
                {"CNMF_TPU_SKETCH": "1", "CNMF_TPU_SKETCH_DIM": ""}]


@pytest.mark.parametrize("env", RESOLVE_ENVS, ids=lambda e: str(e))
@pytest.mark.parametrize("shape", [(180, 2000), (1300, 2000), (40, 200),
                                   (64, 40), (2000, 300)])
def test_resolve_consensus_sketch_matches_jax(sketch_env, env, shape):
    for key, val in env.items():
        sketch_env.setenv(key, val)
    got = tsketch.resolve_consensus_sketch(*shape)
    want = jsketch.resolve_consensus_sketch(*shape)
    assert (got.engaged, got.dim, got.source) == (want.engaged, want.dim,
                                                  want.source)
    assert got.as_context() == want.as_context()


def test_resolve_consensus_sketch_refuses_as_jax(sketch_env):
    sketch_env.setenv("CNMF_TPU_SKETCH", "sometimes")
    with pytest.raises(ValueError) as got:
        tsketch.resolve_consensus_sketch(100, 2000)
    with pytest.raises(ValueError) as want:
        jsketch.resolve_consensus_sketch(100, 2000)
    assert str(got.value) == str(want.value)


def test_project_rows_with_jax_projection_matches_jax():
    A = np.random.default_rng(1).random((30, 300)).astype(np.float32)
    P = np.asarray(jax.random.normal(jax.random.key(0), (300, 64),
                                     jnp.float32) * (1.0 / np.sqrt(64)))
    got = tsketch.project_rows(A, 64, projection=P, device="cpu")
    np.testing.assert_allclose(got, jsketch.project_rows(A, 64), **F32)
    # the port's own draw has the law of JAX's: entries N(0, 1/dim)
    Pt = tsketch.projection_matrix(300, 64).numpy()
    assert abs(Pt.std() * np.sqrt(64) - 1.0) < 0.02
    assert tsketch.project_rows(A, 400, device="cpu") is not None


def _jax_projection(g, dim, seed=0):
    return np.asarray(jax.random.normal(jax.random.key(seed), (g, dim),
                                        jnp.float32) * (1.0 / np.sqrt(dim)))


def _merged(k=4, reps=10, g=300, seed=3):
    """``reps`` noisy replicates of k base programs, rows labelled as
    combine labels them."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(0.4, 1.0, (k, g))
    rows, labels = [], []
    for it in range(reps):
        for t in range(k):
            rows.append(base[t] * rng.lognormal(0.0, 0.3, g))
            labels.append("iter%d_topic%d" % (it, t + 1))
    rows[5] = rng.gamma(0.4, 1.0, g)      # an outlier the filter drops
    return np.asarray(rows), np.asarray(labels), [f"g{j}" for j in range(g)]


def _consensus_runs(tmp_path, monkeypatch, mode):
    """Port and JAX runs prepared on the same counts (300 HVGs), the same
    merged spectra injected, consensus at k=4 with the sketch forced."""
    rng = np.random.default_rng(0)
    n, g = 150, 400
    usage = rng.dirichlet(np.ones(4) * 0.3, size=n)
    spectra = rng.gamma(0.4, 1.0, size=(4, g)) * 200.0 / g
    counts = rng.poisson(usage @ spectra * 60.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    cells = [f"c{i}" for i in range(n)]
    genes = [f"g{j}" for j in range(g)]
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray(cells), np.asarray(genes)), fn)
    port = cNMF(str(tmp_path / "port"), "sk", device="cpu")
    ref = JaxCNMF(output_dir=str(tmp_path / "jax"), name="sk")
    for obj in (port, ref):
        obj.prepare(fn, components=[4], n_iter=10, seed=1,
                    num_highvar_genes=300, batch_size=64)
    with open(port.paths["nmf_genes_list"]) as f:
        hvgs = f.read().split("\n")
    vals, labels, _ = _merged(g=len(hvgs))
    save_df_to_npz(Frame(vals, labels, np.asarray(hvgs)),
                   port.paths["merged_spectra"] % 4)
    jax_save_df(pd.DataFrame(vals, index=labels, columns=hvgs),
                ref.paths["merged_spectra"] % 4)
    monkeypatch.setenv("CNMF_TPU_SKETCH", "1")
    P = _jax_projection(len(hvgs), 256)
    proj = tsketch.project_rows
    monkeypatch.setattr(tmodel, "project_rows",
                        lambda A, dim, **kw: proj(A, dim, projection=P,
                                                  **kw))
    # the usage refit's default init and the k-means cluster ids come
    # from the JAX package (torch cannot draw threefry), as in
    # tests/test_torch_pipeline.py
    monkeypatch.setattr(tnmf, "fit_h_default_init",
                        lambda n_, k_, seed=0, device="cpu":
                        convert.fit_h_init(np.asarray(
                            jnmf.fit_h_default_init(n_, k_)), device))

    def kmeans_with_jax_ids(Xf, k_, **kw):
        labels_, centers, inertia = tkmeans.kmeans(Xf, k_, **kw)
        want, _, _ = jkmeans.kmeans(Xf, k_, n_init=10, seed=1)
        return convert.cluster_labels(labels_, want), centers, inertia

    monkeypatch.setattr(tmodel, "kmeans", kmeans_with_jax_ids)
    stats = {}
    for name, obj in (("port", port), ("jax", ref)):
        kw = {} if name == "port" else dict(show_clustering=False)
        if mode == "stats":
            stats[name] = obj.consensus(
                4, skip_density_and_return_after_stats=True, **kw)
        else:
            obj.consensus(4, density_threshold=0.5, build_ref=False, **kw)
    return port, ref, stats


def test_f2_consensus_reads_the_sketch_knob(sketch_env, tmp_path):
    """Fault F2: with ``CNMF_TPU_SKETCH=1`` the JAX package clusters the
    projected spectra and the port clustered the full-width ones. Fed
    JAX's projection, the port's density filter, clusters and medians
    (from the full-width spectra) are JAX's."""
    port, ref, _ = _consensus_runs(tmp_path, sketch_env, "consensus")
    info = port.consensus_info[4]
    assert (info["sketch"], info["sketch_dim"], info["distance_width"]) \
        == (True, 256, 256)
    # projected densities never enter the exact runs' cache
    import os

    assert not os.path.exists(port.paths["local_density_cache"] % 4)
    from cnmf_torch_tpu import load_df_from_npz as jload

    # the medians (the clusters are held equal by kmeans_with_jax_ids);
    # the usages come from the refits, held elsewhere
    got = jload(port.paths["consensus_spectra"] % (4, "0_5")).values
    want = jload(ref.paths["consensus_spectra"] % (4, "0_5")).values
    assert got.shape == want.shape == (4, 300)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_f2_stats_silhouette_in_the_projected_space(sketch_env, tmp_path):
    _, _, stats = _consensus_runs(tmp_path, sketch_env, "stats")
    got = stats["port"].values[:, 0]
    want = stats["jax"].values[:, 0]
    assert got[2] == pytest.approx(want[2], rel=1e-5)     # silhouette


def test_k_selection_takes_one_sweep_level_decision(sketch_env, tmp_path):
    """Under ``auto`` a per-K decision would engage at the larger K only;
    the statistics take the decision of the largest merged matrix for
    every K, as the JAX package's K-selection does."""
    from test_torch_resilience import _prepared

    obj = _prepared(tmp_path, "ksel", components=(3, 4))
    obj.factorize()
    obj.combine()
    sketch_env.setenv("CNMF_TPU_SKETCH", "auto")
    sketch_env.setenv("CNMF_TPU_SKETCH_DIM", "3")
    assert not tsketch.resolve_consensus_sketch(9, 50).engaged
    assert tsketch.resolve_consensus_sketch(12, 50).engaged
    stats = obj.k_selection_stats()
    want = jsketch.resolve_consensus_sketch(12, 50)
    rec = obj.consensus_info["k_selection"]
    assert rec["R_max"] == 12 and rec["sketch"] == want.engaged
    for k in (3, 4):
        assert obj.consensus_info[k]["distance_width"] == 3
    assert np.isfinite(stats.values).all()
