"""The port's pipeline end to end on the CPU, against the JAX package.

(a) The golden design of ``tests/test_reproducibility.py`` on the port:
    prepare for real, inject the golden merged spectra, consensus for real,
    and compare every artifact with ``tests/golden/data/``. The usage
    refits draw their default init from the JAX package (threefry) through
    ``convert.fit_h_init``, since torch cannot reproduce that stream, and
    the port's k-means clusters take the JAX clusters' ids through
    ``convert.cluster_labels`` (which checks that the partitions agree).
    ``gene_spectra_tpm`` is compared with the JAX package's own output on
    the same inputs (the JAX package misses that golden on this tree).
(b) The slice itself: KL on a sparse count matrix through prepare,
    factorize (ELL lane, plain statistics), combine, consensus and the
    K-selection statistics; the artifacts are read by the JAX package.
(c) The port's replicate sweep against the JAX sweep (ELL lane, Pallas
    kernels in interpret mode) from the same carried inits: per-replicate
    objectives within 5%, the band of the bf16 chain both sweeps run.
"""

import importlib
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import yaml

from cnmf_torch_tpu import cNMF as JaxCNMF
from cnmf_torch_tpu import load_df_from_npz as jax_load_df
from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu_torch import Frame, cNMF, convert, save_df_to_npz
from cnmf_torch_tpu_torch import load_df_from_npz as port_load_df
from cnmf_torch_tpu_torch.models import cnmf as tmodel
from cnmf_torch_tpu_torch.ops import kmeans as tkmeans
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.parallel import replicate_sweep

jkmeans = importlib.import_module("cnmf_torch_tpu.ops.kmeans")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "data")
RMS_TOL = 1e-4
KS = [4, 5]
CONSENSUS = [(4, "0_5"), (4, "2_0")]

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each (one spinning thread per core) would oversubscribe
    the cores and slow every worker."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)



def rms(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _jax_default_init(n, k, seed=0, device="cpu"):
    return convert.fit_h_init(np.asarray(jnmf.fit_h_default_init(n, k)),
                              device)


def _kmeans_with_jax_ids(X, k, **kw):
    labels, centers, inertia = tkmeans.kmeans(X, k, **kw)
    ref, _, _ = jkmeans.kmeans(X, k, n_init=10, seed=1)
    return convert.cluster_labels(labels, ref), centers, inertia


def _golden_run(obj):
    obj.prepare(os.path.join(GOLDEN, "counts.df.npz"), components=KS,
                n_iter=6, seed=14, num_highvar_genes=120, batch_size=64,
                max_NMF_iter=200)
    for k in KS:
        shutil.copyfile(
            os.path.join(GOLDEN, f"golden.spectra.k_{k}.merged.df.npz"),
            obj.paths["merged_spectra"] % k)
    for k, dtr in CONSENSUS:
        obj.consensus(k, density_threshold=float(dtr.replace("_", ".")),
                      show_clustering=False, build_ref=True)
    return obj


@pytest.fixture(scope="module")
def golden_runs(tmp_path_factory):
    """The port's and the JAX package's golden runs on the same inputs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnmf, "fit_h_default_init", _jax_default_init)
        mp.setattr(tmodel, "kmeans", _kmeans_with_jax_ids)
        port = _golden_run(cNMF(str(tmp_path_factory.mktemp("port")),
                                "golden", device="cpu"))
        stats = port.k_selection_stats()
    ref = _golden_run(JaxCNMF(output_dir=str(tmp_path_factory.mktemp("jax")),
                              name="golden"))
    return port, stats, ref


def _golden(name):
    return os.path.join(GOLDEN, name)


def test_golden_seed_ledger_exact(golden_runs):
    port, _, _ = golden_runs
    got = jax_load_df(port.paths["nmf_replicate_parameters"])
    want = jax_load_df(_golden("golden.nmf_params.df.npz"))
    for col in ["n_components", "iter", "nmf_seed"]:
        np.testing.assert_array_equal(got[col].values.astype(np.int64),
                                      want[col].values.astype(np.int64), col)


def test_golden_solver_params_exact(golden_runs):
    port, _, _ = golden_runs
    with open(port.paths["nmf_run_parameters"]) as f:
        got = yaml.safe_load(f)
    with open(_golden("golden.nmf_idvrun_params.yaml")) as f:
        want = yaml.safe_load(f)
    assert got == want


def test_golden_hvg_list_exact(golden_runs):
    port, _, _ = golden_runs
    with open(port.paths["nmf_genes_list"]) as f:
        got = f.read()
    with open(_golden("golden.overdispersed_genes.txt")) as f:
        assert got == f.read()


def test_golden_tpm_stats_rms(golden_runs):
    port, _, _ = golden_runs
    got = jax_load_df(port.paths["tpm_stats"])
    want = jax_load_df(_golden("golden.tpm_stats.df.npz"))
    assert list(got.index) == list(want.index)
    assert rms(got.values, want.values) < RMS_TOL


@pytest.mark.parametrize("key,basename", [
    ("consensus_spectra", "golden.spectra.k_%d.dt_%s.consensus.df.npz"),
    ("consensus_usages", "golden.usages.k_%d.dt_%s.consensus.df.npz"),
    ("gene_spectra_score", "golden.gene_spectra_score.k_%d.dt_%s.df.npz"),
    ("starcat_spectra", "golden.starcat_spectra.k_%d.dt_%s.df.npz"),
])
@pytest.mark.parametrize("k,dtr", CONSENSUS)
def test_golden_consensus_artifacts_rms(golden_runs, key, basename, k, dtr):
    port, _, _ = golden_runs
    got = jax_load_df(port.paths[key] % (k, dtr))
    want = jax_load_df(_golden(basename % (k, dtr)))
    assert got.shape == want.shape
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    assert rms(got.values, want.values) < RMS_TOL, f"{key} k={k} dt={dtr}"


@pytest.mark.parametrize("k,dtr", CONSENSUS)
def test_gene_spectra_tpm_matches_jax_run(golden_runs, k, dtr):
    """TPM-unit spectra are f32 values of order 1e3-1e4, whose spacing
    (1e-3 at 1e4) is above an absolute RMS of 1e-4: the bar is an RMS of
    1e-6 relative to the artifact's own RMS (a few f32 ulps)."""
    port, _, ref = golden_runs
    got = jax_load_df(port.paths["gene_spectra_tpm"] % (k, dtr))
    want = jax_load_df(ref.paths["gene_spectra_tpm"] % (k, dtr))
    assert got.shape == want.shape
    assert list(got.columns) == list(want.columns)
    scale = rms(want.values, np.zeros_like(want.values))
    assert rms(got.values, want.values) < 1e-6 * scale


def test_golden_k_selection_stats(golden_runs):
    _, stats, _ = golden_runs
    want = jax_load_df(_golden("golden.k_selection_stats.df.npz"))
    cols = list(stats.columns)
    assert cols == list(want.columns)
    got = stats.values
    assert rms(got[:, [0, 2]], want[["k", "silhouette"]].values) < RMS_TOL
    np.testing.assert_allclose(got[:, 3], want["prediction_error"].values,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# (b) the slice end to end: KL on sparse counts through the ELL lane
# ---------------------------------------------------------------------------

def _sparse_counts(n=400, g=1000, k_true=6, scale=10.0, seed=7):
    """The low-rank Poisson model of ``bench.py``: at this size the 200
    HVGs hold ~5% nonzeros at row width 24 <= 200/8, so the ELL lane
    engages by the default dispatch rule."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k_true) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(k_true, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * scale).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                 np.asarray([f"g{j}" for j in range(g)]))


@pytest.fixture(scope="module")
def kl_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("kl")
    counts_fn = os.path.join(str(d), "counts.df.npz")
    save_df_to_npz(_sparse_counts(), counts_fn)
    obj = cNMF(str(d), "kl", device="cpu")
    obj.prepare(counts_fn, components=[4, 5], n_iter=4, seed=14,
                beta_loss="kullback-leibler", num_highvar_genes=200,
                batch_size=256, max_NMF_iter=200)
    obj.factorize()
    obj.combine()
    calls = []
    plain = kl_ell.h_stats_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kl_ell, "h_stats_plain",
                   lambda *a, **kw: calls.append(1) or plain(*a, **kw))
        obj.consensus(4, density_threshold=2.0)
    stats = obj.k_selection_stats()
    return obj, stats, len(calls)


def test_kl_slice_takes_the_ell_lane(kl_run):
    obj, _, refit_calls = kl_run
    info = obj.factorize_info
    assert info["lane"] == "ell" and info["kernel"] == "ell-torch"
    assert info["bf16_ratio"] is True
    for k in (4, 5):
        (trace,) = info["trace"][k]
        assert trace.shape[1] == 4 and np.isfinite(trace).all()
        # the first pass solves its usage blocks against the random init
        # and is no bound (the JAX solver's pass objectives rise after it
        # too); from the second pass on the objective falls
        assert (trace[-1] < trace[1]).all()
        assert np.isfinite(info["errs"][k]).all()
    # the consensus usage refit ran the ELL H statistics
    assert refit_calls > 0


def test_kl_slice_artifacts(kl_run):
    obj, stats, _ = kl_run
    n, g_hv = 400, 200
    for k in (4, 5):
        merged = jax_load_df(obj.paths["merged_spectra"] % k)
        assert merged.shape == (4 * k, g_hv)
        assert list(merged.index[:2]) == ["iter0_topic1", "iter0_topic2"]
        # a DataFrame read by the JAX package carries back into the port
        back = convert.frame(merged.values, merged.index, merged.columns)
        own = port_load_df(obj.paths["merged_spectra"] % k)
        np.testing.assert_array_equal(back.values, own.values)
        assert list(back.index) == list(own.index)
    shapes = {"consensus_spectra": (4, g_hv), "consensus_usages": (n, 4),
              "gene_spectra_tpm": (4, 1000), "gene_spectra_score": (4, 1000),
              "starcat_spectra": (4, g_hv)}
    for key, shape in shapes.items():
        df = jax_load_df(obj.paths[key] % (4, "2_0"))
        assert df.shape == shape, key
        assert np.isfinite(df.values.astype(np.float64)).all(), key
        assert os.path.exists(obj.paths[key + "__txt"] % (4, "2_0"))
    ks = jax_load_df(obj.paths["k_selection_stats"])
    assert list(ks.columns) == ["k", "local_density_threshold",
                                "silhouette", "prediction_error"]
    np.testing.assert_array_equal(ks["k"].values, [4, 5])
    assert np.isfinite(stats.values).all()
    usage, scores, spectra_tpm, top = obj.load_results(4, 2.0,
                                                       n_top_genes=10)
    np.testing.assert_allclose(usage.values.sum(axis=1), 1.0, rtol=1e-5)
    assert scores.shape == (1000, 4) and top.shape == (10, 4)


# ---------------------------------------------------------------------------
# (c) the replicate sweep against the JAX sweep from carried inits
# ---------------------------------------------------------------------------

def test_replicate_sweep_matches_jax_sweep(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_SPARSE_BETA", "1")
    monkeypatch.setenv("CNMF_TPU_PALLAS", "1")
    rng = np.random.default_rng(8)
    X = sp.random(150, 80, density=0.08, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1)
    X = X.astype(np.float32)
    n, k, chunk = X.shape[0], 4, 64
    seeds = [11, 22, 33]
    e, _ = jsp.ell_chunk_rows(X, chunk)
    H0, W0 = jrep._stacked_inits(jsp.ell_device_put(e), k, seeds,
                                 "random", n_rows=n)
    _, _, want = jrep.replicate_sweep(
        X, seeds, k, beta_loss="kullback-leibler",
        online_chunk_size=chunk, online_chunk_max_iter=200)
    te, _ = tsp.ell_chunk_rows(X, chunk)
    spectra, usages, got = replicate_sweep(
        te, seeds, k, beta_loss="kullback-leibler", online_chunk_size=chunk,
        online_chunk_max_iter=200, n_rows=n,
        inits=convert.replicate_inits(np.asarray(H0), np.asarray(W0)),
        return_usages=True, device="cpu")
    assert spectra.shape == (3, k, 80) and usages.shape == (3, n, k)
    np.testing.assert_allclose(got, want, rtol=5e-2)


# ---------------------------------------------------------------------------
# (d) F4: cNMF.update_nmf_iter_params, in a two-worker resume
# ---------------------------------------------------------------------------

def _structured_counts(n=60, g=90, k_true=4, seed=0):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k_true) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(k_true, g)) * 50.0 / g
    counts = rng.poisson(usage @ spectra * 200.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return (counts, np.asarray([f"c{i}" for i in range(n)]),
            np.asarray([f"g{j}" for j in range(g)]))


def _two_worker_resume(obj, counts_fn):
    """The JAX package's elastic-completion flow
    (``tests/test_pipeline.py::test_worker_sharding_and_skip_missing``):
    worker 0 of 2 runs, the ledger is re-probed, a one-worker resume
    completes the run. Returns the ``completed`` column after the re-probe
    and after the resume, and the merged spectra's shape."""
    obj.prepare(counts_fn, components=[3], n_iter=4, seed=1,
                num_highvar_genes=60, batch_size=64, max_NMF_iter=100)
    obj.factorize(worker_i=0, total_workers=2)
    obj.update_nmf_iter_params()
    done = list(_completed(obj))
    obj.factorize(worker_i=0, total_workers=1, skip_completed_runs=True)
    obj.update_nmf_iter_params()
    merged = obj.combine_nmf(3)
    return done, list(_completed(obj)), tuple(merged.shape)


def _completed(obj):
    ledger = port_load_df(obj.paths["nmf_replicate_parameters"])
    return [bool(v) for v in ledger.column("completed")]


def test_f4_update_nmf_iter_params_matches_jax(tmp_path):
    """Fault F4: the port had no ``update_nmf_iter_params``, so the JAX
    package's resume flow raised AttributeError."""
    import pandas as pd
    from cnmf_torch_tpu import save_df_to_npz as jax_save_df

    counts, rows, cols = _structured_counts()
    jfn, tfn = str(tmp_path / "j.df.npz"), str(tmp_path / "t.df.npz")
    jax_save_df(pd.DataFrame(counts, index=rows, columns=cols), jfn)
    save_df_to_npz(Frame(counts, rows, cols), tfn)
    got = _two_worker_resume(cNMF(str(tmp_path), "port", device="cpu"), tfn)
    want = _two_worker_resume(JaxCNMF(output_dir=str(tmp_path), name="jax"),
                              jfn)
    assert got == want
    assert got == ([True, False, True, False], [True] * 4, (12, 60))


# ---------------------------------------------------------------------------
# (e) prepare's sparse sums: ordered segment sums, no atomics
# ---------------------------------------------------------------------------

def test_prepare_sums_are_ordered_segment_sums():
    """The sparse row totals and column moments of prepare are ordered
    segment sums: on the CPU bit for bit the sequential ``index_add_``
    scatter they replaced (whose CUDA form adds atomically, so the f64
    tpm_stats artifact changed in its last bits from run to run), and
    within 1e-12 of the JAX package's host moments."""
    from cnmf_torch_tpu.ops import stats as jstats
    from cnmf_torch_tpu_torch.ops import stats as tstats

    rng = np.random.default_rng(11)
    X = sp.random(400, 150, density=0.07, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(1.0, 3.0, s))
    X = sp.csr_matrix(X.toarray() * (np.arange(150) != 7))  # empty column
    totals = tstats.row_sums(X, device="cpu")
    (mean, var), (smean, svar) = tstats.column_moments_staged(
        X, row_scale=1e6 / totals, device="cpu")

    data = torch.as_tensor(X.data, dtype=torch.float64)
    rows = torch.repeat_interleave(torch.arange(400),
                                   torch.as_tensor(np.diff(X.indptr)))
    idx = torch.as_tensor(X.indices.astype(np.int64))
    want_totals = torch.zeros(400, dtype=torch.float64).index_add_(
        0, rows, data)
    want_s1 = torch.zeros(150, dtype=torch.float64).index_add_(0, idx, data)
    assert np.array_equal(totals, want_totals.numpy())
    assert np.array_equal(mean, (want_s1 / 400).numpy())
    assert mean[7] == 0.0 and var[7] == 0.0

    jmean, jvar = jstats.column_mean_var(X)
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=1e-12)
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=1e-12)
    Xs = sp.diags(1e6 / totals) @ X
    jsmean, jsvar = jstats.column_mean_var(Xs)
    np.testing.assert_allclose(smean, np.asarray(jsmean), rtol=1e-12)
    np.testing.assert_allclose(svar, np.asarray(jsvar), rtol=1e-12)
