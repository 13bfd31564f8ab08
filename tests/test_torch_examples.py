"""The four tutorials on the port (``cnmf_torch_tpu_torch/examples/``),
held to the JAX package's (``examples/``), and the public pieces they
brought with them: ``compute_tpm``, ``StreamStats.record_to`` (the stream
rows of the timings TSV) and the h5ad writes of a machine without h5py
(``ROADMAP.md`` D20).

Sizes are ``tests/test_examples.py``'s: the simulated tutorial at full size,
the others reduced. Each port tutorial runs with ``device="cpu"`` and its
own ground-truth assertions, at the JAX thresholds."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linear_sum_assignment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from cnmf_torch_tpu_torch.examples import (  # noqa: E402
    _common, batch_correction_tutorial, pbmc_tutorial, seurat_vignette,
    simulated_tutorial)
from cnmf_torch_tpu_torch.utils.io import (Counts,  # noqa: E402
                                           load_df_from_npz,
                                           load_df_from_text)

PBMC_SMALL = dict(n_cells=600, n_genes=900, n_iter=6, ks=[9, 10, 11])
BATCH_SMALL = dict(n_cells=800, n_genes=600, n_iter=8)
SEURAT_SMALL = dict(n_cells=300, n_genes=400, n_iter=6, k=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _jax_tutorial(name):
    return importlib.import_module(name)


# -- the simulations: the same numpy code and seeds --------------------------

@pytest.mark.parametrize("name, fn, kwargs", [
    ("simulated_tutorial", "simulate_counts", {}),
    ("pbmc_tutorial", "simulate_pbmc_like", {}),
    ("pbmc_tutorial", "simulate_pbmc_like",
     dict(n_cells=600, n_genes=900)),
    ("batch_correction_tutorial", "simulate_citeseq_batches", {}),
    ("batch_correction_tutorial", "simulate_citeseq_batches",
     dict(n_cells=800, n_genes=600)),
])
def test_simulated_counts_equal_jax(name, fn, kwargs):
    port = getattr(importlib.import_module(
        f"cnmf_torch_tpu_torch.examples.{name}"), fn)(**kwargs)
    jax = getattr(_jax_tutorial(name), fn)(**kwargs)
    assert len(port) == len(jax)
    for a, b in zip(port, jax):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the simulated tutorial: both packages on the same counts ----------------

@pytest.fixture(scope="module")
def jax_sim(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_sim"))
    _jax_tutorial("simulated_tutorial").main(d)
    return d


@pytest.fixture(scope="module")
def port_sim(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_sim"))
    simulated_tutorial.main(d, device="cpu")  # asserts r > 0.95 inside
    return d


def test_simulated_tutorial_counts_file_equals_jax(jax_sim, port_sim):
    a = load_df_from_npz(os.path.join(port_sim, "sim_counts.df.npz"))
    b = load_df_from_npz(os.path.join(jax_sim, "sim_counts.df.npz"))
    assert np.array_equal(a.values, b.values)
    assert list(a.index) == list(b.index)
    assert list(a.columns) == list(b.columns)


def test_simulated_tutorial_spectra_match_jax_one_to_one(jax_sim, port_sim):
    fn = "sim_run/sim_run.gene_spectra_tpm.k_6.dt_0_2.txt"
    port = load_df_from_text(os.path.join(port_sim, fn))
    jax = load_df_from_text(os.path.join(jax_sim, fn))
    assert port.shape == jax.shape == (6, 1500)
    assert list(port.columns) == list(jax.columns)
    r = np.corrcoef(np.vstack([port.values, jax.values]))[:6, 6:]
    rows, cols = linear_sum_assignment(-r)
    matched = r[rows, cols]
    assert (matched >= 0.95).all(), matched


def _stream_rows(tsv):
    """``{name: (has bytes, meta keys)}`` of the stream sub-phase rows."""
    with open(tsv) as f:
        lines = [ln.rstrip("\n").split("\t") for ln in f][1:]
    out = {}
    for stage, _wall, nbytes, _gbps, _ts, _err, meta in lines:
        if "/" in stage:
            assert stage not in out, f"{stage} recorded twice"
            keys = tuple(sorted(kv.split("=")[0] for kv in meta.split(";")
                                if kv))
            out[stage] = (nbytes != "", keys)
    return out


def test_record_to_rows_match_jax_in_the_timings_tsv(jax_sim, port_sim):
    tsv = "sim_run/cnmf_tmp/sim_run.timings.tsv"
    port = _stream_rows(os.path.join(port_sim, tsv))
    jax = _stream_rows(os.path.join(jax_sim, tsv))
    assert port == jax
    assert "stage_dense:tpm/wall" in port
    assert port["stage_dense:tpm/wall"] == (True, ("overlap", "slabs"))


class _Rows:
    def __init__(self):
        self.rows = []

    def record(self, name, seconds, nbytes=None, **meta):
        self.rows.append((name, seconds, nbytes, meta))


@pytest.mark.parametrize("disk_s", [0.0, 0.375])
def test_record_to_writes_jax_s_rows(disk_s):
    from cnmf_torch_tpu.parallel.streaming import StreamStats as JaxStats

    from cnmf_torch_tpu_torch.parallel.streaming import StreamStats

    timers = []
    for cls in (StreamStats, JaxStats):
        stats = cls()
        stats.add(host_prep_s=0.5, h2d_s=0.25, device_s=0.125, nbytes=4096,
                  slabs=3, disk_s=disk_s, disk_nbytes=2048)
        stats.wall_s = 0.6
        timer = _Rows()
        stats.record_to(timer, "stage_dense:x")
        stats.record_to(None, "stage_dense:x")
        timers.append(timer.rows)
    assert timers[0] == timers[1]
    assert [r[0] for r in timers[0]] == (
        ["stage_dense:x/disk"] * (disk_s > 0)
        + [f"stage_dense:x/{p}" for p in ("host_prep", "h2d", "device",
                                          "wall")])


# -- the consensus residency --------------------------------------------------

GOLDEN = os.path.join(ROOT, "tests", "golden", "data")


def _golden_consensus(out_dir, counts_fn, obj=None):
    """prepare on ``counts_fn``, the golden merged spectra injected in
    place of a factorize, consensus at K 4; returns the object."""
    import shutil

    from cnmf_torch_tpu_torch import cNMF

    obj = obj or cNMF(out_dir, "golden", device="cpu")
    obj.prepare(counts_fn, components=[4], n_iter=6, seed=14,
                num_highvar_genes=120, batch_size=64, max_NMF_iter=200)
    shutil.copyfile(os.path.join(GOLDEN, "golden.spectra.k_4.merged.df.npz"),
                    obj.paths["merged_spectra"] % 4)
    obj.consensus(4, density_threshold=0.5, show_clustering=False)
    return obj


def test_a_re_prepare_drops_the_consensus_residency(tmp_path):
    """A second prepare on other counts of the same shape empties the
    residency cache, so the next consensus stages the new matrices and
    writes what a new object writes."""
    from cnmf_torch_tpu_torch import Frame, save_df_to_npz

    golden = load_df_from_npz(os.path.join(GOLDEN, "counts.df.npz"))
    rolled = str(tmp_path / "rolled.df.npz")
    save_df_to_npz(Frame(np.roll(golden.values, 7, axis=0), golden.index,
                         golden.columns), rolled)
    obj = _golden_consensus(str(tmp_path / "re"),
                            os.path.join(GOLDEN, "counts.df.npz"))
    assert set(obj._dev_cache) == {"norm_counts", "tpm"}
    first = {k: v[1] for k, v in obj._dev_cache.items()}
    obj.prepare(rolled, components=[4], n_iter=6, seed=14,
                num_highvar_genes=120, batch_size=64, max_NMF_iter=200)
    assert obj._dev_cache == {}
    _golden_consensus(None, rolled, obj=obj)
    assert all(obj._dev_cache[k][1] is not first[k] for k in first)
    fresh = _golden_consensus(str(tmp_path / "fresh"), rolled)
    for key in ("consensus_spectra", "consensus_usages", "gene_spectra_tpm"):
        got = load_df_from_npz(obj.paths[key] % (4, "0_5"))
        want = load_df_from_npz(fresh.paths[key] % (4, "0_5"))
        np.testing.assert_array_equal(got.values, want.values, key)


# -- one ELL lane rule ---------------------------------------------------------

@pytest.mark.parametrize("knob", ["", "0", "1"])
@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_the_refits_follow_the_one_lane_rule(knob, beta_loss, monkeypatch,
                                             tmp_path):
    """``stage_matrix``, ``run_nmf_use_ell``, the spectra refit and the
    consensus residency all ask ``takes_ell_lane``: a sparse matrix stays
    on the host for the refits exactly when it or its transpose takes the
    ELL lane."""
    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.ops import nmf as tnmf
    from cnmf_torch_tpu_torch.ops.sparse import EllMatrix

    monkeypatch.setenv("CNMF_TPU_SPARSE_BETA", knob)
    rng = np.random.default_rng(3)
    X = sp.random(300, 400, density=0.02, format="csr", random_state=rng,
                  data_rvs=lambda n: rng.integers(1, 9, n).astype(np.float32))
    beta = 2.0 if beta_loss == "frobenius" else 1.0
    ell = tnmf.takes_ell_lane(X, beta)
    assert ell == (beta == 1.0 and knob != "0")
    assert tnmf.run_nmf_use_ell(X, beta) is ell
    assert isinstance(tnmf.stage_matrix(X, beta, "cpu"), EllMatrix) is ell
    obj = cNMF(str(tmp_path), "lanes", device="cpu")
    monkeypatch.setattr(obj, "_solver_params",
                        lambda: {"beta_loss": beta_loss})
    assert obj._refits_dense(X) is not (ell or tnmf.takes_ell_lane(X.T, beta))
    staged = obj._stage_dense("x", X)
    assert isinstance(staged, torch.Tensor) is obj._refits_dense(X)


# -- compute_tpm ----------------------------------------------------------

@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("with_totals", [True, False])
def test_compute_tpm_matches_jax(sparse, with_totals):
    from cnmf_torch_tpu.models import compute_tpm as jax_tpm
    from cnmf_torch_tpu.ops.stats import row_sums
    from cnmf_torch_tpu.utils.anndata_lite import AnnDataLite

    from cnmf_torch_tpu_torch.models import compute_tpm

    rng = np.random.default_rng(5)
    X = rng.poisson(0.7, size=(40, 30)).astype(np.float64)
    X[3] = 0.0  # a cell with no counts stays at zero
    X = sp.csr_matrix(X) if sparse else X
    obs = [f"c{i}" for i in range(40)]
    var = [f"g{j}" for j in range(30)]
    totals = row_sums(X) if with_totals else None
    want = jax_tpm(AnnDataLite(X, obs=pd.DataFrame(index=obs),
                               var=pd.DataFrame(index=var)), totals=totals)
    got = compute_tpm(Counts(X, np.asarray(obs), np.asarray(var),
                             var={"kind": np.asarray(["x"] * 30)}),
                      totals=totals, device="cpu")
    assert sp.issparse(got.X) == sparse
    dense = (lambda a: a.toarray() if sp.issparse(a) else np.asarray(a))
    np.testing.assert_allclose(dense(got.X), dense(want.X), rtol=1e-6)
    assert list(got.obs_names) == obs and list(got.var_names) == var
    assert list(got.var) == ["kind"]


# -- the PBMC tutorial, through h5ad and through the 10x trio -----------------

@pytest.fixture(scope="module")
def pbmc_h5ad(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pbmc_h5ad"))
    best = pbmc_tutorial.main(d, device="cpu", **PBMC_SMALL)
    return d, best


def test_pbmc_tutorial_recovers_the_programs(pbmc_h5ad):
    d, best = pbmc_h5ad
    assert os.path.exists(os.path.join(d, "pbmc_like_counts.h5ad"))
    assert (best[:8] > 0.8).all()


def _no_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)


def test_pbmc_without_h5py_reads_the_10x_trio(pbmc_h5ad, tmp_path,
                                              monkeypatch, capfd):
    _no_h5py(monkeypatch)
    best = pbmc_tutorial.main(str(tmp_path), device="cpu", **PBMC_SMALL)
    err = capfd.readouterr().err
    mtx = os.path.join(str(tmp_path), "pbmc_like_counts_10x", "matrix.mtx")
    assert f"h5py is not installed: wrote {mtx}" in err
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "pbmc_like_counts.h5ad"))
    # the same integer counts reach prepare either way: the same run
    np.testing.assert_array_equal(best, pbmc_h5ad[1])


def test_only_an_import_error_picks_the_fallback(tmp_path, monkeypatch):
    counts = Counts(sp.csr_matrix(np.eye(3)), np.asarray(["a", "b", "c"]),
                    np.asarray(["x", "y", "z"]))

    class Broken:
        def find_spec(self, name, path=None, target=None):
            if name == "h5py":
                raise RuntimeError("a broken h5py install")
            return None

    monkeypatch.delitem(sys.modules, "h5py", raising=False)
    monkeypatch.setattr(sys, "meta_path", [Broken()] + sys.meta_path)
    with pytest.raises(RuntimeError, match="broken h5py"):
        _common.write_counts(str(tmp_path / "c.h5ad"), counts)
    monkeypatch.undo()
    # with h5py, a failing write raises too (no fallback)
    with pytest.raises(OSError):
        _common.write_counts(str(tmp_path / "missing" / "c.h5ad"), counts)
    _no_h5py(monkeypatch)
    path = _common.write_counts(str(tmp_path / "c.h5ad"), counts)
    assert path == str(tmp_path / "c_10x" / "matrix.mtx")
    from cnmf_torch_tpu_torch.utils.io import load_counts

    back = load_counts(path)
    assert np.array_equal(back.X.toarray(), np.eye(3))
    assert list(back.obs_names) == ["a", "b", "c"]


# -- the batch-correction tutorial -------------------------------------------

@pytest.mark.parametrize("h5py_here", [True, False])
def test_batch_correction_tutorial(tmp_path, monkeypatch, h5py_here):
    """Harmony mixes the batches and the biology is recovered, from the
    sidecar's h5ad hand-off and from its ``.df.npz`` one (no h5py)."""
    if not h5py_here:
        _no_h5py(monkeypatch)
    sil_raw, sil_corr, best, dt = batch_correction_tutorial.main(
        str(tmp_path), device="cpu", **BATCH_SMALL)
    assert (best > 0.8).sum() >= 5
    assert dt in (0.5, 2.0)
    assert os.path.exists(os.path.join(
        str(tmp_path), "islets", "cnmf_tmp",
        "islets.spectra.k_6.dt_%s.consensus.df.npz"
        % str(dt).replace(".", "_")))
    suffix = ".h5ad" if h5py_here else ".df.npz"
    for name in ("Corrected.HVG.Varnorm", "TP10K"):
        assert os.path.exists(os.path.join(str(tmp_path),
                                           f"islets_pre.{name}{suffix}"))


@pytest.mark.parametrize("error", ["density", "runtime", "oom"])
def test_batch_correction_falls_back_only_on_the_density_filter(
        tmp_path, monkeypatch, error):
    """consensus at 0.5 failing in its density filter reruns at 2.0; any
    other error (a device fault, an out-of-memory) raises."""
    from cnmf_torch_tpu_torch.models.cnmf import DensityFilterError, cNMF

    real = cNMF.consensus
    raised = {"density": DensityFilterError("Zero components remain"),
              "runtime": RuntimeError("a device fault"),
              "oom": torch.OutOfMemoryError("out of memory")}[error]
    asked = []

    def consensus(self, k, density_threshold=0.5, **kw):
        asked.append(density_threshold)
        if density_threshold == 0.5:
            raise raised
        return real(self, k, density_threshold=density_threshold, **kw)

    monkeypatch.setattr(cNMF, "consensus", consensus)
    if error != "density":
        # the failure comes before any replicate is read
        monkeypatch.setattr(cNMF, "factorize", lambda self, **kw: None)
        monkeypatch.setattr(cNMF, "combine", lambda self, **kw: None)
        with pytest.raises(type(raised)) as info:
            batch_correction_tutorial.main(str(tmp_path), device="cpu",
                                           **BATCH_SMALL)
        assert info.value is raised and asked == [0.5]
        return
    dt = batch_correction_tutorial.main(str(tmp_path), device="cpu",
                                        **BATCH_SMALL)[3]
    assert asked == [0.5, 2.0] and dt == 2.0


# -- the Seurat vignette: the same files as JAX's -----------------------------

@pytest.fixture(scope="module")
def seurat_runs(tmp_path_factory):
    jd = str(tmp_path_factory.mktemp("jax_seurat"))
    pd_ = str(tmp_path_factory.mktemp("port_seurat"))
    j = _jax_tutorial("seurat_vignette").main(jd, **SEURAT_SMALL)
    p = seurat_vignette.main(pd_, device="cpu", **SEURAT_SMALL)
    return (jd, j), (pd_, p)


def test_seurat_vignette_writes_jax_s_files(seurat_runs):
    (jd, j_r), (pd_, p_r) = seurat_runs
    assert os.path.relpath(j_r, jd) == os.path.relpath(p_r, pd_)
    with open(j_r) as f:
        j_text = f.read().replace(jd, "<out>")
    with open(p_r) as f:
        p_text = f.read().replace(pd_, "<out>")
    assert p_text == j_text
    tenx = "vignette/for_seurat_10x"
    for name in ("matrix.mtx", "barcodes.tsv", "features.tsv"):
        with open(os.path.join(jd, tenx, name), "rb") as a, \
                open(os.path.join(pd_, tenx, name), "rb") as b:
            assert a.read() == b.read(), name
    a = load_df_from_npz(os.path.join(jd, "counts.df.npz"))
    b = load_df_from_npz(os.path.join(pd_, "counts.df.npz"))
    assert np.array_equal(a.values, b.values)


@pytest.mark.parametrize("artifact", [
    "usages.k_4.dt_2_0.consensus", "gene_spectra_score.k_4.dt_2_0",
    "gene_spectra_tpm.k_4.dt_2_0"])
def test_seurat_vignette_tables_have_jax_s_rows_and_columns(seurat_runs,
                                                            artifact):
    (jd, _), (pd_, p_r) = seurat_runs
    fn = f"vignette/vignette.{artifact}.txt"
    with open(os.path.join(jd, fn)) as f:
        j_rows = [ln.split("\t")[0] for ln in f]
    with open(os.path.join(pd_, fn)) as f:
        p_rows = [ln.split("\t")[0] for ln in f]
    assert p_rows == j_rows
    with open(os.path.join(jd, fn)) as f, open(os.path.join(pd_, fn)) as g:
        assert f.readline() == g.readline()  # the header: the columns
    # every path the generated R code reads exists
    import re

    with open(p_r) as f:
        for p in re.findall(r'"(/[^"]+)"', f.read()):
            assert os.path.exists(p), p


# -- the device rule and the command line -------------------------------------

@pytest.mark.parametrize("module", [
    simulated_tutorial, pbmc_tutorial, batch_correction_tutorial,
    seurat_vignette], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_a_tutorial_defaults_to_cuda_and_raises_without_a_card(
        module, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(str(tmp_path / "run"))
    assert not os.path.exists(tmp_path / "run")


def test_the_command_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    module = "cnmf_torch_tpu_torch.examples.seurat_vignette"
    ok = subprocess.run([sys.executable, "-m", module, str(tmp_path / "ok"),
                         "--device", "cpu"], cwd=str(tmp_path), env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert "Seurat import script:" in ok.stdout
    card = subprocess.run(
        [sys.executable, "-c", "import torch; torch.cuda.is_available = "
         "lambda: False; import runpy, sys; sys.argv = ['x', "
         f"{str(tmp_path / 'no')!r}]; runpy.run_module({module!r}, "
         "run_name='__main__')"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert card.returncode != 0 and "no CUDA device" in card.stderr


def test_the_lint_gate_covers_the_tutorials():
    from cnmf_torch_tpu_torch.analysis.engine import (DEFAULT_BASELINE,
                                                      PACKAGE_DIR,
                                                      lint_paths)

    examples = os.path.join(PACKAGE_DIR, "examples")
    assert examples.startswith(PACKAGE_DIR + os.sep)  # inside the gate's walk
    result = lint_paths([examples], baseline_path=DEFAULT_BASELINE,
                        root=ROOT)
    assert result.files == 6 and not result.findings, result.findings
