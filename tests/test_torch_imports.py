"""The port stands alone: no JAX, no JAX package, none of the host
libraries the GPU machine lacks (pandas, h5py, PyYAML, matplotlib,
scikit-learn), and no silent CPU run when no card is present."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cnmf_torch_tpu_torch import cNMF
from cnmf_torch_tpu_torch.cli import main as cli_main
from cnmf_torch_tpu_torch.ops import nmf as tnmf
from cnmf_torch_tpu_torch.parallel import replicate_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cnmf_torch_tpu_torch")
BLOCKED = ("jax", "jaxlib", "cnmf_torch_tpu", "pandas", "h5py", "yaml",
           "matplotlib", "sklearn")

_TINY_PIPELINE = r"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import os, tempfile
# the telemetry base runs too: events, metrics, spans
for knob in ("CNMF_TPU_TELEMETRY", "CNMF_TPU_METRICS",
             "CNMF_TPU_TRACE_SAMPLE"):
    os.environ[knob] = "1"
import numpy as np
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

rng = np.random.default_rng(0)
usage = rng.dirichlet(np.ones(4) * 0.3, size=60)
spectra = rng.gamma(0.3, 1.0, size=(4, 90)) * 50.0 / 90
counts = rng.poisson(usage @ spectra * 250.0).astype(np.float64)
counts[counts.sum(axis=1) == 0, 0] = 1.0
d = tempfile.mkdtemp()
fn = os.path.join(d, "counts.df.npz")
save_df_to_npz(Frame(counts, np.array(["c%d" % i for i in range(60)]),
                     np.array(["g%d" % j for j in range(90)])), fn)
obj = cNMF(d, "tiny", device="cpu")
obj.prepare(fn, components=[3], n_iter=4, seed=1, num_highvar_genes=40,
            beta_loss="kullback-leibler", batch_size=32, max_NMF_iter=50)
obj.factorize()
obj.factorize(skip_completed_runs=True)
obj.factorize(batched=False)
# the multi-device layer on meshes of CPU entries
from cnmf_torch_tpu_torch import launcher
from cnmf_torch_tpu_torch.parallel.grid2d import mesh_grid2d
from cnmf_torch_tpu_torch.parallel.mesh import Mesh
from cnmf_torch_tpu_torch.parallel.multihost import mesh_2d
from cnmf_torch_tpu_torch.runtime import elastic
obj.factorize(rowshard=True, mesh=Mesh(["cpu"] * 2, ("cells",)))
obj.factorize(mesh=mesh_2d(devices=["cpu"] * 4))
obj.factorize(mesh=mesh_grid2d(2, 2, devices=["cpu"] * 4))
assert obj.factorize_info["mode"] == "grid2d"
from cnmf_torch_tpu_torch.runtime import faults, resilience
from cnmf_torch_tpu_torch.ops import sketch
assert resilience.derive_retry_seed(5, 1) == 4
assert faults.parse_fault_spec("nonfinite:k=3")[0].params == {{"k": 3}}
obj.combine()
obj.consensus(3, density_threshold=2.0)
stats = obj.k_selection_stats()
assert np.isfinite(stats.values).all()
obj.k_selection_plot()
# the atlas path: the row-sharded solver and the shard store
os.environ["CNMF_TPU_OOC"] = "1"
atlas = cNMF(d, "atlas", device="cpu", rowshard_threshold=50)
atlas.prepare(fn, components=[3], n_iter=4, seed=1, num_highvar_genes=40,
              beta_loss="kullback-leibler", batch_size=32, max_NMF_iter=50)
atlas.factorize()
assert atlas.factorize_info["mode"] == "rowshard"
atlas.combine()
atlas.consensus(3, density_threshold=2.0)
atlas.k_selection_plot()
# the remote object store, and the cost model's events
from cnmf_torch_tpu_torch.utils.netstore import ObjectStoreServer
os.environ["CNMF_TPU_PERF_MODEL"] = "1"
with ObjectStoreServer() as srv:
    os.environ["CNMF_TPU_STORE_URI"] = srv.url + "/p"
    remote = cNMF(d, "remote", device="cpu", rowshard_threshold=50)
    remote.prepare(fn, components=[3], n_iter=4, seed=1,
                   num_highvar_genes=40, beta_loss="kullback-leibler",
                   batch_size=32, max_NMF_iter=50)
    remote.factorize()
    remote.combine()
    remote.consensus(3, density_threshold=2.0)
    assert remote._probe_store().backend.kind == "remote"
del os.environ["CNMF_TPU_STORE_URI"], os.environ["CNMF_TPU_OOC"]
from cnmf_torch_tpu_torch.obs import regress
snap = regress.build_snapshot(dict(kl=dict(wall_seconds=1.0)),
                              fingerprint="f", created=0.0)
regress.save_snapshot(snap, os.path.join(d, "snap.json"))
from cnmf_torch_tpu_torch.cli import main
from cnmf_torch_tpu_torch.utils.telemetry import validate_events_file
assert validate_events_file(os.path.join(d, "tiny", "cnmf_tmp",
                                         "tiny.events.jsonl")) > 10
main(["report", os.path.join(d, "tiny")])
main(["trace", os.path.join(d, "tiny")])
main(["report", os.path.join(d, "remote")])
try:
    main(["benchdiff", os.path.join(d, "snap.json"),
          os.path.join(d, "snap.json")])
except SystemExit as exc:
    assert exc.code == 0
# the serving tier: the daemon over the tiny run's reference, the ring
from cnmf_torch_tpu_torch.serving import (ProjectionService, ServeClient,
                                          ServeDaemon, load_reference)
from cnmf_torch_tpu_torch.serving.fleet import FleetRouter, HashRing
ref = load_reference(os.path.join(d, "tiny"), k=3)
svc = ProjectionService(ref, device="cpu", warm_start=False)
sock = os.path.join(d, "serve.sock")
daemon = ServeDaemon(svc, socket_path=sock).start()
H, meta = ServeClient(socket_path=sock, timeout=60).project(
    np.ones((5, ref.n_genes), np.float32))
assert H.shape == (5, 3) and np.isfinite(H).all()
daemon.close()
assert HashRing([0, 1]).route("t") in (0, 1)
# 10x .mtx input through the native reader, the planner's CLI, and an
# h5ad read that names the missing h5py
import gzip, scipy.io, scipy.sparse
from cnmf_torch_tpu_torch.native import native_available
from cnmf_torch_tpu_torch.utils.io import load_counts
tenx = os.path.join(d, "tenx")
os.makedirs(tenx)
scipy.io.mmwrite(os.path.join(tenx, "matrix.mtx"),
                 scipy.sparse.coo_matrix(counts.T), field="integer")
with open(os.path.join(tenx, "genes.tsv"), "w") as f:
    f.write("".join("id%d\tg%d\n" % (j, j) for j in range(90)))
with gzip.open(os.path.join(tenx, "barcodes.tsv.gz"), "wt") as f:
    f.write("".join("c%d\n" % i for i in range(60)))
assert native_available()
c10x = load_counts(os.path.join(tenx, "matrix.mtx"))
assert np.array_equal(c10x.X.toarray(), counts)
main(["plan", os.path.join(d, "tiny"), "--out", os.path.join(d, "p.json")])
try:
    load_counts(os.path.join(d, "x.h5ad"))
    raise AssertionError("an h5ad read without h5py")
except ImportError as exc:
    assert "h5py" in str(exc)
# the preprocess sidecar: seurat_v3, PCA, Harmony and the MI ranking; the
# figures skipped with a warning, the .h5ad write naming the missing h5py
import warnings
from scipy import sparse as _sparse
from cnmf_torch_tpu_torch import Preprocess
from cnmf_torch_tpu_torch.utils.io import Counts
pp = Preprocess(0, plot_dir=d, device="cpu")
raw = Counts(_sparse.csr_matrix(counts),
             np.array(["c%d" % i for i in range(60)]),
             np.array(["g%d" % j for j in range(90)]),
             obs={{"batch": np.array(["a", "b", "c"] * 20, dtype=object)}})
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    filt = pp.filter_adata(raw, min_cells_per_gene=1, min_counts_per_cell=1,
                           makeplots=True)
assert any("log10_n_counts.png" in str(w.message) for w in caught)
rna, tp10k, hvgs = pp.preprocess_for_cnmf(filt, harmony_vars="batch",
                                          n_top_rna_genes=40,
                                          max_iter_harmony=2)
assert rna.X.shape == (filt.shape[0], 40) and (rna.X >= 0).all()
picked = pp.select_features_MI(filt, np.array([0, 1, 2] * 20),
                               n_top_features=5)
assert picked.var["highly_variable"].sum() == 5
try:
    pp.preprocess_for_cnmf(filt, n_top_rna_genes=40,
                           save_output_base=os.path.join(d, "pp"))
    raise AssertionError("an h5ad write without h5py")
except ImportError as exc:
    assert "h5py" in str(exc)
# lint and the sanitizer: the gate passes, the knob table prints, and a
# guard on the CPU guards nothing
from cnmf_torch_tpu_torch.analysis.gate import main as gate_main
from cnmf_torch_tpu_torch.utils.sanitize import host_read, sync_guard
assert gate_main() == 0
try:
    main(["lint", "--knob-table"])
except SystemExit as exc:
    assert exc.code == 0
with sync_guard("cpu") as guard:
    with host_read():
        pass
assert not guard.active and guard.reads == 0
# the tutorials: all four import, the Seurat vignette runs, and a counts
# file meant as h5ad lands as the 10x trio the port reads natively
from cnmf_torch_tpu_torch.examples import (_common, batch_correction_tutorial,
                                           pbmc_tutorial, seurat_vignette,
                                           simulated_tutorial)
r_path = seurat_vignette.main(os.path.join(d, "seurat"), n_cells=60,
                              n_genes=90, n_iter=4, k=3, device="cpu")
assert os.path.exists(r_path)
mtx = _common.write_counts(os.path.join(d, "pbmc.h5ad"), Counts(
    _sparse.csr_matrix(counts), np.array(["c%d" % i for i in range(60)]),
    np.array(["g%d" % j for j in range(90)])))
assert mtx.endswith(os.path.join("pbmc_10x", "matrix.mtx"))
assert np.array_equal(load_counts(mtx).X.toarray(), counts)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each (one spinning thread per core) would oversubscribe
    the cores and slow every worker."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)



def test_port_runs_with_jax_and_host_libraries_blocked(tmp_path):
    """In a subprocess, because tests/conftest.py imports JAX into this
    one."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_PIPELINE.format(blocked=BLOCKED)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "multicard_check.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


# the modules each slice added, which the walk above must reach
SLICE_MODULES = ["runtime/__init__.py", "runtime/faults.py",
                 "runtime/resilience.py", "ops/sketch.py",
                 "utils/telemetry.py", "utils/profiling.py",
                 "obs/__init__.py", "obs/metrics.py", "obs/tracing.py",
                 "obs/slo.py", "utils/storebackend.py",
                 "utils/shardstore.py", "runtime/checkpoint.py",
                 "parallel/streaming.py", "parallel/rowshard.py",
                 "utils/netstore.py", "obs/costmodel.py", "obs/regress.py",
                 "parallel/mesh.py", "parallel/multihost.py",
                 "parallel/grid2d.py", "runtime/elastic.py", "launcher.py",
                 "serving/__init__.py", "serving/reference.py",
                 "serving/batcher.py", "serving/daemon.py",
                 "serving/fleet.py", "native/__init__.py",
                 "utils/anndata_lite.py", "utils/autotune.py",
                 "runtime/planner.py", "models/plots.py",
                 "models/preprocess.py", "ops/harmony.py", "ops/pca.py",
                 "ops/seurat_v3.py", "ops/mutual_info.py",
                 "analysis/__init__.py", "analysis/engine.py",
                 "analysis/gate.py", "analysis/rules_artifacts.py",
                 "analysis/rules_concurrency.py", "analysis/rules_knobs.py",
                 "analysis/rules_sync.py", "analysis/rules_telemetry.py",
                 "utils/sanitize.py", "examples/__init__.py",
                 "examples/_common.py", "examples/simulated_tutorial.py",
                 "examples/pbmc_tutorial.py",
                 "examples/batch_correction_tutorial.py",
                 "examples/seurat_vignette.py"]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_the_slice_modules_are_checked(rel):
    path = os.path.join(PORT, rel)
    assert path in _sources()
    assert not _imported_roots(path) & set(BLOCKED), _imported_roots(path)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "cnmf_torch_tpu"}, roots


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card,
                                                               tmp_path,
                                                               monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cNMF(output_dir=str(tmp_path), name="x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnmf.fit_h(np.ones((4, 3), np.float32), np.ones((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replicate_sweep(np.ones((4, 3), np.float32), [1], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replicate_sweep(np.ones((4, 3), np.float32), [1], 2, mode="batch",
                        beta_loss="kullback-leibler")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnmf.run_nmf(np.ones((4, 3), np.float32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["combine", "--output-dir", str(tmp_path)])
    from cnmf_torch_tpu_torch.serving import (ProjectionService,
                                              ResidentReference,
                                              fleet_forever, serve_forever)

    ref = ResidentReference(np.ones((2, 3), np.float32), beta=2.0,
                            chunk_size=8, chunk_max_iter=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ref.stage()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProjectionService(ref).start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_forever(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_forever(str(tmp_path))
    from cnmf_torch_tpu_torch import Preprocess
    from cnmf_torch_tpu_torch.ops import (moe_correct_ridge, pca,
                                          run_harmony, seurat_v3_hvg)
    from cnmf_torch_tpu_torch.ops.mutual_info import mutual_info_classif

    X = np.ones((6, 4), np.float32)
    for call in (Preprocess, lambda: pca(X, 2), lambda: seurat_v3_hvg(X, 2),
                 lambda: run_harmony(X, {"b": np.arange(6) % 2}, "b"),
                 lambda: moe_correct_ridge(X.T, np.ones((1, 6)),
                                           np.ones((2, 6)), [0.0, 1.0]),
                 lambda: mutual_info_classif(X, np.arange(6) % 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the sanitizer's guard and the autotuner's measurements (F7)
    from cnmf_torch_tpu_torch.utils import autotune
    from cnmf_torch_tpu_torch.utils.sanitize import sync_guard

    monkeypatch.setattr(autotune, "_active_device", None)
    for call in (autotune.measure_rho_scales, autotune.measure_plan_points,
                 lambda: sync_guard().__enter__()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU is the only way to run without a card
    assert cNMF(output_dir=str(tmp_path), name="y",
                device="cpu").device.type == "cpu"
    with sync_guard("cpu") as guard:
        assert not guard.active
