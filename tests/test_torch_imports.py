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
                 "parallel/grid2d.py", "runtime/elastic.py", "launcher.py"]


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
                                                               tmp_path):
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
    # asking for the CPU is the only way to run without a card
    assert cNMF(output_dir=str(tmp_path), name="y",
                device="cpu").device.type == "cpu"
