"""Several processes and the (replicates x cells) mesh
(``parallel/multihost.py``), on the CPU.

The 2-D sweep is held to the JAX package's ``replicate_sweep_2d`` over the
same 2 x 4 layout of its 8 virtual devices, from JAX's inits, at ``rtol
1e-4`` (W and the objectives). ``_balanced_rc`` equals JAX's for every
device and process count. One test joins two processes with ``gloo`` and
solves row-sharded across them: the result equals one process over two
shards bit for bit (gloo adds two ranks as one process adds two shards);
its children run under a 120 s limit and are killed past it.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.parallel import multihost as jmh
from cnmf_torch_tpu_torch.parallel import multihost as tmh
from cnmf_torch_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _counts(n=202, g=120, k=4, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.dirichlet(np.ones(k) * 0.3, size=n)
    S = rng.gamma(0.3, 1.0, size=(k, g)) * 40.0 / g
    X = rng.poisson(U @ S).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    return X


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("n_proc", [1, 2, 4])
def test_balanced_rc_is_jax(n_dev, n_proc):
    assert tmh._balanced_rc(n_dev, n_proc) == jmh._balanced_rc(n_dev, n_proc)


def test_mesh_2d_lays_out_rows_a_process():
    m = tmh.mesh_2d(devices=["cpu"] * 8)
    assert m.axis_names == ("replicates", "cells")
    assert m.devices.shape == jmh.mesh_2d().devices.shape == (2, 4)
    # two processes of two entries each: one row a process; a mesh across
    # processes needs the process group first
    assert tmh._balanced_rc(4, 2) == (2, 2)
    with pytest.raises(RuntimeError, match="torch.distributed initialized"):
        tmh.mesh_2d(devices=["cpu"] * 4, owners=[0, 0, 1, 1])
    assert tmh.mesh_2d(replicate_shards=4, devices=["cpu"] * 8) \
        .devices.shape == (4, 2)
    with pytest.raises(ValueError, match="does not divide"):
        tmh.mesh_2d(replicate_shards=3, devices=["cpu"] * 8)


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_the_2d_sweep_matches_jax(beta_loss):
    X = _counts()
    seeds, k = [11, 12, 13], 4
    jmesh = jmh.mesh_2d()
    spectra_j, errs_j = jmh.replicate_sweep_2d(X, seeds, k, jmesh,
                                               beta_loss=beta_loss,
                                               n_passes=6)
    n, g = X.shape
    n_pad = n + (-n) % 4
    Xp = jnp.asarray(np.pad(X, ((0, n_pad - n), (0, 0))))
    pairs = [jnmf.random_init(jax.random.key(s), n_pad, g, k, jnp.mean(Xp))
             for s in seeds]
    inits = (np.stack([np.asarray(p[0]) for p in pairs]),
             np.stack([np.asarray(p[1]) for p in pairs]))
    spectra_t, errs_t = tmh.replicate_sweep_2d(
        X, seeds, k, tmh.mesh_2d(devices=["cpu"] * 8), beta_loss=beta_loss,
        n_passes=6, init_factors=inits)
    assert spectra_t.shape == (3, k, g)
    assert _rel(spectra_t, spectra_j) < 1e-4
    np.testing.assert_allclose(errs_t, np.asarray(errs_j), rtol=1e-4)


def test_the_2d_sweep_replicate_is_the_row_sharded_solve():
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    X = _counts(seed=1)
    spectra, errs = tmh.replicate_sweep_2d(
        X, [5, 6], 3, tmh.mesh_2d(devices=["cpu"] * 4), n_passes=5,
        beta_loss="kullback-leibler")
    for r, s in enumerate([5, 6]):
        _H, W, err = nmf_fit_rowsharded(
            X, 3, beta_loss="kullback-leibler", seed=s, n_passes=5,
            mesh=Mesh(["cpu"] * 2, ("cells",)))
        np.testing.assert_array_equal(spectra[r], W)
        assert np.float32(err) == errs[r]


def test_partial_coordinates_raise_and_none_is_one_process(monkeypatch):
    for name in ("CNMF_COORDINATOR_ADDRESS", "CNMF_NUM_PROCESSES",
                 "CNMF_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tmh.initialize_distributed() == (0, 1)
    with pytest.raises(RuntimeError, match="no CNMF_COORDINATOR_ADDRESS"):
        tmh.initialize_distributed(auto=True)
    monkeypatch.setenv("CNMF_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="needs all three coordinates"):
        tmh.initialize_distributed()
    assert tmh.is_coordinator()
    tmh.sync_hosts("alone")      # one process: a no-op


def test_local_devices_read_the_pod_simulation(monkeypatch):
    monkeypatch.setenv("CNMF_SIM_CPU_DEVICES", "3")
    assert tmh.local_devices("cpu") == [torch.device("cpu")] * 3
    # simulated CPU entries never stand in for cards
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="simulates CPU mesh entries"):
            tmh.local_devices(device)
    monkeypatch.delenv("CNMF_SIM_CPU_DEVICES")
    assert tmh.local_devices("cpu") == [torch.device("cpu")]


def test_a_wedged_barrier_times_out_and_names_itself():
    with pytest.warns(RuntimeWarning, match="abandoning wedged barrier"):
        with pytest.raises(tmh.HostBarrierTimeout, match="did not complete"):
            tmh._wait_with_timeout(lambda: time.sleep(5), 0.2, "wedge")
    tmh._wait_with_timeout(lambda: None, 1.0, "fine")
    with pytest.raises(KeyError):
        tmh._wait_with_timeout(lambda: {}["x"], 1.0, "raises")


_RANK = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from cnmf_torch_tpu_torch.parallel.mesh import Mesh, backend, global_devices
from cnmf_torch_tpu_torch.parallel.multihost import initialize_distributed
from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded
out, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
X = np.load(out + "/X.npy")
devices, owners = global_devices(["cpu"])
mesh = Mesh(devices, ("cells",), owners=owners)

class Rec:
    enabled = True
    def __init__(self):
        self.events = []
    def emit(self, t, **f):
        self.events.append(dict(f, t=t))
    def emit_stream(self, *a):
        pass

rec = Rec()
H, W, err = nmf_fit_rowsharded(X, 3, beta_loss="kullback-leibler", seed=4,
                               n_passes=5, mesh=mesh, events=rec)
np.save(f"{out}/W{rank}.npy", W)
np.save(f"{out}/H{rank}.npy", H)
json.dump({"err": err, "backend": backend(),
           "events": [e for e in rec.events if e["t"] == "collective"]},
          open(f"{out}/r{rank}.json", "w"))
"""


def test_two_processes_solve_across_a_gloo_group(tmp_path):
    from cnmf_torch_tpu_torch.launcher import _free_port
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    X = _counts(seed=2)
    np.save(tmp_path / "X.npy", X)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path),
                               str(r), port], env=env) for r in range(2)]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            assert time.monotonic() - t0 < 120, "ranks past 120 s"
            assert all(p.poll() in (None, 0) for p in procs), \
                [p.poll() for p in procs]
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0]
    H, W, err = nmf_fit_rowsharded(X, 3, beta_loss="kullback-leibler",
                                   seed=4, n_passes=5,
                                   mesh=Mesh(["cpu"] * 2, ("cells",)))
    for r in range(2):
        rec = json.loads((tmp_path / f"r{r}.json").read_text())
        assert rec["backend"] == "gloo"
        (ev,) = rec["events"]
        assert ev["context"]["processes"] == 2
        assert ev["context"]["all_reduces"] > 0 and ev["nbytes"] > 0
        np.testing.assert_array_equal(np.load(tmp_path / f"W{r}.npy"), W)
        np.testing.assert_array_equal(np.load(tmp_path / f"H{r}.npy"), H)
        assert rec["err"] == err
