"""The elastic layer (``runtime/elastic.py``, the ``hostloss`` fault) and
the degraded re-mesh of factorize, on the CPU.

The pure parts are held to the JAX package's: the heartbeat's files and
diagnosis text, the loss classifier, the lost-device resolution and
``plan_degraded_mesh``'s shapes for the 1-D mesh, the (replicates x cells)
mesh and the grid. A ``hostloss`` fault on the row-sharded, grid and 2-D
factorize paths re-plans the mesh over the survivors (``fault`` events
``host_loss`` and ``remesh``); a loss at the replicate boundary resumes
from the final pass checkpoint and writes the clean run's spectra bit for
bit, a loss mid-replicate finishes within ``5e-2`` of them (the remaining
passes run on fewer shards); the 2-D sweep reruns the K on the re-planned
mesh, bit for bit a clean run on that mesh.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cnmf_torch_tpu.runtime import elastic as jel
from cnmf_torch_tpu.runtime import faults as jfaults
from cnmf_torch_tpu_torch import Frame, cNMF, load_df_from_npz, \
    save_df_to_npz
from cnmf_torch_tpu_torch.parallel import grid2d as tgrid
from cnmf_torch_tpu_torch.parallel import multihost as tmh
from cnmf_torch_tpu_torch.parallel.mesh import Mesh
from cnmf_torch_tpu_torch.runtime import elastic as tel
from cnmf_torch_tpu_torch.runtime import faults as tfaults
from cnmf_torch_tpu_torch.utils import telemetry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


# ---------------------------------------------------------------------------
# the pure parts against JAX
# ---------------------------------------------------------------------------

def test_the_heartbeat_files_and_diagnosis_are_jax(tmp_path):
    hb = tel.Heartbeat(tmp_path, "run", 0, interval_s=0.05)
    assert hb.beat(phase="pass", cursor=3, force=True)
    assert not hb.beat(phase="pass", cursor=4)      # throttled
    rec = tel.Heartbeat.read(hb.path)
    assert (rec["index"], rec["phase"], rec["cursor"]) == (0, "pass", 3)
    jhb = jel.Heartbeat(tmp_path, "run", 1, interval_s=0.05)
    assert jhb.path == hb.path_for(1)
    culprits = hb.culprits(3)
    assert [c["index"] for c in culprits] == [1, 2]
    assert all(c["age_s"] is None for c in culprits)
    assert tel.Heartbeat.describe(culprits) == \
        jel.Heartbeat.describe(culprits)
    assert tel.Heartbeat.describe([]) == jel.Heartbeat.describe([])
    off = tel.Heartbeat(tmp_path, "off", 0, interval_s=0)
    assert not off.enabled and not off.beat(force=True)


@pytest.mark.parametrize("exc", [
    RuntimeError("peer closed the socket"), RuntimeError("Device halted"),
    RuntimeError("numerics"), OSError("connection reset by peer"),
    ValueError("socket closed")])
def test_is_device_loss_is_jax(exc):
    assert tel.is_device_loss(exc) == jel.is_device_loss(exc)
    assert tel.is_device_loss(tfaults.HostLossError("x"))


@pytest.mark.parametrize("lost,count", [((), 1), ((), 2), ((1, 3), 1),
                                        ((), 9)])
def test_lost_entries_resolve_as_in_jax(lost, count):
    jmesh = JMesh(np.asarray(jax.devices()[:4]), ("cells",))
    want = [int(d.id) for d in jel.resolve_lost_devices(
        jfaults.HostLossError("x", lost=lost, count=count), jmesh)]
    got = tel.resolve_lost_devices(
        tfaults.HostLossError("x", lost=lost, count=count),
        Mesh(["cpu"] * 4, ("cells",)))
    assert got == want


@pytest.mark.parametrize("n,lost", [(8, 1), (8, 2), (8, 3), (6, 2)])
def test_the_degraded_plans_are_jax(n, lost, monkeypatch):
    monkeypatch.delenv("CNMF_TPU_GRID_SHAPE", raising=False)
    devs = jax.devices()[:n]
    dead = devs[-lost:]
    cases = [
        (JMesh(np.asarray(devs), ("cells",)),
         Mesh(["cpu"] * n, ("cells",))),
        (jax_mesh_2d(devs), tmh.mesh_2d(devices=["cpu"] * n)),
        (jax_grid(devs), tgrid.mesh_grid2d(devices=["cpu"] * n))]
    for jm, tm in cases:
        want = jel.plan_degraded_mesh(jm, dead)
        got = tel.plan_degraded_mesh(tm, list(range(n - lost, n)))
        assert got.axis_names == tuple(want.axis_names)
        assert got.devices.shape == want.devices.shape


def jax_mesh_2d(devs):
    from cnmf_torch_tpu.parallel.multihost import mesh_2d

    return mesh_2d(devices=devs)


def jax_grid(devs):
    from cnmf_torch_tpu.parallel.grid2d import mesh_grid2d

    return mesh_grid2d(devices=devs)


def test_the_floor_refuses_a_mesh_too_small(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_MIN_DEVICES", "3")
    with pytest.raises(tel.DegradedMeshError, match="below the"):
        tel.plan_degraded_mesh(Mesh(["cpu"] * 3, ("cells",)), [2])
    monkeypatch.delenv("CNMF_TPU_MIN_DEVICES")
    assert tel.min_surviving_devices() == 1
    assert tel.elastic_enabled() and tel.heartbeat_s() == 0.0
    assert tel.straggler_deadline_s() == 0.0


def test_the_layers_knobs_carry_the_jax_text():
    from cnmf_torch_tpu.utils import envknobs as jknobs
    from cnmf_torch_tpu_torch.utils import envknobs as tknobs

    jax_text = {name: kb.doc for name, kb in jknobs.REGISTRY.items()}
    names = ("CNMF_TPU_GRID_OVERLAP", "CNMF_TPU_GRID_BLOCKS",
             "CNMF_TPU_GRID_SHAPE", "CNMF_TPU_BARRIER_TIMEOUT_S",
             "CNMF_TPU_WORKER_TIMEOUT", "CNMF_TPU_WORKER_RESPAWNS",
             "CNMF_TPU_WORKER_BACKOFF_S", "CNMF_TPU_ELASTIC",
             "CNMF_TPU_HEARTBEAT_S", "CNMF_TPU_STRAGGLER_S",
             "CNMF_TPU_MIN_DEVICES", "CNMF_COORDINATOR_ADDRESS",
             "CNMF_NUM_PROCESSES", "CNMF_PROCESS_ID",
             "CNMF_SIM_CPU_DEVICES")
    for name in names:
        assert tknobs.KNOBS[name] == jax_text[name], name


def test_maybe_hostloss_fires_once_after_its_skips(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "hostloss:context=pass,after=2,devices=1+3")
    tfaults.maybe_hostloss(context="replicate")   # another site
    tfaults.maybe_hostloss(context="pass")
    tfaults.maybe_hostloss(context="pass")
    with pytest.raises(tfaults.HostLossError) as got:
        tfaults.maybe_hostloss(context="pass")
    assert got.value.lost == (1, 3)
    tfaults.maybe_hostloss(context="pass")        # limit 1


# ---------------------------------------------------------------------------
# the re-mesh on factorize's paths
# ---------------------------------------------------------------------------

def _run(tmp_path, name):
    rng = np.random.default_rng(1)
    X = rng.poisson(rng.gamma(0.5, 1.0, (240, 1))
                    * rng.gamma(0.5, 1.0, (1, 300)) * 4.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    fn = str(tmp_path / "c.df.npz")
    if not os.path.exists(fn):
        save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(240)]),
                             np.asarray([f"g{j}" for j in range(300)])), fn)
    obj = cNMF(str(tmp_path), name, device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=4,
                num_highvar_genes=150, beta_loss="kullback-leibler")
    return obj


def _spectra(obj):
    return [load_df_from_npz(obj.paths["iter_spectra"] % (3, i)).values
            for i in range(2)]


def _faults(obj):
    return [e for e in telemetry.read_events(obj._events.path)
            if e["t"] == "fault"]


@pytest.mark.parametrize("context", ["pass", "replicate"])
def test_a_host_loss_remeshes_the_row_sharded_factorize(tmp_path,
                                                        monkeypatch,
                                                        context):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    clean = _run(tmp_path, "clean")
    clean.factorize(rowshard=True, mesh=Mesh(["cpu"] * 4, ("cells",)))
    lossy = _run(tmp_path, "lossy" + context)
    spec = f"hostloss:context={context},after=1"
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC", spec)
    with pytest.warns(RuntimeWarning, match="continuing degraded"):
        lossy.factorize(rowshard=True, mesh=Mesh(["cpu"] * 4, ("cells",)))
    events = _faults(lossy)
    kinds = [e["kind"] for e in events]
    assert "host_loss" in kinds
    (remesh,) = [e["context"] for e in events if e["kind"] == "remesh"]
    assert (remesh["from_devices"], remesh["to_devices"]) == (4, 3)
    assert lossy.factorize_info["mesh_devices_final"] == 3
    for a, b in zip(_spectra(lossy), _spectra(clean)):
        if context == "replicate":
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() / np.abs(b).max() < 5e-2


def test_a_host_loss_remeshes_the_grid_factorize(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    # a distinct spec string: a parsed spec's counters live for the process
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "hostloss:context=pass,after=1,count=1")
    obj = _run(tmp_path, "grid")
    with pytest.warns(RuntimeWarning, match="continuing degraded"):
        obj.factorize(mesh=tgrid.mesh_grid2d(2, 2, devices=["cpu"] * 4))
    (remesh,) = [e["context"] for e in _faults(obj)
                 if e["kind"] == "remesh"]
    assert remesh["context"] == "grid2d"
    assert (remesh["from_devices"], remesh["to_devices"]) == (4, 3)
    assert all(np.isfinite(W).all() and (W >= 0).all()
               for W in _spectra(obj))


def test_a_host_loss_reruns_the_2d_sweep(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    # the rerun's sweep runs whole on the re-planned 1 x 3 mesh
    clean = _run(tmp_path, "clean2d")
    clean.factorize(mesh=tmh.mesh_2d(devices=["cpu"] * 3))
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC", "hostloss:context=sweep2d")
    obj = _run(tmp_path, "lossy2d")
    with pytest.warns(RuntimeWarning, match="re-planned"):
        obj.factorize(mesh=tmh.mesh_2d(devices=["cpu"] * 4))
    kinds = [e["kind"] for e in _faults(obj)]
    assert kinds.count("host_loss") == 1 and kinds.count("remesh") == 1
    for a, b in zip(_spectra(obj), _spectra(clean)):
        np.testing.assert_array_equal(a, b)


def test_elastic_off_aborts_on_a_loss(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ELASTIC", "0")
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "hostloss:context=pass,after=1,limit=1")
    obj = _run(tmp_path, "off")
    with pytest.raises(tfaults.HostLossError):
        obj.factorize(rowshard=True, mesh=Mesh(["cpu"] * 2, ("cells",)))


def test_factorize_stamps_heartbeats(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_HEARTBEAT_S", "0.01")
    obj = _run(tmp_path, "hb")
    t0 = time.time()
    obj.factorize(rowshard=True, mesh=Mesh(["cpu"] * 2, ("cells",)))
    rec = tel.Heartbeat.read(os.path.join(
        os.path.dirname(obj.paths["resilience_ledger"]),
        "hb.heartbeat.0.json"))
    assert rec is not None and rec["ts"] >= t0
