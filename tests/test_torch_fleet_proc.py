"""The serving tier as real processes on the CPU: ``python -m
cnmf_torch_tpu_torch serve`` and ``... fleet --device cpu`` over a
port-built consensus run.

* a ``serve`` daemon answers the JAX wire format within ``rtol 1e-5`` of
  the port's solo ``fit_h``, a SIGKILLed daemon's stale socket is replaced
  by the next one, and SIGTERM removes the socket;
* a ``fleet`` of two replicas under load from four tenants loses one
  replica to a ``replicadeath`` clause: no request fails, every reply
  matches solo, the fleet's events record the death and the failover, the
  slot respawns, and a clean shutdown leaves no replica process alive.

These tests live in a file of their own so a distributed run gives them
their own worker. Each has its own deadline of 60 s for every wait.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cnmf_torch_tpu_torch.ops.nmf import fit_h
from cnmf_torch_tpu_torch.serving import ServeClient, load_reference
from cnmf_torch_tpu_torch.serving.fleet import FleetClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
DEADLINE_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A consensus-complete port run (KL, k=3) with 128-row chunks, so a
    replica warms eight small buckets."""
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

    tmp = str(tmp_path_factory.mktemp("fleet_run"))
    rng = np.random.default_rng(7)
    usage = rng.dirichlet(np.ones(4) * 0.3, size=300)
    spectra = rng.gamma(0.3, 1.0, size=(4, 800)) * 40.0 / 80
    counts = rng.poisson(usage @ spectra * 25.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.array([f"c{i}" for i in range(300)]),
                         np.array([f"g{j}" for j in range(800)])), fn)
    obj = cNMF(tmp, "fl", device="cpu")
    obj.prepare(fn, components=[3], n_iter=6, seed=3,
                num_highvar_genes=100, beta_loss="kullback-leibler",
                max_NMF_iter=100, batch_size=128)
    obj.factorize()
    obj.combine()
    obj.consensus(3, density_threshold=2.0, show_clustering=False)
    return os.path.join(tmp, "fl")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(OMP_NUM_THREADS="1", CNMF_TPU_SERVE_BUCKETS="64")
    env.update(extra)
    return env


def _spawn(args, env, log):
    return subprocess.Popen(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", *args],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def _wait_healthy(cli, proc, deadline):
    while True:
        assert proc.poll() is None, "the process exited while warming"
        try:
            return cli.healthz()
        except (OSError, ValueError):
            pass
        assert time.monotonic() < deadline, "never became healthy"
        time.sleep(0.1)


def _stop(proc, sig=signal.SIGTERM):
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        return proc.wait(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError("the process outlived its deadline")


def _solo(ref, X):
    return fit_h(X, ref.W, chunk_size=ref.chunk_size,
                 chunk_max_iter=ref.chunk_max_iter, h_tol=ref.h_tol,
                 l1_reg_H=ref.l1_H, beta=ref.beta, device="cpu")


def _queries(ref, n_queries, seed):
    rng = np.random.default_rng(seed)
    return [rng.gamma(1.0, 1.0, size=(int(rng.integers(5, 200)),
                                      ref.n_genes)).astype(np.float32)
            for _ in range(n_queries)]


def _children(pid) -> list:
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().split(")")[-1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(")")[-1].split()[0] != "Z"


def test_serve_subprocess_sigkill_then_restart(run_dir, tmp_path):
    ref = load_reference(run_dir)
    sock = str(tmp_path / "s.sock")
    X = _queries(ref, 1, 1)[0]
    want = _solo(ref, X)
    log = open(tmp_path / "serve.log", "wb")
    first = _spawn(["serve", run_dir, "--socket", sock, "--device", "cpu"],
                   _env(), log)
    try:
        deadline = time.monotonic() + DEADLINE_S
        cli = ServeClient(socket_path=sock, timeout=DEADLINE_S)
        hz = _wait_healthy(cli, first, deadline)
        assert hz["reference"]["device"] == "cpu"
        H, _ = cli.project(X, tenant="a")
        np.testing.assert_allclose(H, want, rtol=RTOL, atol=ATOL)
        _stop(first, signal.SIGKILL)
        assert os.path.exists(sock)  # a SIGKILL leaves the file behind
        second = _spawn(["serve", run_dir, "--socket", sock, "--device",
                         "cpu"], _env(), log)
        try:
            _wait_healthy(cli, second, time.monotonic() + DEADLINE_S)
            H2, _ = cli.project(X, tenant="b", encoding="data")
            np.testing.assert_allclose(H2, want, rtol=RTOL, atol=ATOL)
            assert _stop(second) == 0
        finally:
            if second.poll() is None:
                _stop(second, signal.SIGKILL)
        assert not os.path.exists(sock)
    finally:
        if first.poll() is None:
            _stop(first, signal.SIGKILL)
        log.close()


def test_fleet_subprocess_survives_a_replica_death(run_dir, tmp_path):
    ref = load_reference(run_dir)
    sock = str(tmp_path / "f.sock")
    # warm starts off: a tenant repeats its matrices, and every reply is
    # held to the cold solo refit
    env = _env(CNMF_TPU_TELEMETRY="1", CNMF_TPU_FLEET_HEALTH_S="0.2",
               CNMF_TPU_SERVE_WARM_START="0",
               CNMF_TPU_WORKER_BACKOFF_S="0.1",
               CNMF_TPU_FAULT_SPEC="replicadeath:context=fleet,worker=0,"
                                   "after=10")
    log = open(tmp_path / "fleet.log", "wb")
    proc = _spawn(["fleet", run_dir, "--replicas", "2", "--socket", sock,
                   "--device", "cpu"], env, log)
    pids = set()
    try:
        deadline = time.monotonic() + DEADLINE_S
        cli = FleetClient(socket_path=sock, timeout=DEADLINE_S)
        hz = _wait_healthy(cli, proc, deadline)
        assert hz["replicas_up"] == 2
        pids |= {r["pid"] for r in cli.stats()["replicas"]}
        queries = _queries(ref, 24, 2)
        wants = [_solo(ref, X) for X in queries]
        errors, served = [], []
        stop = threading.Event()

        def tenant_loop(t):
            c = FleetClient(socket_path=sock, timeout=DEADLINE_S)
            i = t
            while not stop.is_set():
                j = i % len(queries)
                try:
                    H, meta = c.project(queries[j], tenant=f"tenant-{t}")
                    np.testing.assert_allclose(H, wants[j], rtol=RTOL,
                                               atol=ATOL)
                    served.append(meta.get("generation"))
                except Exception as exc:  # the failure mode under test
                    errors.append(repr(exc))
                i += 4

        threads = [threading.Thread(target=tenant_loop, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        respawned = False
        try:
            while time.monotonic() < deadline:
                st = cli.stats()
                pids |= {r["pid"] for r in st["replicas"]
                         if r["pid"] is not None}
                if (st["replica_deaths"] >= 1 and st["replicas_up"] == 2
                        and all(r["in_ring"] for r in st["replicas"])):
                    respawned = True
                    break
                time.sleep(0.1)
            time.sleep(0.5)  # traffic on the respawned fleet
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=DEADLINE_S)
                assert not t.is_alive(), "a client passed its deadline"
        assert respawned, "the dead replica never came back"
        assert not errors, errors[:3]
        assert len(served) > 8 and set(served) == {0}
        assert st["failovers"] >= 1 and st["error"] == 0
        assert cli.shutdown()
        assert _stop(proc) == 0
    finally:
        # on any path: SIGTERM (the router drains its replicas), then
        # SIGKILL whatever is left, so a failure leaves no process behind
        if proc.poll() is None:
            pids.update(_children(proc.pid))
            try:
                _stop(proc)
            except AssertionError:
                pass
        log.close()
        alive = [pid for pid in pids if _alive(pid)]
        for pid in alive:
            os.kill(pid, signal.SIGKILL)
    assert not os.path.exists(sock)
    assert not alive, f"replicas {alive} outlived the fleet"
    name = os.path.basename(run_dir)
    ev_path = os.path.join(run_dir, "cnmf_tmp", f"{name}.fleet.events.jsonl")
    from cnmf_torch_tpu_torch.utils.telemetry import (read_events,
                                                      validate_events_file)

    assert validate_events_file(ev_path) > 0
    evs = read_events(ev_path)
    deaths = [e for e in evs if e["t"] == "replica_death"]
    assert deaths and deaths[0]["reason"] == "exit"
    assert deaths[0]["replica"] == 0 and deaths[0]["since_kill_s"] >= 0
    assert [e for e in evs if e["t"] == "failover"]
    oks = [e for e in evs if e["t"] == "serve_request"
           and e["status"] == "ok"]
    assert {e["replica"] for e in oks} == {0, 1}
    leftovers = [f for f in os.listdir(os.path.join(run_dir, "cnmf_tmp"))
                 if f.endswith(".sock")]
    assert not leftovers, leftovers
    assert json.dumps(deaths[0])
