"""``chip_smoke.py``'s child processes on the CPU: nothing it starts
outlives it.

The smoke runs chains of child processes in threads beside 9a's stages
(:class:`chip_smoke.Beside`) and starts every child as the leader of a
process group of its own (:class:`chip_smoke.Children`). Whatever ends
the smoke early, :func:`chip_smoke.stopping_children` kills every
process of those groups, a child's own children too (a fleet's
replicas), and joins the chains' threads. A rehearsal: a real ``fleet``
with two replicas on the CPU runs as a chain while the main thread
fails, as a failed check of 9a's would; a SIGTERM to the script ends
it the same way. The scheduler runs at most its number of chains at
once, in the order given, and a chain's error is raised where its phase
reads it, naming the phase.
"""

import importlib.util
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60.0


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def children(smoke, monkeypatch):
    """A registry of this test's own, and its stop at the end."""
    reg = smoke.Children()
    monkeypatch.setattr(smoke, "CHILDREN", reg)
    yield reg
    reg.stop(timeout=10)


def _alive(pid) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def _wait_for(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"no {what} in {DEADLINE_S} s"
        time.sleep(0.05)


# a parent that starts two children in its own group (as ``fleet`` starts
# its replicas), writes the three pids and waits for a shutdown
TREE = textwrap.dedent("""
    import subprocess, sys, time
    kids = [subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
            for _ in range(2)]
    with open(sys.argv[1] + ".tmp", "w") as f:
        f.write(" ".join(str(p) for p in [0] + [k.pid for k in kids]))
    import os
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
    time.sleep(600)
""")


def _tree_pids(path, leader) -> list:
    _wait_for(lambda: os.path.exists(path), "pid file")
    with open(path) as f:
        pids = [int(p) for p in f.read().split()]
    return [leader] + pids[1:]


def test_a_failure_beside_the_chains_kills_every_tree(smoke, children,
                                                      tmp_path):
    pid_files = [str(tmp_path / f"tree{i}") for i in range(2)]
    leaders = {}

    def chain(i):
        def run():
            proc = smoke.CHILDREN.popen([sys.executable, "-c", TREE,
                                         pid_files[i]])
            leaders[i] = proc.pid
            proc.wait()     # as a chain waits on its child
        return run

    def lone():
        smoke.CHILDREN.run([sys.executable, "-c",
                            "import time; time.sleep(600)"], 600)

    def body():
        smoke.Beside({"17": chain(0), "12c": chain(1), "9c": lone},
                     workers=3)
        _wait_for(lambda: all(os.path.exists(p) for p in pid_files),
                  "trees")
        raise RuntimeError("a failed check of 9a")

    with pytest.raises(RuntimeError, match="9a"):
        smoke.stopping_children(body)
    pids = [p for i in range(2) for p in _tree_pids(pid_files[i],
                                                    leaders[i])]
    pids += [p.pid for p in children.procs]
    assert len(set(pids)) == 7
    _wait_for(lambda: not any(_alive(p) for p in pids), "clean stop")
    assert not any(t.is_alive() for t in children.threads)


def test_an_orphaned_grandchild_is_reached_through_its_group(smoke,
                                                              children,
                                                              tmp_path):
    """The leader exits and leaves its children behind (a fleet that
    crashed): they are still in its group, and the stop kills them."""
    path = str(tmp_path / "tree")
    proc = children.popen([sys.executable, "-c",
                           TREE.replace("time.sleep(600)\n", "", 1)
                           .rstrip() + "\n", path])
    proc.wait(timeout=DEADLINE_S)
    kids = _tree_pids(path, proc.pid)[1:]
    assert all(_alive(p) for p in kids)
    assert sorted(children.stop(timeout=10)) == sorted(kids)
    _wait_for(lambda: not any(_alive(p) for p in kids), "clean stop")


def test_sigterm_ends_the_script_and_its_children(tmp_path):
    """The script's own SIGTERM handler runs
    :func:`chip_smoke.stopping_children`'s clean-up."""
    path = str(tmp_path / "tree")
    script = textwrap.dedent(f"""
        import importlib.util, sys, time
        spec = importlib.util.spec_from_file_location(
            "cs", {os.path.join(ROOT, "chip_smoke.py")!r})
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)

        def body():
            cs.CHILDREN.popen([sys.executable, "-c", {TREE!r}, {path!r}])
            time.sleep(600)

        cs._main = body
        sys.exit(cs.main())
    """)
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT)
    try:
        _wait_for(lambda: os.path.exists(path), "tree")
        with open(path) as f:
            kids = [int(p) for p in f.read().split()][1:]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=DEADLINE_S) == 143
        _wait_for(lambda: not any(_alive(p) for p in kids), "clean stop")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_the_scheduler_keeps_its_order_limit_and_phases(smoke, children):
    running, most, started = [0], [0], []
    lock = threading.Lock()

    def chain(name, fail=False):
        def run():
            with lock:
                started.append(name)
                running[0] += 1
                most[0] = max(most[0], running[0])
            time.sleep(0.2)
            with lock:
                running[0] -= 1
            if fail:
                raise AssertionError(f"{name}'s gate")
            return name
        return run

    names = ["17", "12c", "9c", "11f", "11g"]
    beside = smoke.Beside({n: chain(n, fail=n == "9c") for n in names},
                          workers=2)
    beside.join()
    assert started[:2] == names[:2] and sorted(started) == sorted(names)
    assert most[0] == 2
    assert set(beside.walls) == set(names)
    assert all(beside.result(n) == n for n in names if n != "9c")
    with pytest.raises(RuntimeError, match="phase 9c") as err:
        beside.result("9c")
    assert "9c's gate" in str(err.value.__cause__)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """A consensus-complete port run (KL, k=3) for a real fleet."""
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

    tmp = str(tmp_path_factory.mktemp("smoke_fleet"))
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


def test_a_real_fleet_beside_a_failing_phase_leaves_nothing(smoke, children,
                                                             fleet_run,
                                                             tmp_path):
    """The rehearsal: 12c's ``fleet`` (two ``serve`` replicas) up as a
    chain, then the main thread fails; the fleet and both replicas are
    gone when :func:`chip_smoke.stopping_children` returns."""
    from cnmf_torch_tpu_torch.serving.fleet import FleetClient

    sock = str(tmp_path / "fleet.sock")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               CNMF_TPU_SERVE_BUCKETS="64",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    seen, up = {}, threading.Event()

    def fleet_chain():
        log = open(tmp_path / "fleet.log", "wb")
        proc = smoke.CHILDREN.popen(
            [sys.executable, "-m", "cnmf_torch_tpu_torch", "fleet",
             fleet_run, "-k", "3", "--local-density-threshold", "2.0",
             "--replicas", "2", "--socket", sock, "--device", "cpu"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        seen["fleet"] = proc.pid
        cli = FleetClient(socket_path=sock, timeout=30.0)
        deadline = time.monotonic() + DEADLINE_S
        while True:
            assert proc.poll() is None, "the fleet exited while warming"
            try:
                st = cli.stats()
                if st["replicas_up"] == 2:
                    break
            except (OSError, ValueError):
                pass
            assert time.monotonic() < deadline, "fleet never healthy"
            time.sleep(0.1)
        seen["replicas"] = [r["pid"] for r in st["replicas"]]
        up.set()
        proc.wait()     # 12c waits for its shutdown, which never comes

    def body():
        smoke.Beside({"12c": fleet_chain}, workers=3)
        assert up.wait(DEADLINE_S), "the fleet never came up"
        raise RuntimeError("a failed check beside 12c")

    with pytest.raises(RuntimeError, match="beside 12c"):
        smoke.stopping_children(body)
    pids = [seen["fleet"], *seen["replicas"]]
    assert len(set(pids)) == 3 and all(pids)
    _wait_for(lambda: not any(_alive(p) for p in pids), "clean stop")
    assert not any(t.is_alive() for t in children.threads)
