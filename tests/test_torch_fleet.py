"""The port's replicated serving fleet (``serving/fleet.py``) on the CPU:
the consistent-hash ring and token buckets against the JAX package's,
idempotent retries (at most one solve per id), the daemon's shutdown
drain (no accepted request lost), the router's failover, wedge
conviction, respawn budget, rollover and fleet-scoped quarantine against
in-process fake replicas (as the JAX package's tests drive its router),
and the CLI's argument errors. The real subprocess fleet is in
``tests/test_torch_fleet_proc.py``.

Every test that waits on a socket or a thread has its own deadline of
60 s or less.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cnmf_torch_tpu_torch.ops.nmf import fit_h
from cnmf_torch_tpu_torch.serving import (
    ProjectionService,
    ResidentReference,
    ServeClient,
    ServeDaemon,
)
from cnmf_torch_tpu_torch.serving.fleet import (
    FleetClient,
    FleetDaemon,
    FleetRouter,
    HashRing,
    TokenBucket,
)

K, G = 6, 90
RTOL_SOLO, ATOL = 1e-5, 1e-6
DEADLINE_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each would oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _reference(beta=2.0, chunk_size=5000, seed=0, g=G, k=K, **kw):
    rng = np.random.default_rng(seed)
    W = rng.gamma(0.3, 1.0, size=(k, g)).astype(np.float32)
    return ResidentReference(W, beta=beta, chunk_size=chunk_size,
                             chunk_max_iter=150, h_tol=0.05, l1_H=0.0,
                             **kw)


def _query(ref, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.dirichlet(np.ones(ref.k) * 0.3, size=n)
    return (u @ ref.W * 40.0
            + rng.random((n, ref.n_genes)) * 0.01).astype(np.float32)


def _solo(ref, X, H_init=None):
    return fit_h(X, ref.W, H_init=H_init, chunk_size=ref.chunk_size,
                 chunk_max_iter=ref.chunk_max_iter, h_tol=ref.h_tol,
                 l1_reg_H=ref.l1_H, l2_reg_H=0.0, beta=ref.beta,
                 device="cpu")


def _assert_solo(H, want):
    np.testing.assert_allclose(H, want, rtol=RTOL_SOLO, atol=ATOL)


# ---------------------------------------------------------------------------
# consistent-hash ring
# ---------------------------------------------------------------------------

def test_hashring_spread_and_route_stability():
    ring = HashRing([0, 1, 2, 3])
    tenants = [f"tenant-{i}" for i in range(4000)]
    before = {t: ring.route(t) for t in tenants}
    counts = {n: sum(1 for v in before.values() if v == n)
              for n in range(4)}
    # even-ish spread: no replica owns more than ~2x its fair share
    assert all(200 < c < 2000 for c in counts.values()), counts
    ring.remove(2)
    after = {t: ring.route(t) for t in tenants}
    # THE consistent-hashing property: removing a node remaps ONLY the
    # tenants it owned — every other tenant keeps its warm replica
    moved = [t for t in tenants if before[t] != after[t]]
    assert len(moved) == counts[2]
    assert all(before[t] == 2 for t in moved)
    # adding it back restores the exact original assignment
    ring.add(2)
    assert {t: ring.route(t) for t in tenants} == before


def test_hashring_candidates_are_the_failover_order():
    ring = HashRing(["a", "b", "c"])
    for tenant in ("acme", "globex", "initech"):
        cands = ring.candidates(tenant)
        assert cands[0] == ring.route(tenant)
        assert sorted(cands) == ["a", "b", "c"]  # all nodes, no dupes
    assert HashRing().candidates("x") == []
    assert HashRing().route("x") is None


# ---------------------------------------------------------------------------
# token-bucket admission
# ---------------------------------------------------------------------------

def test_token_bucket_accounting():
    now = [0.0]
    tb = TokenBucket(rate=2.0, burst=4.0, clock=lambda: now[0])
    assert [tb.allow() for _ in range(5)] == [True] * 4 + [False]
    now[0] += 1.0  # 2 tokens refill at rate=2/s
    assert [tb.allow() for _ in range(3)] == [True, True, False]
    now[0] += 100.0  # refill caps at burst, not 200 tokens
    assert [tb.allow() for _ in range(5)] == [True] * 4 + [False]
    # burst defaults to 2x rate
    assert TokenBucket(rate=3.0).burst == 6.0


def test_hashring_routes_as_the_jax_ring():
    """The same tenants go to the same nodes, in the same failover order,
    as under the JAX package's ring: before and after a removal."""
    from cnmf_torch_tpu.serving.fleet import HashRing as JRing

    tenants = [f"tenant-{i}" for i in range(1000)]
    for nodes in ([0, 1], [0, 1, 2, 3], ["a", "b", "c"]):
        ring, jring = HashRing(nodes), JRing(nodes)
        for t in tenants:
            assert ring.route(t) == jring.route(t)
            assert ring.candidates(t) == jring.candidates(t)
        ring.remove(nodes[0])
        jring.remove(nodes[0])
        assert [ring.route(t) for t in tenants] == [jring.route(t)
                                                     for t in tenants]


def test_token_bucket_matches_jax_under_a_fake_clock():
    from cnmf_torch_tpu.serving.fleet import TokenBucket as JBucket

    now = [0.0]
    steps = [0.0, 0.1, 0.0, 0.7, 0.0, 0.0, 2.5, 0.05, 0.0, 10.0, 0.0]
    for rate, burst in ((2.0, 4.0), (0.5, None), (10.0, 1.0)):
        now[0] = 0.0
        tb = TokenBucket(rate, burst, clock=lambda: now[0])
        jb = JBucket(rate, burst, clock=lambda: now[0])
        assert tb.burst == jb.burst
        for dt in steps * 3:
            now[0] += dt
            assert tb.allow() == jb.allow()


# ---------------------------------------------------------------------------
# idempotent request ids: at-most-once solve on the real service
# ---------------------------------------------------------------------------

def test_idempotent_request_id_solves_once():
    ref = _reference()
    with ProjectionService(ref, device="cpu", max_batch=4, linger_ms=5.0,
                           warm_start=False) as svc:
        X = _query(ref, 17, 5)
        H1, meta1 = svc.project(X, request_id="rid-1")
        H2, meta2 = svc.project(X, request_id="rid-1")  # router retry
        _assert_solo(H1, _solo(ref, X))
        assert np.array_equal(H1, H2)
        stats = svc.stats()
        # ONE solve, one dedup hit — the retry never re-entered the queue
        assert stats["ok"] == 1
        assert stats["deduped"] == 1
        # a different id is a different request
        H3, _ = svc.project(X, request_id="rid-2")
        np.testing.assert_allclose(H3, H1, rtol=RTOL_SOLO, atol=ATOL)
        assert svc.stats()["ok"] == 2


def test_idempotent_ids_do_not_cross_tenants_or_leak_unbounded():
    ref = _reference()
    with ProjectionService(ref, device="cpu", max_batch=4, linger_ms=2.0,
                           warm_start=False) as svc:
        X = _query(ref, 9, 6)
        svc.project(X, tenant="a", request_id="r-a")
        assert len(svc._idem) == 1
        # no id -> no claim kept
        svc.project(X, tenant="a")
        assert len(svc._idem) == 1


# ---------------------------------------------------------------------------
# daemon shutdown drain: no accepted request is ever lost
# ---------------------------------------------------------------------------

def test_daemon_shutdown_drains_every_accepted_request(tmp_path):
    """Requests sitting in the batcher's linger window when the daemon is
    told to stop must ALL complete with their correct usage matrices."""
    ref = _reference()
    svc = ProjectionService(ref, device="cpu", max_batch=8,
                            linger_ms=300.0,
                            warm_start=False)
    sock = str(tmp_path / "drain.sock")
    daemon = ServeDaemon(svc, socket_path=sock).start()
    n_req = 5
    results = [None] * n_req
    errors = []

    def worker(i):
        try:
            X = _query(ref, 16 + i, 100 + i)
            H, _ = ServeClient(socket_path=sock,
                               timeout=DEADLINE_S).project(X)
            results[i] = (X, H)
        except Exception as exc:  # pragma: no cover - the failure mode
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_req)]
    for t in threads:
        t.start()
    # wait until every request is ACCEPTED (inflight counts at the
    # accept loop), i.e. all five are inside the linger window
    deadline = time.monotonic() + 10.0
    while daemon.server.inflight < n_req:
        assert time.monotonic() < deadline, "requests never accepted"
        time.sleep(0.005)
    daemon.close()  # must drain, not drop
    for t in threads:
        t.join(timeout=DEADLINE_S)
        assert not t.is_alive(), "a client passed its deadline"
    assert not errors
    for X, H in results:
        assert H is not None
        _assert_solo(H, _solo(ref, X))
    assert not os.path.exists(sock)  # no orphaned socket either


# ---------------------------------------------------------------------------
# the router, against fake replicas
# ---------------------------------------------------------------------------

class _Events:
    def __init__(self):
        self.emitted = []

    def emit(self, event_type, **fields):
        self.emitted.append((event_type, fields))

    def of(self, event_type):
        return [f for t, f in self.emitted if t == event_type]


class FakeReplica:
    """In-process stand-in for SubprocessReplica: same duck interface,
    scripted behavior, shared append-only log for ordering assertions."""

    def __init__(self, slot, ordinal, generation, spectra, log,
                 behavior=None):
        self.slot, self.ordinal = slot, ordinal
        self.generation, self.spectra_path = generation, spectra
        self.log = log
        self.behavior = dict(behavior or {})
        self.requests = 0
        self.pid = 40000 + ordinal
        self._alive = False
        self.gate = None  # optional Event a /project blocks on

    def start(self):
        if self.behavior.get("fail_start"):
            raise OSError("spawn failed")
        self._alive = True
        self.log.append(("start", self.ordinal))
        return self

    def alive(self):
        return self._alive

    def uptime_s(self):
        return 1.0

    def kill(self, wedge=False):
        if wedge:
            self.behavior["wedged"] = True
        else:
            self._alive = False

    def reap(self, timeout=0.0):
        pass

    def healthz(self, timeout=0.0):
        if not self._alive or self.behavior.get("wedged"):
            raise OSError("no reply")
        return {"ok": True}

    def heartbeat_age(self):
        if self.behavior.get("wedged"):
            return None  # stamp went stale/absent
        return 0.0

    def forward(self, method, path, body=None, headers=None,
                timeout=0.0):
        if not self._alive or self.behavior.get("wedged"):
            raise ConnectionRefusedError("replica down")
        self.log.append((f"{method} {path}", self.ordinal))
        if self.gate is not None:
            self.gate.wait(timeout=30)
        reply = self.behavior.get("project")
        if reply is not None:
            status, payload = reply
            return status, json.dumps(payload).encode()
        return 200, json.dumps(
            {"ok": True, "status": "ok", "usage": [[1.0] * K],
             "meta": {"generation": self.generation}}).encode()

    def shutdown(self, grace_s=60.0):
        self.log.append(("shutdown", self.ordinal))
        self._alive = False

    def _cleanup(self):
        pass


def _fake_router(log, events=None, replicas=2, behaviors=None, **kw):
    behaviors = behaviors or {}

    def factory(slot, ordinal, generation, spectra):
        return FakeReplica(slot, ordinal, generation, spectra, log,
                           behavior=behaviors.get(generation))

    return FleetRouter(replicas=replicas, replica_factory=factory,
                       events=events, **kw)


def _body(tenant, request_id=None, n=3):
    payload = {"tenant": tenant, "data": [[0.5] * G] * n}
    if request_id is not None:
        payload["request_id"] = request_id
    return json.dumps(payload).encode()


def test_router_routes_and_accounts(monkeypatch):
    log, ev = [], _Events()
    router = _fake_router(log, events=ev).start(supervise=False)
    try:
        status, blob = router.handle_project(_body("acme"), {})
        assert status == 200
        assert json.loads(blob)["status"] == "ok"
        # same tenant -> same replica (warm cache locality)
        router.handle_project(_body("acme"), {})
        served = [o for op, o in log if op == "POST /project"]
        assert len(served) == 2 and served[0] == served[1]
        st = router.stats()
        assert st["ok"] == 2 and st["requests"] == 2
        reqs = ev.of("serve_request")
        assert len(reqs) == 2
        assert all(r["status"] == "ok" and "replica" in r for r in reqs)
    finally:
        router.close()


def test_router_tenant_quota_sheds_before_forwarding(monkeypatch):
    # burst auto-sizes to max(1, 2*rate) = 1 token: the second
    # back-to-back request from one tenant is shed at admission
    monkeypatch.setenv("CNMF_TPU_FLEET_TENANT_QPS", "0.001")
    log = []
    router = _fake_router(log).start(supervise=False)
    try:
        assert router.handle_project(_body("hot"), {})[0] == 200
        status, reply = router.handle_project(_body("hot"), {})
        assert status == 429
        assert reply["status"] == "shed"
        # the shed request never consumed replica queue space
        assert len([1 for op, _ in log if op == "POST /project"]) == 1
        # quotas are PER tenant: another tenant still gets through
        assert router.handle_project(_body("cold"), {})[0] == 200
        assert router.stats()["shed"] == 1
    finally:
        router.close()


def test_router_fleet_scoped_poison_quarantine():
    log = []
    poison = {"project": (422, {"ok": False, "status": "poison",
                                "error": "NaN input"})}
    router = _fake_router(log, behaviors={0: poison}).start(
        supervise=False)
    try:
        for _ in range(3):  # three strikes, counted AT THE ROUTER
            status, _reply = router.handle_project(_body("toxic"), {})
            assert status == 422
        status, reply = router.handle_project(_body("toxic"), {})
        assert status == 403
        assert reply["status"] == "quarantined"
        # the 4th request was refused at admission, not forwarded
        assert len([1 for op, _ in log if op == "POST /project"]) == 3
        assert "toxic" in router.stats()["quarantined_tenants"]
    finally:
        router.close()


def test_router_failover_retry_is_idempotent_and_respawns():
    log, ev = [], _Events()
    router = _fake_router(log, events=ev).start(supervise=False)
    try:
        status, blob = router.handle_project(
            _body("acme", request_id="rid-9"), {})
        assert status == 200
        home = [o for op, o in log if op == "POST /project"][-1]
        # SIGKILL the tenant's home replica
        victim = next(s for s in router._slots
                      if s.replica.ordinal == home)
        victim.replica.kill()
        # the router retries the SAME request id on a survivor — the
        # idempotency header makes that retry at-most-once end to end
        status, blob = router.handle_project(
            _body("acme", request_id="rid-9"), {})
        assert status == 200
        survivor = [o for op, o in log if op == "POST /project"][-1]
        assert survivor != home
        assert router.stats()["retries"] >= 1
        # supervision notices the corpse: ring shrinks, events emitted
        router._tick()
        assert len(router._ring) == 1
        deaths = ev.of("replica_death")
        assert deaths and deaths[0]["reason"] == "exit"
        assert deaths[0]["replica"] == victim.index
        fo = ev.of("failover")
        assert fo and fo[0]["survivors"] == 1
        # ...and respawns within budget: due -> spawn -> healthy -> ring
        victim.down_until = 0.0
        router._tick()  # spawns (warming, not yet in ring)
        router._tick()  # first healthy poll joins the ring
        assert len(router._ring) == 2
        assert victim.replica.ordinal != home  # a NEW ordinal, new node
    finally:
        router.close()


def test_router_wedge_conviction_needs_both_evidence_kinds(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_FLEET_WEDGE_POLLS", "2")
    log, ev = [], _Events()
    router = _fake_router(log, events=ev).start(supervise=False)
    try:
        slot = router._slots[0]
        slot.replica.behavior["wedged"] = True  # SIGSTOP profile
        router._tick()  # strike 1: healthz failed, heartbeat stale
        assert len(router._ring) == 2  # not convicted yet
        router._tick()  # strike 2: convicted, killed, failed over
        assert len(router._ring) == 1
        deaths = ev.of("replica_death")
        assert deaths and deaths[0]["reason"] == "wedge"
    finally:
        router.close()


def test_router_respawn_budget_exhausts(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_FLEET_RESPAWNS", "0")
    log, ev = [], _Events()
    router = _fake_router(log, events=ev).start(supervise=False)
    try:
        router._slots[0].replica.kill()
        router._tick()
        assert len(router._ring) == 1
        router._tick()  # budget 0: no respawn attempt
        assert router._slots[0].replica is None
        reasons = [d["reason"] for d in ev.of("replica_death")]
        assert "respawns_exhausted" in reasons
    finally:
        router.close()


def test_router_all_replicas_down_is_503_not_a_hang():
    log = []
    router = _fake_router(log).start(supervise=False)
    try:
        for slot in router._slots:
            slot.replica.kill()
        status, reply = router.handle_project(_body("acme"), {})
        assert status == 503
        assert reply["status"] == "error"
    finally:
        router.close()


# ---------------------------------------------------------------------------
# rollover: drain-then-swap ordering, zero downtime
# ---------------------------------------------------------------------------

def test_rollover_orders_warm_swap_drain_and_updates_respawn_ref():
    log, ev = [], _Events()
    router = _fake_router(log, events=ev,
                          spectra_path="v1.df.npz").start(supervise=False)
    try:
        gen0 = {s.replica.ordinal for s in router._slots}
        # hold one in-flight request on the OLD generation across the
        # whole rollover: it must complete, not be torn down
        victim = router._slots[0].replica
        victim.gate = threading.Event()
        inflight = {}

        def old_request():
            tenant = next(t for t in (f"t{i}" for i in range(64))
                          if router._ring.route(t) == victim.ordinal)
            inflight["reply"] = router.handle_project(_body(tenant), {})

        t = threading.Thread(target=old_request)
        t.start()
        deadline = time.monotonic() + 5.0
        while not any(op == "POST /project" for op, _ in log):
            assert time.monotonic() < deadline
            time.sleep(0.005)

        status, reply = router.handle_rollover({"spectra": "v2.df.npz"})
        assert status == 200 and reply["generation"] == 1

        # ordering: every NEW replica started before any OLD replica was
        # told to shut down (warm first, swap, then drain the old set)
        starts_gen1 = [i for i, (op, o) in enumerate(log)
                       if op == "start" and o not in gen0]
        shutdowns_gen0 = [i for i, (op, o) in enumerate(log)
                          if op == "shutdown" and o in gen0]
        assert len(starts_gen1) == 2 and len(shutdowns_gen0) == 2
        assert max(starts_gen1) < min(shutdowns_gen0)

        # the held old-generation request still completes (drain, not
        # drop) — zero downtime means IT never observed the swap
        victim.gate.set()
        t.join(timeout=DEADLINE_S)
        assert not t.is_alive()
        assert inflight["reply"][0] == 200

        # new requests land on generation 1, and a future death-respawn
        # would load the NEW reference
        status, blob = router.handle_project(_body("anyone"), {})
        assert json.loads(blob)["meta"]["generation"] == 1
        assert router._spectra_path == "v2.df.npz"
        roll = ev.of("rollover")
        assert roll and roll[0]["generation"] == 1
        assert roll[0]["wall_s"] >= 0
    finally:
        router.close()


def test_rollover_warm_failure_leaves_old_generation_serving():
    log = []
    router = _fake_router(
        log, spectra_path="v1.df.npz",
        behaviors={1: {"fail_start": True}}).start(supervise=False)
    try:
        status, reply = router.handle_rollover({"spectra": "v2.df.npz"})
        assert status == 500
        assert "old reference still serving" in reply["error"]
        assert router._generation == 0
        assert router._spectra_path == "v1.df.npz"
        assert len(router._ring) == 2  # untouched
        assert router.handle_project(_body("acme"), {})[0] == 200
    finally:
        router.close()


def test_rollover_rejects_concurrent_and_malformed():
    log = []
    router = _fake_router(log).start(supervise=False)
    try:
        assert router.handle_rollover({})[0] == 400
        router._rollover_lock.acquire()
        try:
            assert router.handle_rollover(
                {"spectra": "x.df.npz"})[0] == 409
        finally:
            router._rollover_lock.release()
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the fleet daemon over HTTP (fake replicas, real router + handler)
# ---------------------------------------------------------------------------

def test_fleet_daemon_http_surface(tmp_path):
    log = []
    router = _fake_router(log, spectra_path="v1.df.npz")
    sock = str(tmp_path / "fleet.sock")
    daemon = FleetDaemon(router, socket_path=sock)
    router.start(supervise=False)
    thread = threading.Thread(target=daemon.server.serve_forever,
                              daemon=True)
    daemon._thread = thread
    thread.start()
    try:
        cli = FleetClient(socket_path=sock, timeout=DEADLINE_S)
        hz = cli.healthz()
        assert hz["ok"] and hz["replicas_up"] == 2
        H, meta = cli.project(np.ones((1, G), np.float32),
                              tenant="acme", request_id="rid-http")
        assert H.shape == (1, K)
        st = cli.stats()
        assert st["ok"] == 1 and st["generation"] == 0
        out = cli.rollover("v2.df.npz")
        assert out["generation"] == 1
        assert cli.stats()["generation"] == 1
        assert cli.shutdown()
    finally:
        daemon.close()
    assert not os.path.exists(sock)


def test_f6_fleet_daemon_serve_forever_closes_the_router(tmp_path):
    """JAX's blocking ``FleetDaemon.serve_forever``: it serves until
    another thread shuts the server down, then returns with the router
    closed (every replica drain-stopped) and the socket removed."""
    log = []
    router = _fake_router(log, spectra_path="v1.df.npz")
    sock = str(tmp_path / "fleet.sock")
    daemon = FleetDaemon(router, socket_path=sock)
    router.start(supervise=False)
    thread = threading.Thread(target=daemon.serve_forever, daemon=True)
    thread.start()
    cli = FleetClient(socket_path=sock, timeout=DEADLINE_S)
    assert cli.healthz()["replicas_up"] == 2
    H, _ = cli.project(np.ones((1, G), np.float32), tenant="acme")
    assert H.shape == (1, K)
    threading.Thread(target=daemon.server.shutdown, daemon=True).start()
    thread.join(timeout=DEADLINE_S)
    assert not thread.is_alive()
    assert daemon._closed and not router._running
    assert sorted(o for what, o in log if what == "shutdown") == [0, 1]
    assert not os.path.exists(sock)


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def test_cli_fleet_argument_validation(tmp_path):
    from cnmf_torch_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["fleet", str(tmp_path / "nope"), "--device", "cpu"])
    assert exc.value.code == 2
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    with pytest.raises(SystemExit) as exc:
        main(["fleet", str(run_dir), "--socket", "s.sock",
              "--port", "8080", "--device", "cpu"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        main(["fleet", str(run_dir), "--replicas", "0", "--device",
              "cpu"])
    assert exc.value.code == 2
    # stray positionals still fail fast for non-run_dir subcommands
    with pytest.raises(SystemExit) as exc:
        main(["consensus", "9"])
    assert exc.value.code == 2
