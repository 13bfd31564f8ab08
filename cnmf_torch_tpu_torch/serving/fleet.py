"""Replicated serving fleet: tenant-aware routing, failover, and
zero-downtime reference rollover over N ``serve`` daemon replicas.

One daemon (``daemon.py``) serves from one process; the fleet is many
replicas that individually die, hang, and roll their reference forward
without the fleet dropping a request. This module is the stdlib HTTP
router in front of them:

  * **Tenant routing** — a consistent-hash ring (:class:`HashRing`,
    sha1, 64 vnodes per replica, the JAX package's ring point for point)
    pins each tenant to one replica, so the tenant's warm-start usage
    cache stays hot; removing a replica remaps only its own tenants.
  * **Admission** — per-tenant token-bucket quotas
    (``CNMF_TPU_FLEET_TENANT_QPS``) shed a hot tenant with HTTP 429
    before it takes replica queue space, and the 3-strike poison
    quarantine is counted at the router, so a poisoned tenant stays
    quarantined across failovers.
  * **Failover** — replica health from subprocess liveness, ``/healthz``
    polls and heartbeat stamps (``runtime/elastic.py``); a dead replica
    leaves the ring at the next supervision tick, its tenants remap to
    the survivors, and it respawns after the launcher's deterministic
    backoff (``launcher.respawn_delay``). A wedged replica (alive but
    unresponsive, SIGSTOP in the chaos drill) is convicted only on
    ``CNMF_TPU_FLEET_WEDGE_POLLS`` consecutive failed polls WITH a stale
    or absent heartbeat, then SIGKILLed and respawned. Router retries
    carry the request's idempotency id (``daemon.REQUEST_ID_HEADER``):
    at most one solve per id. One hedged attempt
    (``CNMF_TPU_FLEET_HEDGE_MS``) bounds the tail paid for a slow
    replica.
  * **Rollover** — ``POST /rollover {"spectra": <path>}`` serves a new
    reference with zero downtime: a fresh replica set warms against the
    new spectra, the ring swaps at once when every fresh replica is
    healthy, and the old generation drains (the daemon's ``/shutdown``
    drain) before it exits. No request sees an error or a reply from a
    mix of references.

Every replica is ``python -m cnmf_torch_tpu_torch serve ... --device
<the fleet's device>``: the replicas of a fleet on a card each open their
own CUDA context on it. Chaos clauses ``replicadeath`` / ``replicawedge``
(``runtime/faults.py``) kill and wedge replicas on demand; telemetry lands
as ``replica_death`` / ``failover`` / ``rollover`` events plus router-side
``serve_request`` events naming the serving replica.
"""

from __future__ import annotations

import itertools
import hashlib
import json
import os
import queue
import signal
import subprocess
import threading
import time

from ..launcher import port_command, port_env, respawn_delay
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..runtime import faults
from ..runtime.elastic import Heartbeat
from ..utils.envknobs import env_flag, env_float, env_int
from .batcher import POISON_QUARANTINE_STRIKES, ServeError
from .daemon import (REQUEST_ID_HEADER, ServeClient, _bind, _close_server,
                     _JsonHandler, _server_address, _UnixHTTPConnection,
                     install_stop_signals, restore_signals)

__all__ = [
    "HashRing",
    "TokenBucket",
    "FleetRouter",
    "FleetDaemon",
    "FleetClient",
    "SubprocessReplica",
    "fleet_forever",
    "default_fleet_socket_path",
]

# vnodes per replica on the consistent-hash ring: enough that tenant
# load spreads evenly across a handful of replicas, few enough that
# ring rebuilds stay trivially cheap
FLEET_VNODES = 64


def default_fleet_socket_path(run_dir: str) -> str:
    name = os.path.basename(os.path.normpath(run_dir))
    return os.path.join(run_dir, "cnmf_tmp", name + ".fleet.sock")


# ---------------------------------------------------------------------------
# consistent-hash ring
# ---------------------------------------------------------------------------

def _hash64(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode("utf-8")).digest()[:8],
                          "big")


class HashRing:
    """Consistent-hash ring over opaque node ids.

    Each node owns :data:`FLEET_VNODES` points; a key routes to the
    first point clockwise from its own hash. Removing a node remaps
    ONLY the keys that routed to it (they fall to the next point
    clockwise); adding a node steals ~1/N of the keyspace. That
    stability is the whole reason for the structure: a replica death
    must not reshuffle every tenant's warm-start cache onto a cold
    replica."""

    def __init__(self, nodes=()):
        self._points: list = []  # sorted [(hash, node)]
        self._nodes: set = set()
        for node in nodes:
            self.add(node)

    def add(self, node):
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(FLEET_VNODES):
            self._points.append((_hash64(f"{node}#{v}"), node))
        self._points.sort()

    def remove(self, node):
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [p for p in self._points if p[1] != node]

    def nodes(self) -> set:
        return set(self._nodes)

    def __len__(self):
        return len(self._nodes)

    def route(self, key: str):
        """The key's home node, or ``None`` on an empty ring."""
        if not self._points:
            return None
        h = _hash64(str(key))
        lo, hi = 0, len(self._points)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return self._points[lo % len(self._points)][1]

    def candidates(self, key: str) -> list:
        """Every node, ordered by ring distance from the key: the
        failover sequence (element 0 is :meth:`route`'s answer; retries
        walk clockwise so every router agrees on the fallback order)."""
        if not self._points:
            return []
        h = _hash64(str(key))
        lo, hi = 0, len(self._points)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        out, seen = [], set()
        n = len(self._points)
        for i in range(n):
            node = self._points[(lo + i) % n][1]
            if node not in seen:
                seen.add(node)
                out.append(node)
        return out


# ---------------------------------------------------------------------------
# per-tenant token buckets
# ---------------------------------------------------------------------------

class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s up to ``burst`` capacity;
    :meth:`allow` spends one token or answers False. ``clock`` is
    injectable so tests drive time deterministically."""

    def __init__(self, rate: float, burst: float | None = None,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, 2.0 * self.rate)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


# ---------------------------------------------------------------------------
# replicas (subprocess engine)
# ---------------------------------------------------------------------------

class SubprocessReplica:
    """One ``serve`` daemon subprocess: the real replica engine.

    The router only touches the duck interface (``start`` / ``alive`` /
    ``kill`` / ``healthz`` / ``forward`` / ``heartbeat_age`` /
    ``shutdown``) so unit tests substitute in-process fakes; everything
    process-shaped lives here."""

    def __init__(self, run_dir: str, slot: int, ordinal: int,
                 generation: int, spectra_path: str | None = None,
                 k: int | None = None, density_threshold=None,
                 replica_telemetry: bool | None = None, device="cuda"):
        self.run_dir = run_dir
        self.device = str(device)
        self.slot = int(slot)
        self.ordinal = int(ordinal)
        self.generation = int(generation)
        self.spectra_path = spectra_path
        self.k = k
        self.density_threshold = density_threshold
        name = os.path.basename(os.path.normpath(run_dir))
        tmp = os.path.join(run_dir, "cnmf_tmp")
        self.socket_path = os.path.join(
            tmp, f"{name}.fleet.r{self.ordinal}.sock")
        self.log_path = os.path.join(
            tmp, f"{name}.fleet.r{self.ordinal}.log")
        self.heartbeat_path = os.path.join(
            tmp, f"{name}.serve.heartbeat.{self.ordinal}.json")
        self._telemetry = (env_flag("CNMF_TPU_FLEET_REPLICA_TELEMETRY",
                                    False)
                           if replica_telemetry is None
                           else bool(replica_telemetry))
        self.proc: subprocess.Popen | None = None
        self.started_at: float | None = None
        self.killed_at: float | None = None
        self.ready_s: float | None = None
        self.requests = 0  # router-side per-replica share counter

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def start(self):
        cmd = port_command("serve", self.run_dir, "--socket",
                           self.socket_path, "--replica-index",
                           str(self.ordinal), "--device", self.device)
        if self.k is not None:
            cmd += ["-k", str(self.k)]
        if self.density_threshold is not None:
            cmd += ["--local-density-threshold",
                    str(self.density_threshold)]
        if self.spectra_path is not None:
            cmd += ["--spectra", self.spectra_path]
        # the replica imports this copy of the port whatever its working
        # directory
        env = port_env(os.environ)
        if not self._telemetry:
            # N replicas of one run dir would otherwise multi-count
            # serve_request in the merged report; the router's own
            # stream carries per-request outcomes
            env["CNMF_TPU_TELEMETRY"] = "0"
        # heartbeats are the wedge-conviction evidence — make sure the
        # replica actually stamps them unless the operator pinned a rate
        env.setdefault("CNMF_TPU_HEARTBEAT_S", "0.5")
        # an append-only crash log, not an artifact anyone parses — torn
        # tails are expected after SIGKILL chaos
        log = open(self.log_path, "ab")  # cnmf-lint: disable=artifact-nonatomic
        try:
            self.proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                         env=env)
        finally:
            log.close()
        self.started_at = time.monotonic()
        return self

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def uptime_s(self) -> float:
        if self.started_at is None:
            return 0.0
        return time.monotonic() - self.started_at

    def kill(self, wedge: bool = False):
        """SIGKILL the replica (``wedge=True`` SIGSTOPs instead — the
        fault hooks' alive-but-unresponsive profile)."""
        if self.proc is None:
            return
        if self.killed_at is None:
            self.killed_at = time.monotonic()
        try:
            self.proc.send_signal(signal.SIGSTOP if wedge
                                  else signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass

    def reap(self, timeout: float = 10.0):
        if self.proc is None:
            return
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass

    def _connect(self, timeout: float):
        return _UnixHTTPConnection(self.socket_path, timeout=timeout)

    def forward(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None, timeout: float = 180.0):
        """Raw pass-through to the replica: ``(status, body_bytes)``.
        Raises ``OSError`` family on transport failure (dead socket,
        refused connect, read timeout) — the router's failover signal."""
        conn = self._connect(timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def healthz(self, timeout: float = 5.0) -> dict:
        status, blob = self.forward("GET", "/healthz", timeout=timeout)
        if status != 200:
            raise ServeError(f"replica {self.ordinal}: healthz HTTP "
                             f"{status}")
        return json.loads(blob)

    def heartbeat_age(self) -> float | None:
        """Seconds since the replica's last heartbeat stamp, or ``None``
        when it never stamped."""
        rec = Heartbeat.read(self.heartbeat_path)
        if rec is None:
            return None
        return max(0.0, time.time() - float(rec.get("ts", 0.0)))

    def shutdown(self, grace_s: float = 60.0):
        """Drain-stop: ``POST /shutdown`` (the daemon finishes every
        accepted request before its batcher stops), bounded wait, then
        SIGKILL if it overstays."""
        try:
            self.forward("POST", "/shutdown", timeout=10.0)
        except OSError:
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.kill()
                self.reap(5.0)
        self._cleanup()

    def _cleanup(self):
        for path in (self.socket_path, self.heartbeat_path):
            try:
                if os.path.exists(path):
                    os.unlink(path)
            except OSError:
                pass


def _drain(reps):
    """Drain-stop replicas all at once: each finishes its accepted
    requests and exits in parallel with the others."""
    threads = [threading.Thread(target=r.shutdown, daemon=True)
               for r in reps]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class _Slot:
    """One replica position: the ring membership unit the supervisor
    manages. ``replica`` is live (or warming) or ``None`` while down;
    ``attempts`` counts deaths against the respawn budget."""

    __slots__ = ("index", "replica", "in_ring", "attempts", "down_until",
                 "healthz_fails")

    def __init__(self, index: int):
        self.index = int(index)
        self.replica = None
        self.in_ring = False
        self.attempts = 0
        self.down_until = 0.0
        self.healthz_fails = 0


class FleetRouter:
    """Spawns, supervises, and routes over N serve replicas.

    ``replica_factory(slot, ordinal, generation, spectra_path)`` builds
    one replica (default: :class:`SubprocessReplica` over ``run_dir``);
    tests inject in-process fakes. :meth:`handle_project` /
    :meth:`handle_rollover` are plain ``(status, payload)`` functions so
    router behavior is unit-testable without any HTTP server."""

    def __init__(self, run_dir: str | None = None, *,
                 replicas: int | None = None,
                 spectra_path: str | None = None, k: int | None = None,
                 density_threshold=None, events=None,
                 replica_factory=None, forward_timeout_s: float = 180.0,
                 device="cuda"):
        self.run_dir = run_dir
        self.device = str(device)
        self.n_replicas = (env_int("CNMF_TPU_FLEET_REPLICAS", 2, lo=1)
                           if replicas is None else max(1, int(replicas)))
        self.events = events
        self.forward_timeout_s = float(forward_timeout_s)
        self.health_s = env_float("CNMF_TPU_FLEET_HEALTH_S", 0.5, lo=0.05)
        self.wedge_polls = env_int("CNMF_TPU_FLEET_WEDGE_POLLS", 3, lo=1)
        self.respawn_budget = env_int("CNMF_TPU_FLEET_RESPAWNS", 3, lo=0)
        self.warm_timeout_s = env_float("CNMF_TPU_FLEET_WARM_TIMEOUT_S",
                                        300.0, lo=1.0)
        self.retries = env_int("CNMF_TPU_FLEET_RETRIES", 2, lo=0)
        self.hedge_ms = env_float("CNMF_TPU_FLEET_HEDGE_MS", 0.0, lo=0.0)
        self.tenant_qps = env_float("CNMF_TPU_FLEET_TENANT_QPS", 0.0,
                                    lo=0.0)
        self.tenant_burst = env_float("CNMF_TPU_FLEET_TENANT_BURST", 0.0,
                                      lo=0.0)
        self.backoff_s = env_float("CNMF_TPU_WORKER_BACKOFF_S", 0.5,
                                   lo=0.0)
        if replica_factory is None:
            if run_dir is None:
                raise ValueError("need run_dir or replica_factory")

            def replica_factory(slot, ordinal, generation, spectra):
                return SubprocessReplica(
                    run_dir, slot, ordinal, generation,
                    spectra_path=spectra, k=k,
                    density_threshold=density_threshold,
                    device=self.device)

        self._factory = replica_factory
        self._spectra_path = spectra_path
        self._ordinals = itertools.count(0)
        # ring + slots + generation swap together under one lock: a
        # request either sees the whole old generation or the whole new
        # one, never a mix
        self._ring_lock = threading.Lock()
        self._ring = HashRing()
        self._slots = [_Slot(i) for i in range(self.n_replicas)]
        self._by_node: dict = {}  # ordinal -> replica (ring members)
        self._generation = 0
        self._rollover_lock = threading.Lock()
        # fleet-scoped admission state
        self._tenant_lock = threading.Lock()
        self._tenant_home: dict = {}
        self._strikes: dict = {}
        self._quarantined: set = set()
        self._buckets: dict = {}
        self._slo = obs_slo.tracker_from_env()
        self._stats = {"requests": 0, "ok": 0, "shed": 0, "poison": 0,
                       "quarantined": 0, "error": 0, "retries": 0,
                       "hedged": 0, "failovers": 0, "replica_deaths": 0,
                       "rollovers": 0}
        self._stats_lock = threading.Lock()
        self._req_seq = itertools.count(1)
        self._running = False
        self._supervisor: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------

    def start(self, supervise: bool = True):
        """Spawn the initial replica set, wait until every one answers
        ``/healthz`` (bounded by ``CNMF_TPU_FLEET_WARM_TIMEOUT_S``),
        and start the supervision loop."""
        self._running = True
        fresh = []
        for slot in self._slots:
            rep = self._factory(slot.index, next(self._ordinals),
                                self._generation, self._spectra_path)
            rep.start()
            slot.replica = rep
            fresh.append((slot, rep))
        deadline = time.monotonic() + self.warm_timeout_s
        for slot, rep in fresh:
            self._wait_healthy(rep, deadline)
            with self._ring_lock:
                self._ring.add(rep.ordinal)
                self._by_node[rep.ordinal] = rep
                slot.in_ring = True
        if supervise:
            t = threading.Thread(target=self._supervise_loop,
                                 name="cnmf-fleet-supervise", daemon=True)
            self._supervisor = t
            t.start()
        return self

    def _wait_healthy(self, rep, deadline: float):
        while True:
            if not rep.alive():
                raise ServeError(
                    f"replica {rep.ordinal} exited while warming "
                    f"(see its log)")
            try:
                rep.healthz(timeout=2.0)
                rep.ready_s = rep.uptime_s()
                return
            except (OSError, ValueError, ServeError):
                pass
            if time.monotonic() >= deadline:
                raise ServeError(
                    f"replica {rep.ordinal} not healthy within "
                    f"CNMF_TPU_FLEET_WARM_TIMEOUT_S="
                    f"{self.warm_timeout_s:g} s")
            time.sleep(0.1)

    def close(self):
        """Stop supervision, then drain-stop every replica."""
        self._running = False
        if self._supervisor is not None:
            self._supervisor.join(timeout=2 * self.health_s + 5.0)
            self._supervisor = None
        with self._ring_lock:
            reps = [s.replica for s in self._slots
                    if s.replica is not None]
            for s in self._slots:
                if s.replica is not None:
                    self._ring.remove(s.replica.ordinal)
                    self._by_node.pop(s.replica.ordinal, None)
                s.replica = None
                s.in_ring = False
        _drain(reps)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- supervision ---------------------------------------------------

    def _supervise_loop(self):
        while self._running:
            try:
                self._tick()
            except Exception:  # pragma: no cover - supervision must live
                pass
            time.sleep(self.health_s)

    def _tick(self):
        now = time.monotonic()
        for slot in self._slots:
            rep = slot.replica
            if rep is None:
                if (slot.attempts <= self.respawn_budget
                        and now >= slot.down_until and self._running):
                    self._respawn(slot)
                continue
            # injectable chaos (runtime/faults.py): kill or wedge a real
            # subprocess so the detection paths below run against the
            # genuine article, not a simulation of one
            if faults.maybe_replicadeath(context="fleet",
                                         worker=slot.index):
                rep.kill()
            elif faults.maybe_replicawedge(context="fleet",
                                           worker=slot.index):
                rep.kill(wedge=True)
            if not rep.alive():
                self._pronounce_dead(slot, "exit")
                continue
            if not slot.in_ring:
                # warming respawn: join the ring on first healthy poll
                try:
                    rep.healthz(timeout=2.0)
                except (OSError, ValueError, ServeError):
                    continue
                rep.ready_s = rep.uptime_s()
                with self._ring_lock:
                    self._ring.add(rep.ordinal)
                    self._by_node[rep.ordinal] = rep
                    slot.in_ring = True
                slot.healthz_fails = 0
                continue
            try:
                rep.healthz(timeout=max(2.0, 4 * self.health_s))
                slot.healthz_fails = 0
            except (OSError, ValueError, ServeError):
                slot.healthz_fails += 1
                # conviction needs BOTH kinds of evidence: healthz can
                # time out on a merely busy replica, but a busy replica
                # keeps stamping heartbeats from its dispatch loop — a
                # wedge (SIGSTOP, GIL spin) fails both
                hb_age = rep.heartbeat_age()
                hb_stale = hb_age is None or hb_age > max(
                    3.0, 4 * self.health_s)
                if slot.healthz_fails >= self.wedge_polls and hb_stale:
                    rep.kill()
                    if hasattr(rep, "reap"):
                        rep.reap(5.0)
                    self._pronounce_dead(slot, "wedge")

    def _pronounce_dead(self, slot, reason: str):
        rep = slot.replica
        with self._ring_lock:
            was_in_ring = slot.in_ring
            if was_in_ring:
                self._ring.remove(rep.ordinal)
                self._by_node.pop(rep.ordinal, None)
            slot.replica = None
            slot.in_ring = False
            slot.healthz_fails = 0
        with self._tenant_lock:
            displaced = sum(1 for home in self._tenant_home.values()
                            if home == rep.ordinal)
        with self._stats_lock:
            self._stats["replica_deaths"] += 1
            if was_in_ring:
                self._stats["failovers"] += 1
        if self.events is not None:
            extra = {}
            killed_at = getattr(rep, "killed_at", None)
            if killed_at is not None:
                # detection delay of an injected kill or wedge
                extra["since_kill_s"] = round(
                    time.monotonic() - killed_at, 3)
            self.events.emit("replica_death", replica=slot.index,
                             reason=reason, ordinal=rep.ordinal,
                             pid=rep.pid,
                             uptime_s=round(rep.uptime_s(), 3),
                             requests_served=rep.requests, **extra)
            if was_in_ring:
                self.events.emit("failover", replica=slot.index,
                                 tenants=displaced,
                                 survivors=len(self._ring))
        if hasattr(rep, "_cleanup"):
            rep._cleanup()
        slot.attempts += 1
        if slot.attempts <= self.respawn_budget:
            slot.down_until = time.monotonic() + respawn_delay(
                self.backoff_s, slot.attempts, slot.index)
        elif self.events is not None:
            # terminal: the slot stays down until a rollover rebuilds
            # the fleet — surfaced as its own death record so the
            # report's reason breakdown shows the budget ran out
            self.events.emit("replica_death", replica=slot.index,
                             reason="respawns_exhausted",
                             attempts=slot.attempts)

    def _respawn(self, slot):
        rep = self._factory(slot.index, next(self._ordinals),
                            self._generation, self._spectra_path)
        try:
            rep.start()
        except Exception:
            slot.attempts += 1
            slot.down_until = time.monotonic() + respawn_delay(
                self.backoff_s, slot.attempts, slot.index)
            if self.events is not None:
                self.events.emit("replica_death", replica=slot.index,
                                 reason="spawn_failed",
                                 ordinal=rep.ordinal)
            return
        slot.replica = rep
        slot.in_ring = False  # joins the ring on first healthy poll

    # -- request path --------------------------------------------------

    def handle_project(self, body: bytes, headers: dict
                       ) -> tuple[int, dict | bytes]:
        """Route one ``/project`` body: admission (quarantine, quota),
        consistent-hash candidates, bounded transport-failure retry with
        the same idempotency id, optional hedge. Returns ``(http_status,
        reply)`` where reply is raw bytes (pass-through) or a dict the
        caller JSON-encodes."""
        try:
            payload = json.loads(body or b"{}")
        except (ValueError, json.JSONDecodeError) as exc:
            return 400, {"ok": False, "status": "error",
                         "error": f"bad JSON body: {exc}"}
        tenant = str(payload.get("tenant", "default"))
        shape = payload.get("shape")
        n_cells = (int(shape[0]) if isinstance(shape, (list, tuple))
                   and shape else len(payload.get("data") or ()))
        with self._tenant_lock:
            quarantined = tenant in self._quarantined
        if quarantined:
            self._account(tenant, n_cells, "quarantined", None)
            return 403, {"ok": False, "status": "quarantined",
                         "error": f"tenant {tenant!r} is quarantined at "
                                  f"the fleet router after "
                                  f"{POISON_QUARANTINE_STRIKES} poison "
                                  f"inputs"}
        if self.tenant_qps > 0 and not self._bucket(tenant).allow():
            self._account(tenant, n_cells, "shed", None)
            return 429, {"ok": False, "status": "shed",
                         "error": f"tenant {tenant!r} is over its "
                                  f"admission quota "
                                  f"(CNMF_TPU_FLEET_TENANT_QPS="
                                  f"{self.tenant_qps:g}); retry with "
                                  f"backoff"}
        request_id = (headers.get(REQUEST_ID_HEADER)
                      or payload.get("request_id"))
        if request_id is None:
            # stamp one so OUR retries and hedges are idempotent even
            # for clients that did not opt in
            request_id = f"fleet-{os.getpid()}-{next(self._req_seq)}"
        fwd_headers = {"Content-Type": "application/json",
                       REQUEST_ID_HEADER: str(request_id)}
        trace = headers.get("X-CNMF-Trace")
        if trace:
            fwd_headers["X-CNMF-Trace"] = trace

        t0 = time.perf_counter()
        last_exc: Exception | None = None
        tried: set = set()
        for attempt in range(1 + self.retries):
            with self._ring_lock:
                order = [self._by_node[n]
                         for n in self._ring.candidates(tenant)
                         if n in self._by_node]
            order = [r for r in order if r.ordinal not in tried]
            if not order:
                break
            primary = order[0]
            backup = order[1] if len(order) > 1 else None
            with self._tenant_lock:
                self._tenant_home[tenant] = primary.ordinal
            try:
                status, blob, served_by = self._attempt(
                    primary, backup, body, fwd_headers)
            except OSError as exc:
                last_exc = exc
                tried.add(primary.ordinal)
                with self._stats_lock:
                    self._stats["retries"] += 1
                # deterministic bounded backoff before walking the ring
                time.sleep(min(0.25, 0.02 * (attempt + 1)))
                continue
            if status == 200:
                blob = self._stamp_generation(blob, served_by)
            self._finish(tenant, n_cells, status, blob, served_by,
                         (time.perf_counter() - t0) * 1e3)
            return status, blob
        self._account(tenant, n_cells, "error", None)
        self._slo_record((time.perf_counter() - t0) * 1e3, ok=False)
        return 503, {"ok": False, "status": "error",
                     "error": f"no replica reachable for tenant "
                              f"{tenant!r} after {1 + self.retries} "
                              f"attempt(s): {last_exc}"}

    def _stamp_generation(self, blob: bytes, served_by) -> bytes:
        """Stamp the serving replica's reference generation into the
        reply ``meta`` — during a rollover it is the client-visible
        answer to "which reference solved this?"."""
        try:
            reply = json.loads(blob)
            meta = reply.get("meta")
            if not isinstance(meta, dict):
                meta = reply["meta"] = {}
            meta["generation"] = served_by.generation
            return json.dumps(reply).encode("ascii")
        except (ValueError, TypeError, AttributeError):
            return blob

    def _attempt(self, primary, backup, body: bytes, headers: dict):
        """One routed attempt, optionally hedged: after
        ``CNMF_TPU_FLEET_HEDGE_MS`` without a reply the next distinct
        candidate gets a duplicate (same idempotency id — at most one
        solve) and the first answer wins."""
        if self.hedge_ms <= 0 or backup is None:
            status, blob = primary.forward(
                "POST", "/project", body, headers,
                timeout=self.forward_timeout_s)
            primary.requests += 1
            return status, blob, primary

        results: queue.Queue = queue.Queue()

        def run(rep):
            try:
                results.put((rep, rep.forward(
                    "POST", "/project", body, headers,
                    timeout=self.forward_timeout_s)))
            except Exception as exc:
                results.put((rep, exc))

        threading.Thread(target=run, args=(primary,), daemon=True).start()
        hedged = False
        outstanding = 1
        try:
            rep, out = results.get(timeout=self.hedge_ms / 1e3)
            outstanding -= 1
        except queue.Empty:
            hedged = True
            with self._stats_lock:
                self._stats["hedged"] += 1
            threading.Thread(target=run, args=(backup,),
                             daemon=True).start()
            outstanding += 1
            rep, out = results.get()
            outstanding -= 1
        if isinstance(out, Exception) and hedged and outstanding:
            # the loser may still deliver — prefer any real reply over
            # surfacing the first transport error
            rep, out = results.get()
            outstanding -= 1
        if isinstance(out, Exception):
            raise out if isinstance(out, OSError) else OSError(str(out))
        rep.requests += 1
        return out[0], out[1], rep

    def _finish(self, tenant: str, n_cells: int, status: int,
                blob: bytes, served_by, total_ms: float):
        """Account a replica's verdict fleet-side: counters, SLO,
        telemetry, and the fleet-scoped poison strikes."""
        if status == 200:
            self._account(tenant, n_cells, "ok", served_by,
                          total_ms=round(total_ms, 3))
            self._slo_record(total_ms, ok=True)
            return
        verdict = "error"
        try:
            verdict = str(json.loads(blob).get("status", "error"))
        except (ValueError, AttributeError):
            pass
        if verdict == "poison":
            with self._tenant_lock:
                strikes = self._strikes.get(tenant, 0) + 1
                self._strikes[tenant] = strikes
                if strikes >= POISON_QUARANTINE_STRIKES:
                    self._quarantined.add(tenant)
        elif verdict == "quarantined":
            # the replica already convicted this tenant — adopt the
            # verdict fleet-wide so its failover target never re-learns
            with self._tenant_lock:
                self._quarantined.add(tenant)
        self._account(tenant, n_cells, verdict, served_by)
        self._slo_record(total_ms, ok=False)

    def _account(self, tenant: str, n_cells: int, status: str,
                 served_by, **fields):
        key = status if status in ("ok", "shed", "poison", "quarantined",
                                   "error") else "error"
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats[key] += 1
        obs_metrics.counter_inc("cnmf_fleet_requests_total", status=key)
        if self.events is not None:
            if served_by is not None:
                fields["replica"] = served_by.slot
                fields["ordinal"] = served_by.ordinal
            self.events.emit("serve_request", tenant=tenant,
                             n_cells=int(n_cells), status=status,
                             **fields)

    def _bucket(self, tenant: str) -> TokenBucket:
        with self._tenant_lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(self.tenant_qps,
                                     self.tenant_burst or None)
                self._buckets[tenant] = bucket
            return bucket

    def _slo_record(self, latency_ms: float, ok: bool):
        if self._slo is not None:
            self._slo.record(latency_ms, ok=ok)

    # -- rollover ------------------------------------------------------

    def handle_rollover(self, payload: dict) -> tuple[int, dict]:
        """Zero-downtime reference rollover: warm a fresh replica set
        against the new spectra, swap the ring atomically, drain-stop
        the old generation. The old generation keeps serving until the
        instant of the swap; on ANY warm failure it keeps serving,
        untouched."""
        spectra = payload.get("spectra")
        if not spectra:
            return 400, {"ok": False, "error":
                         "rollover needs {\"spectra\": <path or shard "
                         "store>}"}
        if not self._rollover_lock.acquire(blocking=False):
            return 409, {"ok": False, "error":
                         "a rollover is already in progress"}
        t0 = time.monotonic()
        try:
            new_gen = self._generation + 1
            fresh = []
            try:
                for i in range(self.n_replicas):
                    rep = self._factory(i, next(self._ordinals), new_gen,
                                        spectra)
                    rep.start()
                    fresh.append(rep)
                deadline = time.monotonic() + self.warm_timeout_s
                for rep in fresh:
                    self._wait_healthy(rep, deadline)
            except Exception as exc:
                for rep in fresh:
                    rep.kill()
                    if hasattr(rep, "reap"):
                        rep.reap(5.0)
                    if hasattr(rep, "_cleanup"):
                        rep._cleanup()
                return 500, {"ok": False, "error":
                             f"rollover aborted (old reference still "
                             f"serving): {exc}"}
            # atomic swap: requests admitted after this block route to
            # the new generation; requests already forwarded ride their
            # open connections and the old daemons' shutdown drain
            with self._ring_lock:
                old = [s.replica for s in self._slots
                       if s.replica is not None]
                self._ring = HashRing(r.ordinal for r in fresh)
                self._by_node = {r.ordinal: r for r in fresh}
                self._slots = [_Slot(i) for i in range(self.n_replicas)]
                for slot, rep in zip(self._slots, fresh):
                    slot.replica = rep
                    slot.in_ring = True
                self._generation = new_gen
                self._spectra_path = spectra  # respawns load the new ref
            _drain(old)
            wall = time.monotonic() - t0
            with self._stats_lock:
                self._stats["rollovers"] += 1
            if self.events is not None:
                self.events.emit("rollover", generation=new_gen,
                                 wall_s=round(wall, 3),
                                 replicas=self.n_replicas,
                                 spectra=str(spectra))
            return 200, {"ok": True, "generation": new_gen,
                         "wall_s": round(wall, 3),
                         "replicas": self.n_replicas}
        finally:
            self._rollover_lock.release()

    # -- introspection -------------------------------------------------

    def healthz(self) -> tuple[int, dict]:
        with self._ring_lock:
            up = len(self._ring)
            total = len(self._slots)
            gen = self._generation
        reply = {"ok": up > 0, "generation": gen, "replicas_up": up,
                 "replicas": total}
        if self._slo is not None:
            verdict = self._slo.evaluate()
            reply["slo"] = verdict
            reply["degraded"] = bool(verdict.get("burning"))
        return (200 if up > 0 else 503), reply

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        with self._ring_lock:
            out["generation"] = self._generation
            out["replicas_up"] = len(self._ring)
            out["replicas"] = [
                {"slot": s.index,
                 "ordinal": (s.replica.ordinal
                             if s.replica is not None else None),
                 "in_ring": s.in_ring,
                 "pid": (s.replica.pid if s.replica is not None
                         else None),
                 "requests": (s.replica.requests
                              if s.replica is not None else 0),
                 # spawn to first healthy poll (the warm budget's reading)
                 "ready_s": (getattr(s.replica, "ready_s", None)
                             if s.replica is not None else None),
                 "respawn_attempts": s.attempts}
                for s in self._slots]
        with self._tenant_lock:
            out["quarantined_tenants"] = sorted(self._quarantined)
            out["tenants"] = len(self._tenant_home)
        if self._slo is not None:
            out["slo"] = self._slo.evaluate()
        return out

    def metrics_text(self) -> str:
        return obs_metrics.render_text()


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

class _FleetHandler(_JsonHandler):

    @property
    def router(self) -> FleetRouter:
        return self.server.router

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(*self.router.healthz())
        elif self.path == "/stats":
            self._reply(200, {"ok": True, "stats": self.router.stats()})
        elif self.path == "/metrics":
            self._reply_text(200, self.router.metrics_text())
        else:
            self._no_route()

    def do_POST(self):
        if self.path == "/shutdown":
            self._shutdown_reply()
            return
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length) if length else b""
        if self.path == "/project":
            status, reply = self.router.handle_project(
                body, dict(self.headers.items()))
            self._reply(status, reply)
        elif self.path == "/rollover":
            try:
                payload = json.loads(body or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                self._reply(400, {"ok": False, "error": str(exc)})
                return
            self._reply(*self.router.handle_rollover(payload))
        else:
            self._no_route()


class FleetDaemon:
    """The router behind one HTTP endpoint, the fleet's single front door
    (unix socket, or 127.0.0.1 TCP with ``port``). The serve daemon's
    drain-accounted server: close() stops accepting, lets accepted
    requests finish, then stops the router and its replicas."""

    def __init__(self, router: FleetRouter,
                 socket_path: str | None = None, port: int | None = None):
        self.router = router
        self.server, self.socket_path = _bind(_FleetHandler, socket_path,
                                              port)
        self.server.router = router
        self._thread = None
        self._closed = False

    @property
    def address(self) -> str:
        return _server_address(self.server, self.socket_path)

    def start(self):
        self.router.start()
        t = threading.Thread(target=self.server.serve_forever,
                             name="cnmf-fleet-http", daemon=True)
        self._thread = t
        t.start()
        return self

    def serve_forever(self):
        """Serve on this thread until the server is shut down (another
        thread's ``server.shutdown()``), then :meth:`close`, which stops
        the router. The router is started by the caller, as in the JAX
        package."""
        try:
            self.server.serve_forever()
        finally:
            self.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        _close_server(self.server, self.socket_path, self._thread,
                      self.router.close)
        self._thread = None


class FleetClient(ServeClient):
    """The serve client plus the fleet's control surface."""

    def rollover(self, spectra: str) -> dict:
        """Trigger a zero-downtime reference rollover; returns the
        router's verdict (raises :class:`ServeError` on failure)."""
        status, data = self._request("POST", "/rollover",
                                     {"spectra": str(spectra)})
        if status != 200 or not data.get("ok"):
            raise ServeError(data.get("error", f"rollover: HTTP "
                                               f"{status}"))
        return data


def fleet_forever(run_dir: str, replicas: int | None = None,
                  k: int | None = None, density_threshold=None,
                  spectra_path: str | None = None,
                  socket_path: str | None = None,
                  port: int | None = None, device="cuda"):
    """The ``fleet <run_dir>`` entry: spawn and front N ``serve`` replicas
    on ``device`` (default ``"cuda"``; every replica runs there) until
    SIGINT/SIGTERM (clean close: replicas drain-stopped, sockets
    removed)."""
    from ..device import resolve_device
    from ..utils.telemetry import EventLog
    from .reference import load_reference

    dev = resolve_device(device)
    name = os.path.basename(os.path.normpath(run_dir))
    events = EventLog(
        os.path.join(run_dir, "cnmf_tmp", name + ".fleet.events.jsonl"),
        manifest_extra={"run_name": name, "role": "fleet"}, device=dev)
    # resolve the reference now, so a bad run_dir/k/spectra fails here
    # once instead of N times in replica logs
    load_reference(run_dir, k=k, density_threshold=density_threshold,
                   spectra_path=spectra_path)
    router = FleetRouter(run_dir, replicas=replicas,
                         spectra_path=spectra_path, k=k,
                         density_threshold=density_threshold,
                         events=events, device=str(device))
    if port is None and socket_path is None:
        socket_path = default_fleet_socket_path(run_dir)
    daemon = FleetDaemon(router, socket_path=socket_path, port=port)
    prev = install_stop_signals(daemon.server.shutdown)
    print(f"fleet: spawning {router.n_replicas} serve replica(s) for "
          f"{name} on {dev} ...", flush=True)
    try:
        router.start()
        print(f"fleet: routing on {daemon.address} (generation "
              f"{router._generation}, {len(router._ring)} replica(s) up)",
              flush=True)
        t = threading.Thread(target=daemon.server.serve_forever,
                             name="cnmf-fleet-http", daemon=True)
        daemon._thread = t
        t.start()
        while t.is_alive():
            t.join(timeout=1.0)
    finally:
        daemon.close()
        restore_signals(prev)
    return 0
