"""The projection daemon's HTTP front end.

Stdlib HTTP/JSON over a 127.0.0.1 TCP port or (the default) a unix domain
socket next to the run's artifacts: no open network surface unless asked
for. One daemon serves one resident reference from one device; concurrent
client connections are handled by a threading server whose request
threads all feed the ONE micro-batching dispatcher (``batcher.py``), which
is how N racing clients become one batched device solve.

Protocol (all bodies JSON), the JAX package's wire format:

  * ``POST /project`` — ``{"tenant": "...", "data": [[...]]}`` or
    ``{"tenant": "...", "shape": [n, g], "b64": "<base64 f32
    row-major>"}``. Success: ``{"ok": true, "shape": [n, k], "b64" |
    "usage": ..., "meta": {...}}`` (the reply mirrors the request's
    encoding). Errors carry ``{"ok": false, "status", "error"}`` with
    HTTP 429 (shed), 422 (poison), 403 (quarantined), 400 (bad request).
  * ``GET /healthz`` — liveness + resident-reference summary; with the
    SLO tracker armed (``CNMF_TPU_SLO_P99_MS``) the reply carries the
    windowed verdict and ``"degraded": true`` while the SLO burns.
  * ``GET /reference`` — the reference's description with its gene order.
  * ``GET /stats`` — serving counters + latency summary.
  * ``GET /metrics`` — text exposition of the metrics registry (a
    "disabled" banner unless ``CNMF_TPU_METRICS=1``).
  * ``POST /shutdown`` — clean stop WITH drain: the accept loop closes
    first, then every accepted request finishes before the batcher stops
    and the socket file is removed, bounded by ``CNMF_TPU_SERVE_DRAIN_S``
    (default 30 s). The fleet's zero-downtime rollover relies on it.

Idempotent retries: a client may stamp ``X-CNMF-Request-Id`` (or payload
key ``"request_id"``); resubmitting the same id returns the original
solve's reply instead of solving again. Tracing: a sampled client sends
``X-CNMF-Trace: <trace>:<span>`` and the daemon threads a child context
through admission, queue, linger and dispatch as ``span`` events.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from ..utils.envknobs import env_float
from .batcher import (PoisonError, ProjectionService, QuarantinedError,
                      ServeError, ShedError)

__all__ = ["ServeDaemon", "ServeClient", "serve_forever",
           "default_socket_path", "REQUEST_ID_HEADER"]

# client-chosen idempotency key: same id -> at most one solve (the payload
# key "request_id" is equivalent; the header wins when both are set)
REQUEST_ID_HEADER = "X-CNMF-Request-Id"

_STATUS_HTTP = {"shed": 429, "poison": 422, "quarantined": 403,
                "error": 400}


def default_socket_path(run_dir: str) -> str:
    name = os.path.basename(os.path.normpath(run_dir))
    return os.path.join(run_dir, "cnmf_tmp", name + ".serve.sock")


def _decode_matrix(payload: dict) -> np.ndarray:
    if "b64" in payload:
        shape = payload.get("shape")
        if (not isinstance(shape, (list, tuple)) or len(shape) != 2):
            raise ValueError("b64 requests need \"shape\": [n, g]")
        raw = base64.b64decode(payload["b64"])
        n, g = int(shape[0]), int(shape[1])
        if len(raw) != n * g * 4:
            raise ValueError(
                f"b64 payload is {len(raw)} bytes; shape {n}x{g} needs "
                f"{n * g * 4} (f32 row-major)")
        return np.frombuffer(raw, np.float32).reshape(n, g)
    if "data" in payload:
        return np.asarray(payload["data"], dtype=np.float32)
    raise ValueError("request needs \"data\" (nested lists) or "
                     "\"b64\" + \"shape\"")


def _encode_matrix(H: np.ndarray, like: dict) -> dict:
    if "b64" in like:
        return {"shape": list(H.shape),
                "b64": base64.b64encode(
                    np.ascontiguousarray(H, np.float32).tobytes()
                ).decode("ascii")}
    return {"shape": list(H.shape), "usage": H.tolist()}


class _JsonHandler(BaseHTTPRequestHandler):
    """Shared reply helpers of the serve and fleet handlers."""

    protocol_version = "HTTP/1.1"

    # the daemon's own telemetry covers request accounting; stderr access
    # logs would interleave with the pipeline's prints
    def log_message(self, fmt, *args):  # noqa: D401 - BaseHTTP override
        pass

    def _reply(self, code: int, obj):
        body = (obj if isinstance(obj, bytes)
                else json.dumps(obj).encode("utf-8"))
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, text: str):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _no_route(self):
        self._reply(404, {"ok": False, "error": f"no route {self.path!r}"})

    def _shutdown_reply(self):
        self._reply(200, {"ok": True, "stopping": True})
        threading.Thread(target=self.server.shutdown, daemon=True).start()


class _Handler(_JsonHandler):

    @property
    def service(self) -> ProjectionService:
        return self.server.service

    def do_GET(self):
        if self.path == "/healthz":
            reply = {"ok": True,
                     "reference": self.service.reference.describe()}
            slo = self.service.slo_status()
            if slo is not None:
                reply["slo"] = slo
                reply["degraded"] = bool(slo.get("burning"))
            self._reply(200, reply)
        elif self.path == "/reference":
            ref = self.service.reference
            self._reply(200, dict(
                ref.describe(),
                genes=None if ref.genes is None else
                [str(g) for g in ref.genes],
                components=[str(c) for c in ref.components]))
        elif self.path == "/stats":
            self._reply(200, {"ok": True, "stats": self.service.stats()})
        elif self.path == "/metrics":
            self._reply_text(200, self.service.metrics_text())
        else:
            self._no_route()

    def do_POST(self):
        if self.path == "/shutdown":
            self._shutdown_reply()
            return
        if self.path != "/project":
            self._no_route()
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            X = _decode_matrix(payload)
        except (ValueError, json.JSONDecodeError) as exc:
            self._reply(400, {"ok": False, "status": "error",
                              "error": str(exc)})
            return
        tenant = str(payload.get("tenant", "default"))
        request_id = (self.headers.get(REQUEST_ID_HEADER)
                      or payload.get("request_id"))
        if request_id is not None:
            request_id = str(request_id)
        # the client's sampled context arrives in the trace header;
        # everything the daemon does for this request nests under one
        # serve.http child span
        ctx = obs_tracing.from_header(
            self.headers.get(obs_tracing.TRACE_HEADER))
        hctx = obs_tracing.child(ctx)
        with obs_tracing.span(self.service.events, hctx, "serve.http",
                              tenant=tenant, n_cells=int(X.shape[0])):
            try:
                H, meta = self.service.project(X, tenant=tenant,
                                               trace=hctx,
                                               request_id=request_id)
            except ServeError as exc:
                self._reply(_STATUS_HTTP.get(exc.status, 400),
                            {"ok": False, "status": exc.status,
                             "error": str(exc)})
                return
            self._reply(200, dict({"ok": True, "meta": meta},
                                  **_encode_matrix(H, payload)))


class _DrainMixin:
    """Connection-accounted threading server.

    ``daemon_threads = True`` means ``server_close()`` does NOT join
    handler threads, so a bare shutdown races them and an accepted
    request can be lost. Every accepted connection is counted in
    ``process_request`` (which runs IN the accept loop, in step with
    ``shutdown()``) and uncounted when its handler thread finishes; after
    ``shutdown()`` returns, :meth:`wait_drained` blocks until the count
    reaches zero before the service underneath is torn down.
    """

    def __init__(self, *args, **kwargs):
        self.inflight = 0
        self._inflight_cv = threading.Condition()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._inflight_cv:
            self.inflight += 1
        try:
            super().process_request(request, client_address)
        except Exception:
            # the handler thread never spawned; give its count back
            with self._inflight_cv:
                self.inflight -= 1
                self._inflight_cv.notify_all()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._inflight_cv:
                self.inflight -= 1
                self._inflight_cv.notify_all()

    def wait_drained(self, timeout: float) -> bool:
        """Block until every accepted connection finished handling, or
        ``timeout`` seconds elapsed. Returns whether the drain
        completed."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._inflight_cv:
            while self.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True


class _TCPHTTPServer(_DrainMixin, ThreadingHTTPServer):
    pass


class _UnixHTTPServer(_DrainMixin, ThreadingHTTPServer):
    address_family = socket.AF_UNIX

    def server_bind(self):
        # HTTPServer.server_bind unpacks (host, port); a unix address is
        # a path
        socketserver.TCPServer.server_bind(self)
        self.server_name = "localhost"
        self.server_port = 0


def _bind(handler, socket_path: str | None, port: int | None):
    """A drain-accounted server on ``127.0.0.1:port`` or a unix socket
    (a stale socket file from a crashed daemon is replaced: a live daemon
    keeps its inode and its open connections). Returns ``(server,
    socket_path or None)``."""
    if port is not None:
        server = _TCPHTTPServer(("127.0.0.1", int(port)), handler)
        socket_path = None
    else:
        if socket_path is None:
            raise ValueError("need socket_path or port")
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        server = _UnixHTTPServer(socket_path, handler)
    server.daemon_threads = True
    return server, socket_path


def _server_address(server, socket_path) -> str:
    if socket_path:
        return socket_path
    host, port = server.server_address[:2]
    return f"{host}:{port}"


def _close_server(server, socket_path, thread, stop_inner):
    """Stop accepting, drain accepted requests (bounded by
    ``CNMF_TPU_SERVE_DRAIN_S``), stop what is underneath, close the
    listener and remove the socket file."""
    server.shutdown()
    drain_s = env_float("CNMF_TPU_SERVE_DRAIN_S", 30.0, lo=0.0)
    if not server.wait_drained(drain_s):
        print(f"serve: shutdown drain timed out after {drain_s:g} s with "
              f"{server.inflight} connection(s) still open "
              f"(CNMF_TPU_SERVE_DRAIN_S)")
    stop_inner()
    server.server_close()
    if socket_path and os.path.exists(socket_path):
        try:
            os.unlink(socket_path)
        except OSError:
            pass
    if thread is not None:
        thread.join(timeout=10)


class ServeDaemon:
    """One resident reference behind one HTTP endpoint.

    ``socket_path`` binds a unix domain socket; ``port`` binds
    ``127.0.0.1:port`` instead (0 picks a free port). Call
    :meth:`serve_forever` (blocking) or :meth:`start` (background thread).
    :meth:`close` drains, stops the batcher, closes the server and
    removes the socket file.
    """

    def __init__(self, service: ProjectionService,
                 socket_path: str | None = None, port: int | None = None):
        self.service = service
        self.server, self.socket_path = _bind(_Handler, socket_path, port)
        self.server.service = service
        self._thread = None
        self._closed = False

    @property
    def address(self) -> str:
        return _server_address(self.server, self.socket_path)

    def start(self):
        self.service.start()
        t = threading.Thread(target=self.server.serve_forever,
                             name="cnmf-serve-http", daemon=True)
        self._thread = t
        t.start()
        return self

    def serve_forever(self):
        self.service.start()
        try:
            self.server.serve_forever()
        finally:
            self.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        # stop ACCEPTING first, let every accepted request reach its real
        # reply (the service is still up), then stop the batcher
        _close_server(self.server, self.socket_path, self._thread,
                      self.service.close)
        self._thread = None


class _UnixHTTPConnection(HTTPConnection):
    def __init__(self, path: str, timeout=None):
        super().__init__("localhost", timeout=timeout)
        self._unix_path = path

    def connect(self):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if self.timeout is not None:
            s.settimeout(self.timeout)
        s.connect(self._unix_path)
        self.sock = s


class ServeClient:
    """Minimal stdlib client for the daemon. One connection per call."""

    def __init__(self, socket_path: str | None = None,
                 host: str = "127.0.0.1", port: int | None = None,
                 timeout: float = 180.0, events=None):
        if socket_path is None and port is None:
            raise ValueError("need socket_path or port")
        self.socket_path = socket_path
        self.host, self.port = host, port
        self.timeout = timeout
        # optional EventLog: a traced client writes its own client.request
        # root span beside the daemon's spans
        self.events = events

    def _request(self, method: str, path: str, payload: dict | None = None,
                 headers: dict | None = None, raw: bool = False,
                 body: bytes | None = None):
        if self.socket_path:
            conn = _UnixHTTPConnection(self.socket_path,
                                       timeout=self.timeout)
        else:
            conn = HTTPConnection(self.host, self.port,
                                  timeout=self.timeout)
        try:
            if body is None and payload is not None:
                body = json.dumps(payload).encode("utf-8")
            hdrs = dict(headers or {})
            if body:
                hdrs["Content-Type"] = "application/json"
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            blob = resp.read()
            if raw:
                return resp.status, blob.decode("utf-8", "replace")
            return resp.status, json.loads(blob or b"{}")
        finally:
            conn.close()

    def project(self, X, tenant: str = "default",
                encoding: str = "b64", request_id: str | None = None):
        """Project ``X`` (n x genes) onto the resident reference; returns
        ``(usage (n, k) ndarray, meta dict)``. Raises the matching
        :class:`ServeError` subclass on a daemon-side error. With
        ``CNMF_TPU_TRACE_SAMPLE`` > 0 a sampled call carries the trace
        header; ``request_id`` stamps the idempotency header."""
        X = np.ascontiguousarray(np.asarray(X), dtype=np.float32)
        payload: dict = {"tenant": tenant}
        body = None
        if encoding == "b64":
            payload["shape"] = list(X.shape)
            # the b64 member is spliced in as bytes: the same JSON without
            # a second pass of the encoder over the whole matrix
            head = json.dumps(payload)[:-1] + ', "b64": "'
            body = (head.encode("ascii") + base64.b64encode(X.tobytes())
                    + b'"}')
        else:
            payload["data"] = X.tolist()
        ctx = obs_tracing.new_trace()
        headers = ({obs_tracing.TRACE_HEADER: obs_tracing.header_value(ctx)}
                   if ctx is not None else None)
        if request_id is not None:
            headers = dict(headers or {})
            headers[REQUEST_ID_HEADER] = str(request_id)
        with obs_tracing.span(self.events, ctx, "client.request",
                              tenant=tenant):
            status, data = self._request("POST", "/project", payload,
                                         headers=headers, body=body)
        if status != 200 or not data.get("ok"):
            err = {"shed": ShedError, "poison": PoisonError,
                   "quarantined": QuarantinedError}.get(
                data.get("status"), ServeError)
            raise err(data.get("error", f"HTTP {status}"))
        if "b64" in data:
            H = np.frombuffer(base64.b64decode(data["b64"]),
                              np.float32).reshape(data["shape"])
        else:
            H = np.asarray(data["usage"], dtype=np.float32)
        return H, data.get("meta", {})

    def _get(self, path: str) -> dict:
        status, data = self._request("GET", path)
        if status != 200:
            raise ServeError(f"{path.lstrip('/')}: HTTP {status}: {data}")
        return data

    def healthz(self) -> dict:
        return self._get("/healthz")

    def reference(self) -> dict:
        return self._get("/reference")

    def stats(self) -> dict:
        return self._get("/stats")["stats"]

    def metrics(self) -> str:
        """The daemon's ``GET /metrics`` text exposition, verbatim."""
        status, text = self._request("GET", "/metrics", raw=True)
        if status != 200:
            raise ServeError(f"metrics: HTTP {status}: {text}")
        return text

    def shutdown(self):
        status, data = self._request("POST", "/shutdown")
        return status == 200


def install_stop_signals(stop) -> dict:
    """Route SIGINT/SIGTERM to ``stop`` (in a thread, so the handler never
    blocks the accept loop); returns the previous handlers for
    :func:`restore_signals`. Off the main thread (tests) nothing is
    installed."""
    import signal

    def _stop(signum, frame):
        threading.Thread(target=stop, daemon=True).start()

    prev = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev[sig] = signal.signal(sig, _stop)
        except ValueError:
            pass
    return prev


def restore_signals(prev: dict):
    import signal

    for sig, handler in prev.items():
        try:
            signal.signal(sig, handler)
        except ValueError:
            pass


def serve_forever(run_dir: str, k: int | None = None,
                  density_threshold=None, spectra_path: str | None = None,
                  socket_path: str | None = None, port: int | None = None,
                  replica: int = 0, device="cuda"):
    """The ``serve <run_dir>`` entry: load the reference, stage it on
    ``device`` (default ``"cuda"``; raises without a card unless asked for
    ``"cpu"``), warm the buckets, bind, and serve until SIGINT/SIGTERM
    (clean close: batcher drained, socket removed). ``replica`` is the
    fleet router's ordinal: it keys this daemon's heartbeat file and
    events stream so N replicas of one run directory never collide."""
    from ..device import resolve_device
    from ..runtime.elastic import Heartbeat
    from ..utils.telemetry import EventLog
    from .reference import load_reference

    dev = resolve_device(device)
    name = os.path.basename(os.path.normpath(run_dir))
    replica = int(replica)
    leaf = (name + ".events.jsonl" if replica == 0
            else f"{name}.r{replica}.events.jsonl")
    events = EventLog(
        os.path.join(run_dir, "cnmf_tmp", leaf),
        manifest_extra={"run_name": name, "role": "serve",
                        "replica": replica}, device=dev)
    ref = load_reference(run_dir, k=k, density_threshold=density_threshold,
                         spectra_path=spectra_path)

    liveness = None
    hb = Heartbeat(os.path.join(run_dir, "cnmf_tmp"), name + ".serve",
                   replica, events=events)
    if hb.enabled:
        liveness = hb.beat

    service = ProjectionService(ref, device=dev, events=events,
                                liveness=liveness)
    if port is None and socket_path is None:
        socket_path = default_socket_path(run_dir)
    daemon = ServeDaemon(service, socket_path=socket_path, port=port)

    # periodic metrics_snapshot events (plus one at shutdown) carrying the
    # registry state and the SLO verdict
    snapshotter = None
    if obs_metrics.metrics_enabled() and events.enabled:
        snapshotter = obs_metrics.Snapshotter(
            events, interval_s=30.0,
            slo_fn=lambda: service.slo_status(refresh_metrics=True))
        snapshotter.start()

    prev = install_stop_signals(daemon.server.shutdown)
    print(f"serve: reference k={ref.k} x {ref.n_genes} genes "
          f"(beta={ref.beta:g}) from {ref.source} on {dev}", flush=True)
    try:
        service.start()
        print(f"serve: listening on {daemon.address} (buckets "
              f"{list(service.buckets)}, batch <= {service.max_batch} "
              f"lanes, linger {service.linger_s * 1e3:g} ms, warmup "
              f"{service.warmup_s:.3f} s)", flush=True)
        daemon.serve_forever()
    finally:
        if snapshotter is not None:
            snapshotter.stop()
        daemon.close()
        # one perf_model event over the whole session, after close so
        # every dispatch is in the accounting
        try:
            service.emit_perf_model()
        except Exception:
            pass
        restore_signals(prev)
    return 0
