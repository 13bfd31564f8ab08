"""An HTTP object-store fixture: the stand-in for a cloud object store.

Own copy of ``cnmf_torch_tpu/utils/netstore.py`` (standard library only):
an in-memory object store, ``http.server`` on a background thread, that
the remote shard-store backend (``utils/storebackend.py``) speaks to in
the tests and in ``chip_smoke.py``. One server hosts many stores: object
names are flat URL paths under any prefix
(``/run1/cnmf.norm_counts.store/slab_00000.npz``).

Verbs:

  * ``GET /name`` -- 200 and the body; ``Range: bytes=a-b`` -> 206 and the
    slice;
  * ``GET /prefix/?list=1`` -- 200 and a JSON array of the object names
    under the prefix (relative);
  * ``GET /metrics`` -- 200 and this process's metrics registry as text
    (``obs/metrics.py``; a "disabled" banner unless
    ``CNMF_TPU_METRICS=1``). An object named ``metrics`` is shadowed;
  * ``PUT /name`` -- 201, the body stored verbatim;
  * ``HEAD /name`` -- 200 with Content-Length, or 404;
  * ``DELETE /name`` -- 204, or 404.

Network faults are not injected here: the client fires them
(``runtime/faults.py:maybe_netfault``) before its socket opens, so one
server serves every scenario. The server is threaded (hedged reads hit it
concurrently) with daemon workers; ``stop()`` joins the serve loop, so no
thread outlives it.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import metrics as obs_metrics

__all__ = ["ObjectStoreServer"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # self.server is the ObjectStoreServer below (objects + lock)

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # tests assert on pipeline output, not request logs

    def _key(self) -> str:
        return urllib.parse.unquote(
            urllib.parse.urlsplit(self.path).path).lstrip("/")

    def _send(self, code: int, body: bytes = b"",
              content_type: str = "application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def do_GET(self):
        parts = urllib.parse.urlsplit(self.path)
        query = urllib.parse.parse_qs(parts.query)
        if parts.path == "/metrics" and not query:
            self._send(200, obs_metrics.render_text().encode("utf-8"),
                       content_type="text/plain; charset=utf-8")
            return
        obs_metrics.counter_inc("cnmf_netstore_requests_total",
                                verb="get")
        if query.get("list"):
            prefix = urllib.parse.unquote(parts.path).lstrip("/")
            if prefix and not prefix.endswith("/"):
                prefix += "/"
            with self.server.lock:
                names = sorted(k[len(prefix):] for k in self.server.objects
                               if k.startswith(prefix))
            self._send(200, json.dumps(names).encode("utf-8"),
                       content_type="application/json")
            return
        key = self._key()
        with self.server.lock:
            body = self.server.objects.get(key)
        if body is None:
            self._send(404)
            return
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo_s, _, hi_s = rng[len("bytes="):].partition("-")
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) + 1 if hi_s else len(body)
            part = body[lo:hi]
            self.send_response(206)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Range", "bytes %d-%d/%d"
                             % (lo, lo + len(part) - 1, len(body)))
            self.send_header("Content-Length", str(len(part)))
            self.end_headers()
            self.wfile.write(part)
            return
        self._send(200, body)

    def do_HEAD(self):
        obs_metrics.counter_inc("cnmf_netstore_requests_total",
                                verb="head")
        key = self._key()
        with self.server.lock:
            body = self.server.objects.get(key)
        if body is None:
            self._send(404)
        else:
            self._send(200, body)  # _send skips the body for HEAD

    def do_PUT(self):
        obs_metrics.counter_inc("cnmf_netstore_requests_total",
                                verb="put")
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)
        with self.server.lock:
            self.server.objects[self._key()] = body
        self._send(201)

    def do_DELETE(self):
        obs_metrics.counter_inc("cnmf_netstore_requests_total",
                                verb="delete")
        with self.server.lock:
            existed = self.server.objects.pop(self._key(), None) is not None
        self._send(204 if existed else 404)


class ObjectStoreServer(ThreadingHTTPServer):
    """``with ObjectStoreServer() as srv: ... srv.url ...`` — binds
    127.0.0.1 on an ephemeral port (``port=0``), serves on a background
    thread until ``stop()``/``__exit__``. ``objects`` maps flat names
    to bytes; mutate it directly to seed or corrupt fixtures."""

    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _Handler)
        self.objects: dict = {}
        self.lock = threading.Lock()
        self._thread = None

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return "http://%s:%d" % (host, port)

    def start(self) -> "ObjectStoreServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="cnmf-netstore", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.server_close()

    def __enter__(self) -> "ObjectStoreServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
