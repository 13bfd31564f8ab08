"""Shard-store transport backends: a local directory or a remote object
store.

Own copy of ``cnmf_torch_tpu/utils/storebackend.py``:

  * :class:`StoreBackend` -- the five-verb contract (``get``/``put``/
    ``exists``/``list``/``delete``) that ``utils/shardstore.py`` reads and
    writes through. Digest validation, the manifest-last protocol and
    torn-read healing stay above this seam, in the shard store.
  * :class:`LocalBackend` -- the POSIX store directory: plain reads;
    writes land through an atomic same-directory rename whose temp name
    carries ``.tmp-<pid>``, as the JAX package's do, so either package's
    temp sweep finds the other's debris.
  * :class:`RemoteBackend` -- HTTP GET/PUT/HEAD/DELETE against an object
    store (``utils/netstore.py`` is the in-repo fixture): per-operation
    timeouts, bounded exponential backoff with a deterministic jitter
    (a fault run replays exactly, and the jitter equals the JAX
    package's to the bit), hedged reads (``CNMF_TPU_STORE_HEDGE_S``) and
    a read-through cache at ``<store>.cache`` (LRU under
    ``CNMF_TPU_STORE_CACHE_BYTES``, each entry with a sha1 sidecar and
    revalidated on every hit).

Degradation: a transient fault heals (a ``fault`` event of kind
``store_net`` with ``healed: true``); a remote that is down serves
digest-valid cached objects with one loud warning a run; an object that
can be neither fetched nor served from the cache raises
:class:`RemoteStoreError`, a ``RuntimeError`` and not an ``OSError``, so
it escapes the shard reader's torn-read re-reads (they would hit the same
dead network) and reaches the resilience ledger as ``remote_store``.

``CNMF_TPU_STORE_URI``: unset keeps the store at its own path;
``file:///base`` relocates it under ``base/<leaf>``;
``http(s)://host:port/prefix`` puts it under ``prefix/<leaf>`` of the
object store, with its cache beside the local store path.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import warnings

from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from .envknobs import env_float, env_int, env_str

__all__ = ["STORE_URI_ENV", "STORE_RETRIES_ENV", "STORE_BACKOFF_ENV",
           "STORE_TIMEOUT_ENV", "STORE_HEDGE_ENV", "STORE_CACHE_ENV",
           "RemoteStoreError", "StoreBackend", "LocalBackend",
           "RemoteBackend", "resolve_backend", "store_cache_dir",
           "backend_counter_snapshot", "backoff_delay", "store_retries",
           "store_backoff_s", "store_timeout_s", "store_hedge_s",
           "store_cache_bytes"]

STORE_URI_ENV = "CNMF_TPU_STORE_URI"
STORE_RETRIES_ENV = "CNMF_TPU_STORE_RETRIES"
STORE_BACKOFF_ENV = "CNMF_TPU_STORE_BACKOFF_S"
STORE_TIMEOUT_ENV = "CNMF_TPU_STORE_TIMEOUT_S"
STORE_HEDGE_ENV = "CNMF_TPU_STORE_HEDGE_S"
STORE_CACHE_ENV = "CNMF_TPU_STORE_CACHE_BYTES"


class RemoteStoreError(RuntimeError):
    """A remote store operation failed after its retries, and no
    digest-valid cached copy could serve it. Not an ``OSError``: the shard
    reader's torn-read re-reads must not spend themselves on a dead
    network; it reaches the resilience ledger (kind ``remote_store``)."""


def store_retries() -> int:
    """Network retries of one store operation (``CNMF_TPU_STORE_RETRIES``,
    default 3; 0 disables). Distinct from ``CNMF_TPU_SHARD_RETRIES``."""
    return env_int(STORE_RETRIES_ENV, 3, lo=0)


def store_backoff_s() -> float:
    """Backoff base in seconds (``CNMF_TPU_STORE_BACKOFF_S``, default
    0.05): attempt N waits ``base * 2^(N-1) * (1 + 0.5 * jitter)``."""
    return env_float(STORE_BACKOFF_ENV, 0.05, lo=0.0)


def store_timeout_s() -> float:
    """Socket timeout of a slab transfer (``CNMF_TPU_STORE_TIMEOUT_S``,
    default 30); metadata operations use ``max(1, timeout / 4)``."""
    return env_float(STORE_TIMEOUT_ENV, 30.0, lo=0.001)


def store_hedge_s() -> float:
    """Hedged-read trigger (``CNMF_TPU_STORE_HEDGE_S``): a GET unanswered
    after this many seconds issues a second identical request, and the
    first valid answer wins. 0 (default) never hedges."""
    return env_float(STORE_HEDGE_ENV, 0.0, lo=0.0)


def store_cache_bytes() -> int:
    """Read-through cache budget (``CNMF_TPU_STORE_CACHE_BYTES``, default
    1 GiB; 0 disables the cache)."""
    return env_int(STORE_CACHE_ENV, 1 << 30, lo=0)


def backoff_delay(name: str, attempt: int, base: float | None = None) -> float:
    """Seconds to wait before retry ``attempt`` (1-based) of an operation
    on ``name``: exponential in the attempt, with a jitter from the SHA-1
    of ``name:attempt``, so objects decorrelate and a fault run replays
    with the same timing."""
    if base is None:
        base = store_backoff_s()
    seed = hashlib.sha1(("%s:%d" % (name, attempt)).encode()).digest()
    jitter = int.from_bytes(seed[:4], "big") / 2.0 ** 32
    return float(base) * (2.0 ** (attempt - 1)) * (1.0 + 0.5 * jitter)


class _Counters:
    """Thread-safe per-backend operation counters of the remote transport
    (a local backend never bumps them), folded into ``StreamStats``
    (``parallel/streaming.py``) as a delta around each staging pass."""

    FIELDS = ("retries", "healed", "hedges", "hedges_won",
              "cache_hits", "cache_misses", "degraded_reads")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def bump(self, key: str, n: int = 1):
        with self._lock:
            setattr(self, key, getattr(self, key) + int(n))
        obs_metrics.counter_inc("cnmf_store_%s_total" % key, n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: int(getattr(self, f)) for f in self.FIELDS}


def backend_counter_snapshot(obj):
    """Counter snapshot of a store's backend when it is remote, else
    ``None``. Accepts a ``ShardStore`` (has ``.backend``) or a backend."""
    bk = getattr(obj, "backend", obj)
    if bk is None or getattr(bk, "kind", "local") != "remote":
        return None
    return bk.counters.snapshot()


class StoreBackend:
    """Transport contract the shard store reads and writes through. Object
    names are flat (``manifest.json``, ``names.npz``, ``slab_*.npz``);
    ``op`` (``slab``/``meta``/``manifest``) names the operation class."""

    kind = "abstract"

    def __init__(self):
        self.counters = _Counters()

    def get(self, name, *, op="slab", refresh=False, events=None) -> bytes:
        raise NotImplementedError

    def put(self, name, data, *, op="slab", events=None) -> None:
        raise NotImplementedError

    def exists(self, name, *, events=None) -> bool:
        raise NotImplementedError

    def list(self, *, events=None) -> list:
        raise NotImplementedError

    def delete(self, name, *, events=None) -> None:
        raise NotImplementedError

    def describe(self, name) -> str:
        """Human-readable location of ``name`` for error messages."""
        raise NotImplementedError


@contextlib.contextmanager
def _atomic_write(path: str):
    """A same-directory ``<path>.tmp-<pid>`` temp renamed onto ``path``
    when the block succeeds; removed otherwise."""
    tmp = path + ".tmp-%d" % os.getpid()
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


class LocalBackend(StoreBackend):
    """A POSIX store directory: ``get`` is a plain read (the shard reader's
    digest and re-read ladder above handles torn reads), ``put`` lands
    atomically."""

    kind = "local"

    def __init__(self, root: str):
        super().__init__()
        self.root = os.fspath(root)

    def get(self, name, *, op="slab", refresh=False, events=None) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def put(self, name, data, *, op="slab", events=None) -> None:
        os.makedirs(self.root, exist_ok=True)
        with _atomic_write(os.path.join(self.root, name)) as tmp:
            # the temp half of _atomic_write's rename
            with open(tmp, "wb") as f:  # cnmf-lint: disable=artifact-nonatomic
                f.write(bytes(data))

    def exists(self, name, *, events=None) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def list(self, *, events=None) -> list:
        if not os.path.isdir(self.root):
            return []
        return sorted(os.listdir(self.root))

    def delete(self, name, *, events=None) -> None:
        try:
            os.unlink(os.path.join(self.root, name))
        except FileNotFoundError:
            pass

    def describe(self, name) -> str:
        return os.path.join(self.root, name)


# one degraded-service warning a run and endpoint: a down remote serving
# from the cache says so once, not once a slab
_degraded_lock = threading.Lock()
_degraded_warned: set = set()


def _reset_degraded_warnings():
    """Re-arm the once-a-run degraded warning (tests and the smoke)."""
    with _degraded_lock:
        _degraded_warned.clear()


class RemoteBackend(StoreBackend):
    """The HTTP object-store transport (the module docstring has its
    contract). ``base`` is the object prefix URL; ``cache_dir`` holds the
    read-through cache (None, or ``CNMF_TPU_STORE_CACHE_BYTES=0``, turns
    it off)."""

    kind = "remote"

    def __init__(self, base: str, cache_dir: str | None = None):
        super().__init__()
        self.base = base.rstrip("/")
        self.cache_dir = None if cache_dir is None else os.fspath(cache_dir)

    # -- requests --------------------------------------------------------

    def _url(self, name) -> str:
        return self.base + "/" + urllib.parse.quote(str(name))

    def _timeout(self, op: str) -> float:
        t = store_timeout_s()
        # metadata answers in one round trip: a down remote shows at
        # metadata speed, not slab speed
        return t if op == "slab" else min(t, max(1.0, t / 4.0))

    def _request(self, method, name, url, data=None, op="slab") -> bytes:
        from ..runtime import faults

        action = faults.maybe_netfault(op=method.lower(), context=str(name))
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/octet-stream")
        with urllib.request.urlopen(req, timeout=self._timeout(op)) as resp:
            body = resp.read()
        if action == "tear" and body:
            # an injected torn response: one byte flipped mid-body, for
            # the shard reader's digest check to catch
            torn = bytearray(body)
            torn[len(torn) // 2] ^= 0xFF
            body = bytes(torn)
        return body

    def _emit_fault(self, events, context: dict):
        if events is None:
            return
        try:
            events.emit("fault", kind="store_net", context=context)
        except Exception:
            pass

    def _warn_degraded(self, detail: str):
        with _degraded_lock:
            if self.base in _degraded_warned:
                return
            _degraded_warned.add(self.base)
        warnings.warn(
            "remote store %s is unreachable after retries; DEGRADED to "
            "the local read-through cache (%s). Served objects are "
            "digest-validated, but writes and uncached reads will fail "
            "until the endpoint recovers" % (self.base, detail),
            RuntimeWarning, stacklevel=3)

    def _with_retries(self, fn, *, op, name, events=None):
        retries = store_retries()
        attempt = 0
        while True:
            attempt += 1
            try:
                out = fn()
            except urllib.error.HTTPError as exc:
                # before OSError (HTTPError is one): a 404 is an answer,
                # not a fault, and is never retried
                if exc.code == 404:
                    raise FileNotFoundError(
                        "%s: object %r not found (HTTP 404)"
                        % (self.base, str(name)))
                err = exc
            except (TimeoutError, OSError) as exc:
                err = exc
            else:
                if attempt > 1:
                    # a transient fault healed: counted, and left in the
                    # telemetry (the report's "recovered")
                    self.counters.bump("healed")
                    self._emit_fault(events, {
                        "op": str(op), "object": str(name),
                        "attempt": attempt, "healed": True})
                return out
            self._emit_fault(events, {
                "op": str(op), "object": str(name),
                "attempt": attempt, "error": str(err)})
            if attempt > retries:
                raise RemoteStoreError(
                    "%s: %s %r failed after %d attempt(s): %s — remote "
                    "store unreachable (tune %s / %s, or unset %s to go "
                    "back to local paths)"
                    % (self.base, str(op), str(name), attempt, err,
                       STORE_RETRIES_ENV, STORE_TIMEOUT_ENV,
                       STORE_URI_ENV)) from err
            self.counters.bump("retries")
            time.sleep(backoff_delay(str(name), attempt))

    def _fetch(self, name, op) -> bytes:
        """One GET, hedged: a primary still unanswered after
        ``CNMF_TPU_STORE_HEDGE_S`` races a second identical request, and
        the first success wins (a failed first answer waits for the other,
        so a flaky primary does not waste a healthy hedge). The requests
        run on daemon threads; an abandoned loser drains into a queue no
        one reads and exits."""
        hedge = store_hedge_s()
        url = self._url(name)
        if hedge <= 0.0:
            return self._request("GET", name, url, op=op)
        import queue

        results: queue.Queue = queue.Queue()

        def _run(tag):
            try:
                results.put((tag, True,
                             self._request("GET", name, url, op=op)))
            except BaseException as exc:
                results.put((tag, False, exc))

        threading.Thread(target=_run, args=("primary",),
                         name="cnmf-store-get", daemon=True).start()
        try:
            tag, ok, val = results.get(timeout=hedge)
        except queue.Empty:
            self.counters.bump("hedges")
            threading.Thread(target=_run, args=("hedge",),
                             name="cnmf-store-hedge", daemon=True).start()
            tag, ok, val = results.get()
            if not ok:
                tag2, ok2, val2 = results.get()
                if ok2:
                    tag, ok, val = tag2, ok2, val2
            if ok and tag == "hedge":
                self.counters.bump("hedges_won")
        if not ok:
            raise val
        return val

    # -- the five verbs ----------------------------------------------------

    def _cache_on(self) -> bool:
        return self.cache_dir is not None and store_cache_bytes() > 0

    def get(self, name, *, op="slab", refresh=False, events=None) -> bytes:
        """Read-through: a digest-valid cached entry serves without the
        network; a miss fetches (retried, hedged) and lands in the cache.
        ``refresh=True`` bypasses the cache: the shard reader sets it after
        a digest mismatch, so a poisoned entry heals from the remote."""
        cache_on = self._cache_on()
        if cache_on and not refresh:
            data = self._cache_get(name)
            if data is not None:
                self.counters.bump("cache_hits")
                with _degraded_lock:
                    endpoint_down = self.base in _degraded_warned
                if endpoint_down:
                    # the endpoint already failed this run: a hit is
                    # degraded service, and the report counts it so
                    self.counters.bump("degraded_reads")
                return data
            self.counters.bump("cache_misses")
        t_get = time.perf_counter()
        try:
            with obs_tracing.span(
                    events, obs_tracing.child(obs_tracing.process_context()),
                    "store.get", object=str(name), op=str(op)):
                data = self._with_retries(
                    lambda: self._fetch(name, op),
                    op="get", name=name, events=events)
            obs_metrics.observe("cnmf_store_get_ms",
                                (time.perf_counter() - t_get) * 1e3)
        except RemoteStoreError:
            if cache_on and not refresh:
                # a copy may have landed since the miss (another worker
                # shares the cache): the last chance before failing
                data = self._cache_get(name)
                if data is not None:
                    self.counters.bump("degraded_reads")
                    self._warn_degraded("read %r from cache" % str(name))
                    self._emit_fault(events, {
                        "op": "get", "object": str(name), "degraded": True})
                    return data
            raise
        if cache_on:
            self._cache_put(name, data)
        return data

    def put(self, name, data, *, op="slab", events=None) -> None:
        """A retried PUT. Not write-through: the cache holds only bytes the
        remote served, and reads are accounted against the network."""
        data = bytes(data)
        self._with_retries(
            lambda: self._request("PUT", name, self._url(name),
                                  data=data, op=op),
            op="put", name=name, events=events)

    def exists(self, name, *, events=None) -> bool:
        try:
            self._with_retries(
                lambda: self._request("HEAD", name, self._url(name),
                                      op="meta"),
                op="head", name=name, events=events)
            return True
        except FileNotFoundError:
            return False
        except RemoteStoreError:
            if self._cache_on() and self._cache_get(name) is not None:
                self._warn_degraded("presence of %r from cache" % str(name))
                self._emit_fault(events, {
                    "op": "head", "object": str(name), "degraded": True})
                return True
            raise

    def list(self, *, events=None) -> list:
        try:
            body = self._with_retries(
                lambda: self._request("GET", "list", self.base + "/?list=1",
                                      op="meta"),
                op="list", name="list", events=events)
            return sorted(str(s) for s in json.loads(body.decode("utf-8")))
        except RemoteStoreError:
            if self._cache_on() and os.path.isdir(self.cache_dir):
                names = sorted(
                    urllib.parse.unquote(fn)
                    for fn in os.listdir(self.cache_dir)
                    if not fn.endswith(".sha1") and ".tmp-" not in fn)
                self._warn_degraded("listing cached objects only")
                self._emit_fault(events, {"op": "list", "degraded": True})
                return names
            raise

    def delete(self, name, *, events=None) -> None:
        try:
            self._with_retries(
                lambda: self._request("DELETE", name, self._url(name),
                                      op="meta"),
                op="delete", name=name, events=events)
        except FileNotFoundError:
            pass
        finally:
            self._cache_drop(name)

    def describe(self, name) -> str:
        return self._url(name)

    # -- the read-through cache --------------------------------------------
    #
    # one file an object under cache_dir (its URL-quoted name) and a
    # ``.sha1`` sidecar with its content digest, both landed atomically,
    # so a crash mid-write leaves only pid-suffixed temps (swept with the
    # store). A hit recomputes the sha1 and drops an entry that disagrees
    # with its sidecar (a partial write, bit rot), so the cache never
    # serves bytes the remote did not serve.

    def _cache_path(self, name) -> str:
        return os.path.join(self.cache_dir,
                            urllib.parse.quote(str(name), safe=""))

    def _cache_get(self, name):
        path = self._cache_path(name)
        try:
            with open(path, "rb") as f:
                data = f.read()
            with open(path + ".sha1") as f:
                want = f.read().strip()
        except OSError:
            return None
        if hashlib.sha1(data).hexdigest() != want:
            self._cache_drop(name)
            return None
        try:
            os.utime(path)  # the LRU's recency
        except OSError:
            pass
        return data

    def _cache_put(self, name, data: bytes):
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            path = self._cache_path(name)
            # both writes are the temp halves of _atomic_write's renames
            with _atomic_write(path + ".sha1") as tmp:
                with open(tmp, "w") as f:  # cnmf-lint: disable=artifact-nonatomic
                    f.write(hashlib.sha1(data).hexdigest())
            with _atomic_write(path) as tmp:
                with open(tmp, "wb") as f:  # cnmf-lint: disable=artifact-nonatomic
                    f.write(data)
            self._evict(keep=os.path.basename(path))
        except OSError:
            # the cache is an optimization: a full or read-only disk never
            # fails the read that tried to fill it
            pass

    def _cache_drop(self, name):
        if self.cache_dir is None:
            return
        path = self._cache_path(name)
        for p in (path, path + ".sha1"):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _evict(self, keep: str):
        """LRU sweep to the byte budget (entry bytes; the sidecars go with
        their entries), least recently read first, never ``keep`` (the
        entry just written)."""
        budget = store_cache_bytes()
        entries = []
        total = 0
        for fn in os.listdir(self.cache_dir):
            if fn.endswith(".sha1") or ".tmp-" in fn:
                continue
            p = os.path.join(self.cache_dir, fn)
            try:
                st = os.stat(p)
            except OSError:
                continue
            total += st.st_size
            entries.append((st.st_mtime, st.st_size, fn))
        if total <= budget:
            return
        for _, size, fn in sorted(entries):
            if fn == keep:
                continue
            p = os.path.join(self.cache_dir, fn)
            for victim in (p, p + ".sha1"):
                try:
                    os.unlink(victim)
                except OSError:
                    pass
            total -= size
            if total <= budget:
                return


def store_cache_dir(store_dir) -> str:
    """The read-through cache directory of a store path, ``<store>.cache``
    beside it (a remote store's; swept with the store)."""
    return os.fspath(store_dir) + ".cache"


def resolve_backend(store_dir, uri: str | None = None) -> StoreBackend:
    """Backend for ``store_dir`` from the store URI (the argument, else
    ``CNMF_TPU_STORE_URI``): empty -> :class:`LocalBackend` on the path
    itself; ``file:///base`` -> under ``base/<leaf>``;
    ``http(s)://host[:port]/prefix`` -> :class:`RemoteBackend` under
    ``prefix/<leaf>`` with the cache beside ``store_dir``. ``<leaf>`` is
    the store directory's basename, so stores of several runs share one
    endpoint apart."""
    store_dir = os.fspath(store_dir)
    raw = env_str(STORE_URI_ENV, "") if uri is None else uri
    raw = (raw or "").strip()
    if not raw:
        return LocalBackend(store_dir)
    parts = urllib.parse.urlsplit(raw)
    scheme = parts.scheme.lower()
    leaf = os.path.basename(os.path.normpath(store_dir)) or "store"
    if scheme == "file":
        return LocalBackend(os.path.join(parts.path or "/", leaf))
    if scheme in ("http", "https"):
        base = raw.rstrip("/") + "/" + urllib.parse.quote(leaf)
        return RemoteBackend(base, cache_dir=store_cache_dir(store_dir))
    raise ValueError(
        "%s=%r: expected empty (local paths), file:///base/dir, or "
        "http(s)://host[:port]/prefix" % (STORE_URI_ENV, raw))
