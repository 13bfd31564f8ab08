"""Cross-request micro-batching for the projection daemon.

Every projection request is a fixed-W usage refit, row-separable work:
``fit_h`` solves row chunks independently (``ops/nmf.py:fit_h`` runs
``_chunk_h_solve`` chunk by chunk with no carry). That independence is
what makes cross-request batching possible: each request becomes one or
more *lanes* (its solo chunk partition, ``chunk = min(online_chunk_size,
n)``), lanes zero-pad to a bucketed row count, and the whole batch runs as
ONE ``_chunk_h_solve`` call on a ``(lanes, rows, genes)`` stack against
the resident reference (:func:`batched_project`). A padded row has X = 0
and H = 0 and stays exactly zero under every beta's MU step, adding
``+0.0`` to its lane's convergence norm; the H init is the solo draw's
prefix (:func:`~cnmf_torch_tpu_torch.ops.nmf.fit_h_default_init`). Each
lane is then its solo chunk's solve up to the matmul's reduction order on
a stack of another shape: a served request is held to its solo
:func:`~cnmf_torch_tpu_torch.ops.nmf.fit_h` at ``rtol 1e-5``, not bit for
bit.

Layers:

  * the admission queue and its single dispatcher thread. The first queued
    request opens a batch; the dispatcher lingers up to
    ``CNMF_TPU_SERVE_LINGER_MS`` collecting batchmates (at most
    ``CNMF_TPU_SERVE_BATCH`` lanes), then launches. Requests older than
    ``CNMF_TPU_SERVE_TIMEOUT_S`` shed with a clear error, and a full queue
    sheds at once instead of building an unbounded backlog.
  * :class:`ProjectionService`, the daemon core: the resident reference,
    eager warmup of every padded ``(lanes, rows)`` bucket, per-(tenant,
    matrix) usage warm starts, per-lane health grading
    (:func:`~cnmf_torch_tpu_torch.ops.nmf.lane_health`) with tenant
    quarantine so one poison input cannot sink its batchmates or the
    daemon, and ``serve_request``/``serve_batch`` telemetry.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import tracing as obs_tracing
from ..runtime import faults
from ..utils.envknobs import env_flag, env_float, env_int, env_str

__all__ = [
    "ServeError",
    "ShedError",
    "PoisonError",
    "QuarantinedError",
    "resolve_buckets",
    "bucket_for",
    "lane_buckets",
    "lane_count",
    "batched_project",
    "ProjectionService",
]

# poison strikes before a tenant is quarantined (admission-rejected):
# repeated unhealthiness is a property of the input, not the run
POISON_QUARANTINE_STRIKES = 3

# bounded reservoir of per-request total latencies for stats()
_LATENCY_SAMPLES = 4096

# warm-start cache entries kept (LRU): one usage matrix per (tenant,
# matrix fingerprint), bounding host memory against tenant growth
_WARM_CACHE_ENTRIES = 256

# idempotency claims kept (FIFO eviction): request_id -> its _Request, so
# a router retry of an id that already solved (or graded poison) gets the
# original reply instead of a second solve. Shed outcomes are forgotten:
# shed means "not done, retry", so the retry must re-enter
_IDEM_CACHE_ENTRIES = 1024


class ServeError(RuntimeError):
    """Base class for request-level serve failures (a clear client-visible
    error, never a daemon crash)."""

    status = "error"


class ShedError(ServeError):
    """Admission shed: bounded queue full or deadline exceeded."""

    status = "shed"


class PoisonError(ServeError):
    """The request's lane graded unhealthy (nonfinite input or result).
    Batchmates are unaffected: lanes are independent."""

    status = "poison"


class QuarantinedError(ServeError):
    """Tenant exceeded the poison-strike budget; admission rejects."""

    status = "quarantined"


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

def resolve_buckets(chunk_size: int, spec: str | None = None) -> tuple:
    """The padded-rows bucket schedule: parsed ``CNMF_TPU_SERVE_BUCKETS``
    entries below the run's chunk size, with the chunk size itself as the
    top bucket (a lane is never taller than one solo chunk)."""
    if spec is None:
        spec = env_str("CNMF_TPU_SERVE_BUCKETS", "64,256,1024")
    chunk_size = int(chunk_size)
    out = {chunk_size}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            b = int(part)
        except ValueError:
            raise ValueError(
                f"CNMF_TPU_SERVE_BUCKETS={spec!r}: expected "
                f"comma-separated integers")
        if b < 1:
            raise ValueError(
                f"CNMF_TPU_SERVE_BUCKETS={spec!r}: buckets must be >= 1")
        if b < chunk_size:
            out.add(b)
    return tuple(sorted(out))


def bucket_for(n: int, buckets: tuple) -> int:
    """Smallest bucket >= n (buckets sorted ascending; the top bucket is
    the chunk size, and lanes never exceed it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def lane_buckets(max_batch: int) -> tuple:
    """Power-of-two lane-count buckets up to (and including) the batch
    cap: the batch axis of the warmed bucket schedule."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(sorted(set(out)))


def lane_count(n: int, chunk_size: int) -> int:
    """How many lanes (solo chunks) a request of ``n`` rows occupies."""
    chunk = min(int(chunk_size), int(n))
    return max(1, -(-int(n) // chunk))


# ---------------------------------------------------------------------------
# the batched device program
# ---------------------------------------------------------------------------

def batched_project(Xb, Hb, W, WWT, w_colsum, h_tol, *, beta, max_iter,
                    l1, l2):
    """One usage solve over a stack of request lanes: ``Xb (b, n, g)`` and
    ``Hb (b, n, k)`` on the reference's device, ``W (1, k, g)`` broadcast
    to every lane. Each lane is the solo per-chunk program
    (``_chunk_h_solve`` with ``fit_h``'s arguments) and stops on its own;
    ``WWT`` (beta=2) / ``w_colsum`` (beta=1) are the reference's resident
    loop-invariant products. Returns ``(H (b, n, k), rel (b,))``, ``rel``
    each lane's last relative change, the host's health signal."""
    from ..ops.nmf import _chunk_h_solve

    return _chunk_h_solve(Xb, Hb, W, WWT, float(beta), float(l1),
                          float(l2), int(max_iter), h_tol,
                          w_colsum=w_colsum, return_resid=True)


def _host_tensor(a: np.ndarray):
    """A CPU tensor over the f32 rows ``a`` (copied when read-only, as a
    matrix decoded from the wire's bytes is)."""
    import torch

    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

_SENTINEL = object()
_req_ids = itertools.count(1)


class _Request:
    __slots__ = ("rid", "tenant", "X", "n", "h_init", "warm",
                 "t_enqueue", "t_dequeue", "event", "_rlock", "result",
                 "error", "meta", "trace", "request_id")

    def __init__(self, tenant: str, X: np.ndarray, h_init, warm: bool,
                 trace=None, request_id: str | None = None):
        self.rid = next(_req_ids)
        self.tenant = tenant
        self.X = X
        self.n = int(X.shape[0])
        self.h_init = h_init
        self.warm = warm
        self.t_enqueue = time.perf_counter()
        # stamped by the dispatcher when it pulls the request off the
        # queue: splits queue wait (enqueue->dequeue) from batch linger
        # (dequeue->launch) on the trace waterfall
        self.t_dequeue = None
        self.event = threading.Event()
        self._rlock = threading.Lock()
        self.result = None
        self.error = None
        self.meta: dict = {}
        # sampled trace context (obs/tracing.py) or None
        self.trace = trace
        # client-chosen idempotency key (or None): the service's dedup
        # map points ids at their original request, so a retry waits on
        # the same event instead of enqueueing a second solve
        self.request_id = request_id

    def reply(self, result=None, error=None, **meta):
        # first reply wins: the dispatcher and the shutdown drain can
        # race on a request caught mid-close
        with self._rlock:
            if self.event.is_set():
                return
            self.result = result
            self.error = error
            self.meta.update(meta)
            self.event.set()

    def wait(self, timeout=None):
        if not self.event.wait(timeout):
            raise ShedError(
                f"request {self.rid}: no reply within {timeout} s (daemon "
                f"overloaded or gone)")
        if self.error is not None:
            raise self.error
        return self.result, self.meta


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class ProjectionService:
    """Resident-reference projection with cross-request batching.

    Construct with a :class:`~cnmf_torch_tpu_torch.serving.reference.
    ResidentReference` and the ``device`` to serve from (default
    ``"cuda"``; raises without a card unless asked for ``"cpu"``), call
    :meth:`start` (stages the reference, warms every bucket, starts the
    dispatcher), then :meth:`project` from any number of threads.
    :meth:`close` drains and stops.
    """

    def __init__(self, reference, *, device="cuda",
                 max_batch: int | None = None,
                 linger_ms: float | None = None,
                 timeout_s: float | None = None,
                 buckets: str | None = None,
                 warm_start: bool | None = None,
                 events=None, liveness=None):
        self.reference = reference
        self.device = device
        self.max_batch = (env_int("CNMF_TPU_SERVE_BATCH", 8, lo=1)
                          if max_batch is None else int(max_batch))
        linger = (env_float("CNMF_TPU_SERVE_LINGER_MS", 2.0, lo=0.0)
                  if linger_ms is None else float(linger_ms))
        self.linger_s = linger / 1000.0
        self.timeout_s = (env_float("CNMF_TPU_SERVE_TIMEOUT_S", 30.0,
                                    lo=0.0)
                          if timeout_s is None else float(timeout_s))
        self.warm_start = (env_flag("CNMF_TPU_SERVE_WARM_START", True)
                           if warm_start is None else bool(warm_start))
        self.buckets = resolve_buckets(reference.chunk_size, buckets)
        self.b_buckets = lane_buckets(self.max_batch)
        self.events = events
        self.liveness = liveness
        # bounded admission queue: beyond ~4 batches of backlog the
        # daemon sheds instead of queueing into timeout territory
        self._q: queue.Queue = queue.Queue(maxsize=4 * self.max_batch)
        self._thread: threading.Thread | None = None
        self._running = False
        self._lock = threading.Lock()
        # bucket bookkeeping: (b_pad, n_pad) -> dispatched already?
        self._programs: dict = {}
        self._warmup_done = False
        self.warmup_s = None
        # default-init cache: ONE grow-only uniform draw whose row prefix
        # serves every request size (fit_h_default_init's prefix
        # property), so a request pays no draw of its own
        self._init_cache: np.ndarray | None = None
        # warm starts: (tenant, matrix token) -> last healthy usage (LRU)
        self._warm_cache: dict = {}
        # tenant poison strikes / quarantine
        self._strikes: dict = {}
        self._quarantined: set = set()
        # idempotency: request_id -> the original _Request (FIFO-bounded
        # at _IDEM_CACHE_ENTRIES); dedup hits wait on the original's
        # event, so one id solves at most once
        self._idem: dict = {}
        self._stats = {
            "requests": 0, "ok": 0, "shed": 0, "poison": 0,
            "quarantined": 0, "error": 0, "deduped": 0, "batches": 0,
            "multi_request_batches": 0, "lanes_total": 0,
            "max_lanes": 0, "warm_started": 0,
            "cold_dispatches_after_warmup": 0,
        }
        self._latencies: list = []
        # the reservoir halves itself when full; count what it dropped so
        # /stats and /metrics state what the p99 was computed over
        self._lat_dropped = 0
        # sliding-window SLO tracker, armed by CNMF_TPU_SLO_P99_MS
        self._slo = obs_slo.tracker_from_env()
        # roofline accounting: per-dispatch analytic cost + solve wall,
        # flushed as ONE perf_model event at shutdown (emit_perf_model)
        self._perf = {"solve_s": 0.0, "flops": 0.0, "bytes": 0.0,
                      "lanes": 0, "batches": 0}

    # -- lifecycle -----------------------------------------------------

    def start(self, warmup: bool = True):
        """Stage the reference on the service's device, warm the buckets,
        and start the dispatcher thread. Idempotent."""
        with self._lock:
            if self._running:
                return self
            self.reference.stage(device=self.device, events=self.events)
            self._running = True
        if warmup:
            self.warmup()
        t = threading.Thread(target=self._dispatch_loop,
                             name="cnmf-serve-dispatch", daemon=True)
        self._thread = t
        t.start()
        return self

    def close(self):
        """Stop the dispatcher; queued requests get a clear shed error."""
        with self._lock:
            if not self._running:
                return
            self._running = False
        self._q.put(_SENTINEL)
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _SENTINEL:
                self._idem_forget(req)
                req.reply(error=ShedError("daemon shutting down"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- warmup --------------------------------------------------------

    def warmup(self) -> int:
        """Dispatch every ``(lanes, rows)`` bucket once on zeros, in turn,
        where its request stack fits ``CNMF_TPU_WARM_DUMMY_BUDGET_BYTES``:
        the card's allocator pools and cuBLAS handles are then warm before
        the first request. A bucket over the budget is left cold and
        counted by :meth:`stats` when traffic first reaches it. Returns the
        number of buckets dispatched."""
        import torch

        ref = self.reference
        g, k = ref.n_genes, ref.k
        budget = env_int("CNMF_TPU_WARM_DUMMY_BUDGET_BYTES", 2 << 30,
                         lo=0)
        t0 = time.perf_counter()
        done = 0
        for b_pad in self.b_buckets:
            for n_pad in self.buckets:
                if b_pad * n_pad * g * 4 > budget:
                    continue
                Xb = torch.zeros((b_pad, n_pad, g), dtype=torch.float32,
                                 device=ref.device)
                Hb = torch.zeros((b_pad, n_pad, k), dtype=torch.float32,
                                 device=ref.device)
                out_h, out_rel = batched_project(
                    Xb, Hb, ref.Wd, ref.WWT, ref.w_colsum, ref.h_tol_dev,
                    beta=ref.beta, max_iter=ref.chunk_max_iter,
                    l1=ref.l1_H, l2=0.0)
                out_rel.cpu()
                del Xb, Hb, out_h, out_rel
                self._programs[(int(b_pad), int(n_pad))] = True
                done += 1
        self.warmup_s = time.perf_counter() - t0
        self._warmup_done = True
        return done

    # -- admission -----------------------------------------------------

    def submit(self, X, tenant: str = "default", trace=None,
               request_id: str | None = None) -> _Request:
        """Validate and enqueue one projection request; returns the pending
        handle (``.wait()`` for the result). Raises ``ServeError``
        subclasses on admission failure. ``trace`` is an optional sampled
        trace context; the dispatcher emits queue/linger/solve spans under
        it. ``request_id`` is an optional idempotency key: resubmitting an
        id that already solved (or graded poison) returns the original
        handle, so at most one solve per id. Shed outcomes release the
        id."""
        tenant = str(tenant)
        if not self._running:
            raise ShedError("daemon not running")
        if request_id is not None:
            with self._lock:
                cached = self._idem.get(request_id)
            if cached is not None:
                self._count("deduped")
                return cached
        if tenant in self._quarantined:
            self._count("quarantined")
            self._emit_request(tenant, getattr(X, "shape", (0,))[0],
                               "quarantined")
            raise QuarantinedError(
                f"tenant {tenant!r} is quarantined after "
                f"{POISON_QUARANTINE_STRIKES} poison inputs; restart the "
                f"daemon (or fix the inputs) to clear it")
        X = np.ascontiguousarray(np.asarray(X), dtype=np.float32)
        if X.ndim != 2 or X.shape[0] < 1:
            raise self._reject(tenant, 0, ServeError(
                f"request must be a (cells, genes) matrix, got shape "
                f"{X.shape}"))
        if X.shape[1] != self.reference.n_genes:
            raise self._reject(tenant, X.shape[0], ServeError(
                f"request has {X.shape[1]} genes; the resident reference "
                f"expects {self.reference.n_genes} (its gene order — see "
                f"/reference)"))
        # cap a request at one full batch of lanes: every dispatch then
        # stays inside the warmed (lanes, rows) bucket schedule
        max_cells = self.reference.chunk_size * self.max_batch
        if X.shape[0] > max_cells:
            raise self._reject(tenant, X.shape[0], ServeError(
                f"request has {X.shape[0]} cells; this daemon accepts at "
                f"most {max_cells} per request (chunk "
                f"{self.reference.chunk_size} x CNMF_TPU_SERVE_BATCH="
                f"{self.max_batch} lanes) — split the matrix into row "
                f"blocks and project them separately (results are "
                f"row-independent)"))
        h_init, warm = self._warm_init_for(tenant, X)
        req = _Request(tenant, X, h_init, warm, trace=trace,
                       request_id=request_id)
        if request_id is not None:
            with self._lock:
                existing = self._idem.get(request_id)
                if existing is not None:
                    # a concurrent duplicate claimed the id first
                    self._stats["deduped"] += 1
                    return existing
                self._idem[request_id] = req
                while len(self._idem) > _IDEM_CACHE_ENTRIES:
                    self._idem.pop(next(iter(self._idem)))
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._idem_forget(req)
            self._count("shed")
            self._slo_record(0.0, ok=False)
            self._emit_request(tenant, X.shape[0], "shed")
            raise ShedError(
                f"admission queue full ({self._q.maxsize} requests in "
                f"flight); retry with backoff")
        obs_metrics.gauge_set("cnmf_serve_queue_depth", self._q.qsize())
        if not self._running:
            # close() raced us: nobody may ever reply, so shed now (a
            # no-op when the dispatcher did reply first)
            self._idem_forget(req)
            req.reply(error=ShedError("daemon shutting down"))
        return req

    def _reject(self, tenant: str, n_cells, error: ServeError):
        """Account an admission rejection (counter + telemetry) and hand
        the error back for raising."""
        self._count(error.status)
        self._emit_request(tenant, n_cells, error.status)
        return error

    def project(self, X, tenant: str = "default", timeout: float | None
                = None, trace=None, request_id: str | None = None
                ) -> tuple[np.ndarray, dict]:
        """Blocking projection: returns ``(usage (n, k), meta)``."""
        req = self.submit(X, tenant=tenant, trace=trace,
                          request_id=request_id)
        wait = timeout
        if wait is None:
            wait = (self.timeout_s + 120.0) if self.timeout_s else None
        return req.wait(wait)

    def _idem_forget(self, req):
        """Release a request's idempotency claim (shed paths only)."""
        rid = getattr(req, "request_id", None)
        if rid is None:
            return
        with self._lock:
            if self._idem.get(rid) is req:
                self._idem.pop(rid, None)

    # -- dispatcher ----------------------------------------------------

    def _dispatch_loop(self):
        carry = None
        while True:
            if carry is not None:
                req, carry = carry, None
            else:
                req = self._q.get()
            if req is _SENTINEL:
                break
            if req.t_dequeue is None:
                req.t_dequeue = time.perf_counter()
            if self._expired(req):
                continue
            batch = [req]
            lanes = lane_count(req.n, self.reference.chunk_size)
            deadline = time.perf_counter() + self.linger_s
            while lanes < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    carry = _SENTINEL
                    break
                nxt.t_dequeue = time.perf_counter()
                if self._expired(nxt):
                    continue
                n_lanes = lane_count(nxt.n, self.reference.chunk_size)
                if lanes + n_lanes > self.max_batch:
                    carry = nxt
                    break
                batch.append(nxt)
                lanes += n_lanes
            try:
                self._dispatch(batch)
            except Exception as exc:
                # a failed dispatch answers its requests with an error;
                # it never retries them anywhere else
                for r in batch:
                    if not r.event.is_set():
                        self._idem_forget(r)
                        self._count("error")
                        self._emit_request(r.tenant, r.n, "error")
                        r.reply(error=ServeError(
                            f"batch dispatch failed: {exc}"))
            if carry is _SENTINEL:
                break

    def _expired(self, req) -> bool:
        if not self.timeout_s:
            return False
        waited = time.perf_counter() - req.t_enqueue
        if waited <= self.timeout_s:
            return False
        self._count("shed")
        self._slo_record(waited * 1e3, ok=False)
        self._emit_request(req.tenant, req.n, "shed",
                           wait_ms=round(waited * 1e3, 3))
        self._idem_forget(req)
        req.reply(error=ShedError(
            f"request {req.rid}: shed after waiting "
            f"{waited:.2f} s (> CNMF_TPU_SERVE_TIMEOUT_S="
            f"{self.timeout_s:g}); the daemon is overloaded"))
        return True

    # -- batched solve -------------------------------------------------

    def _default_init(self, n: int) -> np.ndarray:
        """Rows ``[0:n]`` of the solo default H init (grow-only cache: the
        CPU generator's draws have the prefix property, so one large
        draw's first rows equal every smaller draw)."""
        with self._lock:
            cached = self._init_cache
        if cached is None or cached.shape[0] < n:
            from ..ops.nmf import fit_h_default_init

            size = max(int(n), self.buckets[-1])
            fresh = fit_h_default_init(size, self.reference.k).numpy()
            with self._lock:
                if (self._init_cache is None
                        or self._init_cache.shape[0] < size):
                    self._init_cache = fresh
                cached = self._init_cache
        return cached[:n]

    @staticmethod
    def _x_token(X: np.ndarray) -> tuple:
        """Cheap content fingerprint (shape + f64 sum + strided sample):
        warm starts fire only for a REPEAT of the same matrix. A different
        matrix of the same shape must never inherit a previous solve's
        exact zeros, which are absorbing under MU."""
        buf = X.ravel()
        step = max(1, buf.size // 64)
        return (X.shape, float(buf.sum(dtype=np.float64)),
                buf[::step][:64].tobytes())

    def _warm_init_for(self, tenant: str, X: np.ndarray):
        """The (h_init, warm?) pair for a request: the tenant's previous
        healthy usage for this exact matrix when warm starts are on, else
        None (solo default init)."""
        if not self.warm_start:
            return None, False
        with self._lock:
            H = self._warm_cache.get((tenant, self._x_token(X)))
        if H is None:
            return None, False
        return H, True

    def _dispatch(self, batch: list):
        import torch

        t0 = time.perf_counter()
        # injectable consistent slowness at the dispatch seam
        faults.maybe_straggle(context="serve:dispatch")
        ref = self.reference
        chunk_size = ref.chunk_size
        g, k = ref.n_genes, ref.k

        # lane plan: (request, row_lo, row_hi) in request coordinates, the
        # solo chunk partition, so each lane is one chunk of the
        # request's own fit_h
        lanes = []
        for req in batch:
            chunk = min(chunk_size, req.n)
            for lo in range(0, req.n, chunk):
                lanes.append((req, lo, min(lo + chunk, req.n)))
        n_pad = bucket_for(max(hi - lo for _, lo, hi in lanes),
                           self.buckets)
        # admission caps a request at chunk_size * max_batch cells, so a
        # batch's lane count always fits the bucket schedule
        b_pad = bucket_for(len(lanes), self.b_buckets)

        key = (int(b_pad), int(n_pad))
        cache_hit = bool(self._programs.get(key))
        if not cache_hit:
            self._programs[key] = True
            if self._warmup_done:
                self._count("cold_dispatches_after_warmup")

        # the padded stack is zeroed on the device and only each lane's
        # real rows cross from the host
        t_solve = time.perf_counter()
        Xd = torch.zeros((b_pad, n_pad, g), dtype=torch.float32,
                         device=ref.device)
        Hd = torch.zeros((b_pad, n_pad, k), dtype=torch.float32,
                         device=ref.device)
        inits: dict = {}
        for i, (req, lo, hi) in enumerate(lanes):
            Xd[i, :hi - lo].copy_(_host_tensor(req.X[lo:hi]))
            H0 = inits.get(req.rid)
            if H0 is None:
                if req.h_init is not None:
                    # the solo comparator is fit_h(H_init=prev), which
                    # clamps at zero
                    H0 = np.maximum(
                        np.asarray(req.h_init, np.float32), 0.0)
                else:
                    H0 = self._default_init(req.n)
                inits[req.rid] = H0
            Hd[i, :hi - lo].copy_(_host_tensor(H0[lo:hi]))
        out_h, out_rel = batched_project(
            Xd, Hd, ref.Wd, ref.WWT, ref.w_colsum, ref.h_tol_dev,
            beta=ref.beta, max_iter=ref.chunk_max_iter, l1=ref.l1_H,
            l2=0.0)
        H_all = out_h.cpu().numpy()
        rel_all = out_rel.cpu().numpy()
        del Xd, Hd, out_h, out_rel
        solve_ms = (time.perf_counter() - t_solve) * 1e3

        # per-lane health grading: a nonfinite residual or factor block
        # marks ONLY its own lane; batchmates are independent
        from ..ops.nmf import lane_health

        health = lane_health(rel_all, spectra=H_all)

        from ..obs.costmodel import serve_project_cost

        perf_c = serve_project_cost(int(b_pad), int(n_pad), g, k,
                                    beta=ref.beta,
                                    iters=int(ref.chunk_max_iter))
        with self._lock:
            self._stats["batches"] += 1
            self._stats["lanes_total"] += len(lanes)
            self._stats["max_lanes"] = max(self._stats["max_lanes"],
                                           len(lanes))
            if len(batch) > 1:
                self._stats["multi_request_batches"] += 1
            self._perf["solve_s"] += solve_ms / 1e3
            self._perf["flops"] += perf_c["flops"]
            self._perf["bytes"] += perf_c["bytes"]
            self._perf["lanes"] += len(lanes)
            self._perf["batches"] += 1
        if self.events is not None:
            self.events.emit(
                "serve_batch", lanes=len(lanes), requests=len(batch),
                bucket=[int(b_pad), int(n_pad)],
                solve_ms=round(solve_ms, 3), cache_hit=cache_hit,
                queue_depth=self._q.qsize())
        obs_metrics.counter_inc("cnmf_serve_batches_total")
        obs_metrics.counter_inc("cnmf_serve_lanes_total", len(lanes))
        obs_metrics.observe("cnmf_serve_solve_ms", solve_ms)
        obs_metrics.gauge_set("cnmf_serve_queue_depth", self._q.qsize())
        if self.liveness is not None:
            try:
                self.liveness(phase="serve", cursor=self._stats["batches"])
            except Exception:
                pass

        # deterministic unpadding: each request's usage is the ordered
        # concatenation of its lanes' real rows
        by_req: dict = {}
        for i, (req, lo, hi) in enumerate(lanes):
            ok, rows = by_req.get(req.rid, (True, []))
            by_req[req.rid] = (ok and bool(health[i]),
                               rows + [H_all[i, :hi - lo]])
        for req in batch:
            healthy, rows = by_req[req.rid]
            wait_ms = round((t_solve - req.t_enqueue) * 1e3, 3)
            self._emit_req_spans(req, t0, t_solve, solve_ms)
            if healthy:
                H = np.concatenate(rows, axis=0)
                if self.warm_start:
                    self._store_warm(req.tenant, self._x_token(req.X), H)
                self._count("ok")
                if req.warm:
                    self._count("warm_started")
                total = round(
                    (time.perf_counter() - req.t_enqueue) * 1e3, 3)
                with self._lock:
                    self._latencies.append(total)
                    if len(self._latencies) > _LATENCY_SAMPLES:
                        dropped = len(self._latencies) // 2
                        del self._latencies[:dropped]
                        self._lat_dropped += dropped
                self._slo_record(total, ok=True)
                obs_metrics.observe("cnmf_serve_request_ms", total)
                self._emit_request(
                    req.tenant, req.n, "ok", wait_ms=wait_ms,
                    solve_ms=round(solve_ms, 3), total_ms=total,
                    batch_lanes=len(lanes), batch_requests=len(batch),
                    warm_start=req.warm)
                req.reply(result=H, batch_lanes=len(lanes),
                          batch_requests=len(batch), warm_start=req.warm,
                          wait_ms=wait_ms, solve_ms=round(solve_ms, 3))
                # the idempotency map may pin this request for its whole
                # cache lifetime: keep the (small) usage result for
                # retries, drop the (large) input and init now
                req.X = None
                req.h_init = None
            else:
                strikes = self._strike(req.tenant)
                self._count("poison")
                self._slo_record(
                    (time.perf_counter() - req.t_enqueue) * 1e3,
                    ok=False)
                self._emit_request(
                    req.tenant, req.n, "poison", wait_ms=wait_ms,
                    solve_ms=round(solve_ms, 3),
                    batch_lanes=len(lanes), batch_requests=len(batch))
                if self.events is not None:
                    self.events.emit(
                        "fault", kind="serve_poison",
                        context={"tenant": req.tenant, "n_cells": req.n,
                                 "strikes": strikes,
                                 "quarantined":
                                     req.tenant in self._quarantined})
                req.reply(error=PoisonError(
                    f"request {req.rid} (tenant {req.tenant!r}): "
                    f"projection graded unhealthy (nonfinite input or "
                    f"usage); strike {strikes}/"
                    f"{POISON_QUARANTINE_STRIKES}"))
                # poison stays claimed (a retry of the same id must NOT
                # re-solve and take a second strike); free the input
                req.X = None
                req.h_init = None

    def _emit_req_spans(self, req, t0: float, t_solve: float,
                        solve_ms: float):
        """The request's hop spans on the batcher side: queue wait
        (enqueue -> dequeue), batch linger (dequeue -> launch), device
        dispatch (launch -> fetched). Nothing for untraced requests."""
        if req.trace is None or self.events is None:
            return
        dq = req.t_dequeue if req.t_dequeue is not None else t0
        obs_tracing.emit_span(
            self.events, obs_tracing.child(req.trace), "serve.queue",
            start_ts=obs_tracing.perf_to_wall(req.t_enqueue),
            wall_ms=(dq - req.t_enqueue) * 1e3, tenant=req.tenant)
        obs_tracing.emit_span(
            self.events, obs_tracing.child(req.trace), "serve.linger",
            start_ts=obs_tracing.perf_to_wall(dq),
            wall_ms=(t_solve - dq) * 1e3)
        obs_tracing.emit_span(
            self.events, obs_tracing.child(req.trace), "serve.solve",
            start_ts=obs_tracing.perf_to_wall(t_solve),
            wall_ms=solve_ms)

    def _slo_record(self, latency_ms: float, ok: bool):
        if self._slo is not None:
            self._slo.record(latency_ms, ok=ok)

    def slo_status(self, refresh_metrics: bool = False):
        """The windowed SLO verdict, or ``None`` when the tracker is not
        armed. With ``refresh_metrics`` the verdict is also published as
        gauges so a /metrics scrape carries it."""
        if self._slo is None:
            return None
        verdict = self._slo.evaluate()
        if refresh_metrics:
            obs_metrics.gauge_set("cnmf_slo_target_p99_ms",
                                  verdict["target_p99_ms"])
            obs_metrics.gauge_set("cnmf_slo_window_requests",
                                  verdict["requests"])
            obs_metrics.gauge_set("cnmf_slo_window_errors",
                                  verdict["errors"])
            if verdict.get("p99_ms") is not None:
                obs_metrics.gauge_set("cnmf_slo_p99_ms",
                                      verdict["p99_ms"])
            obs_metrics.gauge_set("cnmf_slo_burning",
                                  1.0 if verdict["burning"] else 0.0)
        return verdict

    def metrics_text(self) -> str:
        """The daemon's /metrics body: refresh the point-in-time gauges
        (queue depth, reservoir coverage, SLO verdict) and render the
        process registry."""
        if obs_metrics.metrics_enabled():
            obs_metrics.gauge_set("cnmf_serve_queue_depth",
                                  self._q.qsize())
            with self._lock:
                kept = len(self._latencies)
                dropped = self._lat_dropped
            obs_metrics.gauge_set("cnmf_serve_latency_samples_kept", kept)
            obs_metrics.gauge_set("cnmf_serve_latency_samples_dropped",
                                  dropped)
            obs_metrics.gauge_set(
                "cnmf_serve_latency_window_coverage",
                round(kept / (kept + dropped), 6) if kept + dropped
                else 1.0)
            self.slo_status(refresh_metrics=True)
        return obs_metrics.render_text()

    def _store_warm(self, tenant: str, token: tuple, H: np.ndarray):
        with self._lock:
            cache = self._warm_cache
            cache.pop((tenant, token), None)
            cache[(tenant, token)] = H
            while len(cache) > _WARM_CACHE_ENTRIES:
                cache.pop(next(iter(cache)))

    def _strike(self, tenant: str) -> int:
        with self._lock:
            strikes = self._strikes.get(tenant, 0) + 1
            self._strikes[tenant] = strikes
            if strikes >= POISON_QUARANTINE_STRIKES:
                self._quarantined.add(tenant)
            return strikes

    # -- accounting ----------------------------------------------------

    def _count(self, key: str):
        is_status = key in ("ok", "shed", "poison", "quarantined",
                            "error")
        with self._lock:
            self._stats["requests"] += is_status
            self._stats[key] = self._stats.get(key, 0) + 1
        if is_status:
            obs_metrics.counter_inc("cnmf_serve_requests_total",
                                    status=key)

    def _emit_request(self, tenant: str, n_cells, status: str, **fields):
        if self.events is not None:
            self.events.emit("serve_request", tenant=str(tenant),
                             n_cells=int(n_cells), status=status,
                             **fields)

    def emit_perf_model(self):
        """Flush the accumulated dispatch accounting as ONE ``perf_model``
        event, priced against the serving card's data-sheet peaks
        (``perf_exempt`` off a card). Called at daemon shutdown; no-op
        without telemetry + ``CNMF_TPU_PERF_MODEL`` or when nothing
        dispatched."""
        from ..obs.costmodel import (device_peaks, perf_model_enabled,
                                     roofline)

        if self.events is None or not perf_model_enabled():
            return
        with self._lock:
            perf = dict(self._perf)
        if not perf.get("batches"):
            return
        dev = self.reference.device
        on_card = dev is not None and dev.type == "cuda"
        peaks = device_peaks(dev) if on_card else device_peaks("cpu")
        roof = roofline(perf["flops"], perf["bytes"], perf["solve_s"],
                        peaks, perf_exempt=not on_card)
        self.events.emit(
            "perf_model", stage="serve", lane="serve-project",
            predicted={"flops": perf["flops"], "bytes": perf["bytes"],
                       "iters_assumed_cap": True},
            measured={"wall_s": round(perf["solve_s"], 4),
                      "passes": int(perf["batches"]),
                      "lanes": int(perf["lanes"])},
            roofline=roof)

    def stats(self) -> dict:
        from ..utils.profiling import latency_summary

        with self._lock:
            out = dict(self._stats)
            lat = list(self._latencies)
            lat_dropped = self._lat_dropped
            out["quarantined_tenants"] = sorted(self._quarantined)
            out["programs_warmed"] = sum(
                1 for v in self._programs.values() if v)
        out["batched_fraction"] = (
            round(out["multi_request_batches"] / out["batches"], 3)
            if out["batches"] else 0.0)
        out["mean_lanes"] = (round(out["lanes_total"] / out["batches"], 2)
                             if out["batches"] else 0.0)
        out["latency_ms"] = latency_summary(lat)
        out["latency_samples_kept"] = len(lat)
        out["latency_samples_dropped"] = lat_dropped
        out["latency_window_coverage"] = (
            round(len(lat) / (len(lat) + lat_dropped), 6)
            if len(lat) + lat_dropped else 1.0)
        slo = self.slo_status()
        if slo is not None:
            out["slo"] = slo
        out["reference"] = self.reference.describe()
        out["buckets"] = list(self.buckets)
        out["lane_buckets"] = list(self.b_buckets)
        out["warmup_s"] = self.warmup_s
        return out
