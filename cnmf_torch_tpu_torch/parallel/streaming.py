"""Pipelined host-to-card staging: the bounded streaming engine behind
every matrix upload of the row-sharded path.

Port of ``cnmf_torch_tpu/parallel/streaming.py`` for one device:

  * :func:`run_pipeline` — a sliding-window producer/consumer: slab
    preparation (CSR row slicing, the copy into pinned host memory and
    the host-to-card copy) runs on a small thread pool, and the caller
    thread commits each slab on the card in task order. At most
    ``CNMF_TPU_STREAM_DEPTH`` slabs are prepared but not committed, and a
    host-bytes budget clamps that window. Depth 1 (or 0 threads) is the
    serial loop. An optional disk-producer stage (``source``) reads
    shard-store slabs on its own thread ahead of the workers.
  * :class:`SlabBufferPool` — reusable host staging buffers, pinned on a
    card: each remembers its dirty prefix, so reuse zeroes only what the
    previous slab wrote beyond the new one.
  * the copies: a worker fills a pinned buffer, issues the copy with
    ``non_blocking=True`` on a side CUDA stream and records an event; the
    commit makes the caller's stream wait on that event before it uses
    the slab, so a slab is never read before its copy lands.
  * CSR slabs densify on the card with ``index_put_`` without
    accumulation: a slab's (row, column) pairs are unique, so no atomic
    add is involved and two runs give the same bits.
  * :class:`StreamStats` — the per-phase wall ledger (disk, host prep,
    host-to-card, device, end to end, bytes) and the host slab-residency
    peak, folded into a ``stream`` event.

Fault containment: a failed slab prep or copy retries with bounded
exponential backoff (``CNMF_TPU_SHARD_RETRIES``,
``CNMF_TPU_SHARD_BACKOFF_S``) before :class:`ShardUploadError`; a slab
that makes no progress for ``CNMF_TPU_STREAM_STALL_S`` seconds raises
:class:`ShardStallError` from the commit-side watchdog. The ``stall``
fault hook sits where a hung copy would, and ``upload`` at the staging
entry (``runtime/faults.py``).

Knobs: ``CNMF_TPU_STREAM_DEPTH`` (default ``2 x threads + 1``; ``1``
serial), ``CNMF_TPU_STREAM_THREADS`` (default ``min(4, cores - 1)``; ``0``
serial), ``CNMF_TPU_STREAM_BYTES`` (in-flight host bytes, default 4 GiB),
``CNMF_TPU_SHARD_RETRIES``, ``CNMF_TPU_SHARD_BACKOFF_S`` and
``CNMF_TPU_STREAM_STALL_S``; each is validated when read.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..obs import metrics as obs_metrics
from ..runtime.faults import maybe_fail as _maybe_fail_fault
from ..utils.envknobs import env_float as _env_float
from ..utils.envknobs import env_int as _env_int
from ..utils.envknobs import env_str as _env_str

__all__ = ["StreamStats", "SlabBufferPool", "run_pipeline", "nnz_bucket",
           "stream_threads", "stream_depth", "stream_to_device",
           "stream_store", "put_arrays", "running_liveness", "SLAB_ROWS",
           "PIN_CHUNK_BYTES", "ShardStallError", "ShardUploadError",
           "shard_retries", "stream_stall_s"]

# rows per slab of an in-memory matrix's staging
SLAB_ROWS = 65_536
# bytes a pinned staging buffer holds: a larger array crosses in pieces
PIN_CHUNK_BYTES = 32 << 20

DEPTH_ENV = "CNMF_TPU_STREAM_DEPTH"
THREADS_ENV = "CNMF_TPU_STREAM_THREADS"
BYTES_ENV = "CNMF_TPU_STREAM_BYTES"
SHARD_RETRIES_ENV = "CNMF_TPU_SHARD_RETRIES"
SHARD_BACKOFF_ENV = "CNMF_TPU_SHARD_BACKOFF_S"
STALL_ENV = "CNMF_TPU_STREAM_STALL_S"

_DEFAULT_BYTES_BUDGET = 4 << 30


class ShardUploadError(RuntimeError):
    """A slab upload kept failing after the ``CNMF_TPU_SHARD_RETRIES``
    budget: the staged matrix cannot be completed."""


class ShardStallError(RuntimeError):
    """A slab upload made no progress for ``CNMF_TPU_STREAM_STALL_S``
    seconds: a hang turned into a failure that names the slab."""


def shard_retries() -> int:
    """Per-slab upload retry budget (``CNMF_TPU_SHARD_RETRIES``, default
    2; 0: the first failure raises)."""
    return _env_int(SHARD_RETRIES_ENV, 2, lo=0)


def stream_stall_s() -> float:
    """Per-slab progress watchdog in seconds (``CNMF_TPU_STREAM_STALL_S``,
    default 0 = off); enforced on the threaded path, where the commit
    thread awaits the workers."""
    return _env_float(STALL_ENV, 0.0, lo=0.0)


def stream_threads() -> int:
    """Host-prep worker count: ``CNMF_TPU_STREAM_THREADS`` when set, else
    the measured staging point of the autotune cache
    (``utils/autotune.py``), else a default that leaves one core to the
    committing thread (pin > autotuned > heuristic); 0 is the serial
    path."""
    static = max(1, min(4, (os.cpu_count() or 2) - 1))
    if _env_str(THREADS_ENV, "").strip() == "":
        from ..utils.autotune import cached_plan_point

        tuned = cached_plan_point("stream_threads")
        if tuned is not None:
            return max(0, int(tuned))
    return _env_int(THREADS_ENV, static, lo=0)


def stream_depth(slab_bytes: int | None = None,
                 threads: int | None = None, windows: int = 1) -> int:
    """In-flight slab cap: ``CNMF_TPU_STREAM_DEPTH``, else two a worker
    plus one, clamped so ``windows`` depth-sized windows of slab buffers
    stay under the ``CNMF_TPU_STREAM_BYTES`` budget."""
    if threads is None:
        threads = stream_threads()
    depth = _env_int(DEPTH_ENV, max(2 * threads + 1, 3), lo=1)
    if slab_bytes and slab_bytes > 0:
        budget = _env_int(BYTES_ENV, _DEFAULT_BYTES_BUDGET, lo=1)
        depth = min(depth,
                    max(budget // (int(slab_bytes) * max(windows, 1)), 1))
    return max(depth, 1)


class StreamStats:
    """Thread-safe per-phase wall ledger of one staging run.

    ``host_prep_s`` / ``h2d_s`` / ``disk_s`` accumulate across worker
    threads (their sum can exceed ``wall_s``: that is the overlap);
    ``device_s`` is the commits plus the closing synchronize; ``wall_s``
    is end to end; ``host_peak_bytes`` the host slab-residency high-water
    mark; the ``store_*`` fields a remote store backend's counters over
    the run (:meth:`fold_store_counters`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.host_prep_s = 0.0
        self.h2d_s = 0.0
        self.device_s = 0.0
        self.wall_s = 0.0
        self.nbytes = 0
        self.slabs = 0
        self.disk_s = 0.0
        self.disk_nbytes = 0
        self.host_peak_bytes = 0
        self.store_remote = False
        self.store_retries = 0
        self.store_hedges = 0
        self.store_hedges_won = 0
        self.store_cache_hits = 0
        self.store_cache_misses = 0
        self.store_degraded = 0

    def add(self, host_prep_s=0.0, h2d_s=0.0, device_s=0.0, nbytes=0,
            slabs=0, disk_s=0.0, disk_nbytes=0):
        with self._lock:
            self.host_prep_s += host_prep_s
            self.h2d_s += h2d_s
            self.device_s += device_s
            self.nbytes += nbytes
            self.slabs += slabs
            self.disk_s += disk_s
            self.disk_nbytes += disk_nbytes
        if slabs:
            obs_metrics.counter_inc("cnmf_stream_slabs_total", slabs)
        if nbytes:
            obs_metrics.counter_inc("cnmf_stream_bytes_total", nbytes)

    def fold_store_counters(self, before, after):
        """Fold a remote backend's counter delta (snapshots of
        ``storebackend.backend_counter_snapshot`` before and after the
        run) into this ledger; a no-op when either is None (a local
        backend)."""
        if before is None or after is None:
            return
        with self._lock:
            self.store_remote = True
            for field, key in (("store_retries", "retries"),
                               ("store_hedges", "hedges"),
                               ("store_hedges_won", "hedges_won"),
                               ("store_cache_hits", "cache_hits"),
                               ("store_cache_misses", "cache_misses"),
                               ("store_degraded", "degraded_reads")):
                delta = int(after.get(key, 0)) - int(before.get(key, 0))
                setattr(self, field, getattr(self, field) + max(delta, 0))

    @property
    def overlap_fraction(self) -> float:
        """0 on the serial path (the phase walls sum to the end-to-end
        wall), towards 1 when the phases hide behind each other."""
        busy = self.host_prep_s + self.h2d_s + self.device_s + self.disk_s
        if busy <= 0.0 or self.wall_s <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.wall_s / busy))

    def gb_per_s(self) -> float:
        return (self.nbytes / self.wall_s / 1e9) if self.wall_s > 0 else 0.0

    def read_gb_per_s(self) -> float:
        return (self.disk_nbytes / self.disk_s / 1e9) if self.disk_s > 0 \
            else 0.0

    def record_to(self, timer, prefix: str):
        """One row a phase, then the wall, in a ``StageTimer`` (the
        timings TSV): ``<prefix>/disk`` (only after a disk read),
        ``/host_prep``, ``/h2d``, ``/device`` and ``/wall`` with the JAX
        package's fields. The walls are already read: ``device_s``
        closes with the staging's synchronize."""
        if timer is None:
            return
        if self.disk_s > 0:
            timer.record(f"{prefix}/disk", self.disk_s,
                         nbytes=self.disk_nbytes)
        timer.record(f"{prefix}/host_prep", self.host_prep_s)
        timer.record(f"{prefix}/h2d", self.h2d_s, nbytes=self.nbytes)
        timer.record(f"{prefix}/device", self.device_s)
        timer.record(f"{prefix}/wall", self.wall_s, nbytes=self.nbytes,
                     slabs=self.slabs,
                     overlap=round(self.overlap_fraction, 3))

    def __repr__(self):
        return (f"StreamStats(wall={self.wall_s:.3f}s "
                f"prep={self.host_prep_s:.3f}s h2d={self.h2d_s:.3f}s "
                f"device={self.device_s:.3f}s disk={self.disk_s:.3f}s "
                f"bytes={self.nbytes} slabs={self.slabs} "
                f"overlap={self.overlap_fraction:.2f})")


class _Buf:
    __slots__ = ("tensor", "arr", "used")

    def __init__(self, tensor):
        self.tensor = tensor
        self.arr = tensor.numpy()
        self.used = 0  # dirty prefix length from the previous fill


class SlabBufferPool:
    """Reusable host slab buffers keyed by (shape, dtype), in pinned
    memory when ``pin`` (the source of a non-blocking copy to the card).
    ``fill`` writes the payload prefix and zeroes only the stale
    remainder of the previous occupant. A buffer goes back (``give``)
    only after the copy that reads it has completed."""

    def __init__(self, pin: bool = False):
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._free: dict = collections.defaultdict(list)
        self.allocated = 0

    def take(self, shape, dtype) -> _Buf:
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        key = (shape, np.dtype(dtype).str)
        with self._lock:
            free = self._free[key]
            if free:
                return free.pop()
            self.allocated += 1
        t = torch.from_numpy(np.zeros(0, np.dtype(dtype)))
        return _Buf(torch.zeros(shape, dtype=t.dtype, pin_memory=self.pin))

    def give(self, buf: _Buf):
        key = (tuple(buf.arr.shape), buf.arr.dtype.str)
        with self._lock:
            self._free[key].append(buf)

    @staticmethod
    def fill(buf: _Buf, data) -> np.ndarray:
        n = len(data)
        buf.arr[:n] = data
        if buf.used > n:
            buf.arr[n:buf.used] = 0
        buf.used = n
        return buf.arr


def nnz_bucket(nnz: int, cap: int, floor: int = 1024) -> int:
    """The smallest power-of-two size that fits ``nnz`` (never below
    ``floor``, never above ``cap``): slab buffers come in few sizes, so
    the pool reuses them."""
    cap = max(int(cap), 1)
    b = max(int(floor), 1)
    n = max(int(nnz), 1)
    while b < n:
        b <<= 1
    return min(b, cap)


def _emit_fault(events, kind: str, context: dict):
    if events is None:
        return
    try:
        events.emit("fault", kind=kind, context=context)
    except Exception:
        pass


def _retrying(prep, context: str | None, events, heartbeat: dict | None = None,
              cancelled: threading.Event | None = None):
    """Wrap a slab prep with the retry policy: a failed prep or copy
    retries with exponential backoff before the slab fails the staging
    call as :class:`ShardUploadError`. Hosts the ``stall`` fault hook,
    where a real hang would sit. ``heartbeat`` (threaded path) is stamped
    at the start of every attempt, and forward over a backoff sleep, so
    the stall watchdog measures progress per attempt. ``cancelled``: set
    when the watchdog gave up on the pipeline; a worker that wakes later
    starts no fresh work. A :class:`~..utils.shardstore.TornShardError`
    already spent the shard reader's own re-read budget and passes
    through."""
    retries = shard_retries()
    backoff = _env_float(SHARD_BACKOFF_ENV, 0.1, lo=0.0)

    from ..runtime.faults import maybe_stall as _maybe_stall

    def wrapped(task, *extra):
        attempt = 0
        while True:
            if heartbeat is not None:
                heartbeat[id(task)] = time.monotonic()
            if attempt == 0:
                _maybe_stall(context=context)
            if cancelled is not None and cancelled.is_set():
                raise ShardStallError(
                    "staging call already aborted by the stall watchdog "
                    "(context=%s, task=%s); abandoned worker skips fresh "
                    "prep work" % (context, task))
            try:
                return prep(task, *extra)
            except (ShardStallError, ShardUploadError, KeyboardInterrupt,
                    SystemExit):
                raise
            except Exception as exc:
                # a torn slab already spent read_slab's own re-reads, and a
                # RemoteStoreError the transport's retries: running either
                # again here would square the retries and misreport the
                # fault as shard_upload_failed
                from ..utils.shardstore import RemoteStoreError, TornShardError

                if isinstance(exc, (TornShardError, RemoteStoreError)):
                    raise
                attempt += 1
                ctx = {"context": str(context), "task": str(task),
                       "attempt": attempt,
                       "error": f"{type(exc).__name__}: {exc}"}
                if attempt > retries:
                    _emit_fault(events, "shard_upload_failed", ctx)
                    raise ShardUploadError(
                        "shard upload failed after %d attempt(s) "
                        "(context=%s, task=%s): %s: %s — raise %s to retry "
                        "transient transfer faults more"
                        % (attempt, context, task, type(exc).__name__, exc,
                           SHARD_RETRIES_ENV)) from exc
                _emit_fault(events, "shard_retry", ctx)
                delay = backoff * (2 ** (attempt - 1))
                warnings.warn(
                    "shard upload attempt %d/%d failed (%s: %s); retrying "
                    "in %.2gs" % (attempt, retries, type(exc).__name__, exc,
                                  delay),
                    RuntimeWarning, stacklevel=2)
                if heartbeat is not None:
                    heartbeat[id(task)] = time.monotonic() + delay
                time.sleep(delay)

    return wrapped


def run_pipeline(tasks, prep, commit, *, depth: int | None = None,
                 threads: int | None = None, fault_context: str | None = None,
                 events=None, liveness=None, source=None):
    """Sliding-window pipeline: ``prep(task)`` on worker threads, at most
    ``depth`` tasks prepared but not committed; ``commit(task, payload)``
    on the caller thread in submission order. ``depth <= 1``,
    ``threads <= 0`` or a single task run the serial loop (no thread).

    ``source``: an optional disk-producer stage — ``source(task)`` runs on
    one reader thread ahead of the workers, within the same window, and
    ``prep`` is then called as ``prep(task, raw)``; a prep retry reuses
    the raw payload it was given (no re-read).

    Every prep runs under :func:`_retrying`; on the threaded path the
    commit side enforces the ``CNMF_TPU_STREAM_STALL_S`` watchdog and
    abandons (does not join) a stalled worker.

    ``liveness``: an optional ``runtime.elastic.Heartbeat`` (anything with
    its ``beat(phase=, cursor=, force=)``), stamped on the committing
    thread after every committed slab as ``stage:<fault_context>`` with
    the slab's index, so a worker in a long staging reads as alive to the
    launcher's straggler check. ``Heartbeat.beat`` is throttled and never
    raises."""
    tasks = list(tasks)
    if threads is None:
        threads = stream_threads()
    if depth is None:
        depth = stream_depth(threads=threads)
    stall_s = stream_stall_s()
    read_context = f"{fault_context or 'stream'}:read"
    phase = f"stage:{fault_context or 'stream'}"

    def committed(i: int):
        if liveness is not None:
            liveness.beat(phase=phase, cursor=i)

    if depth <= 1 or threads <= 0 or len(tasks) <= 1:
        if source is not None:
            src_serial = _retrying(source, read_context, events)
            prep_serial = _retrying(prep, fault_context, events)
            for i, t in enumerate(tasks):
                commit(t, prep_serial(t, src_serial(t)))
                committed(i)
            return
        serial_prep = _retrying(prep, fault_context, events)
        for i, t in enumerate(tasks):
            commit(t, serial_prep(t))
            committed(i)
        return
    import concurrent.futures

    heartbeat: dict = {}
    cancelled = threading.Event()
    src_ex = None
    if source is not None:
        src_wrapped = _retrying(source, read_context, events,
                                heartbeat=heartbeat, cancelled=cancelled)
        src_ex = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="cnmf-stream-disk")
        base_prep = prep

        def prep(task, raw_fut):  # noqa: F811 — staged twin of the bare prep
            return base_prep(task, raw_fut.result())

    prep = _retrying(prep, fault_context, events, heartbeat=heartbeat,
                     cancelled=cancelled)

    def await_result(task, fut):
        if stall_s <= 0:
            return fut.result()
        poll = min(max(stall_s / 10.0, 0.05), 1.0)
        while True:
            try:
                return fut.result(timeout=poll)
            except concurrent.futures.TimeoutError:
                last = heartbeat.get(id(task))
                if last is not None and time.monotonic() - last <= stall_s:
                    continue
                if last is None and not fut.running():
                    continue  # still queued behind other slabs
                ctx = {"context": str(fault_context), "task": str(task),
                       "stall_s": stall_s}
                _emit_fault(events, "shard_stall", ctx)
                raise ShardStallError(
                    "shard upload made no progress for %gs (%s; context=%s, "
                    "task=%s) — the transfer is hung, not slow. Aborting "
                    "this staging call cleanly; relaunch resumes from the "
                    "newest valid checkpoint." % (stall_s, STALL_ENV,
                                                  fault_context, task)) \
                    from None

    pending = collections.deque()
    n_done = 0
    ex = concurrent.futures.ThreadPoolExecutor(
        max_workers=min(threads, len(tasks)),
        thread_name_prefix="cnmf-stream")
    try:
        for t in tasks:
            if len(pending) >= depth:
                tt, fut = pending.popleft()
                commit(tt, await_result(tt, fut))
                committed(n_done)
                n_done += 1
            if src_ex is not None:
                pending.append((t, ex.submit(prep, t,
                                             src_ex.submit(src_wrapped, t))))
            else:
                pending.append((t, ex.submit(prep, t)))
        while pending:
            tt, fut = pending.popleft()
            commit(tt, await_result(tt, fut))
            committed(n_done)
            n_done += 1
    except ShardStallError:
        cancelled.set()
        if src_ex is not None:
            src_ex.shutdown(wait=False, cancel_futures=True)
        ex.shutdown(wait=False, cancel_futures=True)
        raise
    except BaseException:
        if src_ex is not None:
            src_ex.shutdown(wait=True, cancel_futures=True)
        ex.shutdown(wait=True, cancel_futures=True)
        raise
    else:
        if src_ex is not None:
            src_ex.shutdown(wait=True)
        ex.shutdown(wait=True)


# ---------------------------------------------------------------------------
# host-to-card copies
# ---------------------------------------------------------------------------

class _Uploader:
    """Host arrays to one device. On a card each array crosses in pieces
    of at most :data:`PIN_CHUNK_BYTES` through pinned buffers of a
    :class:`SlabBufferPool`, ``non_blocking`` on a side stream, two pieces
    in flight; an event recorded after the last copy is waited on by the
    worker (so its pinned buffers go back to the pool) and by the
    committing thread's stream before it reads the arrays. On the CPU the
    arrays are wrapped as they are."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pool = SlabBufferPool(pin=self.cuda)
        self._stream = (torch.cuda.Stream(device=self.device) if self.cuda
                        else None)

    def put(self, arrays):
        """``(device tensors, event)`` of host numpy ``arrays``."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if not self.cuda:
            return [torch.from_numpy(a) for a in arrays], None
        outs, inflight = [], collections.deque()
        with torch.cuda.stream(self._stream):
            for a in arrays:
                src = a.reshape(-1)
                d = torch.empty(a.shape, device=self.device,
                                dtype=torch.from_numpy(src[:0]).dtype)
                dst = d.view(-1)
                step = max(1, PIN_CHUNK_BYTES // max(a.itemsize, 1))
                for lo in range(0, a.size, step):
                    hi = min(lo + step, a.size)
                    if len(inflight) >= 2:
                        ev, buf = inflight.popleft()
                        ev.synchronize()
                        self.pool.give(buf)
                    # power-of-two sizes, so slabs of similar nnz share
                    buf = self.pool.take((nnz_bucket(hi - lo, step),),
                                         a.dtype)
                    SlabBufferPool.fill(buf, src[lo:hi])
                    dst[lo:hi].copy_(buf.tensor[:hi - lo], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self._stream)
                    inflight.append((ev, buf))
                outs.append(d)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()
        for _, buf in inflight:
            self.pool.give(buf)
        return outs, event

    def ready(self, tensors, event):
        """Order the current stream after the copy of ``tensors``."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in tensors:
            t.record_stream(cur)


def put_arrays(arrays, device, stats: StreamStats | None = None):
    """Host arrays as tensors on ``device`` (pinned, non-blocking on a
    side stream on a card), ready on the current stream."""
    t0 = time.perf_counter()
    up = _Uploader(device)
    outs, event = up.put(arrays)
    up.ready(outs, event)
    if stats is not None:
        stats.add(h2d_s=time.perf_counter() - t0, slabs=1,
                  nbytes=sum(int(np.asarray(a).nbytes) for a in arrays))
    return outs


def _csr_parts(blk: sp.csr_matrix, dtype):
    """A CSR row block's values, int32 columns and rebased int32 indptr."""
    return (blk.data.astype(dtype, copy=False),
            blk.indices.astype(np.int32, copy=False),
            (blk.indptr - blk.indptr[0]).astype(np.int32))


def _densify(out, lo: int, hi: int, vals, cols, indptr):
    """Scatter one CSR slab into rows ``[lo, hi)`` of the dense ``out``:
    row ids from ``indptr`` on the card, then ``index_put_`` without
    accumulation (the slab's coordinates are unique)."""
    nnz = int(vals.shape[0])
    if nnz == 0:
        return
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(hi - lo, device=out.device), counts, output_size=nnz)
    out[lo:hi].index_put_((rows, cols.long()), vals.to(out.dtype))


class _RunningLiveness:
    """The liveness target of a staging call that runs several pipelines
    in turn (one a shard, or one a replicate row): every beat carries the
    call's running count of committed slabs as its cursor, so the cursors
    of the whole call run ``0..n-1`` as one pipeline's do."""

    def __init__(self, liveness):
        self.liveness = liveness
        self.done = 0

    def beat(self, phase=None, cursor=None, force: bool = False):
        self.done += 1
        return self.liveness.beat(phase=phase, cursor=self.done - 1,
                                  force=force)


def running_liveness(liveness):
    """``liveness`` as a :class:`_RunningLiveness` (None and an already
    running one are returned as they are)."""
    if liveness is None or isinstance(liveness, _RunningLiveness):
        return liveness
    return _RunningLiveness(liveness)


def _stage(n_out: int, g: int, tasks, prep_host, commit_host, device,
           dtype, stats, events, fault_context, slab_bytes, source=None,
           depth_cap=None, liveness=None):
    """The shared staging loop: ``prep_host(task[, raw]) -> (arrays,
    meta)`` on the workers, each slab's arrays copied to ``device``;
    ``commit_host(out, task, tensors, meta)`` on the caller thread."""
    t_wall = time.perf_counter()
    dev = torch.device(device)
    out = torch.zeros((n_out, g), dtype=dtype, device=dev)
    up = _Uploader(dev)
    threads = stream_threads()
    depth = stream_depth(slab_bytes=slab_bytes, threads=threads, windows=2)
    if depth_cap is not None:
        depth = max(1, min(depth, depth_cap))

    def prep(task, *raw):
        t0 = time.perf_counter()
        arrays, meta = prep_host(task, *raw)
        t1 = time.perf_counter()
        tensors, event = up.put(arrays)
        if stats is not None:
            stats.add(host_prep_s=t1 - t0, h2d_s=time.perf_counter() - t1,
                      slabs=1, nbytes=sum(int(a.nbytes) for a in arrays))
        return tensors, event, meta

    def commit(task, payload):
        tensors, event, meta = payload
        t0 = time.perf_counter()
        up.ready(tensors, event)
        commit_host(out, task, tensors, meta)
        if stats is not None:
            stats.add(device_s=time.perf_counter() - t0)

    run_pipeline(tasks, prep, commit, depth=depth, threads=threads,
                 fault_context=fault_context, events=events,
                 liveness=liveness, source=source)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if stats is not None:
        stats.add(device_s=time.perf_counter() - t0)
        stats.wall_s += time.perf_counter() - t_wall
    return out


def stream_to_device(X, device, dtype=torch.float32, pad_rows: int = 0,
                     stats: StreamStats | None = None, events=None,
                     liveness=None):
    """One host matrix (dense or scipy-sparse) as a dense tensor on
    ``device``, with ``pad_rows`` zero rows appended, through the
    pipeline: CSR slabs of :data:`SLAB_ROWS` rows cross as (values,
    columns, indptr) and densify on the card (the dense matrix never
    exists on the host); dense slabs cross as they are. The staging
    contexts are the JAX package's: ``stream_csr:csr`` (its CSR
    transport, the port's only one) and ``stream_dense``; ``liveness`` is
    stamped per committed slab (:func:`run_pipeline`)."""
    _maybe_fail_fault("upload", context="stream_to_device")
    n, g = X.shape
    n_out = n + int(pad_rows)
    tasks = [(lo, min(lo + SLAB_ROWS, n)) for lo in range(0, n, SLAB_ROWS)]
    if sp.issparse(X):
        Xc = X.tocsr()
        max_nnz = max((int(Xc.indptr[hi] - Xc.indptr[lo])
                       for lo, hi in tasks), default=1)
        slab_bytes = max(max_nnz, 1) * 8

        def prep_host(task):
            lo, hi = task
            return _csr_parts(Xc[lo:hi], np.float32), None

        def commit_host(out, task, t, meta):
            _densify(out, task[0], task[1], *t)

        context = "stream_csr:csr"
    else:
        Xd = np.asarray(X)
        slab_bytes = SLAB_ROWS * g * 4

        def prep_host(task):
            lo, hi = task
            return [np.asarray(Xd[lo:hi], dtype=np.float32)], None

        def commit_host(out, task, t, meta):
            out[task[0]:task[1]].copy_(t[0])

        context = "stream_dense"
    return _stage(n_out, g, tasks, prep_host, commit_host, device,
                  dtype, stats, events, context, slab_bytes,
                  liveness=liveness)


def stream_store(cursor, device, dtype=torch.float32, *,
                 stats: StreamStats | None = None, events=None,
                 liveness=None, pad_rows: int = 0):
    """A shard-store row range straight from disk into a dense tensor on
    ``device``: slab reads on the disk-producer thread, slicing and the
    copy on the workers, placement on the caller thread. The whole matrix
    never exists on the host: in-flight slab bytes stay under
    ``CNMF_TPU_OOC_BUDGET_BYTES`` (one slab is the floor), and the
    realized peak lands in ``stats.host_peak_bytes``. Values are placed,
    never summed, so the result is bit for bit the in-memory matrix's
    staging. ``cursor``: a :class:`~..utils.shardstore.SlabCursor`;
    ``pad_rows`` zero rows are appended (no disk read). ``liveness`` is
    stamped per committed slab as ``stage:stream_store``
    (:func:`run_pipeline`)."""
    from ..utils.shardstore import ooc_budget_bytes
    from ..utils.storebackend import backend_counter_snapshot

    store = cursor.store
    bk_before = backend_counter_snapshot(store)
    base = cursor.rows[0]
    g = store.n_genes
    n_out = cursor.n_rows + int(pad_rows)
    segs = cursor.tasks()  # (slab_i, global_lo, global_hi)
    max_raw = max((int(store.slabs[si]["raw_bytes"]) for si, _, _ in segs),
                  default=0)
    task_bytes = max(2 * max_raw, 1)
    residency = cursor.residency

    def source(task):
        si, glo, ghi = task
        t0 = time.perf_counter()
        raw = cursor.read(si)  # digest-verified; charges residency
        if stats is not None:
            stats.add(disk_s=time.perf_counter() - t0,
                      disk_nbytes=int(store.slabs[si]["raw_bytes"]))
        return raw

    def prep_host(task, raw):
        si, glo, ghi = task
        a = glo - int(store.slabs[si]["row0"])
        b = a + (ghi - glo)
        if store.format == "csr":
            return _csr_parts(raw[a:b], np.float32), si
        return [np.asarray(raw[a:b], dtype=np.float32)], si

    def commit_host(out, task, t, si):
        _, glo, ghi = task
        lo, hi = glo - base, ghi - base
        if store.format == "csr":
            _densify(out, lo, hi, *t)
        else:
            out[lo:hi].copy_(t[0])
        cursor.release(si)

    out = _stage(n_out, g, segs, prep_host, commit_host, device,
                 dtype, stats, events, "stream_store", task_bytes,
                 source=source,
                 depth_cap=ooc_budget_bytes() // (task_bytes * 3),
                 liveness=liveness)
    if stats is not None:
        stats.host_peak_bytes = max(stats.host_peak_bytes, residency.peak)
        stats.fold_store_counters(bk_before, backend_counter_snapshot(store))
    return out
