"""Per-stage tracing: the wall-clock ledger and optional profiler traces.

Own copy of ``cnmf_torch_tpu/utils/profiling.py``:

  * :class:`StageTimer` records each pipeline stage's wall clock (and
    optional metadata) to ``<run_dir>/cnmf_tmp/<name>.timings.tsv``,
    appended across invocations, and mirrors every row into the run's
    event log as a ``stage`` event;
  * :func:`trace` wraps a stage in one ``torch.profiler`` session when
    ``CNMF_TPU_PROFILE_DIR`` is set and writes a Chrome trace of it under
    ``<dir>/<stage>/`` (CPU activity, and CUDA activity where a card is
    present); unset, it does nothing;
  * :func:`percentile` and :func:`latency_summary` are the one latency
    summary of the report and the metrics registry.

A stage's wall is the host's: a stage that returned with work still
queued on the card would under-report, so each pipeline stage ends in
host reads (its artifacts' writes).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

__all__ = ["StageTimer", "trace", "PROFILE_ENV", "percentile",
           "latency_summary", "HIST_EDGES"]

PROFILE_ENV = "CNMF_TPU_PROFILE_DIR"

# log-ish histogram bucket edges for latency summaries, in the caller's
# unit (serving uses milliseconds): fine buckets where SLOs live, coarse
# tails, one overflow bucket. Shared with the live metrics registry
# (obs/metrics.py) so a scraped /metrics histogram and the post-hoc
# report's latency_summary bucket the same way.
_HIST_EDGES = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
               1000.0, 2000.0, 5000.0)
HIST_EDGES = _HIST_EDGES


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile (numpy's default method) over an
    unsorted sequence — the ONE percentile implementation, shared by the
    telemetry report's serving section and the SLO tracker."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of an empty sequence")
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * (float(q) / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def latency_summary(values, percentiles=(50.0, 95.0, 99.0)) -> dict:
    """Latency distribution summary: count/mean/max, the requested
    percentiles (``p50``/``p95``/``p99`` keys), and a fixed-edge histogram
    (``{"<=1", ..., ">5000": count}`` in the caller's unit — serving
    passes milliseconds). Empty input yields ``{"count": 0}`` so callers
    can always embed the result."""
    vals = [float(v) for v in values]
    if not vals:
        return {"count": 0}
    out = {"count": len(vals),
           "mean": sum(vals) / len(vals),
           "max": max(vals)}
    for q in percentiles:
        label = ("p%g" % q).replace(".", "_")
        out[label] = percentile(vals, q)
    hist: dict = {}
    edges = _HIST_EDGES
    for v in vals:
        for edge in edges:
            if v <= edge:
                label = "<=%g" % edge
                break
        else:
            label = ">%g" % edges[-1]
        hist[label] = hist.get(label, 0) + 1
    # stable bucket order (dicts preserve insertion): edges first, overflow
    ordered = {}
    for edge in edges:
        label = "<=%g" % edge
        if label in hist:
            ordered[label] = hist[label]
    overflow = ">%g" % edges[-1]
    if overflow in hist:
        ordered[overflow] = hist[overflow]
    out["histogram"] = ordered
    return out


def _sanitize_field(v) -> str:
    """TSV fields are single-line, tab-free by contract: meta values with
    tabs/newlines would shift every later column and corrupt positional
    parsers."""
    s = str(v)
    for ch in ("\t", "\n", "\r"):
        if ch in s:
            s = s.replace(ch, " ")
    return s


class StageTimer:
    """Append-only wall-clock ledger for pipeline stages.

    Thread-safe: concurrent stages (the JAX package's ``k_selection_plot``
    runs its stats passes in threads) may record into one TSV — records
    serialize under a lock so the header is written exactly once and rows
    never interleave mid-line (readers parse the file positionally).

    ``events``: optional :class:`~.telemetry.EventLog`
    — every recorded row is mirrored as a ``stage`` event, so the
    structured stream carries the same walls/bytes as the TSV without a
    second measurement site."""

    # one warning per PROCESS when the ledger is unwritable: per-instance
    # state would re-warn for every stats pass of a K-selection sweep
    _oserror_warned = False
    _oserror_lock = threading.Lock()

    def __init__(self, timings_path: str | None, events=None):
        self.timings_path = timings_path
        self.events = events
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int | None = None, **meta):
        """Time a stage. ``nbytes`` (bytes the stage moved/produced) fills
        the throughput columns — staging stages record it so host_prep vs
        H2D vs device walls carry GB/s, not just seconds."""
        t0 = time.perf_counter()
        err = ""
        try:
            yield
        except BaseException as exc:
            err = type(exc).__name__
            raise
        finally:
            elapsed = time.perf_counter() - t0
            self._record(name, elapsed, err, meta, nbytes)

    def record(self, name: str, seconds: float, nbytes: int | None = None,
               **meta):
        """Append a pre-measured row (a caller that measures its phases
        across threads itself, where a context manager around one of them
        would measure the wrong wall)."""
        self._record(name, float(seconds), "", meta, nbytes)

    def _record(self, name: str, elapsed: float, err: str, meta: dict,
                nbytes: int | None = None):
        if self.events is not None:
            self.events.emit("stage", stage=str(name),
                             wall_s=round(float(elapsed), 6),
                             nbytes=int(nbytes) if nbytes else None,
                             error=err or None,
                             meta={str(k): meta[k] for k in sorted(meta)}
                             if meta else None)
        if self.timings_path is None:
            return
        meta_str = ";".join(f"{k}={_sanitize_field(v)}"
                            for k, v in sorted(meta.items()))
        gbps = ("" if not nbytes or elapsed <= 0
                else f"{nbytes / elapsed / 1e9:.3f}")
        try:
            with self._lock:
                header_needed = not os.path.exists(self.timings_path)
                # append-only ledger, not a probed artifact: an atomic
                # rewrite would drop rows raced in by sibling processes,
                # and a torn tail row is tolerated by every reader
                with open(self.timings_path, "a") as f:  # cnmf-lint: disable=artifact-nonatomic
                    if header_needed:
                        # bytes/gb_per_s sit AFTER wall_seconds: the
                        # JAX package's parsers read columns [:2]
                        # positionally
                        f.write("stage\twall_seconds\tbytes\tgb_per_s\t"
                                "timestamp\terror\tmeta\n")
                    f.write(f"{_sanitize_field(name)}\t{elapsed:.4f}\t"
                            f"{nbytes if nbytes else ''}\t{gbps}\t"
                            f"{time.time():.1f}\t{_sanitize_field(err)}\t"
                            f"{meta_str}\n")
        except OSError as exc:
            # tracing must never take the pipeline down — but a silently
            # missing ledger cost a round of debugging; warn once/process
            with StageTimer._oserror_lock:
                if not StageTimer._oserror_warned:
                    StageTimer._oserror_warned = True
                    import warnings

                    warnings.warn(
                        "StageTimer: cannot append to %r (%s); timing rows "
                        "from this process will be dropped silently from "
                        "here on" % (self.timings_path, exc),
                        RuntimeWarning, stacklevel=3)


# One profiler session at a time: stages both NEST in one thread
# (k_selection_plot -> its consensus sub-stages) and could run
# CONCURRENTLY across threads. A non-blocking lock serves both: the first
# stage to acquire owns the session, every nested or concurrent stage
# inside it is a no-op (nested device work is already captured by the
# outer session; concurrent stages go untraced rather than opening a
# second profiler, which raises).
_trace_lock = threading.Lock()


@contextlib.contextmanager
def trace(stage_name: str):
    """``torch.profiler`` trace of a stage when CNMF_TPU_PROFILE_DIR is
    set: one Chrome trace (``<dir>/<stage>/<host>.<pid>.<time>.pt.trace
    .json``) of CPU activity and, where a card is present, CUDA activity.

    Reentrant- and thread-safe: only one profiler session can exist, so
    whichever stage acquires the (non-blocking) session lock first traces;
    stages nested inside it or racing it from sibling threads no-op.
    """
    from .envknobs import env_str

    profile_dir = env_str(PROFILE_ENV, "")
    if not profile_dir or not _trace_lock.acquire(blocking=False):
        yield
        return
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(profile_dir, stage_name)
    try:
        with profile(activities=activities) as prof:
            yield
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, "%s.%d.%d.pt.trace.json"
            % (socket.gethostname(), os.getpid(), time.time_ns())))
    finally:
        _trace_lock.release()
