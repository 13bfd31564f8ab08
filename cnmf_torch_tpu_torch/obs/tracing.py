"""Sampled distributed request tracing.

Own copy of ``cnmf_torch_tpu/obs/tracing.py``, the same code and text. The
publishers it names (serving, the store backend, streaming, the launcher)
are the JAX package's; each comes to the port with its layer. Today the
port's factorize publishes here.

A trace is one user-visible unit of work — one ``ServeClient.project``
call, or one launcher-driven batch run — stitched across processes by a
16-hex trace id. Each hop emits ``span`` events (schema-registered in
``utils/telemetry.EVENT_TYPES``) into whatever run telemetry JSONL it
already writes; the O_APPEND single-write discipline means client,
daemon, parent, and worker spans interleave safely in one file.

Propagation:

* serve path — ``ServeClient`` samples per request
  (``CNMF_TPU_TRACE_SAMPLE``), sends ``X-CNMF-Trace: <trace>:<span>``;
  the daemon parses it and threads a child context through admission,
  batcher queueing, linger, and the AOT dispatch.
* batch path — the launcher samples once per run and serializes the
  root context into ``CNMF_TPU_TRACE_CTX`` in each worker's env;
  workers (and the store backend under them) pick it up via
  :func:`process_context`.

Sampling is DETERMINISTIC in the trace id: the keep/drop decision is a
pure function of (trace_id, rate), so every process that sees a context
agrees it is sampled — there is no per-hop coin flip to lose spans
mid-trace. Unsampled work creates no context at all (``new_trace``
returns ``None``) and every emit helper is a no-op on ``None``, which
is what keeps the off path at literally zero work.

``cnmf-tpu trace <run_dir>`` renders the collected spans as
per-trace waterfalls (queue wait vs batch linger vs device dispatch vs
store I/O) via :func:`render_run_traces`.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager

from ..utils.envknobs import env_float, env_str

__all__ = [
    "TRACE_SAMPLE_ENV", "TRACE_CTX_ENV", "TRACE_HEADER", "TraceContext",
    "sample_rate", "is_sampled", "new_trace", "child", "header_value",
    "from_header", "env_value", "from_env", "process_context",
    "reset_process_context", "emit_span", "span", "perf_to_wall",
    "load_traces", "render_waterfall", "render_run_traces",
]

TRACE_SAMPLE_ENV = "CNMF_TPU_TRACE_SAMPLE"
TRACE_CTX_ENV = "CNMF_TPU_TRACE_CTX"
TRACE_HEADER = "X-CNMF-Trace"


class TraceContext:
    """Immutable (trace, span, parent) triple. ``span_id`` names the
    span the HOLDER is inside; emitting with this context writes
    ``span=span_id, parent=parent_id``. Children get fresh span ids
    parented on this one."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str, parent_id=None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = None if parent_id is None else str(parent_id)

    def __repr__(self):
        return ("TraceContext(trace=%s, span=%s, parent=%s)"
                % (self.trace_id, self.span_id, self.parent_id))


_ID_LOCK = threading.Lock()
_ID_COUNTER = [0]  # per-process span sequence; bumped under _ID_LOCK


def _new_span_id() -> str:
    with _ID_LOCK:
        _ID_COUNTER[0] += 1
        n = _ID_COUNTER[0]
    return "%x.%x" % (os.getpid(), n)


def sample_rate() -> float:
    """The ``CNMF_TPU_TRACE_SAMPLE`` probability in [0, 1]; 0 (the
    default) disables tracing entirely."""
    return env_float(TRACE_SAMPLE_ENV, 0.0, lo=0.0, hi=1.0)


def is_sampled(trace_id: str, rate=None) -> bool:
    """Deterministic keep/drop: hash the trace id into [0, 1) and keep
    when it falls under the rate. Same id + same rate -> same answer in
    every process, pinned by test."""
    r = sample_rate() if rate is None else float(rate)
    if r <= 0.0:
        return False
    if r >= 1.0:
        return True
    import hashlib

    h = hashlib.sha256(trace_id.encode("ascii")).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64) < r


def new_trace(rate=None):
    """Start a new root trace, or ``None`` when sampling says drop (or
    tracing is off). Root span id doubles as the trace's top of tree."""
    r = sample_rate() if rate is None else float(rate)
    if r <= 0.0:
        return None
    trace_id = uuid.uuid4().hex[:16]
    if not is_sampled(trace_id, r):
        return None
    return TraceContext(trace_id, _new_span_id())


def child(ctx):
    """A fresh span context parented on ``ctx`` (None-propagating)."""
    if ctx is None:
        return None
    return TraceContext(ctx.trace_id, _new_span_id(), ctx.span_id)


# -- wire formats -----------------------------------------------------------

def header_value(ctx) -> str:
    return "%s:%s" % (ctx.trace_id, ctx.span_id)


def from_header(value):
    """Parse an ``X-CNMF-Trace`` header; malformed values are dropped
    (tracing must never fail a request)."""
    if not value:
        return None
    parts = str(value).split(":")
    if len(parts) != 2 or not all(parts):
        return None
    return TraceContext(parts[0], parts[1])


env_value = header_value  # same trace:span serialization on both wires


def from_env():
    """The context serialized into ``CNMF_TPU_TRACE_CTX`` by a launcher
    parent, or ``None``."""
    return from_header(env_str(TRACE_CTX_ENV, ""))


_PROC_LOCK = threading.Lock()
_PROC_CTX: list = []  # memoized [ctx-or-None]; set once under _PROC_LOCK


def process_context():
    """This process's ambient trace context (from env), memoized — the
    batch-path analogue of the serve path's per-request header."""
    with _PROC_LOCK:
        if not _PROC_CTX:
            _PROC_CTX.append(from_env())
        return _PROC_CTX[0]


def reset_process_context() -> None:
    """Tests only: re-read ``CNMF_TPU_TRACE_CTX`` on next use."""
    with _PROC_LOCK:
        _PROC_CTX.clear()


# -- span emission ----------------------------------------------------------

def perf_to_wall(t_perf: float) -> float:
    """Convert a ``time.perf_counter`` stamp into the wall-clock epoch
    used by span ``start_ts``, so spans timed with perf_counter deltas
    (the batcher's request stamps) land on the same axis as everyone
    else's."""
    return time.time() - (time.perf_counter() - t_perf)


def emit_span(events, ctx, name: str, start_ts: float, wall_ms: float,
              **context) -> None:
    """Append one schema-valid ``span`` event; no-op without an enabled
    event log or a sampled context. Never raises past the event layer
    (``EventLog.emit`` already swallows I/O errors)."""
    if ctx is None or events is None:
        return
    if not getattr(events, "enabled", False):
        return
    events.emit("span", trace=ctx.trace_id, span=ctx.span_id,
                parent=ctx.parent_id, name=str(name),
                start_ts=float(start_ts),
                wall_ms=round(float(wall_ms), 3),
                context=context or None)


@contextmanager
def span(events, ctx, name: str, **context):
    """Time a block as one span. ``ctx`` should already be the CHILD
    context for this span (see :func:`child`); yields it so nested
    spans can parent on it."""
    if ctx is None or events is None or not getattr(events, "enabled",
                                                    False):
        yield None
        return
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        emit_span(events, ctx, name, start_ts=t_wall,
                  wall_ms=(time.perf_counter() - t0) * 1e3, **context)


# -- waterfall rendering (cnmf-tpu trace) -----------------------------------

def load_traces(run_dir: str) -> dict:
    """Collect every ``span`` event under ``<run_dir>/cnmf_tmp/`` into
    ``{trace_id: [span dict, ...]}`` (each sorted by start_ts)."""
    from ..utils.telemetry import _find_event_files, read_events

    traces: dict = {}
    for path in _find_event_files(run_dir):
        try:
            events = read_events(path)
        except (OSError, ValueError):
            continue
        for ev in events:
            if ev.get("t") != "span":
                continue
            traces.setdefault(ev.get("trace", "?"), []).append(ev)
    for spans in traces.values():
        spans.sort(key=lambda e: (e.get("start_ts", 0.0),
                                  e.get("span", "")))
    return traces


def _span_depth(ev: dict, by_id: dict) -> int:
    depth, seen = 0, set()
    parent = ev.get("parent")
    while parent and parent in by_id and parent not in seen:
        seen.add(parent)
        depth += 1
        parent = by_id[parent].get("parent")
    return depth


def render_waterfall(trace_id: str, spans: list, width: int = 40) -> str:
    """One trace as an indented waterfall: bar position = span start
    offset within the trace, bar length = wall time, both to scale."""
    if not spans:
        return "trace %s: no spans" % trace_id
    by_id = {ev.get("span"): ev for ev in spans}
    t_lo = min(ev.get("start_ts", 0.0) for ev in spans)
    t_hi = max(ev.get("start_ts", 0.0) + ev.get("wall_ms", 0.0) / 1e3
               for ev in spans)
    total_ms = max((t_hi - t_lo) * 1e3, 1e-6)
    name_w = max(len("  " * _span_depth(ev, by_id) + str(ev.get("name")))
                 for ev in spans)
    lines = ["trace %s — %d span(s), %.1f ms total"
             % (trace_id, len(spans), total_ms)]
    for ev in spans:
        off_ms = (ev.get("start_ts", 0.0) - t_lo) * 1e3
        wall_ms = float(ev.get("wall_ms", 0.0))
        lo = int(round(off_ms / total_ms * width))
        ln = max(1, int(round(wall_ms / total_ms * width)))
        lo = min(lo, width - 1)
        ln = min(ln, width - lo)
        bar = " " * lo + "#" * ln + " " * (width - lo - ln)
        label = "  " * _span_depth(ev, by_id) + str(ev.get("name"))
        ctx = ev.get("context") or {}
        suffix = ("  [%s]" % ",".join("%s=%s" % kv
                                      for kv in sorted(ctx.items()))
                  if ctx else "")
        lines.append("  %-*s |%s| %8.2f ms @ +%.2f ms%s"
                     % (name_w, label, bar, wall_ms, off_ms, suffix))
    return "\n".join(lines)


def render_run_traces(run_dir: str, limit: int = 10) -> str:
    """Every sampled trace in a run directory, newest first, capped at
    ``limit`` waterfalls (the cap is stated, never silent)."""
    traces = load_traces(run_dir)
    if not traces:
        return ("no span events under %s — run with "
                "CNMF_TPU_TELEMETRY=1 and CNMF_TPU_TRACE_SAMPLE>0"
                % run_dir)
    order = sorted(traces,
                   key=lambda tid: traces[tid][0].get("start_ts", 0.0),
                   reverse=True)
    shown = order[:limit]
    parts = ["%d trace(s) in %s" % (len(traces), run_dir)]
    if len(order) > len(shown):
        parts[0] += " (showing newest %d)" % len(shown)
    for tid in shown:
        parts.append("")
        parts.append(render_waterfall(tid, traces[tid]))
    return "\n".join(parts)
