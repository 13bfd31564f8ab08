"""Process-local metrics registry with text exposition.

Own copy of ``cnmf_torch_tpu/obs/metrics.py``, the same code and text. The
publishers it names (serving, the store backend, streaming, the launcher)
are the JAX package's; each comes to the port with its layer. Today the
port's factorize publishes here.

One registry per process, one lock per registry: counters, gauges, and
fixed-log-bucket histograms (the bucket edges are
``utils/profiling.HIST_EDGES`` so a scraped histogram and the post-hoc
report's ``latency_summary`` agree bucket-for-bucket). The registry is
deliberately tiny — no label cardinality explosions, no per-sample
allocation beyond a dict entry — because every publisher (batcher
dispatch, store-backend fetches, streaming slabs, rowshard passes,
launcher respawns) sits on a hot-ish host path.

Publication is gated on ``CNMF_TPU_METRICS``: the module-level helpers
(:func:`counter_inc`, :func:`gauge_set`, :func:`observe`) are no-ops
when the knob is off, so an un-knobbed run records nothing and scrapes
render an explicit "disabled" banner. :class:`MetricsRegistry` methods
themselves are ungated so tests can drive a private registry directly.

Exposition is the de-facto text format (``# TYPE`` comments +
``name{label="v"} value`` samples; histograms expose cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``), parse-backable via
:func:`parse_exposition`. Snapshots of the same state land in the run
telemetry JSONL as ``metrics_snapshot`` events through the existing
``EventLog`` (same O_APPEND single-write discipline).
"""

from __future__ import annotations

import threading

from ..utils.envknobs import env_flag
from ..utils.profiling import HIST_EDGES

__all__ = [
    "METRICS_ENV", "MetricsRegistry", "metrics_enabled",
    "default_registry", "reset_default_registry", "counter_inc",
    "gauge_set", "observe", "render_text", "parse_exposition",
    "emit_snapshot", "Snapshotter",
]

METRICS_ENV = "CNMF_TPU_METRICS"

_COUNTER = "counter"
_GAUGE = "gauge"
_HISTOGRAM = "histogram"


def metrics_enabled() -> bool:
    """True when ``CNMF_TPU_METRICS`` is on. Checked at every
    publication site (like ``telemetry_enabled``), so long-lived
    processes and tests can toggle it without rebuilding objects."""
    return env_flag(METRICS_ENV, False)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Histogram:
    """Cumulative fixed-edge histogram cell: per-bucket counts (one
    overflow bucket), sum, count. Mutated only under the owning
    registry's lock."""

    __slots__ = ("buckets", "sum", "count")

    def __init__(self):
        self.buckets = [0] * (len(HIST_EDGES) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        for i, edge in enumerate(HIST_EDGES):
            if value <= edge:
                self.buckets[i] += 1
                break
        else:
            self.buckets[-1] += 1
        self.sum += value
        self.count += 1


class MetricsRegistry:
    """Thread-safe instrument store. ``(name, kind)`` is the instrument;
    each distinct label set is a series under it. Mixing kinds under one
    name raises — the exposition format cannot represent it."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_key: value | _Histogram})
        self._instruments: dict = {}

    def _series(self, name: str, kind: str, labels: dict):
        inst = self._instruments.get(name)
        if inst is None:
            inst = (kind, {})
            self._instruments[name] = inst
        elif inst[0] != kind:
            raise ValueError(
                "metric %r already registered as %s, not %s"
                % (name, inst[0], kind))
        return inst[1], _label_key(labels)

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counter %r increment must be >= 0" % name)
        with self._lock:
            series, key = self._series(name, _COUNTER, labels)
            series[key] = series.get(key, 0.0) + float(value)

    def set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            series, key = self._series(name, _GAUGE, labels)
            series[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            series, key = self._series(name, _HISTOGRAM, labels)
            cell = series.get(key)
            if cell is None:
                cell = series[key] = _Histogram()
            cell.observe(float(value))

    def snapshot(self) -> dict:
        """JSON-safe copy of the whole registry, the payload of a
        ``metrics_snapshot`` telemetry event. Histograms keep the
        report's ``latency_summary`` bucket labels (``<=%g`` / ``>%g``,
        NON-cumulative) so the two surfaces read identically."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for name in sorted(self._instruments):
                kind, series = self._instruments[name]
                for key in sorted(series):
                    label = name if not key else "%s{%s}" % (
                        name, ",".join("%s=%s" % kv for kv in key))
                    if kind == _COUNTER:
                        out["counters"][label] = series[key]
                    elif kind == _GAUGE:
                        out["gauges"][label] = series[key]
                    else:
                        cell = series[key]
                        hist = {}
                        for i, edge in enumerate(HIST_EDGES):
                            if cell.buckets[i]:
                                hist["<=%g" % edge] = cell.buckets[i]
                        if cell.buckets[-1]:
                            hist[">%g" % HIST_EDGES[-1]] = cell.buckets[-1]
                        out["histograms"][label] = {
                            "count": cell.count, "sum": cell.sum,
                            "buckets": hist}
        return out

    def render_text(self) -> str:
        """Text exposition: ``# TYPE`` per instrument, samples sorted by
        (name, labels) so scrapes diff cleanly; histogram buckets are
        CUMULATIVE with an explicit ``+Inf`` bucket."""
        lines = []
        with self._lock:
            for name in sorted(self._instruments):
                kind, series = self._instruments[name]
                lines.append("# TYPE %s %s" % (name, kind))
                for key in sorted(series):
                    if kind == _HISTOGRAM:
                        cell = series[key]
                        acc = 0
                        for i, edge in enumerate(HIST_EDGES):
                            acc += cell.buckets[i]
                            lines.append("%s_bucket%s %d" % (
                                name, _fmt_labels(key, le="%g" % edge),
                                acc))
                        acc += cell.buckets[-1]
                        lines.append("%s_bucket%s %d" % (
                            name, _fmt_labels(key, le="+Inf"), acc))
                        lines.append("%s_sum%s %s" % (
                            name, _fmt_labels(key), _fmt_value(cell.sum)))
                        lines.append("%s_count%s %d" % (
                            name, _fmt_labels(key), cell.count))
                    else:
                        lines.append("%s%s %s" % (
                            name, _fmt_labels(key),
                            _fmt_value(series[key])))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


def _fmt_value(v: float) -> str:
    f = float(v)
    return "%d" % f if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(key: tuple, **extra) -> str:
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, _escape(v)) for k, v in pairs)


def parse_exposition(text: str) -> dict:
    """Parse exposition text back into ``{(name, labels_tuple): value}``
    plus a ``types`` side table — the round-trip half of the format the
    tests assert with."""
    samples: dict = {}
    types: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            body = rest.rstrip("}")
            labels = []
            for item in _split_labels(body):
                k, _, v = item.partition("=")
                labels.append((k, _unescape(v.strip('"'))))
            key = (name, tuple(labels))
        else:
            key = (name_part, ())
        samples[key] = float(value_part)
    return {"samples": samples, "types": types}


def _split_labels(body: str):
    out, cur, in_str, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\" and in_str:
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_str = not in_str
            cur.append(ch)
            continue
        if ch == "," and not in_str:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _unescape(v: str) -> str:
    return (v.replace(r'\"', '"').replace(r"\n", "\n")
            .replace(r"\\", "\\"))


# ---------------------------------------------------------------------------
# process-default registry + gated helpers (the publisher API)
# ---------------------------------------------------------------------------

_REGISTRY_LOCK = threading.Lock()
_DEFAULT_REGISTRY: list = []  # 0-or-1 element; rebound under the lock


def default_registry() -> MetricsRegistry:
    """The one process-wide registry every publisher shares — serve
    batcher, store backend, streaming engine, launcher, netstore server
    all land in the same scrape."""
    with _REGISTRY_LOCK:
        if not _DEFAULT_REGISTRY:
            _DEFAULT_REGISTRY.append(MetricsRegistry())
        return _DEFAULT_REGISTRY[0]


def reset_default_registry() -> None:
    """Tests only: drop all recorded series."""
    with _REGISTRY_LOCK:
        if _DEFAULT_REGISTRY:
            _DEFAULT_REGISTRY[0].reset()


def counter_inc(name: str, value: float = 1.0, **labels) -> None:
    """Gated counter bump on the default registry — a no-op (no lock,
    no allocation) when ``CNMF_TPU_METRICS`` is off."""
    if metrics_enabled():
        default_registry().inc(name, value, **labels)


def gauge_set(name: str, value: float, **labels) -> None:
    if metrics_enabled():
        default_registry().set(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if metrics_enabled():
        default_registry().observe(name, value, **labels)


_DISABLED_BANNER = ("# cnmf-tpu metrics disabled "
                    "(set CNMF_TPU_METRICS=1 to enable)\n")


def render_text() -> str:
    """Exposition for the default registry — the ``GET /metrics`` body
    on both the serve daemon and the object-store server."""
    if not metrics_enabled():
        return _DISABLED_BANNER
    return default_registry().render_text()


# ---------------------------------------------------------------------------
# metrics_snapshot events
# ---------------------------------------------------------------------------

def emit_snapshot(events, registry=None, slo=None) -> bool:
    """Append one ``metrics_snapshot`` event (full registry state, plus
    the current SLO evaluation when the caller has one) to the run's
    telemetry JSONL. Requires BOTH telemetry and metrics on; returns
    whether an event was written."""
    if events is None or not getattr(events, "enabled", False):
        return False
    if not metrics_enabled():
        return False
    reg = default_registry() if registry is None else registry
    events.emit("metrics_snapshot", metrics=reg.snapshot(), slo=slo)
    return True


class Snapshotter:
    """Background snapshot loop for long-lived processes (the serve
    daemon): one ``metrics_snapshot`` per ``interval_s`` plus a final
    one at :meth:`stop`, so even a short-lived daemon leaves at least
    one snapshot in its event stream."""

    def __init__(self, events, interval_s: float = 30.0, registry=None,
                 slo_fn=None):
        self._events = events
        self._interval = max(1.0, float(interval_s))
        self._registry = registry
        self._slo_fn = slo_fn
        self._stop = threading.Event()
        self._thread = None

    def _slo(self):
        return self._slo_fn() if self._slo_fn is not None else None

    def _run(self):
        while not self._stop.wait(self._interval):
            emit_snapshot(self._events, registry=self._registry,
                          slo=self._slo())

    def start(self) -> "Snapshotter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="cnmf-metrics-snapshot",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        emit_snapshot(self._events, registry=self._registry,
                      slo=self._slo())
