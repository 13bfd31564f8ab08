"""Run telemetry: the structured event log, convergence records, memory
watermarks, and the ``report`` renderer.

Own copy of ``cnmf_torch_tpu/utils/telemetry.py``, with the same schema,
so an events file either package writes validates and renders in the
other:

  * :class:`EventLog` — append-only JSON-lines event stream at
    ``<run_dir>/cnmf_tmp/<name>.events.jsonl`` with a versioned schema.
    A run manifest (package version and path, torch and CUDA versions,
    devices, ``CNMF_*`` env knobs, seed summary) is emitted once,
    automatically, before the first event. Emission is a no-op unless
    ``CNMF_TPU_TELEMETRY=1``.
  * :data:`EVENT_TYPES` — every event type of the JAX package, those whose
    producers the port has not reached yet (the serving and fleet
    events, ``collective``, ``plan``, ``perf_model``) included, so the
    report reads any run's stream. The atlas path emits ``stream``
    (:meth:`EventLog.emit_stream`), ``checkpoint`` and the
    ``shard_store_write`` / ``ooc_ingest`` dispatch events.
  * :func:`validate_event` / :func:`validate_events_file` — the ONE
    schema definition.
  * :func:`render_report` — the ``report <run_dir>`` renderer: stage
    waterfall, per-K replicate convergence, faults, memory peaks and every
    other section of the JAX package's report, text for text.

Two functions differ from the JAX module, where it read JAX:
:func:`_manifest_fields` (``jax_version`` is ``"unavailable"``, the JAX
module's own spelling without JAX, beside ``torch_version`` and
``cuda_version``; ``backend`` is ``cuda`` or ``cpu``) and
:func:`device_memory_snapshot` (``torch.cuda.memory_stats`` and
``mem_get_info``; one ``cpu`` entry on a CPU run, which never initialises
CUDA).

The solver-side half is the sweep's per-replicate objective trace
(``parallel/replicates.py:_sweep_telemetry_payload``), read from the
traces the sweep already brings to the host, once per K.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = [
    "TELEMETRY_ENV",
    "SCHEMA_VERSION",
    "EVENT_TYPES",
    "telemetry_enabled",
    "EventLog",
    "device_memory_snapshot",
    "device_memory_peak_bytes",
    "validate_event",
    "validate_events_file",
    "read_events",
    "summarize_events",
    "render_report",
]

TELEMETRY_ENV = "CNMF_TPU_TELEMETRY"

SCHEMA_VERSION = 1

# required fields per event type, beyond the common {"v", "t", "ts"}.
# This dict IS the schema (the JAX package's, unchanged): the tests
# validate every emitted line against it. The port produces manifest,
# dispatch, stage, replicates, stream, memory, fault, checkpoint, span and
# metrics_snapshot; the other types' producers come with the layers still
# to port, and the report reads them already.
EVENT_TYPES = {
    "manifest": {"package_version", "jax_version", "backend", "devices",
                 "env"},
    "dispatch": {"decision", "context"},
    "stage": {"stage", "wall_s"},
    "replicates": {"k", "beta", "records"},
    # host->device staging statistics (the streaming layer)
    "stream": {"context", "wall_s", "nbytes", "overlap_fraction"},
    "memory": {"stage", "devices"},
    # resilience and elasticity: nonfinite_replicate / retry / quarantine
    # / torn_artifact (runtime/resilience.py, models/cnmf.py), and the
    # shard, topology and store-transport kinds of the layers to come,
    # with the (k, iter, seed, attempt) / (path, reason) context needed
    # to audit a degraded run
    "fault": {"kind", "context"},
    # mid-run checkpoint lifecycle: action in {write, resume, discard}
    "checkpoint": {"action", "context"},
    # serving: one event per projection request and per batched dispatch
    "serve_request": {"tenant", "n_cells", "status"},
    "serve_batch": {"lanes", "requests", "bucket"},
    # the replicated serving fleet's router
    "replica_death": {"replica", "reason"},
    "failover": {"replica", "tenants"},
    "rollover": {"generation", "wall_s"},
    # 2-D grid statistics collectives
    "collective": {"context", "wall_s", "nbytes"},
    # the resolved execution plan, one per factorize
    "plan": {"plan", "signature"},
    # observability (obs/): one `span` per sampled trace hop, one
    # `metrics_snapshot` per registry snapshot (plus the SLO verdict)
    "span": {"trace", "span", "name", "start_ts", "wall_ms"},
    "metrics_snapshot": {"metrics"},
    # the roofline cost model: predicted work joined with a measured wall
    "perf_model": {"stage", "lane", "predicted", "measured", "roofline"},
}

# per-record required fields inside a "replicates" event's records list
REPLICATE_RECORD_FIELDS = {"seed", "err", "iters", "capped", "nonfinite"}


def telemetry_enabled() -> bool:
    """True when ``CNMF_TPU_TELEMETRY`` is set to anything but 0/off.
    Checked at every emission site, so tests (and long-lived processes)
    can toggle it without rebuilding pipeline objects."""
    from .envknobs import env_flag

    return env_flag(TELEMETRY_ENV, False)


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------

def _jsonable(v):
    """Coerce numpy scalars/arrays (the natural products of a fetched
    sweep) into plain JSON types; anything else falls back to str."""
    import numpy as np

    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        f = float(v)
        return f if np.isfinite(f) else repr(f)
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


class _NanSafeEncoder(json.JSONEncoder):
    """JSON-lines must stay machine-parseable: a diverged replicate's
    ``inf``/``nan`` objective serializes as a string, not bare ``NaN``
    (which ``json.dumps`` emits by default and strict parsers reject)."""

    def iterencode(self, o, _one_shot=False):
        import math

        def scrub(v):
            if isinstance(v, float) and not math.isfinite(v):
                return repr(v)
            if isinstance(v, dict):
                return {k: scrub(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [scrub(x) for x in v]
            return v

        return super().iterencode(scrub(o), _one_shot)


class EventLog:
    """Thread-safe append-only JSONL event stream for one run.

    Construction is free; nothing touches the filesystem until the first
    :meth:`emit` with telemetry enabled. The manifest is emitted once per
    EventLog instance, before any other event, so a factorize-only worker
    still produces a self-describing file.
    """

    def __init__(self, path: str | None, manifest_extra: dict | None = None,
                 device=None):
        self.path = path
        # the run's device: the manifest's backend and the memory events
        # describe it (a CPU run never initialises CUDA)
        self.device = device
        self._lock = threading.Lock()
        self._manifest_done = False
        self._manifest_extra = dict(manifest_extra or {})
        self._write_failed = False

    def set_manifest_extra(self, **fields):
        """Merge run-level manifest fields (seed summary, ledger Ks) known
        only after construction; effective until the manifest is written."""
        with self._lock:
            self._manifest_extra.update(fields)

    @property
    def enabled(self) -> bool:
        return self.path is not None and telemetry_enabled()

    def emit(self, event_type: str, **fields):
        """Append one event (no-op unless enabled). Never raises: telemetry
        must not take the pipeline down."""
        if not self.enabled:
            return
        try:
            with self._lock:
                if not self._manifest_done and event_type != "manifest":
                    self._manifest_done = True
                    self._write_line(self._build_manifest())
                elif event_type == "manifest":
                    self._manifest_done = True
                self._write_line(self._event(event_type, fields))
        except Exception:
            if not self._write_failed:
                self._write_failed = True
                import warnings

                warnings.warn(
                    "telemetry: failed to append to %r; further events "
                    "from this log are dropped silently" % (self.path,),
                    RuntimeWarning, stacklevel=2)

    def emit_memory(self, stage: str):
        """Device-memory watermark event at a stage boundary."""
        if not self.enabled:
            return
        self.emit("memory", stage=stage,
                  devices=device_memory_snapshot(self.device))

    def emit_stream(self, context: str, stats):
        """One ``StreamStats`` (``parallel/streaming.py``) as a ``stream``
        event: the phase walls and bytes, for a shard-store staging the
        disk wall, bytes, read rate and the host slab-residency peak, and
        for a remote store its transport counters."""
        if not self.enabled or stats is None:
            return
        disk_s = float(stats.disk_s)
        remote = bool(stats.store_remote)
        self.emit(
            "stream", context=context, wall_s=round(stats.wall_s, 4),
            host_prep_s=round(stats.host_prep_s, 4),
            h2d_s=round(stats.h2d_s, 4), device_s=round(stats.device_s, 4),
            nbytes=int(stats.nbytes), slabs=int(stats.slabs),
            gb_per_s=round(stats.gb_per_s(), 3),
            overlap_fraction=round(stats.overlap_fraction, 3),
            disk_s=round(disk_s, 4) if disk_s > 0 else None,
            disk_nbytes=int(stats.disk_nbytes) if disk_s > 0 else None,
            disk_gb_per_s=(round(stats.read_gb_per_s(), 3)
                           if disk_s > 0 else None),
            host_peak_bytes=(int(stats.host_peak_bytes)
                             if stats.host_peak_bytes > 0 else None),
            store_remote=(True if remote else None),
            store_retries=(int(stats.store_retries) if remote else None),
            store_hedges=(int(stats.store_hedges) if remote else None),
            store_hedges_won=(int(stats.store_hedges_won)
                              if remote else None),
            store_cache_hits=(int(stats.store_cache_hits)
                              if remote else None),
            store_cache_misses=(int(stats.store_cache_misses)
                                if remote else None),
            store_degraded=(int(stats.store_degraded) if remote else None))

    # -- internals -----------------------------------------------------

    def _event(self, event_type: str, fields: dict) -> dict:
        ev = {"v": SCHEMA_VERSION, "t": event_type, "ts": round(time.time(), 3)}
        # None-valued fields are omitted (absent == not measured): keeps
        # the stream compact and the schema's required-field check honest
        ev.update({k: _jsonable(v) for k, v in fields.items()
                   if v is not None})
        return ev

    def _build_manifest(self) -> dict:
        return self._event("manifest", dict(_manifest_fields(self.device),
                                            **self._manifest_extra))

    def _write_line(self, ev: dict):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        line = json.dumps(ev, cls=_NanSafeEncoder,
                          separators=(",", ":")) + "\n"
        # one os.write per line on an O_APPEND fd: run_parallel workers in
        # separate processes append to the SAME file, and buffered text
        # mode flushes a large (multi-KB `replicates`) line as several
        # write() syscalls — concurrent writers would tear lines mid-JSON.
        # A single write() to an O_APPEND regular file does not interleave.
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, line.encode("utf-8"))
        finally:
            os.close(fd)


def _run_device(device):
    """The run's ``torch.device``: the caller's, else the card when CUDA
    is already initialised in this process, else the CPU."""
    import torch

    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _manifest_fields(device=None) -> dict:
    """Versions, device inventory, and the env knobs that steer dispatch —
    everything needed to interpret (or reproduce) the rest of the stream.
    ``jax_version`` is the schema's required field; the port never imports
    JAX, so it carries the JAX module's spelling for a missing JAX."""
    try:
        from ..version import __version__ as pkg_version
    except Exception:
        pkg_version = "unknown"
    from .builddir import PACKAGE_DIR

    # package_path: the copy of the port this process imported (a
    # checkout's or an install's)
    fields = {"package_version": pkg_version,
              "jax_version": "unavailable", "package_path": PACKAGE_DIR}
    try:
        import torch

        fields["torch_version"] = torch.__version__
        fields["cuda_version"] = torch.version.cuda or "none"
        dev = _run_device(device)
        fields["backend"] = dev.type
        if dev.type == "cuda":
            fields["devices"] = [
                {"id": i, "platform": "cuda",
                 "kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())]
        else:
            fields["devices"] = [_cpu_device_entry()]
    except Exception:
        fields.setdefault("backend", "unavailable")
        fields.setdefault("devices", [])
    fields["env"] = {k: v for k, v in sorted(os.environ.items())
                     if k.startswith("CNMF_")}
    return fields


def _cpu_device_entry() -> dict:
    import platform

    return {"id": 0, "platform": "cpu",
            "kind": platform.processor() or platform.machine() or "cpu"}


# ---------------------------------------------------------------------------
# device-memory watermarks
# ---------------------------------------------------------------------------

def device_memory_snapshot(device=None) -> list[dict]:
    """Per-card memory watermarks of the caching allocator
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` as
    ``bytes_in_use``, ``allocated_bytes.all.peak`` — since the last
    ``reset_peak_memory_stats`` — as ``peak_bytes_in_use``;
    ``torch.cuda.memory_allocated`` as ``live_buffer_bytes``) and, for the
    run's card, ``bytes_limit`` from ``torch.cuda.mem_get_info``. Only
    cards whose allocator holds memory are read, so no context is created
    on an idle card. A CPU run writes one ``cpu`` entry and never
    initialises CUDA."""
    out = []
    try:
        dev = _run_device(device)
        if dev.type != "cuda":
            return [dict(_cpu_device_entry(), live_buffer_bytes=0)]
        import torch

        run_idx = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i) or {}
            if i != run_idx and not stats.get("allocated_bytes.all.peak"):
                continue
            ent = {"id": i, "platform": "cuda",
                   "live_buffer_bytes": int(torch.cuda.memory_allocated(i))}
            for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                             ("peak_bytes_in_use",
                              "allocated_bytes.all.peak")):
                if src in stats:
                    ent[key] = int(stats[src])
            try:
                ent["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
            except Exception:
                pass
            out.append(ent)
    except Exception:
        pass
    return out


def device_memory_peak_bytes(device=None) -> int:
    """Max peak (or current) device bytes across the cards; falls back
    to the live-buffer sum when the allocator reports no stats."""
    peak = 0
    for ent in device_memory_snapshot(device):
        peak = max(peak, ent.get("peak_bytes_in_use",
                                 ent.get("bytes_in_use",
                                         ent.get("live_buffer_bytes", 0))))
    return int(peak)


def replicate_records(payload) -> list[dict]:
    """The ONE payload->records conversion: turn a sweep telemetry payload
    (``parallel.replicates._sweep_telemetry_payload`` — array values may be
    device arrays) into the schema's per-replicate record list
    (:data:`REPLICATE_RECORD_FIELDS`), as the JAX package's: ``capped`` is
    ``iters >= cap`` and NaN trace slots (never evaluated) are dropped."""
    import numpy as np

    trace = np.asarray(payload["trace"])
    iters = np.asarray(payload["iters"])
    nonfin = np.asarray(payload["nonfinite"])
    errs = np.asarray(payload["errs"])
    cap = int(payload["cap"])
    inner = (np.asarray(payload["inner_iters"])
             if payload.get("inner_iters") is not None else None)
    dna_fb = (np.asarray(payload["dna_fallback"])
              if payload.get("dna_fallback") is not None else None)
    records = []
    for i, seed in enumerate(payload["seeds"]):
        tr = trace[i]
        rec = {
            "seed": int(seed),
            "err": float(errs[i]),
            "iters": int(iters[i]),
            "capped": bool(iters[i] >= cap),
            "nonfinite": bool(nonfin[i]),
            # NaN marks never-evaluated slots; what remains is the
            # objective trajectory at the solver's evaluation cadence
            "trace": [float(v) for v in tr[~np.isnan(tr)]],
        }
        # solver-recipe accounting (batch solvers only): total
        # inner update applications, and the dna recipe's MU
        # fallback-lane fraction — additive fields, absent elsewhere
        if inner is not None:
            rec["inner_iters"] = int(inner[i])
        if dna_fb is not None:
            rec["dna_fallback"] = round(float(dna_fb[i]), 4)
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# schema validation
# ---------------------------------------------------------------------------

def validate_event(ev: dict) -> None:
    """Raise ``ValueError`` unless ``ev`` is a schema-valid event."""
    if not isinstance(ev, dict):
        raise ValueError(f"event is not an object: {type(ev).__name__}")
    for field in ("v", "t", "ts"):
        if field not in ev:
            raise ValueError(f"event missing required field {field!r}: {ev}")
    if ev["v"] != SCHEMA_VERSION:
        raise ValueError(
            f"unknown schema version {ev['v']!r} (this build understands "
            f"{SCHEMA_VERSION})")
    t = ev["t"]
    if t not in EVENT_TYPES:
        raise ValueError(f"unknown event type {t!r}")
    if not isinstance(ev["ts"], (int, float)):
        raise ValueError(f"ts must be numeric, got {ev['ts']!r}")
    missing = EVENT_TYPES[t] - set(ev)
    if missing:
        raise ValueError(
            f"{t} event missing required fields {sorted(missing)}: {ev}")
    if t == "replicates":
        if not isinstance(ev["records"], list):
            raise ValueError("replicates.records must be a list")
        for rec in ev["records"]:
            rmissing = REPLICATE_RECORD_FIELDS - set(rec)
            if rmissing:
                raise ValueError(
                    f"replicate record missing {sorted(rmissing)}: {rec}")
    if t == "memory" and not isinstance(ev["devices"], list):
        raise ValueError("memory.devices must be a list")
    if t == "span":
        for field in ("start_ts", "wall_ms"):
            if not isinstance(ev[field], (int, float)):
                raise ValueError(f"span.{field} must be numeric: {ev}")
    if t == "metrics_snapshot" and not isinstance(ev["metrics"], dict):
        raise ValueError("metrics_snapshot.metrics must be an object")
    if t == "perf_model":
        for field in ("predicted", "measured", "roofline"):
            if not isinstance(ev[field], dict):
                raise ValueError(f"perf_model.{field} must be an object: {ev}")
        for field in ("flops", "bytes"):
            if not isinstance(ev["predicted"].get(field), (int, float)):
                raise ValueError(
                    f"perf_model.predicted.{field} must be numeric: {ev}")
        if not isinstance(ev["measured"].get("wall_s"), (int, float)):
            raise ValueError(
                f"perf_model.measured.wall_s must be numeric: {ev}")
        if not isinstance(ev["roofline"].get("bound"), str):
            raise ValueError(f"perf_model.roofline.bound must be a str: {ev}")


def validate_events_file(path: str) -> int:
    """Validate every line of an events.jsonl; returns the event count.
    The FIRST event must be a manifest (self-describing stream)."""
    count = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {exc}")
            try:
                validate_event(ev)
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}")
            if count == 0 and ev["t"] != "manifest":
                raise ValueError(
                    f"{path}:1: first event must be the manifest, "
                    f"got {ev['t']!r}")
            count += 1
    return count


def read_events(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _find_event_files(run_dir: str) -> list[str]:
    tmp = os.path.join(run_dir, "cnmf_tmp")
    if not os.path.isdir(tmp):
        return []
    return sorted(os.path.join(tmp, fn) for fn in os.listdir(tmp)
                  if fn.endswith(".events.jsonl"))


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TB"


def summarize_events(events: list[dict]) -> dict:
    """Aggregate an event stream into the report's summary:
    stage walls, staging throughput, per-K convergence, memory peaks."""
    import math

    summary: dict = {"n_events": len(events)}
    manifest = next((e for e in events if e["t"] == "manifest"), None)
    if manifest:
        summary["manifest"] = {
            "package_version": manifest.get("package_version"),
            "jax_version": manifest.get("jax_version"),
            "backend": manifest.get("backend"),
            "n_devices": len(manifest.get("devices") or []),
        }
    summary["dispatch"] = [
        {k: e[k] for k in ("decision", "context") if k in e}
        for e in events if e["t"] == "dispatch"]

    # the resolved execution plan: one per factorize — keep
    # the LAST (a multi-worker run dir concatenates worker streams; they
    # resolved the same plan or the signatures differ loudly here)
    plan_ev = next((e for e in reversed(events) if e["t"] == "plan"), None)
    if plan_ev is not None:
        summary["plan"] = {"plan": plan_ev.get("plan"),
                           "signature": plan_ev.get("signature")}

    # consensus/k-selection dispatch lane: which geometry the
    # clustering stages ran on — sketched (random-projected) vs exact —
    # with the replicate counts and distance-matrix shapes that justify
    # it, so the sketched lane is auditable like factorize's
    cons_rows = []
    for e in events:
        if e["t"] != "dispatch" or e.get("decision") not in (
                "consensus_path", "k_selection"):
            continue
        ctx = e.get("context") or {}
        if not isinstance(ctx, dict):
            continue
        cons_rows.append(dict(ctx, decision=e.get("decision")))
    if cons_rows:
        summary["consensus"] = cons_rows

    stages: dict = {}
    for e in events:
        if e["t"] != "stage":
            continue
        ent = stages.setdefault(e["stage"], {"wall_s": 0.0, "nbytes": 0,
                                             "count": 0})
        ent["wall_s"] += float(e.get("wall_s", 0.0))
        ent["nbytes"] += int(e.get("nbytes") or 0)
        ent["count"] += 1
    summary["stages"] = {
        name: {"wall_s": round(v["wall_s"], 4), "nbytes": v["nbytes"],
               "count": v["count"]}
        for name, v in stages.items()}

    streams = [e for e in events if e["t"] == "stream"]
    if streams:
        summary["streaming"] = [
            {"context": e["context"], "wall_s": e["wall_s"],
             "nbytes": e["nbytes"], "gb_per_s": e.get("gb_per_s"),
             "overlap_fraction": e.get("overlap_fraction")}
            for e in streams]

    # 2-D grid statistics collectives (parallel/grid2d.py):
    # per-solve reduce wall + logical psum payload, and the measured
    # probe's hidden-collective (overlap) fraction when it ran
    colls = [e for e in events if e["t"] == "collective"]
    if colls:
        summary["collectives"] = [
            {"context": e.get("context"), "wall_s": e.get("wall_s"),
             "nbytes": e.get("nbytes"),
             "overlap_fraction": e.get("overlap_fraction")}
            for e in colls]

    # out-of-core ingestion: the shard store written at
    # prepare (dispatch decision=shard_store_write), factorize's store
    # engagement (decision=ooc_ingest), and the disk-producer staging
    # walls carried by store-backed stream events
    disk_streams = [e for e in streams if e.get("disk_nbytes")]
    store_ev = next((e for e in events if e["t"] == "dispatch"
                     and e.get("decision") == "shard_store_write"), None)
    ooc_ev = next((e for e in events if e["t"] == "dispatch"
                   and e.get("decision") == "ooc_ingest"), None)
    remote_streams = [e for e in streams if e.get("store_remote")]
    if disk_streams or store_ev or ooc_ev or remote_streams:
        ing: dict = {}
        ctx = (ooc_ev or store_ev or {}).get("context") or {}
        for key in ("slabs", "store_bytes", "format", "rows", "backend"):
            if ctx.get(key) is not None:
                ing[key] = ctx[key]
        if disk_streams:
            disk_s = sum(float(e.get("disk_s") or 0.0)
                         for e in disk_streams)
            disk_b = sum(int(e.get("disk_nbytes") or 0)
                         for e in disk_streams)
            ing["disk_read_nbytes"] = disk_b
            ing["disk_read_gb_per_s"] = (round(disk_b / disk_s / 1e9, 3)
                                         if disk_s > 0 else 0.0)
            fracs = [float(e["overlap_fraction"]) for e in disk_streams
                     if e.get("overlap_fraction") is not None]
            if fracs:
                ing["overlap_fraction"] = round(sum(fracs) / len(fracs), 3)
            peaks = [int(e.get("host_peak_bytes") or 0)
                     for e in disk_streams]
            if any(peaks):
                ing["host_peak_bytes"] = max(peaks)
        # remote-store transport health: transport retries,
        # hedge engagement, read-through cache hit rate and degraded
        # (cache-served-while-remote-down) reads, summed across every
        # stream that rode the network backend
        if remote_streams:
            rem = {out: sum(int(e.get(field) or 0) for e in remote_streams)
                   for out, field in (
                       ("retries", "store_retries"),
                       ("hedges", "store_hedges"),
                       ("hedges_won", "store_hedges_won"),
                       ("cache_hits", "store_cache_hits"),
                       ("cache_misses", "store_cache_misses"),
                       ("degraded_reads", "store_degraded"))}
            looked = rem["cache_hits"] + rem["cache_misses"]
            rem["cache_hit_rate"] = (round(rem["cache_hits"] / looked, 3)
                                     if looked else 0.0)
            ing["remote"] = rem
        if ing:
            summary["ingestion"] = ing

    conv: dict = {}
    for e in events:
        if e["t"] != "replicates":
            continue
        k = int(e["k"])
        ent = conv.setdefault(k, {"n": 0, "capped": 0, "nonfinite": 0,
                                  "errs": [], "iters": [], "recipes": set(),
                                  "dna_fb": []})
        if e.get("recipe"):
            ent["recipes"].add(str(e["recipe"]))
        for rec in e["records"]:
            ent["n"] += 1
            ent["capped"] += bool(rec.get("capped"))
            ent["nonfinite"] += bool(rec.get("nonfinite"))
            err = rec.get("err")
            if isinstance(err, (int, float)) and math.isfinite(err):
                ent["errs"].append(float(err))
            ent["iters"].append(int(rec.get("iters", 0)))
            fb = rec.get("dna_fallback")
            if isinstance(fb, (int, float)) and math.isfinite(fb):
                ent["dna_fb"].append(float(fb))
    convergence = {}
    for k, ent in sorted(conv.items()):
        errs = ent["errs"]
        row = {"replicates": ent["n"],
               "fraction_capped": round(ent["capped"] / max(ent["n"], 1), 4),
               "nonfinite": ent["nonfinite"],
               "mean_iters": round(sum(ent["iters"])
                                   / max(len(ent["iters"]), 1), 1)}
        if ent["recipes"]:
            # the engaged solver recipe(s) for this K (normally one)
            row["recipe"] = "+".join(sorted(ent["recipes"]))
        if ent["dna_fb"]:
            row["dna_fallback_mean"] = round(
                sum(ent["dna_fb"]) / len(ent["dna_fb"]), 4)
        if errs:
            lo, hi = min(errs), max(errs)
            med = sorted(errs)[len(errs) // 2]
            row.update(err_min=round(lo, 6), err_median=round(med, 6),
                       err_max=round(hi, 6),
                       err_rel_spread=round((hi - lo) / abs(med), 6)
                       if med else None)
        convergence[str(k)] = row
    if convergence:
        summary["convergence"] = convergence

    # faults & recoveries: per-class counts from the fault stream, plus
    # the recovery outcomes derivable from it (a `retry` event's context
    # carries the attempt's health) and the checkpoint lifecycle
    fault_by_kind: dict = {}
    retried = recovered = quarantined_n = 0
    net_recovered = net_degraded = 0
    for e in events:
        if e["t"] != "fault":
            continue
        kind = str(e.get("kind"))
        fault_by_kind[kind] = fault_by_kind.get(kind, 0) + 1
        if kind == "retry":
            retried += 1
            ctx = e.get("context")
            if isinstance(ctx, dict) and ctx.get("healthy"):
                recovered += 1
        elif kind == "quarantine":
            quarantined_n += 1
        elif kind == "store_net":
            # remote-store transport outcomes: a retry ladder
            # that eventually succeeded marks the event healed; a read
            # served from the local cache with the remote down marks it
            # degraded — plain store_net events are in-flight attempts
            ctx = e.get("context")
            if isinstance(ctx, dict):
                if ctx.get("healed"):
                    net_recovered += 1
                if ctx.get("degraded"):
                    net_degraded += 1
    if fault_by_kind:
        summary["faults"] = {"by_kind": dict(sorted(fault_by_kind.items())),
                             "retried": retried, "recovered": recovered,
                             "quarantined": quarantined_n}
        if fault_by_kind.get("store_net"):
            summary["faults"]["store_net_recovered"] = net_recovered
            summary["faults"]["store_net_degraded"] = net_degraded
    ckpt_actions: dict = {}
    max_resume_pass = None
    for e in events:
        if e["t"] != "checkpoint":
            continue
        action = str(e.get("action"))
        ckpt_actions[action] = ckpt_actions.get(action, 0) + 1
        if action == "resume":
            ctx = e.get("context")
            p = ctx.get("pass_idx") if isinstance(ctx, dict) else None
            if isinstance(p, (int, float)):
                max_resume_pass = max(int(p), max_resume_pass or 0)
    if ckpt_actions:
        ckpt_sum = {"actions": dict(sorted(ckpt_actions.items()))}
        if max_resume_pass is not None:
            ckpt_sum["max_resume_pass"] = max_resume_pass
        summary["checkpoints"] = ckpt_sum

    # mesh elasticity: topology losses, degraded re-meshes
    # (with the before/after device counts), launcher shard adoptions,
    # and straggler containments — the audit trail that distinguishes
    # "the run survived a dying pod" from "the run was never stressed"
    losses = remeshes = stolen = stragglers = 0
    remesh_paths: list[str] = []
    for e in events:
        if e["t"] != "fault":
            continue
        kind = str(e.get("kind"))
        ctx = e.get("context") if isinstance(e.get("context"), dict) else {}
        if kind == "host_loss":
            losses += 1
        elif kind == "remesh":
            remeshes += 1
            fd, td = ctx.get("from_devices"), ctx.get("to_devices")
            if isinstance(fd, int) and isinstance(td, int):
                remesh_paths.append(f"{fd}->{td}")
        elif kind == "worker_steal":
            stolen += 1
        elif kind == "straggler":
            stragglers += 1
    if losses or remeshes or stolen or stragglers:
        elasticity = {"host_losses": losses, "remeshes": remeshes,
                      "stolen_shards": stolen, "stragglers": stragglers}
        if remesh_paths:
            elasticity["remesh_devices"] = remesh_paths
        if max_resume_pass is not None:
            elasticity["max_resume_pass"] = max_resume_pass
        summary["elasticity"] = elasticity

    # warm serving tier: request outcomes, per-tenant traffic,
    # batch-size engagement, and the latency distribution — p50/p95/p99
    # via the shared percentile helper (utils/profiling.py)
    reqs = [e for e in events if e["t"] == "serve_request"]
    batches = [e for e in events if e["t"] == "serve_batch"]
    if reqs or batches:
        from .profiling import latency_summary

        by_status: dict = {}
        by_tenant: dict = {}
        lat_ms = []
        for e in reqs:
            st = str(e.get("status"))
            by_status[st] = by_status.get(st, 0) + 1
            ten = str(e.get("tenant"))
            by_tenant[ten] = by_tenant.get(ten, 0) + 1
            if st == "ok" and isinstance(e.get("total_ms"), (int, float)):
                lat_ms.append(float(e["total_ms"]))
        serving: dict = {"requests": len(reqs),
                         "by_status": dict(sorted(by_status.items())),
                         "tenants": len(by_tenant)}
        if lat_ms:
            serving["latency_ms"] = latency_summary(lat_ms)
            span = max(e["ts"] for e in reqs) - min(e["ts"] for e in reqs)
            if span > 0:
                serving["qps"] = round(len(lat_ms) / span, 1)
        if batches:
            lanes = [int(e.get("lanes", 0)) for e in batches]
            nreq = [int(e.get("requests", 0)) for e in batches]
            serving["batches"] = len(batches)
            serving["mean_lanes"] = round(sum(lanes) / len(lanes), 2)
            serving["max_lanes"] = max(lanes)
            serving["multi_request_batches"] = sum(
                1 for r in nreq if r > 1)
            hits = [e.get("cache_hit") for e in batches
                    if e.get("cache_hit") is not None]
            if hits:
                serving["cache_hit_fraction"] = round(
                    sum(bool(h) for h in hits) / len(hits), 3)
        summary["serving"] = serving

    # replicated serving fleet: replica lifecycle + routing
    # outcomes from the router's event stream — deaths (with lifetimes),
    # tenant failovers, reference rollovers, and the per-replica request
    # share computed from router-side serve_request events (which carry
    # the replica slot each request was served by)
    deaths = [e for e in events if e["t"] == "replica_death"]
    failovers = [e for e in events if e["t"] == "failover"]
    rollovers = [e for e in events if e["t"] == "rollover"]
    share: dict = {}
    for e in reqs:
        if e.get("replica") is not None:
            rep = str(e["replica"])
            share[rep] = share.get(rep, 0) + 1
    if deaths or failovers or rollovers or share:
        fleet: dict = {"replica_deaths": len(deaths),
                       "failovers": len(failovers),
                       "rollovers": len(rollovers)}
        reasons: dict = {}
        lifetimes = []
        for e in deaths:
            reasons[str(e.get("reason"))] = \
                reasons.get(str(e.get("reason")), 0) + 1
            up = e.get("uptime_s")
            if isinstance(up, (int, float)) and math.isfinite(up):
                lifetimes.append(round(float(up), 3))
        if reasons:
            fleet["deaths_by_reason"] = dict(sorted(reasons.items()))
        if lifetimes:
            fleet["replica_lifetimes_s"] = sorted(lifetimes)
        t_failed = sum(int(e.get("tenants", 0)) for e in failovers)
        if failovers:
            fleet["tenants_failed_over"] = t_failed
        if rollovers:
            fleet["rollover_wall_s"] = [
                round(float(e.get("wall_s", 0.0)), 3) for e in rollovers]
            gens = [int(e["generation"]) for e in rollovers
                    if isinstance(e.get("generation"), int)]
            if gens:
                fleet["generation"] = max(gens)
        if share:
            total_share = sum(share.values())
            fleet["requests_by_replica"] = dict(sorted(share.items()))
            fleet["request_share"] = {
                rep: round(n / total_share, 3)
                for rep, n in sorted(share.items())}
        summary["fleet"] = fleet

    # live observability plane: sampled trace spans rolled up
    # by name (the waterfall itself is the `trace` command), and the LAST
    # SLO verdict carried by a metrics_snapshot — what /healthz was
    # reporting when the stream ended
    span_evs = [e for e in events if e["t"] == "span"]
    if span_evs:
        by_name: dict = {}
        for e in span_evs:
            ent = by_name.setdefault(str(e.get("name")),
                                     {"count": 0, "wall_ms": 0.0})
            ent["count"] += 1
            w = e.get("wall_ms")
            if isinstance(w, (int, float)) and math.isfinite(w):
                ent["wall_ms"] += float(w)
        summary["spans"] = {
            "count": len(span_evs),
            "traces": len({e.get("trace") for e in span_evs}),
            "by_name": {name: {"count": v["count"],
                               "wall_ms_total": round(v["wall_ms"], 3)}
                        for name, v in sorted(by_name.items())}}
    slo_ev = next((e for e in reversed(events)
                   if e["t"] == "metrics_snapshot"
                   and isinstance(e.get("slo"), dict)), None)
    if slo_ev is not None:
        summary["slo"] = slo_ev["slo"]

    # roofline cost model: one row per (stage, kernel lane)
    # joining predicted work with the measured wall — achieved MFU,
    # achieved bandwidth fraction, and the compute-/memory-bound call.
    # Interpret-mode / nominal-peak rows carry perf_exempt so consumers
    # skip them instead of comparing
    perf_rows = []
    for e in events:
        if e["t"] != "perf_model":
            continue
        pred = e.get("predicted") or {}
        meas = e.get("measured") or {}
        roof = e.get("roofline") or {}
        row = {"stage": e.get("stage"), "lane": e.get("lane"),
               "wall_s": meas.get("wall_s"),
               "passes": meas.get("passes"),
               "flops": pred.get("flops"), "bytes": pred.get("bytes"),
               "mfu": roof.get("mfu"), "bw_frac": roof.get("bw_frac"),
               "intensity": roof.get("intensity"),
               "bound": roof.get("bound"),
               "peak_source": roof.get("peak_source"),
               "perf_exempt": bool(roof.get("perf_exempt"))}
        if pred.get("collective_bytes"):
            row["collective_bytes"] = pred["collective_bytes"]
        perf_rows.append(row)
    if perf_rows:
        summary["roofline"] = perf_rows

    mem_peak = 0
    mem_stage = None
    for e in events:
        if e["t"] != "memory":
            continue
        for dev in e.get("devices", []):
            b = dev.get("peak_bytes_in_use",
                        dev.get("bytes_in_use",
                                dev.get("live_buffer_bytes", 0)))
            if b and b > mem_peak:
                mem_peak, mem_stage = int(b), e.get("stage")
    if mem_peak:
        summary["memory_peak_bytes"] = mem_peak
        summary["memory_peak_stage"] = mem_stage
    return summary


def render_report(run_dir: str) -> str:
    """Human-readable run report from a run directory's telemetry (events
    JSONL preferred; the timings TSV alone still yields a stage table)."""
    lines: list[str] = []
    run_dir = run_dir.rstrip(os.sep)
    lines.append(f"cNMF run report — {run_dir}")
    lines.append("=" * min(78, len(lines[0])))

    event_files = _find_event_files(run_dir)
    events: list[dict] = []
    for path in event_files:
        events.extend(read_events(path))
    if not events:
        tsvs = []
        tmp = os.path.join(run_dir, "cnmf_tmp")
        if os.path.isdir(tmp):
            tsvs = [os.path.join(tmp, fn) for fn in sorted(os.listdir(tmp))
                    if fn.endswith(".timings.tsv")]
        if not tsvs:
            lines.append("no telemetry found (run with CNMF_TPU_TELEMETRY=1 "
                         "to produce an events.jsonl; no timings TSV either)")
            return "\n".join(lines)
        lines.append("no events.jsonl (telemetry was off) — stage walls "
                     "from the timings TSV:")
        stages: dict = {}
        for path in tsvs:
            with open(path) as f:
                next(f, None)
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        try:
                            stages[parts[0]] = (stages.get(parts[0], 0.0)
                                                + float(parts[1]))
                        except ValueError:
                            pass
        lines.extend(_stage_waterfall(
            {k: {"wall_s": v, "nbytes": 0, "count": 1}
             for k, v in stages.items()}))
        return "\n".join(lines)

    summary = summarize_events(events)

    man = summary.get("manifest")
    if man:
        lines.append("")
        lines.append("Manifest")
        lines.append("-" * 8)
        lines.append(
            f"  package {man.get('package_version')}   "
            f"jax {man.get('jax_version')}   backend {man.get('backend')} "
            f"({man.get('n_devices')} device(s))")

    plan_sum = summary.get("plan")
    if plan_sum and isinstance(plan_sum.get("plan"), dict):
        lines.append("")
        lines.append("Plan")
        lines.append("-" * 4)
        from ..runtime.planner import render_plan

        try:
            lines.extend("  " + ln
                         for ln in render_plan(plan_sum["plan"]))
        except Exception:
            lines.append("  (unrenderable plan payload)")
        if plan_sum.get("signature"):
            lines.append(f"  signature {plan_sum['signature']}")

    if summary.get("dispatch"):
        lines.append("")
        lines.append("Dispatch decisions")
        lines.append("-" * 18)
        for d in summary["dispatch"]:
            if d.get("decision") in ("consensus_path", "k_selection"):
                continue  # rendered in their own section below
            ctx = d.get("context", {})
            ctx_str = "  ".join(f"{k}={v}" for k, v in ctx.items()) \
                if isinstance(ctx, dict) else str(ctx)
            lines.append(f"  {d.get('decision')}: {ctx_str}")

    if summary.get("consensus"):
        lines.append("")
        lines.append("Consensus / k-selection dispatch")
        lines.append("-" * 32)
        for c in summary["consensus"]:
            if c.get("decision") == "k_selection":
                lines.append(
                    f"  k_selection: Ks={c.get('ks')}  "
                    f"R_max={c.get('R_max')}  packed={c.get('packed')}  "
                    f"sketch={'on dim=%s' % c.get('sketch_dim') if c.get('sketch') else 'off'}"
                    f" ({c.get('sketch_source')})")
            else:
                shape = c.get("distance_shape") or ["?", "?"]
                lines.append(
                    f"  {c.get('stage', 'consensus'):<18s} K={c.get('k')}"
                    f"  replicates={c.get('replicates')}"
                    f"  dist={shape[0]}x{shape[-1]}"
                    f" @ width {c.get('distance_width')}"
                    f"  sketch={'on dim=%s' % c.get('sketch_dim') if c.get('sketch') else 'off'}"
                    f" ({c.get('sketch_source')})"
                    f"{'  packed' if c.get('packed') else ''}")

    lines.append("")
    lines.append("Stage waterfall")
    lines.append("-" * 15)
    lines.extend(_stage_waterfall(summary.get("stages", {})))

    if summary.get("streaming"):
        lines.append("")
        lines.append("Host->device staging")
        lines.append("-" * 20)
        for s in summary["streaming"]:
            gbps = s.get("gb_per_s")
            lines.append(
                f"  {s['context']:<32s} {s['wall_s']:>8.3f} s  "
                f"{_fmt_bytes(s['nbytes']):>10s}  "
                f"{(f'{gbps:.2f} GB/s' if gbps is not None else ''):>11s}  "
                f"overlap {s.get('overlap_fraction', 0):.2f}")

    ing = summary.get("ingestion")
    if ing:
        lines.append("")
        lines.append("Ingestion (out-of-core shard store)")
        lines.append("-" * 35)
        if ing.get("store_bytes") is not None:
            lines.append(
                f"  {'store size':<28s} {_fmt_bytes(ing['store_bytes']):>10s}"
                f"  ({ing.get('slabs', '?')} slab(s), "
                f"{ing.get('format', '?')}, {ing.get('rows', '?')} rows)")
        if ing.get("backend") is not None:
            lines.append(f"  {'store backend':<28s}"
                         f" {str(ing['backend']):>10s}")
        elif ing.get("slabs") is not None:
            lines.append(f"  {'slabs':<28s} {ing['slabs']:>10d}")
        if ing.get("disk_read_nbytes") is not None:
            lines.append(
                f"  {'disk read':<28s}"
                f" {_fmt_bytes(ing['disk_read_nbytes']):>10s}"
                f"  ({ing.get('disk_read_gb_per_s', 0.0):.2f} GB/s)")
        if ing.get("overlap_fraction") is not None:
            lines.append(f"  {'disk/h2d overlap fraction':<28s}"
                         f" {ing['overlap_fraction']:>10.2f}")
        if ing.get("host_peak_bytes") is not None:
            lines.append(
                f"  {'host slab residency peak':<28s}"
                f" {_fmt_bytes(ing['host_peak_bytes']):>10s}")
        rem = ing.get("remote")
        if rem:
            lines.append(f"  {'remote cache hit rate':<28s}"
                         f" {rem.get('cache_hit_rate', 0.0):>10.1%}")
            lines.append(f"  {'remote transport retries':<28s}"
                         f" {rem.get('retries', 0):>10d}")
            lines.append(
                f"  {'remote hedges won':<28s}"
                f" {rem.get('hedges_won', 0):>10d}"
                f"  (of {rem.get('hedges', 0)} hedged)")
            lines.append(f"  {'remote degraded reads':<28s}"
                         f" {rem.get('degraded_reads', 0):>10d}")

    if summary.get("collectives"):
        lines.append("")
        lines.append("Collectives (2-D grid statistics reductions)")
        lines.append("-" * 44)
        for c in summary["collectives"]:
            ctx = c.get("context") or {}
            if not isinstance(ctx, dict):
                ctx = {}
            mesh_s = "x".join(str(x) for x in (ctx.get("mesh_shape")
                                               or [])) or "?"
            blocks = "/".join(str(x) for x in (ctx.get("blocks")
                                               or [])) or "?"
            frac = c.get("overlap_fraction")
            lines.append(
                f"  {str(ctx.get('stage', 'grid2d')):<20s} "
                f"k={str(ctx.get('k', '?')):<4s} mesh {mesh_s:<6s} "
                f"blocks {blocks:<6s} {float(c.get('wall_s', 0)):>8.3f} s"
                f"  {_fmt_bytes(c.get('nbytes', 0)):>10s}"
                + (f"  overlap {frac:.2f}" if frac is not None else ""))

    if summary.get("convergence"):
        lines.append("")
        lines.append("Replicate convergence (per K)")
        lines.append("-" * 29)
        # recipe + dna-fallback columns: which convergence math
        # ran, and — under the dna recipe — what fraction of lanes took
        # the monotone MU fallback instead of the Newton step
        any_fb = any(row.get("dna_fallback_mean") is not None
                     for row in summary["convergence"].values())
        lines.append(f"  {'K':>4s} {'reps':>6s} {'capped':>8s} "
                     f"{'nonfin':>7s} {'mean it':>8s} {'err median':>12s} "
                     f"{'rel spread':>11s} {'recipe':>12s}"
                     + (f" {'dna fb':>7s}" if any_fb else ""))
        for k, row in summary["convergence"].items():
            med = row.get("err_median")
            spread = row.get("err_rel_spread")
            fb = row.get("dna_fallback_mean")
            line = (
                f"  {k:>4s} {row['replicates']:>6d} "
                f"{row['fraction_capped']:>7.1%} "
                f"{row['nonfinite']:>7d} {row['mean_iters']:>8.1f} "
                f"{(f'{med:.5g}' if med is not None else '-'):>12s} "
                f"{(f'{spread:.2e}' if spread is not None else '-'):>11s} "
                f"{row.get('recipe') or '-':>12s}")
            if any_fb:
                line += f" {(f'{fb:.1%}' if fb is not None else '-'):>7s}"
            lines.append(line)

    if summary.get("faults") or summary.get("checkpoints"):
        lines.append("")
        lines.append("Faults & recoveries")
        lines.append("-" * 19)
        faults = summary.get("faults") or {}
        by_kind = faults.get("by_kind") or {}
        if by_kind:
            lines.append(f"  {'class':<28s} {'events':>7s}")
            for kind, n in by_kind.items():
                lines.append(f"  {kind:<28s} {n:>7d}")
            lines.append(
                "  retried %d (recovered %d), quarantined %d"
                % (faults.get("retried", 0), faults.get("recovered", 0),
                   faults.get("quarantined", 0)))
            if by_kind.get("store_net"):
                lines.append(
                    "  store_net: recovered %d, degraded reads %d"
                    % (faults.get("store_net_recovered", 0),
                       faults.get("store_net_degraded", 0)))
        ckpts = summary.get("checkpoints")
        if ckpts:
            actions = ckpts.get("actions", {})
            parts = [f"{n} {a}" for a, n in actions.items()]
            line = "  checkpoints: " + ", ".join(parts)
            if ckpts.get("max_resume_pass") is not None:
                line += (" (deepest resume: pass %d)"
                         % ckpts["max_resume_pass"])
            lines.append(line)

    el = summary.get("elasticity")
    if el:
        lines.append("")
        lines.append("Mesh elasticity")
        lines.append("-" * 15)
        lines.append(f"  {'host/device losses':<28s} {el['host_losses']:>7d}")
        remesh_detail = ("  (" + ", ".join(el["remesh_devices"]) + " devices)"
                         if el.get("remesh_devices") else "")
        lines.append(f"  {'degraded re-meshes':<28s} {el['remeshes']:>7d}"
                     + remesh_detail)
        lines.append(f"  {'stolen worker shards':<28s}"
                     f" {el['stolen_shards']:>7d}")
        lines.append(f"  {'stragglers contained':<28s}"
                     f" {el['stragglers']:>7d}")
        if el.get("max_resume_pass") is not None:
            lines.append(f"  {'deepest resumed pass':<28s}"
                         f" {el['max_resume_pass']:>7d}")

    srv = summary.get("serving")
    if srv:
        lines.append("")
        lines.append("Serving (projection daemon)")
        lines.append("-" * 27)
        status = "  ".join(f"{s}={n}" for s, n in
                           srv.get("by_status", {}).items())
        lines.append(f"  requests {srv['requests']} "
                     f"({srv.get('tenants', 0)} tenant(s))  {status}")
        if srv.get("batches"):
            lines.append(
                f"  batches {srv['batches']}  mean lanes "
                f"{srv.get('mean_lanes')}  max {srv.get('max_lanes')}  "
                f"cross-request batches "
                f"{srv.get('multi_request_batches', 0)}"
                + (f"  cache-hit {srv['cache_hit_fraction']:.0%}"
                   if srv.get("cache_hit_fraction") is not None else ""))
        lat = srv.get("latency_ms")
        if lat and lat.get("count"):
            lines.append(
                f"  latency p50 {lat.get('p50', 0):.2f} ms  "
                f"p95 {lat.get('p95', 0):.2f} ms  "
                f"p99 {lat.get('p99', 0):.2f} ms  "
                f"max {lat.get('max', 0):.2f} ms"
                + (f"  ({srv['qps']} req/s sustained)"
                   if srv.get("qps") is not None else ""))
            hist = lat.get("histogram") or {}
            if hist:
                total = sum(hist.values())
                for label, cnt in hist.items():
                    bar = "#" * max(1, int(round(cnt / total * 32)))
                    lines.append(f"    {label:>8s} ms {cnt:>7d}  {bar}")

    fleet = summary.get("fleet")
    if fleet:
        lines.append("")
        lines.append("Fleet (replicated serving)")
        lines.append("-" * 26)
        reasons = fleet.get("deaths_by_reason")
        lines.append(
            f"  replica deaths {fleet.get('replica_deaths', 0)}"
            + (f" ({', '.join(f'{r}={n}' for r, n in reasons.items())})"
               if reasons else "")
            + f"  failovers {fleet.get('failovers', 0)}"
            + (f" ({fleet['tenants_failed_over']} tenant(s) remapped)"
               if fleet.get("tenants_failed_over") is not None else ""))
        lives = fleet.get("replica_lifetimes_s")
        if lives:
            lines.append(
                f"  dead-replica lifetimes {min(lives):.1f}"
                f"-{max(lives):.1f} s over {len(lives)} death(s)")
        walls = fleet.get("rollover_wall_s")
        lines.append(
            f"  rollovers {fleet.get('rollovers', 0)}"
            + (f" (walls {', '.join(f'{w:.1f}s' for w in walls)};"
               f" now serving generation {fleet.get('generation')})"
               if walls else ""))
        share = fleet.get("request_share")
        if share:
            counts = fleet.get("requests_by_replica", {})
            for rep, frac in share.items():
                lines.append(f"    replica {rep:<8s} "
                             f"{counts.get(rep, 0):>7d} request(s)  "
                             f"{frac:.1%}")

    slo = summary.get("slo")
    if slo:
        lines.append("")
        lines.append("SLO")
        lines.append("-" * 3)
        verdict = ("BURNING" if slo.get("burning")
                   else "ok" if slo.get("requests") else "ok (no traffic)")
        p99 = slo.get("p99_ms")
        lines.append(
            f"  target p99 {slo.get('target_p99_ms')} ms over "
            f"{slo.get('window_s')} s window: {verdict}")
        lines.append(
            f"  windowed p99 "
            + (f"{p99:.2f} ms" if isinstance(p99, (int, float))
               else "n/a")
            + f"  requests {slo.get('requests', 0)}  errors "
            f"{slo.get('errors', 0)} "
            f"(rate {slo.get('error_rate', 0.0):.4f}, budget "
            f"{slo.get('max_error_rate', 0.0):.4f})")

    roof = summary.get("roofline")
    if roof:
        lines.append("")
        lines.append("Roofline")
        lines.append("-" * 8)
        lines.append(f"  {'stage':<22s} {'lane':<14s} {'wall':>9s} "
                     f"{'MFU':>7s} {'BW':>7s} {'int.':>8s}  verdict")
        for r in roof:
            mfu, bw = r.get("mfu"), r.get("bw_frac")
            inten = r.get("intensity")
            wall = r.get("wall_s")
            verdict = str(r.get("bound") or "?")
            if r.get("perf_exempt"):
                verdict += " (perf-exempt)"
            if r.get("peak_source") and r.get("peak_source") != "datasheet":
                verdict += f" [{r['peak_source']}]"
            lines.append(
                "  "
                f"{str(r.get('stage'))[:22]:<22s} "
                f"{str(r.get('lane'))[:14]:<14s} "
                + (f"{wall:>8.3f}s" if isinstance(wall, (int, float))
                   else f"{'n/a':>9s}") + " "
                + (f"{100 * mfu:>6.2f}%" if isinstance(mfu, (int, float))
                   else f"{'n/a':>7s}") + " "
                + (f"{100 * bw:>6.2f}%" if isinstance(bw, (int, float))
                   else f"{'n/a':>7s}") + " "
                + (f"{inten:>8.2f}" if isinstance(inten, (int, float))
                   else f"{'n/a':>8s}")
                + f"  {verdict}")

    spans = summary.get("spans")
    if spans:
        lines.append("")
        lines.append("Trace spans (sampled)")
        lines.append("-" * 21)
        lines.append(f"  {spans['count']} span(s) across "
                     f"{spans['traces']} trace(s) — render waterfalls "
                     f"with `cnmf-tpu trace <run_dir>`")
        for name, v in spans.get("by_name", {}).items():
            lines.append(f"  {name:<28s} {v['count']:>6d} span(s) "
                         f"{v['wall_ms_total']:>10.1f} ms total")

    lines.append("")
    lines.append("Device memory")
    lines.append("-" * 13)
    if summary.get("memory_peak_bytes"):
        lines.append(
            f"  peak {_fmt_bytes(summary['memory_peak_bytes'])} "
            f"(at stage boundary: {summary.get('memory_peak_stage')})")
    else:
        lines.append("  no memory watermarks recorded (backend reports no "
                     "memory stats and no live buffers were sampled)")
    lines.append("")
    lines.append(f"{summary['n_events']} events across "
                 f"{len(event_files)} file(s)")
    return "\n".join(lines)


def _stage_waterfall(stages: dict) -> list[str]:
    if not stages:
        return ["  (no stage events)"]
    # top-level pipeline stages first, sub-stages (dotted/slashed) under
    top = {k: v for k, v in stages.items() if "." not in k and "/" not in k}
    total = sum(v["wall_s"] for v in top.values()) or \
        sum(v["wall_s"] for v in stages.values())
    width = 32
    out = []
    for name, v in sorted(stages.items(),
                          key=lambda kv: -kv[1]["wall_s"]):
        frac = v["wall_s"] / total if total > 0 else 0.0
        bar = "#" * max(1, int(round(min(frac, 1.0) * width))) \
            if v["wall_s"] > 0 else ""
        extra = ""
        if v.get("nbytes"):
            gbps = v["nbytes"] / v["wall_s"] / 1e9 if v["wall_s"] > 0 else 0
            extra = f"  {_fmt_bytes(v['nbytes'])} ({gbps:.2f} GB/s)"
        out.append(f"  {name:<36s} {v['wall_s']:>9.3f} s  "
                   f"{bar:<{width}s}{extra}")
    return out
