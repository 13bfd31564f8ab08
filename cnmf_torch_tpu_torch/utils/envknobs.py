"""The environment knobs the port reads, and their parsers.

Own copy of the readers of ``cnmf_torch_tpu/utils/envknobs.py``
(``env_int``, ``env_str``, ``env_flag``) with the same parsing, words and
errors, so the same environment means the same thing to both packages.
The registry (:data:`REGISTRY`, the JAX package's ``Knob`` shape, its
kinds and defaults beside the port's own text) holds only the knobs the
port honours; reading any other name raises, as it does in the JAX
package. Two checks hang off it: the lint's knob rules
(``analysis/rules_knobs.py``: no raw ``os.environ`` read of a knob, no
accessor naming an unregistered one) and the generated table
``KNOBS.md`` beside the package (:func:`knob_table`), which the lint holds
to the registry both ways.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

__all__ = ["Knob", "REGISTRY", "KNOBS", "env_int", "env_float", "env_str",
           "env_flag", "env_is_set", "pin_knob", "knob_table",
           "parse_knob_table"]

_FALSE_WORDS = ("0", "false", "off", "no")


@dataclass(frozen=True)
class Knob:
    """One knob the port reads: its name, kind (``int``, ``float``, ``str``
    or ``flag``), the default as the knob table shows it, and what it does.
    The kind and the default are the JAX package's; ``documented=False``
    would keep a knob out of the table (the JAX package's ``JAX_*``
    variables; the port has none)."""

    name: str
    kind: str
    default: str
    doc: str
    documented: bool = True


def _knobs(*entries) -> dict:
    return {k.name: k for k in entries}


REGISTRY: dict[str, Knob] = _knobs(
    # -- the solver recipe knobs (ops/recipe.py), the lane and precision
    # knobs (ops/sparse.py, ops/nmf.py), the sweep's memory budget
    # (parallel/replicates.py), the fault harness (runtime/faults.py) and the
    # retry policy (runtime/resilience.py)
    Knob("CNMF_TPU_ACCEL", "str", "auto",
         "solver acceleration: auto (default), 0 or 1"),
    Knob("CNMF_TPU_INNER_REPEATS", "int", "auto",
         "amu inner repeats (auto or an integer)"),
    Knob("CNMF_TPU_KL_NEWTON", "flag", "`1`",
         "an engaged acceleration picks dna for KL (1)"),
    Knob("CNMF_TPU_SKETCH", "str", "`0`",
         "sketched KL W updates: 0 (default), 1 or auto"),
    Knob("CNMF_TPU_SKETCH_DIM", "int", "auto",
         "sampled rows per sketched W update"),
    Knob("CNMF_TPU_SKETCH_EXACT_EVERY", "int", "`4`",
         "exact W update cadence of the sketch"),
    Knob("CNMF_TPU_SPARSE_BETA", "str", "auto",
         "ELL lane for beta in {1, 0}: 0 dense, 1 ELL, or a density "
         "threshold in (0, 1)"),
    Knob("CNMF_TPU_BF16_RATIO", "flag", "`1`",
         "bf16 ratio chain of online KL/IS (1, the default) or strict f32"
         " (0)"),
    Knob("CNMF_TPU_BUDGET_ELEMS", "int", "device-derived",
         "f32 element budget of a replicate slice (default: from the "
         "card's free memory)"),
    Knob("CNMF_TPU_FAULT_SPEC", "str", "unset",
         "deterministic fault injection clauses (unset: every hook is a "
         "no-op)"),
    Knob("CNMF_TPU_MAX_RETRIES", "int", "`2`",
         "derived-seed retries of an unhealthy replicate (default 2)"),
    Knob("CNMF_TPU_MIN_HEALTHY_FRAC", "float", "`0.8`",
         "per-K floor of healthy replicates after retries (default 0.8)"),
    # -- the telemetry base (utils/telemetry.py, utils/profiling.py, obs/)
    Knob("CNMF_TPU_TELEMETRY", "flag", "`0`",
         "flag: the run's event log (<run>/cnmf_tmp/<name>.events.jsonl; "
         "default 0)"),
    Knob("CNMF_TPU_PROFILE_DIR", "str", "unset",
         "per-stage torch.profiler Chrome traces into this directory "
         "(unset: none)"),
    Knob("CNMF_TPU_METRICS", "flag", "`0`",
         "flag: the metrics registry records and metrics_snapshot events "
         "land (default 0)"),
    Knob("CNMF_TPU_TRACE_SAMPLE", "float", "`0`",
         "trace sampling probability in [0, 1] (default 0: no spans)"),
    Knob("CNMF_TPU_TRACE_CTX", "str", "unset",
         "trace_id:span_id context a parent process hands its workers "
         "(unset: none)"),
    Knob("CNMF_TPU_SLO_P99_MS", "float", "`0` (off)",
         "target p99 latency of the SLO tracker in ms (default 0: off)"),
    Knob("CNMF_TPU_SLO_WINDOW_S", "float", "`300`",
         "SLO evaluation window in seconds (default 300)"),
    # -- the out-of-core layer (utils/shardstore.py, utils/storebackend.py,
    # runtime/checkpoint.py, parallel/streaming.py, parallel/rowshard.py)
    Knob("CNMF_TPU_OOC", "str", "auto",
         "row-slab shard store of the normalized counts: auto (default: "
         "written above the host budget), 1 (forced and authoritative) or"
         " 0 (off)"),
    Knob("CNMF_TPU_OOC_BUDGET_BYTES", "int", "`1<<30`",
         "host slab-residency budget in bytes (default 1 GiB)"),
    Knob("CNMF_TPU_OOC_SLAB_ROWS", "int", "`0` (auto)",
         "rows a store slab (default 0: from the budget)"),
    Knob("CNMF_TPU_OOC_SHARD_BYTES", "int", "`0` (device-derived)",
         "resident-shard budget in bytes above which a store-backed solve"
         " loops over slab groups (default 0: from the card's free "
         "memory)"),
    Knob("CNMF_TPU_SHARD_RETRIES", "int", "`2`",
         "re-reads of a torn slab and retries of a failed slab upload "
         "(default 2)"),
    Knob("CNMF_TPU_SHARD_BACKOFF_S", "float", "`0.1`",
         "slab upload retry backoff base in seconds (default 0.1)"),
    Knob("CNMF_TPU_CKPT_EVERY_PASSES", "int", "`1`",
         "pass checkpoint cadence of the row-sharded solver (default 1; 0"
         " off)"),
    Knob("CNMF_TPU_CKPT_H_BYTES", "int", "`256<<20`",
         "largest usage matrix a pass checkpoint holds (default 256 MiB)"),
    Knob("CNMF_TPU_CKPT_MIN_INTERVAL_S", "float", "`0` (every eligible pass)",
         "least seconds between two checkpoint writes (default 0)"),
    Knob("CNMF_TPU_STREAM_DEPTH", "int", "`2×threads+1`",
         "slabs in flight in the staging pipeline (default 2 x threads + "
         "1; 1 serial)"),
    Knob("CNMF_TPU_STREAM_THREADS", "int", "`min(4, cpus−1)`",
         "host-prep threads of the staging pipeline (default min(4, cores"
         " - 1); 0 serial)"),
    Knob("CNMF_TPU_STREAM_BYTES", "int", "`4<<30`",
         "host bytes budget of in-flight slabs (default 4 GiB)"),
    Knob("CNMF_TPU_STREAM_STALL_S", "float", "`0` (off)",
         "seconds without progress after which a slab upload is a stall "
         "(default 0: off)"),
    Knob("CNMF_TPU_STORE_URI", "str", "unset",
         "where the shard store lives: unset (local paths), file:///base "
         "or http(s)://host:port/prefix (an object store)"),
    # -- the remote object store's transport (utils/storebackend.py)
    Knob("CNMF_TPU_STORE_RETRIES", "int", "`3`",
         "network retries of a remote store operation (default 3; 0 off)"),
    Knob("CNMF_TPU_STORE_BACKOFF_S", "float", "`0.05`",
         "remote store retry backoff base in seconds (default 0.05)"),
    Knob("CNMF_TPU_STORE_TIMEOUT_S", "float", "`30`",
         "socket timeout of a remote slab transfer in seconds; metadata "
         "uses max(1, t/4) (default 30)"),
    Knob("CNMF_TPU_STORE_HEDGE_S", "float", "`0` (off)",
         "seconds after which a remote GET is hedged by a second request "
         "(default 0: off)"),
    Knob("CNMF_TPU_STORE_CACHE_BYTES", "int", "`1<<30`",
         "read-through cache budget of a remote store, <store>.cache "
         "(default 1 GiB; 0 off)"),
    # -- the roofline cost model and the snapshot diff (obs/costmodel.py,
    # obs/regress.py)
    Knob("CNMF_TPU_PERF_MODEL", "flag", "`0`",
         "flag: factorize emits perf_model events under the telemetry "
         "(default 0)"),
    Knob("CNMF_TPU_PERF_GATE_BAND", "float", "`0.6`",
         "relative band a bench metric must move past before benchdiff "
         "calls it (default 0.6)"),
    Knob("CNMF_TPU_PERF_GATE_N", "int", "`3`",
         "the perf gate's sample count (obs/perf_gate.py): each wall is "
         "measured N times and compared min-of-N (default 3, at least "
         "1)"),
    # -- the multi-device layer (parallel/mesh.py, parallel/multihost.py,
    # parallel/grid2d.py, runtime/elastic.py, launcher.py), the JAX text
    Knob("CNMF_TPU_GRID_OVERLAP", "flag", "`1`",
         "compute-overlapped grid collectives (MPI-FAUN): each statistics"
         " block's psum dispatches while the next block's local gemm "
         "computes; `0` serializes reduce→gemm with a barrier — results "
         "are bit-identical either way, only scheduling freedom differs"),
    Knob("CNMF_TPU_GRID_BLOCKS", "int", "`0` (auto)",
         "statistics sub-blocks per overlapped reduction on the (cells × "
         "genes) grid (clamped to a divisor of the local rows/cols); `0` "
         "derives 4 blocks when the tile affords them, `1` disables "
         "blocking (one psum per statistic)"),
    Knob("CNMF_TPU_GRID_SHAPE", "str", "auto",
         "pin the (cells × genes) grid factorization as `CxG` (e.g. "
         "`4x2`); `auto` lays cells across hosts / genes within a host on"
         " pods (the O(rows·k) reductions stay on ICI, only k×g/k×k "
         "crosses DCN) and factors most-square single-host"),
    Knob("CNMF_TPU_BARRIER_TIMEOUT_S", "float", "`0` (off)",
         "cross-host barrier watchdog: a barrier a dead host can never "
         "join raises `HostBarrierTimeout` (clean abort; relaunch resumes"
         " from checkpoints) instead of a distributed hang"),
    Knob("CNMF_TPU_WORKER_TIMEOUT", "float", "`0` (off)",
         "per-worker wall timeout in seconds for the subprocess launcher "
         "engine; an over-budget worker is killed (and respawned, below)"),
    Knob("CNMF_TPU_WORKER_RESPAWNS", "int", "`1`",
         "how many times the launcher respawns a dead/timed-out worker "
         "onto its unfinished ledger shard (`--skip-completed-runs`) "
         "before falling back to skip-missing combine"),
    Knob("CNMF_TPU_WORKER_BACKOFF_S", "float", "`0.5`",
         "respawn backoff base: attempt N waits `base * 2^(N-1)` seconds"),
    Knob("CNMF_TPU_ELASTIC", "flag", "`1`",
         "elastic degraded-mode execution: after a host/device loss the "
         "rowshard and 2-D factorize paths re-plan a smaller mesh over "
         "the surviving devices, re-stage X, and resume in-flight "
         "replicates from their pass checkpoints; the launcher "
         "additionally lets the idle fleet adopt a dead or straggling "
         "worker's shard (work-stealing). `0` restores abort-and-relaunch"),
    Knob("CNMF_TPU_HEARTBEAT_S", "float", "`0` (off)",
         "mesh-participant liveness interval: each process/worker stamps "
         "an atomic heartbeat file (pass cursor included) at pass/stage "
         "boundaries; barrier timeouts and straggler containment then "
         "name the silent culprit (index, last-beat age, pass) instead of"
         " a generic timeout. A peer is presumed dead after 3x this "
         "interval"),
    Knob("CNMF_TPU_STRAGGLER_S", "float", "`0` (off)",
         "launcher straggler grace (elastic layer; needs "
         "`CNMF_TPU_HEARTBEAT_S` — conviction is evidence-based): a "
         "worker whose run exceeds the longest clean finisher's wall time"
         " by this many seconds AND whose heartbeat is stale (older than "
         "max(grace, 3× heartbeat interval)) is killed and its shard "
         "adopted by the fleet — containment before a slow shard wedges "
         "the sweep. Clocks start at each process's own spawn, so "
         "adoptions redoing a full shard get a full allowance; a worker "
         "stamping liveness on schedule is never convicted"),
    Knob("CNMF_TPU_MIN_DEVICES", "int", "`1`",
         "degraded-mesh floor: elastic continuation refuses to shrink "
         "below this many surviving devices and re-raises the loss "
         "(clean, checkpoint-resumable abort) instead"),
    Knob("CNMF_COORDINATOR_ADDRESS", "str", "unset",
         "multi-host pod coordinate: coordinator `host:port` (set all "
         "three together)"),
    Knob("CNMF_NUM_PROCESSES", "int", "unset",
         "multi-host pod coordinate: total process count (set all three "
         "together)"),
    Knob("CNMF_PROCESS_ID", "int", "unset",
         "multi-host pod coordinate: this process's id (set all three "
         "together)"),
    Knob("CNMF_SIM_CPU_DEVICES", "int", "unset",
         "simulate an N-device CPU pod host (launcher/tests)"),
    # -- the serving tier and the fleet (serving/), the JAX text
    Knob("CNMF_TPU_SERVE_BATCH", "int", "`8`",
         "projection daemon (`cnmf-tpu serve`): max request lanes "
         "coalesced into one batched device dispatch; `1` disables "
         "cross-request batching (every request solves solo)"),
    Knob("CNMF_TPU_SERVE_LINGER_MS", "float", "`2`",
         "micro-batching linger: after the first queued request, the "
         "dispatcher waits up to this many milliseconds for batchmates "
         "before launching the (possibly smaller) batch; `0` dispatches "
         "immediately"),
    Knob("CNMF_TPU_SERVE_BUCKETS", "str", "`64,256,1024`",
         "padded-shape bucket schedule for the serve program cache: "
         "request row counts round up to the next bucket (the run's "
         "online chunk size is always appended as the top bucket) so a "
         "bounded program set serves every request shape with zero "
         "steady-state compiles"),
    Knob("CNMF_TPU_SERVE_TIMEOUT_S", "float", "`30`",
         "admission deadline: a request still undispatched this long "
         "after arrival is shed with a clear error instead of waiting "
         "behind an overloaded queue (the queue itself is bounded at 4x "
         "the batch size; arrivals beyond it shed immediately)"),
    Knob("CNMF_TPU_SERVE_WARM_START", "flag", "`1`",
         "serve-path usage warm starts: a repeat (tenant, matrix) "
         "projection re-solves from the tenant's previous usage matrix "
         "instead of the constant init — repeat projections converge in a"
         " fraction of the inner iterations; `0` restores the stateless "
         "solo-identical init for every request"),
    Knob("CNMF_TPU_SERVE_DRAIN_S", "float", "`30`",
         "shutdown drain budget: on `POST /shutdown` (or any daemon "
         "close) the accept loop stops first, then every already-accepted"
         " request runs to its real reply for up to this many seconds "
         "before the batcher is torn down — no accepted request is lost "
         "across a clean shutdown, which is what the fleet's "
         "zero-downtime rollover drains ride"),
    Knob("CNMF_TPU_FLEET_REPLICAS", "int", "`2`",
         "`cnmf-tpu fleet`: serve replicas the router spawns and fronts "
         "(also `--replicas`); each is a full `serve` daemon subprocess "
         "with its own unix socket, heartbeat file, and AOT-warmed "
         "program cache"),
    Knob("CNMF_TPU_FLEET_HEALTH_S", "float", "`0.5`",
         "fleet supervision cadence: every tick the router reaps dead "
         "replica processes, polls `/healthz`, reads heartbeat stamps, "
         "and runs the wedge-conviction bookkeeping"),
    Knob("CNMF_TPU_FLEET_HEDGE_MS", "float", "`0` (off)",
         "tail hedging: when the primary replica has not replied after "
         "this many milliseconds the router launches ONE duplicate "
         "attempt (same idempotency id) on the next candidate and takes "
         "whichever answers first — bounds the p99 paid for a momentarily"
         " slow replica; `0` disables hedging"),
    Knob("CNMF_TPU_FLEET_REPLICA_TELEMETRY", "flag", "`0`",
         "`1` leaves telemetry ON inside fleet replica subprocesses "
         "(their per-replica events land in "
         "`<name>.r<ordinal>.events.jsonl`). Default off: the router's "
         "own event stream already carries per-request outcomes, and N "
         "replicas would otherwise multi-count `serve_request` in "
         "`cnmf-tpu report`"),
    Knob("CNMF_TPU_FLEET_RESPAWNS", "int", "`3`",
         "respawn budget per replica slot: each death schedules a respawn"
         " after the launcher's deterministic exponential backoff "
         "(`CNMF_TPU_WORKER_BACKOFF_S` base) until the budget is "
         "exhausted, after which the slot stays down and its tenants "
         "remain failed over to the survivors"),
    Knob("CNMF_TPU_FLEET_RETRIES", "int", "`2`",
         "router failover retries per request on TRANSPORT errors "
         "(replica died mid-request, connect refused): the retry carries "
         "the same idempotency id to the next consistent-hash candidate, "
         "so a request that actually solved is never solved twice; "
         "replica-side verdicts (shed/poison/quarantine) pass through "
         "without retry"),
    Knob("CNMF_TPU_FLEET_TENANT_QPS", "float", "`0` (off)",
         "per-tenant token-bucket admission rate at the router "
         "(requests/s): a tenant exceeding its bucket sheds with HTTP 429"
         " BEFORE consuming replica queue space, so one hot tenant cannot"
         " starve the fleet; `0` disables quota admission"),
    Knob("CNMF_TPU_FLEET_TENANT_BURST", "float", "`0` (auto)",
         "token-bucket burst capacity per tenant; `0` defaults to `2x` "
         "the rate (one second of headroom on top of sustained "
         "`CNMF_TPU_FLEET_TENANT_QPS`)"),
    Knob("CNMF_TPU_FLEET_WARM_TIMEOUT_S", "float", "`300`",
         "rollover warm budget: `POST /rollover` spawns a fresh replica "
         "set against the new reference and waits up to this long for "
         "every one to answer `/healthz` before any traffic moves; on "
         "timeout (or a fresh replica dying) the new set is killed and "
         "the old generation keeps serving untouched"),
    Knob("CNMF_TPU_FLEET_WEDGE_POLLS", "int", "`3`",
         "wedge conviction threshold: a replica whose `/healthz` fails "
         "this many CONSECUTIVE ticks while its heartbeat is stale or "
         "absent is convicted as wedged (alive-but-unresponsive), "
         "SIGKILLed, and respawned — one failed poll on a busy replica "
         "never convicts"),
    Knob("CNMF_TPU_WARM_DUMMY_BUDGET_BYTES", "int", "`2<<30`",
         "cap on dataset-sized warm-up dummy allocations "
         "(consensus/K-selection/Harmony warms)"),
    # -- h5ad output (utils/anndata_lite.py), the execution planner
    # (runtime/planner.py) and its autotuner (utils/autotune.py), the JAX
    # text
    Knob("CNMF_H5_COMPRESSION", "str", "`none`",
         "h5ad artifact compression: `none` (reference-matching default; "
         "gzip-1 was ~5 s of a 22 s prepare), `gzip` (level 1), or `lzf`"),
    Knob("CNMF_TPU_PLAN", "str", "unset",
         "path to a dumped execution-plan JSON (the env spelling of "
         "`cnmf-tpu factorize --plan`): loaded before any dispatch "
         "resolves and pinned knob-by-knob, so the run reproduces the "
         "recorded dispatch bit-identically (`runtime/planner.py`; the "
         "resolved plan of every factorize is logged as a `plan` "
         "telemetry event and printed by `cnmf-tpu plan <run_dir>`)"),
    Knob("CNMF_TPU_AUTOTUNE", "str", "auto",
         "the microbench autotuner behind the execution planner "
         "(`utils/autotune.py`): `auto` (default) consumes an existing "
         "per-device measured cache (ρ cost ratios, ELL density "
         "crossover, Pallas-vs-jnp, grid blocks, stream threads, sketch "
         "dim) but only measures when an explicitly engaged lane needs "
         "it; `1` measures all plan points up front (once per device "
         "fingerprint, ~2 s); `0` disables measuring AND consuming — "
         "static heuristics only, the deterministic escape hatch"),
    # -- the sanitizer (utils/sanitize.py)
    Knob("CNMF_TPU_SANITIZE", "flag", "`0`",
         "`1` wraps the designated solver tests of "
         "`tests/test_torch_cuda.py` in `utils/sanitize.py:sync_guard` "
         "(`torch.cuda.set_sync_debug_mode(\"error\")`): an implicit "
         "device-to-host sync outside a chosen `host_read()` fails the "
         "test, which also asserts finite outputs"),
)

# name -> what it does: the view the accessors check a name against
KNOBS = {name: knob.doc for name, knob in REGISTRY.items()}


def _raw(name: str) -> str | None:
    if name not in KNOBS:
        raise ValueError(f"env knob {name!r} is not one the port reads; "
                         "declare it in cnmf_torch_tpu_torch/utils/"
                         "envknobs.py")
    return os.environ.get(name)


def env_int(name: str, default: int | None,
            lo: int | None = None, hi: int | None = None) -> int | None:
    """Parse an integer knob: empty/unset -> ``default``; non-numeric or
    outside ``[lo, hi]`` raises ``ValueError`` naming the knob."""
    raw = (_raw(name) or "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer")
    if lo is not None and val < lo:
        raise ValueError(f"{name}={raw!r}: must be >= {lo}")
    if hi is not None and val > hi:
        raise ValueError(f"{name}={raw!r}: must be <= {hi}")
    return val


def env_float(name: str, default: float | None,
              lo: float | None = None,
              hi: float | None = None) -> float | None:
    """Parse a float knob with the same strictness as :func:`env_int`."""
    raw = (_raw(name) or "").strip()
    if not raw:
        return default
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a number")
    if lo is not None and val < lo:
        raise ValueError(f"{name}={raw!r}: must be >= {lo}")
    if hi is not None and val > hi:
        raise ValueError(f"{name}={raw!r}: must be <= {hi}")
    return val


def env_str(name: str, default: str = "") -> str:
    """Read a string knob verbatim; unset -> ``default``."""
    raw = _raw(name)
    return default if raw is None else raw


def env_flag(name: str, default: bool) -> bool:
    """Boolean knob: unset/empty -> ``default``; ``0/false/off/no`` (any
    case) -> False; anything else -> True."""
    raw = _raw(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in _FALSE_WORDS


def env_is_set(name: str) -> bool:
    """True when the knob is present in the environment (even empty): the
    "an explicit pin wins" predicate of the execution planner."""
    _raw(name)
    return name in os.environ


def pin_knob(name: str, value) -> None:
    """Set a knob's value in this process's environment: the planner's
    replay (``runtime/planner.py:apply_plan``). Only a knob the port reads
    may be pinned."""
    _raw(name)
    os.environ[name] = str(value)


# ---------------------------------------------------------------------------
# the knob table (cnmf_torch_tpu_torch/KNOBS.md)
# ---------------------------------------------------------------------------

TABLE_HEADER = ("| knob | default | what it does |", "|---|---|---|")


def knob_table() -> str:
    """The markdown knob table generated from the registry
    (``python -m cnmf_torch_tpu_torch lint --knob-table``). ``KNOBS.md``
    beside the package holds it byte for byte; the lint's
    ``knob-doc-drift`` rule compares the two both ways, so regenerate it
    instead of editing it."""
    lines = list(TABLE_HEADER)
    for k in REGISTRY.values():
        if k.documented:
            lines.append(f"| `{k.name}` | {k.default} | {k.doc} |")
    return "\n".join(lines)


def parse_knob_table(text: str) -> dict[str, tuple[str, str]]:
    """``{name: (default cell, doc cell)}`` of a markdown knob table (the
    rows ``| `NAME` | default | doc |``; other lines and the header are
    skipped). The name and default cells hold no ``|``; the doc cell is
    the rest of the row, so a doc with a ``|`` still parses."""
    row_re = re.compile(r"^\| (.+?) \| (.+?) \| (.+) \|$")
    out: dict[str, tuple[str, str]] = {}
    for line in text.splitlines():
        m = row_re.match(line.strip())
        if not m:
            continue
        name_cell, default_cell, doc_cell = (c.strip() for c in m.groups())
        if name_cell in ("knob", "Variable"):
            continue
        for name in re.findall(r"`((?:CNMF|JAX)[A-Z0-9_]*)`", name_cell):
            out[name] = (default_cell, doc_cell)
    return out
