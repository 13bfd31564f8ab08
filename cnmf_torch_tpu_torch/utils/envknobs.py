"""The environment knobs the port reads, and their parsers.

Own copy of the readers of ``cnmf_torch_tpu/utils/envknobs.py``
(``env_int``, ``env_str``, ``env_flag``) with the same parsing, words and
errors, so the same environment means the same thing to both packages.
The registry holds only the knobs the port honours; reading any other
name raises, as it does in the JAX package.
"""

from __future__ import annotations

import os

__all__ = ["KNOBS", "env_int", "env_float", "env_str", "env_flag"]

_FALSE_WORDS = ("0", "false", "off", "no")

# name -> what it does (the solver recipe knobs of ops/recipe.py, the
# lane and precision knobs of ops/sparse.py and ops/nmf.py, the sweep's
# memory budget of parallel/replicates.py, the fault harness of
# runtime/faults.py, the retry policy of runtime/resilience.py, the
# telemetry base's, the store's and the cost model's knobs, with the JAX
# package's types and defaults)
KNOBS = {
    "CNMF_TPU_ACCEL": "solver acceleration: auto (default), 0 or 1",
    "CNMF_TPU_INNER_REPEATS": "amu inner repeats (auto or an integer)",
    "CNMF_TPU_KL_NEWTON": "an engaged acceleration picks dna for KL (1)",
    "CNMF_TPU_SKETCH": "sketched KL W updates: 0 (default), 1 or auto",
    "CNMF_TPU_SKETCH_DIM": "sampled rows per sketched W update",
    "CNMF_TPU_SKETCH_EXACT_EVERY": "exact W update cadence of the sketch",
    "CNMF_TPU_SPARSE_BETA": "ELL lane for beta in {1, 0}: 0 dense, 1 ELL, "
                            "or a density threshold in (0, 1)",
    "CNMF_TPU_BF16_RATIO": "bf16 ratio chain of online KL/IS (1, the "
                           "default) or strict f32 (0)",
    "CNMF_TPU_BUDGET_ELEMS": "f32 element budget of a replicate slice "
                             "(default: from the card's free memory)",
    "CNMF_TPU_FAULT_SPEC": "deterministic fault injection clauses "
                           "(unset: every hook is a no-op)",
    "CNMF_TPU_MAX_RETRIES": "derived-seed retries of an unhealthy "
                            "replicate (default 2)",
    "CNMF_TPU_MIN_HEALTHY_FRAC": "per-K floor of healthy replicates after "
                                 "retries (default 0.8)",
    # the telemetry base (utils/telemetry.py, utils/profiling.py, obs/)
    "CNMF_TPU_TELEMETRY": "flag: the run's event log "
                          "(<run>/cnmf_tmp/<name>.events.jsonl; default 0)",
    "CNMF_TPU_PROFILE_DIR": "per-stage torch.profiler Chrome traces into "
                            "this directory (unset: none)",
    "CNMF_TPU_METRICS": "flag: the metrics registry records and "
                        "metrics_snapshot events land (default 0)",
    "CNMF_TPU_TRACE_SAMPLE": "trace sampling probability in [0, 1] "
                             "(default 0: no spans)",
    "CNMF_TPU_TRACE_CTX": "trace_id:span_id context a parent process "
                          "hands its workers (unset: none)",
    "CNMF_TPU_SLO_P99_MS": "target p99 latency of the SLO tracker in ms "
                           "(default 0: off)",
    "CNMF_TPU_SLO_WINDOW_S": "SLO evaluation window in seconds "
                             "(default 300)",
    # the out-of-core layer (utils/shardstore.py, utils/storebackend.py,
    # runtime/checkpoint.py, parallel/streaming.py, parallel/rowshard.py)
    "CNMF_TPU_OOC": "row-slab shard store of the normalized counts: auto "
                    "(default: written above the host budget), 1 (forced "
                    "and authoritative) or 0 (off)",
    "CNMF_TPU_OOC_BUDGET_BYTES": "host slab-residency budget in bytes "
                                 "(default 1 GiB)",
    "CNMF_TPU_OOC_SLAB_ROWS": "rows a store slab (default 0: from the "
                              "budget)",
    "CNMF_TPU_OOC_SHARD_BYTES": "resident-shard budget in bytes above which "
                                "a store-backed solve loops over slab groups "
                                "(default 0: from the card's free memory)",
    "CNMF_TPU_SHARD_RETRIES": "re-reads of a torn slab and retries of a "
                              "failed slab upload (default 2)",
    "CNMF_TPU_SHARD_BACKOFF_S": "slab upload retry backoff base in seconds "
                                "(default 0.1)",
    "CNMF_TPU_CKPT_EVERY_PASSES": "pass checkpoint cadence of the row-"
                                  "sharded solver (default 1; 0 off)",
    "CNMF_TPU_CKPT_H_BYTES": "largest usage matrix a pass checkpoint holds "
                             "(default 256 MiB)",
    "CNMF_TPU_CKPT_MIN_INTERVAL_S": "least seconds between two checkpoint "
                                    "writes (default 0)",
    "CNMF_TPU_STREAM_DEPTH": "slabs in flight in the staging pipeline "
                             "(default 2 x threads + 1; 1 serial)",
    "CNMF_TPU_STREAM_THREADS": "host-prep threads of the staging pipeline "
                               "(default min(4, cores - 1); 0 serial)",
    "CNMF_TPU_STREAM_BYTES": "host bytes budget of in-flight slabs "
                             "(default 4 GiB)",
    "CNMF_TPU_STREAM_STALL_S": "seconds without progress after which a "
                               "slab upload is a stall (default 0: off)",
    "CNMF_TPU_STORE_URI": "where the shard store lives: unset (local "
                          "paths), file:///base or "
                          "http(s)://host:port/prefix (an object store)",
    # the remote object store's transport (utils/storebackend.py)
    "CNMF_TPU_STORE_RETRIES": "network retries of a remote store operation "
                              "(default 3; 0 off)",
    "CNMF_TPU_STORE_BACKOFF_S": "remote store retry backoff base in seconds "
                                "(default 0.05)",
    "CNMF_TPU_STORE_TIMEOUT_S": "socket timeout of a remote slab transfer "
                                "in seconds; metadata uses max(1, t/4) "
                                "(default 30)",
    "CNMF_TPU_STORE_HEDGE_S": "seconds after which a remote GET is hedged "
                              "by a second request (default 0: off)",
    "CNMF_TPU_STORE_CACHE_BYTES": "read-through cache budget of a remote "
                                  "store, <store>.cache (default 1 GiB; 0 "
                                  "off)",
    # the roofline cost model and the snapshot diff (obs/costmodel.py,
    # obs/regress.py)
    "CNMF_TPU_PERF_MODEL": "flag: factorize emits perf_model events under "
                           "the telemetry (default 0)",
    "CNMF_TPU_PERF_GATE_BAND": "relative band a bench metric must move past "
                               "before benchdiff calls it (default 0.6)",
}


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
