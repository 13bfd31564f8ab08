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
# runtime/faults.py, the retry policy of runtime/resilience.py and the
# telemetry base's knobs, with the JAX package's types and defaults)
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
