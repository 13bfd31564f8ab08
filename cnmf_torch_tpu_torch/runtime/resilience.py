"""Replicate quarantine, derived-seed retry and artifact validation.

Own copy of ``cnmf_torch_tpu/runtime/resilience.py``:

* :func:`lane_health` (from ``ops/nmf.py``) grades each replicate of a
  sweep from the outputs the solvers already return;
* :class:`ReplicateGuard` books unhealthy lanes for retry at
  :func:`derive_retry_seed` (``seed XOR attempt``, reproducible on resume
  without any state), quarantines a lane that exhausts
  ``CNMF_TPU_MAX_RETRIES``, writes the per-worker resilience ledger and
  enforces ``CNMF_TPU_MIN_HEALTHY_FRAC`` per K;
* :func:`load_spectra_checked` / :func:`probe_spectra_file` are the one
  definition of a trustworthy replicate artifact, shared by
  ``--skip-completed-runs`` resume and ``combine_nmf``.

The ledger's JSON has the JAX package's keys, so either package's combine
reads a ledger the other wrote. Given the run's event log, the guard
emits the JAX guard's ``fault`` events: ``nonfinite_replicate``,
``retry`` and ``quarantine``, with ``(k, iter, seed, attempt)`` (and a
retry's ``healthy``) in the context.
"""

from __future__ import annotations

import glob
import json
import os
import re
import warnings

import numpy as np

from ..ops.nmf import lane_health  # noqa: F401  (re-export)
from ..utils.envknobs import env_float, env_int
from ..utils.io import Frame, atomic_artifact

__all__ = ["MAX_RETRIES_ENV", "MIN_HEALTHY_FRAC_ENV", "max_retries",
           "min_healthy_frac", "derive_retry_seed", "lane_health",
           "TornArtifactError", "UnhealthySweepError", "UNHEALTHY_EXIT_CODE",
           "load_spectra_checked", "probe_spectra_file", "ReplicateGuard",
           "load_quarantined_tasks", "load_quarantine_records",
           "sweep_stale_ledgers"]

MAX_RETRIES_ENV = "CNMF_TPU_MAX_RETRIES"
MIN_HEALTHY_FRAC_ENV = "CNMF_TPU_MIN_HEALTHY_FRAC"

_DEFAULT_MAX_RETRIES = 2
_DEFAULT_MIN_HEALTHY_FRAC = 0.8


class TornArtifactError(RuntimeError):
    """A replicate artifact exists but cannot be trusted (unreadable,
    truncated, wrong shape or nonfinite)."""


class UnhealthySweepError(RuntimeError):
    """Too few healthy replicates survived for a K after retries."""


# the CLI's exit code for UnhealthySweepError: a rerun draws the same
# derived seeds and fails the same way, so a launcher must not respawn on
# it (1 is any uncaught exception, 2 argparse's usage error)
UNHEALTHY_EXIT_CODE = 3


def max_retries() -> int:
    """Retry budget per unhealthy replicate (``CNMF_TPU_MAX_RETRIES``,
    default 2; 0 quarantines at once)."""
    return env_int(MAX_RETRIES_ENV, _DEFAULT_MAX_RETRIES, lo=0)


def min_healthy_frac() -> float:
    """Per-K survival floor (``CNMF_TPU_MIN_HEALTHY_FRAC``, default 0.8),
    evaluated over this worker's share of the ledger."""
    return env_float(MIN_HEALTHY_FRAC_ENV, _DEFAULT_MIN_HEALTHY_FRAC,
                     lo=0.0, hi=1.0)


def derive_retry_seed(seed: int, attempt: int) -> int:
    """The seed of retry ``attempt >= 1``: ``seed XOR attempt`` in the
    ledger's 31-bit seed domain, derivable from the ledger seed alone."""
    if int(attempt) < 1:
        raise ValueError(f"retry attempts start at 1, got {attempt}")
    return (int(seed) ^ int(attempt)) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# artifact validation (resume and combine)
# ---------------------------------------------------------------------------

def load_spectra_checked(path, k: int | None = None,
                         n_genes: int | None = None) -> Frame:
    """Load a replicate's spectra ``.npz`` and check that it is complete:
    the archive opens, its three members parse, the matrix is 2-D with
    ``k`` rows (and ``n_genes`` columns when given), the labels match its
    shape and every value is finite. Raises :class:`TornArtifactError`
    otherwise."""
    try:
        with np.load(path, allow_pickle=True) as f:
            data = np.asarray(f["data"])
            index = np.asarray(f["index"])
            columns = np.asarray(f["columns"])
    except Exception as exc:
        raise TornArtifactError(
            f"{path}: unreadable replicate artifact "
            f"({type(exc).__name__}: {exc})")
    if data.ndim != 2:
        raise TornArtifactError(
            f"{path}: expected a 2-D spectra matrix, got ndim={data.ndim}")
    if k is not None and data.shape[0] != int(k):
        raise TornArtifactError(
            f"{path}: expected {int(k)} component rows, got {data.shape[0]}")
    if n_genes is not None and data.shape[1] != int(n_genes):
        raise TornArtifactError(
            f"{path}: expected {int(n_genes)} gene columns, "
            f"got {data.shape[1]}")
    if len(index) != data.shape[0] or len(columns) != data.shape[1]:
        raise TornArtifactError(
            f"{path}: label arrays ({len(index)}, {len(columns)}) do not "
            f"match the data shape {data.shape}")
    try:
        finite = bool(np.isfinite(data).all())
    except (TypeError, ValueError) as exc:
        raise TornArtifactError(f"{path}: non-numeric spectra data ({exc})")
    if not finite:
        raise TornArtifactError(f"{path}: nonfinite spectra values")
    return Frame(data, index, columns)


def probe_spectra_file(path, k: int | None = None,
                       n_genes: int | None = None) -> str | None:
    """``None`` when the artifact is present and valid, ``"missing"`` when
    absent, else the reason it fails validation."""
    if not os.path.exists(path):
        return "missing"
    try:
        load_spectra_checked(path, k=k, n_genes=n_genes)
        return None
    except TornArtifactError as exc:
        return str(exc)


# ---------------------------------------------------------------------------
# quarantine and retry bookkeeping
# ---------------------------------------------------------------------------

class ReplicateGuard:
    """Health bookkeeping of one factorize call: observe sweep results,
    queue retries, quarantine exhausted lanes, write the resilience ledger
    and enforce the healthy-fraction floor. Both factorize lanes (batched
    and sequential) report through :meth:`observe`, and the retry waves
    re-solve through the caller's ``rerun``."""

    def __init__(self, events=None, ledger_path: str | None = None,
                 max_retries_: int | None = None,
                 min_healthy_frac_: float | None = None):
        self.events = events
        self.ledger_path = ledger_path
        self.max_retries = (max_retries() if max_retries_ is None
                            else int(max_retries_))
        self.min_healthy_frac = (min_healthy_frac()
                                 if min_healthy_frac_ is None
                                 else float(min_healthy_frac_))
        self._totals: dict[int, int] = {}
        self._healthy: dict[int, int] = {}
        self._pending: list[dict] = []
        self.retries: list[dict] = []
        self.quarantined: list[dict] = []

    def _emit(self, kind: str, context: dict):
        if self.events is not None:
            self.events.emit("fault", kind=kind, context=context)

    def observe(self, k: int, iters, seeds, health, attempt: int = 0,
                derived_seeds=None) -> np.ndarray:
        """Record one sweep's (or retry wave's) per-lane health and return
        the healthy mask (callers write healthy lanes only). An unhealthy
        lane queues a retry at ``attempt + 1`` while the budget lasts, else
        it is quarantined. ``seeds`` are the original ledger seeds."""
        k = int(k)
        health = np.asarray(health, dtype=bool).reshape(-1)
        if len(health) != len(list(iters)):
            raise ValueError(
                f"health mask has {len(health)} lanes for {len(list(iters))}"
                " tasks")
        if attempt == 0:
            self._totals[k] = self._totals.get(k, 0) + len(health)
        for j, ok in enumerate(health):
            it, seed = int(iters[j]), int(seeds[j])
            if attempt > 0:
                rec = {"k": k, "iter": it, "seed": seed,
                       "attempt": int(attempt),
                       "derived_seed": int(derived_seeds[j]),
                       "healthy": bool(ok)}
                self.retries.append(rec)
                self._emit("retry", rec)
            if ok:
                self._healthy[k] = self._healthy.get(k, 0) + 1
                continue
            ctx = {"k": k, "iter": it, "seed": seed, "attempt": int(attempt)}
            self._emit("nonfinite_replicate", ctx)
            if attempt < self.max_retries:
                self._pending.append({"k": k, "iter": it, "seed": seed,
                                      "attempt": int(attempt) + 1})
            else:
                rec = dict(ctx, attempts=int(attempt))
                self.quarantined.append(rec)
                self._emit("quarantine", rec)
                warnings.warn(
                    "replicate k=%d iter=%d (seed %d) quarantined after "
                    "%d attempt(s): solver output nonfinite. It is excluded "
                    "from combine; raise %s to retry more."
                    % (k, it, seed, int(attempt) + 1, MAX_RETRIES_ENV),
                    RuntimeWarning, stacklevel=2)
        return health

    def take_pending(self) -> list[dict]:
        """Pop the queued retry tasks (one wave, one attempt number)."""
        pending, self._pending = self._pending, []
        return pending

    def credit_existing(self, k: int, n: int):
        """Count ``n`` replicates of K already valid on disk and skipped by
        a resume as healthy, so the floor sees the whole K."""
        k = int(k)
        self._totals[k] = self._totals.get(k, 0) + int(n)
        self._healthy[k] = self._healthy.get(k, 0) + int(n)

    def carry_quarantined(self, k: int, it: int, seed: int,
                          attempts: int | None = None):
        """Re-record a previous run's unresolved quarantine during a resume
        that does not rerun the lane: it counts toward the K's total (not
        healthy) and rides into this run's ledger, keeping combine's
        exclusion; ``attempts`` keeps the exhausted budget."""
        k = int(k)
        self._totals[k] = self._totals.get(k, 0) + 1
        rec = {"k": k, "iter": int(it), "seed": int(seed), "carried": True}
        if attempts is not None:
            rec["attempts"] = int(attempts)
        self.quarantined.append(rec)

    def finalize(self):
        """Write the resilience ledger when anything happened (a clean
        pass removes this worker's old ledger) and enforce the per-K
        floor: raises :class:`UnhealthySweepError` when a K ends below
        ``min_healthy_frac``."""
        if self._pending:
            # a caller that skipped the retry waves must not drop lanes
            for t in self.take_pending():
                rec = {"k": t["k"], "iter": t["iter"], "seed": t["seed"],
                       "attempts": t["attempt"] - 1}
                self.quarantined.append(rec)
        if self.ledger_path:
            if self.retries or self.quarantined:
                payload = {"schema": 1,
                           "max_retries": self.max_retries,
                           "min_healthy_frac": self.min_healthy_frac,
                           "retries": self.retries,
                           "quarantined": self.quarantined}
                with atomic_artifact(self.ledger_path) as tmp:
                    with open(tmp, "w") as f:
                        json.dump(payload, f, indent=1)
            elif os.path.exists(self.ledger_path):
                os.unlink(self.ledger_path)
        bad = []
        for k, total in sorted(self._totals.items()):
            frac = self._healthy.get(k, 0) / max(total, 1)
            if frac < self.min_healthy_frac:
                bad.append((k, frac, total))
        if bad:
            detail = "; ".join(
                "k=%d: %.0f%% of %d replicates healthy" % (k, 100 * f, t)
                for k, f, t in bad)
            raise UnhealthySweepError(
                "factorize: too few healthy replicates after %d retry "
                "attempt(s) — %s (floor %s=%.2f, evaluated over this "
                "worker's ledger shard). Consensus over so few survivors "
                "would be unreliable; inspect the solver inputs "
                "(nonfinite counts? pathological scaling?), or lower the "
                "floor explicitly to accept the degraded sweep."
                % (self.max_retries, detail, MIN_HEALTHY_FRAC_ENV,
                   self.min_healthy_frac))


def load_quarantine_records(
        ledger_path_template: str) -> dict[tuple[int, int], int | None]:
    """Quarantined ``(k, iter) -> exhausted attempts`` across every
    worker's resilience ledger (``None`` where a record has no count; a
    known count beats an unknown one, a larger a smaller)."""
    out: dict[tuple[int, int], int | None] = {}
    for path in glob.glob(str(ledger_path_template).replace("%d", "*")):
        try:
            with open(path) as f:
                payload = json.load(f)
            for rec in payload.get("quarantined", []):
                key = (int(rec["k"]), int(rec["iter"]))
                att = rec.get("attempts")
                att = None if att is None else int(att)
                if key not in out:
                    out[key] = att
                elif att is not None and (out[key] is None
                                          or att > out[key]):
                    out[key] = att
        except (OSError, ValueError, KeyError, TypeError):
            warnings.warn(
                f"unreadable resilience ledger {path}; its quarantine "
                "records are ignored", RuntimeWarning, stacklevel=2)
    return out


def load_quarantined_tasks(ledger_path_template: str) -> set[tuple[int, int]]:
    """The quarantined ``(k, iter)`` pairs of every worker's ledger:
    combine skips them without a flag."""
    return set(load_quarantine_records(ledger_path_template))


def sweep_stale_ledgers(ledger_path_template: str, total_workers: int):
    """Delete the resilience ledgers of worker indices outside the current
    fleet (left by an earlier run with more workers). Worker 0 calls it at
    the start of a fresh factorize, which voids old quarantine records."""
    pattern = str(ledger_path_template).replace("%d", "*")
    rx = re.compile(re.escape(str(ledger_path_template)).replace(
        re.escape("%d"), r"(\d+)") + "$")
    for path in glob.glob(pattern):
        m = rx.match(path)
        if m and int(m.group(1)) >= int(total_workers):
            try:
                os.unlink(path)
            except OSError:
                pass
