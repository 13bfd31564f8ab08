"""Sliding-window SLO tracking for the serving tier.

Own copy of ``cnmf_torch_tpu/obs/slo.py``, the same code and text; its
consumer, the serve daemon, comes to the port with the serving layer.

The tracker answers ONE question, live: over the last
``CNMF_TPU_SLO_WINDOW_S`` seconds, did the daemon hold its latency and
error targets? ``CNMF_TPU_SLO_P99_MS`` arms it (unset/0 = off); each
completed request records (timestamp, total latency, ok-or-not); and
:meth:`SloTracker.evaluate` reduces the window to a verdict the daemon
surfaces in ``/metrics``, ``/healthz`` (degraded-when-burning), and the
report's SLO section — the probe a fleet chaos smoke asserts against.

Window semantics (pinned by test): an observation recorded at time
``t`` belongs to the window evaluated at ``now`` iff
``t > now - window_s`` — strictly newer than the left edge, so an
observation exactly ``window_s`` old has just aged out. p99 uses the
same linear-interpolated :func:`~cnmf_torch_tpu_torch.utils.profiling.
percentile` as the report, not a third variant.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.envknobs import env_float
from ..utils.profiling import percentile

__all__ = ["SLO_P99_ENV", "SLO_WINDOW_ENV", "SloTracker",
           "tracker_from_env"]

SLO_P99_ENV = "CNMF_TPU_SLO_P99_MS"
SLO_WINDOW_ENV = "CNMF_TPU_SLO_WINDOW_S"

# error budget: the fraction of windowed requests allowed to end
# not-ok (shed/poison/error) before the SLO burns. A constructor
# parameter rather than a knob — the two registered knobs cover the
# latency target and window; revisit if fleets need to tune this.
DEFAULT_MAX_ERROR_RATE = 0.01


class SloTracker:
    """Thread-safe sliding-window SLO evaluator."""

    def __init__(self, target_p99_ms: float, window_s: float = 300.0,
                 max_error_rate: float = DEFAULT_MAX_ERROR_RATE,
                 clock=time.monotonic):
        if not target_p99_ms > 0:
            raise ValueError("target_p99_ms must be > 0, got %r"
                             % (target_p99_ms,))
        if not window_s > 0:
            raise ValueError("window_s must be > 0, got %r" % (window_s,))
        self.target_p99_ms = float(target_p99_ms)
        self.window_s = float(window_s)
        self.max_error_rate = float(max_error_rate)
        self._clock = clock
        self._lock = threading.Lock()
        self._obs: deque = deque()  # (t, latency_ms, ok)

    def _evict(self, now: float) -> None:
        edge = now - self.window_s
        while self._obs and self._obs[0][0] <= edge:
            self._obs.popleft()

    def record(self, latency_ms: float, ok: bool = True,
               now=None) -> None:
        t = self._clock() if now is None else float(now)
        with self._lock:
            self._obs.append((t, float(latency_ms), bool(ok)))
            self._evict(t)

    def evaluate(self, now=None) -> dict:
        """The windowed verdict: request/error counts, measured p99,
        and ``burning`` (latency target missed OR error budget blown).
        An empty window is trivially not burning — no evidence, no
        alarm."""
        t = self._clock() if now is None else float(now)
        with self._lock:
            self._evict(t)
            obs = list(self._obs)
        n = len(obs)
        errors = sum(1 for _, _, ok in obs if not ok)
        out = {
            "target_p99_ms": self.target_p99_ms,
            "window_s": self.window_s,
            "max_error_rate": self.max_error_rate,
            "requests": n,
            "errors": errors,
        }
        if n == 0:
            out.update(p99_ms=None, error_rate=0.0, burning=False,
                       ok=True)
            return out
        p99 = percentile([lat for _, lat, _ in obs], 99.0)
        error_rate = errors / n
        burning = (p99 > self.target_p99_ms
                   or error_rate > self.max_error_rate)
        out.update(p99_ms=round(p99, 3),
                   error_rate=round(error_rate, 6),
                   burning=burning, ok=not burning)
        return out


def tracker_from_env():
    """Build the tracker the knobs describe, or ``None`` when
    ``CNMF_TPU_SLO_P99_MS`` is unset/0 (SLO tracking off)."""
    target = env_float(SLO_P99_ENV, 0.0, lo=0.0)
    if target <= 0:
        return None
    window = env_float(SLO_WINDOW_ENV, 300.0, lo=1.0)
    return SloTracker(target, window_s=window)
