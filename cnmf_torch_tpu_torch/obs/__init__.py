"""Observability plane: own copies of ``cnmf_torch_tpu/obs/metrics.py``,
``tracing.py`` and ``slo.py`` (pure host code, the same names, exposition
text and sampling hash).

* :mod:`~cnmf_torch_tpu_torch.obs.metrics` — a process-local metrics
  registry (counters, gauges, fixed-log-bucket histograms) with a text
  exposition format, and ``metrics_snapshot`` telemetry events.
* :mod:`~cnmf_torch_tpu_torch.obs.tracing` — sampled traces: a trace/span
  context, each span a ``span`` event; the ``trace`` command renders the
  waterfalls.
* :mod:`~cnmf_torch_tpu_torch.obs.slo` — the sliding-window SLO tracker.

Off by default: with the knobs unset no instrument records and no span
emits. The cost model and the regression observatory come with the
port's benchmark.
"""

from . import metrics, slo, tracing  # noqa: F401

__all__ = ["metrics", "tracing", "slo"]
