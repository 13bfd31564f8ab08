"""Observability plane: own copies of ``cnmf_torch_tpu/obs/metrics.py``,
``tracing.py``, ``slo.py``, ``costmodel.py`` and ``regress.py`` (pure
host code, the same names, exposition text, sampling hash, cost formulas
and snapshot schema).

* :mod:`~cnmf_torch_tpu_torch.obs.metrics` — a process-local metrics
  registry (counters, gauges, fixed-log-bucket histograms) with a text
  exposition format, and ``metrics_snapshot`` telemetry events.
* :mod:`~cnmf_torch_tpu_torch.obs.tracing` — sampled traces: a trace/span
  context, each span a ``span`` event; the ``trace`` command renders the
  waterfalls.
* :mod:`~cnmf_torch_tpu_torch.obs.slo` — the sliding-window SLO tracker.
* :mod:`~cnmf_torch_tpu_torch.obs.costmodel` — the roofline cost model
  behind factorize's ``perf_model`` events (``CNMF_TPU_PERF_MODEL``).
* :mod:`~cnmf_torch_tpu_torch.obs.regress` — bench snapshots and the
  noise-aware diff of the ``benchdiff`` command.

Off by default: with the knobs unset no instrument records and no span or
``perf_model`` event emits.
"""

from . import costmodel, metrics, regress, slo, tracing  # noqa: F401

__all__ = ["metrics", "tracing", "slo", "costmodel", "regress"]
