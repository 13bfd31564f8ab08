"""The port's observability plane (``cnmf_torch_tpu_torch/obs``) against the
JAX package's (``cnmf_torch_tpu/obs``): the same calls give the same
metrics exposition text and snapshots, the same sampling answers, the same
header round trips and span waterfalls, and the same SLO verdicts."""

import json

import pytest

from cnmf_torch_tpu.obs import metrics as jmetrics
from cnmf_torch_tpu.obs import slo as jslo
from cnmf_torch_tpu.obs import tracing as jtracing
from cnmf_torch_tpu.utils import telemetry as jtel
from cnmf_torch_tpu_torch.obs import metrics as tmetrics
from cnmf_torch_tpu_torch.obs import slo as tslo
from cnmf_torch_tpu_torch.obs import tracing as ttracing
from cnmf_torch_tpu_torch.utils import telemetry as ttel

PACKAGES = {"jax": (jmetrics, jtracing, jslo, jtel),
            "port": (tmetrics, ttracing, tslo, ttel)}


def _drive(reg):
    """One fixed sequence of instrument calls, labels and values chosen to
    reach every formatting branch (integral and fractional values, label
    escapes, every histogram bucket and the overflow)."""
    reg.inc("cnmf_requests_total")
    reg.inc("cnmf_requests_total", 2.0, tenant="a")
    reg.inc("cnmf_requests_total", 0.5, tenant='b"q\\n')
    reg.set("cnmf_queue_depth", 7)
    reg.set("cnmf_queue_depth", 3.25, lane="x")
    for v in (0.5, 1.0, 1.5, 3.0, 9.0, 19.0, 45.0, 99.0, 150.0, 400.0,
              800.0, 1500.0, 4000.0, 9000.0, 2.0):
        reg.observe("cnmf_latency_ms", v, route="/project")
    reg.observe("cnmf_latency_ms", 12.5)
    return reg


@pytest.mark.parametrize("view", ["render_text", "snapshot", "parsed"])
def test_metrics_registry_same_text_and_snapshot(view):
    got = {}
    for name, (metrics, _, _, _) in PACKAGES.items():
        reg = _drive(metrics.MetricsRegistry())
        if view == "render_text":
            got[name] = reg.render_text()
        elif view == "snapshot":
            got[name] = json.dumps(reg.snapshot(), sort_keys=True)
        else:
            parsed = metrics.parse_exposition(reg.render_text())
            got[name] = (sorted(parsed["samples"].items()),
                         sorted(parsed["types"].items()))
    assert got["port"] == got["jax"]


def test_metrics_registry_refuses_mixed_kinds_in_both():
    for metrics, _, _, _ in PACKAGES.values():
        reg = metrics.MetricsRegistry()
        reg.inc("m")
        with pytest.raises(ValueError, match="already registered"):
            reg.set("m", 1.0)
        with pytest.raises(ValueError, match="must be >= 0"):
            reg.inc("m", -1.0)


@pytest.mark.parametrize("enabled", [False, True])
def test_default_registry_gating(monkeypatch, enabled):
    if enabled:
        monkeypatch.setenv("CNMF_TPU_METRICS", "1")
    else:
        monkeypatch.delenv("CNMF_TPU_METRICS", raising=False)
    texts = {}
    for name, (metrics, _, _, _) in PACKAGES.items():
        metrics.reset_default_registry()
        metrics.counter_inc("cnmf_factorize_workers_total")
        metrics.gauge_set("cnmf_g", 2.5, k="9")
        metrics.observe("cnmf_h", 3.0)
        texts[name] = metrics.render_text()
        metrics.reset_default_registry()
    assert texts["port"] == texts["jax"]
    assert ("cnmf_factorize_workers_total 1" in texts["port"]) == enabled


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.25, 0.5, 0.9, 1.0])
def test_is_sampled_same_answer(rate):
    ids = ["%016x" % (0x9E3779B97F4A7C15 * i % (1 << 64))
           for i in range(200)]
    got = {name: [tracing.is_sampled(t, rate) for t in ids]
           for name, (_, tracing, _, _) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    if 0.0 < rate < 1.0:
        assert 0 < sum(got["port"]) < len(ids)


@pytest.mark.parametrize("value", ["abc:1.2", "", None, "nocolon",
                                   "a:b:c", ":x", "x:"])
def test_header_round_trip(value):
    parsed = {}
    for name, (_, tracing, _, _) in PACKAGES.items():
        ctx = tracing.from_header(value)
        parsed[name] = None if ctx is None else (
            ctx.trace_id, ctx.span_id, ctx.parent_id,
            tracing.header_value(ctx))
    assert parsed["port"] == parsed["jax"]
    if value == "abc:1.2":
        assert parsed["port"] == ("abc", "1.2", None, "abc:1.2")


def test_trace_context_from_env_and_children(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TRACE_CTX", "feedbeef:7.1")
    for _, tracing, _, _ in PACKAGES.values():
        tracing.reset_process_context()
        ctx = tracing.process_context()
        assert (ctx.trace_id, ctx.span_id) == ("feedbeef", "7.1")
        kid = tracing.child(ctx)
        assert (kid.trace_id, kid.parent_id) == ("feedbeef", "7.1")
        assert tracing.child(None) is None
        tracing.reset_process_context()
    monkeypatch.setenv("CNMF_TPU_TRACE_SAMPLE", "0")
    assert ttracing.new_trace() is None and jtracing.new_trace() is None


def _spans():
    """Two traces of nested spans with fixed times."""
    t0 = 1_700_000_000.0
    return [
        ("aaaa", "1.1", None, "client.request", t0, 40.0, {"tenant": "a"}),
        ("aaaa", "1.2", "1.1", "daemon.admit", t0 + 0.002, 5.0, {}),
        ("aaaa", "1.3", "1.2", "batcher.dispatch", t0 + 0.008, 20.0,
         {"lanes": 3}),
        ("bbbb", "2.1", None, "factorize.worker", t0 + 5.0, 1500.0,
         {"worker": 0}),
        ("bbbb", "2.2", "2.1", "store.get", t0 + 5.1, 12.5, {}),
    ]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_span_waterfalls_render_the_same(tmp_path, monkeypatch, writer):
    """Spans emitted through one package's event log render identically
    in both packages' ``trace`` renderer."""
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    _, tracing, _, tel = PACKAGES[writer]
    run = tmp_path / "run"
    log = tel.EventLog(str(run / "cnmf_tmp" / "run.events.jsonl"))
    for trace_id, span_id, parent, name, start, wall, ctx in _spans():
        tracing.emit_span(log, tracing.TraceContext(trace_id, span_id,
                                                    parent),
                          name, start, wall, **ctx)
    assert jtel.validate_events_file(
        str(run / "cnmf_tmp" / "run.events.jsonl")) == 6
    texts = {name: tr.render_run_traces(str(run))
             for name, (_, tr, _, _) in PACKAGES.items()}
    assert texts["port"] == texts["jax"]
    assert "2 trace(s)" in texts["port"]
    assert "batcher.dispatch" in texts["port"]
    limited = {name: tr.render_run_traces(str(run), limit=1)
               for name, (_, tr, _, _) in PACKAGES.items()}
    assert limited["port"] == limited["jax"]


def test_span_context_manager_emits_one_event(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    log = ttel.EventLog(str(tmp_path / "e.jsonl"))
    ctx = ttracing.TraceContext("cccc", "3.1")
    with ttracing.span(log, ctx, "stage.x", k=9) as got:
        assert got is ctx
    with ttracing.span(log, None, "untraced"):
        pass
    events = ttel.read_events(str(tmp_path / "e.jsonl"))
    assert [e["t"] for e in events] == ["manifest", "span"]
    assert events[1]["name"] == "stage.x"
    assert events[1]["context"] == {"k": 9}
    jtel.validate_events_file(str(tmp_path / "e.jsonl"))


def _slo_script(slo):
    clock = [0.0]
    tr = slo.SloTracker(50.0, window_s=10.0, clock=lambda: clock[0])
    verdicts = [tr.evaluate()]
    for i in range(40):
        clock[0] = i * 0.5
        tr.record(5.0 + (i % 7) * 9.0, ok=(i % 13 != 5))
        verdicts.append(tr.evaluate())
    # the window's left edge: an observation exactly window_s old is out
    verdicts.append(tr.evaluate(now=19.5 + 9.999))
    verdicts.append(tr.evaluate(now=19.5 + 10.0))
    return verdicts


def test_slo_window_math_agrees():
    assert _slo_script(tslo) == _slo_script(jslo)
    last = _slo_script(tslo)
    assert last[-2]["requests"] == 1 and last[-1]["requests"] == 0


@pytest.mark.parametrize("env", [{}, {"CNMF_TPU_SLO_P99_MS": "25"},
                                 {"CNMF_TPU_SLO_P99_MS": "25",
                                  "CNMF_TPU_SLO_WINDOW_S": "60"}])
def test_slo_tracker_from_env_agrees(monkeypatch, env):
    monkeypatch.delenv("CNMF_TPU_SLO_P99_MS", raising=False)
    monkeypatch.delenv("CNMF_TPU_SLO_WINDOW_S", raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    got = {}
    for name, (_, _, slo, _) in PACKAGES.items():
        tr = slo.tracker_from_env()
        got[name] = None if tr is None else (tr.target_p99_ms, tr.window_s,
                                             tr.max_error_rate)
    assert got["port"] == got["jax"]


def test_metrics_snapshot_needs_telemetry_and_metrics(tmp_path, monkeypatch):
    path = str(tmp_path / "e.jsonl")
    log = ttel.EventLog(path)
    reg = _drive(tmetrics.MetricsRegistry())
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.delenv("CNMF_TPU_METRICS", raising=False)
    assert not tmetrics.emit_snapshot(log, registry=reg)
    monkeypatch.setenv("CNMF_TPU_METRICS", "1")
    assert tmetrics.emit_snapshot(log, registry=reg,
                                  slo=tslo.SloTracker(10.0).evaluate())
    assert jtel.validate_events_file(path) == 2
    (snap,) = [e for e in ttel.read_events(path)
               if e["t"] == "metrics_snapshot"]
    assert snap["metrics"] == json.loads(json.dumps(reg.snapshot()))
    summary = {name: tel.summarize_events(ttel.read_events(path))
               for name, (_, _, _, tel) in PACKAGES.items()}
    assert summary["port"] == summary["jax"]
    assert summary["port"]["slo"]["requests"] == 0
