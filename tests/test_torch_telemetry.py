"""The port's telemetry base (``utils/telemetry.py``, ``utils/profiling.py``
and the pipeline's events) against the JAX package's, on the CPU.

* the schema, the validator and the report are the JAX module's: the same
  tables, the same verdicts on the same events, and the same report text
  and summary on an events file written by either package;
* the port's pipeline writes an events file the JAX validator accepts and
  that meets the JAX pipeline test's expectations
  (``tests/test_telemetry.py::test_pipeline_emits_schema_valid_events``),
  ``jax_version`` aside;
* a sweep's replicate records agree with the JAX solvers' from the same
  ``(X, H0, W0)``, the fixed 64-slot trace and its last-slot overwrite
  included;
* the fault events of a ``CNMF_TPU_FAULT_SPEC`` run are the JAX package's;
* telemetry changes nothing the run computes, and off writes no events.
"""

import json
import os
import threading
import warnings

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu import cNMF as JaxCNMF
from cnmf_torch_tpu import save_df_to_npz as jax_save_df
from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.ops import sparse as jsp
from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu.utils import profiling as jprof
from cnmf_torch_tpu.utils import telemetry as jtel
from cnmf_torch_tpu_torch import Frame, cNMF, convert, save_df_to_npz
from cnmf_torch_tpu_torch.cli import main as port_cli
from cnmf_torch_tpu_torch.obs.tracing import render_run_traces
from cnmf_torch_tpu_torch.ops import sparse as tsp
from cnmf_torch_tpu_torch.parallel import replicate_sweep
from cnmf_torch_tpu_torch.parallel import replicates as trep
from cnmf_torch_tpu_torch.utils import profiling as tprof
from cnmf_torch_tpu_torch.utils import telemetry as ttel

TELEMETRY_ON = {"CNMF_TPU_TELEMETRY": "1", "CNMF_TPU_METRICS": "1",
                "CNMF_TPU_TRACE_SAMPLE": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each would oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


# ---------------------------------------------------------------------------
# schema and validation
# ---------------------------------------------------------------------------

def test_schema_is_the_jax_modules():
    assert ttel.EVENT_TYPES == jtel.EVENT_TYPES
    assert ttel.REPLICATE_RECORD_FIELDS == jtel.REPLICATE_RECORD_FIELDS
    assert ttel.SCHEMA_VERSION == jtel.SCHEMA_VERSION
    assert ttel.TELEMETRY_ENV == jtel.TELEMETRY_ENV


_MANIFEST = {"v": 1, "t": "manifest", "ts": 1.0, "package_version": "x",
             "jax_version": "unavailable", "backend": "cpu", "devices": [],
             "env": {}}
VALIDATION_TABLE = [
    _MANIFEST,
    dict(_MANIFEST, devices=None),
    {"v": 1, "t": "stage", "ts": 1.0, "stage": "x", "wall_s": 0.1},
    {"t": "stage", "ts": 1.0},
    {"v": 1, "t": "nope", "ts": 1.0},
    {"v": 1, "t": "stage", "ts": 1.0},
    {"v": 99, "t": "stage", "ts": 1.0, "stage": "x", "wall_s": 0.1},
    {"v": 1, "t": "stage", "ts": "late", "stage": "x", "wall_s": 0.1},
    {"v": 1, "t": "replicates", "ts": 1.0, "k": 3, "beta": 1.0,
     "records": [{"seed": 1}]},
    {"v": 1, "t": "replicates", "ts": 1.0, "k": 3, "beta": 1.0,
     "records": "none"},
    {"v": 1, "t": "replicates", "ts": 1.0, "k": 3, "beta": 1.0,
     "records": [{"seed": 1, "err": 2.0, "iters": 3, "capped": False,
                  "nonfinite": False}]},
    {"v": 1, "t": "memory", "ts": 1.0, "stage": "x", "devices": {}},
    {"v": 1, "t": "fault", "ts": 1.0, "kind": "retry", "context": {}},
    {"v": 1, "t": "span", "ts": 1.0, "trace": "a", "span": "b",
     "name": "n", "start_ts": "0", "wall_ms": 1.0},
    {"v": 1, "t": "span", "ts": 1.0, "trace": "a", "span": "b",
     "name": "n", "start_ts": 0.0, "wall_ms": 1.0},
    {"v": 1, "t": "metrics_snapshot", "ts": 1.0, "metrics": []},
    {"v": 1, "t": "perf_model", "ts": 1.0, "stage": "s", "lane": "l",
     "predicted": {"flops": 1, "bytes": 2}, "measured": {"wall_s": 0.1},
     "roofline": {"bound": "memory"}},
    {"v": 1, "t": "perf_model", "ts": 1.0, "stage": "s", "lane": "l",
     "predicted": {"flops": "1", "bytes": 2},
     "measured": {"wall_s": 0.1}, "roofline": {"bound": "memory"}},
    "not an event",
]


def _verdict(tel, ev):
    try:
        tel.validate_event(ev)
    except ValueError as exc:
        return str(exc)
    return "ok"


@pytest.mark.parametrize("i", range(len(VALIDATION_TABLE)))
def test_validate_event_same_verdicts(i):
    ev = VALIDATION_TABLE[i]
    assert _verdict(ttel, ev) == _verdict(jtel, ev)


@pytest.mark.parametrize("lines", [
    [_MANIFEST, {"v": 1, "t": "stage", "ts": 1.0, "stage": "x",
                 "wall_s": 0.1}],
    [{"v": 1, "t": "stage", "ts": 1.0, "stage": "x", "wall_s": 0.1}],
    [_MANIFEST, "{not json"],
])
def test_validate_events_file_same_verdicts(tmp_path, lines):
    path = tmp_path / "e.jsonl"
    path.write_text("\n".join(ln if isinstance(ln, str) else json.dumps(ln)
                              for ln in lines) + "\n\n")
    got = {}
    for name, tel in (("port", ttel), ("jax", jtel)):
        try:
            got[name] = tel.validate_events_file(str(path))
        except ValueError as exc:
            got[name] = str(exc).split(": ", 1)[-1][:40]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("raw", [None, "", "0", "off", "False", "1", "yes"])
def test_telemetry_knob_reads_as_in_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("CNMF_TPU_TELEMETRY", raising=False)
    else:
        monkeypatch.setenv("CNMF_TPU_TELEMETRY", raw)
    assert ttel.telemetry_enabled() == jtel.telemetry_enabled()


def test_event_log_behaviour(tmp_path, monkeypatch):
    """Nothing on disk until the first enabled emit; the manifest first;
    None fields dropped; NaN and inf as strings; one line per event."""
    path = tmp_path / "sub" / "run.events.jsonl"
    log = ttel.EventLog(str(path), manifest_extra={"run_name": "r"},
                        device="cpu")
    monkeypatch.delenv("CNMF_TPU_TELEMETRY", raising=False)
    log.emit("stage", stage="x", wall_s=1.0)
    assert not path.exists()
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    log.set_manifest_extra(ledger={"ks": [3]})
    log.emit("stage", stage="x", wall_s=float("nan"), nbytes=None,
             meta={"a": np.float32(np.inf), "b": np.arange(2)})
    log.emit_memory("x")
    events = ttel.read_events(str(path))
    assert [e["t"] for e in events] == ["manifest", "stage", "memory"]
    man, stage, mem = events
    assert man["run_name"] == "r" and man["ledger"] == {"ks": [3]}
    assert man["jax_version"] == "unavailable"
    assert man["torch_version"] == torch.__version__
    assert man["backend"] == "cpu" and man["devices"][0]["platform"] == "cpu"
    assert man["env"]["CNMF_TPU_TELEMETRY"] == "1"
    assert all(key.startswith("CNMF_") for key in man["env"])
    assert stage["wall_s"] == "nan" and "nbytes" not in stage
    assert stage["meta"] == {"a": "inf", "b": [0, 1]}
    assert mem["devices"] == [dict(man["devices"][0], live_buffer_bytes=0)]
    assert jtel.validate_events_file(str(path)) == 3
    assert not torch.cuda.is_initialized()


def test_event_log_write_failure_warns_once(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    blocker = tmp_path / "file"
    blocker.write_text("x")
    log = ttel.EventLog(str(blocker / "run.events.jsonl"), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            log.emit("stage", stage="x", wall_s=0.1)
    assert [str(w.message).startswith("telemetry: failed to append")
            for w in caught] == [True]


def test_event_log_lines_do_not_tear_across_threads(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    path = str(tmp_path / "e.jsonl")
    logs = [ttel.EventLog(path, device="cpu") for _ in range(4)]

    def writer(log, i):
        for j in range(25):
            log.emit("stage", stage=f"w{i}.{j}", wall_s=0.0,
                     meta={"pad": "x" * 3000})

    threads = [threading.Thread(target=writer, args=(log, i))
               for i, log in enumerate(logs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = ttel.read_events(path)
    assert len(events) == 4 + 100
    for ev in events:
        ttel.validate_event(ev)


# ---------------------------------------------------------------------------
# profiling: StageTimer, percentiles, trace()
# ---------------------------------------------------------------------------

def _timer_rows(prof, path):
    timer = prof.StageTimer(str(path))
    timer.record("prepare", 0.5, nbytes=2_000_000, k=9, note="a\tb\nc")
    timer.record("factorize", 1.25)
    with pytest.raises(KeyError):
        with timer.stage("combine"):
            raise KeyError("x")
    with open(path) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    # the wall of the timed stage and every row's timestamp differ
    for row in rows[1:]:
        row[4] = "-"
    rows[3][1] = "-"
    return rows


def test_stage_timer_writes_the_jax_tsv(tmp_path):
    assert (_timer_rows(tprof, tmp_path / "t.tsv")
            == _timer_rows(jprof, tmp_path / "j.tsv"))


def test_stage_timer_mirrors_stage_events(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    log = ttel.EventLog(str(tmp_path / "e.jsonl"), device="cpu")
    timer = tprof.StageTimer(str(tmp_path / "t.tsv"), events=log)
    timer.record("stage_a", 0.25, nbytes=10, k=3)
    (ev,) = [e for e in ttel.read_events(str(tmp_path / "e.jsonl"))
             if e["t"] == "stage"]
    assert (ev["stage"], ev["wall_s"], ev["nbytes"], ev["meta"]) == (
        "stage_a", 0.25, 10, {"k": 3})


@pytest.mark.parametrize("values", [[3.0], [1.0, 2.0], [5.0, 0.5, 70.0,
                                                        1200.0, 9000.0, 2.0],
                                    list(np.linspace(0.1, 6000.0, 101))])
def test_latency_summary_matches_jax(values):
    assert tprof.latency_summary(values) == jprof.latency_summary(values)
    for q in (0, 50, 95, 99, 100):
        assert tprof.percentile(values, q) == jprof.percentile(values, q)
    assert tprof.HIST_EDGES == jprof.HIST_EDGES


def test_trace_writes_one_chrome_trace_per_stage(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    a = torch.ones(8, 8)
    with tprof.trace("outer"):
        a = a @ a
        with tprof.trace("inner"):      # nested: captured by the outer
            a = a @ a
    files = os.listdir(tmp_path / "prof" / "outer")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert not (tmp_path / "prof" / "inner").exists()
    with open(tmp_path / "prof" / "outer" / files[0]) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    monkeypatch.delenv("CNMF_TPU_PROFILE_DIR")
    with tprof.trace("off"):
        pass
    assert not (tmp_path / "prof" / "off").exists()


# ---------------------------------------------------------------------------
# the pipeline's events
# ---------------------------------------------------------------------------

def _mini_counts(n=120, g=90, seed=3):
    """The JAX telemetry test's low-rank Poisson counts at the port suite's
    size."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(5) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(5, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * 300.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return (counts, np.asarray([f"c{i}" for i in range(n)]),
            np.asarray([f"g{j}" for j in range(g)]))


def _port_pipeline(root, name, env):
    counts, rows, cols = _mini_counts()
    fn = os.path.join(root, "counts.df.npz")
    save_df_to_npz(Frame(counts, rows, cols), fn)
    with pytest.MonkeyPatch.context() as mp:
        for key in TELEMETRY_ON:
            mp.delenv(key, raising=False)
        # the ELL lane of the main path, at this small size
        mp.setenv("CNMF_TPU_SPARSE_BETA", "1")
        for key, val in env.items():
            mp.setenv(key, val)
        obj = cNMF(root, name, device="cpu")
        obj.prepare(fn, components=[3, 4], n_iter=4, seed=7,
                    num_highvar_genes=60, beta_loss="kullback-leibler",
                    batch_size=64, max_NMF_iter=60)
        obj.factorize()
        obj.combine()
        obj.consensus(3, density_threshold=2.0)
        obj.k_selection_plot()
    return obj


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The same pipeline with every telemetry knob on and with them off."""
    on = _port_pipeline(str(tmp_path_factory.mktemp("on")), "ev",
                        TELEMETRY_ON)
    off = _port_pipeline(str(tmp_path_factory.mktemp("off")), "ev", {})
    return on, off


def _events_path(obj):
    return os.path.join(obj.output_dir, obj.name, "cnmf_tmp",
                        obj.name + ".events.jsonl")


def test_pipeline_events_pass_the_jax_validator(port_runs):
    """Every expectation of the JAX pipeline test, ``jax_version`` (which
    the port spells "unavailable") aside."""
    obj, _ = port_runs
    path = _events_path(obj)
    n = jtel.validate_events_file(path)
    assert ttel.validate_events_file(path) == n
    events = jtel.read_events(path)
    assert n == len(events)
    by_type = {}
    for e in events:
        by_type.setdefault(e["t"], []).append(e)

    assert events[0]["t"] == "manifest"
    man = by_type["manifest"][0]
    assert len(by_type["manifest"]) == 1
    assert man["jax_version"] == "unavailable"
    assert man["backend"] == "cpu"
    assert isinstance(man["devices"], list) and man["devices"]
    assert man["env"].get(jtel.TELEMETRY_ENV) == "1"
    assert man["ledger"]["ks"] == [3, 4]
    assert man["ledger"]["n_tasks"] == 8
    assert "seed_min" in man["ledger"]

    decisions = {d["decision"] for d in by_type["dispatch"]}
    assert "solver_path" in decisions
    solver = [d for d in by_type["dispatch"]
              if d["decision"] == "solver_path"][0]
    assert solver["context"]["engaged_path"] in (
        "batched", "batched-packed", "batched-ell")

    assert {e["stage"] for e in by_type["stage"]} >= {"prepare",
                                                      "factorize",
                                                      "combine"}
    reps = by_type["replicates"]
    assert {int(e["k"]) for e in reps} == {3, 4}
    for e in reps:
        assert len(e["records"]) == 4
        for rec in e["records"]:
            assert rec["iters"] >= 1
            assert isinstance(rec["capped"], bool)
            assert rec["trace"], "objective trace must be non-empty"
            assert np.isfinite(rec["trace"]).all()

    assert by_type["memory"]
    assert all(isinstance(m["devices"], list) for m in by_type["memory"])

    report = jtel.render_report(os.path.join(obj.output_dir, obj.name))
    for needle in ("Manifest", "Dispatch decisions", "Stage waterfall",
                   "Replicate convergence", "factorize"):
        assert needle in report
    port_cli(["report", os.path.join(obj.output_dir, obj.name)])


def test_pipeline_events_of_the_port(port_runs):
    """What the port's pipeline adds beyond the JAX test's expectations:
    the dispatch decisions of the main path, one stage event per pipeline
    stage and the consensus sub-stages, the replicate records' cadence
    and kernel, the worker span and the closing metrics snapshot."""
    obj, _ = port_runs
    events = jtel.read_events(_events_path(obj))
    decisions = [e["decision"] for e in events if e["t"] == "dispatch"]
    assert decisions[:3] == ["ell_vs_dense", "solver_recipe", "solver_path"]
    assert decisions.count("consensus_path") == 3    # consensus + 2 stats
    assert decisions.count("k_selection") == 1
    ell = next(e for e in events if e.get("decision") == "ell_vs_dense")
    assert ell["context"]["use_ell"] and ell["context"]["kernel"] == (
        "ell-torch")
    stages = [e["stage"] for e in events if e["t"] == "stage"]
    for top in ("prepare", "factorize", "combine", "consensus",
                "k_selection_plot"):
        assert stages.count(top) == 1, (top, stages)
    assert {"consensus.density", "consensus.kmeans",
            "consensus.refit_usage", "consensus.refit_spectra",
            "consensus.ols", "consensus.writes"} <= set(stages)
    assert [e["stage"] for e in events if e["t"] == "memory"] == [
        "prepare", "factorize", "combine", "consensus", "k_selection_plot"]
    for e in (e for e in events if e["t"] == "replicates"):
        assert (e["mode"], e["cadence"], e["recipe"], e["kernel"]) == (
            "online", "pass", "mu", "ell-torch")
        assert e["cap"] == obj.factorize_info["n_passes"]
    (span,) = [e for e in events if e["t"] == "span"]
    assert span["name"] == "factorize.worker"
    (snap,) = [e for e in events if e["t"] == "metrics_snapshot"]
    assert snap["metrics"]["counters"][
        "cnmf_factorize_workers_total"] >= 1.0
    traces = render_run_traces(os.path.join(obj.output_dir, obj.name))
    assert "factorize.worker" in traces


def test_telemetry_off_writes_no_events(port_runs, capsys):
    _, obj = port_runs
    run = os.path.join(obj.output_dir, obj.name)
    assert not os.path.exists(_events_path(obj))
    report = ttel.render_report(run)
    assert "timings TSV" in report and "factorize" in report
    assert report == jtel.render_report(run)
    port_cli(["report", "--output-dir", obj.output_dir, "--name",
              obj.name])
    assert "timings TSV" in capsys.readouterr().out


def _stored_arrays(path):
    with np.load(path, allow_pickle=True) as f:
        return {key: np.asarray(f[key]).tobytes() for key in f.files}


def test_telemetry_changes_no_artifact(port_runs):
    """Every iter spectra file, merged spectra and consensus artifact of
    the run with every knob on holds the same stored arrays (and text)
    as the run with them off; the zip container carries its write time,
    so the arrays are compared, not the files."""
    on, off = port_runs
    names = sorted(os.listdir(os.path.join(on.output_dir, on.name,
                                           "cnmf_tmp")))
    compared = 0
    for rel in ([os.path.join("cnmf_tmp", n) for n in names
                 if ".spectra.k_" in n or ".iter_" in n]
                + sorted(os.listdir(os.path.join(on.output_dir, on.name)))):
        a = os.path.join(on.output_dir, on.name, rel)
        b = os.path.join(off.output_dir, off.name, rel)
        if os.path.isdir(a) or rel.endswith((".jsonl", ".tsv")):
            continue
        if a.endswith(".npz"):
            assert _stored_arrays(a) == _stored_arrays(b), rel
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
        compared += 1
    assert compared >= 8 + 4 * 2


# ---------------------------------------------------------------------------
# report parity on files written by either package
# ---------------------------------------------------------------------------

def _fault_counts(seed=2, n=60, g=100):
    counts = np.random.default_rng(seed).binomial(
        40, 0.02, size=(n, g)).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return (counts, np.asarray([f"c{i}" for i in range(n)]),
            np.asarray([f"g{j}" for j in range(g)]))


FAULT_SPEC = ("nonfinite:k=3,iter=1;nonfinite:k=3,iter=2;"
              "nonfinite:k=3,iter=2,attempt=1;"
              "nonfinite:k=3,iter=2,attempt=2")


def _fault_run(root, jax: bool):
    """prepare, factorize under FAULT_SPEC (a lane that recovers at its
    first retry and one that is quarantined) and combine, every telemetry
    knob on."""
    counts, rows, cols = _fault_counts()
    fn = os.path.join(root, "counts.df.npz")
    if jax:
        jax_save_df(pd.DataFrame(counts, index=rows, columns=cols), fn)
        obj = JaxCNMF(output_dir=root, name="flt")
    else:
        save_df_to_npz(Frame(counts, rows, cols), fn)
        obj = cNMF(root, "flt", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for key, val in TELEMETRY_ON.items():
            mp.setenv(key, val)
        mp.setenv("CNMF_TPU_MIN_HEALTHY_FRAC", "0.5")
        obj.prepare(fn, components=[3], n_iter=3, seed=1,
                    num_highvar_genes=50, batch_size=64, max_NMF_iter=50)
        mp.setenv("CNMF_TPU_FAULT_SPEC", FAULT_SPEC)
        with pytest.warns(RuntimeWarning, match="quarantined"):
            obj.factorize()
        obj.combine()
    return os.path.join(root, "flt")


@pytest.fixture(scope="module")
def fault_runs(tmp_path_factory):
    return {"jax": _fault_run(str(tmp_path_factory.mktemp("jflt")), True),
            "port": _fault_run(str(tmp_path_factory.mktemp("tflt")), False)}


def _fault_keys(run_dir):
    events = jtel.read_events(os.path.join(run_dir, "cnmf_tmp",
                                           "flt.events.jsonl"))
    return sorted((e["kind"], e["context"]["k"], e["context"]["iter"],
                   e["context"]["attempt"], e["context"].get("healthy"))
                  for e in events if e["t"] == "fault")


def test_guard_fault_events_match_jax(fault_runs):
    got = _fault_keys(fault_runs["port"])
    assert got == _fault_keys(fault_runs["jax"])
    assert {g[0] for g in got} == {"nonfinite_replicate", "retry",
                                   "quarantine"}
    assert ("retry", 3, 1, 1, True) in got


@pytest.mark.parametrize("writer", ["jax-faults", "port-faults",
                                    "port-pipeline"])
@pytest.mark.parametrize("view", ["render_report", "summarize_events"])
def test_report_same_in_both_packages(fault_runs, port_runs, writer, view):
    run = (fault_runs[writer.split("-")[0]] if writer.endswith("faults")
           else os.path.join(port_runs[0].output_dir, port_runs[0].name))
    if view == "render_report":
        got = {name: tel.render_report(run)
               for name, tel in (("port", ttel), ("jax", jtel))}
    else:
        events = jtel.read_events(jtel._find_event_files(run)[0])
        got = {name: json.dumps(tel.summarize_events(events),
                                sort_keys=True, default=str)
               for name, tel in (("port", ttel), ("jax", jtel))}
    assert got["port"] == got["jax"]
    if view == "render_report" and writer.endswith("faults"):
        assert "Faults & recoveries" in got["port"]
        assert "Trace spans (sampled)" in got["port"]


# ---------------------------------------------------------------------------
# replicate records from the same (X, H0, W0)
# ---------------------------------------------------------------------------

def _kl_inputs(seed=8, n=96, g=60, R=3, k=4):
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=0.12, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1)
    X = X.astype(np.float32)
    H0 = rng.random((R, n, k), np.float32) + 0.1
    W0 = rng.random((R, k, g), np.float32) + 0.1
    return X, H0, W0


def _port_records(X, seeds, k, H0, W0, **kw):
    payloads = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CNMF_TPU_TELEMETRY", "1")
        mp.setenv("CNMF_TPU_BF16_RATIO", "0")
        mp.setenv("CNMF_TPU_ACCEL", "0")
        replicate_sweep(X, seeds, k, beta_loss="kullback-leibler",
                        inits=convert.replicate_inits(H0, W0),
                        telemetry_sink=payloads.append, device="cpu", **kw)
    (payload,) = payloads
    return payload, ttel.replicate_records(payload)


def _jax_records(seeds, k, mode, cap, tms, errs):
    tm = jnmf.SolverTelemetry(
        trace=np.stack([np.asarray(t.trace) for t in tms]),
        iters=np.asarray([int(t.iters) for t in tms]),
        nonfinite=np.asarray([bool(t.nonfinite) for t in tms]))
    payload = jrep._sweep_telemetry_payload(k, 1.0, mode, seeds, cap, tm,
                                            np.asarray(errs))
    return jtel.replicate_records(payload)


def _assert_records_agree(got, want):
    assert len(got) == len(want)
    for g_rec, w_rec in zip(got, want):
        for key in ("seed", "iters", "capped", "nonfinite"):
            assert g_rec[key] == w_rec[key], key
        assert len(g_rec["trace"]) == len(w_rec["trace"])
        np.testing.assert_allclose(g_rec["trace"], w_rec["trace"],
                                   rtol=1e-4)
        np.testing.assert_allclose(g_rec["err"], w_rec["err"], rtol=1e-4)


def test_online_replicate_records_match_jax():
    """The main path's sweep (online KL on the ELL lane, strict f32): one
    record a lane with JAX's pass count, cap flag and per-pass trace."""
    X, H0, W0 = _kl_inputs()
    n, k, chunk, seeds = X.shape[0], 4, 48, [11, 22, 33]
    h_tol, n_passes, h_tol_start = jnmf.resolve_online_schedule(1.0)
    te, _ = tsp.ell_chunk_rows(X, chunk)
    payload, got = _port_records(te, seeds, k, H0, W0, n_rows=n,
                                 online_chunk_size=chunk,
                                 online_chunk_max_iter=200)
    assert (payload["cadence"], payload["cap"], payload["recipe"],
            payload["kernel"]) == ("pass", n_passes, "mu", "ell-torch")
    assert payload["trace"].shape == (3, trep.TRACE_LEN)
    e, pad = jsp.ell_chunk_rows(X, chunk)
    xj = jsp.ell_device_put(e)
    Hc = np.pad(H0, ((0, 0), (0, pad), (0, 0))).reshape(3, -1, chunk, k)
    tms, errs = [], []
    for r in range(3):
        _, _, err, tm = jnmf.nmf_fit_online(
            xj, Hc[r], W0[r], beta=1.0, tol=1e-4, h_tol=h_tol,
            chunk_max_iter=200, n_passes=n_passes, h_tol_start=h_tol_start,
            bf16_ratio=False, telemetry=True)
        tms.append(tm)
        errs.append(float(err))
    want = _jax_records(seeds, k, "online", n_passes, tms, errs)
    _assert_records_agree(got, want)
    assert all(len(rec["trace"]) == rec["iters"] for rec in got)


def test_batch_replicate_records_keep_the_64_slot_cap():
    """A batch sweep of 700 iterations evaluates 70 objectives: JAX keeps
    the first 63 and, in the last slot, the 70th; so does the port."""
    X, H0, W0 = _kl_inputs(seed=4, n=40, g=30, R=2, k=3)
    Xd = X.toarray()
    seeds = [5, 6]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CNMF_TPU_SPARSE_BETA", "0")
        payload, got = _port_records(Xd, seeds, 3, H0, W0, mode="batch",
                                     tol=-1.0, batch_max_iter=700)
    assert payload["cadence"] == "iter/10" and payload["cap"] == 700
    tms, errs = [], []
    for r in range(2):
        _, _, err, tm = jnmf.nmf_fit_batch(Xd, H0[r], W0[r], beta=1.0,
                                           tol=-1.0, max_iter=700,
                                           telemetry=True)
        tms.append(tm)
        errs.append(float(err))
    want = _jax_records(seeds, 3, "batch", 700, tms, errs)
    _assert_records_agree(got, want)
    for rec in got:
        assert rec["capped"] and len(rec["trace"]) == trep.TRACE_LEN


@pytest.mark.parametrize("n_evals", [0, 1, 63, 64, 65, 90])
def test_trace_slots_overwrite_the_last(n_evals):
    vals = np.arange(1, n_evals + 1, dtype=np.float32)
    slots = trep._trace_slots(vals)
    assert slots.shape == (trep.TRACE_LEN,)
    kept = slots[~np.isnan(slots)]
    assert len(kept) == min(n_evals, trep.TRACE_LEN)
    if n_evals:
        assert kept[-1] == n_evals
        assert (kept[:-1] == np.arange(1, len(kept))).all()
