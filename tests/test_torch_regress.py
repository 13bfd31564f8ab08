"""The port's perf-regression observatory (``obs/regress.py``) and its
``benchdiff`` command against the JAX package's.

The counterparts of ``tests/test_regress.py``'s thirteen tests, run on the
port's copy, plus the cross-package checks: a snapshot built by either
package validates and diffs in the other, both packages' diffs of
``BENCH_r06.json`` against a copy with one lane slowed 2x are equal row
for row, and both ``benchdiff`` commands give the same verdict, text and
exit code. Every comparison is exact (the diff is host arithmetic on the
same floats).
"""

import contextlib
import copy
import io
import json
import os
import subprocess
import sys

import pytest

from cnmf_torch_tpu.cli import main as jax_main
from cnmf_torch_tpu.obs import regress as jrg
from cnmf_torch_tpu_torch.cli import main as port_main
from cnmf_torch_tpu_torch.obs import regress as rg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RAW = {
    "serve": {"qps": 500.0, "latency_ms": {"p50": 10.0, "p99": 20.0,
                                           "count": 360,
                                           "histogram": {"<=10": 160}},
              "vs_baseline": 0.5, "requests": 360, "ok": True,
              "latency_samples_kept": 390},
    "kl": {"wall_seconds": 4.0, "mfu": 0.02, "error": None},
}


def _snap(raw=None, fingerprint="fp-a", created=1000.0, label=None,
          mod=rg):
    return mod.build_snapshot(raw if raw is not None else RAW,
                              fingerprint=fingerprint, created=created,
                              label=label)


# ---------------------------------------------------------------------------
# schema: extraction, validation, round trip
# ---------------------------------------------------------------------------

def test_extract_metrics_direction_classification():
    m = rg.extract_metrics(RAW["serve"])
    assert m["qps"]["direction"] == "higher"
    assert m["latency_ms.p50"]["direction"] == "lower"
    assert m["latency_ms.p99"]["direction"] == "lower"
    for absent in ("vs_baseline", "requests", "ok", "latency_ms.count",
                   "latency_ms.histogram.<=10", "latency_samples_kept"):
        assert absent not in m
    mk = rg.extract_metrics(RAW["kl"])
    assert mk["wall_seconds"]["direction"] == "lower"
    assert mk["mfu"]["direction"] == "higher"
    # the JAX package lifts the same metrics
    for raw in RAW.values():
        assert rg.extract_metrics(raw) == jrg.extract_metrics(raw)


def test_snapshot_round_trip(tmp_path):
    snap = _snap(label="round-trip")
    path = rg.save_snapshot(snap, str(tmp_path / "deep" / "snap.json"))
    loaded = rg.load_snapshot(path)
    assert loaded == snap
    assert loaded["schema"] == rg.BENCH_SCHEMA == jrg.BENCH_SCHEMA
    assert loaded["schema_version"] == rg.BENCH_SCHEMA_VERSION
    assert loaded["label"] == "round-trip"
    assert loaded["tiers"]["serve"]["raw"]["latency_ms"]["p50"] == 10.0
    # one schema: the JAX package loads the port's file, and the two
    # writers give the same bytes for the same snapshot
    assert jrg.load_snapshot(path) == snap
    jpath = jrg.save_snapshot(_snap(label="round-trip", mod=jrg),
                              str(tmp_path / "j" / "snap.json"))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    assert not [fn for fn in os.listdir(tmp_path / "deep")
                if fn != "snap.json"]


_BREAKAGES = (
    {"schema": "something-else"},
    {"schema_version": 99},
    {"fingerprint": None},
    {"tiers": {"kl": {"metrics": "fast"}}},
    {"tiers": {"kl": {"metrics": {"wall_seconds": {
        "value": "4", "direction": "lower"}}}}},
    {"tiers": {"kl": {"metrics": {"wall_seconds": {
        "value": 4.0, "direction": "sideways"}}}}},
    {"tiers": {"kl": {"metrics": {"wall_seconds": {
        "value": 4.0, "direction": "lower", "samples": [1.0, "x"]}}}}},
)


@pytest.mark.parametrize("breakage", _BREAKAGES,
                         ids=lambda b: next(iter(b)))
def test_validate_rejects_malformed_docs(breakage):
    good = _snap()
    with pytest.raises(ValueError) as mine:
        rg.validate_bench({**good, **breakage})
    with pytest.raises(ValueError) as theirs:
        jrg.validate_bench({**good, **breakage})
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError):
        rg.validate_bench([good])


def test_error_tier_is_perf_exempt():
    snap = _snap({"kl": {"wall_seconds": 4.0, "error": "timeout"},
                  "serve": {"qps": 10.0, "perf_exempt": True}})
    assert snap["tiers"]["kl"]["perf_exempt"] is True
    assert snap["tiers"]["serve"]["perf_exempt"] is True


# ---------------------------------------------------------------------------
# the noise-aware diff
# ---------------------------------------------------------------------------

def test_diff_green_on_identical():
    d = rg.diff_snapshots(_snap(), _snap(), band=0.1)
    assert d["ok"] is True and d["regressions"] == 0
    assert all(r["verdict"] in ("ok", "exempt") for r in d["rows"])
    assert "=> OK" in rg.render_diff(d)


def test_diff_red_on_2x_lane_slowdown():
    new = copy.deepcopy(RAW)
    new["kl"]["wall_seconds"] = 8.0
    d = rg.diff_snapshots(_snap(), _snap(new), band=0.6)
    red = [r for r in d["rows"] if r["verdict"] == "regressed"]
    assert d["ok"] is False and d["regressions"] == 1
    assert red[0]["tier"] == "kl" and red[0]["metric"] == "wall_seconds"
    assert red[0]["rel"] == pytest.approx(1.0)
    assert "=> RED" in rg.render_diff(d)


def test_diff_direction_for_higher_better_metrics():
    worse = copy.deepcopy(RAW)
    worse["serve"]["qps"] = 100.0
    d = rg.diff_snapshots(_snap(), _snap(worse), band=0.6)
    assert {(r["tier"], r["metric"]) for r in d["rows"]
            if r["verdict"] == "regressed"} == {("serve", "qps")}
    better = copy.deepcopy(RAW)
    better["serve"]["qps"] = 2000.0
    d2 = rg.diff_snapshots(_snap(), _snap(better), band=0.6)
    assert d2["ok"] is True and d2["improvements"] == 1


def test_diff_min_of_n_samples_absorb_noise():
    base, new = _snap(), _snap()
    m = new["tiers"]["kl"]["metrics"]["wall_seconds"]
    m["samples"] = [9.0, 4.1, 12.0]
    m["value"] = 9.0
    rg.validate_bench(new)
    d = rg.diff_snapshots(base, new, band=0.2)
    row = [r for r in d["rows"] if r["metric"] == "wall_seconds"][0]
    assert row["new"] == 4.1 and row["verdict"] == "ok"
    assert rg._effective({"value": 1.0, "direction": "higher",
                          "samples": [1.0, 3.0, 2.0]}) == 3.0


def test_diff_fingerprint_mismatch_exempts_everything():
    new = copy.deepcopy(RAW)
    new["kl"]["wall_seconds"] = 400.0
    d = rg.diff_snapshots(_snap(), _snap(new, fingerprint="fp-b"),
                          band=0.1)
    assert d["ok"] is True and d["fingerprint_match"] is False
    assert all(r["verdict"] in ("exempt", "missing") for r in d["rows"])
    assert "fingerprints differ" in rg.render_diff(d)


def test_diff_missing_tier_and_metric_reported_not_gated():
    base = _snap({"kl": {"wall_seconds": 4.0},
                  "serve": {"qps": 500.0}})
    new = _snap({"kl": {"wall_seconds": 4.0, "compile_seconds": 1.0}})
    d = rg.diff_snapshots(base, new, band=0.1)
    verdicts = {(r["tier"], r["metric"]): r["verdict"] for r in d["rows"]}
    assert verdicts[("serve", "*")] == "missing"
    assert verdicts[("kl", "compile_seconds")] == "missing"
    assert d["ok"] is True


# knob -> (the port's and JAX's readers, the variable, the default, (word,
# value) pairs the two packages read alike, a word both refuse)
GATE_KNOBS = {
    "band": (rg.gate_band, jrg.gate_band, rg.GATE_BAND_ENV,
             rg.DEFAULT_BAND, [("0.25", 0.25)], "wide"),
    # the sample count floors at 1
    "n": (rg.gate_n, jrg.gate_n, rg.GATE_N_ENV, rg.DEFAULT_N,
          [("5", 5), ("0", 1), ("-3", 1)], "three"),
}


@pytest.mark.parametrize("knob", sorted(GATE_KNOBS))
def test_gate_band_knob(monkeypatch, knob):
    """The perf gate's knobs (the band and the sample count) read as the
    JAX package reads them."""
    mine, theirs, env, default, words, bad = GATE_KNOBS[knob]
    assert (rg.GATE_BAND_ENV, rg.GATE_N_ENV, rg.DEFAULT_BAND,
            rg.DEFAULT_N) == (jrg.GATE_BAND_ENV, jrg.GATE_N_ENV,
                              jrg.DEFAULT_BAND, jrg.DEFAULT_N)
    monkeypatch.delenv(env, raising=False)
    assert mine() == theirs() == default
    for word, value in words:
        monkeypatch.setenv(env, word)
        assert mine() == theirs() == value
    if knob == "band":
        d = rg.diff_snapshots(_snap(), _snap())
        assert d["band"] == 0.25
    monkeypatch.setenv(env, bad)
    with pytest.raises(ValueError, match=env) as caught:
        mine()
    with pytest.raises(Exception) as caught_jax:
        theirs()
    assert type(caught.value) is type(caught_jax.value)


def test_zero_baseline_edge():
    base = _snap({"kl": {"wall_seconds": 0.0}})
    same = _snap({"kl": {"wall_seconds": 0.0}})
    worse = _snap({"kl": {"wall_seconds": 1.0}})
    assert rg.diff_snapshots(base, same, band=0.1)["ok"] is True
    d = rg.diff_snapshots(base, worse, band=0.1)
    assert d["ok"] is False
    row = [r for r in d["rows"] if r["metric"] == "wall_seconds"][0]
    assert row["rel"] is None


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _bench_pair(tmp_path):
    """``BENCH_r06.json`` and a copy whose ``plan`` tier ran 2x slower."""
    base_fn = os.path.join(ROOT, "BENCH_r06.json")
    with open(base_fn) as f:
        slow = json.load(f)
    m = slow["tiers"]["plan"]["metrics"]["autotuned_auto.wall_seconds"]
    m["value"] *= 2.0
    if isinstance(m.get("samples"), list):
        m["samples"] = [2.0 * s for s in m["samples"]]
    slow_fn = str(tmp_path / "slow.json")
    with open(slow_fn, "w") as f:
        json.dump(slow, f)
    return base_fn, slow_fn


@pytest.mark.parametrize("band", [None, 0.6, 0.05])
def test_both_packages_diff_bench_r06_alike(tmp_path, band):
    base_fn, slow_fn = _bench_pair(tmp_path)
    for a, b in ((base_fn, base_fn), (base_fn, slow_fn), (slow_fn, base_fn)):
        mine = rg.diff_snapshots(rg.load_snapshot(a), rg.load_snapshot(b),
                                 band=band)
        theirs = jrg.diff_snapshots(jrg.load_snapshot(a),
                                    jrg.load_snapshot(b), band=band)
        assert mine == theirs
        assert rg.render_diff(mine) == jrg.render_diff(theirs)
    slowed = rg.diff_snapshots(rg.load_snapshot(base_fn),
                               rg.load_snapshot(slow_fn), band=band)
    # 2x is a move of 1.0, past every band here
    assert {(r["tier"], r["metric"]) for r in slowed["rows"]
            if r["verdict"] == "regressed"} == {
                ("plan", "autotuned_auto.wall_seconds")}
    assert slowed["ok"] is False


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with pytest.raises(SystemExit) as exc:
            main(argv)
    return exc.value.code, buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--json"], ["--band", "0.05"],
                                   ["--band", "0.05", "--json"]])
def test_benchdiff_matches_the_jax_command(tmp_path, extra):
    base_fn, slow_fn = _bench_pair(tmp_path)
    for a, b in ((base_fn, base_fn), (base_fn, slow_fn)):
        mine = _run_cli(port_main, ["benchdiff", a, b] + extra)
        theirs = _run_cli(jax_main, ["benchdiff", a, b] + extra)
        assert mine == theirs
    assert _run_cli(port_main, ["benchdiff", base_fn, slow_fn, "--band",
                                "0.05"])[0] == 1


def test_benchdiff_cli_exit_codes(tmp_path):
    a = rg.save_snapshot(_snap(), str(tmp_path / "a.json"))
    worse = copy.deepcopy(RAW)
    worse["kl"]["wall_seconds"] = 8.0
    b = rg.save_snapshot(_snap(worse), str(tmp_path / "b.json"))
    env = dict(os.environ, PYTHONPATH=ROOT)

    green = subprocess.run(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", "benchdiff", a, a],
        capture_output=True, text=True, timeout=120, env=env)
    assert green.returncode == 0, green.stderr
    assert "=> OK" in green.stdout

    red = subprocess.run(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", "benchdiff", a, b,
         "--band", "0.6", "--json"],
        capture_output=True, text=True, timeout=120, env=env)
    assert red.returncode == 1, red.stderr
    doc = json.loads(red.stdout)
    assert doc["ok"] is False and doc["regressions"] == 1

    bad = subprocess.run(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", "benchdiff", a,
         str(tmp_path / "absent.json")],
        capture_output=True, text=True, timeout=120, env=env)
    assert bad.returncode == 2 and "absent.json" in bad.stderr
