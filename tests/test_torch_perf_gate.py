"""The port's perf gate (``obs/perf_gate.py``) against the JAX package's
``scripts/perf_gate.py``.

The gate runs on the CPU only when asked (``--device cpu``); its default
device is the card, which raises here. Its snapshot is the JAX script's
document for the same measurement (the JAX script is loaded by path, its
``_snapshot`` run on the same dict and fingerprint), and its pinned lane
is JAX's ``nmf_fit_batch`` on the same draws, at the one-replicate solve
bands of ``tests/test_torch_call_forms.py`` (factors within 1e-4 of their
largest value, the objective at ``rtol 1e-5``). The measurement itself
runs on the CPU; every test of a verdict (the self-test's legs through
the ``benchdiff`` children, the baseline leg) feeds ``main`` a fixed
measurement. The self-test is JAX's, its two measurements' samples
taken in turns: its doubled candidate goes red only while the second
honest wall stays above 0.8 of the first, and the suite's workers share
this host's cores, so a verdict on live walls would test the host.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu_torch.obs import perf_gate
from cnmf_torch_tpu_torch.obs import regress as rg
from cnmf_torch_tpu_torch.utils.autotune import device_fingerprint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY = ("perf gate: self-test green on re-measurement and red on "
           "injected 2x slowdown (benchdiff exits 0/1), min-of-")
MEAS = {"samples": [0.0123, 0.0119, 0.0131], "wall_s": 0.0119,
        "gflops": 0.87}


@pytest.fixture(scope="module")
def jax_gate():
    spec = importlib.util.spec_from_file_location(
        "_jax_perf_gate", os.path.join(ROOT, "scripts", "perf_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def gate_env(monkeypatch, tmp_path):
    for name in (rg.GATE_N_ENV, rg.GATE_BAND_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(perf_gate, "BASELINE_DIR", str(tmp_path / "base"))
    return monkeypatch


@pytest.fixture
def fixed_measurement(gate_env):
    """``main`` measures ``MEAS`` (the device it was asked for recorded)."""
    devices = []

    def measure_turns(n, device, ways):
        devices.append((n, str(device), ways))
        return [dict(MEAS) for _ in range(ways)]

    gate_env.setattr(perf_gate, "_measure_turns", measure_turns)
    return devices


def test_main_on_the_cpu_prints_the_summary(fixed_measurement, capsys):
    assert perf_gate.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"{SUMMARY}3 gate wall 11.9 ms at (96, 64, 7), "
                    f"fingerprint {device_fingerprint('cpu')}; no baseline "
                    "recorded for this fingerprint")
    # the self-test's two honest measurements, in turns, N from the knob
    assert fixed_measurement == [(3, "cpu", 2)]


def _module(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "cnmf_torch_tpu_torch.obs.perf_gate",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


def test_the_module_runs_as_a_user_runs_it():
    """The module's entry: its usage, and the card by default."""
    usage = _module("--help")
    assert usage.returncode == 0, usage.stderr
    assert "--device" in usage.stdout and "--write-baseline" in usage.stdout
    if torch.cuda.is_available():
        return
    default = _module()
    assert default.returncode == 1
    assert "no CUDA device is available" in default.stderr


def test_without_a_card_the_default_device_raises(gate_env):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is live")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_gate.main([])


def test_snapshot_is_the_jax_scripts(jax_gate):
    assert (perf_gate.GATE_SHAPE, perf_gate.GATE_ITERS) == \
        (jax_gate.GATE_SHAPE, jax_gate.GATE_ITERS)
    mine = perf_gate._snapshot(MEAS, "fp-card", 1000.0, "gate-new")
    theirs = jax_gate._snapshot(MEAS, "fp-card", 1000.0, "gate-new")
    assert mine == theirs
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)
    assert mine["tiers"]["gate"]["metrics"]["update_wall_s"]["samples"] \
        == MEAS["samples"]


def test_the_gate_lane_matches_jax():
    X, H0, W0 = perf_gate._gate_inputs("cpu")
    n, g, k = perf_gate.GATE_SHAPE
    rng = np.random.default_rng(0)
    draws = [rng.random(s).astype(np.float32)
             for s in ((n, g), (n, k), (k, g))]
    for got, want in zip((X, H0, W0), draws):
        np.testing.assert_array_equal(got.numpy(), want)
    H, W, err = perf_gate._fit(X, H0, W0)
    Hj, Wj, errj = jnmf.nmf_fit_batch(*map(jnp.asarray, draws), beta=2.0,
                                      tol=0.0, max_iter=perf_gate.GATE_ITERS)
    assert (H.shape, W.shape, err.shape) == ((n, k), (k, g), ())
    assert float(err) == pytest.approx(float(errj), rel=1e-5)
    for got, want in ((H, Hj), (W, Wj)):
        want = np.asarray(want, np.float64)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-4 * np.abs(
            want).max()


def test_measure_counts_the_samples_and_the_flops():
    meas = perf_gate._measure(2, "cpu")
    assert len(meas["samples"]) == 2
    assert meas["wall_s"] == min(meas["samples"]) > 0
    cost = jnmf.dense_update_cost(*perf_gate.GATE_SHAPE, 2.0)["flops"]
    assert meas["gflops"] == pytest.approx(
        cost * perf_gate.GATE_ITERS / meas["wall_s"] / 1e9)


def test_the_self_tests_measurements_take_their_samples_in_turns(
        monkeypatch):
    """Each call of the lane is one sample, the two measurements' calls
    alternate after the warm calls, and each wall is its own min."""
    calls = []
    clock = [0.0]

    def fit(X, H0, W0):
        calls.append(len(calls))
        clock[0] += 1.0 + len(calls)   # every call a second longer

    monkeypatch.setattr(perf_gate, "_fit", fit)
    monkeypatch.setattr(perf_gate.time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(perf_gate, "GATE_WARM_S", 0.0)
    a, b = perf_gate._measure_turns(3, "cpu", 2)
    # one warm call (2 s), then a, b, a, b, a, b
    assert a["samples"] == [3.0, 5.0, 7.0]
    assert b["samples"] == [4.0, 6.0, 8.0]
    assert (a["wall_s"], b["wall_s"]) == (3.0, 4.0)
    assert len(calls) == 7
    assert a["gflops"] == pytest.approx(4.0 / 3.0 * b["gflops"])


def _baseline_path():
    fp = device_fingerprint("cpu")
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in fp)
    return os.path.join(perf_gate.BASELINE_DIR, safe + ".json")


def test_the_baseline_leg(fixed_measurement, capsys):
    assert not os.path.exists(_baseline_path())
    assert perf_gate.main(["--device", "cpu", "--write-baseline"]) == 0
    assert os.path.isfile(_baseline_path())
    assert "baseline written to " + _baseline_path() in \
        capsys.readouterr().out
    # green against its own baseline
    assert perf_gate.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "within band of baseline " + _baseline_path() in out
    # red against the same baseline with its walls halved
    base = rg.load_snapshot(_baseline_path())
    rg.save_snapshot(perf_gate._scaled_walls(base, 0.5), _baseline_path())
    assert perf_gate.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "regressed" in captured.out
    assert "regression vs recorded baseline" in captured.err


def test_scaled_walls_doubles_as_the_jax_red_leg():
    snap = perf_gate._snapshot(MEAS, "fp", 1.0, "b")
    red = perf_gate._scaled_walls(snap, 2.0)
    m = red["tiers"]["gate"]["metrics"]["update_wall_s"]
    assert m["value"] == 2.0 * MEAS["wall_s"]
    assert m["samples"] == [2.0 * s for s in MEAS["samples"]]
    assert snap["tiers"]["gate"]["metrics"]["update_wall_s"]["value"] == \
        MEAS["wall_s"]
    d = rg.diff_snapshots(snap, red)
    assert d["ok"] is False and d["regressions"] == 1
