"""Retries, quarantine and resume in the port, against the JAX package.

The port keeps its own copies of ``runtime/faults.py`` and
``runtime/resilience.py``; each piece is held against the JAX package's
from the same inputs: the derived retry seeds, the fault-spec grammar
(the same clauses parse to the same params, the same malformed specs
raise the same messages), the health grade, the artifact probe's
verdicts, the resilience ledger (written by one package, read by the
other), and whole factorize runs under one ``CNMF_TPU_FAULT_SPEC``: the
same tasks are retried, written and quarantined, the same floor fails.
Then the port alone: a resume after a torn artifact and a kill-resume
through the CLI in a subprocess (``--device cpu``) rewrite every iter
file bit for bit as the uninterrupted run wrote it.

Tolerances: none. Seeds, specs, verdicts, task sets and ledger records
are compared exactly, and resumed artifacts byte for byte.
"""

import contextlib
import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_torch_tpu import cNMF as JaxCNMF
from cnmf_torch_tpu import save_df_to_npz as jax_save_df
from cnmf_torch_tpu.runtime import faults as jfaults
from cnmf_torch_tpu.runtime import resilience as jres
from cnmf_torch_tpu_torch import Frame, cNMF, load_df_from_npz, save_df_to_npz
from cnmf_torch_tpu_torch.cli import main as cli_main
from cnmf_torch_tpu_torch.parallel import replicate_sweep
from cnmf_torch_tpu_torch.runtime import faults, resilience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = faults.FAULT_SPEC_ENV


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each would oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def fault_env(monkeypatch):
    for name in (SPEC, resilience.MAX_RETRIES_ENV,
                 resilience.MIN_HEALTHY_FRAC_ENV, "CNMF_TPU_TELEMETRY",
                 "CNMF_TPU_SKETCH", "CNMF_TPU_ACCEL"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# seeds, spec grammar, health grade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 7, 12345, 946286477,
                                  0x7FFFFFFE, 0x7FFFFFFF, 0xFFFFFFFF,
                                  2 ** 40 + 3])
@pytest.mark.parametrize("attempt", [1, 2, 3, 5, 64])
def test_derive_retry_seed_matches_jax(seed, attempt):
    got = resilience.derive_retry_seed(seed, attempt)
    assert got == jres.derive_retry_seed(seed, attempt)
    assert got == (seed ^ attempt) & 0x7FFFFFFF


def test_derive_retry_seed_refuses_attempt_zero():
    for mod in (resilience, jres):
        with pytest.raises(ValueError, match="start at 1"):
            mod.derive_retry_seed(7, 0)


GOOD_SPECS = [
    "nonfinite:k=5,iter=2",
    "nonfinite:k=5,iter=2;kill:stage=factorize,worker=1;"
    "torn:artifact=iter_spectra;upload",
    " nonfinite : k=9 , iter=3 , attempt=1 ;; ",
    "kill:stage=factorize,worker=0,once=/tmp/x.done,after=2",
    "torn:artifact=iter_,limit=3",
    "upload:context=replicate_sweep",
    "stall:context=stream,seconds=0.05",
    "hostloss:devices=2+3,count=2",
    "straggler:worker=1,seconds=0.5,limit=4",
    "shard_read;netflake;netslow:seconds=2;netdown:context=get:slab;"
    "nettorn",
    "replicadeath:worker=0;replicawedge:context=serve",
    "nonfinite:seed=-12,k=3",
    "",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_fault_spec_matches_jax(spec):
    got = [(c.kind, c.params) for c in faults.parse_fault_spec(spec)]
    want = [(c.kind, c.params) for c in jfaults.parse_fault_spec(spec)]
    assert got == want


BAD_SPECS = ["explode:k=1", "kill:stage", "nonfinite:k=1,=3",
             "kill:stage=factorize;teleport", "torn:artifact"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_fault_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as got:
        faults.parse_fault_spec(spec)
    with pytest.raises(ValueError) as want:
        jfaults.parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", range(4))
def test_lane_health_with_nonfinite_matches_jax(case):
    rng = np.random.default_rng(case)
    errs = rng.random(6)
    errs[rng.integers(0, 6)] = [np.nan, np.inf, -np.inf, 1.0][case]
    latch = rng.random(6) < 0.3
    spectra = rng.random((6, 2, 3)).astype(np.float32)
    spectra[rng.integers(0, 6), 1, 2] = np.nan if case % 2 else 0.5
    for kw in ({}, {"nonfinite": latch}, {"spectra": spectra},
               {"nonfinite": latch, "spectra": spectra}):
        np.testing.assert_array_equal(resilience.lane_health(errs, **kw),
                                      jres.lane_health(errs, **kw))


def test_poison_lanes_and_controls_match_jax(fault_env, tmp_path):
    spectra = np.ones((3, 2, 2), np.float32)
    errs = np.ones(3)
    calls = [(4, [0, 1, 2], 0), (5, [0, 1, 2], 0), (4, [0, 1, 2], 1),
             (4, [0, 1, 2], 0), (4, [2, 1, 0], 0)]
    for spec in ("nonfinite:k=4,iter=1", "nonfinite:k=4,after=1",
                 "nonfinite:k=4,limit=1", "nonfinite:seed=11",
                 "nonfinite:k=4,iter=2,attempt=1"):
        outs = []
        for mod in (faults, jfaults):
            # a raw value no other test sets: each module parses it anew,
            # with fresh counters
            fault_env.setenv(SPEC, spec + ";;;")
            row = []
            for k, its, attempt in calls:
                s2, e2 = mod.maybe_poison_lanes(k, its, spectra, errs,
                                                attempt=attempt,
                                                seeds=[10, 11, 12])
                row.append((np.isnan(s2).any(axis=(1, 2)).tolist(),
                            np.isnan(e2).tolist()))
            outs.append(row)
        assert outs[0] == outs[1], spec
    assert np.isfinite(spectra).all() and np.isfinite(errs).all()


def test_torn_hook_tears_the_matching_artifact_once(fault_env, tmp_path):
    fault_env.setenv(SPEC, "torn:artifact=spectra,limit=1")
    f = Frame(np.ones((2, 3)), np.asarray([1, 2]), np.asarray(list("abc")))
    fn1 = str(tmp_path / "x.spectra.k_3.iter_0.df.npz")
    fn2 = str(tmp_path / "x.spectra.k_3.iter_1.df.npz")
    fn3 = str(tmp_path / "x.usages.df.npz")
    for fn in (fn3, fn1, fn2):
        save_df_to_npz(f, fn, compress=False)
    assert resilience.probe_spectra_file(fn3, k=2) is None   # no match
    assert "unreadable" in resilience.probe_spectra_file(fn1, k=2)
    assert resilience.probe_spectra_file(fn2, k=2) is None   # limit=1


def test_kill_hook_sigkills_once_per_sentinel(tmp_path):
    script = tmp_path / "killme.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from cnmf_torch_tpu_torch.runtime import faults\n"
        "faults.maybe_kill('factorize', 0)\n"
        "print('alive')\n")
    sentinel = tmp_path / "kill.done"
    env = dict(os.environ, CNMF_TPU_FAULT_SPEC=
               f"kill:stage=factorize,worker=0,once={sentinel}")
    p1 = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, timeout=120)
    assert p1.returncode == -signal.SIGKILL, p1.stderr.decode()
    assert sentinel.exists()
    p2 = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, timeout=120)
    assert p2.returncode == 0 and b"alive" in p2.stdout


def test_straggle_and_upload_hooks(fault_env):
    fault_env.setenv(SPEC, "straggler:worker=1,seconds=0.01,limit=2;"
                           "upload:context=replicate_sweep")
    assert faults.maybe_straggle("factorize", worker=0) == 0.0
    assert faults.maybe_straggle("factorize", worker=1) == 0.01
    assert faults.maybe_straggle("factorize", worker=1) == 0.01
    assert faults.maybe_straggle("factorize", worker=1) == 0.0  # limit 2
    with pytest.raises(RuntimeError, match="injected fault: upload"):
        replicate_sweep(np.ones((6, 5), np.float32), [1], 2, device="cpu")
    fault_env.delenv(SPEC)
    spectra, _, errs = replicate_sweep(np.ones((6, 5), np.float32), [1], 2,
                                       device="cpu")
    assert spectra.shape == (1, 2, 5) and np.isfinite(errs).all()


# ---------------------------------------------------------------------------
# artifact validation and the ledger, across the two packages
# ---------------------------------------------------------------------------

def _torn_cases(tmp_path):
    """name -> (path, k, n_genes) of valid, torn, NaN, wrong-shape and
    missing artifacts written by the port."""
    cols = np.asarray([f"g{j}" for j in range(5)])
    good = Frame(np.ones((3, 5)), np.arange(1, 4), cols)
    cases = {}

    def put(name, frame):
        fn = str(tmp_path / f"{name}.df.npz")
        save_df_to_npz(frame, fn, compress=False)
        return fn

    cases["valid"] = (put("valid", good), 3, 5)
    cases["rows"] = (cases["valid"][0], 4, None)
    cases["genes"] = (cases["valid"][0], 3, 9)
    nan = good.values.copy()
    nan[1, 2] = np.nan
    cases["nan"] = (put("nan", Frame(nan, good.index, cols)), 3, None)
    inf = good.values.copy()
    inf[0, 0] = np.inf
    cases["inf"] = (put("inf", Frame(inf, good.index, cols)), 3, 5)
    torn = put("torn", good)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 3)
    cases["torn"] = (torn, 3, 5)
    one_d = str(tmp_path / "oned.df.npz")
    np.savez(one_d, data=np.ones(5), index=np.arange(5), columns=cols)
    cases["ndim"] = (one_d, None, None)
    labels = str(tmp_path / "labels.df.npz")
    np.savez(labels, data=np.ones((3, 5)), index=np.arange(2), columns=cols)
    cases["labels"] = (labels, 3, 5)
    cases["missing"] = (str(tmp_path / "none.df.npz"), 3, 5)
    return cases


def test_probe_and_load_verdicts_match_jax(tmp_path):
    for name, (fn, k, g) in _torn_cases(tmp_path).items():
        got = resilience.probe_spectra_file(fn, k=k, n_genes=g)
        want = jres.probe_spectra_file(fn, k=k, n_genes=g)
        assert got == want, name
        assert (got is None) == (name == "valid"), name
        if got not in (None, "missing"):
            with pytest.raises(resilience.TornArtifactError):
                resilience.load_spectra_checked(fn, k=k, n_genes=g)
    frame = resilience.load_spectra_checked(
        _torn_cases(tmp_path)["valid"][0], k=3, n_genes=5)
    assert frame.shape == (3, 5)


def _guard_run(mod, path):
    guard = mod.ReplicateGuard(ledger_path=path, max_retries_=1,
                               min_healthy_frac_=0.5)
    guard.observe(3, [0, 1, 2], [10, 11, 12], [True, False, False])
    wave = guard.take_pending()
    derived = [mod.derive_retry_seed(t["seed"], 1) for t in wave]
    guard.observe(3, [t["iter"] for t in wave], [t["seed"] for t in wave],
                  [True, False], attempt=1, derived_seeds=derived)
    guard.carry_quarantined(4, 5, 99, attempts=2)
    guard.credit_existing(4, 3)
    guard.finalize()
    with open(path) as f:
        return json.load(f)


def test_ledgers_written_by_one_package_read_by_the_other(tmp_path):
    tpl = str(tmp_path / "run.resilience.w%d.json")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        port = _guard_run(resilience, tpl % 0)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        jax_ = _guard_run(jres, tpl % 1)
    assert port == jax_
    assert port["retries"][0] == {"k": 3, "iter": 1, "seed": 11,
                                  "attempt": 1, "derived_seed": 10,
                                  "healthy": True}
    recs = resilience.load_quarantine_records(tpl)
    assert recs == jres.load_quarantine_records(tpl) == {(3, 2): 1,
                                                         (4, 5): 2}
    assert resilience.load_quarantined_tasks(tpl) == \
        jres.load_quarantined_tasks(tpl)
    # stale ledgers of worker indices outside the fleet go
    resilience.sweep_stale_ledgers(tpl, 1)
    assert os.path.exists(tpl % 0) and not os.path.exists(tpl % 1)


def test_guard_floor_matches_jax(tmp_path):
    for mod in (resilience, jres):
        guard = mod.ReplicateGuard(ledger_path=str(tmp_path / "l.json"),
                                   max_retries_=0, min_healthy_frac_=0.8)
        with pytest.warns(RuntimeWarning, match="quarantined"):
            guard.observe(3, [0, 1, 2], [1, 2, 3], [True, True, False])
        with pytest.raises(mod.UnhealthySweepError,
                           match="too few healthy replicates"):
            guard.finalize()
    assert resilience.UNHEALTHY_EXIT_CODE == jres.UNHEALTHY_EXIT_CODE == 3


# ---------------------------------------------------------------------------
# factorize and combine under one fault spec, in both packages
# ---------------------------------------------------------------------------

def _counts_df(seed=2, n=60, g=100):
    counts = np.random.default_rng(seed).binomial(
        40, 0.02, size=(n, g)).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return (counts, np.asarray([f"c{i}" for i in range(n)]),
            np.asarray([f"g{j}" for j in range(g)]))


def _prepared(tmp_path, name, jax=False, n_iter=3, components=(3,),
              **kw):
    counts, rows, cols = _counts_df()
    fn = str(tmp_path / f"{name}_counts.df.npz")
    if jax:
        jax_save_df(pd.DataFrame(counts, index=rows, columns=cols), fn)
        obj = JaxCNMF(output_dir=str(tmp_path), name=name)
    else:
        save_df_to_npz(Frame(counts, rows, cols), fn)
        obj = cNMF(str(tmp_path), name, device="cpu")
    obj.prepare(fn, components=list(components), n_iter=n_iter, seed=1,
                num_highvar_genes=50, batch_size=64, max_NMF_iter=50, **kw)
    return obj


def _outcome(obj, ks=(3,), n_iter=3):
    """Which iter files exist, and the ledger's retries and quarantines."""
    written = sorted((k, it) for k in ks for it in range(n_iter)
                     if os.path.exists(obj.paths["iter_spectra"] % (k, it)))
    path = obj.paths["resilience_ledger"] % 0
    ledger = None
    if os.path.exists(path):
        with open(path) as f:
            ledger = json.load(f)
        ledger = (ledger["retries"],
                  sorted((q["k"], q["iter"], q["seed"], q["attempts"])
                         for q in ledger["quarantined"]))
    return written, ledger


SCENARIOS = {
    "retry": ("nonfinite:k=3,iter=1", {}),
    "quarantine": ("nonfinite:k=3,iter=0;nonfinite:k=3,iter=0,attempt=1;"
                   "nonfinite:k=3,iter=0,attempt=2",
                   {resilience.MIN_HEALTHY_FRAC_ENV: "0.5"}),
    "no_retries": ("nonfinite:k=3,iter=2",
                   {resilience.MAX_RETRIES_ENV: "0",
                    resilience.MIN_HEALTHY_FRAC_ENV: "0.6"}),
}


@pytest.fixture(scope="module")
def jax_outcomes(tmp_path_factory):
    """The JAX package's factorize under each scenario's spec (and the
    floor's failure), on its own prepared run."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (spec, env) in SCENARIOS.items():
            d = tmp_path_factory.mktemp("jax_" + name)
            obj = _prepared(d, name, jax=True)
            mp.setenv(SPEC, spec)
            for key, val in env.items():
                mp.setenv(key, val)
            with _maybe_warns(name):
                obj.factorize()
            out[name] = _outcome(obj)
            for key in env:
                mp.delenv(key)
        d = tmp_path_factory.mktemp("jax_floor")
        obj = _prepared(d, "floor", jax=True)
        mp.setenv(SPEC, SCENARIOS["quarantine"][0])
        with pytest.warns(RuntimeWarning, match="quarantined"):
            with pytest.raises(jres.UnhealthySweepError):
                obj.factorize()
        out["floor"] = _outcome(obj)
    return out


def _maybe_warns(name):
    if name == "retry":
        return contextlib.nullcontext()
    return pytest.warns(RuntimeWarning, match="quarantined")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_factorize_under_a_fault_spec_matches_jax(fault_env, tmp_path,
                                                  jax_outcomes, name):
    spec, env = SCENARIOS[name]
    obj = _prepared(tmp_path, name)
    fault_env.setenv(SPEC, spec)
    for key, val in env.items():
        fault_env.setenv(key, val)
    with _maybe_warns(name):
        obj.factorize()
    got = _outcome(obj)
    assert got == jax_outcomes[name]
    info = obj.factorize_info
    assert info["written"] == {3: len(got[0])}
    assert info["retries"] == got[1][0]
    # combine skips a quarantined replicate without the flag
    merged = obj.combine_nmf(3)
    assert merged.shape == (3 * len(got[0]), 50)


def test_floor_raises_in_both_packages(fault_env, tmp_path, jax_outcomes):
    obj = _prepared(tmp_path, "floor")
    fault_env.setenv(SPEC, SCENARIOS["quarantine"][0])
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises(resilience.UnhealthySweepError,
                           match="too few healthy replicates"):
            obj.factorize()
    assert _outcome(obj) == jax_outcomes["floor"]
    # the CLI maps it to the distinct exit code
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises(SystemExit) as exc:
            cli_main(["factorize", "--output-dir", str(tmp_path), "--name",
                      "floor", "--device", "cpu"])
    assert exc.value.code == resilience.UNHEALTHY_EXIT_CODE
    # a resume cannot bypass the floor: the quarantine is carried
    with pytest.raises(resilience.UnhealthySweepError):
        obj.factorize(skip_completed_runs=True)


def test_f1_a_poisoned_lane_is_retried_not_dropped(fault_env, tmp_path):
    """Fault F1: the port used to report a diverged replicate, skip its
    file and leave a run whose combine raised on the missing file."""
    obj = _prepared(tmp_path, "f1", beta_loss="kullback-leibler")
    fault_env.setenv(SPEC, "nonfinite:k=3,iter=1")
    obj.factorize()
    assert os.path.exists(obj.paths["iter_spectra"] % (3, 1))
    (rec,) = obj.factorize_info["retries"]
    assert (rec["iter"], rec["attempt"], rec["healthy"]) == (1, 1, True)
    assert rec["derived_seed"] == rec["seed"] ^ 1
    merged = obj.combine_nmf(3)
    assert merged.shape == (9, 50) and np.isfinite(merged.values).all()


def test_combine_validates_and_skips_quarantined(fault_env, tmp_path):
    obj = _prepared(tmp_path, "comb")
    obj.factorize()
    fn = obj.paths["iter_spectra"] % (3, 2)
    with open(fn, "r+b") as f:
        f.truncate(os.path.getsize(fn) // 3)
    with pytest.raises(resilience.TornArtifactError,
                       match="skip_missing_files"):
        obj.combine_nmf(3)
    assert obj.combine_nmf(3, skip_missing_files=True).shape == (6, 50)
    os.remove(obj.paths["iter_spectra"] % (3, 1))
    with pytest.raises(FileNotFoundError):
        obj.combine_nmf(3, skip_missing_files=False)
    # a JAX-written ledger quarantines iter 1 and 2: combine skips both
    # without the flag, and trusts iter 0's valid file
    with open(obj.paths["resilience_ledger"] % 3, "w") as f:
        json.dump({"schema": 1, "retries": [],
                   "quarantined": [{"k": 3, "iter": it, "seed": 0,
                                    "attempts": 2} for it in (0, 1, 2)]},
                  f)
    merged = obj.combine_nmf(3)
    assert list(merged.index) == ["iter0_topic1", "iter0_topic2",
                                  "iter0_topic3"]


# ---------------------------------------------------------------------------
# resume: bit for bit the uninterrupted run
# ---------------------------------------------------------------------------

def _iter_bytes(obj, ks, n_iter):
    out = {}
    for k in ks:
        for it in range(n_iter):
            with np.load(obj.paths["iter_spectra"] % (k, it),
                         allow_pickle=True) as f:
                out[(k, it)] = (f["data"].tobytes(), f["data"].dtype)
    return out


@pytest.mark.parametrize("batched", [True, False])
def test_resume_after_a_torn_artifact_is_bit_identical(fault_env, tmp_path,
                                                       batched):
    ks = (3, 4)
    obj = _prepared(tmp_path, "torn", components=ks,
                    beta_loss="kullback-leibler")
    fault_env.setenv("CNMF_TPU_SPARSE_BETA", "1")     # the ELL lane
    obj.factorize(batched=batched)
    assert obj.factorize_info["lane"] == "ell"
    good = _iter_bytes(obj, ks, 3)
    # the parsed spec (and its injection count) is cached per raw value
    # for the process: each parameter sets its own
    fault_env.setenv(SPEC, "torn:artifact=k_4.iter_1" + ";" * (1 + batched))
    obj.factorize(batched=batched)       # writes every file, tears one
    fault_env.delenv(SPEC)
    assert resilience.probe_spectra_file(
        obj.paths["iter_spectra"] % (4, 1), k=4) is not None
    with pytest.warns(RuntimeWarning, match="failed validation"):
        obj.factorize(batched=batched, skip_completed_runs=True)
    # the batched lane reruns the whole K group, the sequential lane the
    # torn task only
    assert obj.factorize_info["jobs"] == (3 if batched else 1)
    assert _iter_bytes(obj, ks, 3) == good
    obj.factorize(batched=batched, skip_completed_runs=True)
    assert obj.factorize_info["jobs"] == 0


def test_sequential_lane_starts_from_the_batched_lanes_init(fault_env,
                                                          tmp_path):
    """On the ELL lane every ``run_nmf`` call of the sequential lane takes
    the batched sweep's init scale (``sweep_x_mean`` of the staged
    encoding, passed as ``x_mean``), so a seed starts both lanes from the
    same init, and on the CPU their objectives agree at ``rtol 1e-6``."""
    from cnmf_torch_tpu_torch.ops import nmf as tnmf
    from cnmf_torch_tpu_torch.parallel import replicates as trep

    obj = _prepared(tmp_path, "lanes", components=(3, 4),
                    beta_loss="kullback-leibler")
    fault_env.setenv("CNMF_TPU_SPARSE_BETA", "1")     # the ELL lane
    scales: list = []
    real = tnmf.random_init

    def draw(seed, n, g, k, x_mean, *a, **kw):
        scales.append((int(seed), int(k), float(x_mean)))
        return real(seed, n, g, k, x_mean, *a, **kw)

    fault_env.setattr(tnmf, "random_init", draw)
    fault_env.setattr(trep, "random_init", draw)
    runs = {}
    for batched in (False, True):
        scales.clear()
        obj.factorize(batched=batched)
        assert obj.factorize_info["lane"] == "ell"
        runs[batched] = (sorted(scales), dict(obj.factorize_info["errs"]))
    assert runs[False][0] == runs[True][0] and len(runs[True][0]) == 6
    for k in (3, 4):
        np.testing.assert_allclose(runs[False][1][k], runs[True][1][k],
                                   rtol=1e-6)


def test_resume_after_a_torn_artifact_matches_jax_tasks(fault_env,
                                                        tmp_path, capsys):
    """The same torn file makes both packages rerun the same tasks: the
    torn file's whole K group, read from the sweeps each one prints."""
    runs = {}
    for jax in (False, True):
        d = tmp_path / ("jax" if jax else "port")
        d.mkdir()
        obj = _prepared(d, "res", jax=jax, components=(3, 4))
        fault_env.setenv(SPEC, "torn:artifact=k_3.iter_2")
        obj.factorize()
        fault_env.delenv(SPEC)
        capsys.readouterr()
        with pytest.warns(RuntimeWarning, match="failed validation"):
            obj.factorize(skip_completed_runs=True)
        sweeps = re.findall(r"Running (\d+) replicates for k=(\d+)",
                            capsys.readouterr().out)
        runs[jax] = (sweeps, _outcome(obj, ks=(3, 4)))
    assert runs[False] == runs[True]
    assert runs[False][0] == [("3", "3")]
    assert len(runs[False][1][0]) == 6 and runs[False][1][1] is None


_KILL_RUN = r"""
import sys
sys.path.insert(0, {root!r})
from cnmf_torch_tpu_torch.cli import main
main(sys.argv[1:])
"""


def test_kill_resume_through_the_cli_is_bit_identical(tmp_path):
    """SIGKILL the port's CLI factorize after its first K (the ``kill``
    hook sits after a K's writes), resume with ``--skip-completed-runs``,
    and compare every iter file with an uninterrupted run's."""
    counts, rows, cols = _counts_df(seed=5)
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, rows, cols), fn)
    script = tmp_path / "run.py"
    script.write_text(_KILL_RUN.format(root=ROOT))
    env = {key: v for key, v in os.environ.items()
           if not key.startswith("CNMF_TPU_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)

    def cli(*args, extra=None):
        return subprocess.run(
            [sys.executable, str(script), *args, "--output-dir",
             str(tmp_path), "--device", "cpu"],
            env=dict(env, **(extra or {})), capture_output=True, text=True,
            timeout=300)

    for name in ("whole", "killed"):
        p = cli("prepare", "--name", name, "-c", fn, "-k", "3", "4", "-n",
                "3", "--seed", "4", "--numgenes", "50", "--beta-loss",
                "kullback-leibler", "--batch_size", "64")
        assert p.returncode == 0, p.stderr[-2000:]
    assert cli("factorize", "--name", "whole").returncode == 0
    sentinel = tmp_path / "kill.done"
    p = cli("factorize", "--name", "killed", extra={
        SPEC: f"kill:stage=factorize,worker=0,once={sentinel}"})
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    assert sentinel.exists()
    killed = cNMF(str(tmp_path), "killed", device="cpu")
    assert not os.path.exists(killed.paths["iter_spectra"] % (4, 0))
    p = cli("factorize", "--name", "killed", "--skip-completed-runs")
    assert p.returncode == 0, p.stderr[-2000:]
    whole = cNMF(str(tmp_path), "whole", device="cpu")
    assert _iter_bytes(killed, (3, 4), 3) == _iter_bytes(whole, (3, 4), 3)
    p = cli("factorize", "--name", "killed", "--skip-completed-runs",
            "--sequential")
    assert p.returncode == 0 and "nothing to resume" in p.stdout


def test_resume_honours_a_raised_retry_budget(fault_env, tmp_path):
    """A quarantine is final under the budget that made it and reruns on
    a resume under a larger one (the remedy its warning names)."""
    obj = _prepared(tmp_path, "budget")
    fault_env.setenv(SPEC, "nonfinite:k=3,iter=0")
    fault_env.setenv(resilience.MAX_RETRIES_ENV, "0")
    fault_env.setenv(resilience.MIN_HEALTHY_FRAC_ENV, "0.5")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        obj.factorize()
    obj.factorize(skip_completed_runs=True)
    assert obj.factorize_info["jobs"] == 0
    assert os.path.exists(obj.paths["resilience_ledger"] % 0)
    fault_env.delenv(SPEC)
    fault_env.setenv(resilience.MAX_RETRIES_ENV, "2")
    obj.factorize(skip_completed_runs=True)
    assert not os.path.exists(obj.paths["resilience_ledger"] % 0)
    assert obj.combine_nmf(3).shape == (9, 50)
    assert load_df_from_npz(obj.paths["iter_spectra"] % (3, 0)).shape \
        == (3, 50)
