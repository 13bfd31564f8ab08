"""The port's solver-recipe resolution against the JAX package's.

The same arguments and the same environment must resolve the same recipe
(every field) or raise the same error in both packages. The JAX package
reads a per-device autotune cache that the port does not have; the tests
turn it off (``CNMF_TPU_AUTOTUNE=0``), which is the JAX package's own
behaviour when no cache exists.
"""

import itertools

import pytest

from cnmf_torch_tpu.ops import recipe as jrec
from cnmf_torch_tpu_torch.ops import recipe as trec

KNOBS = ("CNMF_TPU_ACCEL", "CNMF_TPU_KL_NEWTON", "CNMF_TPU_INNER_REPEATS",
         "CNMF_TPU_SKETCH", "CNMF_TPU_SKETCH_DIM",
         "CNMF_TPU_SKETCH_EXACT_EVERY")


@pytest.fixture
def clean_env(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CNMF_TPU_AUTOTUNE", "0")
    return monkeypatch


def _fields(r):
    return (r.algo, r.inner_repeats, r.kl_newton, r.source, r.sketch_dim,
            r.sketch_exact_every, r.label)


def _both(**kw):
    """Resolve in both packages: ``("ok", fields)`` or ``("error", type,
    message)``, asserted equal."""
    out = []
    for mod in (jrec, trec):
        try:
            out.append(("ok", _fields(mod.resolve_recipe(**kw))))
        except ValueError as e:
            out.append(("error", type(e).__name__, str(e)))
    assert out[0] == out[1], (kw, out)
    return out[0]


SHAPES = [dict(), dict(n=1000, g=500, k=8),
          dict(n=1000, g=500, k=8, ell=True, ell_width=64),
          dict(ell=True)]
ENVS = [{}, {"CNMF_TPU_ACCEL": "0"}, {"CNMF_TPU_ACCEL": "1"},
        {"CNMF_TPU_ACCEL": "auto"}, {"CNMF_TPU_ACCEL": "On"},
        {"CNMF_TPU_ACCEL": "1", "CNMF_TPU_KL_NEWTON": "0"},
        {"CNMF_TPU_ACCEL": "1", "CNMF_TPU_KL_NEWTON": "0",
         "CNMF_TPU_INNER_REPEATS": "5"},
        {"CNMF_TPU_ACCEL": "auto", "CNMF_TPU_INNER_REPEATS": "auto"},
        {"CNMF_TPU_SKETCH": "1"},
        {"CNMF_TPU_SKETCH": "1", "CNMF_TPU_SKETCH_DIM": "300",
         "CNMF_TPU_SKETCH_EXACT_EVERY": "2"},
        {"CNMF_TPU_SKETCH": "auto", "CNMF_TPU_ACCEL": "1"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k[9:]}={v}" for k, v in e.items()) or "unset")
def test_resolution_grid_matches_jax(clean_env, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    seen = set()
    for beta, mode, algo, shape in itertools.product(
            (2.0, 1.0, 0.0), ("batch", "online", "rowshard"),
            ("mu", "halsvar"), SHAPES):
        seen.add(_both(beta=beta, mode=mode, algo=algo, **shape)[:2])
    assert ("ok",) == tuple({s[0] for s in seen})


@pytest.mark.parametrize("kw", [
    dict(accel="1"), dict(accel="0"), dict(accel="auto", kl_newton=False),
    dict(accel="1", kl_newton=False, inner_repeats=4),
    dict(sketch="1", sketch_dim=128, sketch_exact_every=3),
    dict(sketch="1", accel="1"), dict(accel="1", kl_newton=True)],
    ids=str)
def test_caller_arguments_win_like_jax(clean_env, kw):
    clean_env.setenv("CNMF_TPU_ACCEL", "0")
    clean_env.setenv("CNMF_TPU_SKETCH", "1")
    for beta, mode in itertools.product((1.0, 0.0, 2.0),
                                        ("batch", "online")):
        _both(beta=beta, mode=mode, n=400, **kw)


@pytest.mark.parametrize("env", [
    {"CNMF_TPU_ACCEL": "bogus"}, {"CNMF_TPU_SKETCH": "maybe"},
    {"CNMF_TPU_ACCEL": "1", "CNMF_TPU_KL_NEWTON": "0",
     "CNMF_TPU_INNER_REPEATS": "lots"},
    {"CNMF_TPU_ACCEL": "1", "CNMF_TPU_KL_NEWTON": "0",
     "CNMF_TPU_INNER_REPEATS": "-2"},
    {"CNMF_TPU_SKETCH": "1", "CNMF_TPU_SKETCH_DIM": "x"},
    {"CNMF_TPU_SKETCH": "1", "CNMF_TPU_SKETCH_EXACT_EVERY": "0"}],
    ids=lambda e: ",".join(f"{k[9:]}={v}" for k, v in e.items()))
def test_bad_knob_words_raise_the_same_error(clean_env, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    out = _both(beta=1.0, mode="batch", n=400)
    assert out[0] == "error"


def test_unknown_algo_and_recipe_fields_raise_like_jax(clean_env):
    assert _both(beta=1.0, mode="batch", algo="nope")[0] == "error"
    for args in [("nope",), ("amu", 0), ("mu", 1, True), ("sketch",),
                 ("sketch", 1, False, "env", 5, 0), ("mu", 1, False,
                                                     "env", 3)]:
        errs = []
        for mod in (jrec, trec):
            with pytest.raises(ValueError) as e:
                mod.SolverRecipe(*args)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_auto_inner_repeats_and_sketch_rows_match_jax(clean_env):
    for beta, n, g, k, width, ell in itertools.product(
            (2.0, 1.0, 0.0), (None, 300, 5000), (None, 80, 2000),
            (None, 4, 13), (None, 16, 184), (False, True)):
        assert (trec.auto_inner_repeats(beta, n, g, k, width, ell)
                == jrec.auto_inner_repeats(beta, n, g, k, width, ell))
    for n in (None, 0, 100, 1000, 5000, 100_000):
        assert trec.auto_sketch_rows(n) == jrec.auto_sketch_rows(n)


MULTI_DEVICE_KNOBS = (
    "CNMF_TPU_GRID_OVERLAP", "CNMF_TPU_GRID_BLOCKS", "CNMF_TPU_GRID_SHAPE",
    "CNMF_TPU_BARRIER_TIMEOUT_S", "CNMF_TPU_WORKER_TIMEOUT",
    "CNMF_TPU_WORKER_RESPAWNS", "CNMF_TPU_WORKER_BACKOFF_S",
    "CNMF_TPU_ELASTIC", "CNMF_TPU_HEARTBEAT_S", "CNMF_TPU_STRAGGLER_S",
    "CNMF_TPU_MIN_DEVICES", "CNMF_COORDINATOR_ADDRESS",
    "CNMF_NUM_PROCESSES", "CNMF_PROCESS_ID", "CNMF_SIM_CPU_DEVICES")


def test_the_port_reads_no_unregistered_knob():
    from cnmf_torch_tpu_torch.utils import envknobs

    with pytest.raises(ValueError, match="not one the port reads"):
        envknobs.env_str("CNMF_TPU_SOMETHING_ELSE")
    # the recipe knobs, the lane, precision and budget knobs that
    # tests/test_torch_knobs.py holds against the JAX package, the
    # fault and retry knobs of tests/test_torch_resilience.py, and the
    # telemetry base's knobs of tests/test_torch_telemetry.py, and the
    # out-of-core layer's of tests/test_torch_shardstore.py,
    # test_torch_streaming.py and test_torch_checkpoint.py, and the
    # remote store's and the cost model's of tests/test_torch_remote.py
    # and test_torch_regress.py, and the multi-device layer's of
    # tests/test_torch_elastic.py
    assert set(KNOBS) | {"CNMF_TPU_SPARSE_BETA", "CNMF_TPU_BF16_RATIO",
                         "CNMF_TPU_BUDGET_ELEMS", "CNMF_TPU_FAULT_SPEC",
                         "CNMF_TPU_MAX_RETRIES",
                         "CNMF_TPU_MIN_HEALTHY_FRAC",
                         "CNMF_TPU_TELEMETRY", "CNMF_TPU_PROFILE_DIR",
                         "CNMF_TPU_METRICS", "CNMF_TPU_TRACE_SAMPLE",
                         "CNMF_TPU_TRACE_CTX", "CNMF_TPU_SLO_P99_MS",
                         "CNMF_TPU_SLO_WINDOW_S", "CNMF_TPU_OOC",
                         "CNMF_TPU_OOC_BUDGET_BYTES", "CNMF_TPU_OOC_SLAB_ROWS",
                         "CNMF_TPU_OOC_SHARD_BYTES", "CNMF_TPU_SHARD_RETRIES",
                         "CNMF_TPU_SHARD_BACKOFF_S",
                         "CNMF_TPU_CKPT_EVERY_PASSES", "CNMF_TPU_CKPT_H_BYTES",
                         "CNMF_TPU_CKPT_MIN_INTERVAL_S",
                         "CNMF_TPU_STREAM_DEPTH", "CNMF_TPU_STREAM_THREADS",
                         "CNMF_TPU_STREAM_BYTES", "CNMF_TPU_STREAM_STALL_S",
                         "CNMF_TPU_STORE_URI", "CNMF_TPU_STORE_RETRIES",
                         "CNMF_TPU_STORE_BACKOFF_S", "CNMF_TPU_STORE_TIMEOUT_S",
                         "CNMF_TPU_STORE_HEDGE_S", "CNMF_TPU_STORE_CACHE_BYTES",
                         "CNMF_TPU_PERF_MODEL",
                         "CNMF_TPU_PERF_GATE_BAND"} | set(
        MULTI_DEVICE_KNOBS) == set(envknobs.KNOBS)
