"""The port's staging pipeline (``parallel/streaming.py``) against the JAX
package's engine and its tests (``tests/test_streaming.py``): the
sliding window commits in order within its depth, the serial fallbacks,
retries, their exhaustion, the stall watchdog (which leaves retry backoff
out of its budget and stops abandoned workers), the ``stall`` fault hook
through a real staging call, the knobs' parsing against the JAX
package's, and the staged matrices bit for bit the host matrix (CSR slabs
densify without accumulation; ragged, skewed and empty slabs).
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.parallel import streaming as jst
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.parallel import streaming as tst


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _skewed_csr(n=97, g=31, seed=5):
    """One dense row, empty rows and a ragged tail."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=0.08, random_state=int(seed), format="lil")
    X[3, :] = rng.random(g) + 0.5
    X[n - 1, :] = 0.0
    X[n // 2, :] = 0.0
    return sp.csr_matrix(X).astype(np.float32)


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, t, **kw):
        self.events.append(dict(kw, t=t))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,threads", [(3, 2), (2, 4), (5, 1)])
def test_run_pipeline_commits_in_order_and_bounds_depth(depth, threads):
    seen, in_flight, max_in_flight = [], [0], [0]
    lock = threading.Lock()

    def prep(i):
        with lock:
            in_flight[0] += 1
            max_in_flight[0] = max(max_in_flight[0], in_flight[0])
        return i * i

    def commit(i, payload):
        with lock:
            in_flight[0] -= 1
        seen.append((i, payload))

    tst.run_pipeline(range(20), prep, commit, depth=depth, threads=threads)
    assert seen == [(i, i * i) for i in range(20)]
    assert max_in_flight[0] <= depth


@pytest.mark.parametrize("kw", [{"depth": 1, "threads": 4},
                                {"depth": 8, "threads": 0}])
def test_run_pipeline_serial_fallbacks(kw):
    seen = []
    tst.run_pipeline(range(5), lambda i: -i, lambda i, p: seen.append(p),
                     **kw)
    assert seen == [0, -1, -2, -3, -4]


def test_run_pipeline_with_a_disk_stage_reads_once_a_task():
    reads = []

    def source(i):
        reads.append(i)
        return 10 * i

    seen = []
    tst.run_pipeline(range(7), lambda i, raw: raw + i,
                     lambda i, p: seen.append(p), depth=3, threads=2,
                     source=source)
    assert seen == [11 * i for i in range(7)]
    assert sorted(reads) == list(range(7))


def test_run_pipeline_propagates_prep_errors():
    def prep(i):
        if i == 3:
            raise KeyboardInterrupt
        return i

    with pytest.raises(KeyboardInterrupt):
        tst.run_pipeline(range(8), prep, lambda i, p: None, depth=2,
                         threads=2)


@pytest.mark.parametrize("nnz,cap", [(0, 10_000), (1025, 10_000),
                                     (900_000, 10_000), (5, 100),
                                     (4097, 1 << 62)])
def test_nnz_bucket_matches_the_jax_package(nnz, cap):
    assert tst.nnz_bucket(nnz, cap) == jst.nnz_bucket(nnz, cap)


def test_slab_buffer_pool_zeroes_stale_tail():
    pool = tst.SlabBufferPool()
    b = pool.take((8,), np.float32)
    tst.SlabBufferPool.fill(b, np.array([1, 2, 3, 4, 5], np.float32))
    pool.give(b)
    b2 = pool.take((8,), np.float32)
    assert b2 is b
    out = tst.SlabBufferPool.fill(b2, np.array([9, 9], np.float32))
    np.testing.assert_array_equal(out, [9, 9, 0, 0, 0, 0, 0, 0])
    # the numpy view and the tensor a copy reads are one buffer
    assert b2.tensor[:2].tolist() == [9.0, 9.0]
    assert pool.allocated == 1


@pytest.mark.parametrize("env", [
    {"CNMF_TPU_STREAM_THREADS": "3", "CNMF_TPU_STREAM_DEPTH": "7"},
    {"CNMF_TPU_STREAM_THREADS": "3", "CNMF_TPU_STREAM_BYTES": "100"},
    {"CNMF_TPU_STREAM_THREADS": "2", "CNMF_TPU_STREAM_BYTES": str(1 << 40)},
    {"CNMF_TPU_STREAM_THREADS": "0", "CNMF_TPU_STREAM_DEPTH": "1"},
])
def test_stream_knobs_match_the_jax_package(monkeypatch, env):
    monkeypatch.setenv("CNMF_TPU_AUTOTUNE", "0")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tst.stream_threads() == jst.stream_threads()
    for slab in (None, 1, 60, 1 << 20):
        for windows in (1, 2):
            assert (tst.stream_depth(slab_bytes=slab, windows=windows)
                    == jst.stream_depth(slab_bytes=slab, windows=windows))


@pytest.mark.parametrize("env,val,fn", [
    ("CNMF_TPU_STREAM_DEPTH", "0", "stream_depth"),
    ("CNMF_TPU_STREAM_DEPTH", "soon", "stream_depth"),
    ("CNMF_TPU_STREAM_THREADS", "-1", "stream_threads"),
    ("CNMF_TPU_STREAM_THREADS", "many", "stream_threads"),
    ("CNMF_TPU_SHARD_RETRIES", "-2", "shard_retries"),
    ("CNMF_TPU_STREAM_STALL_S", "-1", "stream_stall_s"),
    ("CNMF_TPU_STREAM_STALL_S", "later", "stream_stall_s"),
])
def test_stream_knob_validation(monkeypatch, env, val, fn):
    monkeypatch.setenv(env, val)
    with pytest.raises(ValueError, match=env):
        getattr(tst, fn)()


# ---------------------------------------------------------------------------
# retries and the stall watchdog
# ---------------------------------------------------------------------------

def test_shard_retry_recovers_transient_failures(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_SHARD_BACKOFF_S", "0")
    fails = {"n": 0}

    def prep(i):
        if i == 3 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("transient wire fault")
        return i

    seen = []
    events = _Events()
    with pytest.warns(RuntimeWarning, match="retrying"):
        tst.run_pipeline(range(6), prep, lambda i, p: seen.append(p),
                         depth=2, threads=2, fault_context="test",
                         events=events)
    assert seen == list(range(6))
    assert [e["kind"] for e in events.events
            if e["t"] == "fault"] == ["shard_retry", "shard_retry"]


def test_shard_retry_exhaustion_raises(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_SHARD_BACKOFF_S", "0")
    monkeypatch.setenv("CNMF_TPU_SHARD_RETRIES", "1")

    def prep(i):
        if i == 1:
            raise RuntimeError("permanent")
        return i

    events = _Events()
    with pytest.warns(RuntimeWarning):
        with pytest.raises(tst.ShardUploadError,
                           match="CNMF_TPU_SHARD_RETRIES"):
            tst.run_pipeline(range(4), prep, lambda i, p: None, depth=2,
                             threads=2, fault_context="test", events=events)
    assert [e["kind"] for e in events.events if e["t"] == "fault"] == [
        "shard_retry", "shard_upload_failed"]
    monkeypatch.setenv("CNMF_TPU_SHARD_RETRIES", "0")
    with pytest.raises(tst.ShardUploadError):
        tst.run_pipeline(range(4), prep, lambda i, p: None, depth=1,
                         threads=0)


def test_a_torn_slab_is_not_retried_as_an_upload_fault(monkeypatch):
    from cnmf_torch_tpu_torch.utils.shardstore import TornShardError

    calls = []

    def prep(i):
        calls.append(i)
        raise TornShardError("slab failed its digest")

    with pytest.raises(TornShardError):
        tst.run_pipeline(range(3), prep, lambda i, p: None, depth=1,
                         threads=0)
    assert calls == [0]


def test_stall_watchdog_converts_hang(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_STREAM_STALL_S", "0.3")

    def prep(i):
        if i == 0:
            time.sleep(2.0)
        return i

    events = _Events()
    t0 = time.monotonic()
    with pytest.raises(tst.ShardStallError, match="CNMF_TPU_STREAM_STALL_S"):
        tst.run_pipeline(range(4), prep, lambda i, p: None, depth=2,
                         threads=2, fault_context="test", events=events)
    assert time.monotonic() - t0 < 1.5
    assert any(e["t"] == "fault" and e["kind"] == "shard_stall"
               for e in events.events)


def test_stall_watchdog_excludes_retry_backoff(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_STREAM_STALL_S", "0.6")
    monkeypatch.setenv("CNMF_TPU_SHARD_RETRIES", "2")
    monkeypatch.setenv("CNMF_TPU_SHARD_BACKOFF_S", "0.4")
    fails = {"n": 0}

    def prep(i):
        if i == 1 and fails["n"] < 2:
            fails["n"] += 1
            time.sleep(0.3)
            raise RuntimeError("transient")
        return i

    seen = []
    with pytest.warns(RuntimeWarning):
        tst.run_pipeline(range(4), prep, lambda i, p: seen.append(p),
                         depth=2, threads=2, fault_context="t")
    assert seen == [0, 1, 2, 3]


def test_abandoned_worker_skips_fresh_prep_after_stall(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "stall:context=zombie,seconds=0.8")
    monkeypatch.setenv("CNMF_TPU_STREAM_STALL_S", "0.2")
    ran = []

    def prep(i):
        ran.append(i)
        return i

    with pytest.raises(tst.ShardStallError):
        tst.run_pipeline(range(4), prep, lambda i, p: None, depth=2,
                         threads=1, fault_context="zombie")
    n_at_abort = len(ran)
    time.sleep(1.2)
    assert len(ran) == n_at_abort, "abandoned worker started fresh prep"


def test_stall_fault_injection_through_staging(monkeypatch):
    monkeypatch.setattr(tst, "SLAB_ROWS", 8)
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "stall:context=stream_csr,seconds=3")
    monkeypatch.setenv("CNMF_TPU_STREAM_STALL_S", "0.3")
    monkeypatch.setenv("CNMF_TPU_STREAM_THREADS", "2")
    X = _skewed_csr(n=64, g=16, seed=2)
    t0 = time.monotonic()
    with pytest.raises(tst.ShardStallError):
        trs.stream_rows_to_mesh(X, "cpu")
    assert time.monotonic() - t0 < 2.0
    monkeypatch.delenv("CNMF_TPU_FAULT_SPEC")
    monkeypatch.delenv("CNMF_TPU_STREAM_STALL_S")
    Xd, pad = trs.stream_rows_to_mesh(X, "cpu")
    assert pad == 0
    np.testing.assert_array_equal(Xd.numpy(), X.toarray())


def test_the_upload_fault_fails_the_staging_entry(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "upload:context=stream_rows_to_mesh")
    with pytest.raises(RuntimeError, match="injected fault: upload"):
        trs.stream_rows_to_mesh(np.ones((4, 3), np.float32), "cpu")


# ---------------------------------------------------------------------------
# staged matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slab_rows", [1, 8, 13, 1000])
@pytest.mark.parametrize("depth", ["1", "5"])
def test_csr_staging_is_the_dense_matrix(monkeypatch, slab_rows, depth):
    monkeypatch.setattr(tst, "SLAB_ROWS", slab_rows)
    monkeypatch.setenv("CNMF_TPU_STREAM_DEPTH", depth)
    X = _skewed_csr()
    stats = tst.StreamStats()
    out = tst.stream_to_device(X, "cpu", pad_rows=3, stats=stats)
    assert out.dtype == torch.float32 and out.shape == (X.shape[0] + 3,
                                                        X.shape[1])
    np.testing.assert_array_equal(out[:X.shape[0]].numpy(), X.toarray())
    assert not out[X.shape[0]:].any()
    assert stats.slabs == -(-X.shape[0] // slab_rows)
    assert stats.nbytes == sum(
        a.nbytes for lo in range(0, X.shape[0], slab_rows)
        for a in tst._csr_parts(X[lo:lo + slab_rows], np.float32))


@pytest.mark.parametrize("slab_rows", [7, 1000])
def test_dense_staging_is_the_matrix(monkeypatch, slab_rows):
    monkeypatch.setattr(tst, "SLAB_ROWS", slab_rows)
    X = np.random.default_rng(0).random((50, 9)).astype(np.float64)
    out = tst.stream_to_device(X, "cpu")
    np.testing.assert_array_equal(out.numpy(), X.astype(np.float32))


def test_an_empty_matrix_stages(monkeypatch):
    out = tst.stream_to_device(sp.csr_matrix((0, 5), dtype=np.float32),
                               "cpu", pad_rows=2)
    assert out.shape == (2, 5) and not out.any()


def test_put_arrays_keeps_order_and_values():
    arrays = [np.arange(10, dtype=np.int32), np.ones((3, 4), np.float32),
              np.zeros(0, np.float32)]
    stats = tst.StreamStats()
    out = tst.put_arrays(arrays, "cpu", stats=stats)
    for a, t in zip(arrays, out):
        assert t.shape == a.shape and np.array_equal(t.numpy(), a)
    assert stats.nbytes == sum(a.nbytes for a in arrays)


def test_stream_stats_overlap_and_the_stream_event(tmp_path, monkeypatch):
    from cnmf_torch_tpu_torch.utils.telemetry import (EventLog,
                                                      validate_events_file)

    st = tst.StreamStats()
    assert st.overlap_fraction == 0.0
    st.add(host_prep_s=1.0, h2d_s=1.0, device_s=1.0, disk_s=1.0,
           disk_nbytes=10 ** 9, nbytes=2 * 10 ** 9, slabs=4)
    st.wall_s = 2.0
    st.host_peak_bytes = 123
    assert st.overlap_fraction == pytest.approx(0.5)
    assert st.gb_per_s() == pytest.approx(1.0)
    assert st.read_gb_per_s() == pytest.approx(1.0)
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    path = str(tmp_path / "ev.jsonl")
    log = EventLog(path, device="cpu")
    log.emit_stream("rowshard_stage_x", st)
    assert validate_events_file(path) == 2
    from cnmf_torch_tpu.utils.telemetry import validate_events_file as jval

    assert jval(path) == 2


def test_an_encoding_past_int32_slots_is_refused(monkeypatch):
    """perm_t holds int32 row-side slot positions: an encoding of 2**31
    slots or more is refused before any buffer is allocated, and the
    W-numerator wrapper refuses such a shape."""
    from cnmf_torch_tpu_torch.ops import sparse as tsp
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    X = sp.csr_matrix(np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tsp.csr_to_ell(X, width=2 ** 29)
    x = tsp.csr_to_ell(X)
    wide = 2 ** 29   # zero-stride views: nothing of this size is allocated
    monkeypatch.setattr(kl_ell, "_check", lambda *a, **k: None)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        kl_ell.w_numer(torch.zeros(1).expand(4, wide),
                       torch.zeros(1, dtype=torch.int32).expand(4, wide),
                       torch.as_tensor(x.rows_t), torch.as_tensor(x.perm_t),
                       torch.ones((1, 4, 2)), torch.ones((1, 2, 3)))


def test_the_pipeline_s_shared_state_under_thread_stress():
    """More workers than cores and a short switch interval: the stats
    ledger, the buffer pool and the residency ledger lose no update."""
    import sys

    from cnmf_torch_tpu_torch.utils.shardstore import HostResidency

    stats = tst.StreamStats()
    pool = tst.SlabBufferPool()
    led = HostResidency()
    n_tasks = 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def prep(i):
            buf = pool.take((16,), np.float32)
            tst.SlabBufferPool.fill(buf, np.full(i % 16, i, np.float32))
            led.charge(3)
            stats.add(host_prep_s=1.0, nbytes=2, slabs=1)
            pool.give(buf)
            led.release(3)
            return i

        seen = []
        tst.run_pipeline(range(n_tasks), prep, lambda i, p: seen.append(p),
                         depth=64, threads=32)
    finally:
        sys.setswitchinterval(old)
    assert seen == list(range(n_tasks))
    assert (stats.slabs, stats.nbytes, stats.host_prep_s) == (
        n_tasks, 2 * n_tasks, float(n_tasks))
    assert led.live == 0 and 3 <= led.peak <= 3 * 32
    assert 1 <= pool.allocated <= 32
