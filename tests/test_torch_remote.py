"""The port's remote object store (``utils/storebackend.py:RemoteBackend``,
``utils/netstore.py``, ``runtime/faults.py:maybe_netfault``) against the
JAX package's.

The counterparts of ``tests/test_shardstore_remote.py``'s twenty tests
(local-against-remote parity of the stored and staged bytes, the retry,
backoff and hedge ladder under the four network faults, the read-through
cache, the URI dispatch and the degradation contract), then the
cross-package checks on one fixture server: both packages write the same
objects byte for byte and fill the same cache, each stages the other's
store to the same matrix, ``backoff_delay`` and the fault hook agree, and
the port's prepare -> factorize -> consensus through an ``http://`` store
(from the knob or ``--store-uri``, and from a JAX-written store) writes
the local-store run's iter spectra bit for bit. Every comparison is
exact.

Every server binds ``127.0.0.1:0``; every test sets short timeouts and
backoffs, and no request waits on a socket for more than a few seconds.
"""

import os
import threading
import time
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.runtime import faults as jfaults
from cnmf_torch_tpu.utils import shardstore as jss
from cnmf_torch_tpu.utils import storebackend as jbk
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.runtime import faults
from cnmf_torch_tpu_torch.utils.netstore import ObjectStoreServer
from cnmf_torch_tpu_torch.utils.shardstore import (
    RemoteStoreError,
    open_shard_store,
    probe_shard_store,
    sweep_store_temps,
    write_shard_store,
)
from cnmf_torch_tpu_torch.utils.storebackend import (
    STORE_URI_ENV,
    LocalBackend,
    RemoteBackend,
    _reset_degraded_warnings,
    backend_counter_snapshot,
    backoff_delay,
    resolve_backend,
    store_cache_dir,
    store_retries,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _dense(n=219, g=37, seed=0):
    return np.abs(np.random.default_rng(seed).random((n, g))
                  ).astype(np.float32)


def _csr(n=219, g=37, seed=1, density=0.15):
    X = sp.random(n, g, density=density, format="lil", random_state=seed)
    X[40:60, :] = 0.0
    X[n - 1, :] = 0.0
    return sp.csr_matrix(X).astype(np.float32)


def _set_spec(monkeypatch, spec):
    """Install a fault spec after flushing both packages' parse caches
    (keyed on the raw value: a spec string an earlier test used would
    otherwise keep its exhausted counters)."""
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC", "")
    faults.maybe_netfault(op="flush", context="flush")
    jfaults.maybe_netfault(op="flush", context="flush")
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC", spec)


@pytest.fixture()
def srv():
    with ObjectStoreServer() as s:
        yield s


@pytest.fixture()
def remote_env(srv, monkeypatch):
    monkeypatch.setenv(STORE_URI_ENV, srv.url + "/t")
    monkeypatch.setenv("CNMF_TPU_STORE_BACKOFF_S", "0.01")
    monkeypatch.setenv("CNMF_TPU_STORE_TIMEOUT_S", "5")
    monkeypatch.delenv("CNMF_TPU_FAULT_SPEC", raising=False)
    _reset_degraded_warnings()
    jbk._reset_degraded_warnings()
    yield srv
    _reset_degraded_warnings()
    jbk._reset_degraded_warnings()


def _names(n, g):
    return [f"c{i}" for i in range(n)], [f"g{j}" for j in range(g)]


def _write_both(tmp_path, monkeypatch, url, X, slab_rows=50):
    obs, var = _names(*X.shape)
    monkeypatch.delenv(STORE_URI_ENV, raising=False)
    write_shard_store(tmp_path / "local.store", X, slab_rows=slab_rows,
                      obs_names=obs, var_names=var)
    local = open_shard_store(tmp_path / "local.store")
    monkeypatch.setenv(STORE_URI_ENV, url)
    write_shard_store(tmp_path / "remote.store", X, slab_rows=slab_rows,
                      obs_names=obs, var_names=var)
    remote = open_shard_store(tmp_path / "remote.store")
    assert remote.backend.kind == "remote"
    return local, remote


# ---------------------------------------------------------------------------
# local against remote: stored and staged bytes
# ---------------------------------------------------------------------------

def test_remote_bit_parity_dense_ragged(tmp_path, monkeypatch, remote_env):
    X = _dense()  # 219 rows at 50 a slab: a ragged 19-row last slab
    local, remote = _write_both(tmp_path, monkeypatch,
                                remote_env.url + "/t", X)
    assert len(remote.slabs) == 5
    assert local.manifest["store_digest"] == remote.manifest["store_digest"]
    for i in range(len(local.slabs)):
        assert np.array_equal(np.asarray(local.read_slab(i)),
                              np.asarray(remote.read_slab(i)))
    assert local.obs_names() == remote.obs_names()
    assert local.var_names() == remote.var_names()


def test_remote_bit_parity_csr_zero_slab(tmp_path, monkeypatch, remote_env):
    X = _csr()
    local, remote = _write_both(tmp_path, monkeypatch,
                                remote_env.url + "/t", X, slab_rows=20)
    assert remote.slabs[2]["nnz"] == 0  # the all-zero row band
    for i in range(len(local.slabs)):
        a, b = local.read_slab(i), remote.read_slab(i)
        assert np.array_equal(a.toarray(), b.toarray())


def test_remote_staging_bit_parity(tmp_path, monkeypatch, remote_env):
    """The staged tensors, dense rows and the dual ELL encoding, are the
    same bits whether the slabs came over HTTP or from disk."""
    X = _csr()
    local, remote = _write_both(tmp_path, monkeypatch,
                                remote_env.url + "/t", X, slab_rows=60)
    A, pad_a = trs.stream_rows_to_mesh(local, "cpu", pad_multiple=4)
    B, pad_b = trs.stream_rows_to_mesh(remote, "cpu", pad_multiple=4)
    assert pad_a == pad_b
    assert torch.equal(A, B)
    E1, _ = trs.stream_ell_to_mesh(local, "cpu")
    E2, _ = trs.stream_ell_to_mesh(remote, "cpu")
    assert E1.width == E2.width
    for leaf in ("vals", "cols", "rows_t", "perm_t"):
        assert torch.equal(getattr(E1, leaf), getattr(E2, leaf))


# ---------------------------------------------------------------------------
# retry, backoff and hedging
# ---------------------------------------------------------------------------

def test_backoff_delay_deterministic():
    a1 = backoff_delay("slab_00001.npz", 1, base=0.1)
    assert a1 == backoff_delay("slab_00001.npz", 1, base=0.1)
    assert backoff_delay("slab_00001.npz", 3, base=0.1) > a1
    assert a1 != backoff_delay("slab_00002.npz", 1, base=0.1)
    assert 0.1 <= a1 < 0.15


@pytest.mark.parametrize("name", ["slab_00000.npz", "slab_00417.npz",
                                  "manifest.json", "names.npz", "list",
                                  "a b/ü.npz", ""])
@pytest.mark.parametrize("attempt", [1, 2, 3, 7])
@pytest.mark.parametrize("base", [None, 0.05, 0.001, 1.5])
def test_backoff_delay_equals_jax(monkeypatch, name, attempt, base):
    monkeypatch.setenv("CNMF_TPU_STORE_BACKOFF_S", "0.02")
    assert backoff_delay(name, attempt, base) == \
        jbk.backoff_delay(name, attempt, base)


def test_netflake_heals_with_retry(tmp_path, monkeypatch, remote_env):
    monkeypatch.setenv("CNMF_TPU_OOC_SLAB_ROWS", "32")
    X = _dense(100, 20)
    write_shard_store(tmp_path / "st", X)
    _set_spec(monkeypatch, "netflake:context=get:slab")
    store = open_shard_store(tmp_path / "st")
    (block,) = store._load_arrays(store.slabs[0]["file"], refresh=True)
    assert np.array_equal(block, X[:32])
    snap = backend_counter_snapshot(store)
    assert snap["retries"] >= 1 and snap["healed"] >= 1


def test_netdown_exhausts_budget_with_named_error(tmp_path, monkeypatch,
                                                  remote_env):
    monkeypatch.setenv("CNMF_TPU_STORE_RETRIES", "2")
    monkeypatch.setenv("CNMF_TPU_STORE_CACHE_BYTES", "0")
    X = _dense(64, 10)
    write_shard_store(tmp_path / "st", X)
    store = open_shard_store(tmp_path / "st")
    _set_spec(monkeypatch, "netdown:context=get:slab")
    with pytest.raises(RemoteStoreError) as ei:
        store.read_slab(0)
    msg = str(ei.value)
    assert "CNMF_TPU_STORE_RETRIES" in msg
    assert "CNMF_TPU_STORE_URI" in msg
    assert "3 attempt(s)" in msg
    assert not isinstance(ei.value, OSError)


def test_hedge_wins_against_slow_primary(tmp_path, monkeypatch, remote_env):
    monkeypatch.setenv("CNMF_TPU_OOC_SLAB_ROWS", "32")
    monkeypatch.setenv("CNMF_TPU_STORE_HEDGE_S", "0.1")
    X = _dense(64, 10)
    write_shard_store(tmp_path / "st", X)
    store = open_shard_store(tmp_path / "st")
    # only the first slab GET stalls (netslow fires once by default); the
    # hedge issued after 0.1 s answers at full speed
    _set_spec(monkeypatch, "netslow:context=get:slab,seconds=1.5")
    t0 = time.perf_counter()
    raw = store.backend.get(store.slabs[0]["file"], refresh=True)
    waited = time.perf_counter() - t0
    assert raw and waited < 1.0
    snap = backend_counter_snapshot(store)
    assert snap["hedges"] == 1 and snap["hedges_won"] == 1


def test_nettorn_response_healed_by_reread(tmp_path, monkeypatch,
                                           remote_env):
    monkeypatch.setenv("CNMF_TPU_OOC_SLAB_ROWS", "32")
    X = _dense(64, 10)
    write_shard_store(tmp_path / "st", X)
    store = open_shard_store(tmp_path / "st")
    _set_spec(monkeypatch, "nettorn:context=get:slab")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = np.asarray(store.read_slab(0))
    assert np.array_equal(got, X[:32])
    assert any("re-reading" in str(x.message) for x in w)


def test_404_is_file_not_found_without_retry(remote_env):
    bk = RemoteBackend(remote_env.url + "/empty")
    with pytest.raises(FileNotFoundError):
        bk.get("nope.npz")
    assert backend_counter_snapshot(bk)["retries"] == 0
    assert bk.exists("nope.npz") is False


# ---------------------------------------------------------------------------
# the read-through cache
# ---------------------------------------------------------------------------

def _cached_backend(srv, tmp_path, prefix="c", cache="cache"):
    return RemoteBackend(srv.url + "/" + prefix,
                         cache_dir=str(tmp_path / cache))


def test_cache_hit_skips_network(tmp_path, remote_env):
    bk = _cached_backend(remote_env, tmp_path)
    bk.put("a", b"payload-a")
    assert bk.get("a") == b"payload-a"
    with remote_env.lock:
        remote_env.objects.clear()
    assert bk.get("a") == b"payload-a"
    snap = backend_counter_snapshot(bk)
    assert snap["cache_hits"] == 1 and snap["cache_misses"] == 1


def test_cache_lru_eviction(tmp_path, remote_env, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_STORE_CACHE_BYTES", "256")
    bk = _cached_backend(remote_env, tmp_path)
    for i in range(4):
        bk.put("o%d" % i, bytes([i]) * 100)
        bk.get("o%d" % i)
        time.sleep(0.02)  # distinct mtimes order the LRU sweep
    entries = [fn for fn in os.listdir(tmp_path / "cache")
               if not fn.endswith(".sha1")]
    assert len(entries) <= 2 and "o3" in entries
    assert "o0" not in entries


def test_cache_digest_revalidation_discards_corruption(tmp_path,
                                                       remote_env):
    bk = _cached_backend(remote_env, tmp_path)
    bk.put("a", b"good-bytes")
    bk.get("a")
    with open(os.path.join(tmp_path / "cache", "a"), "wb") as f:
        f.write(b"rotten-bytes")          # the entry flipped, its sidecar kept
    assert bk.get("a") == b"good-bytes"
    snap = backend_counter_snapshot(bk)
    assert snap["cache_hits"] == 0 and snap["cache_misses"] == 2


def test_cache_partial_write_is_a_miss(tmp_path, remote_env):
    bk = _cached_backend(remote_env, tmp_path)
    bk.put("a", b"remote-truth")
    os.makedirs(tmp_path / "cache", exist_ok=True)
    with open(os.path.join(tmp_path / "cache", "a"), "wb") as f:
        f.write(b"orphan-no-sidecar")
    assert bk.get("a") == b"remote-truth"
    assert backend_counter_snapshot(bk)["cache_misses"] == 1


def test_a_poisoned_cache_entry_heals_from_the_remote(tmp_path, monkeypatch,
                                                     remote_env):
    """A cache entry whose sidecar agrees with its wrong bytes passes the
    cache's own check; the shard reader's digest catches it, re-reads with
    ``refresh=True`` past the cache, and the clean copy lands over it."""
    import hashlib

    monkeypatch.setenv("CNMF_TPU_OOC_SLAB_ROWS", "32")
    X = _dense(64, 10)
    write_shard_store(tmp_path / "st", X)
    store = open_shard_store(tmp_path / "st")
    clean = np.asarray(store.read_slab(0))
    entry = os.path.join(store_cache_dir(tmp_path / "st"),
                         store.slabs[0]["file"])
    with open(entry, "rb") as f:
        good = f.read()
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF
    with open(entry, "wb") as f:
        f.write(bytes(bad))
    with open(entry + ".sha1", "w") as f:
        f.write(hashlib.sha1(bytes(bad)).hexdigest())
    again = open_shard_store(tmp_path / "st")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = np.asarray(again.read_slab(0))
    assert np.array_equal(got, clean) and np.array_equal(got, X[:32])
    assert any("re-reading" in str(x.message) for x in w)
    with open(entry, "rb") as f:
        assert f.read() == good
    snap = backend_counter_snapshot(again)
    assert snap["cache_hits"] >= 1


def test_crash_temps_swept(tmp_path, monkeypatch, remote_env):
    monkeypatch.setenv("CNMF_TPU_OOC_SLAB_ROWS", "32")
    store_dir = tmp_path / "st"
    write_shard_store(store_dir, _dense(64, 10))
    cache_dir = store_cache_dir(store_dir)
    os.makedirs(cache_dir, exist_ok=True)
    orphan = os.path.join(cache_dir, "slab_00000.npz.tmp-12345")
    with open(orphan, "wb") as f:
        f.write(b"partial")
    swept = sweep_store_temps(store_dir)
    assert not os.path.exists(orphan) and swept >= 1


# ---------------------------------------------------------------------------
# the degradation contract
# ---------------------------------------------------------------------------

def test_down_remote_serves_warm_cache_loudly(tmp_path, monkeypatch,
                                              remote_env):
    monkeypatch.setenv("CNMF_TPU_OOC_SLAB_ROWS", "32")
    monkeypatch.setenv("CNMF_TPU_STORE_RETRIES", "1")
    X = _dense(100, 20)
    write_shard_store(tmp_path / "st", X)
    warm = open_shard_store(tmp_path / "st")
    ref = [np.asarray(warm.read_slab(i)) for i in range(len(warm.slabs))]
    warm.obs_names()
    _set_spec(monkeypatch, "netdown:context=get:")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        store = open_shard_store(tmp_path / "st")
        got = [np.asarray(store.read_slab(i))
               for i in range(len(store.slabs))]
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    snap = backend_counter_snapshot(store)
    assert snap["degraded_reads"] >= 1
    loud = [x for x in w if issubclass(x.category, RuntimeWarning)
            and "DEGRADED" in str(x.message)]
    assert len(loud) == 1  # once a run, not once a slab


def test_probe_missing_vs_down(tmp_path, monkeypatch, remote_env):
    store, reason = probe_shard_store(tmp_path / "absent.store")
    assert store is None and reason == "missing"
    monkeypatch.setenv("CNMF_TPU_STORE_RETRIES", "0")
    monkeypatch.setenv("CNMF_TPU_STORE_CACHE_BYTES", "0")
    _set_spec(monkeypatch, "netdown:context=head:")
    with pytest.raises(RemoteStoreError):
        probe_shard_store(tmp_path / "absent.store")


def _store_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("cnmf-store")]


def test_no_lingering_threads_after_failure(tmp_path, monkeypatch,
                                            remote_env):
    monkeypatch.setenv("CNMF_TPU_STORE_RETRIES", "0")
    monkeypatch.setenv("CNMF_TPU_STORE_CACHE_BYTES", "0")
    monkeypatch.setenv("CNMF_TPU_STORE_HEDGE_S", "0.05")
    bk = RemoteBackend(remote_env.url + "/z",
                       cache_dir=str(tmp_path / "cache"))
    bk.put("a", b"x")
    _set_spec(monkeypatch, "netslow:context=get:a,seconds=0.5")
    assert bk.get("a", refresh=True) == b"x"  # the hedge wins the stall
    for t in _store_threads():  # the abandoned primary drains and exits
        t.join(timeout=5)
    assert not _store_threads()


# ---------------------------------------------------------------------------
# dispatch and the knobs
# ---------------------------------------------------------------------------

def test_uri_dispatch(tmp_path, monkeypatch):
    sd = str(tmp_path / "x.store")
    monkeypatch.delenv(STORE_URI_ENV, raising=False)
    bk = resolve_backend(sd)
    assert isinstance(bk, LocalBackend) and bk.root == sd
    bk = resolve_backend(sd, uri="file://%s/alt" % tmp_path)
    assert isinstance(bk, LocalBackend)
    assert bk.root == os.path.join(str(tmp_path), "alt", "x.store")
    bk = resolve_backend(sd, uri="http://h:9/pfx")
    assert isinstance(bk, RemoteBackend)
    assert bk.base == "http://h:9/pfx/x.store"
    assert bk.cache_dir == sd + ".cache"
    jb = jbk.resolve_backend(sd, uri="http://h:9/pfx")
    assert (jb.base, jb.cache_dir) == (bk.base, bk.cache_dir)
    monkeypatch.setenv(STORE_URI_ENV, "https://h:9/p")
    assert resolve_backend(sd).kind == "remote"
    with pytest.raises(ValueError, match="CNMF_TPU_STORE_URI"):
        resolve_backend(sd, uri="s3://unsupported")


@pytest.mark.parametrize("knob,bad", [
    ("CNMF_TPU_STORE_RETRIES", "many"), ("CNMF_TPU_STORE_RETRIES", "-1"),
    ("CNMF_TPU_STORE_BACKOFF_S", "soon"), ("CNMF_TPU_STORE_BACKOFF_S", "-1"),
    ("CNMF_TPU_STORE_TIMEOUT_S", "0"), ("CNMF_TPU_STORE_HEDGE_S", "x"),
    ("CNMF_TPU_STORE_CACHE_BYTES", "1.5"),
    ("CNMF_TPU_STORE_CACHE_BYTES", "-3")])
def test_knob_validation_one_line_errors(monkeypatch, knob, bad):
    from cnmf_torch_tpu_torch.utils import storebackend as tbk

    reader = {"CNMF_TPU_STORE_RETRIES": "store_retries",
              "CNMF_TPU_STORE_BACKOFF_S": "store_backoff_s",
              "CNMF_TPU_STORE_TIMEOUT_S": "store_timeout_s",
              "CNMF_TPU_STORE_HEDGE_S": "store_hedge_s",
              "CNMF_TPU_STORE_CACHE_BYTES": "store_cache_bytes"}[knob]
    monkeypatch.setenv(knob, bad)
    with pytest.raises(ValueError, match=knob) as mine:
        getattr(tbk, reader)()
    with pytest.raises(ValueError) as theirs:
        getattr(jbk, reader)()
    assert str(mine.value) == str(theirs.value)
    assert "\n" not in str(mine.value)
    monkeypatch.delenv(knob)
    assert getattr(tbk, reader)() == getattr(jbk, reader)()
    assert store_retries() == 3


def test_remote_knobs_registered():
    from cnmf_torch_tpu_torch.utils.envknobs import KNOBS

    for knob in ("CNMF_TPU_STORE_URI", "CNMF_TPU_STORE_RETRIES",
                 "CNMF_TPU_STORE_BACKOFF_S", "CNMF_TPU_STORE_TIMEOUT_S",
                 "CNMF_TPU_STORE_HEDGE_S", "CNMF_TPU_STORE_CACHE_BYTES",
                 "CNMF_TPU_PERF_MODEL", "CNMF_TPU_PERF_GATE_BAND"):
        assert knob in KNOBS


# ---------------------------------------------------------------------------
# across the packages, on one fixture server
# ---------------------------------------------------------------------------

_SPECS = ["netflake:context=get:slab", "netflake:context=get:slab,limit=2",
          "netslow:context=get:slab,seconds=0.01", "netdown:context=head:",
          "nettorn:context=get:slab", "nettorn:context=put:,after=1",
          "netdown:context=get:slab,limit=2"]
_CALLS = [("get", "slab_00000.npz"), ("get", "manifest.json"),
          ("head", "manifest.json"), ("put", "slab_00001.npz"),
          ("get", "slab_00001.npz"), ("get", "slab_00002.npz"),
          ("put", "names.npz")]


@pytest.mark.parametrize("spec", _SPECS)
def test_maybe_netfault_fires_as_in_jax(monkeypatch, spec):
    """The same spec over the same call sequence: the same raises, tears
    and passes in both packages."""
    def outcomes(mod):
        _set_spec(monkeypatch, spec)
        seen = []
        for op, name in _CALLS:
            try:
                seen.append(mod.maybe_netfault(op=op, context=name))
            except ConnectionError as exc:
                seen.append(str(exc))
        return seen

    assert outcomes(faults) == outcomes(jfaults)


def _objects(srv, prefix):
    with srv.lock:
        return {k[len(prefix):]: v for k, v in srv.objects.items()
                if k.startswith(prefix)}


@pytest.mark.parametrize("kind,slab_rows", [("dense", 50), ("csr", 20),
                                            ("csr", 1000)])
def test_both_packages_write_the_same_objects(tmp_path, monkeypatch,
                                              remote_env, kind, slab_rows):
    X = _dense() if kind == "dense" else _csr()
    obs, var = _names(*X.shape)
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/port")
    write_shard_store(tmp_path / "a" / "x.store", X, slab_rows=slab_rows,
                      obs_names=obs, var_names=var)
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/jax")
    jss.write_shard_store(tmp_path / "b" / "x.store", X,
                          slab_rows=slab_rows, obs_names=obs, var_names=var)
    mine = _objects(remote_env, "port/x.store/")
    theirs = _objects(remote_env, "jax/x.store/")
    assert sorted(mine) == sorted(theirs)
    assert "manifest.json" in mine and "names.npz" in mine
    for name in theirs:
        assert mine[name] == theirs[name], name
    # a rewrite over the old generation leaves no orphan in either
    write_shard_store(tmp_path / "b" / "x.store", X[:30], slab_rows=10)
    assert sorted(_objects(remote_env, "jax/x.store/")) == [
        "manifest.json", "names.npz", "slab_00000.npz", "slab_00001.npz",
        "slab_00002.npz"]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_either_package_stages_the_other_s_store(tmp_path, monkeypatch,
                                                 remote_env, writer, kind):
    import jax
    from jax.sharding import Mesh

    from cnmf_torch_tpu.parallel.rowshard import (
        stream_ell_to_mesh as jax_stream_ell,
        stream_rows_to_mesh as jax_stream_rows)

    X = _dense(203, 29) if kind == "dense" else _csr(203, 29, density=0.1)
    obs, var = _names(*X.shape)
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/w")
    (write_shard_store if writer == "port" else jss.write_shard_store)(
        tmp_path / "x.store", X, slab_rows=40, obs_names=obs, var_names=var)
    mine = open_shard_store(tmp_path / "x.store")
    theirs = jss.open_shard_store(tmp_path / "x.store")
    assert mine.backend.kind == theirs.backend.kind == "remote"
    assert mine.manifest == theirs.manifest
    dense = X.toarray() if sp.issparse(X) else X
    got, _ = trs.stream_rows_to_mesh(mine, "cpu")
    assert np.array_equal(got.numpy(), dense)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("cells",))
    want, _ = jax_stream_rows(theirs, mesh, "cells")
    assert np.array_equal(np.asarray(want), got.numpy())
    if kind == "csr":
        E, _ = trs.stream_ell_to_mesh(mine, "cpu")
        J, _ = jax_stream_ell(theirs, mesh, "cells")
        assert np.array_equal(np.asarray(J.vals), E.vals.numpy())
        assert np.array_equal(np.asarray(J.cols), E.cols.numpy())


def test_both_packages_fill_the_same_cache(tmp_path, monkeypatch,
                                           remote_env):
    X = _csr()
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/c")
    write_shard_store(tmp_path / "a" / "x.store", X, slab_rows=30)
    names = RemoteBackend(remote_env.url + "/c/x.store").list()
    bk = RemoteBackend(remote_env.url + "/c/x.store",
                       cache_dir=str(tmp_path / "mine"))
    jb = jbk.RemoteBackend(remote_env.url + "/c/x.store",
                           cache_dir=str(tmp_path / "theirs"))
    for name in names:
        assert bk.get(name) == jb.get(name)
    mine = sorted(os.listdir(tmp_path / "mine"))
    assert mine == sorted(os.listdir(tmp_path / "theirs"))
    assert len(mine) == 2 * len(names)
    for fn in mine:
        with open(tmp_path / "mine" / fn, "rb") as a, \
                open(tmp_path / "theirs" / fn, "rb") as b:
            assert a.read() == b.read(), fn
    # each package serves the other's cache entries as hits
    cross = RemoteBackend(remote_env.url + "/c/x.store",
                          cache_dir=str(tmp_path / "theirs"))
    for name in names:
        cross.get(name)
    assert backend_counter_snapshot(cross)["cache_hits"] == len(names)


# ---------------------------------------------------------------------------
# the pipeline through an http:// store
# ---------------------------------------------------------------------------

def _counts_file(d, n=160, g=90, seed=3):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(3) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(3, g)) * 50.0 / g
    counts = rng.poisson(usage @ spectra * 80.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(d, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


def _iter_arrays(obj, ks=(3,), n_iter=4):
    out = {}
    for k in ks:
        for it in range(n_iter):
            with np.load(obj.paths["iter_spectra"] % (k, it)) as f:
                out[(k, it)] = tuple(np.asarray(f[key]).tobytes()
                                     for key in f.files)
    return out


def _consensus_arrays(obj, k=3):
    out = {}
    for key in ("consensus_spectra", "consensus_usages"):
        with np.load(obj.paths[key] % (k, "2_0")) as f:
            out[key] = tuple(np.asarray(f[n]).tobytes() for n in f.files)
    return out


def _pipeline(d, name, fn, consensus=True):
    obj = cNMF(d, name, device="cpu", rowshard_threshold=100)
    obj.prepare(fn, components=[3], n_iter=4, seed=1, num_highvar_genes=50,
                beta_loss="kullback-leibler", batch_size=40,
                max_NMF_iter=80)
    obj.factorize()
    if consensus:
        obj.combine()
        obj.consensus(3, density_threshold=2.0, show_clustering=False)
    return obj


@pytest.fixture(scope="module")
def local_run(tmp_path_factory):
    """The store-only run on a local store that the http runs must
    equal."""
    d = str(tmp_path_factory.mktemp("local"))
    fn = _counts_file(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CNMF_TPU_OOC", "1")
        mp.delenv(STORE_URI_ENV, raising=False)
        obj = _pipeline(d, "r", fn)
    return d, fn, obj


def test_the_pipeline_through_an_http_store(local_run, tmp_path,
                                            monkeypatch, remote_env):
    _, fn, ref = local_run
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/runs")
    obj = _pipeline(str(tmp_path), "r", fn)
    assert obj.factorize_info["mode"] == "rowshard"
    assert obj.factorize_info["ooc_ingest"] == "store_resident"
    assert not os.path.exists(obj.paths["normalized_counts"])
    assert not os.path.exists(obj.paths["shard_store"])
    leaf = os.path.basename(obj.paths["shard_store"])
    assert "runs/%s/manifest.json" % leaf in remote_env.objects
    assert _iter_arrays(obj) == _iter_arrays(ref)
    assert _consensus_arrays(obj) == _consensus_arrays(ref)
    # the staging's stream event carries the transport's counters, and the
    # cache holds what the remote served
    from cnmf_torch_tpu.utils import telemetry as jtel
    from cnmf_torch_tpu_torch.utils import telemetry as tel

    events_fn = os.path.join(str(tmp_path), "r", "cnmf_tmp",
                             "r.events.jsonl")
    events = tel.read_events(events_fn)
    (stage,) = [e for e in events if e["t"] == "stream"
                and e["context"] == "rowshard_stage_x"]
    assert stage["store_remote"] is True
    assert stage["store_cache_misses"] >= 1
    # the streamed consensus reads the slabs back through the warm cache
    (cons,) = [e for e in events if e["t"] == "stream"
               and e["context"] == "consensus_stream"]
    assert cons["store_remote"] is True
    assert cons["store_cache_hits"] >= stage["store_cache_misses"]
    assert cons["store_cache_misses"] == 0 and cons["store_retries"] == 0
    cache = store_cache_dir(obj.paths["shard_store"])
    assert os.path.isdir(cache) and os.listdir(cache)
    assert jtel.validate_events_file(events_fn) == \
        tel.validate_events_file(events_fn)
    assert tel.render_report(os.path.join(str(tmp_path), "r")) == \
        jtel.render_report(os.path.join(str(tmp_path), "r"))


def test_the_cli_store_uri_runs_the_pipeline(local_run, tmp_path,
                                             monkeypatch, remote_env):
    from cnmf_torch_tpu_torch.cli import main

    _, fn, ref = local_run
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    # an empty value first, so the teardown restores the knob's absence
    monkeypatch.setenv(STORE_URI_ENV, "")
    uri = remote_env.url + "/cli"
    common = ["--output-dir", str(tmp_path), "--name", "r", "--device",
              "cpu", "--store-uri", uri]
    main(["prepare", "-c", fn, "-k", "3", "-n", "4", "--seed", "1",
          "--numgenes", "50", "--beta-loss", "kullback-leibler",
          "--batch_size", "40", "--max-nmf-iter", "80"] + common)
    main(["factorize", "--rowshard-threshold", "100"] + common)
    main(["combine"] + common)
    main(["consensus", "-k", "3", "--local-density-threshold", "2.0"]
         + common)
    obj = cNMF(str(tmp_path), "r", device="cpu")
    assert os.environ[STORE_URI_ENV] == uri
    assert _iter_arrays(obj) == _iter_arrays(ref)
    # the CLI's consensus keeps the constructor's row-shard threshold
    # (200,000), so its final usage refit is the resident one, where the
    # reference run's is row-sharded: the spectra are the same bits
    assert _consensus_arrays(obj)["consensus_spectra"] == \
        _consensus_arrays(ref)["consensus_spectra"]


def test_factorize_from_a_jax_written_http_store(local_run, tmp_path,
                                                 monkeypatch, remote_env):
    """The port's run whose store the JAX package wrote over HTTP (the
    same matrix and names) factorizes to the local-store run's bits."""
    _, fn, ref = local_run
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/j")
    obj = cNMF(str(tmp_path), "r", device="cpu", rowshard_threshold=100)
    obj.prepare(fn, components=[3], n_iter=4, seed=1, num_highvar_genes=50,
                beta_loss="kullback-leibler", batch_size=40,
                max_NMF_iter=80)
    port_store = open_shard_store(obj.paths["shard_store"])
    X = port_store.to_matrix()
    obs, var = port_store.obs_names(), port_store.var_names()
    written = _objects(remote_env, "j/")
    with remote_env.lock:
        for k in list(remote_env.objects):
            if k.startswith("j/"):
                del remote_env.objects[k]
    jss.write_shard_store(obj.paths["shard_store"], X, obs_names=obs,
                          var_names=var,
                          slab_rows=port_store.manifest["slab_rows"])
    assert _objects(remote_env, "j/") == written
    obj.factorize()
    assert _iter_arrays(obj) == _iter_arrays(ref)


def test_a_cold_netdown_ends_factorize_in_the_ledger(local_run, tmp_path,
                                                     monkeypatch,
                                                     remote_env):
    import json

    _, fn, _ = local_run
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    monkeypatch.setenv("CNMF_TPU_STORE_RETRIES", "1")
    monkeypatch.setenv(STORE_URI_ENV, remote_env.url + "/down")
    obj = cNMF(str(tmp_path), "r", device="cpu", rowshard_threshold=100)
    obj.prepare(fn, components=[3], n_iter=4, seed=1, num_highvar_genes=50,
                beta_loss="kullback-leibler", batch_size=40,
                max_NMF_iter=80)
    _set_spec(monkeypatch, "netdown:context=get:slab")
    with pytest.raises(RemoteStoreError):
        obj.factorize()
    with open(obj.paths["resilience_ledger"] % 0) as f:
        ledger = json.load(f)
    kinds = [r["kind"] for r in ledger["shard_faults"]]
    assert kinds == ["remote_store"]
    assert ledger["shard_faults"][0]["stage"] == "rowshard_stage_x"
    assert not os.path.exists(obj.paths["iter_spectra"] % (3, 0))
