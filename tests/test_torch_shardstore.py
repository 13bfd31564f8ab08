"""The port's shard store (``utils/shardstore.py``,
``utils/storebackend.py``) against the JAX package's.

A store written by either package opens in the other with the same
arrays, names and digests, and the two writers give the same manifest
bytes for the same matrix; torn slabs are detected, re-read and failed
loudly; ownership and residency accounting hold; store-backed staging is
bit for bit the in-memory staging; and ``prepare`` writes, skips and
sweeps the store as the JAX package's does. Every comparison is exact
(the store is a byte format).
"""

import json
import os
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.utils import shardstore as jss
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.parallel import streaming as tst
from cnmf_torch_tpu_torch.utils import shardstore as tss
from cnmf_torch_tpu_torch.utils import storebackend as tbk


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
    X[40:60, :] = 0.0              # a zero row band across a slab boundary
    X[n - 1, :] = 0.0              # an empty last row
    return sp.csr_matrix(X).astype(np.float32)


def _matrix(kind):
    return _dense() if kind == "dense" else _csr()


def _names(n, g):
    return [f"cell{i}" for i in range(n)], [f"gene{j}" for j in range(g)]


def _same_matrix(a, b):
    a = a.toarray() if sp.issparse(a) else np.asarray(a)
    b = b.toarray() if sp.issparse(b) else np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# cross-package format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "csr"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_opens_in_the_other_package(tmp_path, kind, writer):
    X = _matrix(kind)
    obs, var = _names(*X.shape)
    write = (jss if writer == "jax" else tss).write_shard_store
    write(tmp_path / "st", X, obs_names=obs, var_names=var, slab_rows=50)
    j = jss.open_shard_store(tmp_path / "st")
    t = tss.open_shard_store(tmp_path / "st")
    assert t.shape == j.shape and t.format == j.format == kind
    assert (t.store_digest, t.input_digest) == (j.store_digest,
                                                j.input_digest)
    assert [s["digest"] for s in t.slabs] == [s["digest"] for s in j.slabs]
    assert (t.nnz, t.max_row_nnz, t.value_sum) == (j.nnz, j.max_row_nnz,
                                                   j.value_sum)
    assert t.obs_names() == j.obs_names() == obs
    assert t.var_names() == j.var_names() == var
    assert _same_matrix(t.to_matrix(), j.to_matrix())
    assert _same_matrix(t.to_matrix(), X)
    for i in range(len(t.slabs)):
        assert _same_matrix(t.read_slab(i), j.read_slab(i))
    assert _same_matrix(t.row_block(35, 160), j.row_block(35, 160))


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_both_writers_give_the_same_manifest_bytes(tmp_path, kind):
    X = _matrix(kind)
    obs, var = _names(*X.shape)
    jss.write_shard_store(tmp_path / "j", X, obs_names=obs, var_names=var,
                          slab_rows=64)
    tss.write_shard_store(tmp_path / "t", X, obs_names=obs, var_names=var,
                          slab_rows=64)
    with open(tmp_path / "j" / "manifest.json", "rb") as f:
        want = f.read()
    with open(tmp_path / "t" / "manifest.json", "rb") as f:
        assert f.read() == want
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "t"))
    for fn in os.listdir(tmp_path / "j"):
        if not fn.endswith(".npz"):
            continue
        with np.load(tmp_path / "j" / fn, allow_pickle=True) as a, \
                np.load(tmp_path / "t" / fn, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key])


@pytest.mark.parametrize("X", [_dense(40, 9), _csr(40, 9),
                               np.zeros((0, 5), np.float32)],
                         ids=["dense", "csr", "empty"])
def test_input_digest_matches_the_jax_package(X):
    from cnmf_torch_tpu.runtime.checkpoint import input_digest as jdig
    from cnmf_torch_tpu_torch.runtime.checkpoint import input_digest

    assert input_digest(X) == jdig(X)


def test_f64_input_lands_as_f32(tmp_path):
    X = np.random.default_rng(2).random((40, 8))
    tss.write_shard_store(tmp_path / "st", X, slab_rows=16)
    store = tss.open_shard_store(tmp_path / "st")
    assert store.dtype == np.float32
    assert store.read_slab(0).dtype == np.float32
    assert store.input_digest == jss.open_shard_store(
        tmp_path / "st").input_digest


def test_ragged_slabs_and_rewrite_without_orphans(tmp_path):
    tss.write_shard_store(tmp_path / "st", _dense(219), slab_rows=50)
    store = tss.open_shard_store(tmp_path / "st")
    assert len(store.slabs) == 5
    assert store.slabs[-1]["row1"] - store.slabs[-1]["row0"] == 19
    tss.write_shard_store(tmp_path / "st", _dense(60), slab_rows=30)
    store = tss.open_shard_store(tmp_path / "st")
    assert len(store.slabs) == 2
    assert len([f for f in os.listdir(tmp_path / "st")
                if f.startswith("slab_")]) == 2


# ---------------------------------------------------------------------------
# validation and torn reads
# ---------------------------------------------------------------------------

def test_open_rejects_structural_damage(tmp_path):
    X = _dense(100, 10)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=40)
    man_path = tmp_path / "st" / "manifest.json"
    man = json.loads(man_path.read_text())
    os.unlink(tmp_path / "st" / man["slabs"][1]["file"])
    with pytest.raises(tss.TornShardError, match="missing"):
        tss.open_shard_store(tmp_path / "st")
    tss.write_shard_store(tmp_path / "st", X, slab_rows=40)
    man = json.loads(man_path.read_text())
    man["slabs"][1]["row0"] += 1
    man_path.write_text(json.dumps(man))
    with pytest.raises(tss.TornShardError, match="contiguous"):
        tss.open_shard_store(tmp_path / "st")
    man_path.write_text("{not json")
    store, reason = tss.probe_shard_store(tmp_path / "st")
    assert store is None and "manifest" in reason
    assert tss.probe_shard_store(tmp_path / "missing") == (None, "missing")


def test_a_torn_slab_is_re_read_then_fails_loudly(tmp_path):
    X = _dense(80, 12)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=40)
    store = tss.open_shard_store(tmp_path / "st")
    path = os.path.join(store.dir, store.slabs[1]["file"])
    with open(path, "r+b") as f:
        f.seek(30)
        b = f.read(1)
        f.seek(30)
        f.write(bytes([b[0] ^ 0xFF]))

    class Sink:
        def __init__(self):
            self.faults = []

        def emit(self, t, **fields):
            self.faults.append(fields)

    sink = Sink()
    with pytest.warns(RuntimeWarning, match="re-reading from disk"):
        with pytest.raises(tss.TornShardError, match="after 3"):
            store.read_slab(1, events=sink)
    assert [f["context"]["attempt"] for f in sink.faults] == [1, 2, 3]
    assert {f["kind"] for f in sink.faults} == {"shard_read_torn"}
    assert np.array_equal(store.read_slab(0), X[:40])


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_an_injected_torn_read_heals_by_re_reading(tmp_path, monkeypatch,
                                                    kind):
    X = _matrix(kind)[:90]
    tss.write_shard_store(tmp_path / "st", X, slab_rows=30)
    store = tss.open_shard_store(tmp_path / "st")
    # a distinct spec string a case: parsed clauses are cached per raw
    # value, their hit counters with them
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       {"dense": "shard_read:context=slab:0,limit=1",
                        "csr": "shard_read:limit=1,context=slab:0"}[kind])
    with pytest.warns(RuntimeWarning, match="re-reading from disk"):
        blk = store.read_slab(0)
    assert _same_matrix(blk, X[:30])
    assert _same_matrix(store.read_slab(0), X[:30])


def test_names_digest_mismatch_is_torn(tmp_path):
    X = _dense(20, 4)
    tss.write_shard_store(tmp_path / "st", X, obs_names=_names(20, 4)[0],
                          var_names=_names(20, 4)[1], slab_rows=10)
    import io

    buf = io.BytesIO()
    np.savez(buf, obs=np.asarray(["x"] * 20, dtype=object),
             var=np.asarray(_names(20, 4)[1], dtype=object))
    with open(tmp_path / "st" / "names.npz", "wb") as f:
        f.write(buf.getvalue())
    with pytest.raises(tss.TornShardError, match="names digest"):
        tss.open_shard_store(tmp_path / "st").obs_names()


# ---------------------------------------------------------------------------
# ownership and residency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total", [1, 2, 3, 7])
def test_worker_ranges_match_the_jax_package(tmp_path, total):
    tss.write_shard_store(tmp_path / "st", _dense(219), slab_rows=50)
    assert (tss.open_shard_store(tmp_path / "st").worker_ranges(total)
            == jss.open_shard_store(tmp_path / "st").worker_ranges(total))


def test_a_cursor_reads_only_its_own_slabs(tmp_path):
    tss.write_shard_store(tmp_path / "st", _dense(219), slab_rows=50)
    store = tss.open_shard_store(tmp_path / "st")
    cur = tss.SlabCursor(store, rows=(60, 140))
    assert [t[0] for t in cur.tasks()] == [1, 2]
    assert cur.tasks()[0][1:] == (60, 100)
    with pytest.raises(ValueError, match="outside this cursor"):
        cur.read(0)
    cur.read(1)
    assert cur.residency.live == store.slabs[1]["raw_bytes"]
    cur.release(1)
    assert cur.residency.live == 0
    assert cur.residency.peak == store.slabs[1]["raw_bytes"]
    with pytest.raises(ValueError, match="outside store rows"):
        tss.SlabCursor(store, rows=(0, 500))


def test_host_residency_ledger():
    led = tss.HostResidency()
    led.charge(10)
    led.charge(5)
    led.release(10)
    led.charge(2)
    assert (led.live, led.peak) == (7, 15)
    led.release(100)
    assert led.live == 0


@pytest.mark.parametrize("kind", ["dense", "csr"])
@pytest.mark.parametrize("pad", [0, 5])
def test_store_staging_is_the_in_memory_staging(tmp_path, kind, pad):
    X = _matrix(kind)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=60)
    store = tss.open_shard_store(tmp_path / "st")
    want, pad_w = trs.stream_rows_to_mesh(X, "cpu",
                                          pad_multiple=X.shape[0] + pad)
    got, pad_g = trs.stream_rows_to_mesh(store, "cpu",
                                         pad_multiple=X.shape[0] + pad)
    assert pad_w == pad_g == pad
    assert torch.equal(want, got)
    dense = X.toarray() if sp.issparse(X) else X
    assert np.array_equal(got[:X.shape[0]].numpy(), dense)
    assert not got[X.shape[0]:].any()


def test_store_ell_staging_is_the_in_memory_encoding(tmp_path):
    X = _csr(300, 64, density=0.05)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=70)
    store = tss.open_shard_store(tmp_path / "st")
    want, _ = trs.stream_ell_to_mesh(X, "cpu")
    got, _ = trs.stream_ell_to_mesh(store, "cpu")
    for a, b in ((want.vals, got.vals), (want.cols, got.cols),
                 (want.rows_t, got.rows_t), (want.perm_t, got.perm_t)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("budget", [1, 4096])
def test_store_staging_stays_under_the_host_budget(tmp_path, monkeypatch,
                                                   budget):
    X = _csr(400, 50, density=0.2)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=40)
    store = tss.open_shard_store(tmp_path / "st")
    monkeypatch.setenv("CNMF_TPU_OOC_BUDGET_BYTES", str(budget))
    stats = tst.StreamStats()
    out = tst.stream_store(tss.SlabCursor(store), "cpu", stats=stats)
    assert np.array_equal(out.numpy(), X.toarray())
    # one slab at a time at a budget below a slab (the floor), never more
    # than the budget plus one slab otherwise
    assert 0 < stats.host_peak_bytes <= max(budget, 0) + store.max_slab_bytes
    assert stats.slabs == len(store.slabs) and stats.disk_nbytes > 0


def test_store_dispatch_sizes_the_resident_budget(tmp_path, monkeypatch):
    import jax
    from jax.sharding import Mesh

    from cnmf_torch_tpu.parallel.rowshard import store_dispatch as jdisp

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("cells",))
    X = _csr(300, 64, density=0.05)
    tss.write_shard_store(tmp_path / "st", X, slab_rows=70)
    tstore = tss.open_shard_store(tmp_path / "st")
    jstore = jss.open_shard_store(tmp_path / "st")
    for shard_bytes in ("", "1024"):
        monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", shard_bytes)
        for beta, force_dense in ((1.0, False), (1.0, True), (2.0, False)):
            with warnings.catch_warnings():
                # an over-budget ELL shard warns in both packages
                warnings.simplefilter("ignore")
                got = trs.store_dispatch(tstore, beta,
                                         force_dense=force_dense)
                want = jdisp(jstore, mesh, beta, force_dense=force_dense)
            assert got == want, (shard_bytes, beta, force_dense)


# ---------------------------------------------------------------------------
# the transport seam
# ---------------------------------------------------------------------------

def test_store_uri_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("CNMF_TPU_STORE_URI", raising=False)
    bk = tbk.resolve_backend(tmp_path / "run.store")
    assert bk.kind == "local" and bk.root == str(tmp_path / "run.store")
    bk = tbk.resolve_backend(tmp_path / "run.store",
                             uri=f"file://{tmp_path}/elsewhere")
    assert bk.root == str(tmp_path / "elsewhere" / "run.store")
    monkeypatch.setenv("CNMF_TPU_STORE_URI", "http://localhost:1/prefix")
    with pytest.raises(NotImplementedError, match="remote object store"):
        tbk.resolve_backend(tmp_path / "run.store")
    with pytest.raises(ValueError, match="expected empty"):
        tbk.resolve_backend(tmp_path / "x", uri="ftp://host/x")


def test_a_file_uri_relocates_the_store_for_both_packages(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("CNMF_TPU_STORE_URI", f"file://{tmp_path}/remote")
    X = _csr(50, 12)
    tss.write_shard_store(tmp_path / "run" / "st", X, slab_rows=20)
    assert os.path.exists(tmp_path / "remote" / "st" / "manifest.json")
    assert not os.path.exists(tmp_path / "run" / "st")
    store = jss.open_shard_store(tmp_path / "run" / "st")
    assert _same_matrix(store.to_matrix(), X)


def test_temps_are_swept_and_stores_removed(tmp_path):
    tss.write_shard_store(tmp_path / "st", _dense(30, 4), slab_rows=10)
    for d in (tmp_path / "st", tmp_path / "st.cache"):
        os.makedirs(d, exist_ok=True)
        (d / "slab_00000.npz.tmp-123").write_bytes(b"x")
    assert tss.sweep_store_temps(tmp_path / "st") == 2
    assert tss.open_shard_store(tmp_path / "st").n_rows == 30
    tss.remove_store(tmp_path / "st")
    assert not os.path.exists(tmp_path / "st")
    assert not os.path.exists(tmp_path / "st.cache")


def test_local_puts_land_atomically_with_the_jax_temp_name(tmp_path,
                                                           monkeypatch):
    bk = tbk.LocalBackend(str(tmp_path / "st"))
    seen = []
    real = os.replace
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (seen.append(a), real(a, b)))
    bk.put("manifest.json", b"{}")
    assert seen and ".tmp-%d" % os.getpid() in seen[0]
    assert bk.get("manifest.json") == b"{}"
    assert bk.exists("manifest.json") and bk.list() == ["manifest.json"]
    bk.delete("manifest.json")
    bk.delete("manifest.json")
    assert tbk.backend_counter_snapshot(bk) is None


# ---------------------------------------------------------------------------
# prepare and factorize with the store
# ---------------------------------------------------------------------------

def _counts_file(tmp_path, n=120, g=80, seed=3):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(3) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(3, g)) * 50.0 / g
    counts = rng.poisson(usage @ spectra * 80.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp_path, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


def _prepared(tmp_path, name, fn, n_iter=2):
    obj = cNMF(str(tmp_path), name, device="cpu", rowshard_threshold=100)
    obj.prepare(fn, components=[3], n_iter=n_iter, seed=1,
                num_highvar_genes=40,
                beta_loss="kullback-leibler", batch_size=40,
                max_NMF_iter=100)
    return obj


@pytest.mark.parametrize("budget,written", [("1", True),
                                            (str(1 << 40), False)])
def test_prepare_auto_writes_the_store_above_the_budget(tmp_path,
                                                        monkeypatch, budget,
                                                        written):
    monkeypatch.delenv("CNMF_TPU_OOC", raising=False)
    monkeypatch.setenv("CNMF_TPU_OOC_BUDGET_BYTES", budget)
    obj = _prepared(tmp_path, "a", _counts_file(tmp_path))
    assert os.path.exists(obj.paths["normalized_counts"])
    assert (obj._probe_store() is not None) is written


def test_ooc1_skips_the_matrix_file_and_assembles_loudly(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    obj = _prepared(tmp_path, "a", _counts_file(tmp_path))
    assert not os.path.exists(obj.paths["normalized_counts"])
    store = obj._probe_store()
    assert store is not None
    with pytest.warns(RuntimeWarning, match="assembling the full matrix"):
        norm = obj._read_norm_counts()
    assert _same_matrix(norm.X, store.to_matrix())
    assert list(norm.var_names) == store.var_names()
    monkeypatch.setenv("CNMF_TPU_OOC", "0")
    assert obj._probe_store() is None


def test_a_stale_store_is_swept_by_a_fresh_factorize(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_OOC", "auto")
    monkeypatch.setenv("CNMF_TPU_OOC_BUDGET_BYTES", "1")
    fn = _counts_file(tmp_path)
    obj = _prepared(tmp_path, "a", fn)
    # a store from another matrix under the same name
    tss.write_shard_store(obj.paths["shard_store"], _dense(120, 7),
                          slab_rows=50)
    with pytest.warns(RuntimeWarning, match="stale store|does not match"):
        obj.factorize()
    assert not os.path.exists(obj.paths["shard_store"])
    assert obj.factorize_info["mode"] == "rowshard"


def test_an_atlas_run_reports_as_the_jax_package_renders_it(tmp_path,
                                                            monkeypatch):
    """A store-authoritative prepare, a row-sharded factorize with pass
    checkpoints and a streamed consensus under ``CNMF_TPU_TELEMETRY``:
    the events file (``shard_store_write``, ``ooc_ingest``, ``stream``
    and ``checkpoint`` events) validates in both packages and both
    render the same report text."""
    from cnmf_torch_tpu.utils import telemetry as jtel
    from cnmf_torch_tpu_torch.utils import telemetry as ttel

    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.setenv("CNMF_TPU_OOC", "1")
    obj = _prepared(tmp_path, "a", _counts_file(tmp_path), n_iter=4)
    obj.factorize()
    obj.combine()
    obj.consensus(3, density_threshold=2.0)
    path = str(tmp_path / "a" / "cnmf_tmp" / "a.events.jsonl")
    n = ttel.validate_events_file(path)
    assert n == jtel.validate_events_file(path) > 10
    events = ttel.read_events(path)
    decisions = {e.get("decision") for e in events if e["t"] == "dispatch"}
    assert {"shard_store_write", "ooc_ingest"} <= decisions
    assert {e["context"] for e in events if e["t"] == "stream"} >= {
        "rowshard_stage_x", "consensus_stream"}
    assert {e["action"] for e in events
            if e["t"] == "checkpoint"} >= {"write", "discard"}
    run_dir = str(tmp_path / "a")
    assert ttel.render_report(run_dir) == jtel.render_report(run_dir)
    assert "ingestion" in ttel.summarize_events(events)
