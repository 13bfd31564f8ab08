"""Liveness while X stages: the port's staging against the JAX package's.

Every staging path takes ``liveness`` (a ``runtime.elastic.Heartbeat``)
and stamps it once per committed slab as ``stage:<context>``, with the
JAX package's context names. A recording stand-in (an object with
``Heartbeat.beat``'s signature that appends its arguments) is handed to
both packages; a real ``Heartbeat`` at interval 0 would record nothing,
since ``interval_s <= 0`` turns its writer off in both.

* Where the store fixes the slab plan (``stream_store``, the slab-looped
  groups) and where the task plan is the same in both (``run_pipeline``,
  the ELL shards, the grid's stripes, the 2-D re-stage), the lists of
  ``(phase, cursor)`` are equal.
* Where the port cuts its own slabs (``stream_rows_to_mesh`` of a host
  matrix), there is one beat per committed slab, cursors ``0..n-1`` in
  order, under JAX's phase string.
* Each case runs on the threaded pipeline and on the serial one.
* The factorize paths hand their own heartbeat to their staging, the
  re-stage after a re-mesh included, and a worker whose staging is slow
  stays fresh by the launcher's straggler test.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from cnmf_torch_tpu.parallel import grid2d as jgrid
from cnmf_torch_tpu.parallel import multihost as jmh
from cnmf_torch_tpu.parallel import rowshard as jrs
from cnmf_torch_tpu.parallel import streaming as jst
from cnmf_torch_tpu.utils import shardstore as jss
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch import launcher as tlauncher
from cnmf_torch_tpu_torch.parallel import grid2d as tgrid
from cnmf_torch_tpu_torch.parallel import multihost as tmh
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.parallel import streaming as tst
from cnmf_torch_tpu_torch.parallel.mesh import Mesh
from cnmf_torch_tpu_torch.runtime import elastic
from cnmf_torch_tpu_torch.utils import shardstore as tss


class Recorder:
    """A stand-in for ``Heartbeat``: records every beat, writes nothing."""

    def __init__(self):
        self.beats = []
        self.threads = set()

    def beat(self, phase=None, cursor=None, force=False):
        self.beats.append((phase, cursor))
        self.threads.add(threading.get_ident())
        return True


@pytest.fixture(params=["threaded", "serial"])
def pipeline(request, monkeypatch):
    """The staging pipeline's mode, set through the knobs both packages
    read."""
    if request.param == "threaded":
        monkeypatch.setenv("CNMF_TPU_STREAM_THREADS", "3")
        monkeypatch.setenv("CNMF_TPU_STREAM_DEPTH", "3")
    else:
        monkeypatch.setenv("CNMF_TPU_STREAM_DEPTH", "1")
    monkeypatch.setenv("CNMF_TPU_STREAM_TRANSPORT", "csr")
    return request.param


@pytest.fixture
def small_slabs(monkeypatch):
    monkeypatch.setattr(tst, "SLAB_ROWS", 16)
    monkeypatch.setattr(jst, "DENSIFY_SLAB_ROWS", 16)
    return 16


def _csr(n=100, g=24, seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    X = sp.random(n, g, density=density, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.integers(1, 9, s).astype(float))
    return X.astype(np.float32)


def _matrix(kind, **kw):
    X = _csr(**kw)
    return X if kind == "csr" else X.toarray()


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _store(tmp_path, X, slab_rows=13):
    tss.write_shard_store(str(tmp_path / "x.store"), X, slab_rows=slab_rows)
    return (tss.open_shard_store(str(tmp_path / "x.store")),
            jss.open_shard_store(str(tmp_path / "x.store")))


# ---------------------------------------------------------------------------
# the pipeline itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_source", [False, True])
def test_run_pipeline_beats_as_jax_does(pipeline, with_source):
    tasks = list(range(9))
    kw = {} if pipeline == "threaded" else {"depth": 1}
    runs = []
    for mod in (tst, jst):
        rec = Recorder()
        seen = []
        if with_source:
            mod.run_pipeline(tasks, lambda t, raw: raw * 2,
                             lambda t, p: seen.append(p), fault_context="ctx",
                             liveness=rec, source=lambda t: t + 1, **kw)
        else:
            mod.run_pipeline(tasks, lambda t: t * 2,
                             lambda t, p: seen.append(p), fault_context="ctx",
                             liveness=rec, **kw)
        runs.append((rec, seen))
    (trec, tseen), (jrec, jseen) = runs
    assert tseen == jseen
    assert trec.beats == jrec.beats == [("stage:ctx", i) for i in range(9)]
    # the committing thread stamps, never a worker
    assert trec.threads == {threading.get_ident()}


def test_run_pipeline_without_a_context_beats_stream():
    rec = Recorder()
    tst.run_pipeline([0, 1], lambda t: t, lambda t, p: None, liveness=rec)
    assert rec.beats == [("stage:stream", 0), ("stage:stream", 1)]


# ---------------------------------------------------------------------------
# the store's slab plan: equal lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["csr", "dense"])
@pytest.mark.parametrize("rows", [None, (20, 83)])
def test_stream_store_beats_equal_jax(tmp_path, pipeline, kind, rows):
    X = _matrix(kind)
    tstore, jstore = _store(tmp_path, X)
    trec, jrec = Recorder(), Recorder()
    out = tst.stream_store(tss.SlabCursor(tstore, rows=rows), "cpu",
                           liveness=trec, pad_rows=3)
    sharding = NamedSharding(_jmesh((1,), ("cells",)), P("cells", None))
    jout = jst.stream_store_sharded(jss.SlabCursor(jstore, rows=rows),
                                    sharding, liveness=jrec, pad_rows=3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    lo, hi = rows or (0, X.shape[0])
    n_slabs = len(tstore.slab_indices_for_rows(lo, hi))
    assert n_slabs > 1
    assert trec.beats == jrec.beats == [("stage:stream_store", i)
                                        for i in range(n_slabs)]


def test_stream_rows_to_mesh_from_a_store_beats_equal_jax(tmp_path,
                                                          pipeline):
    X = _csr()
    tstore, jstore = _store(tmp_path, X)
    trec, jrec = Recorder(), Recorder()
    Xd, pad = trs.stream_rows_to_mesh(tstore, "cpu", liveness=trec)
    jXd, jpad = jrs.stream_rows_to_mesh(jstore, _jmesh((1,), ("cells",)),
                                        "cells", liveness=jrec)
    assert pad == jpad == 0
    np.testing.assert_array_equal(Xd.numpy(), np.asarray(jXd))
    assert trec.beats == jrec.beats and len(trec.beats) == len(tstore.slabs)


# ---------------------------------------------------------------------------
# the port's own slabs: one beat a committed slab
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["csr", "dense"])
@pytest.mark.parametrize("shards", [1, 3])
def test_stream_rows_to_mesh_beats_once_a_slab(pipeline, small_slabs, kind,
                                               shards):
    X = _matrix(kind)
    stats = tst.StreamStats()
    rec = Recorder()
    target = "cpu" if shards == 1 else Mesh(["cpu"] * shards, ("cells",))
    Xd, pad = trs.stream_rows_to_mesh(X, target, stats=stats, liveness=rec)
    dense = X.toarray() if sp.issparse(X) else X
    got = (Xd.numpy() if shards == 1
           else np.concatenate([p.numpy() for p in Xd.parts]))
    np.testing.assert_array_equal(got[:X.shape[0]], dense)
    assert stats.slabs > shards
    jrec = Recorder()
    jrs.stream_rows_to_mesh(X, _jmesh((shards,), ("cells",)), "cells",
                            liveness=jrec)
    (phase,) = {p for p, _ in jrec.beats}
    assert phase == ("stage:stream_csr:csr" if kind == "csr"
                     else "stage:stream_dense")
    assert rec.beats == [(phase, i) for i in range(stats.slabs)]


def test_prepare_rowsharded_hands_its_liveness_down(pipeline, small_slabs):
    X = _csr()
    rec, jrec = Recorder(), Recorder()
    trs.prepare_rowsharded(X, "cpu", liveness=rec)
    jrs.prepare_rowsharded(X, _jmesh((1,), ("cells",)), liveness=jrec)
    assert rec.beats == jrec.beats
    assert len(rec.beats) == -(-X.shape[0] // small_slabs)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("source", ["csr", "store"])
def test_stream_ell_to_mesh_beats_once_a_shard(tmp_path, pipeline, shards,
                                               source):
    X = _csr(density=0.1)
    tstore, jstore = _store(tmp_path, X)
    rec, jrec = Recorder(), Recorder()
    target = "cpu" if shards == 1 else Mesh(["cpu"] * shards, ("cells",))
    trs.stream_ell_to_mesh(tstore if source == "store" else X, target,
                           liveness=rec)
    jrs.stream_ell_to_mesh(jstore if source == "store" else X,
                           _jmesh((shards,), ("cells",)), "cells",
                           liveness=jrec)
    assert rec.beats == jrec.beats == [("stage:stream_ell", i)
                                       for i in range(shards)]


@pytest.mark.parametrize("source", ["csr", "dense", "store"])
def test_stage_x_grid_beats_once_a_stripe(tmp_path, pipeline, source):
    X = _matrix("dense" if source == "dense" else "csr")
    tstore, jstore = _store(tmp_path, X)
    rec, jrec = Recorder(), Recorder()
    gx, _, _ = tgrid.stage_x_grid(tstore if source == "store" else X,
                                  tgrid.mesh_grid2d(2, 2, devices=["cpu"] * 4),
                                  liveness=rec)
    jXd, _, _ = jgrid.stage_x_grid(jstore if source == "store" else X,
                                   _jmesh((2, 2), ("cells", "genes")),
                                   liveness=jrec)
    assert rec.beats == jrec.beats == [("stage:stage_x_grid", i)
                                       for i in range(2)]


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)])
def test_stage_x_2d_beats_once_a_slab_of_a_fibre(pipeline, small_slabs,
                                                 shape):
    X = _csr(n=96)
    rec, jrec = Recorder(), Recorder()
    staged = tmh.stage_x_2d(X, tmh.mesh_2d(shape[0], devices=["cpu"] * 4
                                           if shape == (2, 2) else
                                           ["cpu"] * 3), liveness=rec)
    jmh.stage_x_2d(X, _jmesh(shape, ("replicates", "cells")), liveness=jrec)
    phase = "stage:stream_csr:csr"
    # a fibre's shards stage once (a row whose devices another row holds
    # shares them); JAX stages every device of every replicate row
    per_fibre = sum(-(-(p.shape[0]) // small_slabs)
                    for p in staged[0].parts)
    fibres = 1 if shape == (2, 2) else shape[0]
    assert rec.beats == [(phase, i) for i in range(per_fibre * fibres)]
    assert jrec.beats == [(phase, i) for i in range(per_fibre * shape[0])]


# ---------------------------------------------------------------------------
# the slab-looped groups: equal lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_the_slab_looped_solve_beats_as_jax(tmp_path, pipeline, monkeypatch,
                                            beta_loss):
    rng = np.random.default_rng(3)
    X = rng.poisson(rng.gamma(0.5, 1.0, (150, 1))
                    * rng.gamma(0.5, 1.0, (1, 40)) * 3.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    tstore, jstore = _store(tmp_path, X, slab_rows=20)
    monkeypatch.setenv("CNMF_TPU_OOC_SHARD_BYTES", str(50 * 40 * 4))
    rec, jrec = Recorder(), Recorder()
    kw = dict(beta_loss=beta_loss, n_passes=3, tol=0.0, seed=1)
    trs.nmf_fit_rowsharded(tstore, 3, store_slab_loop=True, device="cpu",
                           heartbeat=rec, **kw)
    jrs.nmf_fit_rowsharded(jstore, 3, _jmesh((1,), ("cells",)),
                           store_slab_loop=True, heartbeat=jrec, **kw)
    assert rec.beats == jrec.beats
    phases = [p for p, _ in rec.beats]
    assert phases.count("ooc_group") == 3 * 3
    assert phases.count("stage:stream_store") > phases.count("ooc_group")


# ---------------------------------------------------------------------------
# factorize hands its heartbeat to its staging
# ---------------------------------------------------------------------------

class RecordingHeartbeat(elastic.Heartbeat):
    """The factorize paths' ``Heartbeat``, recording what they stamp."""

    log: list = []

    def beat(self, phase=None, cursor=None, force=False):
        RecordingHeartbeat.log.append((phase, cursor))
        return super().beat(phase=phase, cursor=cursor, force=force)


@pytest.fixture
def heartbeats(monkeypatch):
    RecordingHeartbeat.log = []
    monkeypatch.setenv("CNMF_TPU_HEARTBEAT_S", "30")
    monkeypatch.setattr(elastic, "Heartbeat", RecordingHeartbeat)
    return RecordingHeartbeat.log


def _run(tmp_path, name, n=240):
    rng = np.random.default_rng(1)
    X = rng.poisson(rng.gamma(0.5, 1.0, (n, 1))
                    * rng.gamma(0.5, 1.0, (1, 300)) * 4.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    fn = str(tmp_path / f"c{n}.df.npz")
    if not os.path.exists(fn):
        save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(n)]),
                             np.asarray([f"g{j}" for j in range(300)])), fn)
    obj = cNMF(str(tmp_path), name, device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=4,
                num_highvar_genes=150, beta_loss="kullback-leibler")
    return obj


def test_the_row_sharded_factorize_beats_while_it_stages(tmp_path, pipeline,
                                                         small_slabs,
                                                         heartbeats,
                                                         monkeypatch):
    obj = _run(tmp_path, "rs")
    # a distinct spec string a case: a parsed spec's counters live for
    # the process
    lost = 3 if pipeline == "threaded" else 2
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       f"hostloss:context=replicate,after=1,devices={lost}")
    with pytest.warns(RuntimeWarning, match="continuing degraded"):
        obj.factorize(rowshard=True, mesh=Mesh(["cpu"] * 4, ("cells",)))
    assert heartbeats[0] == ("stage_x", None)
    stage = [b for b in heartbeats if b[0].startswith("stage:")]
    phases = {p for p, _ in stage}
    assert len(phases) == 1
    # two stagings, 4 shards then 3, each one beat a committed slab
    runs, cur = [], []
    for phase, cursor in stage:
        if cursor == 0 and cur:
            runs.append(cur)
            cur = []
        cur.append(cursor)
    runs.append(cur)
    assert len(runs) == 2
    for run, shards in zip(runs, (4, 3)):
        rows_per = -(-240 // shards)
        assert run == list(range(shards * -(-rows_per // small_slabs)))
    first_pass = heartbeats.index(next(b for b in heartbeats
                                       if b[0] == "pass"))
    assert all(b[0] in ("stage_x",) or b[0].startswith("stage:")
               for b in heartbeats[:first_pass])


def test_the_grid_factorize_beats_while_it_stages(tmp_path, pipeline,
                                                  heartbeats):
    obj = _run(tmp_path, "grid")
    obj.factorize(mesh=tgrid.mesh_grid2d(2, 2, devices=["cpu"] * 4))
    assert heartbeats[:3] == [("stage_x", None), ("stage:stage_x_grid", 0),
                              ("stage:stage_x_grid", 1)]
    assert [b for b in heartbeats if b[0].startswith("stage:")] \
        == heartbeats[1:3]


def test_the_2d_factorize_restages_with_beats_after_a_remesh(
        tmp_path, pipeline, small_slabs, heartbeats, monkeypatch):
    """JAX's own 2-D sweep raises under this JAX, so its re-stage is held
    to a direct call of JAX's ``stage_x_2d`` on the re-meshed layout."""
    staged = []
    real = tmh.stage_x_2d

    def spy(X, mesh, **kw):
        staged.append((X, mesh))
        return real(X, mesh, **kw)

    monkeypatch.setattr(tmh, "stage_x_2d", spy)
    lost = 3 if pipeline == "threaded" else 2
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       f"hostloss:context=sweep2d,devices={lost}")
    obj = _run(tmp_path, "lossy2d")
    with pytest.warns(RuntimeWarning, match="re-planned"):
        obj.factorize(mesh=tmh.mesh_2d(devices=["cpu"] * 4))
    assert heartbeats[0] == ("stage_x_2d", None)
    assert len(staged) == 2
    # the first staging, then the re-stage, each after a stage/sweep beat
    first_sweep = heartbeats.index(next(b for b in heartbeats
                                        if b[0] == "sweep2d"))
    first = [b for b in heartbeats[:first_sweep] if b[0].startswith("stage:")]
    second = [b for b in heartbeats[first_sweep:]
              if b[0].startswith("stage:")]
    assert first and first == [(first[0][0], i) for i in range(len(first))]
    X, mesh = staged[1]
    assert tuple(mesh.devices.shape) == (1, 3)
    jrec = Recorder()
    jmh.stage_x_2d(X, _jmesh((1, 3), ("replicates", "cells")),
                   liveness=jrec)
    assert second == jrec.beats


# ---------------------------------------------------------------------------
# the effect: a slow staging keeps the worker fresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hand_down", [True, False])
def test_a_slow_staging_keeps_the_worker_fresh(tmp_path, monkeypatch,
                                               small_slabs, hand_down):
    """A real ``Heartbeat`` at 0.05 s and slab reads slowed by the
    ``stall`` fault hook: read mid-staging, past the straggler window,
    the worker's heartbeat file is fresh when the staging holds the
    heartbeat, and stale when only the forced beat before staging was
    stamped (the port before liveness reached its staging)."""
    monkeypatch.setenv("CNMF_TPU_STREAM_DEPTH", "1")
    # a distinct spec string a case: a parsed spec's counters live for
    # the process
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC",
                       "stall:context=stream_csr,seconds=0.12,"
                       f"limit={12 + int(hand_down)}")
    X = _csr(n=12 * small_slabs)
    hb = elastic.Heartbeat(str(tmp_path), "run", 0, interval_s=0.05)
    window = max(0.3, 3 * hb.interval_s)   # max(STRAGGLER_S, 3 x HEARTBEAT_S)
    hb.beat(phase="stage_x", force=True)
    fresh = []

    def watch():
        time.sleep(window + 0.4)
        fresh.append(tlauncher.heartbeat_fresh(
            elastic.Heartbeat.read(hb.path), window))

    t = threading.Thread(target=watch)
    t.start()
    t0 = time.monotonic()
    trs.stream_rows_to_mesh(X, "cpu", liveness=hb if hand_down else None)
    took = time.monotonic() - t0
    t.join()
    assert took > window + 0.4
    assert fresh == [hand_down]
    rec = elastic.Heartbeat.read(hb.path)
    assert rec["phase"] == ("stage:stream_csr:csr" if hand_down
                            else "stage_x")
