"""The port's serving tier (``cnmf_torch_tpu_torch/serving/``) on the CPU:
the resident reference, the batching projection service, the HTTP daemon,
and their parity with the JAX package's serving tier.

The inputs are the JAX package's serving fixtures (K=6, G=90) made from a
seed with numpy, and a port-built consensus run of 300 x 800 counts. The
tolerances:

* the batched program against JAX's ``batched_project`` on identical
  padded lane stacks, and the whole service against JAX's service with
  both default inits set to the same rows: ``rtol 1e-4, atol 1e-6``;
* each served request against the port's solo ``fit_h``: ``rtol 1e-5,
  atol 1e-6`` (a served lane is its solo chunk solve on a stack of
  another shape; on the CPU the two agree bit for bit here, and the tests
  count the identical replies without requiring them);
* the cost formula, ring routing and token buckets: equal.

Every test that waits on a socket has its own deadline (client timeouts
and thread joins of at most 60 s).
"""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from cnmf_torch_tpu_torch.ops.nmf import fit_h, fit_h_default_init
from cnmf_torch_tpu_torch.serving import (
    PoisonError,
    ProjectionService,
    QuarantinedError,
    ReferenceError,
    ResidentReference,
    ServeClient,
    ServeDaemon,
    ShedError,
    find_references,
    load_reference,
)
from cnmf_torch_tpu_torch.serving.batcher import (
    batched_project,
    bucket_for,
    lane_buckets,
    lane_count,
    resolve_buckets,
)
from cnmf_torch_tpu_torch.utils.profiling import latency_summary, percentile

K, G = 6, 90
RTOL_SOLO, ATOL = 1e-5, 1e-6
RTOL_JAX = 1e-4
DEADLINE_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool in each would oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _W(seed=0, g=G, k=K):
    rng = np.random.default_rng(seed)
    return rng.gamma(0.3, 1.0, size=(k, g)).astype(np.float32)


def _reference(beta=2.0, chunk_size=5000, seed=0, g=G, k=K, **kw):
    return ResidentReference(_W(seed, g, k), beta=beta,
                             chunk_size=chunk_size, chunk_max_iter=150,
                             h_tol=0.05, l1_H=0.0, **kw)


def _query(ref, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.dirichlet(np.ones(ref.k) * 0.3, size=n)
    return (u @ ref.W * 40.0
            + rng.random((n, ref.n_genes)) * 0.01).astype(np.float32)


def _solo(ref, X, H_init=None):
    """The solo comparator: the port's cNMF.refit_usage fit_h call."""
    return fit_h(X, ref.W, H_init=H_init, chunk_size=ref.chunk_size,
                 chunk_max_iter=ref.chunk_max_iter, h_tol=ref.h_tol,
                 l1_reg_H=ref.l1_H, l2_reg_H=0.0, beta=ref.beta,
                 device="cpu")


def _service(ref, **kw):
    return ProjectionService(ref, device="cpu", **kw)


def _assert_solo(H, want):
    np.testing.assert_allclose(H, want, rtol=RTOL_SOLO, atol=ATOL)


def _run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
        assert not t.is_alive(), "a client thread passed its deadline"


# ---------------------------------------------------------------------------
# buckets / percentile units
# ---------------------------------------------------------------------------

def test_resolve_buckets_schedule_and_validation(monkeypatch):
    assert resolve_buckets(5000, "64,256,1024") == (64, 256, 1024, 5000)
    assert resolve_buckets(200, "64,256,1024") == (64, 200)
    monkeypatch.setenv("CNMF_TPU_SERVE_BUCKETS", "32, 128")
    assert resolve_buckets(5000) == (32, 128, 5000)
    with pytest.raises(ValueError, match="CNMF_TPU_SERVE_BUCKETS"):
        resolve_buckets(5000, "64,two")
    with pytest.raises(ValueError, match=">= 1"):
        resolve_buckets(5000, "0,64")


def test_bucket_and_lane_helpers_match_jax():
    from cnmf_torch_tpu.serving import batcher as jb

    buckets = (64, 256, 1024)
    assert bucket_for(1, buckets) == 64
    assert bucket_for(65, buckets) == 256
    assert bucket_for(4096, buckets) == 1024
    assert lane_buckets(8) == (1, 2, 4, 8)
    assert lane_buckets(6) == (1, 2, 4, 6)
    assert lane_count(5001, 5000) == 2
    assert lane_count(150, 64) == 3
    for n in (1, 33, 64, 65, 1000, 4096, 5000, 5001, 7500, 40000):
        assert bucket_for(n, buckets) == jb.bucket_for(n, buckets)
        assert lane_count(n, 5000) == jb.lane_count(n, 5000)
        assert lane_count(n, 64) == jb.lane_count(n, 64)
    for m in (1, 2, 3, 6, 8, 16):
        assert lane_buckets(m) == jb.lane_buckets(m)
    for chunk, spec in ((5000, "64,256,1024"), (200, "64,256,1024"),
                        (100, ""), (5000, "5000,10")):
        assert resolve_buckets(chunk, spec) == jb.resolve_buckets(chunk,
                                                                  spec)


def test_percentile_helper():
    vals = list(range(1, 101))
    assert percentile(vals, 50) == pytest.approx(50.5)
    assert percentile(vals, 99) == pytest.approx(99.01)
    assert percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        percentile([], 50)


def test_latency_summary_shape():
    s = latency_summary([0.5, 1.5, 3.0, 30.0, 700.0])
    assert s["count"] == 5 and s["max"] == 700.0
    assert sum(s["histogram"].values()) == 5
    assert latency_summary([]) == {"count": 0}


def test_serve_project_cost_equals_jax():
    from cnmf_torch_tpu.obs import costmodel as jcm
    from cnmf_torch_tpu_torch.obs import costmodel as tcm

    for b, n, g, k in ((1, 64, 90, 6), (8, 5000, 2000, 9), (4, 1024, 800, 3),
                       (0, 64, 90, 6), (2, 256, 2000, 0)):
        for beta in (2.0, 1.0, 0.0):
            for iters in (1, 150, 0):
                assert (tcm.serve_project_cost(b, n, g, k, beta=beta,
                                               iters=iters)
                        == jcm.serve_project_cost(b, n, g, k, beta=beta,
                                                  iters=iters))


# ---------------------------------------------------------------------------
# the lane solve's serving extras
# ---------------------------------------------------------------------------

def test_default_init_prefix_property():
    """One large default-init draw's first rows equal every smaller draw:
    the service's grow-only init cache relies on it."""
    big = fit_h_default_init(5000, 9).numpy()
    for n in (1, 33, 64, 100, 1000, 4999):
        assert np.array_equal(big[:n], fit_h_default_init(n, 9).numpy())
    assert np.array_equal(fit_h_default_init(100_000, 9).numpy()[:5000],
                          big)


@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_chunk_h_solve_extras_keep_bits(beta):
    """``w_colsum`` is the reduction the step would compute and
    ``return_resid`` only reads the loop: the default call's bits are
    unchanged."""
    from cnmf_torch_tpu_torch.ops.nmf import _chunk_h_solve

    ref = _reference(beta=beta)
    X = torch.from_numpy(_query(ref, 40, 3))
    H0 = fit_h_default_init(40, K)[None]
    W1 = torch.from_numpy(ref.W)[None]
    WWT = W1 @ W1.mT if beta == 2.0 else None
    plain = _chunk_h_solve(X, H0, W1, WWT, beta, 0.0, 0.0, 150, 0.05)
    H, rel = _chunk_h_solve(X, H0, W1, WWT, beta, 0.0, 0.0, 150, 0.05,
                            w_colsum=W1.sum(-1) if beta == 1.0 else None,
                            return_resid=True)
    assert torch.equal(H, plain)
    assert rel.shape == (1,) and 0.0 <= float(rel[0]) < 0.05


def _lane_stacks(ref, seed, b=4, n_pad=64, fill=(33, 64, 10, 0)):
    """A padded ``(b, n_pad, g)`` lane stack of real rows and exact-zero
    padding (the last lane empty), with uniform inits on the real rows."""
    rng = np.random.default_rng(seed)
    Xb = np.zeros((b, n_pad, ref.n_genes), np.float32)
    Hb = np.zeros((b, n_pad, ref.k), np.float32)
    for i, m in enumerate(fill):
        if m:
            Xb[i, :m] = _query(ref, m, seed + i)
            Hb[i, :m] = rng.random((m, ref.k), dtype=np.float32)
    return Xb, Hb


@pytest.mark.parametrize("beta", [2.0, 1.0])
@pytest.mark.parametrize("h_tol", [0.05, 0.0])
def test_batched_program_matches_jax(beta, h_tol):
    import jax

    from cnmf_torch_tpu.serving import ResidentReference as JRef
    from cnmf_torch_tpu.serving.batcher import batched_project as jprog

    ref = ResidentReference(_W(), beta=beta, chunk_size=5000,
                            chunk_max_iter=150, h_tol=h_tol).stage("cpu")
    jref = JRef(_W(), beta=beta, chunk_size=5000, chunk_max_iter=150,
                h_tol=h_tol).stage()
    Xb, Hb = _lane_stacks(ref, 11)
    H, rel = batched_project(
        torch.from_numpy(Xb), torch.from_numpy(Hb), ref.Wd, ref.WWT,
        ref.w_colsum, ref.h_tol_dev, beta=beta, max_iter=150, l1=0.0,
        l2=0.0)
    jH, jrel = jprog()(jax.device_put(Xb), jax.device_put(Hb), jref.Wd,
                       jref.WWT, jref.w_colsum, jref.h_tol_dev, beta=beta,
                       max_iter=150, l1=0.0, l2=0.0)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=RTOL_JAX,
                               atol=ATOL)
    assert np.array_equal(np.isfinite(rel.numpy()),
                          np.isfinite(np.asarray(jrel)))
    # padded rows and the empty lane stay exact zeros
    assert not H.numpy()[0, 33:].any() and not H.numpy()[2, 10:].any()
    assert not H.numpy()[3].any() and float(rel[3]) == 0.0


def test_nonfinite_lane_grades_alone():
    from cnmf_torch_tpu_torch.ops.nmf import lane_health

    ref = _reference(beta=1.0).stage("cpu")
    Xb, Hb = _lane_stacks(ref, 5)
    Xb[1, 7, 3] = np.nan
    H, rel = batched_project(
        torch.from_numpy(Xb), torch.from_numpy(Hb), ref.Wd, ref.WWT,
        ref.w_colsum, ref.h_tol_dev, beta=1.0, max_iter=150, l1=0.0,
        l2=0.0)
    health = lane_health(rel.numpy(), spectra=H.numpy())
    assert health.tolist() == [True, False, True, True]


# ---------------------------------------------------------------------------
# the service against the port's solo fit_h, and against JAX's service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_batched_requests_match_solo(beta):
    ref = _reference(beta=beta)
    with _service(ref, max_batch=8, linger_ms=60.0,
                  warm_start=False) as svc:
        queries = [_query(ref, n, seed) for n, seed in
                   ((33, 1), (100, 2), (256, 3))]
        results = [None] * len(queries)

        def go(i):
            results[i] = svc.project(queries[i], tenant=f"t{i}")

        _run_threads([lambda i=i: go(i) for i in range(len(queries))])
        identical = 0
        for q, (H, meta) in zip(queries, results):
            want = _solo(ref, q)
            _assert_solo(H, want)
            identical += int(np.array_equal(H, want))
        print(f"beta={beta}: {identical}/{len(queries)} replies bit-"
              f"identical to solo fit_h")
        stats = svc.stats()
    assert stats["ok"] == 3
    assert stats["cold_dispatches_after_warmup"] == 0
    assert stats["programs_warmed"] == len(svc.b_buckets) * len(svc.buckets)


def test_multichunk_request_matches_solo():
    """A request taller than the chunk size splits into the solo chunk
    partition, one lane a chunk."""
    ref = _reference(beta=2.0, chunk_size=64)
    with _service(ref, max_batch=8, linger_ms=0.0,
                  warm_start=False) as svc:
        X = _query(ref, 150, 7)
        H, meta = svc.project(X)
        assert meta["batch_lanes"] == 3
        _assert_solo(H, _solo(ref, X))


def test_two_racing_clients_land_in_one_batch():
    ref = _reference(beta=2.0)
    with _service(ref, max_batch=4, linger_ms=120.0,
                  warm_start=False) as svc:
        Xa, Xb = _query(ref, 40, 11), _query(ref, 55, 12)
        out = {}

        def go(name, X):
            out[name] = svc.project(X, tenant=name)

        _run_threads([lambda: go("a", Xa), lambda: go("b", Xb)])
        assert out["a"][1]["batch_requests"] == 2
        assert out["b"][1]["batch_requests"] == 2
        _assert_solo(out["a"][0], _solo(ref, Xa))
        _assert_solo(out["b"][0], _solo(ref, Xb))
        assert svc.stats()["multi_request_batches"] >= 1


@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_service_matches_jax_service(beta, monkeypatch):
    """The same requests through both services, both default inits set to
    the same seeded rows (the packages' generators differ)."""
    from cnmf_torch_tpu.serving import ProjectionService as JService
    from cnmf_torch_tpu.serving import ResidentReference as JRef

    init = np.random.default_rng(99).random((5000, K), dtype=np.float32)
    monkeypatch.setattr(ProjectionService, "_default_init",
                        lambda self, n: init[:n])
    monkeypatch.setattr(JService, "_default_init",
                        lambda self, n: init[:n])
    ref = _reference(beta=beta, chunk_size=128)
    jref = JRef(ref.W, beta=beta, chunk_size=128, chunk_max_iter=150,
                h_tol=0.05, l1_H=0.0)
    sizes = ((20, 1), (128, 2), (300, 3))
    queries = [_query(ref, n, s) for n, s in sizes]
    with _service(ref, max_batch=8, linger_ms=0.0,
                  warm_start=False) as svc, \
            JService(jref, max_batch=8, linger_ms=0.0,
                     warm_start=False) as jsvc:
        for X in queries:
            H, meta = svc.project(X)
            jH, jmeta = jsvc.project(X)
            np.testing.assert_allclose(H, jH, rtol=RTOL_JAX, atol=ATOL)
            assert meta["batch_lanes"] == jmeta["batch_lanes"]


def test_poison_quarantines_without_sinking_batchmates():
    ref = _reference(beta=2.0)
    with _service(ref, max_batch=4, linger_ms=120.0,
                  warm_start=False) as svc:
        good = _query(ref, 30, 21)
        bad = _query(ref, 20, 22)
        bad[5, 3] = np.nan
        out = {}

        def go_good():
            out["good"] = svc.project(good, tenant="fine")

        def go_bad():
            try:
                svc.project(bad, tenant="evil")
                out["bad"] = "no error"
            except PoisonError as exc:
                out["bad"] = exc

        _run_threads([go_good, go_bad])
        assert isinstance(out["bad"], PoisonError)
        H, meta = out["good"]
        assert meta["batch_requests"] == 2
        _assert_solo(H, _solo(ref, good))
        for _ in range(2):
            with pytest.raises(PoisonError):
                svc.project(bad, tenant="evil")
        with pytest.raises(QuarantinedError):
            svc.project(good, tenant="evil")
        H2, _ = svc.project(good, tenant="fine")
        _assert_solo(H2, _solo(ref, good))


def test_admission_shed_paths():
    ref = _reference()
    svc = _service(ref, max_batch=1, linger_ms=0.0, timeout_s=0.05,
                   warm_start=False)
    svc._running = True
    for _ in range(svc._q.maxsize):
        svc._q.put_nowait(object())
    with pytest.raises(ShedError, match="queue full"):
        svc.submit(_query(ref, 5, 1))
    while not svc._q.empty():
        svc._q.get_nowait()
    req = svc.submit(_query(ref, 5, 2))
    req.t_enqueue -= 10.0
    assert svc._expired(req)
    with pytest.raises(ShedError, match="CNMF_TPU_SERVE_TIMEOUT_S"):
        req.wait(1.0)
    svc._running = False


def test_admission_validates_shape_and_accounts_rejections():
    ref = _reference(chunk_size=64)
    with _service(ref, max_batch=2, linger_ms=0.0,
                  warm_start=False) as svc:
        with pytest.raises(Exception, match="genes"):
            svc.submit(np.ones((4, ref.n_genes + 1), np.float32))
        with pytest.raises(Exception, match="matrix"):
            svc.submit(np.ones((0, ref.n_genes), np.float32))
        with pytest.raises(Exception, match="split the matrix"):
            svc.submit(np.ones((64 * 2 + 1, ref.n_genes), np.float32))
        stats = svc.stats()
        assert stats["error"] == 3
        assert stats["requests"] == 3


def test_dispatch_failure_replies_with_an_error(monkeypatch):
    """A failed dispatch answers every request of its batch with an error
    and leaves the daemon serving; it never retries elsewhere."""
    from cnmf_torch_tpu_torch.serving import batcher

    ref = _reference()
    with _service(ref, max_batch=2, linger_ms=0.0,
                  warm_start=False) as svc:
        real = batcher.batched_project

        def broken(*a, **kw):
            raise RuntimeError("device lost")

        monkeypatch.setattr(batcher, "batched_project", broken)
        with pytest.raises(Exception, match="device lost"):
            svc.project(_query(ref, 8, 1))
        monkeypatch.setattr(batcher, "batched_project", real)
        X = _query(ref, 8, 2)
        H, _ = svc.project(X)
        _assert_solo(H, _solo(ref, X))
        assert svc.stats()["error"] == 1


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_warm_start_reuses_previous_usage(beta):
    ref = _reference(beta=beta)
    with _service(ref, max_batch=2, linger_ms=0.0, warm_start=True) as svc:
        X = _query(ref, 48, 31)
        H1, meta1 = svc.project(X, tenant="repeat")
        assert meta1["warm_start"] is False
        H2, meta2 = svc.project(X, tenant="repeat")
        assert meta2["warm_start"] is True
        _assert_solo(H1, _solo(ref, X))
        _assert_solo(H2, _solo(ref, X, H_init=H1))
        H3, meta3 = svc.project(X, tenant="other")
        assert meta3["warm_start"] is False
        np.testing.assert_allclose(H3, H1, rtol=RTOL_SOLO, atol=ATOL)
        # a DIFFERENT matrix of the same shape stays cold: MU zeros are
        # absorbing, so warm starts are keyed by content, not shape
        X_other = _query(ref, 48, 32)
        H4, meta4 = svc.project(X_other, tenant="repeat")
        assert meta4["warm_start"] is False
        _assert_solo(H4, _solo(ref, X_other))
        assert svc.stats()["warm_started"] == 1


def _iters_to_fixed_point(ref, X, H_init, target):
    for budget in (1, 2, 4, 8, 16, 32, 64, 128, 150):
        H = fit_h(X, ref.W, H_init=H_init, chunk_size=ref.chunk_size,
                  chunk_max_iter=budget, h_tol=ref.h_tol, beta=ref.beta,
                  device="cpu")
        if np.array_equal(H, target):
            return budget
    return 10 ** 9


def test_warm_start_converges_in_fraction_of_iterations():
    ref = _reference(beta=2.0)
    X = _query(ref, 64, 41)
    H_cold = _solo(ref, X)
    cold_iters = _iters_to_fixed_point(ref, X, None, H_cold)
    H_warm_target = _solo(ref, X, H_init=H_cold)
    warm_iters = _iters_to_fixed_point(ref, X, H_cold, H_warm_target)
    assert cold_iters >= 8
    assert warm_iters * 4 <= cold_iters, (
        f"warm start took {warm_iters} iters vs cold {cold_iters}")


# ---------------------------------------------------------------------------
# resident reference
# ---------------------------------------------------------------------------

def test_reference_rejects_nonfinite_and_bad_shapes():
    W = np.ones((3, 10), np.float32)
    W[1, 2] = np.inf
    with pytest.raises(ReferenceError, match="nonfinite"):
        ResidentReference(W, beta=2.0, chunk_size=100, chunk_max_iter=10)
    with pytest.raises(ReferenceError, match="matrix"):
        ResidentReference(np.ones(5, np.float32), beta=2.0,
                          chunk_size=100, chunk_max_iter=10)


def test_reference_resident_products_on_the_services_device():
    ref = _reference(beta=2.0)
    with _service(ref, warm_start=False) as svc:
        assert svc.reference is ref
        for t in (ref.Wd, ref.WWT, ref.h_tol_dev):
            assert t.device == torch.device("cpu")
        W1 = torch.from_numpy(ref.W)[None]
        assert torch.equal(ref.WWT, W1 @ W1.mT)
        assert ref.describe()["device"] == "cpu"
        assert svc.stats()["reference"]["resident"]
    ref_kl = _reference(beta=1.0).stage("cpu")
    assert ref_kl.WWT is None
    assert torch.equal(ref_kl.w_colsum, torch.from_numpy(ref_kl.W)[None]
                       .sum(-1))
    assert ref_kl.stage("cpu") is ref_kl


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _reference().stage()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProjectionService(_reference()).start(warmup=False)


# ---------------------------------------------------------------------------
# run-directory reference resolution + serve events (port-built run)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """A consensus-complete port run of 300 cells x 800 genes."""
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

    tmp = str(tmp_path_factory.mktemp("serve_run"))
    rng = np.random.default_rng(5)
    usage = rng.dirichlet(np.ones(4) * 0.3, size=300)
    spectra = rng.gamma(0.3, 1.0, size=(4, 800)) * 40.0 / 80
    counts = rng.poisson(usage @ spectra * 25.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.array([f"c{i}" for i in range(300)]),
                         np.array([f"g{j}" for j in range(800)])), fn)
    obj = cNMF(tmp, "srv", device="cpu")
    obj.prepare(fn, components=[3], n_iter=6, seed=11,
                num_highvar_genes=120, beta_loss="kullback-leibler",
                max_NMF_iter=100)
    obj.factorize()
    obj.combine()
    obj.consensus(3, density_threshold=2.0, show_clustering=False)
    return obj, os.path.join(tmp, "srv")


def test_load_reference_from_run_dir(serve_run):
    obj, run_dir = serve_run
    refs = find_references(run_dir)
    assert [r["k"] for r in refs] == [3]
    ref = load_reference(run_dir)
    assert ref.k == 3 and ref.n_genes == 120 and ref.beta == 1.0
    params = obj._solver_params()
    assert ref.chunk_size == params["online_chunk_size"]
    assert ref.chunk_max_iter == params["online_chunk_max_iter"]
    assert ref.genes is not None and len(ref.genes) == 120
    assert load_reference(run_dir, k=3, density_threshold="2.0").k == 3
    with pytest.raises(ReferenceError, match="no consensus"):
        load_reference(run_dir, k=9)
    second = refs[0]["path"].replace("dt_2_0", "dt_0_4")
    shutil.copyfile(refs[0]["path"], second)
    try:
        with pytest.raises(ReferenceError, match="multiple"):
            load_reference(run_dir)
        assert load_reference(run_dir, density_threshold="0.4").k == 3
    finally:
        os.unlink(second)


def test_load_reference_reads_a_jax_yaml_parameters_file(serve_run,
                                                         tmp_path):
    """A run directory whose parameters file is YAML (the JAX package's)
    loads through the lazy yaml import; an unreadable one raises a
    ReferenceError naming the file."""
    import yaml

    _, run_dir = serve_run
    other = tmp_path / "srv"
    shutil.copytree(run_dir, other)
    params_fn = other / "cnmf_tmp" / "srv.nmf_idvrun_params.yaml"
    params = load_reference(run_dir)
    with open(params_fn) as f:
        doc = yaml.safe_load(f)
    with open(params_fn, "w") as f:
        yaml.safe_dump(doc, f)
    assert not open(params_fn).read().lstrip().startswith("{")
    ref = load_reference(str(other))
    assert (ref.beta, ref.chunk_size) == (params.beta, params.chunk_size)
    with open(params_fn, "w") as f:
        f.write("a: [unclosed\n")
    with pytest.raises(ReferenceError, match="nmf_idvrun_params"):
        load_reference(str(other))


def test_load_reference_from_shard_store(serve_run):
    obj, run_dir = serve_run
    from cnmf_torch_tpu_torch.utils.shardstore import write_shard_store

    base = load_reference(run_dir)
    store_dir = os.path.join(run_dir, "cnmf_tmp", "ref.store")
    write_shard_store(store_dir, base.W,
                      var_names=[str(g) for g in base.genes])
    try:
        ref = load_reference(run_dir, spectra_path=store_dir)
        assert np.array_equal(ref.W, base.W)
        assert ref.genes == [str(g) for g in base.genes]
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def test_serve_matches_refit_usage_on_run_fixture(serve_run):
    obj, run_dir = serve_run
    ref = load_reference(run_dir)
    rng = np.random.default_rng(17)
    X = rng.gamma(1.0, 1.0, size=(37, ref.n_genes)).astype(np.float32)
    with _service(ref, max_batch=4, linger_ms=0.0,
                  warm_start=False) as svc:
        H, _ = svc.project(X)
    _assert_solo(H, obj.refit_usage(X, ref.W))


def test_serve_events_schema_and_report(tmp_path, monkeypatch):
    from cnmf_torch_tpu_torch.utils.telemetry import (EventLog, read_events,
                                                      render_report,
                                                      summarize_events,
                                                      validate_events_file)

    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.setenv("CNMF_TPU_PERF_MODEL", "1")
    ev_dir = tmp_path / "evrun" / "cnmf_tmp"
    ev_dir.mkdir(parents=True)
    ev_path = str(ev_dir / "evrun.events.jsonl")
    events = EventLog(ev_path, manifest_extra={"run_name": "evrun"},
                      device="cpu")
    ref = _reference(beta=2.0)
    with _service(ref, max_batch=4, linger_ms=80.0, warm_start=False,
                  events=events) as svc:
        Xa, Xb = _query(ref, 16, 61), _query(ref, 24, 62)
        outs = []
        _run_threads([lambda X=X, t=t: outs.append(svc.project(X, tenant=t))
                      for X, t in ((Xa, "a"), (Xb, "b"))])
        bad = Xa.copy()
        bad[0, 0] = np.nan
        with pytest.raises(PoisonError):
            svc.project(bad, tenant="evil")
    svc.emit_perf_model()

    assert validate_events_file(ev_path) > 0
    evs = read_events(ev_path)
    kinds = {e["t"] for e in evs}
    assert {"manifest", "serve_request", "serve_batch", "perf_model"} <= kinds
    assert max(e["requests"] for e in evs if e["t"] == "serve_batch") > 1
    perf = [e for e in evs if e["t"] == "perf_model"]
    assert len(perf) == 1 and perf[0]["stage"] == "serve"
    assert perf[0]["roofline"]["perf_exempt"]
    assert perf[0]["predicted"]["iters_assumed_cap"]
    s = summarize_events(evs)
    assert s["serving"]["requests"] == 3
    assert s["serving"]["by_status"] == {"ok": 2, "poison": 1}
    assert s["serving"]["multi_request_batches"] >= 1
    assert "p95" in s["serving"]["latency_ms"]
    report = render_report(str(tmp_path / "evrun"))
    assert "Serving (projection daemon)" in report
    assert "latency p50" in report
    # the JAX package's validator and summary read the port's stream too
    from cnmf_torch_tpu.utils import telemetry as jtel

    assert jtel.validate_events_file(ev_path) == validate_events_file(
        ev_path)
    assert jtel.summarize_events(evs)["serving"] == s["serving"]


# ---------------------------------------------------------------------------
# the daemon (HTTP over unix socket / TCP)
# ---------------------------------------------------------------------------

def test_daemon_unix_socket_end_to_end(tmp_path):
    ref = _reference(beta=2.0)
    svc = _service(ref, max_batch=4, linger_ms=5.0, warm_start=False)
    sock = str(tmp_path / "serve.sock")
    daemon = ServeDaemon(svc, socket_path=sock).start()
    try:
        cli = ServeClient(socket_path=sock, timeout=DEADLINE_S)
        hz = cli.healthz()
        assert hz["ok"] and hz["reference"]["resident"]
        assert hz["reference"]["device"] == "cpu"
        X = _query(ref, 21, 71)
        H_b64, meta = cli.project(X)
        _assert_solo(H_b64, _solo(ref, X))
        H_json, _ = cli.project(X, encoding="data")
        assert np.array_equal(H_json, H_b64)
        assert cli.stats()["ok"] == 2
        assert cli.reference()["components"]
        assert "disabled" in cli.metrics()
        with pytest.raises(Exception, match="genes"):
            cli.project(np.ones((3, ref.n_genes + 2), np.float32))
        status, body = cli._request("POST", "/project", {"tenant": "x"})
        assert status == 400 and body["status"] == "error"
        assert cli._request("GET", "/nope")[0] == 404
        assert cli.shutdown()
    finally:
        daemon.close()
    assert not os.path.exists(sock)


def test_daemon_tcp_loopback():
    ref = _reference(beta=1.0)
    svc = _service(ref, max_batch=2, linger_ms=0.0, warm_start=False)
    daemon = ServeDaemon(svc, port=0).start()
    try:
        port = daemon.server.server_address[1]
        assert daemon.address == f"127.0.0.1:{port}"
        cli = ServeClient(port=port, timeout=DEADLINE_S)
        X = _query(ref, 9, 81)
        H, _ = cli.project(X)
        _assert_solo(H, _solo(ref, X))
    finally:
        daemon.close()


def test_daemon_replaces_stale_socket(tmp_path):
    sock = str(tmp_path / "stale.sock")
    with open(sock, "w") as f:
        f.write("")
    svc = _service(_reference(), linger_ms=0.0, warm_start=False)
    daemon = ServeDaemon(svc, socket_path=sock)
    daemon.start()
    try:
        assert ServeClient(socket_path=sock,
                           timeout=DEADLINE_S).healthz()["ok"]
    finally:
        daemon.close()
    assert not os.path.exists(sock)


def test_daemon_serves_the_jax_client(tmp_path):
    """The wire format is the JAX package's: its client talks to the
    port's daemon."""
    from cnmf_torch_tpu.serving import ServeClient as JClient

    ref = _reference(beta=2.0)
    svc = _service(ref, max_batch=2, linger_ms=0.0, warm_start=False)
    sock = str(tmp_path / "j.sock")
    daemon = ServeDaemon(svc, socket_path=sock).start()
    try:
        cli = JClient(socket_path=sock, timeout=DEADLINE_S)
        X = _query(ref, 12, 5)
        for enc in ("b64", "data"):
            H, _ = cli.project(X, encoding=enc, request_id=f"r-{enc}")
            _assert_solo(H, _solo(ref, X))
    finally:
        daemon.close()


def test_cli_serve_argument_validation(tmp_path):
    from cnmf_torch_tpu_torch.cli import main as cli_main

    with pytest.raises(SystemExit) as exc:
        cli_main(["serve", str(tmp_path / "nope"), "--device", "cpu"])
    assert exc.value.code == 2
    (tmp_path / "cnmf_tmp").mkdir()
    with pytest.raises(SystemExit) as exc:
        cli_main(["serve", str(tmp_path), "--socket", "/tmp/x.sock",
                  "--port", "1234", "--device", "cpu"])
    assert exc.value.code == 2
    # an unprepared run dir is a one-line usage error, not a traceback
    with pytest.raises(SystemExit) as exc:
        cli_main(["serve", str(tmp_path), "--device", "cpu"])
    assert exc.value.code == 2
    # a stray positional still fails for the pipeline stages
    with pytest.raises(SystemExit) as exc:
        cli_main(["consensus", "9"])
    assert exc.value.code == 2


def test_cli_serve_without_a_reference_names_it(serve_run, capsys):
    from cnmf_torch_tpu_torch.cli import main as cli_main

    _, run_dir = serve_run
    with pytest.raises(SystemExit) as exc:
        cli_main(["serve", run_dir, "-k", "9", "--device", "cpu"])
    assert exc.value.code == 2
    assert "no consensus spectra" in capsys.readouterr().err


@pytest.mark.parametrize("env", [
    {},
    {"CNMF_TPU_SERVE_BATCH": "4", "CNMF_TPU_SERVE_LINGER_MS": "7.5",
     "CNMF_TPU_SERVE_TIMEOUT_S": "3", "CNMF_TPU_SERVE_WARM_START": "off",
     "CNMF_TPU_SERVE_BUCKETS": "16,32"},
    {"CNMF_TPU_FLEET_REPLICAS": "3", "CNMF_TPU_FLEET_HEALTH_S": "0.25",
     "CNMF_TPU_FLEET_WEDGE_POLLS": "5", "CNMF_TPU_FLEET_RESPAWNS": "1",
     "CNMF_TPU_FLEET_WARM_TIMEOUT_S": "42", "CNMF_TPU_FLEET_RETRIES": "0",
     "CNMF_TPU_FLEET_HEDGE_MS": "20", "CNMF_TPU_FLEET_TENANT_QPS": "2",
     "CNMF_TPU_FLEET_TENANT_BURST": "9"},
])
def test_serving_knobs_read_as_jax_reads_them(env, monkeypatch):
    from cnmf_torch_tpu.serving import FleetRouter as JRouter
    from cnmf_torch_tpu.serving import ProjectionService as JService
    from cnmf_torch_tpu.serving import ResidentReference as JRef
    from cnmf_torch_tpu_torch.serving import FleetRouter

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    svc = _service(_reference())
    jsvc = JService(JRef(_W(), beta=2.0, chunk_size=5000,
                         chunk_max_iter=150))
    for attr in ("max_batch", "linger_s", "timeout_s", "warm_start",
                 "buckets", "b_buckets"):
        assert getattr(svc, attr) == getattr(jsvc, attr), attr
    assert svc._q.maxsize == jsvc._q.maxsize

    def factory(*a):
        raise AssertionError("not started")

    router = FleetRouter(replica_factory=factory)
    jrouter = JRouter(replica_factory=factory)
    for attr in ("n_replicas", "health_s", "wedge_polls", "respawn_budget",
                 "warm_timeout_s", "retries", "hedge_ms", "tenant_qps",
                 "tenant_burst", "backoff_s"):
        assert getattr(router, attr) == getattr(jrouter, attr), attr
