"""The port's autotuner (``utils/autotune.py``) on the CPU.

- Precedence at every consumer: an explicit knob beats a measured point,
  which beats the static heuristic (the staging threads, the grid's block
  count, the sketch rows, the amu rho through ``_measured_rho_scale``).
- The cache is keyed by the device fingerprint: another package version
  or another device reads nothing.
- ``CNMF_TPU_AUTOTUNE=0`` disables consumption; ``auto`` never measures on
  a stock run (nor in a stock factorize); ``1`` measures every point.
- A failure inside a microbench (a kernel call that raises) raises; it is
  not turned into the static schedule, and nothing is cached.

The measurements on the card (the ``h_stats`` and ``w_numer`` launches,
the card's name in the fingerprint) are ``tests/test_torch_cuda.py``'s.
"""

import math
import os

import numpy as np
import pytest
import torch

from cnmf_torch_tpu_torch.ops import recipe as trec
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.parallel import grid2d, streaming
from cnmf_torch_tpu_torch.runtime.planner import DISPATCH_KNOBS
from cnmf_torch_tpu_torch.utils import autotune


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    env0 = dict(os.environ)
    for knob in DISPATCH_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    prev = autotune.set_cache_dir(str(tmp_path / "autotune"))
    monkeypatch.setattr(autotune, "_active_device", None)
    yield
    autotune.set_cache_dir(prev)
    os.environ.clear()
    os.environ.update(env0)


@pytest.fixture
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _plant(section: str, values: dict, device="cpu"):
    autotune._merge_write(autotune.cache_path(device=device),
                          {section: values}, device=device)


def test_fingerprint_names_the_version_backend_device_and_count():
    assert autotune.device_fingerprint("cpu") == "v0.1.0-cpu-cpu-x1"
    assert autotune.cache_path(device="cpu").endswith(
        "rho_v0.1.0-cpu-cpu-x1.json")


def test_stream_threads_pin_beats_autotuned_beats_heuristic():
    static = max(1, min(4, (os.cpu_count() or 2) - 1))
    assert streaming.stream_threads() == static
    _plant("plan_points", {"stream_threads": 7})
    assert streaming.stream_threads() == 7
    os.environ["CNMF_TPU_STREAM_THREADS"] = "2"
    assert streaming.stream_threads() == 2


def test_grid_blocks_pin_beats_autotuned_beats_heuristic():
    assert grid2d.grid_blocks(96) == 4
    _plant("plan_points", {"grid_blocks": 8})
    assert grid2d.grid_blocks(96) == 8
    assert grid2d.grid_blocks(36) == 6       # clamped to a divisor
    os.environ["CNMF_TPU_GRID_BLOCKS"] = "2"
    assert grid2d.grid_blocks(96) == 2


def test_sketch_rows_pin_beats_autotuned_beats_heuristic():
    os.environ["CNMF_TPU_SKETCH"] = "1"
    assert trec.resolve_recipe(1.0, "batch", n=8000).sketch_dim == 1000
    _plant("plan_points", {"sketch_dim": 512})
    assert trec.resolve_recipe(1.0, "batch", n=8000).sketch_dim == 512
    assert trec.resolve_recipe(1.0, "batch", n=300).sketch_dim == 300
    os.environ["CNMF_TPU_SKETCH_DIM"] = "640"
    assert trec.resolve_recipe(1.0, "batch", n=8000).sketch_dim == 640
    assert trec.resolve_recipe(1.0, "batch", n=8000,
                               sketch_dim=100).sketch_dim == 100


def test_measured_rho_scale_reads_the_cache():
    assert trec._measured_rho_scale(2.0, False) is None
    assert trec.auto_inner_repeats(2.0, 1000, 500, 10) == 8
    _plant("scales", {"b2": 0.02, "dense": 3.0, "ell": 2.0})
    assert trec._measured_rho_scale(2.0, False) == 0.02
    assert trec._measured_rho_scale(1.0, False) == 3.0
    assert trec._measured_rho_scale(1.0, True) == 2.0
    # the measured scale moves rho (static 8 at beta=2: 1 + 100 -> clamp)
    assert trec.auto_inner_repeats(2.0, 1000, 500, 10) == 3
    assert trec.auto_inner_repeats(1.0, 1000, 500, 10) == 4
    # and an explicit rho pin wins over both
    os.environ.update(CNMF_TPU_ACCEL="1", CNMF_TPU_KL_NEWTON="0",
                      CNMF_TPU_INNER_REPEATS="5")
    assert trec.resolve_recipe(2.0, "batch", n=1000, g=500,
                               k=10).inner_repeats == 5


def test_a_fingerprint_change_invalidates_the_cache(monkeypatch):
    from cnmf_torch_tpu_torch import version

    _plant("plan_points", {"stream_threads": 7})
    _plant("scales", {"b2": 0.5})
    assert autotune.cached_plan_point("stream_threads") == 7
    monkeypatch.setattr(version, "__version__", "9.9.9")
    assert autotune.cached_plan_points() == {}
    assert autotune.cached_rho_scale(2.0) is None
    monkeypatch.setattr(version, "__version__", "0.1.0")
    # a cache file that names another device is not read either
    path = autotune.cache_path(device="cpu")
    with open(path) as f:
        text = f.read().replace("-cpu-cpu-x1", "-cuda-Other_card-x1")
    with open(path, "w") as f:
        f.write(text)
    autotune._memo.clear()
    assert autotune.cached_plan_points() == {}


def test_off_disables_consumption():
    _plant("plan_points", {"stream_threads": 7, "grid_blocks": 8})
    _plant("scales", {"b2": 0.02})
    os.environ["CNMF_TPU_AUTOTUNE"] = "0"
    assert autotune.cached_plan_points() == {}
    assert autotune.cached_rho_scale(2.0) is None
    assert grid2d.grid_blocks(96) == 4
    assert autotune.maybe_autotune_plan(device="cpu") is None
    assert autotune.maybe_autotune_rho(beta=2.0, device="cpu") is None
    os.environ["CNMF_TPU_AUTOTUNE"] = "sometimes"
    with pytest.raises(ValueError, match="CNMF_TPU_AUTOTUNE"):
        autotune.autotune_mode()


def _no_measuring(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("measured under auto")

    monkeypatch.setattr(autotune, "measure_rho_scales", boom)
    monkeypatch.setattr(autotune, "measure_plan_points", boom)


def test_auto_never_measures_a_stock_run(monkeypatch, tmp_path):
    _no_measuring(monkeypatch)
    for beta in (2.0, 1.0, 0.0):
        assert autotune.maybe_autotune_rho(beta=beta, device="cpu") is None
    assert autotune.maybe_autotune_plan(device="cpu") is None
    assert not os.path.exists(autotune.cache_path(device="cpu"))
    # an existing cache is consumed, still without measuring
    _plant("plan_points", {"stream_threads": 3})
    assert autotune.maybe_autotune_plan(device="cpu")[
        "plan_points"] == {"stream_threads": 3}
    # under auto a KL run measures rho only when the accel knobs engage
    # amu: the default Newton lane never reads it
    os.environ["CNMF_TPU_ACCEL"] = "1"
    assert autotune.maybe_autotune_rho(beta=1.0, device="cpu") is None


def test_a_stock_factorize_never_measures(monkeypatch, tmp_path,
                                          one_torch_thread):
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

    _no_measuring(monkeypatch)
    rng = np.random.default_rng(1)
    X = rng.poisson(rng.gamma(0.5, 1.0, (60, 1))
                    * rng.gamma(0.5, 1.0, (1, 80)) * 5.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    fn = str(tmp_path / "c.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(60)]),
                         np.asarray([f"g{j}" for j in range(80)])), fn)
    obj = cNMF(str(tmp_path), "stock", device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=1, num_highvar_genes=40,
                beta_loss="kullback-leibler", max_NMF_iter=20)
    obj.factorize()
    assert set(obj.plan.sources.values()) <= {"heuristic", "pin"}
    assert not os.path.exists(autotune.cache_path(device="cpu"))


def test_force_measures_every_point(one_torch_thread):
    os.environ["CNMF_TPU_AUTOTUNE"] = "1"
    rho = autotune.maybe_autotune_rho(beta=1.0, device="cpu")
    assert rho["fingerprint"] == autotune.device_fingerprint("cpu")
    assert set(rho["scales"]) == {"b2", "dense", "ell"}
    assert all(math.isfinite(v) and v > 0 for v in rho["scales"].values())
    payload = autotune.maybe_autotune_plan(device="cpu")
    pts = payload["plan_points"]
    assert {"ell_density_crossover", "grid_blocks",
            "stream_threads"} <= set(pts) <= {
        "ell_density_crossover", "grid_blocks", "stream_threads",
        "sketch_dim"}
    assert "pallas_wins" not in pts
    assert 0.01 <= pts["ell_density_crossover"] <= 0.5
    assert pts["grid_blocks"] in (1, 2, 4, 8)
    assert pts["stream_threads"] in (1, 2, 4)
    # both sections share the device's one file, and the readers see them
    assert payload["scales"] == rho["scales"]
    assert autotune.cached_plan_points() == pts


def test_the_timer_brackets_each_call_with_a_device_sync(monkeypatch):
    """On a card a wall is the device's work: every timed call sits
    between two ``torch.cuda.synchronize`` calls (the launch returns
    before the work ends)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen.append("sync"))
    autotune._time_call(lambda: seen.append("call"), "cuda", repeats=3)
    assert seen == ["call"] + ["sync", "call", "sync"] * 3


@pytest.mark.parametrize("which", ["kl_h_stats", "kl_w_stats"])
def test_a_kernel_failure_inside_the_microbench_raises(monkeypatch, which,
                                                       one_torch_thread):
    def fail(*a, **k):
        raise RuntimeError(f"{which}: CUDA error: an illegal memory access")

    monkeypatch.setattr(kl_ell, which, fail)
    os.environ["CNMF_TPU_AUTOTUNE"] = "1"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        autotune.maybe_autotune_rho(beta=1.0, device="cpu")
    if which == "kl_h_stats":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            autotune.maybe_autotune_plan(device="cpu")
    assert not os.path.exists(autotune.cache_path(device="cpu"))
    assert autotune.cached_plan_points() == {}


def test_the_tuned_crossover_decides_the_lane_the_sweeps_run(
        tmp_path, one_torch_thread):
    """A measured crossover below the matrix's density sends factorize to
    the dense lane, and the sweeps run that lane: the spectra are those of
    a run pinned dense (``CNMF_TPU_SPARSE_BETA=0``), not of the ELL lane
    the static 0.10 rule would take."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz

    rng = np.random.default_rng(14)
    usage = rng.dirichlet(np.ones(5) * 0.2, size=400)
    spectra = rng.gamma(0.25, 1.0, size=(5, 1500)) * 40.0 / 1500
    X = rng.poisson(usage @ spectra * 3.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    fn = str(tmp_path / "c.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(400)]),
                         np.asarray([f"g{j}" for j in range(1500)])), fn)

    def run(name, **env):
        obj = cNMF(str(tmp_path), name, device="cpu")
        obj.prepare(fn, components=[4], n_iter=3, seed=2,
                    num_highvar_genes=1200, beta_loss="kullback-leibler",
                    batch_size=200, max_NMF_iter=30)
        os.environ.update(env)
        try:
            obj.factorize()
        finally:
            for key in env:
                os.environ.pop(key)
        out = []
        for it in range(3):
            with np.load(obj.paths["iter_spectra"] % (4, it),
                         allow_pickle=True) as f:
                out.append(f["data"])
        return obj, np.stack(out)

    ell, s_ell = run("ell")
    assert ell.factorize_info["lane"] == "ell"
    dense, s_dense = run("dense", CNMF_TPU_SPARSE_BETA="0")
    assert dense.factorize_info["lane"] == "dense"
    assert not np.array_equal(s_ell, s_dense)
    _plant("plan_points", {"ell_density_crossover": 0.01})
    tuned, s_tuned = run("tuned")
    assert tuned.plan.sources["encoding"] == "autotuned"
    assert tuned.factorize_info["lane"] == "dense"
    assert np.array_equal(s_tuned, s_dense)


def test_f7_measuring_without_a_card_raises(monkeypatch):
    """No device named and no card visible: the measuring entry points
    raise, as every entry point of the port does (``device.py:
    resolve_device``), instead of timing the CPU. The cache readers, which
    measure nothing, keep their lookup."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for measure in (autotune.measure_rho_scales,
                    autotune.measure_plan_points):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.maybe_autotune_plan(force=True)
    assert autotune.cached_plan_points() == {}
    assert autotune.cached_rho_scale(1.0, ell=True) is None
