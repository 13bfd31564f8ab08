"""The launcher (``launcher.py``) and the CLI's ``run_parallel``, on the
CPU.

The subprocess engine's self-healing is driven with monkeypatched workers
(each worker index runs a tiny inline script, as the JAX package's
``tests/test_elastic.py`` drives its launcher): elastic adoption of a dead
shard, the adoption wave past the respawn budget, straggler containment
and the unhealthy exit code. ``respawn_delay`` equals the JAX package's.
One end-to-end ``run_parallel --engine subprocess`` pipeline (two workers)
runs under a 120 s limit; its merged spectra equal a one-process run's bit
for bit (on the CPU a replicate's lanes do not depend on its batch mates).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cnmf_torch_tpu import launcher as jlauncher
from cnmf_torch_tpu_torch import launcher
from cnmf_torch_tpu_torch.runtime import elastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _EventSink:
    def __init__(self):
        self.events = []

    def emit(self, event_type, **fields):
        self.events.append((event_type, fields))

    def kinds(self):
        return [f.get("kind") for t, f in self.events if t == "fault"]


def _indexed_cmd(spawned, behaviors):
    """A stand-in ``_worker_cmd``: each worker index runs its own inline
    script, which may branch on whether this spawn resumes."""
    def fake_cmd(od, nm, extra):
        spawned.append(list(extra))
        i = int(extra[extra.index("--worker-index") + 1])
        resume = "--skip-completed-runs" in extra
        return [sys.executable, "-c", behaviors[i](resume)]
    return fake_cmd


@pytest.mark.parametrize("backoff,attempt,worker", [
    (0.5, 1, 0), (0.5, 2, 3), (1.0, 3, 17), (0.0, 1, 5)])
def test_respawn_delay_is_jax(backoff, attempt, worker):
    assert launcher.respawn_delay(backoff, attempt, worker) == \
        jlauncher.respawn_delay(backoff, attempt, worker)


def test_the_launcher_steals_a_dead_shard_at_once(tmp_path, monkeypatch):
    spawned: list = []
    behaviors = {
        0: lambda resume: "import sys; sys.exit(0)",
        1: lambda resume: ("import sys; sys.exit(0)" if resume else
                           "import sys, time; time.sleep(1.5); sys.exit(5)"),
    }
    monkeypatch.setattr(launcher, "_worker_cmd",
                        _indexed_cmd(spawned, behaviors))
    monkeypatch.setenv("CNMF_TPU_WORKER_RESPAWNS", "1")
    monkeypatch.setenv("CNMF_TPU_WORKER_BACKOFF_S", "30")  # stealing skips it
    monkeypatch.delenv("CNMF_TPU_WORKER_TIMEOUT", raising=False)
    sink = _EventSink()
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning, match="work-stealing"):
        failed, unhealthy = launcher._run_subprocess_workers(
            str(tmp_path), "x", 2, [], dict(os.environ), events=sink)
    assert time.monotonic() - t0 < 20
    assert failed == set() and unhealthy == set()
    adoption = spawned[-1]
    assert "--skip-completed-runs" in adoption
    assert adoption[adoption.index("--worker-index") + 1] == "1"
    assert sink.kinds() == ["worker_steal"]


def test_one_adoption_wave_past_the_respawn_budget(tmp_path, monkeypatch):
    behaviors = {
        0: lambda resume: "import sys; sys.exit(0)",
        1: lambda resume: ("import sys; sys.exit(0)" if resume else
                           "import sys, time; time.sleep(1.5); sys.exit(5)"),
    }
    monkeypatch.setenv("CNMF_TPU_WORKER_RESPAWNS", "0")
    monkeypatch.delenv("CNMF_TPU_WORKER_TIMEOUT", raising=False)
    spawned: list = []
    monkeypatch.setattr(launcher, "_worker_cmd",
                        _indexed_cmd(spawned, behaviors))
    sink = _EventSink()
    with pytest.warns(RuntimeWarning, match="adoption wave"):
        failed, _ = launcher._run_subprocess_workers(
            str(tmp_path), "x", 2, [], dict(os.environ), events=sink)
    assert failed == set()
    assert [f["context"]["reason"] for t, f in sink.events
            if f.get("kind") == "worker_steal"] \
        == ["respawn_budget_exhausted"]
    spawned2: list = []
    monkeypatch.setattr(launcher, "_worker_cmd",
                        _indexed_cmd(spawned2, behaviors))
    monkeypatch.setenv(elastic.ELASTIC_ENV, "0")
    with pytest.warns(RuntimeWarning, match="skipped at combine"):
        failed, _ = launcher._run_subprocess_workers(
            str(tmp_path), "x", 2, [], dict(os.environ))
    assert failed == {1} and len(spawned2) == 2


def test_a_straggler_is_contained_and_adopted(tmp_path, monkeypatch):
    spawned: list = []
    behaviors = {
        0: lambda resume: "import sys; sys.exit(0)",
        1: lambda resume: ("import sys; sys.exit(0)" if resume else
                           "import time; time.sleep(60)"),
    }
    monkeypatch.setattr(launcher, "_worker_cmd",
                        _indexed_cmd(spawned, behaviors))
    monkeypatch.setenv("CNMF_TPU_WORKER_RESPAWNS", "1")
    monkeypatch.setenv("CNMF_TPU_WORKER_BACKOFF_S", "0.05")
    monkeypatch.setenv(elastic.STRAGGLER_ENV, "0.5")
    # conviction needs liveness armed; the stand-in never beats
    monkeypatch.setenv(elastic.HEARTBEAT_ENV, "0.1")
    monkeypatch.delenv("CNMF_TPU_WORKER_TIMEOUT", raising=False)
    sink = _EventSink()
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning, match="straggler"):
        failed, unhealthy = launcher._run_subprocess_workers(
            str(tmp_path), "x", 2, [], dict(os.environ), events=sink)
    assert time.monotonic() - t0 < 30
    assert failed == set() and unhealthy == set()
    assert "straggler" in sink.kinds() and "worker_steal" in sink.kinds()


def test_a_straggler_deadline_without_liveness_is_disabled(tmp_path,
                                                           monkeypatch):
    behaviors = {0: lambda resume: "import sys; sys.exit(0)"}
    monkeypatch.setattr(launcher, "_worker_cmd",
                        _indexed_cmd([], behaviors))
    monkeypatch.setenv(elastic.STRAGGLER_ENV, "0.5")
    monkeypatch.delenv(elastic.HEARTBEAT_ENV, raising=False)
    with pytest.warns(RuntimeWarning, match="deadline is disabled"):
        assert launcher._run_subprocess_workers(
            str(tmp_path), "x", 1, [], dict(os.environ)) == (set(), set())


def test_an_unhealthy_worker_is_never_respawned(tmp_path, monkeypatch):
    from cnmf_torch_tpu_torch.runtime.resilience import UNHEALTHY_EXIT_CODE

    spawned: list = []
    behaviors = {
        0: lambda resume: "import sys; sys.exit(0)",
        1: lambda resume: f"import sys; sys.exit({UNHEALTHY_EXIT_CODE})",
    }
    monkeypatch.setattr(launcher, "_worker_cmd",
                        _indexed_cmd(spawned, behaviors))
    failed, unhealthy = launcher._run_subprocess_workers(
        str(tmp_path), "x", 2, [], dict(os.environ))
    assert failed == set() and unhealthy == {1} and len(spawned) == 2


def test_the_clean_sweep_keeps_the_store(tmp_path):
    run = tmp_path / "r"
    tmp = run / "cnmf_tmp"
    (tmp / "r.norm_counts.store").mkdir(parents=True)
    (tmp / "r.norm_counts.store.cache").mkdir()
    gone = ["r.spectra.k_3.iter_0.df.npz", "r.ckpt.k_3.iter_0.npz",
            "r.heartbeat.0.json", ".tmp_abc", "x.tmp-12",
            "r.norm_counts.store/slab_00000.npz.tmp-9",
            "r.norm_counts.store.cache/slab_00000.npz"]
    kept = ["r.spectra.k_3.merged.df.npz",
            "r.norm_counts.store/slab_00000.npz",
            "r.norm_counts.store/manifest.json"]
    for name in gone + kept:
        (tmp / name).write_text("x")
    (run / "r.k_selection_stats.df.npz.tmp-3").write_text("x")
    launcher._clean_run_dir(str(run))
    assert all(not (tmp / n).exists() for n in gone)
    assert all((tmp / n).exists() for n in kept)
    assert not (run / "r.k_selection_stats.df.npz.tmp-3").exists()


def test_the_cli_forwards_the_layout_flags(monkeypatch):
    from cnmf_torch_tpu_torch import cli

    seen = {}

    def fake_run_pipeline(counts, output_dir, name, **kw):
        seen.update(kw, counts=counts, output_dir=output_dir, name=name)

    monkeypatch.setattr(launcher, "run_pipeline", fake_run_pipeline)
    cli.main(["run_parallel", "--output-dir", "o", "--name", "n", "-c",
              "c.df.npz", "-k", "3", "4", "--engine", "multihost",
              "--total-workers", "2", "--devices-per-host", "2",
              "--mesh-grid2d", "--rowshard", "--clean", "--device", "cpu"])
    assert seen["engine"] == "multihost" and seen["devices_per_host"] == 2
    assert seen["total_workers"] == 2 and seen["clean"] is True
    assert "--mesh-grid2d" in seen["factorize_flags"]
    assert "--rowshard" in seen["factorize_flags"]
    args = cli.build_parser().parse_args(
        ["factorize", "--mesh-2d", "--distributed"])
    assert args.mesh_2d and args.distributed and not args.mesh_grid2d


def test_run_parallel_subprocess_pipeline(tmp_path):
    """prepare -> two factorize workers -> combine -> k_selection_plot ->
    clean through the CLI, against a one-process run."""
    from cnmf_torch_tpu_torch import Frame, cNMF, load_df_from_npz, \
        save_df_to_npz

    rng = np.random.default_rng(3)
    X = rng.poisson(rng.gamma(0.5, 1.0, (200, 1))
                    * rng.gamma(0.5, 1.0, (1, 250)) * 4.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    fn = str(tmp_path / "c.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(200)]),
                         np.asarray([f"g{j}" for j in range(250)])), fn)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", "run_parallel",
         "--device", "cpu", "--output-dir", str(tmp_path), "--name", "par",
         "-c", fn, "-k", "3", "4", "-n", "4", "--seed", "6", "--numgenes",
         "120", "--beta-loss", "kullback-leibler", "--total-workers", "2",
         "--clean"], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    par = cNMF(str(tmp_path), "par", device="cpu")
    assert (tmp_path / "par" / "par.k_selection_stats.df.npz").exists()
    left = [f for f in os.listdir(tmp_path / "par" / "cnmf_tmp")
            if ".iter_" in f]
    assert left == []
    one = cNMF(str(tmp_path), "one", device="cpu")
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one.prepare(fn, components=[3, 4], n_iter=4, seed=6,
                    num_highvar_genes=120, beta_loss="kullback-leibler")
        one.factorize()
        one.combine()
    finally:
        torch.set_num_threads(threads)
    for k in (3, 4):
        np.testing.assert_array_equal(
            load_df_from_npz(par.paths["merged_spectra"] % k).values,
            load_df_from_npz(one.paths["merged_spectra"] % k).values)


@pytest.mark.parametrize("workers, per, visible, want", [
    # the cards split evenly: every process its own, so nccl
    (2, None, ["0", "1", "2", "3"], [{"CUDA_VISIBLE_DEVICES": "0,1"},
                                    {"CUDA_VISIBLE_DEVICES": "2,3"}]),
    (4, 1, ["4", "5", "6", "7"], [{"CUDA_VISIBLE_DEVICES": v}
                                  for v in "4567"]),
    (2, 1, ["0", "1", "2"], [{"CUDA_VISIBLE_DEVICES": "0"},
                             {"CUDA_VISIBLE_DEVICES": "1"}]),
    # fewer cards than processes: they share them (gloo)
    (2, None, ["0"], [{}, {}]),
])
def test_multihost_processes_own_their_cards(workers, per, visible, want):
    assert launcher._device_envs(workers, per, "cuda", visible) == want


def test_multihost_device_envs_on_the_cpu_and_too_few_cards():
    assert launcher._device_envs(2, 3, "cpu", []) == [
        {"CNMF_SIM_CPU_DEVICES": "3"}] * 2
    assert launcher._device_envs(2, None, "cpu", []) == [{}, {}]
    with pytest.raises(ValueError, match="need 4 cards; 3 are visible"):
        launcher._device_envs(2, 2, "cuda", ["0", "1", "2"])
    assert launcher._visible_cards({"CUDA_VISIBLE_DEVICES": "3, 5"}) == [
        "3", "5"]
